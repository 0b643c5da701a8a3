"""Phase profile of the device DB build (``index/device_build.py``): host
prep, upload, device compute and fetch, then the warm end-to-end
``KmerReference.from_device_build`` (the port's counterpart of the JAX
repo's ``tools/profile_devbuild.py``).

    python -m shotgun_tpu_torch.tools.profile_devbuild [MBP ...]
        [--device cuda|cpu]

For each size (default 1 and 32 Mbp): random genomes from
``default_rng(0)``, 5 records below 8 Mbp and 8 from 8 Mbp up, k = 31.
The build's four steps, as ``device_build_tables`` calls them:

- ``_host_prep``: the 2-bit packing and the N runs, timed warm (the
  second of two calls);
- one warm upload and compute, untimed;
- then three times, each on a fresh copy of the packed buffer: ``_upload``
  (the buffer, the N runs and the record starts to the device),
  ``_compute`` (window keys by kernel H1, validity, the sort, the genome
  counts and the multi-set numbering) and ``_fetch`` (the multi sets'
  (set, record) pairs to the host and the set masks made there), each
  timed by the host clock up to a device synchronisation;
- ``from_device_build`` warm (the second of two calls).

The last line is one JSON object of every number; ``profile`` returns it
with each size's build product.  Exits 1 where CUDA is absent unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from shotgun_tpu_torch.index.device_build import _compute, _fetch, _host_prep, _upload
from shotgun_tpu_torch.reference import KmerReference
from shotgun_tpu_torch.tools.profile_align import timed_s
from shotgun_tpu_torch.utils.device import tool_device
from shotgun_tpu_torch.utils.synth import synth_genomes

K = 31
ITERS = 3


def make_genomes(mbp: float):
    """The JAX tool's genomes of ``mbp`` Mbp, from ``default_rng(0)``."""
    n_rec = 8 if mbp >= 8 else 5
    return synth_genomes(np.random.default_rng(0), n_rec, int(mbp * 1_000_000) // n_rec)


def profile(mbp: float, device: torch.device, log: Callable[[str], None] = print) -> dict:
    """Every timing of the module doc at ``mbp``, and under ``"built"``
    the last iteration's build product (``device_build_tables``' dict
    without ``num_records``, ``num_windows`` and ``prep_s``)."""
    genomes = make_genomes(mbp)
    g, r = int(genomes.codes.size), genomes.num_records
    _host_prep(genomes)  # warm pages and the native library
    t0 = time.perf_counter()
    prep = _host_prep(genomes)
    prep_s = time.perf_counter() - t0
    if prep is None:
        raise RuntimeError("the device build refused the genomes' N runs")
    codes2, runs = prep
    log(f"[{mbp:g} Mbp] host prep: {prep_s:.3f} s ({codes2.nbytes / 1e6:.1f} MB)")
    res = {"mbp": g / 1e6, "records": r, "host_prep_s": prep_s, "iters": []}

    if _compute(g, r, K, *_upload(genomes, codes2, runs, device)) is None:  # warm
        raise RuntimeError("the device build refused the genomes")
    for it in range(ITERS):
        fresh = codes2.copy()
        up, t_up = timed_s(lambda: _upload(genomes, fresh, runs, device), device)
        computed, t_run = timed_s(lambda: _compute(g, r, K, *up), device)
        built, t_fetch = timed_s(lambda: _fetch(computed, r), device)
        total = prep_s + t_up + t_run + t_fetch
        res["iters"].append({"upload_s": t_up, "compute_s": t_run, "fetch_s": t_fetch,
                             "total_s": total, "mbp_per_s": g / 1e6 / total})
        log(f"  iter{it}: prep {prep_s:.3f} upload {t_up:.3f} compute {t_run:.3f} "
            f"fetch {t_fetch:.3f} -> {total:.3f} s ({g / 1e6 / total:.1f} Mbp/s)  "
            f"u={built['num_kmers']} sets={built['num_sets']}")

    KmerReference.from_device_build(genomes, K, device)
    ref, dt = timed_s(lambda: KmerReference.from_device_build(genomes, K, device),
                      device)
    res.update(from_device_build_s=dt, from_device_build_mbp_per_s=g / 1e6 / dt,
               num_kmers=int(ref.index.num_kmers), num_sets=int(ref.index.num_sets))
    log(f"  from_device_build warm: {dt:.3f} s ({g / 1e6 / dt:.1f} Mbp/s, "
        f"{ref.index.num_kmers} k-mers, {ref.index.num_sets} sets)")
    return dict(res, built=built)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mbp", nargs="*", type=float, default=[1, 32])
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default $SHOTGUN_TPU_TORCH_DEVICE or cuda)")
    args = ap.parse_args(argv)
    device = tool_device(args.device, "profile_devbuild")
    out = {"device": str(device), "timer": "host clock up to a device synchronisation",
           "k": K, "sizes": []}
    if device.type == "cuda":
        out["card"] = torch.cuda.get_device_name(device)
    for mbp in args.mbp:
        res = profile(mbp, device, lambda msg: print(msg, flush=True))
        res.pop("built")
        out["sizes"].append(res)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
