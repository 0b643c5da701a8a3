"""Multi-process runs of the port over torch.distributed (gloo, on the
CPU): two port CLI processes (SHOTGUN_TPU_NPROCS=2) print the recorded
golden from process 0 and nothing from process 1, on the -g, -r and -a
routes, as the JAX package's two-process runs do (tests/test_distributed.py);
and the library's align_packed_reads over a mesh of 2 processes x 3
shards equals one device.  Every process has a timeout of its own, so a
hung rank fails its test."""

import json
import os

import pytest
import torch

from shotgun_tpu_torch import cli
from shotgun_tpu_torch.aligner import PseudoAlignment
from shotgun_tpu_torch.io.data_file import FASTAFile, FASTAQFile
from shotgun_tpu_torch.reference import KmerReference
from shotgun_tpu_torch.tools.dryrun import run_two_processes

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
DATA = os.path.join(GOLDEN, "data")
FA = os.path.join(DATA, "corpus.fa")
FQ = os.path.join(DATA, "corpus.fq")
#: the environment a child must not inherit from the test run
CLEARED = ("SHOTGUN_TPU_PROBE", "SHOTGUN_TPU_DEVICE_BUILD", "SHOTGUN_TPU_DEVICE_BUILD_MIN",
           "SHOTGUN_TPU_DEVICE_BUILD_MAX", "SHOTGUN_TPU_MESH", "SHOTGUN_TPU_NPROCS",
           "SHOTGUN_TPU_PROC_ID", "SHOTGUN_TPU_COORDINATOR")
TIMEOUT = 120


def _golden(name: str) -> str:
    with open(os.path.join(GOLDEN, f"{name}.out")) as fh:
        return fh.read()


def _case_args(name: str):
    with open(os.path.join(GOLDEN, "manifest.json")) as fh:
        manifest = json.load(fh)
    return [a.replace("data/", DATA + "/") for a in manifest[name]["args"]]


def _run_two(argv, env=None):
    """``python argv`` as processes 0 and 1 of a 2-process run on the CPU;
    [(stdout, stderr)] of each, both exited 0 within TIMEOUT."""
    base = {k: v for k, v in os.environ.items() if k not in CLEARED}
    return run_two_processes(argv, dict(base, SHOTGUN_TPU_TORCH_DEVICE="cpu",
                                        OMP_NUM_THREADS="2", **(env or {})), TIMEOUT)


@pytest.mark.parametrize("case", ["plain", "combo"])
def test_two_process_dumpalign_matches_golden(case):
    """Process 0 prints the golden exactly (gloo writes to stderr only);
    process 1 prints no summary."""
    outs = _run_two(["-m", "shotgun_tpu_torch", *_case_args(case), "--batch-size", "16"])
    assert outs[0][0] == _golden(case)
    assert "{" not in outs[1][0]


def test_two_process_genomes_take_the_host_build():
    """-g under a mesh builds on the host, as in the JAX CLI, even where the
    device build would take the input; the backend is gloo."""
    outs = _run_two(["-m", "shotgun_tpu_torch", *_case_args("mrq"), "--batch-size", "16",
                     "--profile"], {"SHOTGUN_TPU_DEVICE_BUILD_MIN": "0"})
    assert outs[0][0] == _golden("mrq")
    for _, err in outs:
        stages = err.split("=== profile ===")[1]
        assert "db_build " in stages and "db_build_device" not in stages
        assert "backend gloo" in err and "'data': 2" in err


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The corpus's .kdb and .aln, written by the port's CLI in process."""
    tmp = tmp_path_factory.mktemp("files")
    kdb, aln = str(tmp / "c.kdb"), str(tmp / "c.aln")
    env = {"SHOTGUN_TPU_TORCH_DEVICE": "cpu"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        cli.main(["-t", "reference", "-g", FA, "-k", "11", "-r", kdb])
        cli.main(["-t", "align", "-r", kdb, "--reads", FQ, "-a", aln])
    finally:
        for k, v in saved.items():
            os.environ.pop(k)
            if v is not None:
                os.environ[k] = v
    return kdb, aln


def test_two_process_reference_file_route(files):
    kdb, _ = files
    outs = _run_two(["-m", "shotgun_tpu_torch", "-t", "dumpalign", "-r", kdb, "--reads", FQ,
                     "--batch-size", "8"])
    assert outs[0][0] == _golden("plain") and "{" not in outs[1][0]


def test_two_process_alignment_file_prints_from_both(files):
    """dumpalign -a reads no reads: every process prints the file's
    summary, as the JAX CLI's do (its cli.py:484-486)."""
    _, aln = files
    outs = _run_two(["-m", "shotgun_tpu_torch", "-t", "dumpalign", "-a", aln])
    assert outs[0][0] == outs[1][0] == _golden("plain")


_LIBRARY = r"""
import json, os, sys
import torch
from shotgun_tpu_torch.aligner import PseudoAlignment
from shotgun_tpu_torch.io.data_file import FASTAFile, FASTAQFile
from shotgun_tpu_torch.parallel import distributed
from shotgun_tpu_torch.parallel.mesh import make_mesh
from shotgun_tpu_torch.reference import KmerReference
fa, fq = sys.argv[1:3]
rank = os.environ["SHOTGUN_TPU_PROC_ID"]
distributed.initialize(os.environ["SHOTGUN_TPU_COORDINATOR"], 2, int(rank), "cpu")
try:
    mesh = make_mesh(["cpu"] * 3, group=torch.distributed.group.WORLD)
    assert mesh.shape == {"data": 6} and mesh.first_shard == 3 * int(rank)
    aln = PseudoAlignment(KmerReference(11, FASTAFile(fa).container, device="cpu"), "cpu")
    aln.align_packed_reads(FASTAQFile(fq).container.to_read_batch(), 1, 1, 70, 75, 2,
                           batch_size=10, mesh=mesh, store_reads=False)
    print(json.dumps(aln.get_summary()))
finally:
    distributed.shutdown()
"""


def test_two_processes_of_three_shards_equal_one_device():
    """The library route across processes: 2 processes x 3 local shards
    (process p owns global shards 3p..3p+2), batches of 12 with an uneven
    last one, every gate on; both processes hold the single-device
    summary."""
    outs = _run_two(["-c", _LIBRARY, FA, FQ])
    one = PseudoAlignment(KmerReference(11, FASTAFile(FA).container, device="cpu"), "cpu")
    one.align_packed_reads(FASTAQFile(FQ).container.to_read_batch(), 1, 1, 70, 75, 2,
                           batch_size=10, store_reads=False)
    want = json.loads(json.dumps(one.get_summary()))
    assert [json.loads(out) for out, _ in outs] == [want, want]
    assert want["Statistics"]["unique_mapped_reads"]


def test_dryrun_multichip_on_the_cpu(capsys, monkeypatch):
    """tools/dryrun.py, the port's analog of __graft_entry__.py, on 8 CPU
    shards: the DP mesh, the 4 x 2 DP x TP mesh and the 2-process CLI."""
    from shotgun_tpu_torch.tools import dryrun

    for name in CLEARED:
        monkeypatch.delenv(name, raising=False)
    dryrun.dryrun_multichip(8, "cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines == [
        "dryrun_multichip ok (dp): 8 devices, 64 reads, unique=64",
        "dryrun_multichip ok (dp x tp): 4x2 mesh, 64 reads, unique=64",
        "dryrun_multichip ok (2-process torch.distributed, gloo): process 0's "
        "dumpalign JSON == reference golden"]


def test_entry_step_matches_the_jax_entry():
    """dryrun.entry()'s step on its tiny problem equals __graft_entry__'s
    (the same genomes and reads from the same seed); order keys re-encoded
    to the JAX package's padded record axis."""
    import jax
    import numpy as np

    import __graft_entry__
    from shotgun_tpu_torch.models.pipeline import BIG
    from shotgun_tpu_torch.tools import dryrun

    forward, args = dryrun.entry("cpu")
    got = forward(*args)
    jforward, jargs = __graft_entry__.entry()
    want = jax.jit(jforward)(*jargs)
    r = got.unique_by_rec.shape[0]
    for name in want._fields[:6]:
        assert int(getattr(got, name)) == int(getattr(want, name)), name
    np.testing.assert_array_equal(got.unique_by_rec.numpy(), np.asarray(want.unique_by_rec)[:r])
    fk = got.first_key.numpy().astype(np.int64)
    wk = np.asarray(want.first_key)
    np.testing.assert_array_equal(
        np.where(fk < BIG, fk // (r + 2) * (wk.shape[0] + 2) + fk % (r + 2), BIG), wk[:r])
    assert int(got.n_unique) == 64
