"""The port's benchmark and stage profilers (shotgun_tpu_torch.tools.bench,
.profile_stages, .profile_devbuild) on the CPU at small sizes: their data,
summaries, staged totals, stage outputs and build product held exactly
(tolerance 0: every output is an integer) against the JAX package's
functions on the same seeded data; the headline line; the exits."""

import argparse
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shotgun_tpu.aligner import PseudoAlignment as JaxPseudoAlignment
from shotgun_tpu.index.build import build_index as jax_build_index
from shotgun_tpu.index.device_build import device_build_tables as jax_device_build
from shotgun_tpu.io.data_file import open_fastq_stream as jax_open_fastq_stream
from shotgun_tpu.models import pipeline as jpipe
from shotgun_tpu.ops.encode import pack_codes_2bit, rolling_encode_jnp, unpack_codes_2bit
from shotgun_tpu.ops.probe import hash_probe_gather, resolve_rows
from shotgun_tpu.ops.probe_sort2 import probe_dedupe_sorted as jax_probe_sorted
from shotgun_tpu.reference import KmerReference as JaxKmerReference
from shotgun_tpu.utils.synth import synth_genomes, synth_reads, to_fastq
from shotgun_tpu_torch import convert
from shotgun_tpu_torch.index import device_build as tdb
from shotgun_tpu_torch.models import pipeline as tpipe
from shotgun_tpu_torch.tools import bench, profile_devbuild, profile_stages
from shotgun_tpu_torch.utils.synth import write_fastq

torch.set_num_threads(2)
CPU = torch.device("cpu")
#: the bench at 3 x 30 kbp, 8,192 reads, B = 2048, 2 passes, no 32 Mbp build
SMALL = ["--device", "cpu", "--genomes", "3", "--genome-len", "30000", "--reads", "8192",
         "--batch", "2048", "--passes", "2", "--devbuild-mbp", "0"]
#: reads a CPU shard in the bench run's plumbing check (its own is 16,384)
CPU8_READS = 512
K = 31
ONE, ZERO = jnp.int32(1), jnp.int32(0)
NO_GATES = dict(k=K, has_mrq=False, has_mkq=False, has_mg=False)


@pytest.fixture(scope="module")
def ran():
    """One bench run at SMALL: (the finished Bench, its stdout lines)."""
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setitem(bench.CPU8, "reads_per_device", CPU8_READS)
        b = bench.run(bench.parser().parse_args(SMALL))
    return b, out.getvalue().splitlines()


def _jax_data(n_genomes, genome_len, n_reads):
    rng = np.random.default_rng(0)
    genomes = synth_genomes(rng, n_genomes, genome_len)
    return genomes, synth_reads(rng, genomes, n_reads, 150)


def _fields_equal(got, want):
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)


def _jax_member(jref):
    """The JAX reference's set members without its padded records (its
    ``first_key`` counts rows in the record width it is given)."""
    return jnp.asarray(jref.set_member_dense()[:, : jref.index.num_records])


@pytest.mark.parametrize("tool", ["bench", "profile_stages"])
def test_data_equals_jax_synth(tool, ran, tmp_path):
    """The tools' genomes and reads from seed 0 are the JAX package's, and
    the bench's FASTQ is JAX's ``to_fastq`` byte for byte."""
    if tool == "bench":
        genomes, reads = ran[0].genomes, ran[0].reads
        want_g, want_r = _jax_data(3, 30000, 8192)
    else:
        genomes, reads = profile_stages.make_data(256, 3, 30000)
        want_g, want_r = _jax_data(3, 30000, 256)
    np.testing.assert_array_equal(genomes.codes, want_g.codes)
    np.testing.assert_array_equal(genomes.offsets, want_g.offsets)
    assert genomes.descriptions == want_g.descriptions
    for name in ("codes", "qual", "lengths"):
        np.testing.assert_array_equal(getattr(reads, name), getattr(want_r, name))
    assert reads.ids == want_r.ids
    write_fastq(str(tmp_path / "r.fq"), reads.codes, reads.qual)
    assert (tmp_path / "r.fq").read_text() == to_fastq(want_r)


def test_headline_lines(ran):
    """Stdout holds only the headline, printed after the stage profile and
    after each later section; the last is the finished one, with the JAX
    bench's metric name and definitions; the card's sections say why they
    did not run."""
    b, lines = ran
    heads = [json.loads(line) for line in lines]
    assert len(heads) == len(bench.SECTIONS) - bench.FIRST_EMIT
    assert heads[-1] == json.loads(json.dumps(b.head))
    head, extra = heads[-1], heads[-1]["extra"]
    assert head["metric"] == "pseudo_align_reads_per_sec_k31" and head["unit"] == "reads/s"
    assert head["value"] > 0 and "error" not in extra
    assert head["vs_baseline"] == head["value"] / 4900
    assert extra["kmer_probes_per_sec"] == head["value"] * 120
    times = extra["e2e_pass_times_s"]
    assert len(times) == 2
    assert extra["end_to_end_reads_per_sec"] == 8192 / sorted(times)[1]
    assert extra["end_to_end_vs_baseline"] == extra["end_to_end_reads_per_sec"] / 4900
    assert extra["align_task_summary_equal"] and extra["align_task_reads_per_sec"] > 0
    assert extra["db_build_device_mbp_per_sec"] > 0 and extra["db_build_mbp_per_sec"] > 0
    assert extra["device"] == {"name": "cpu", "power_limit": None}
    assert extra["kernels"] == extra["cold_start"] == "not run: cpu"
    assert set(extra["stage_profile_ms"]) == {
        "encode", "probe", "probe.sort_stable", "probe.cumsum", "probe.scatter_restore",
        "probe.gather", "classify", "aggregate", "fused"}
    assert extra["stage_profile_device_ms"] is None  # no device time on the CPU
    assert extra["kernel_launches"]["staged"] == {"encode_window": 0, "hash_probe": 0}


def test_stream_and_align_task_match_jax(ran, tmp_path):
    """The stream summary equals the JAX package's ``align_stream`` on the
    same FASTQ, and the align task's (asserted by the bench) equals it."""
    b, _ = ran
    genomes, reads = _jax_data(3, 30000, 8192)
    fq = tmp_path / "bench.fq"
    fq.write_text(to_fastq(reads))
    jpa = JaxPseudoAlignment(JaxKmerReference(K, _index=jax_build_index(genomes, K)))
    jpa.align_stream(jax_open_fastq_stream(str(fq), lazy=True), 1, 1, batch_size=2048)
    assert b.summary == jpa.get_summary()
    assert b.extra["stream_statistics"] == b.summary["Statistics"]
    assert sum(b.summary["Statistics"].values()) == 8192


@pytest.mark.parametrize("probe", ["sort", "hash"])
def test_staged_totals_match_jax(probe, ran, tmp_path):
    """Each staged batch's AggResult, and so the totals, equal the JAX
    package's ``align_batch(..., with_aggregate=True)`` on the same batch,
    on the sort join and on the 4-slot hash table."""
    b, _ = ran
    if probe != "sort":
        args = argparse.Namespace(**dict(vars(b.args), probe=probe))
        run, b = b, bench.Bench(args, CPU, str(tmp_path))
        b.reads, b.ref, b.summary = run.reads, run.ref, run.summary
        b.staged()
    assert b.extra["probe_table"]["type"] == ("SortedTableDev" if probe == "sort"
                                              else "HashTableDev")
    genomes, reads = _jax_data(3, 30000, 8192)
    jref = JaxKmerReference(K, _index=jax_build_index(genomes, K))
    tab, member = jref.device_probe_tables(probe), _jax_member(jref)
    totals = dict.fromkeys(("unique", "ambiguous", "unmapped"), 0)
    for i, got in enumerate(b.results):
        sl = slice(2048 * i, 2048 * (i + 1))
        want = jpipe.align_batch(
            tab, member, jnp.asarray(reads.codes[sl]), jnp.asarray(reads.qual[sl]),
            jnp.asarray(reads.lengths[sl]), jnp.ones(2048, dtype=bool),
            ONE, ONE, ZERO, ZERO, ZERO, **NO_GATES, with_aggregate=True)[1]
        _fields_equal(got, jax.device_get(want))
        for name in totals:
            totals[name] += int(getattr(want, f"n_{name}"))
    assert len(b.results) == 4 and b.extra["staged_totals"] == totals


def _stage_case():
    """The profilers' data at 256 reads, with a shared stretch (ambiguous
    reads) and a quarter of the reads random (misses): the JAX index and
    the reads."""
    genomes, reads = _jax_data(3, 30000, 256)
    genomes.codes[30000:36000] = genomes.codes[:6000]
    reads.codes[::4] = np.random.default_rng(5).integers(0, 4, size=reads.codes[::4].shape)
    return jax_build_index(genomes, K), reads


@pytest.mark.parametrize("probe", ["sort", "hash"])
def test_profile_stages_outputs_match_jax(probe):
    """Each stage profile_stages times gives what the JAX stage functions
    of tools/profile_stages.py (sort) and tools/profile_hash.py (hash)
    give on the same batch: the encode (keys as lo/hi), the probe, the
    classify, the dedupe, the aggregate and the fused fold."""
    index, reads = _stage_case()
    ref = convert.reference(index, CPU)
    tab, member = ref.device_probe_tables(CPU, probe), ref.set_member_device(CPU)
    packed, lengths = profile_stages.stage_reads(reads.codes, reads.lengths, CPU)
    _, outs = profile_stages.stages(tab, member, packed, lengths)

    jref = JaxKmerReference(K, _index=index)
    jtab, jmember = jref.device_probe_tables(probe), _jax_member(jref)
    codes = np.zeros((256, 160), dtype=np.uint8)
    codes[:, :150] = reads.codes
    codes_p = jnp.asarray(pack_codes_2bit(codes))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(codes_p))
    jlen, qual = jnp.asarray(reads.lengths), jnp.zeros((256, 1), jnp.uint8)
    lo, hi = rolling_encode_jnp(unpack_codes_2bit(codes_p), K)
    keys = (np.asarray(hi).astype(np.int64) << 32) | np.asarray(lo).astype(np.int64)
    ok = jpipe._window_ok(qual, jlen, K, 130, ZERO, False)
    if probe == "sort":
        (words,), got_ok = outs["encode"]
        np.testing.assert_array_equal(words.numpy(), keys)
        np.testing.assert_array_equal(got_ok.numpy(), np.asarray(ok))
        want = jax.jit(lambda lo, hi, ok: jax_probe_sorted(
            jtab, lo, hi, ok, num_sets=jmember.shape[0],
            max_genome_count=jmember.shape[1]))(lo, hi, ok)
        pre, probe_res = want[3], want[:3] + (None,)
    else:
        np.testing.assert_array_equal(outs["encode"].numpy(), keys)
        rows, bidx = hash_probe_gather(jtab.table, codes_p, k=K, packed=True)
        want = resolve_rows(rows, bidx, jtab.stash, lo, hi)
        pre, probe_res = None, want
        # tools/profile_hash.py's "3a" dedupe, on the windows classify stores
        hit, slot = want[0] & ok, want[3]
        eq = slot[:, :, None] == slot[:, None, :]
        prev = jnp.tril(jnp.ones((130, 130), dtype=bool), -1)
        dup = jnp.any(eq & hit[:, None, :] & prev[None], axis=2)
        np.testing.assert_array_equal(outs["dedupe"].numpy(), np.asarray(hit & ~dup))
    for g, w in zip(outs["probe"], want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    res = jax.jit(lambda pr, pre: jpipe.core_from_probe(
        pr, jmember, qual, jlen, ONE, ONE, ZERO, ZERO, ZERO, **NO_GATES,
        pre_first_occ=pre))(probe_res, pre)
    _fields_equal(outs["classify"], jax.device_get(res))
    agg = jpipe.aggregate_batch(res, jnp.ones(256, dtype=bool))
    _fields_equal(outs["aggregate"], jax.device_get(agg))
    carry = jpipe.align_fold_batch(
        jpipe.init_fold_carry(jmember.shape[1]), jtab, jmember, codes_p, qual, jlen,
        *(np.int32(v) for v in (1, 1, 0, 0, 0)), **NO_GATES, packed=True)
    _fields_equal(outs["fused"], jax.device_get(carry))
    counts = [int(agg.n_unique), int(agg.n_ambiguous), int(agg.n_unmapped)]
    assert all(counts), counts


def test_profile_devbuild_product_matches_device_builds():
    """The build profile_devbuild's steps make equals the port's
    ``device_build_tables`` and, key by key, the JAX package's device
    build (keys, genome counts, set membership)."""
    res = profile_devbuild.profile(0.1, CPU, log=lambda _: None)
    built = res["built"]
    genomes = profile_devbuild.make_genomes(0.1)
    assert genomes.num_records == 5 and genomes.codes.size == 100_000
    want = tdb.device_build_tables(genomes, K, CPU)
    assert set(want) - set(built) == {"num_records", "num_windows", "prep_s"}
    for name, g in built.items():
        w = want[name]
        assert (torch.equal(g, w) if isinstance(g, torch.Tensor)
                else np.array_equal(g, w)), name
    jgen = synth_genomes(np.random.default_rng(0), 5, 20000)
    jt = convert.device_build(jax_device_build(jgen, K, JaxKmerReference._pad_rows), CPU)
    np.testing.assert_array_equal(built["keys"].numpy(), jt["keys"].numpy())
    np.testing.assert_array_equal(built["gc"].numpy(), jt["gc"].numpy())
    bits = [np.unpackbits(m, axis=1, bitorder="little")[:, :5] for m in
            (built["set_masks"], jt["set_masks"])]
    np.testing.assert_array_equal(bits[0][built["sid"].numpy()], bits[1][jt["sid"].numpy()])
    assert res["num_kmers"] == built["num_kmers"] == 5 * (20000 - 30)
    assert len(res["iters"]) == 3 and res["from_device_build_s"] > 0


def test_plumbing_shards_equal_one_device(ran):
    """The bench's 8-shard run equals its one-device run (asserted there)
    and the pipeline's unsharded batch of the same reads."""
    res = ran[0].extra["multichip_cpu8"]
    rows = 8 * CPU8_READS
    assert res["plumbing_check_only"] and res["totals_equal_one_device"]
    assert res["reads"] == rows and "scaling_efficiency" not in res
    ref, reads = ran[0]._mesh_data(3, 30000, rows)
    shards, _ = bench.sharded_run([CPU] * 8, ref, reads, rows)
    packed, lengths = profile_stages.stage_reads(reads.codes, reads.lengths, CPU)
    tab = ref.device_probe_tables(CPU, "sort")
    want = tpipe.aggregate_batch(tpipe.align_batch(
        tab, ref.set_member_device(CPU), packed, None, lengths, 1, 1, 0, 0, 0, **NO_GATES),
        torch.ones(rows, dtype=torch.bool))
    _fields_equal(shards, want)
    assert res["totals"] == {"unique": int(want.n_unique),
                             "ambiguous": int(want.n_ambiguous),
                             "unmapped": int(want.n_unmapped)}


@pytest.mark.parametrize("tool", [bench, profile_stages, profile_devbuild])
def test_tools_exit_1_without_cuda(tool, monkeypatch, capsys):
    """Without CUDA and with no device asked for, each tool exits 1 before
    it measures anything, and says why."""
    monkeypatch.delenv("SHOTGUN_TPU_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        tool.main([])
    assert exc.value.code == 1
    assert "torch.cuda.is_available() is false" in capsys.readouterr().err


def test_failing_section_exits_1_with_the_error(monkeypatch, capsys):
    """A section that raises is not swallowed: the headline is printed with
    the error, and the bench exits 1."""
    def boom(self):
        raise RuntimeError("boom")

    monkeypatch.setattr(bench.Bench, "stream", boom)
    with pytest.raises(SystemExit) as exc:
        bench.main(SMALL)
    assert exc.value.code == 1
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["extra"]["error"] == "stream: RuntimeError('boom')"
    assert last["value"] is None
