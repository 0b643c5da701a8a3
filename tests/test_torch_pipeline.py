"""The port's pipeline (shotgun_tpu_torch.models.pipeline) and streamed
aligner against the JAX package's, field by field, on identical inputs.
Every output is an integer and compared exactly."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from shotgun_tpu.aligner import PseudoAlignment as JaxPseudoAlignment
from shotgun_tpu.index.build import build_index
from shotgun_tpu.io.data_file import open_fastq_stream
from shotgun_tpu.models import pipeline as jpipe
from shotgun_tpu.ops.encode import pack_codes_2bit
from shotgun_tpu.reference import KmerReference as JaxKmerReference
from shotgun_tpu.utils.synth import synth_genomes, synth_reads, to_fastq
from shotgun_tpu_torch import convert
from shotgun_tpu_torch.aligner import PseudoAlignment
from shotgun_tpu_torch.index.hashtable import build_probe_table
from shotgun_tpu_torch.models import pipeline as tpipe

torch.set_num_threads(2)
CPU = torch.device("cpu")
GATES = [(False, False, False), (True, False, False), (False, True, False),
         (False, False, True), (True, True, False), (True, False, True),
         (False, True, True), (True, True, True)]


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_fields_equal(got, want):
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)


def _set_table(rng, s, r):
    """[S, R] membership with half the sets singletons (specific k-mers)."""
    member = (rng.random((s, r)) < 0.3).astype(np.uint8)
    member[np.arange(s), rng.integers(0, r, size=s)] = 1
    single = rng.random(s) < 0.5
    member[single] = 0
    member[single, rng.integers(0, r, size=single.sum())] = 1
    return member


def _probe_inputs(rng, b, l, k, member):
    """Probe results as the hash probe gives them: windows draw k-mers from
    a small per-row pool (so values repeat within a read), each k-mer with
    a unique slot position, a set and that set's genome count."""
    w = l - k + 1
    s = member.shape[0]
    n_kmers = 4 * w
    kmer_sid = rng.integers(0, s, size=n_kmers).astype(np.int32)
    kmer_pos = rng.permutation(1 << 20)[:n_kmers].astype(np.int32)
    sizes = member.sum(axis=1).astype(np.int32)
    pool = rng.integers(0, n_kmers, size=(b, w // 2))
    pick = pool[np.arange(b)[:, None], rng.integers(0, w // 2, size=(b, w))]
    hit = rng.random((b, w)) < 0.8
    sid = np.where(hit, kmer_sid[pick], -1).astype(np.int32)
    gc = np.where(hit, sizes[kmer_sid[pick]], 0).astype(np.int32)
    pos = np.where(hit, kmer_pos[pick], -1).astype(np.int32)
    qual = rng.integers(60, 95, size=(b, l), dtype=np.uint8)
    lengths = rng.integers(k, l + 1, size=b).astype(np.int32)
    qual[np.arange(l)[None, :] >= lengths[:, None]] = 0
    return (hit, sid, gc, pos), qual, lengths


@functools.lru_cache(maxsize=None)
def _jax_core(k, has_mrq, has_mkq, has_mg):
    return jax.jit(functools.partial(
        jpipe.core_from_probe, k=k, has_mrq=has_mrq, has_mkq=has_mkq,
        has_mg=has_mg))


def _both_cores(probe, member, qual, lengths, params, k, gates):
    m, p, mrq, mkq, mg = params
    want = _jax_core(k, *gates)(
        tuple(jnp.asarray(x) for x in probe), jnp.asarray(member),
        jnp.asarray(qual), jnp.asarray(lengths),
        *(jnp.int32(v) for v in params))
    got = tpipe.core_from_probe(
        tuple(_t(x) for x in probe), _t(member), _t(qual), _t(lengths),
        m, p, mrq, mkq, mg, k=k, has_mrq=gates[0], has_mkq=gates[1],
        has_mg=gates[2])
    return got, want


@pytest.mark.parametrize("gates", GATES)
@pytest.mark.parametrize("params", [(1, 1, 75, 77, 2), (2, 0, 80, 70, 1),
                                    (0, -1, 70, 80, 3)])
def test_core_from_probe_matches_jax(gates, params):
    rng = np.random.default_rng(hash((gates, params)) % 2**32)
    k, l = 7, 40
    member = _set_table(rng, 20, 10)
    probe, qual, lengths = _probe_inputs(rng, 48, l, k, member)
    got, want = _both_cores(probe, member, qual, lengths, params, k, gates)
    _assert_fields_equal(got, want)
    assert (np.asarray(want.mtype) == 1).any()


@pytest.mark.parametrize("s,r", [(40, 600), (1100, 12)])
def test_core_and_aggregate_match_jax_on_wide_tables(s, r):
    """R > 512 (the JAX aggregate's argsort branch) and S > 1024 sets (the
    JAX count block's scanned window-gather branch)."""
    rng = np.random.default_rng(s + r)
    k, l = 5, 24
    member = _set_table(rng, s, r)
    probe, qual, lengths = _probe_inputs(rng, 16, l, k, member)
    got, want = _both_cores(probe, member, qual, lengths, (1, 1, 0, 0, 3), k,
                            (False, False, True))
    _assert_fields_equal(got, want)
    row_valid = np.arange(16) < 13
    _assert_fields_equal(
        tpipe.aggregate_batch(got, _t(row_valid)),
        jax.jit(jpipe.aggregate_batch)(want, jnp.asarray(row_valid)))


@pytest.mark.parametrize("gates", [GATES[0], GATES[-1]])
def test_aggregate_batch_matches_jax(gates):
    rng = np.random.default_rng(7)
    k, l = 7, 40
    member = _set_table(rng, 30, 9)
    probe, qual, lengths = _probe_inputs(rng, 64, l, k, member)
    _, want_res = _both_cores(probe, member, qual, lengths, (1, 1, 75, 77, 2),
                              k, gates)
    res = tpipe.BatchResult(*(_t(x) for x in want_res))
    row_valid = rng.random(64) < 0.9
    want = jax.jit(jpipe.aggregate_batch)(want_res, jnp.asarray(row_valid))
    _assert_fields_equal(tpipe.aggregate_batch(res, _t(row_valid)), want)
    assert (np.asarray(want.first_key) < jpipe.BIG).any()


def test_fold_agg_matches_jax():
    rng = np.random.default_rng(8)
    r = 11
    carry = jpipe.FoldCarry(
        counters=rng.integers(0, 100, size=6).astype(np.int32),
        unique_by_rec=rng.integers(0, 9, size=r).astype(np.int32),
        amb_by_rec=rng.integers(0, 9, size=r).astype(np.int32),
        first_batch=np.where(rng.random(r) < 0.5, jpipe.FOLD_INF,
                             rng.integers(0, 4, size=r)).astype(np.int32),
        first_key=rng.integers(0, 500, size=r).astype(np.int32),
        batch_no=np.int32(5),
    )
    agg = jpipe.AggResult(
        *(np.int32(v) for v in rng.integers(0, 50, size=6)),
        unique_by_rec=rng.integers(0, 9, size=r).astype(np.int32),
        amb_by_rec=rng.integers(0, 9, size=r).astype(np.int32),
        first_key=np.where(rng.random(r) < 0.5, jpipe.BIG,
                           rng.integers(0, 500, size=r)).astype(np.int32),
    )
    want = jax.jit(jpipe._fold_agg)(carry, agg)
    got = tpipe._fold_agg(convert.fold_carry(carry, CPU),
                          tpipe.AggResult(*(_t(x) for x in agg)))
    _assert_fields_equal(got, want)


@pytest.mark.parametrize("has_mkq", [False, True])
def test_window_ok_matches_jax(has_mkq):
    rng = np.random.default_rng(9)
    k, l = 11, 48
    qual = rng.integers(60, 95, size=(16, l), dtype=np.uint8)
    lengths = rng.integers(k - 2, l + 1, size=16).astype(np.int32)
    want = jpipe._window_ok(jnp.asarray(qual), jnp.asarray(lengths), k,
                            l - k + 1, jnp.int32(77), has_mkq)
    got = tpipe._window_ok(_t(qual), _t(lengths), k, l - k + 1, 77, has_mkq)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _workload(seed, n_reads=256, read_len=60, genome_len=2000):
    """Synthetic genomes where genome 1 repeats a stretch of genome 0, and
    reads with mutations and varied quality, so unique, ambiguous and
    unmapped reads all occur."""
    rng = np.random.default_rng(seed)
    genomes = synth_genomes(rng, 4, genome_len)
    genomes.codes[genome_len: genome_len + 400] = genomes.codes[:400]
    reads = synth_reads(rng, genomes, n_reads, read_len)
    mutate = rng.random(reads.codes.shape) < 0.04
    reads.codes[mutate] = rng.integers(0, 4, size=mutate.sum())
    reads.qual[:] = rng.integers(60, 91, size=reads.qual.shape)
    return genomes, reads


def _tables(index, kind):
    """JAX HashTableDev of the given kind: the JAX package's 4-slot table,
    or a 3-slot table at one key a bucket, whose overflow fills a stash."""
    jref = JaxKmerReference(index.k, _index=index)
    if kind == "hash":
        return jref.device_probe_tables("hash"), jref.set_member_dense()
    pt = build_probe_table(index.kmer_lo, index.kmer_hi, index.set_id,
                           index.genome_counts(), slots_per_bucket=3)
    assert pt.stash.shape[0] > 0
    from shotgun_tpu.ops.probe import HashTableDev as JaxHashTableDev

    return (JaxHashTableDev(jnp.asarray(pt.table), jnp.asarray(pt.stash)),
            jref.set_member_dense())


@pytest.mark.parametrize("kind", ["hash", "stash"])
@pytest.mark.parametrize("gates", [GATES[0], GATES[-1]])
def test_align_fold_batch_matches_jax(kind, gates):
    k, lpad, b = 21, 64, 64
    genomes, reads = _workload(11)
    jtab, member = _tables(build_index(genomes, k), kind)
    tab = convert.hash_table(jtab, CPU)
    params = (1, 1, 70, 74, 2)
    has = dict(has_mrq=gates[0], has_mkq=gates[1], has_mg=gates[2])

    jcarry = jpipe.init_fold_carry(member.shape[1], start_batch=3)
    carry = convert.fold_carry(jcarry, CPU)
    for start in range(0, 128, b):  # two batches, the second padded
        rows = min(b, 100 - start)
        codes = np.zeros((b, lpad), dtype=np.uint8)
        qual = np.zeros((b, lpad), dtype=np.uint8)
        lengths = np.zeros(b, dtype=np.int32)
        codes[:rows, :60] = reads.codes[start: start + rows]
        qual[:rows, :60] = reads.qual[start: start + rows]
        lengths[:rows] = 60
        packed = pack_codes_2bit(codes)
        jcarry = jpipe.align_fold_batch(
            jcarry, jtab, jnp.asarray(member), jnp.asarray(packed),
            jnp.asarray(qual), jnp.asarray(lengths),
            *(np.int32(v) for v in params), k=k, packed=True, **has)
        carry = tpipe.align_fold_batch(
            carry, tab, _t(member), _t(packed),
            _t(qual) if gates[0] or gates[1] else None, _t(lengths),
            *params, k=k, **has)
        _assert_fields_equal(carry, jax.device_get(jcarry))
    assert int(carry.counters[0]) > 0 and int(carry.counters[1]) > 0


@pytest.mark.parametrize("gates", [(None, None, None), (72, 75, 2)])
def test_align_stream_matches_jax_hash16(tmp_path, monkeypatch, gates):
    """The whole slice: port vs JAX align_stream on a k = 31 workload with
    the probe forced to the 16-slot table."""
    monkeypatch.setenv("SHOTGUN_TPU_PROBE", "hash16")
    k = 31
    genomes, reads = _workload(12, n_reads=300, read_len=100, genome_len=3000)
    fq = tmp_path / "reads.fq"
    fq.write_text(to_fastq(reads))
    index = build_index(genomes, k)

    jpa = JaxPseudoAlignment(JaxKmerReference(k, _index=index))
    jpa.align_stream(open_fastq_stream(str(fq), lazy=True), 1, 1, *gates,
                     batch_size=64)
    ref = convert.reference(index)
    pa = PseudoAlignment(ref, CPU)
    pa.align_stream(open_fastq_stream(str(fq), lazy=True), 1, 1, *gates,
                    batch_size=64)
    assert ref.probe_method() == "hash16"
    assert pa.get_summary() == jpa.get_summary()
    stats = pa.get_summary()["Statistics"]
    assert stats["unique_mapped_reads"] and stats["ambiguous_mapped_reads"]


def test_container_route_equals_stream_route(tmp_path):
    genomes, reads = _workload(13)
    fq = tmp_path / "reads.fq"
    fq.write_text(to_fastq(reads))
    ref = convert.reference(build_index(genomes, 21))
    gates = (70, 74, 2)
    pa_s = PseudoAlignment(ref, CPU)
    pa_s.align_stream(open_fastq_stream(str(fq), lazy=True), 2, 1, *gates,
                      batch_size=50)
    pa_c = PseudoAlignment(ref, CPU)
    pa_c.align_reads_from_container(
        [_record(reads, i) for i in range(reads.num_reads)], 2, 1, *gates,
        batch_size=0)
    assert pa_s.get_summary() == pa_c.get_summary()


def _record(reads, i):
    from shotgun_tpu.io.records import SeqRecord

    seq = np.frombuffer(b"ACGT", dtype=np.uint8)[reads.codes[i]].tobytes()
    return SeqRecord([("identifier", reads.ids[i]),
                      ("sequence", seq.decode("ascii")),
                      ("quality_sequence", reads.qual[i].tobytes().decode("ascii"))])


def test_align_stream_restarts_at_double_stride(tmp_path, monkeypatch):
    """A first record shorter than the rest: the stream's stride guess (the
    first record's length) is too small, and LmaxExceeded restarts the
    pass at twice the stride until the records fit."""
    genomes, reads = _workload(14, n_reads=200, read_len=100)
    reads.lengths[0] = 30
    fq = tmp_path / "reads.fq"
    fq.write_text(to_fastq(reads))
    index = build_index(genomes, 21)

    jpa = JaxPseudoAlignment(JaxKmerReference(21, _index=index))
    jpa.align_stream(open_fastq_stream(str(fq), lazy=True), 1, 1,
                     batch_size=32)
    passes = []
    fold = PseudoAlignment._fold_chunks

    def counting_fold(self, *args):
        passes.append(1)
        return fold(self, *args)

    monkeypatch.setattr(PseudoAlignment, "_fold_chunks", counting_fold)
    pa = PseudoAlignment(convert.reference(index), CPU)
    pa.align_stream(open_fastq_stream(str(fq), lazy=True), 1, 1, batch_size=32)
    assert pa.get_summary() == jpa.get_summary()
    assert len(passes) == 3  # strides 32 -> 64 -> 128
    assert pa._batch_no == 7
