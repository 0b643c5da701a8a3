"""The port's at-scale proofs (shotgun_tpu_torch.tools.devbuild_proof and
.bulk_proof) on the CPU at tiny sizes: each tool's summaries held exactly
(tolerance 0) against the JAX package's library functions on the same
seeded data.  The JAX tools themselves hard-code 100 Mbp and are not run."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shotgun_tpu.aligner import PseudoAlignment as JaxPseudoAlignment
from shotgun_tpu.index.build import build_index as jax_build_index
from shotgun_tpu.io.data_file import open_fastq_stream as jax_open_fastq_stream
from shotgun_tpu.ops.probe_sort import sorted_table_host_words
from shotgun_tpu.parallel import mesh as jmesh
from shotgun_tpu.parallel import table_sharded as jts
from shotgun_tpu.reference import KmerReference as JaxKmerReference
from shotgun_tpu.utils.synth import synth_genomes, synth_reads, to_fastq
from shotgun_tpu_torch import aligner as taligner
from shotgun_tpu_torch.ops.probe import HashTableDev
from shotgun_tpu_torch.reference import KmerReference
from shotgun_tpu_torch.tools import bulk_proof, devbuild_proof

torch.set_num_threads(2)
CPU = torch.device("cpu")
BUDGET_ENV = "SHOTGUN_TPU_HASH_HBM_BUDGET"
#: devbuild_proof at 64 x 4 kbp and 2,048 reads; a 2 x 5 kbp cross-check
DEV = dict(mbp=0.256, n_reads=2048, device="cpu", batch=512,
           check=dict(n_rec=2, rec_len=5000, n_reads=64, n_sample=8))
#: bulk_proof part A at 16 x 20 kbp and 4,096 reads streamed at B = 512
PART_A = dict(device="cpu", rec_len=20_000, n_reads=4096, batch=512)
#: bulk_proof part B at k = 75, 2 x 20 kbp, B = 256
PART_B = dict(device="cpu", n_rec=2, rec_len=20_000, n_reads=256, min_keys=39_000)


def _quiet(*_):
    pass


def _jax_devbuild_summary(batch=512):
    """The JAX package's ``PseudoAlignment(KmerReference.from_device_build(...))``
    summary on devbuild_proof's data (seed 0: 64 x 4 kbp, 2,048 reads)."""
    rng = np.random.default_rng(0)
    genomes = synth_genomes(rng, 64, 4000)
    reads = synth_reads(rng, genomes, 2048, 150)
    pa = JaxPseudoAlignment(JaxKmerReference.from_device_build(genomes, 31))
    pa.align_packed_reads(reads, 1, 1, batch_size=batch, store_reads=False)
    return pa.get_summary()


@pytest.mark.parametrize("probe", ["sort", "hash16"])
def test_devbuild_proof_routes_match_jax(probe, monkeypatch):
    """The device build's sort and (with a large budget) 16-slot routes:
    each summary equals JAX's from_device_build run, and the cross-check
    passes."""
    monkeypatch.setenv(BUDGET_ENV, str(16_000_000_000))
    monkeypatch.setenv("SHOTGUN_TPU_PROBE", probe)
    res = devbuild_proof.run(log=_quiet, **DEV)
    monkeypatch.delenv("SHOTGUN_TPU_PROBE")  # JAX's run takes its own route
    assert res["num_kmers"] == 64 * (4000 - 30)
    assert res["table"]["method"] == probe
    want_type = "HashTableDev" if probe == "hash16" else "SortedTableDev"
    assert res["table"]["type"] == want_type
    if probe == "hash16":
        assert res["table"]["shape"][1:] == [16, 4]
    assert res["align"]["summary"] == _jax_devbuild_summary()
    assert res["cross_check"]["mismatches"] == 0 and res["cross_check"]["sampled"] == 8


def test_devbuild_proof_main_prints_its_json(capsys):
    out = devbuild_proof.main(["0.256", "2048", "--device", "cpu", "--batch", "512",
                               "--check-records", "2", "--check-len", "5000",
                               "--check-reads", "64", "--sample", "8"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == json.loads(json.dumps(out))
    assert out["align"]["summary"] == _jax_devbuild_summary()
    assert out["table"]["method"] == "sort"


@pytest.mark.parametrize("package", ["port", "jax"])
def test_devbuild_budget_below_the_table_takes_the_sort_join(package, monkeypatch):
    """Above the auto crossover (lowered here) with a budget below the
    16-slot table, 'auto' takes the sort join, as in the JAX package, and
    aligns to the same summary; an explicit 'hash16' then raises in both
    packages (the port: over the budget; JAX: a device-built reference
    has no host arrays for it)."""
    monkeypatch.setenv(BUDGET_ENV, "1000")
    monkeypatch.setattr(KmerReference, "AUTO_HASH_MIN_KEYS", 1000)
    monkeypatch.setattr(JaxKmerReference, "AUTO_HASH_MIN_KEYS", 1000)
    if package == "port":
        res = devbuild_proof.run(log=_quiet, **DEV)
        assert res["table"]["type"] == "SortedTableDev" and res["table"]["method"] == "sort"
        assert res["ref"]._hash16_failed
        summary = res["align"]["summary"]
        with pytest.raises(RuntimeError, match="memory budget"):
            res["ref"].device_probe_tables(CPU, "hash16")
    else:
        rng = np.random.default_rng(0)
        genomes = synth_genomes(rng, 64, 4000)
        reads = synth_reads(rng, genomes, 2048, 150)
        ref = JaxKmerReference.from_device_build(genomes, 31)
        assert type(ref.device_probe_tables()).__name__ == "SortedTableDev"
        assert "hash16_failed" in ref._device_tables
        pa = JaxPseudoAlignment(ref)
        pa.align_packed_reads(reads, 1, 1, batch_size=512, store_reads=False)
        summary = pa.get_summary()
        with pytest.raises(AttributeError):
            ref.device_probe_tables("hash16")
    # the fallback's summary is the sort join's under the default budget
    monkeypatch.delenv(BUDGET_ENV)
    assert summary == _jax_devbuild_summary()


def test_sample_checks_catch_a_wrong_type(monkeypatch, tmp_path):
    """Both tools' sampled-read checks fail when a read's host type differs
    from the device path's."""
    monkeypatch.setattr(taligner.Read, "pseudo_align",
                        lambda self, ref, m=1, p=1: taligner.ReadMappingType.UNMAPPED)
    with pytest.raises(AssertionError, match="Read.pseudo_align"):
        devbuild_proof.cross_check(CPU, n_rec=2, rec_len=5000, n_reads=64, n_sample=8,
                                   log=_quiet)
    with pytest.raises(AssertionError, match="Read.pseudo_align"):
        bulk_proof.part_a(str(tmp_path), **dict(PART_A, n_reads=512), log=_quiet)


@pytest.mark.parametrize("route", ["auto", "auto above a lowered crossover"])
def test_bulk_part_a_matches_jax_align_stream(route, tmp_path, monkeypatch):
    """Part A: the same FASTQ as JAX's synth + to_fastq; the stream's summary
    equals JAX's align_stream on its host build, on the sort join and on
    the host-built 16-slot table (auto above AUTO_HASH_MIN_KEYS, lowered
    in both packages); 64 of 64 sampled reads agree with Read.pseudo_align."""
    if route != "auto":
        monkeypatch.setattr(KmerReference, "AUTO_HASH_MIN_KEYS", 1000)
        monkeypatch.setattr(JaxKmerReference, "AUTO_HASH_MIN_KEYS", 1000)
    res = bulk_proof.part_a(str(tmp_path), **PART_A, log=_quiet)
    assert res["table"]["method"] == ("sort" if route == "auto" else "hash16")
    assert isinstance(res["ref"].device_probe_tables(CPU), HashTableDev) == (route != "auto")
    assert res["sampled"] == 64 and res["mismatches"] == 0

    rng = np.random.default_rng(0)
    genomes = synth_genomes(rng, 16, 20_000)
    reads = synth_reads(rng, genomes, 4096, 150)
    with open(res["fastq"]) as fh:
        assert fh.read() == to_fastq(reads)
    index = jax_build_index(genomes, 31)
    assert res["num_kmers"] == index.num_kmers
    pa = JaxPseudoAlignment(JaxKmerReference(31, _index=index))
    pa.align_stream(jax_open_fastq_stream(res["fastq"], lazy=True), 1, 1, batch_size=512)
    assert res["summary"] == pa.get_summary()


def _jax_part_b():
    """JAX's align_aggregate_table_sharded on a 1 x 1 mesh of one CPU
    device over part B's data (seed 1: 2 x 20 kbp at k = 75, 256 reads)."""
    rng = np.random.default_rng(1)
    genomes = synth_genomes(rng, 2, 20_000)
    index = jax_build_index(genomes, 75)
    reads = synth_reads(rng, genomes, 256, 150)
    mesh = jts.make_mesh_2d(jax.devices()[:1], data=1, table=1)
    tab = jts.device_put_sharded_table(
        mesh, jts.pad_table_words_for_sharding(sorted_table_host_words(index), 1))
    (member,) = jmesh.replicate(mesh, JaxKmerReference(75, _index=index).set_member_dense())
    codes = np.zeros((256, 160), dtype=np.uint8)
    codes[:, :150] = reads.codes
    arrays = jmesh.shard_read_arrays(mesh, codes, np.zeros((256, 160), np.uint8),
                                     reads.lengths, np.ones(256, bool))
    one, zero = jnp.int32(1), jnp.int32(0)
    return jts.align_aggregate_table_sharded(
        tab, member, *arrays, one, one, zero, zero, zero, mesh=mesh, k=75,
        has_mrq=False, has_mkq=False, has_mg=False)


def test_bulk_part_b_sharded_equals_unsharded_and_jax():
    """Part B: the sharded aggregation equals the unsharded one in every
    field, and JAX's on a 1-device mesh (per-record fields on the port's
    records, order keys re-encoded to JAX's padded record axis)."""
    res = bulk_proof.part_b(**PART_B, log=_quiet)
    got = res["sharded"]
    assert res["num_kmers"] == 2 * (20_000 - 74)
    assert res["sharded_table"]["words"] == 3
    for name, value in res["unsharded"].items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)
    want = _jax_part_b()
    r = got["unique_by_rec"].size
    for name in ("n_unique", "n_ambiguous", "n_unmapped", "n_filtered_reads",
                 "n_filtered_kmers", "n_hr_kmers"):
        assert int(got[name]) == int(getattr(want, name)), name
    for name in ("unique_by_rec", "amb_by_rec"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(want, name))[:r])
    wk = np.asarray(want.first_key)
    fk = got["first_key"].astype(np.int64)
    big = 0x3FFFFFFF
    np.testing.assert_array_equal(
        np.where(fk < big, fk // (r + 2) * (wk.shape[0] + 2) + fk % (r + 2), big), wk[:r])
    assert int(got["n_unique"]) == 256


def test_bulk_part_b_refuses_too_few_keys():
    with pytest.raises(AssertionError, match="k-mers <"):
        bulk_proof.part_b(**dict(PART_B, min_keys=10**6), log=_quiet)


def test_bulk_proof_main_prints_its_json(capsys):
    out = bulk_proof.main(["b", "--device", "cpu", "--b-records", "2", "--b-len", "20000",
                           "--b-reads", "256", "--b-min-keys", "39000"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == "bulk proof done"
    assert json.loads(lines[-1]) == json.loads(json.dumps(out))
    assert set(out) == {"b"} and out["b"]["num_kmers"] == 39_852


@pytest.mark.parametrize("tool", [devbuild_proof, bulk_proof])
def test_tools_default_to_the_card(tool, monkeypatch):
    """Without --device the tools take resolve_device()'s: cuda, which
    raises where CUDA is absent."""
    monkeypatch.delenv("SHOTGUN_TPU_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available.. is false"):
        tool.main(["0.01", "16"] if tool is devbuild_proof else ["b"])


@pytest.mark.parametrize("max_genomes", [None, 1])
def test_read_spec_gathers_only_its_hits(max_genomes, monkeypatch):
    """``Read.pseudo_align``, the proofs' host spec, looks up the genome
    counts of its own hits, never the whole index's (a gather of 100M
    k-mers a read in part A); on strains with shared k-mers and read
    errors its types and counters equal the JAX package's."""
    from shotgun_tpu.aligner import Read as JaxRead
    from shotgun_tpu.io.packing import GenomeArrays as JaxGenomeArrays
    from shotgun_tpu.io.records import SeqRecord as JaxSeqRecord
    from shotgun_tpu_torch.index.build import KmerIndex, build_index
    from shotgun_tpu_torch.utils.synth import make_genomes, sample_reads

    rng = np.random.default_rng(4)
    genomes = make_genomes(rng, 6, 3000, strains=2, mutation_rate=0.02)
    work = sample_reads(rng, genomes, 48, 100, error_rate=0.02)
    ref = KmerReference(21, _index=build_index(genomes, 21), device=CPU)
    jref = JaxKmerReference(21, _index=jax_build_index(JaxGenomeArrays(
        list(genomes.descriptions), genomes.codes, genomes.offsets), 21))

    def whole_index(self):
        raise AssertionError("a gather over every k-mer of the index")

    monkeypatch.setattr(KmerIndex, "genome_counts", whole_index)
    types = set()
    for i, codes in enumerate(work.codes):
        seq = "".join("ACGT"[c] for c in codes)
        fields = [("identifier", f"r{i}"), ("sequence", seq), ("space", ""),
                  ("quality_sequence", "I" * len(seq))]
        got = taligner.Read(taligner.SeqRecord(fields))
        want = JaxRead(JaxSeqRecord(fields))
        gates = dict(min_kmer_quality=40, max_genomes=max_genomes)
        assert (got.pseudo_align(ref, 1, 1, **gates).name
                == want.pseudo_align(jref, 1, 1, **gates).name)
        assert got.num_redundant_kmers == want.num_redundant_kmers
        assert [r.identifier for r in got.mapping.genomes_mapped_to] == [
            r.identifier for r in want.mapping.genomes_mapped_to]
        types.add(got.mapping.type.name)
    assert types >= {"UNIQUELY_MAPPED", "AMBIGUOUSLY_MAPPED"}


def test_profile_route_on_the_cpu(tmp_path):
    """``profile_align.profile_route``, phase 12a's measures of a route:
    every read of the FASTQ counted, the stream's summary the library's,
    and no device profile where there is no CUDA device."""
    from shotgun_tpu_torch.tools.profile_align import profile_route, stream_align
    from shotgun_tpu_torch.utils.synth import synth_genomes as t_synth_genomes
    from shotgun_tpu_torch.utils.synth import synth_reads as t_synth_reads
    from shotgun_tpu_torch.utils.synth import write_fastq

    rng = np.random.default_rng(5)
    genomes = t_synth_genomes(rng, 4, 3000)
    reads = t_synth_reads(rng, genomes, 300, 150)
    fq = str(tmp_path / "r.fq")
    write_fastq(fq, reads.codes)
    ref = KmerReference(31, genomes, device=CPU)
    prof = profile_route(ref, fq, CPU, 128, repeats=1)
    assert prof["reads"] == 300
    assert prof["stream_reads_per_s"] > 0 and prof["device_ms_per_batch"] > 0
    assert prof["idle_share"] is None and prof["busy_ms"] is None
    stats = stream_align(ref, fq, CPU, 128).get_summary()["Statistics"]
    assert stats["unique_mapped_reads"] == 300


def test_smoke_samples_a_childs_own_resident_memory():
    """``chip_smoke.run_watching_rss`` reads the child's resident memory
    from outside: a child that holds 96 MiB shows at least that, and not
    this process's peak, which ``getrusage`` in the child would echo."""
    import resource
    import sys

    import chip_smoke

    child = ("import time; b = bytearray(96 << 20); b[::4096] = b'x' * (len(b) // 4096); "
             "time.sleep(1.0); print(len(b))")
    proc, peak = chip_smoke.run_watching_rss([sys.executable, "-c", child], 60)
    assert proc.returncode == 0 and proc.stdout.strip() == str(96 << 20)
    assert 96 << 20 <= peak < (96 << 20) + (160 << 20)
    assert peak < resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
