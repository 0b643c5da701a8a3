"""The align task's read store of the port against the JAX package's:
the device list step (``models.pipeline.store_lists``) against its numpy
version on random batch outputs, and the read store of the stream and
container routes against the JAX ``PseudoAlignment`` (ids, mapping types,
mapping lists, summary), on every probe, at two batch sizes, with MRQ
filtering and with duplicate read ids.  Tolerance 0 throughout."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shotgun_tpu import aligner as jaligner
from shotgun_tpu.index.build import build_index
from shotgun_tpu.io.data_file import open_fastq_stream
from shotgun_tpu.io.records import SeqRecord
from shotgun_tpu.models import pipeline as jpipe
from shotgun_tpu.reference import KmerReference as JaxKmerReference
from shotgun_tpu.utils.synth import synth_genomes, synth_reads, to_fastq
from shotgun_tpu_torch import aligner, convert
from shotgun_tpu_torch.models import pipeline as tpipe

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _random_result(rng, b, r, w):
    """A BatchResult as core_from_probe gives one: ambiguous rows with
    lists of any length (empty ones too), downgraded rows whose winner is
    in their list, MRQ-filtered rows, first windows below ``w``."""
    mtype = rng.integers(0, 3, size=b).astype(np.int32)
    winner = rng.integers(0, r, size=b).astype(np.int32)
    amb = (rng.random((b, r)) < rng.random((b, 1)) * 0.5) & (mtype == 2)[:, None]
    downgraded = (rng.random(b) < 0.4) & (mtype == 2)
    amb[np.arange(b), winner] |= downgraded
    fw = rng.integers(0, w, size=(b, r)).astype(np.int32)
    filtered = rng.random(b) < 0.15
    zeros = np.zeros(b, dtype=np.int32)
    return (mtype, winner, downgraded, amb, fw, filtered, zeros, zeros)


@pytest.mark.parametrize("r", [7, 600])
@pytest.mark.parametrize("max_w", [40, 0x7FFF + 5])
def test_store_lists_matches_plain(r, max_w):
    """Both key dtypes of the JAX package's packed store words (int16
    below 0x7FFF windows, int32 from there), R above 512, downgraded and
    filtered rows, and a padded tail that is not stored."""
    rng = np.random.default_rng(r + max_w)
    b, rows = 96, 90
    fields = _random_result(rng, b, r, min(max_w, 40000))
    word, keys = jpipe.pack_store_words(
        jpipe.BatchResult(*(jnp.asarray(x) for x in fields)), max_w=max_w)
    assert keys.dtype == (jnp.int16 if max_w < 0x7FFF else jnp.int32)
    want = tpipe.store_lists_plain(np.asarray(word)[:rows],
                                   np.asarray(keys)[:rows], r)
    got = tpipe.store_lists(
        tpipe.BatchResult(*(torch.from_numpy(np.array(x)) for x in fields)), rows)
    assert got.word.dtype == torch.int8 and got.flat.dtype == torch.int64
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w_)
    assert (want[1] > 1).any() and (want[1] == 0).any()


def _workload(seed, n_reads=200, read_len=60, genome_len=1500):
    """Genomes where genome 1 repeats a stretch of genome 0 and genome 3
    one of genome 2, and reads with mutations and varied quality: unique,
    ambiguous, downgraded and unmapped reads all occur."""
    rng = np.random.default_rng(seed)
    genomes = synth_genomes(rng, 5, genome_len)
    genomes.codes[genome_len: genome_len + 500] = genomes.codes[:500]
    genomes.codes[3 * genome_len: 3 * genome_len + 300] = \
        genomes.codes[2 * genome_len: 2 * genome_len + 300]
    reads = synth_reads(rng, genomes, n_reads, read_len)
    mutate = rng.random(reads.codes.shape) < 0.03
    reads.codes[mutate] = rng.integers(0, 4, size=mutate.sum())
    reads.qual[:] = rng.integers(60, 91, size=reads.qual.shape)
    return genomes, reads


def _assert_store_equal(pa, jpa):
    assert pa._read_ids == jpa._read_ids
    assert pa._mtypes == [int(x) for x in jpa._mtypes]
    assert pa._list_counts == [int(x) for x in jpa._list_counts]
    cat = [np.concatenate(x._list_flat) if x._list_flat else np.zeros(0, np.int64)
           for x in (pa, jpa)]
    assert cat[0].dtype == cat[1].dtype == np.int64
    np.testing.assert_array_equal(cat[0], cat[1])
    assert pa.get_summary() == jpa.get_summary()
    np.testing.assert_array_equal(pa._first_batch, jpa._first_batch)
    np.testing.assert_array_equal(pa._first_key, jpa._first_key)


K = 21


@pytest.fixture(scope="module")
def work():
    genomes, reads = _workload(5)
    return genomes, reads, build_index(genomes, K)


@pytest.mark.parametrize("probe,batch,mrq", [
    ("sort", 32, None), ("sort", 200, 75),
    ("hash", 32, 75), ("hash", 200, None),
    ("hash16", 32, None), ("hash16", 200, 75)])
def test_stream_store_matches_jax(probe, batch, mrq, work, tmp_path, monkeypatch):
    """align_stream(store_reads=True) on each probe, at a batch that
    splits the input into seven (the last one padded) and at one batch.
    The JAX side runs without its superbatch, whose padded tail it counts
    in the batch counter (an output-neutral difference)."""
    monkeypatch.setenv("SHOTGUN_TPU_PROBE", probe)
    monkeypatch.setenv("SHOTGUN_TPU_SUPERBATCH", "1")
    genomes, reads, index = work
    fq = tmp_path / "reads.fq"
    fq.write_text(to_fastq(reads))
    gates = (mrq, None, None)
    jpa = jaligner.PseudoAlignment(JaxKmerReference(K, _index=index))
    jpa.align_stream(open_fastq_stream(str(fq), lazy=True), 1, 1, *gates,
                     batch_size=batch, store_reads=True)
    ref = convert.reference(index)
    pa = aligner.PseudoAlignment(ref, CPU)
    pa.align_stream(open_fastq_stream(str(fq), lazy=True), 1, 1, *gates,
                    batch_size=batch, store_reads=True)
    assert ref.probe_method() == probe
    _assert_store_equal(pa, jpa)
    assert pa._batch_no == jpa._batch_no == -(-reads.num_reads // batch)
    assert set(pa._mtypes) == {0, 1, 2}
    if mrq is not None:
        assert 0 < len(pa._read_ids) < reads.num_reads


def _records(reads, ids=None):
    ids = ids if ids is not None else reads.ids
    out = []
    for i, rid in enumerate(ids):
        li = int(reads.lengths[i])
        seq = np.frombuffer(b"ACGT", dtype=np.uint8)[reads.codes[i, :li]].tobytes()
        out.append(SeqRecord([("identifier", rid), ("sequence", seq.decode()),
                              ("quality_sequence", reads.qual[i, :li].tobytes().decode())]))
    return out


@pytest.mark.parametrize("batch,mrq", [(24, None), (64, 75)])
def test_container_store_matches_jax(batch, mrq, work):
    """The container route (store_reads defaults to True there, as in the
    JAX package) at fewer than 8 batches, below the JAX superbatch."""
    genomes, reads, index = work
    recs = _records(reads)[:150]
    jpa = jaligner.PseudoAlignment(JaxKmerReference(K, _index=index))
    jpa.align_reads_from_container(recs, 2, 0, mrq, 80, 3, batch_size=batch)
    pa = aligner.PseudoAlignment(convert.reference(index), CPU)
    pa.align_reads_from_container(recs, 2, 0, mrq, 80, 3, batch_size=batch)
    _assert_store_equal(pa, jpa)
    assert pa._batch_no == jpa._batch_no


@pytest.mark.parametrize("where", ["earlier call", "same batch", "later batch"])
def test_duplicate_read_id_matches_jax(where, work):
    """A duplicate id raises AddingExistingRead with the reference's
    message at the first duplicate; the reads before it stay stored and
    no total moves."""
    genomes, reads, index = work
    recs = _records(reads)
    # the duplicated read passes the MRQ gate (a filtered read is not
    # stored, so its id can come again), and filtered reads precede it
    dup = next(i for i in range(3, 40) if reads.qual[i].mean() >= 75
               and (reads.qual[:i].mean(axis=1) < 75).any())
    if where == "earlier call":
        first, second = recs[:40], recs[40:60] + [recs[dup]] + recs[60:70]
    else:
        at = 45 if where == "same batch" else 50
        first, second = [], recs[:at] + [recs[dup]] + recs[at:70]
    states = []
    for pa, err in ((aligner.PseudoAlignment(convert.reference(index), CPU),
                     aligner.AddingExistingRead),
                    (jaligner.PseudoAlignment(JaxKmerReference(K, _index=index)),
                     jaligner.AddingExistingRead)):
        if first:
            pa.align_reads_from_container(first, 1, 1, 75, batch_size=48)
        with pytest.raises(err) as exc:
            pa.align_reads_from_container(second, 1, 1, 75, batch_size=48)
        states.append((pa, str(exc.value)))
    (pa, msg), (jpa, jmsg) = states
    assert msg == jmsg == ("There already exists a read with identifier: "
                           + recs[dup].identifier)
    _assert_store_equal(pa, jpa)
    assert pa._batch_no == jpa._batch_no


def test_duplicate_read_id_through_the_cli_matches_jax(work, tmp_path, monkeypatch):
    """-t align on a FASTQ that repeats an id: the stream's validation
    rejects the file, and the regex engine raises the parser's
    DuplicateRecordError in both packages (the read store's
    AddingExistingRead is reached only across calls); no .aln is
    written."""
    from shotgun_tpu import cli as jax_cli
    from shotgun_tpu.io.records import DuplicateRecordError
    from shotgun_tpu_torch import cli

    monkeypatch.setenv("SHOTGUN_TPU_TORCH_DEVICE", "cpu")
    genomes, reads, index = work
    text = to_fastq(reads).splitlines(keepends=True)
    fq = tmp_path / "dup.fq"
    fq.write_text("".join(text[:4 * 120] + text[4 * 7: 4 * 8] + text[4 * 120:]))
    kdb = str(tmp_path / "db.kdb")
    JaxKmerReference(K, _index=index).save(kdb)
    msgs = []
    for main, name in ((cli.main, "p.aln"), (jax_cli.main, "j.aln")):
        with pytest.raises(DuplicateRecordError) as exc:
            main(["-t", "align", "-r", kdb, "--reads", str(fq), "-a",
                  str(tmp_path / name), "--batch-size", "64"])
        msgs.append(str(exc.value))
        assert not (tmp_path / name).exists()
    assert msgs[0] == msgs[1] == ("Duplicate record found with unique index: "
                                  + reads.ids[7])


def test_store_accessors_match_jax(work, tmp_path):
    genomes, reads, index = work
    recs = _records(reads)[:80]
    jpa = jaligner.PseudoAlignment(JaxKmerReference(K, _index=index))
    jpa.align_reads_from_container(recs, batch_size=32)
    pa = aligner.PseudoAlignment(convert.reference(index), CPU)
    pa.align_reads_from_container(recs, batch_size=32)
    for t in aligner.ReadMappingType:
        assert pa.get_reads_by_mapping_type(t) == jpa.get_reads_by_mapping_type(
            jaligner.ReadMappingType[t.name])
    assert repr(pa) == repr(jpa)
    pa.export_summary_to_json(str(tmp_path / "p.json"))
    jpa.export_summary_to_json(str(tmp_path / "j.json"))
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()
    assert json.loads((tmp_path / "p.json").read_text()) == pa.get_summary()


def test_dumpalign_routes_store_nothing(work, tmp_path):
    """Without store_reads the stream keeps only the aggregation."""
    genomes, reads, index = work
    fq = tmp_path / "reads.fq"
    fq.write_text(to_fastq(reads))
    pa = aligner.PseudoAlignment(convert.reference(index), CPU)
    pa.align_stream(open_fastq_stream(str(fq), lazy=True), batch_size=64)
    assert pa._read_ids == [] and pa._list_flat == [] and pa._n_unique > 0
