"""The port's files against the JAX package's: a ``.kdb`` written by the
port's ``-t reference`` is byte-equal to the JAX CLI's, an ``.aln``
written by its ``-t align`` equals the JAX CLI's member by member and
byte for byte, and each package reads the other's files
(``dumpalign -a``, ``dumpalign -r``, ``dumpref -r``), at k = 11, 31 and
75."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from shotgun_tpu import cli as jax_cli
from shotgun_tpu.index.build import build_index
from shotgun_tpu.io.packing import pack_genomes
from shotgun_tpu.io.records import SeqRecord
from shotgun_tpu_torch import cli, convert
from shotgun_tpu_torch.aligner import PseudoAlignment
from shotgun_tpu_torch.reference import KmerReference

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")
FA = os.path.join(GOLDEN, "data", "corpus.fa")
FQ = os.path.join(GOLDEN, "data", "corpus.fq")
SMALL_FA = os.path.join(GOLDEN, "runlog", "data", "small.fa")
SMALL_FQ = os.path.join(GOLDEN, "runlog", "data", "small_se_n1000.fq.gz")
COMBO = ["--min-read-quality", "75", "--min-kmer-quality", "82",
         "--max-genomes", "2", "-m", "2", "-p", "3"]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("SHOTGUN_TPU_TORCH_DEVICE", "cpu")
    for name in ("SHOTGUN_TPU_PROBE", "SHOTGUN_TPU_DEVICE_BUILD",
                 "SHOTGUN_TPU_DEVICE_BUILD_MIN", "SHOTGUN_TPU_SUPERBATCH"):
        monkeypatch.delenv(name, raising=False)


def _run(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _golden(name):
    with open(os.path.join(GOLDEN, f"{name}.out")) as fh:
        return fh.read()


@pytest.mark.parametrize("fa,k,extra", [
    (FA, "11", []),
    (FA, "11", ["--filter-similar", "--similarity-threshold", "0.5"]),
    (SMALL_FA, "31", []),
    (SMALL_FA, "75", []),
])
def test_kdb_byte_equal_to_jax(fa, k, extra, tmp_path):
    mine, theirs = str(tmp_path / "port.kdb"), str(tmp_path / "jax.kdb")
    _run(cli.main, ["-t", "reference", "-g", fa, "-k", k, "-r", mine] + extra)
    _run(jax_cli.main, ["-t", "reference", "-g", fa, "-k", k, "-r", theirs] + extra)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    # each package dumps the other's database as its own
    assert (_run(cli.main, ["-t", "dumpref", "-r", theirs])
            == _run(jax_cli.main, ["-t", "dumpref", "-r", mine]))


def _align_both(tmp_path, monkeypatch, route, extra, fa=FA, fq=FQ, k="11"):
    """The same align task through both CLIs on the same .kdb; the JAX
    side without its superbatch (see test_jax_superbatch_counts_its_tail)."""
    kdb = str(tmp_path / "db.kdb")
    _run(jax_cli.main, ["-t", "reference", "-g", fa, "-k", k, "-r", kdb])
    if route != "auto":
        monkeypatch.setenv("SHOTGUN_TPU_PROBE", route)
    monkeypatch.setenv("SHOTGUN_TPU_SUPERBATCH", "1")
    mine, theirs = str(tmp_path / "port.aln"), str(tmp_path / "jax.aln")
    argv = ["-t", "align", "-r", kdb, "--reads", fq, "--batch-size", "16"] + extra
    _run(cli.main, argv + ["-a", mine])
    _run(jax_cli.main, argv + ["-a", theirs])
    return mine, theirs


@pytest.mark.parametrize("extra", [[], COMBO], ids=["plain", "combo"])
@pytest.mark.parametrize("route", ["sort", "hash", "hash16"])
def test_aln_equal_to_jax(route, extra, tmp_path, monkeypatch):
    mine, theirs = _align_both(tmp_path, monkeypatch, route, extra)
    with np.load(mine) as a, np.load(theirs) as b:
        assert a.files == b.files
        for name in b.files:
            assert a[name].dtype == b[name].dtype, name
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


def test_aln_equal_to_jax_at_k31(tmp_path, monkeypatch):
    """The k = 31 runlog panel: 1000 gzipped reads, the MRQ/MKQ/MG gates."""
    mine, theirs = _align_both(
        tmp_path, monkeypatch, "auto",
        ["--min-read-quality", "59", "--min-kmer-quality", "60", "--max-genomes", "2"],
        fa=SMALL_FA, fq=SMALL_FQ, k="31")
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("gates", [[], ["--min-read-quality", "59", "--min-kmer-quality",
                                         "60", "--max-genomes", "2"]],
                         ids=["plain", "gates"])
def test_reference_align_dumpalign_at_k75_equal_to_jax(gates, tmp_path, monkeypatch):
    """Multi-word keys through the files: each package's reference ->
    align -> dumpalign -a at k = 75 on the runlog panel; the .kdb and .aln
    files and the stdout byte-equal, and dumpalign -a equal to dumpalign
    -r --reads."""
    monkeypatch.setenv("SHOTGUN_TPU_SUPERBATCH", "1")
    outs, files = [], []
    for tag, main in (("port", cli.main), ("jax", jax_cli.main)):
        kdb, aln = str(tmp_path / f"{tag}.kdb"), str(tmp_path / f"{tag}.aln")
        _run(main, ["-t", "reference", "-g", SMALL_FA, "-k", "75", "-r", kdb])
        _run(main, ["-t", "align", "-r", kdb, "--reads", SMALL_FQ, "-a", aln,
                    "--batch-size", "256"] + gates)
        outs.append(_run(main, ["-t", "dumpalign", "-a", aln]))
        files.append((kdb, aln))
    for mine, theirs in zip(*files):
        with open(mine, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read(), mine
    assert outs[0] == outs[1] == _run(
        cli.main, ["-t", "dumpalign", "-r", files[0][0], "--reads", SMALL_FQ] + gates)
    stats = json.loads(outs[0])["Statistics"]
    assert stats["unique_mapped_reads"] > 0 and stats["ambiguous_mapped_reads"] > 0


def test_jax_superbatch_counts_its_tail(tmp_path, monkeypatch):
    """The JAX stream route runs S batches at a time and counts the padded
    tail of the last S in its batch counter (``.aln`` meta counters[6]);
    the port has no superbatch.  Every other member is equal."""
    kdb = str(tmp_path / "db.kdb")
    _run(jax_cli.main, ["-t", "reference", "-g", FA, "-k", "11", "-r", kdb])
    argv = ["-t", "align", "-r", kdb, "--reads", FQ, "--batch-size", "4", "-a"]
    _run(cli.main, argv + [str(tmp_path / "port.aln")])
    _run(jax_cli.main, argv + [str(tmp_path / "jax.aln")])
    mine = PseudoAlignment.load(str(tmp_path / "port.aln"))
    theirs = PseudoAlignment.load(str(tmp_path / "jax.aln"))
    assert (mine._batch_no, theirs._batch_no) == (13, 16)  # 50 reads, 4 a batch
    with np.load(str(tmp_path / "port.aln")) as a, \
            np.load(str(tmp_path / "jax.aln")) as b:
        for name in b.files:
            if name != "meta":
                np.testing.assert_array_equal(a[name], b[name], err_msg=name)


@pytest.mark.parametrize("route", ["sort", "hash", "hash16"])
def test_each_package_reads_the_others_aln(route, tmp_path, monkeypatch):
    mine, theirs = _align_both(tmp_path, monkeypatch, route, [])
    assert _run(jax_cli.main, ["-t", "dumpalign", "-a", mine]) == _golden("plain")
    assert _run(cli.main, ["-t", "dumpalign", "-a", theirs]) == _golden("plain")
    a, b = PseudoAlignment.load(mine), PseudoAlignment.load(theirs)
    assert a._read_ids == b._read_ids and a._mtypes == b._mtypes
    assert a._list_counts == b._list_counts


def test_jax_reads_port_kdb(tmp_path):
    kdb = str(tmp_path / "port.kdb")
    _run(cli.main, ["-t", "reference", "-g", FA, "-k", "11", "-r", kdb])
    assert (_run(jax_cli.main, ["-t", "dumpalign", "-r", kdb, "--reads", FQ])
            == _golden("plain"))


@pytest.mark.parametrize("route", ["sort", "hash", "hash16"])
def test_reference_align_dumpalign_roundtrip(route, tmp_path, monkeypatch):
    """reference -> align -> dumpalign -a through the port alone prints
    the plain golden on every probe.  With -g and -r both given, align
    reads the database from -r, as the JAX CLI does: the same file comes
    out, and a -r that does not exist is the JAX CLI's error."""
    monkeypatch.setenv("SHOTGUN_TPU_PROBE", route)
    kdb, aln = str(tmp_path / "db.kdb"), str(tmp_path / "out.aln")
    _run(cli.main, ["-t", "reference", "-g", FA, "-k", "11", "-r", kdb])
    _run(cli.main, ["-t", "align", "-r", kdb, "--reads", FQ, "-a", aln])
    assert _run(cli.main, ["-t", "dumpalign", "-a", aln]) == _golden("plain")
    aln2 = str(tmp_path / "out2.aln")
    _run(cli.main, ["-t", "align", "-g", FA, "-k", "11", "-r", kdb,
                    "--reads", FQ, "-a", aln2])
    with open(aln, "rb") as a, open(aln2, "rb") as b:
        assert a.read() == b.read()
    missing = str(tmp_path / "new.kdb")
    for main in (cli.main, jax_cli.main):
        with pytest.raises(SystemExit) as exc:
            main(["-t", "align", "-g", FA, "-k", "11", "-r", missing,
                  "--reads", FQ, "-a", aln2])
        assert str(exc.value.code) == (f"Error: Reference database file "
                                       f"'{missing}' does not exist or is not a file.")


def test_device_built_reference_has_nothing_to_save(tmp_path):
    """A device-built reference aligns but holds no host postings: saving
    or dumping it raises a clear error before any file is opened."""
    seqs = ["ACGTTGCAGGCTAACGTTAGC" * 3, "TTGACCGATCGGATCCAGTAC" * 3]
    genomes = pack_genomes([SeqRecord([("description", f"g{i}"), ("genome", s)])
                            for i, s in enumerate(seqs)])
    tgenomes = convert.genome_arrays(genomes)
    ref = KmerReference.from_device_build(tgenomes, 11, torch.device("cpu"))
    assert ref is not None
    assert ref.index.record_lengths.tolist() == [63, 63]
    assert ref.index.kept.all() and ref.similarity_info is None
    path = tmp_path / "x.kdb"
    for call in (lambda: ref.save(str(path)), lambda: ref.write_summary(io.StringIO()),
                 ref.get_summary):
        with pytest.raises(AttributeError, match="device-built reference"):
            call()
    assert not path.exists()
    host = KmerReference(11, tgenomes, device="cpu")
    assert host.kmer_len == 11
    assert host.index.num_kmers == build_index(genomes, 11).num_kmers
