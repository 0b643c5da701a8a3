"""The port's CLI (python -m shotgun_tpu_torch) on the CPU: byte-identical
stdout to every recorded golden (the 16 cases of tests/golden, dumpalign on
every probe route and on the device database build, and the runlog cases
at k = 31, 75 and 150), a .kdb written by the JAX package's CLI, the
device-build gate, the probe routes at k > 31 and for unknown values, k < 1,
the multi-process environment and the one-process mesh, the error contracts of tests/test_cli.py, a
guard that the port runs with jax and the JAX package unimportable, the
library entry points' default device, and the stream's input: a plain
``.fq`` mapped and released with the route, anything else read whole."""

import gc
import gzip
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from shotgun_tpu import cli as jax_cli
from shotgun_tpu_torch import cli
from shotgun_tpu_torch.aligner import PseudoAlignment
from shotgun_tpu_torch.io import data_file
from shotgun_tpu_torch.io.data_file import FASTAFile
from shotgun_tpu_torch.reference import KmerReference
from shotgun_tpu_torch.utils.profiling import PROFILER

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLDEN = os.path.join(HERE, "golden")
DATA = os.path.join(GOLDEN, "data")
FA = os.path.join(DATA, "corpus.fa")
FQ = os.path.join(DATA, "corpus.fq")
DUMPALIGN_CASES = ["plain", "m2", "m0", "p0", "p5", "pneg", "mrq", "mkq",
                   "mg0", "mg1", "mg2", "combo", "sim-align"]
DUMPREF_CASES = ["dumpref", "dumpref-sim75", "dumpref-sim0"]
RUNLOG = os.path.join(GOLDEN, "runlog")
#: the runlog cases: k = 31, and dumpref and dumpalign at k = 75 and 150
RUNLOG_CASES = ["rl-dumpref-sim75-small-k31", "rl-small-k31-flags-m1p1",
                "rl-small-k31-m5p1", "rl-dumpref-small-k75",
                "rl-dumpref-small-k150", "rl-small-k75-m1p1",
                "rl-small-k75-m5p5", "rl-mid-k150-flags", "rl-mid-k150-mg0"]

with open(os.path.join(GOLDEN, "manifest.json")) as _fh:
    _MANIFEST = json.load(_fh)
with open(os.path.join(RUNLOG, "manifest.json")) as _fh:
    _RUNLOG_MANIFEST = json.load(_fh)


def _golden(name: str) -> str:
    with open(os.path.join(GOLDEN, f"{name}.out")) as fh:
        return fh.read()


def _args(name: str):
    return [a.replace("data/", DATA + "/") for a in _MANIFEST[name]["args"]]


GATE_ENV = ("SHOTGUN_TPU_PROBE", "SHOTGUN_TPU_DEVICE_BUILD",
            "SHOTGUN_TPU_DEVICE_BUILD_MIN", "SHOTGUN_TPU_DEVICE_BUILD_MAX")


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("SHOTGUN_TPU_TORCH_DEVICE", "cpu")
    for name in GATE_ENV:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture
def stages():
    """The CLI's ``--profile`` stage names of the next run."""
    PROFILER.stats.clear()
    yield PROFILER.stats
    PROFILER.enabled = False
    PROFILER.stats.clear()


def _exit_message(capsys, argv) -> str:
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert exc.value.code not in (0, None)
    return str(exc.value.code) + capsys.readouterr().err


def test_manifest_lists_every_dumpalign_case():
    assert sorted(DUMPALIGN_CASES) == sorted(
        n for n, c in _MANIFEST.items() if c["args"][1] == "dumpalign")
    assert sorted(DUMPALIGN_CASES + DUMPREF_CASES) == sorted(_MANIFEST)
    assert sorted(RUNLOG_CASES) == sorted(_RUNLOG_MANIFEST)


@pytest.mark.parametrize("name", DUMPALIGN_CASES)
def test_golden_dumpalign(name, capsys):
    cli.main(_args(name) + ["--batch-size", "16"])
    assert capsys.readouterr().out == _golden(name)


@pytest.mark.parametrize("name", DUMPREF_CASES)
def test_golden_dumpref(name, capsys):
    cli.main(_args(name))
    assert capsys.readouterr().out == _golden(name)


@pytest.mark.parametrize("name", RUNLOG_CASES)
def test_runlog_golden(name, capsys):
    args = [a.replace("data/", os.path.join(RUNLOG, "data") + "/")
            for a in _RUNLOG_MANIFEST[name]["args"]]
    cli.main(args + ["--batch-size", "512"])
    with gzip.open(os.path.join(RUNLOG, f"{name}.out.gz"), "rt") as fh:
        assert capsys.readouterr().out == fh.read()


def test_dumpref_of_saved_reference_equals_dumpref_of_genomes(tmp_path, capsys):
    kdb = str(tmp_path / "db.kdb")
    cli.main(["-t", "reference", "-g", FA, "-k", "11", "-r", kdb])
    assert capsys.readouterr().out == ""
    cli.main(["-t", "dumpref", "-r", kdb])
    assert capsys.readouterr().out == _golden("dumpref")


#: probe routes and the forced device build (the corpus is 2.6 kbp, under
#: the device build's default window)
ROUTES = {"sort": {"SHOTGUN_TPU_PROBE": "sort"},
          "hash": {"SHOTGUN_TPU_PROBE": "hash"},
          "device_build": {"SHOTGUN_TPU_DEVICE_BUILD_MIN": "0"}}


@pytest.mark.parametrize("name", DUMPALIGN_CASES)
@pytest.mark.parametrize("route", list(ROUTES))
def test_golden_dumpalign_routes(route, name, capsys, monkeypatch, stages):
    for key, value in ROUTES[route].items():
        monkeypatch.setenv(key, value)
    cli.main(_args(name) + ["--batch-size", "16", "--profile"])
    assert capsys.readouterr().out == _golden(name)
    device_built = route == "device_build" and "--filter-similar" not in _args(name)
    assert ("db_build_device" in stages) == device_built
    assert ("db_build" in stages) != device_built


@pytest.mark.parametrize("env,device_built", [
    ({}, False),                                     # under the 4 Mbp floor
    ({"SHOTGUN_TPU_DEVICE_BUILD_MIN": "0"}, True),
    ({"SHOTGUN_TPU_DEVICE_BUILD_MIN": "0", "SHOTGUN_TPU_DEVICE_BUILD": "0"}, False),
    ({"SHOTGUN_TPU_DEVICE_BUILD_MIN": "0", "SHOTGUN_TPU_DEVICE_BUILD": "yes"}, False),
    ({"SHOTGUN_TPU_DEVICE_BUILD_MIN": "0", "SHOTGUN_TPU_PROBE": "hash16"}, False),
    ({"SHOTGUN_TPU_DEVICE_BUILD_MIN": "0", "SHOTGUN_TPU_DEVICE_BUILD_MAX": "1000"},
     False),                                         # over the ceiling
    ({"SHOTGUN_TPU_DEVICE_BUILD_MIN": "zero"}, False),  # malformed: defaults
    ({"SHOTGUN_TPU_DEVICE_BUILD_MIN": "0", "SHOTGUN_TPU_DEVICE_BUILD_MAX": "x"},
     False),
])
def test_device_build_gate_routes_as_jax(env, device_built, capsys, monkeypatch,
                                         stages):
    """The gate of the JAX package's ``cli.py:301-338``: the build runs on
    the device only with DEVICE_BUILD=1 (the default), the probe auto or
    sort, and the genome size in [MIN, MAX]; a malformed bound sets both
    to their defaults."""
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    cli.main(_args("plain") + ["--profile"])
    assert capsys.readouterr().out == _golden("plain")
    assert ("db_build_device" in stages) == device_built


@pytest.mark.parametrize("task", ["reference", "dumpref"])
def test_host_tasks_build_on_the_host(task, tmp_path, capsys, monkeypatch, stages):
    """The device-build gate is dumpalign's alone: with its window opened
    to the corpus, reference and dumpref -g still build on the host,
    whose postings they save or dump."""
    monkeypatch.setenv("SHOTGUN_TPU_DEVICE_BUILD_MIN", "0")
    kdb = str(tmp_path / "db.kdb")
    argv = ["-t", task, "-g", FA, "-k", "11"] + (["-r", kdb] if task == "reference" else [])
    cli.main(argv + ["--profile"])
    assert "db_build" in stages and "db_build_device" not in stages
    if task == "reference":
        capsys.readouterr()
        cli.main(["-t", "dumpref", "-r", kdb])
    assert capsys.readouterr().out == _golden("dumpref")


def test_kdb_from_jax_reference_task(tmp_path, capsys):
    kdb = str(tmp_path / "corpus.kdb")
    jax_cli.main(["-t", "reference", "-g", FA, "-k", "11", "-r", kdb])
    capsys.readouterr()
    cli.main(["-t", "dumpalign", "-r", kdb, "--reads", FQ])
    assert capsys.readouterr().out == _golden("plain")


def test_corrupt_kdb(tmp_path, capsys):
    bad = tmp_path / "bad.kdb"
    bad.write_bytes(b"not a kdb")
    msg = _exit_message(capsys, ["-t", "dumpalign", "-r", str(bad), "--reads", FQ])
    assert "Error: Incorrect format of input file." in msg


@pytest.mark.parametrize("argv,expect", [
    (["-t", "reference", "-g", FA, "-k", "11", "-r", "x.kdb", "--reads", FQ],
     "Error: For task 'reference', only -g, -k, -r, --filter-similar, and "
     "--similarity-threshold are allowed."),
    (["-t", "dumpref", "-g", FA, "-k", "11", "-m", "2"],
     "Error: For task 'dumpref', only -r or (-g and -k) with --filter-similar "
     "and --similarity-threshold are allowed."),
    (["-t", "align", "-g", FA, "-k", "11", "--reads", FQ, "-a", "x.aln"],
     "Error: For task 'align' with -g, also provide -r to store the reference "
     "database."),
    (["-t", "dumpalign", "-a", "x.aln"],
     "Error: Alignment output file 'x.aln' does not exist or is not a file."),
    (["-t", "bogus"], "Error: Unsupported task."),
    (["-t", "dumpalign", "-g", FA], "Error: For task 'dumpalign', provide"),
    (["-t", "dumpalign", "-g", FA, "-k", "11", "--reads", "missing.fq"],
     "Error: FASTQ reads file 'missing.fq' does not exist"),
])
def test_exits_nonzero(argv, expect, capsys):
    assert expect in _exit_message(capsys, argv)


def _corrupt(tmp_path):
    bad = tmp_path / "bad.kdb"
    bad.write_bytes(b"garbage bytes here")
    return str(bad)


def _genome_txt(tmp_path):
    bad = tmp_path / "genome.txt"
    bad.write_text(">g\nACGT\n")
    return str(bad)


#: the error contracts of tests/test_cli.py (missing file, bad extension,
#: unsupported task, per-task flags, corrupt database, missing inputs, the
#: reference's typo'd long flag, a user-input ValueError), each through the
#: port's CLI: the JAX CLI's message and a non-zero exit
ERROR_CONTRACTS = {
    "missing genome file": (lambda t: ["-t", "dumpref", "-g", "/nope/missing.fa",
                                       "-k", "11"],
                            "does not exist or is not a file"),
    "bad extension": (lambda t: ["-t", "dumpref", "-g", _genome_txt(t), "-k", "3"],
                      "Invalid file extension"),
    "unsupported task": (lambda t: ["-t", "frobnicate"], "Error: Unsupported task."),
    "reference rejects align flags": (
        lambda t: ["-t", "reference", "-g", FA, "-k", "11", "-r",
                   str(t / "x.kdb"), "--reads", FQ], "For task 'reference'"),
    "align requires -a": (lambda t: ["-t", "align", "-g", FA, "-k", "11",
                                     "--reads", FQ], "For task 'align'"),
    "corrupt reference": (lambda t: ["-t", "dumpalign", "-r", _corrupt(t),
                                     "--reads", FQ],
                          "Error: Incorrect format of input file."),
    "corrupt reference, dumpref": (lambda t: ["-t", "dumpref", "-r", _corrupt(t)],
                                   "Error: Incorrect format of input file."),
    "corrupt reference, align": (
        lambda t: ["-t", "align", "-r", _corrupt(t), "--reads", FQ, "-a",
                   str(t / "x.aln")], "Error: Incorrect format of input file."),
    "corrupt alignment": (lambda t: ["-t", "dumpalign", "-a", _corrupt(t)],
                          "Error: Incorrect format of input file."),
    "dumpalign without inputs": (lambda t: ["-t", "dumpalign"],
                                 "provide either -r and --reads"),
    "corrected spelling rejected": (
        lambda t: ["-t", "dumpalign", "-a", "x.aln", "--ambiguous-threshold", "1"],
        "unrecognized arguments"),
    "user-input ValueError": (lambda t: ["-t", "dumpalign", "-g", FA, "-k", "31",
                                         "--reads", FQ, "-m", "-1"],
                              "m must be bigger than or equal to 0"),
    "unwritable output directory": (
        lambda t: ["-t", "reference", "-g", FA, "-k", "11", "-r",
                   "/nope/dir/x.kdb"],
        "Error: Directory '/nope/dir' is not writable to create Reference "
        "database output file '/nope/dir/x.kdb'."),
}


@pytest.mark.parametrize("case", list(ERROR_CONTRACTS))
def test_error_contracts_match_jax(case, tmp_path, capsys):
    argv_of, expect = ERROR_CONTRACTS[case]
    msg = _exit_message(capsys, argv_of(tmp_path))
    assert expect in msg and "Traceback" not in msg
    with pytest.raises(SystemExit) as exc:
        jax_cli.main(argv_of(tmp_path))
    # argparse's usage lines name each package's own program; the error
    # line is the last
    want = str(exc.value.code) + capsys.readouterr().err
    assert (msg.splitlines()[-1].replace("shotgun-tpu-torch", "shotgun-tpu")
            == want.splitlines()[-1])


def test_zero_thresholds_coerced_to_defaults(capsys):
    """-m 0 / -p 0 become 1 / 1, as in the reference."""
    cli.main(["-t", "dumpalign", "-g", FA, "-k", "11", "--reads", FQ,
              "-m", "0", "-p", "0"])
    assert capsys.readouterr().out == _golden("plain")


def test_gzip_inputs_match_plain_golden(tmp_path, capsys):
    fagz, fqgz = str(tmp_path / "corpus.fa.gz"), str(tmp_path / "corpus.fq.gz")
    for src, dst in ((FA, fagz), (FQ, fqgz)):
        with open(src, "rb") as fin, gzip.open(dst, "wb") as fout:
            fout.write(fin.read())
    cli.main(["-t", "dumpalign", "-g", fagz, "-k", "11", "--reads", fqgz])
    assert capsys.readouterr().out == _golden("plain")
    cli.main(["-t", "dumpref", "-g", fagz, "-k", "11"])
    assert capsys.readouterr().out == _golden("dumpref")


CPU = torch.device("cpu")


def _ends(run):
    """The summary ``run()``'s alignment gives, as the JSON that prints
    it reads back, or the (type, message) of what it raises."""
    try:
        return json.loads(json.dumps(run().get_summary()))
    except Exception as exc:
        return type(exc).__name__, str(exc)


def _stream_counters(stats):
    return {k: (st.calls, st.items) for k, st in stats.items()
            if st.counter and k.startswith("stream_")}


def _corpus_reads() -> bytes:
    with open(FQ, "rb") as fh:
        return fh.read()


def _write(path, data: bytes) -> None:
    with open(path, "wb") as fh:
        fh.write(data)


@pytest.mark.parametrize("kind", ["gz", "bad gz", "empty", "fifo"])
def test_stream_reads_whole_what_it_cannot_map(kind, tmp_path, stages):
    """A ``.fq.gz``, an empty ``.fq`` and a FIFO are read whole (counter
    ``stream_read``, never ``stream_mapped``), and the stream route ends
    as the JAX package's: the plain golden's summary, or the same
    exception type and message (``NoRecordsInDataFile`` for the empty
    file, ``BadGzipFile`` for a ``.gz`` that is not gzip).  The FIFO's
    feeder gives the reads once to each open of it."""
    data = _corpus_reads()
    path = str(tmp_path / ("reads.fq.gz" if "gz" in kind else "reads.fq"))
    if kind == "gz":
        with gzip.open(path, "wb") as fh:
            fh.write(data)
    elif kind == "bad gz":
        _write(path, data)
    elif kind == "empty":
        _write(path, b"")
    else:
        os.mkfifo(path)

    def fed(run):
        if kind != "fifo":
            return _ends(run)
        done = threading.Event()

        def feed():  # the reads once to every open of the FIFO, until the run ends
            while not done.is_set():
                try:
                    _write(path, data)
                except BrokenPipeError:
                    pass
                while not done.is_set():  # until the reader has closed it
                    try:
                        os.close(os.open(path, os.O_WRONLY | os.O_NONBLOCK))
                    except OSError:  # ENXIO: no reader
                        break
                    time.sleep(0.01)

        feeder = threading.Thread(target=feed, daemon=True)
        feeder.start()
        try:
            return _ends(run)
        finally:
            done.set()
            os.close(os.open(path, os.O_RDONLY | os.O_NONBLOCK))  # frees a waiting open
            feeder.join(timeout=60)
            assert not feeder.is_alive()

    ref = cli.create_reference(FA, 11, False, 0.95, CPU)
    PROFILER.enable()
    got = fed(lambda: cli.create_alignment_from_reference(ref, path, CPU, 1, 1,
                                                          None, None, None))
    counted = _stream_counters(stages)
    PROFILER.enabled = False
    if kind != "fifo":  # the FIFO's reads are the plain golden's
        jref = jax_cli.create_reference(FA, 11)
        assert got == _ends(lambda: jax_cli.create_alignment_from_reference(
            jref, path, 1, 1, None, None, None))
    if kind in ("gz", "fifo"):
        assert got == json.loads(_golden("plain"))
        assert counted == {"stream_read": (1, len(data))}
    elif kind == "empty":
        assert got == ("NoRecordsInDataFile", f"No valid records found in file: {path}")
        assert counted == {"stream_read": (1, 0)}
    else:
        assert got[0] == "BadGzipFile" and counted == {}


@pytest.mark.parametrize("reads", ["valid", "duplicate id"])
def test_stream_mapping_is_released_with_the_route(reads, tmp_path, monkeypatch, stages):
    """A plain ``.fq`` is mapped (counter ``stream_mapped``, its bytes),
    and the mapping is released once ``create_alignment_from_reference``
    returns, and once the fill's ``NativeParseError`` has sent an invalid
    input to the regex engine, which raises the JAX package's error.
    Reference counts alone release it here (no collector runs), as they
    must between two collections.  A second ``close`` does nothing."""
    data = _corpus_reads()
    if reads == "duplicate id":
        data += b"".join(data.splitlines(keepends=True)[:4])
    path = str(tmp_path / "reads.fq")
    _write(path, data)
    opened = []

    def spy(*args, **kwargs):
        opened.append(data_file.open_fastq_stream(*args, **kwargs))
        return opened[-1]

    monkeypatch.setattr(cli, "open_fastq_stream", spy)
    ref = cli.create_reference(FA, 11, False, 0.95, CPU)
    PROFILER.enable()
    gc.disable()
    try:
        got = _ends(lambda: cli.create_alignment_from_reference(
            ref, path, CPU, 1, 1, None, None, None, batch_size=16))
        (stream,) = opened
        assert stream.raw_bytes().closed
    finally:
        gc.enable()
    stream.close()
    assert stream.raw_bytes().closed
    assert _stream_counters(stages) == {"stream_mapped": (1, len(data))}
    PROFILER.enabled = False
    jref = jax_cli.create_reference(FA, 11)
    assert got == _ends(lambda: jax_cli.create_alignment_from_reference(
        jref, path, 1, 1, None, None, None, batch_size=16))
    if reads == "valid":
        assert got == json.loads(_golden("plain"))
    else:
        assert got[0] == "DuplicateRecordError"


def test_align_task_store_from_a_mapping_equals_the_read_one(tmp_path, stages):
    """The align task's read store (``store_reads=True``: ids from the
    native pass over the input, mapping lists) from a mapped ``.fq``
    equals the one from the same reads read whole out of a ``.fq.gz``,
    member by member of the saved ``.aln``."""
    data = _corpus_reads()
    plain, packed = str(tmp_path / "reads.fq"), str(tmp_path / "reads.fq.gz")
    _write(plain, data)
    with gzip.open(packed, "wb") as fh:
        fh.write(data)
    ref = cli.create_reference(FA, 11, False, 0.95, CPU)
    PROFILER.enable()
    saved = []
    for i, path in enumerate((plain, packed)):
        stages.clear()
        aln = cli.create_alignment_from_reference(ref, path, CPU, 1, 1, None, None,
                                                  None, batch_size=16, store_reads=True)
        assert list(_stream_counters(stages)) == [("stream_mapped", "stream_read")[i]]
        assert len(aln._read_ids) == data.count(b"\n") // 4
        aln.save(str(tmp_path / f"{i}.aln"))
        with np.load(str(tmp_path / f"{i}.aln")) as npz:
            saved.append({k: npz[k] for k in npz.files})
    assert saved[0].keys() == saved[1].keys()
    for k in saved[0]:
        assert np.array_equal(saved[0][k], saved[1][k]), k


def test_bad_extension(tmp_path, capsys):
    reads = tmp_path / "reads.txt"
    reads.write_text("@r\nACGT\n+\nIIII\n")
    msg = _exit_message(capsys, ["-t", "dumpalign", "-g", FA, "-k", "11",
                                 "--reads", str(reads)])
    assert "Invalid file extension" in msg


K35 = ["-t", "dumpalign", "-g", FA, "-k", "35", "--reads", FQ]


def _both(argv, capsys):
    """(the port's stdout, the JAX CLI's) of one argv."""
    cli.main(argv)
    mine = capsys.readouterr().out
    jax_cli.main(argv)
    return mine, capsys.readouterr().out


@pytest.mark.parametrize("env,expect", [
    ({"SHOTGUN_TPU_PROBE": "sort"}, "sort-join probe"),
    ({}, "k=35 > 31"),
])
def test_unported_probes_raise(env, expect, monkeypatch, capsys):
    """The probes that once raised here are ported: the sort join gives
    the plain golden, and k = 35 (the sort join of multi-word keys) the
    JAX CLI's stdout."""
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    if env:
        cli.main(_args("plain"))
        assert capsys.readouterr().out == _golden("plain")
        return
    mine, theirs = _both(K35, capsys)
    assert mine == theirs and json.loads(mine)["Statistics"]["unique_mapped_reads"] > 0


@pytest.mark.parametrize("probe", ["hash16", "sort", "bogus", ""])
def test_k35_probe_values_take_the_word_join(probe, monkeypatch, capsys):
    """At k > 31 every SHOTGUN_TPU_PROBE value but 'hash' takes the sort
    join of multi-word keys, as in the JAX package: auto's stdout."""
    cli.main(K35)
    auto = capsys.readouterr().out
    monkeypatch.setenv("SHOTGUN_TPU_PROBE", probe)
    assert _both(K35, capsys) == (auto, auto)


@pytest.mark.parametrize("extra", [[], ["--min-kmer-quality", "60"]], ids=["ungated", "mkq"])
def test_k35_dumpalign_g_takes_the_device_build(extra, monkeypatch, capsys, stages):
    """Inside the device-build window, -g at k = 35 builds on the device
    (stage ``db_build_device``, its words counted in ``db_build_words``)
    and aligns by the sort join (``sort_join_device``,
    ``sort_join_rows``): the JAX CLI's stdout, which builds on the host."""
    monkeypatch.setenv("SHOTGUN_TPU_DEVICE_BUILD_MIN", "0")
    mine, theirs = _both(K35 + extra + ["--batch-size", "16", "--profile"], capsys)
    assert mine == theirs and json.loads(mine)["Statistics"]["unique_mapped_reads"] > 0
    for name in ("db_build_device", "db_build_words", "sort_join_device", "sort_join_rows"):
        assert name in stages, name
    assert "db_build" not in stages
    assert stages["db_build_words"].items == 2


def test_k35_hash_probe_raises_jax_value_error(monkeypatch):
    monkeypatch.setenv("SHOTGUN_TPU_PROBE", "hash")
    msgs = []
    for main in (cli.main, jax_cli.main):
        with pytest.raises(ValueError) as exc:
            main(K35)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] == (
        "the bucketized hash probe supports k <= 31 only; use the sort-merge "
        "probe (SHOTGUN_TPU_PROBE=sort) for k=35")
    ref = KmerReference(35, FASTAFile(FA).container)
    with pytest.raises(ValueError, match=r"supports k <= 31 only \(k=35\)"):
        ref.probe_table()


@pytest.mark.parametrize("probe", ["", "HASH", "bogus"])
def test_unknown_probe_values_take_the_4_slot_hash(probe, monkeypatch, capsys):
    """At k <= 31 a SHOTGUN_TPU_PROBE value outside auto|sort|hash|hash16
    takes the 4-slot hash table, as in the JAX package."""
    monkeypatch.setenv("SHOTGUN_TPU_PROBE", probe)
    ref = KmerReference(11, FASTAFile(FA).container)
    assert ref.probe_method() == "hash"
    assert ref.device_probe_tables(torch.device("cpu")).table.shape[1] == 4
    mine, theirs = _both(_args("plain"), capsys)
    assert mine == theirs == _golden("plain")


def _k_below_1(route, k, tmp_path, gate):
    """The argv list of one route at k, each package with its own files:
    dumpalign -g, reference then dumpalign -r, reference then align -r
    then dumpalign -a."""
    def argvs(tag):
        kdb, aln = str(tmp_path / f"{tag}.kdb"), str(tmp_path / f"{tag}.aln")
        ref = ["-t", "reference", "-g", FA, "-k", k, "-r", kdb]
        if route == "-g":
            return [["-t", "dumpalign", "-g", FA, "-k", k, "--reads", FQ] + gate]
        if route == "-r":
            return [ref, ["-t", "dumpalign", "-r", kdb, "--reads", FQ] + gate]
        return [ref, ["-t", "align", "-r", kdb, "--reads", FQ, "-a", aln] + gate,
                ["-t", "dumpalign", "-a", aln]]
    return argvs("port"), argvs("jax")


@pytest.mark.parametrize("gate", [[], ["--min-read-quality", "60"]], ids=["none", "mrq"])
@pytest.mark.parametrize("route", ["-g", "-r", "align"])
def test_k_below_1_maps_no_read_as_jax(route, gate, tmp_path, capsys):
    """k < 1: the index is empty in both packages and every read that
    passes the MRQ gate is unmapped; stdout byte-equal to the JAX CLI's."""
    outs = []
    for main, argvs in zip((cli.main, jax_cli.main), _k_below_1(route, "-3", tmp_path, gate)):
        for argv in argvs:
            main(argv)
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    stats = json.loads(outs[0])["Statistics"]
    assert stats["unique_mapped_reads"] == stats["ambiguous_mapped_reads"] == 0
    assert stats["unmapped_reads"] + stats.get("filtered_quality_reads", 0) == 50


@pytest.mark.parametrize("route", ["-g", "-r", "align"])
def test_k_below_1_with_mkq_fails_in_both_clis(route, tmp_path, capsys):
    """With --min-kmer-quality at k < 1 the JAX CLI fails (a shape error
    in its window sums); the port exits non-zero with a message that
    names k."""
    mine, theirs = _k_below_1(route, "-3", tmp_path, ["--min-kmer-quality", "20"])
    fail = 0 if route == "-g" else 1  # the argv that aligns
    for argv in mine[:fail]:
        cli.main(argv)
    msg = _exit_message(capsys, mine[fail])
    assert "k=-3" in msg and "Traceback" not in msg
    for argv in theirs[:fail]:
        jax_cli.main(argv)
    with pytest.raises(TypeError):
        jax_cli.main(theirs[fail])


@pytest.mark.parametrize("task", [["-t", "dumpalign", "-g", FA, "-k", "11", "--reads", FQ],
                                  ["-t", "dumpalign", "-a", "x.aln"]])
def test_multi_process_dumpalign_is_not_ported(task, monkeypatch, capsys):
    """The multi-process dumpalign is ported (tests/test_torch_distributed.py
    runs two processes): SHOTGUN_TPU_NPROCS=2 without SHOTGUN_TPU_PROC_ID
    raises KeyError, as in the JAX CLI, before any input is read; NPROCS=1
    is one process."""
    monkeypatch.setenv("SHOTGUN_TPU_NPROCS", "2")
    monkeypatch.delenv("SHOTGUN_TPU_PROC_ID", raising=False)
    for main in (cli.main, jax_cli.main):
        with pytest.raises(KeyError, match="SHOTGUN_TPU_PROC_ID"):
            main(task)
    monkeypatch.setenv("SHOTGUN_TPU_NPROCS", "1")
    cli.main(_args("plain"))
    assert capsys.readouterr().out == _golden("plain")


@pytest.mark.parametrize("name", ["plain", "mrq", "combo", "mg1"])
def test_one_process_mesh_matches_golden(name, monkeypatch, capsys, stages):
    """SHOTGUN_TPU_MESH=data: one process's mesh over the local devices
    (the CPU here), the JAX CLI's mesh route (the reads parsed whole and
    aligned by align_packed_reads, the database of -g built on the host)."""
    monkeypatch.setenv("SHOTGUN_TPU_MESH", "data")
    cli.main(_args(name) + ["--batch-size", "16", "--profile"])
    assert capsys.readouterr().out == _golden(name)
    assert {"db_build", "fastq_parse", "align"} <= set(stages)
    assert "stream_align" not in stages and "db_build_device" not in stages


def test_filter_similar_at_256_genomes_matches_jax(tmp_path, capsys):
    """EXTSIM at 256 genome identifiers, where its overlap matrix runs on
    the device in both packages: the port's dumpalign equals the JAX
    CLI's, which runs its own XLA product there."""
    fa = tmp_path / "many.fa"
    fa.write_text("".join(f">g{i}\n{'ACGT'[i % 4] * 8}{'ACGTTGCA' * 3}\n"
                          for i in range(256)))
    argv = ["-t", "dumpalign", "-g", str(fa), "-k", "11", "--reads", FQ,
            "--filter-similar"]
    cli.main(argv)
    out = capsys.readouterr().out
    jax_cli.main(argv)
    assert out == capsys.readouterr().out
    assert json.loads(out)["Statistics"]["unique_mapped_reads"] >= 0


def test_cuda_requested_without_cuda(monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    monkeypatch.setenv("SHOTGUN_TPU_TORCH_DEVICE", "cuda")
    msg = _exit_message(capsys, _args("plain"))
    assert "torch.cuda.is_available() is false" in msg


_NO_JAX = r"""
import ast, os, pkgutil, sys, tempfile
sys.modules["jax"] = None  # any import of jax now raises ImportError
sys.modules["shotgun_tpu"] = None  # and so does any import of the JAX package
import shotgun_tpu_torch
for mod in pkgutil.walk_packages(shotgun_tpu_torch.__path__, "shotgun_tpu_torch."):
    __import__(mod.name)
import shotgun_tpu_torch.parallel.distributed, shotgun_tpu_torch.parallel.mesh
import shotgun_tpu_torch.parallel.table_sharded, shotgun_tpu_torch.tools.dryrun
import shotgun_tpu_torch.tools.bulk_proof, shotgun_tpu_torch.tools.devbuild_proof
import shotgun_tpu_torch.tools.profile_devbuild
# every import chip_smoke.py makes, at its top and inside its functions
with open("chip_smoke.py") as fh:
    for node in ast.walk(ast.parse(fh.read())):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            exec(compile(ast.Module([node], []), "chip_smoke.py", "exec"), {})
from shotgun_tpu_torch.cli import main
from shotgun_tpu_torch.io import native
assert native.library_path() == os.path.join(os.getcwd(), "build", "host",
                                             "libshotgun_tpu_torch_io.so")
fa, fq = sys.argv[1:3]
main(sys.argv[3:])  # the plain golden
os.environ["SHOTGUN_TPU_MESH"] = "data"  # again over a one-process mesh
main(sys.argv[3:])
del os.environ["SHOTGUN_TPU_MESH"]
with tempfile.TemporaryDirectory() as tmp:  # reference -> align -> dumpalign -a
    kdb, aln = os.path.join(tmp, "c.kdb"), os.path.join(tmp, "c.aln")
    main(["-t", "reference", "-g", fa, "-k", "11", "-r", kdb])
    main(["-t", "align", "-r", kdb, "--reads", fq, "-a", aln])
    main(["-t", "dumpalign", "-a", aln])
main(["-t", "dumpalign", "-g", fa, "-k", "35", "--reads", fq])  # multi-word keys
loaded = [m for m, v in sys.modules.items() if v is not None and (
    m in ("jax", "jaxlib", "shotgun_tpu") or m.startswith(("jax.", "jaxlib.", "shotgun_tpu.")))]
assert not loaded, loaded
"""


def test_runs_with_jax_unimportable(capsys):
    """With jax and the JAX package unimportable, every port module (the
    parallel modules, tools/dryrun, the proof tools and the benchmark and
    stage profilers named) and every
    import of chip_smoke.py loads, the native library is the port's own under
    build/host/, and the CLI prints the plain golden, directly, over a
    one-process mesh and through reference -> align -> dumpalign -a, and
    the JAX CLI's stdout at k = 35."""
    jax_cli.main(K35)
    k35 = capsys.readouterr().out
    env = dict(os.environ, SHOTGUN_TPU_TORCH_DEVICE="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _NO_JAX, FA, FQ] + _args("plain"),
        cwd=REPO, capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout == _golden("plain") * 3 + k35


ENTRY_POINTS = {
    "KmerReference": lambda t: KmerReference(11, FASTAFile(FA).container),
    "KmerReference.load": lambda t: KmerReference.load(str(t / "c.kdb")),
    "KmerReference.from_device_build": lambda t: KmerReference.from_device_build(
        FASTAFile(FA).container.to_genome_arrays(), 11),
    "PseudoAlignment.load": lambda t: PseudoAlignment.load(str(t / "c.aln")),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_default_to_the_card(entry, tmp_path, monkeypatch):
    """Without a device the library entry points take resolve_device()'s:
    $SHOTGUN_TPU_TORCH_DEVICE, else cuda, which raises where CUDA is
    absent (made absent here, whatever the machine has)."""
    cli.main(["-t", "reference", "-g", FA, "-k", "11", "-r", str(tmp_path / "c.kdb")])
    cli.main(["-t", "align", "-r", str(tmp_path / "c.kdb"), "--reads", FQ,
              "-a", str(tmp_path / "c.aln")])
    assert ENTRY_POINTS[entry](tmp_path).device == torch.device("cpu")
    monkeypatch.delenv("SHOTGUN_TPU_TORCH_DEVICE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available.. is false"):
        ENTRY_POINTS[entry](tmp_path)
