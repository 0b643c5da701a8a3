"""The port's CLI (python -m shotgun_tpu_torch) on the CPU: byte-identical
stdout to every recorded golden (the 16 cases of tests/golden, dumpalign on
every probe route and on the device database build, and the runlog cases
the port runs), a .kdb written by the JAX package's CLI, the device-build
gate, the error contracts of tests/test_cli.py, and a guard that the port
runs with jax unimportable."""

import gzip
import json
import os
import subprocess
import sys

import pytest
import torch

from shotgun_tpu import cli as jax_cli
from shotgun_tpu_torch import cli
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
#: the runlog cases the port runs: every k = 31 case, and dumpref at any
#: k (a host-side task); dumpalign at k = 75 and 150 is not ported
RUNLOG_CASES = ["rl-dumpref-sim75-small-k31", "rl-small-k31-flags-m1p1",
                "rl-small-k31-m5p1", "rl-dumpref-small-k75",
                "rl-dumpref-small-k150"]

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
    assert set(RUNLOG_CASES) <= set(_RUNLOG_MANIFEST)


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


def test_bad_extension(tmp_path, capsys):
    reads = tmp_path / "reads.txt"
    reads.write_text("@r\nACGT\n+\nIIII\n")
    msg = _exit_message(capsys, ["-t", "dumpalign", "-g", FA, "-k", "11",
                                 "--reads", str(reads)])
    assert "Invalid file extension" in msg


@pytest.mark.parametrize("env,expect", [
    ({"SHOTGUN_TPU_PROBE": "sort"}, "sort-join probe"),
    ({}, "k=35 > 31"),
])
def test_unported_probes_raise(env, expect, monkeypatch, capsys):
    """k > 31 is not ported yet.  The sort-join probe, which raised here
    before it was ported, now gives the plain golden."""
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    if env:
        cli.main(_args("plain"))
        assert capsys.readouterr().out == _golden("plain")
        return
    msg = _exit_message(capsys, ["-t", "dumpalign", "-g", FA, "-k", "35",
                                 "--reads", FQ])
    assert expect in msg and "not yet ported" in msg


def test_filter_similar_at_256_genomes_is_not_ported(tmp_path, capsys):
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
import pkgutil, sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import shotgun_tpu_torch
for mod in pkgutil.walk_packages(shotgun_tpu_torch.__path__, "shotgun_tpu_torch."):
    __import__(mod.name)
from shotgun_tpu_torch.cli import main
main(sys.argv[1:])
assert not any(m == "jax" or m.startswith(("jax.", "jaxlib")) for m in sys.modules
               if sys.modules[m] is not None)
"""


def test_runs_with_jax_unimportable():
    env = dict(os.environ, SHOTGUN_TPU_TORCH_DEVICE="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _NO_JAX] + _args("plain"),
        cwd=REPO, capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout == _golden("plain")
