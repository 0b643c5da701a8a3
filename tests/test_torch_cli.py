"""The port's CLI (python -m shotgun_tpu_torch) on the CPU: byte-identical
stdout to the recorded dumpalign goldens, a .kdb written by the JAX
package's CLI, the error contracts of the ported task, and a guard that
the port runs with jax unimportable."""

import json
import os
import subprocess
import sys

import pytest
import torch

from shotgun_tpu import cli as jax_cli
from shotgun_tpu_torch import cli

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLDEN = os.path.join(HERE, "golden")
DATA = os.path.join(GOLDEN, "data")
FA = os.path.join(DATA, "corpus.fa")
FQ = os.path.join(DATA, "corpus.fq")
DUMPALIGN_CASES = ["plain", "m2", "m0", "p0", "p5", "pneg", "mrq", "mkq",
                   "mg0", "mg1", "mg2", "combo", "sim-align"]

with open(os.path.join(GOLDEN, "manifest.json")) as _fh:
    _MANIFEST = json.load(_fh)


def _golden(name: str) -> str:
    with open(os.path.join(GOLDEN, f"{name}.out")) as fh:
        return fh.read()


def _args(name: str):
    return [a.replace("data/", DATA + "/") for a in _MANIFEST[name]["args"]]


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("SHOTGUN_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("SHOTGUN_TPU_PROBE", raising=False)


def _exit_message(capsys, argv) -> str:
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert exc.value.code not in (0, None)
    return str(exc.value.code) + capsys.readouterr().err


def test_manifest_lists_every_dumpalign_case():
    assert sorted(DUMPALIGN_CASES) == sorted(
        n for n, c in _MANIFEST.items() if c["args"][1] == "dumpalign")


@pytest.mark.parametrize("name", DUMPALIGN_CASES)
def test_golden_dumpalign(name, capsys):
    cli.main(_args(name) + ["--batch-size", "16"])
    assert capsys.readouterr().out == _golden(name)


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
    (["-t", "reference", "-g", FA, "-k", "11", "-r", "x.kdb"], "not yet ported"),
    (["-t", "dumpref", "-g", FA, "-k", "11"], "not yet ported"),
    (["-t", "align", "-g", FA, "-k", "11", "--reads", FQ, "-a", "x.aln"],
     "not yet ported"),
    (["-t", "dumpalign", "-a", "x.aln"], "not yet ported"),
    (["-t", "bogus"], "Error: Unsupported task."),
    (["-t", "dumpalign", "-g", FA], "Error: For task 'dumpalign', provide"),
    (["-t", "dumpalign", "-g", FA, "-k", "11", "--reads", "missing.fq"],
     "Error: FASTQ reads file 'missing.fq' does not exist"),
])
def test_exits_nonzero(argv, expect, capsys):
    assert expect in _exit_message(capsys, argv)


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
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    k = "11" if env else "35"
    msg = _exit_message(capsys, ["-t", "dumpalign", "-g", FA, "-k", k,
                                 "--reads", FQ])
    assert expect in msg and "not yet ported" in msg


def test_filter_similar_at_256_genomes_is_not_ported(tmp_path, capsys):
    """EXTSIM reaches jax from 256 genome identifiers on; the port stops
    there with an error instead."""
    fa = tmp_path / "many.fa"
    fa.write_text("".join(f">g{i}\n{'ACGT'[i % 4] * 8}{'ACGTTGCA' * 3}\n"
                          for i in range(256)))
    msg = _exit_message(capsys, ["-t", "dumpalign", "-g", str(fa), "-k", "11",
                                 "--reads", FQ, "--filter-similar"])
    assert "EXTSIM" in msg and "not yet ported" in msg


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
