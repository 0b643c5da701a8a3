"""The port's validating FASTQ fill (``io/native.py
fastq_stream_chunks_vpacked``, ``io/csrc/shotgun_io.cpp``) with its
structure walk split into byte ranges, on the CPU: chunk by chunk the
same codes, quality, lengths and record counts as the serial walk
(``n_threads=1``) and the JAX package's fill, on inputs large enough to
split; the same exception, status and chunks before it on invalid inputs;
and the thread count's default and override.  Tolerance 0 throughout."""

import functools
import os
import random
import sys
import threading

import pytest

from shotgun_tpu.io import native as jnative
from shotgun_tpu_torch.io import data_file, native
from shotgun_tpu_torch.utils.profiling import PROFILER

#: the PHRED33 quality characters
QUAL = ("`1234567890-=qwertyuiop[]\\asdfghjkl;'zxcvbnm,./"
        "~!@#$%^&*()_+QWERTYUIOP{}|ASDFGHJKL:\"ZXCVBNM<>?")
READS = 20_000
#: the row stride: the longest read of ``_reads``
LMAX = 40
THREADS = [1, 2, 3, 8]


@functools.lru_cache(maxsize=None)
def _read_lines(seed):
    rng = random.Random(seed)
    out = []
    for i in range(READS):
        length = rng.randint(8, LMAX)
        qual = rng.choices(QUAL, k=length)
        if rng.random() < 0.2:
            qual[0] = rng.choice("@+")
        head = f"@r{i}" + rng.choice(["", " desc", " \t", f" d{i % 7}"])
        sep = "+" + "." * rng.choice([0, 0, 0, 2])
        out.append((head, "".join(rng.choices("ACGT", k=length)), sep, "".join(qual)))
    return tuple(out)


def _reads(seed=0):
    """[[header, sequence, separator, quality]] of READS reads of 8..LMAX
    bases; a fifth of the quality lines open with '@' or '+', some ids
    carry a description or trailing blanks, some separators dots."""
    return [list(r) for r in _read_lines(seed)]


def _fastq(reads, crlf=False, lead=False):
    nl = "\r\n" if crlf else "\n"
    return (("  \n\t\n\n" if lead else "")
            + "".join(nl.join(r) + nl for r in reads)).encode()


def _fill(mod, data, chunk, lmax, with_qual, **kw):
    """([(codes, qual, lengths, n)] as bytes, the outcome): None at the
    end of the input, else ("parse", status) or "lmax"."""
    out = []
    try:
        for codes, qual, lengths, got in mod.fastq_stream_chunks_vpacked(
                data, chunk, lmax, with_qual, **kw):
            out.append((codes.tobytes(), qual.tobytes(), lengths.tobytes(), got))
    except mod.NativeParseError as exc:
        return out, ("parse", exc.status)
    except mod.LmaxExceeded:
        return out, "lmax"
    return out, None


@pytest.fixture
def registry():
    PROFILER.stats.clear()
    PROFILER.enable()
    yield PROFILER
    PROFILER.enabled = False
    PROFILER.stats.clear()


def _walks(reg):
    return {name: (st.calls, st.items) for name, st in reg.stats.items()
            if name.startswith("fill_walk_")}


#: (input, chunk size): 4,500 and 4,099 records are multiples of no
#: range count; 20,000 reads at 4,500 end in a 2,000-record tail
VALID = [("plain", 4500), ("crlf", 4099), ("leading blanks", 5000),
         ("plain", 65536)]


@pytest.mark.parametrize("nt", THREADS)
def test_split_walk_equals_the_serial_walk(nt, registry):
    for name, chunk in VALID:
        data = _fastq(_reads(seed=len(name)), crlf=name == "crlf",
                      lead=name == "leading blanks")
        for with_qual in (False, True):
            registry.stats.clear()
            got = _fill(native, data, chunk, LMAX, with_qual, n_threads=nt)
            walks = _walks(registry)
            serial = _fill(native, data, chunk, LMAX, with_qual, n_threads=1)
            want = _fill(jnative, data, chunk, LMAX, with_qual, n_threads=1)
            assert got[1] is None and sum(c[3] for c in got[0]) == READS
            assert got == serial == want, (name, chunk, with_qual)
            # a chunk of 4,096 records or more, with 4,096 records' bytes left
            # to walk, is walked in ranges: here each but a short tail
            want_walks = {}
            for start in range(0, READS, chunk):
                left = READS - start
                key = "fill_walk_" + ("split" if nt > 1 and min(chunk, left) >= 4096
                                      else "serial")
                calls, items = want_walks.get(key, (0, 0))
                want_walks[key] = (calls + 1, items + min(chunk, left))
            assert walks == want_walks, (name, chunk, with_qual)


def _invalid(case):
    """(input, lmax) of an invalid input whose fault lies where the split
    walk's ranges meet or end (chunks of 5,000 records)."""
    reads = _reads(seed=7)
    lmax = LMAX
    if case == "duplicate in two ranges of a chunk":
        reads[3100][0] = reads[200][0]
    elif case == "duplicate in two chunks":
        reads[7300][0] = reads[200][0]
    elif case == "bad base in the last range":
        reads[4900][1] = reads[4900][1][:-1] + "N"
    elif case == "bad separator in the last range":
        reads[4950][2] = "+x"
    elif case == "length mismatch in the last chunk":
        reads[19990][3] = reads[19990][3][:-1]
    elif case == "quality line then a lost sequence line":
        # '@' quality, then a head whose sequence line is gone: the
        # quality line reads as a record head to the range cut
        for i in range(1200, 1800):
            reads[i][3] = "@" + reads[i][3][1:]
            reads[i + 1][1] = None
    elif case == "truncated final group":
        return _fastq(reads)[:-len(reads[-1][3]) - 1 - len(reads[-1][2]) - 1], lmax
    elif case == "wider than lmax in a later range":
        reads[4400][1] = "A" * (LMAX + 4)
        reads[4400][3] = "I" * (LMAX + 4)
    reads = [[x for x in r if x is not None] for r in reads]
    return _fastq(reads), lmax


INVALID = ["duplicate in two ranges of a chunk", "duplicate in two chunks",
           "bad base in the last range", "bad separator in the last range",
           "length mismatch in the last chunk",
           "quality line then a lost sequence line", "truncated final group",
           "wider than lmax in a later range"]


@pytest.mark.parametrize("nt", THREADS)
def test_split_walk_rejects_as_the_serial_walk(nt):
    for case in INVALID:
        data, lmax = _invalid(case)
        for with_qual in (False, True):
            got = _fill(native, data, 5000, lmax, with_qual, n_threads=nt)
            serial = _fill(native, data, 5000, lmax, with_qual, n_threads=1)
            want = _fill(jnative, data, 5000, lmax, with_qual, n_threads=1)
            assert got == serial == want, (case, with_qual)
            assert got[1] is not None, case
            if case == "wider than lmax in a later range":
                assert got[1] == "lmax" and not got[0]
                wider = _fill(native, data, 5000, lmax + 4, with_qual, n_threads=nt)
                assert wider == _fill(jnative, data, 5000, lmax + 4, with_qual,
                                      n_threads=1)
                assert wider[1] is None and sum(c[3] for c in wider[0]) == READS


def _false_heads(nt):
    """Inputs of 12,000 reads of 32 bases, each with one fault: read k + 1
    has lost its sequence line and read k's quality line opens with '@',
    so that line reads as a record head to the range cut; k runs over
    the reads near where the first chunk's ranges meet."""
    reads = [[f"@q{i:05d}", "ACGT" * 8, "+", "I" * 32] for i in range(12_000)]
    data = [_fastq([r]) for r in reads]
    step = 5077 / max(nt, 2)  # the window's records (5,000 and 1/64) a range
    for t in range(1, max(nt, 2)):
        for k in range(round(1 + t * step) - 12, round(1 + t * step) + 12):
            bad = list(data)
            bad[k] = _fastq([reads[k][:3] + ["@" + reads[k][3][1:]]])
            bad[k + 1] = _fastq([[reads[k + 1][0]] + reads[k + 1][2:]])
            yield b"".join(bad)


@pytest.mark.parametrize("nt", THREADS)
def test_split_walk_after_a_false_head_walks_on_serially(nt):
    """Where a range starts at a false head, the range before it does not
    end there, and the chunk is walked on serially: the serial walk's
    fault, whichever range held it."""
    for data in _false_heads(nt):
        got = _fill(native, data, 5000, 32, False, n_threads=nt)
        assert got == _fill(jnative, data, 5000, 32, False, n_threads=1)
        assert got[1] == ("parse", native.STATUS_UNPARSED) and not got[0]


def test_streams_on_many_threads_at_once():
    """Six streams filled at once on eight threads each (48 threads, more
    than a test host's cores), chunk after chunk: each yields the serial
    walk's chunks, and every producer ends in time."""
    data = _fastq(_reads(seed=5))
    want = _fill(native, data, 4096, LMAX, True, n_threads=1)
    results = [None] * 6

    def run(i):
        results[i] = _fill(native, data, 4096, LMAX, True, n_threads=8)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(results))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert all(r == want for r in results)


@pytest.mark.parametrize("cores,want", [(1, 1), (2, 1), (4, 3), (8, 7), (9, 8), (32, 8)])
def test_fill_threads_follow_the_affinity_mask(monkeypatch, cores, want):
    monkeypatch.delenv(native.FILL_THREADS_ENV, raising=False)
    monkeypatch.setattr(native.os, "sched_getaffinity", lambda pid: set(range(cores)))
    assert native.fill_threads() == want
    monkeypatch.setenv(native.FILL_THREADS_ENV, "3")
    assert native.fill_threads() == 3
    monkeypatch.setenv(native.FILL_THREADS_ENV, "many")
    assert native.fill_threads() == want


@pytest.mark.parametrize("env,split", [(None, True), ("1", False)])
def test_stream_walks_split_by_default(monkeypatch, tmp_path, registry, env, split):
    """``FASTAQStream.chunks_packed`` takes ``fill_threads()``: four cores
    give three threads and split walks, ``SHOTGUN_TPU_FILL_THREADS=1``
    one thread."""
    monkeypatch.setattr(native.os, "sched_getaffinity", lambda pid: set(range(4)))
    if env is None:
        monkeypatch.delenv(native.FILL_THREADS_ENV, raising=False)
    else:
        monkeypatch.setenv(native.FILL_THREADS_ENV, env)
    path = os.path.join(tmp_path, "reads.fq")
    with open(path, "wb") as fh:
        fh.write(_fastq(_reads(seed=3)))
    stream = data_file.open_fastq_stream(path, lazy=True)
    assert sum(c[3] for c in stream.chunks_packed(5000, LMAX, False)) == READS
    assert _walks(registry) == {
        "fill_walk_split" if split else "fill_walk_serial": (4, READS)}
