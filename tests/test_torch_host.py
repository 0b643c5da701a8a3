"""The port's own copies of the host modules against the JAX package's
originals, on the CPU, from the same inputs (numpy seeds and the golden
corpus): constants, errors and the profiler; FASTA/FASTQ parsing, native
and regex, of good and malformed input (the same records, or an exception
of the same class name and message); record packing; the k-mer index
build, native and numpy, and its record filter; the port's native library
(built under build/host/) against the JAX one; and the synthetic
generators.  Tolerance 0 throughout."""

import io
import os

import numpy as np
import pytest

from shotgun_tpu import constants as jconstants
from shotgun_tpu import errors as jerrors
from shotgun_tpu.index import build as jbuild
from shotgun_tpu.io import data_file as jdf
from shotgun_tpu.io import native as jnative
from shotgun_tpu.io import packing as jpacking
from shotgun_tpu.io import records as jrecords
from shotgun_tpu.utils import profiling as jprofiling
from shotgun_tpu.utils import synth as jsynth
from shotgun_tpu_torch import constants, convert, errors
from shotgun_tpu_torch.index import build
from shotgun_tpu_torch.io import data_file as tdf
from shotgun_tpu_torch.io import native, packing, records
from shotgun_tpu_torch.utils import profiling, synth

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
DATA = os.path.join(HERE, "golden", "data")


def _fields(container):
    return [list(r._fields.items()) for r in container]


def _outcome(fn):
    """('ok', value) or (exception class name, message)."""
    try:
        return "ok", fn()
    except Exception as exc:  # compared by class name and message
        return type(exc).__name__, str(exc)


# --- constants, errors, profiler ------------------------------------------

SMALL = ["constants", "errors", "profiler"]


@pytest.mark.parametrize("what", SMALL)
def test_small_modules_match_jax(what):
    if what == "constants":
        for name in dir(jconstants):
            if name.isupper():
                want, got = getattr(jconstants, name), getattr(constants, name)
                if isinstance(want, np.ndarray):
                    np.testing.assert_array_equal(got, want, err_msg=name)
                else:
                    assert got == want, name
    elif what == "errors":
        assert issubclass(errors.UserInputError, ValueError)
        assert errors.UserInputError is not jerrors.UserInputError
        assert str(errors.UserInputError("x")) == str(jerrors.UserInputError("x"))
    else:
        texts = []
        for mod in (profiling, jprofiling):
            prof = mod.Profiler()
            prof.enable()
            for name, items in (("parse", 10), ("align", 0), ("parse", 5)):
                with prof.phase(name, items=items):
                    pass
            for st in prof.stats.values():
                st.seconds = 0.25  # the clock differs; the format must not
            buf = io.StringIO()
            prof.report(buf)
            texts.append(buf.getvalue())
        assert texts[0] == texts[1] and "parse" in texts[0]


# --- parsing --------------------------------------------------------------

#: (extension, text): good inputs and every error contract of the parsers
PARSE_CASES = {
    "corpus.fa": (".fa", None),
    "corpus.fq": (".fq", None),
    "fa multi-line, N, CRLF": (".fa", ">a b\r\nACGTN\r\nAC\r\n>c\nTTTT\n"),
    "fa duplicate descriptions": (".fa", ">g\nACGT\n>g\nCCCC\n"),
    "fa empty": (".fa", ""),
    "fa unparsed data": (".fa", "junk\n>g\nACGT\n"),
    "fa non-ASCII": (".fa", ">gé\nACGT\n"),
    "fq good": (".fq", "@r1\nACGT\n+\nIIII\n@r2 x\nGG\n+..\n#I\n"),
    "fq duplicate id": (".fq", "@r1\nACGT\n+\nIIII\n@r1\nACGT\n+\nIIII\n"),
    "fq length mismatch": (".fq", "@r1\nACGT\n+\nIII\n"),
    "fq N in a read": (".fq", "@r1\nACNT\n+\nIIII\n"),
    "fq unparsed data": (".fq", "@r1\nACGT\n+\nIIII\nstray\n"),
    "fq empty": (".fq", "\n\n"),
    "fq bad extension": (".txt", "@r1\nACGT\n+\nIIII\n"),
}


@pytest.mark.parametrize("case", list(PARSE_CASES))
def test_parsing_matches_jax(case, tmp_path):
    """Files through the native scanner (``FASTAFile``/``FASTAQFile``) and
    text through the regex engine: the same records, or the same error."""
    ext, text = PARSE_CASES[case]
    if text is None:
        path = os.path.join(DATA, case)
        with open(path) as fh:
            text = fh.read()
    else:
        path = str(tmp_path / f"in{ext}")
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(text)
    fasta = ext == ".fa"
    tfile, jfile = ((tdf.FASTAFile, jdf.FASTAFile) if fasta
                    else (tdf.FASTAQFile, jdf.FASTAQFile))
    got = _outcome(lambda: _fields(tfile(path).container))
    assert got == _outcome(lambda: _fields(jfile(path).container))
    if ext == ".txt":
        assert got[0] == "InvalidExtensionError"
        return
    tparser, jparser = ((records.FASTAParser, jrecords.FASTAParser) if fasta
                        else (records.FASTQParser, jrecords.FASTQParser))

    def regex(cls):
        parser = cls()
        parser.parse_records(text)
        return _fields(parser)

    assert _outcome(lambda: regex(tparser)) == _outcome(lambda: regex(jparser))
    stream = _outcome(lambda: tdf.open_fastq_stream(path) is None)
    assert stream == _outcome(lambda: jdf.open_fastq_stream(path) is None)


# --- packing --------------------------------------------------------------

@pytest.mark.parametrize("what", ["genomes", "reads", "reads padded"])
def test_packing_matches_jax(what):
    if what == "genomes":
        recs = tdf.FASTAFile(os.path.join(DATA, "corpus.fa")).container.records
        got = packing.pack_genomes(recs)
        want = jpacking.pack_genomes(jdf.FASTAFile(os.path.join(DATA, "corpus.fa"))
                                     .container.records)
        assert got.descriptions == want.descriptions
        fields = ("codes", "offsets")
    else:
        path = os.path.join(DATA, "corpus.fq")
        pad = 200 if what == "reads padded" else 0
        got = packing.pack_reads(tdf.FASTAQFile(path).container.records, pad_to=pad)
        want = jpacking.pack_reads(jdf.FASTAQFile(path).container.records, pad_to=pad)
        assert got.ids == want.ids and got.max_len == want.max_len
        fields = ("codes", "qual", "lengths")
    for name in fields:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


# --- the k-mer index --------------------------------------------------------

INDEX_FIELDS = ("record_lengths", "kept", "kmer_words", "first_seen", "post_offsets",
                "post_record", "post_pos", "set_id", "set_masks", "set_sizes")


def _panel():
    """A small strain panel: 6 genomes, 2 ancestors at 1% mutation, an N
    run, and a duplicated description."""
    g = synth.make_genomes(np.random.default_rng(4), 6, 1500, strains=2,
                           mutation_rate=0.01)
    g.codes[100:103] = constants.BASE_N
    g.descriptions[5] = g.descriptions[2]
    return g, jpacking.GenomeArrays(list(g.descriptions), g.codes.copy(),
                                    g.offsets.copy())


def _assert_index_equal(got, want):
    assert got.k == want.k and got.descriptions == want.descriptions
    assert got.similarity_info == want.similarity_info
    for name in INDEX_FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("k", [11, 31])
@pytest.mark.parametrize("route", ["native", "numpy", "filtered"])
def test_build_index_matches_jax(k, route, monkeypatch):
    g, jg = _panel()
    if route == "numpy":
        monkeypatch.setattr(native, "build_kmer_index", lambda *a: None)
        monkeypatch.setattr(jnative, "build_kmer_index", lambda *a: None)
    got, want = build.build_index(g, k), jbuild.build_index(jg, k)
    _assert_index_equal(got, want)
    if route == "filtered":
        kept = np.array([0, 3, 4])
        got, want = build.filter_records(got, kept), jbuild.filter_records(want, kept)
        _assert_index_equal(got, want)
        assert not got.kept.all()
    # the converter carries a JAX index over field by field
    _assert_index_equal(convert.kmer_index(want), got)
    assert [got.kmer_string(i) for i in range(0, got.num_kmers, 97)] == [
        want.kmer_string(i) for i in range(0, want.num_kmers, 97)]


# --- the native library -----------------------------------------------------

NATIVE_CASES = ["library", "fastq_parse", "fastq_stream_chunks_packed",
                "fastq_stream_chunks_vpacked", "fastq_ids", "fasta_parse", "pack2",
                "build_kmer_index"]


def _fastq_bytes():
    reads = jsynth.synth_reads(np.random.default_rng(9), jsynth.synth_genomes(
        np.random.default_rng(8), 3, 800), 300, 70)
    reads.qual[:] = np.random.default_rng(10).integers(35, 90, size=reads.qual.shape)
    return jsynth.to_fastq(reads).encode()


def _chunks(gen):
    return [(c.copy(), q.copy(), n.copy(), got) for c, q, n, got in gen]


@pytest.mark.parametrize("case", NATIVE_CASES)
def test_native_library_matches_jax(case):
    assert native.available() and jnative.available()
    data = _fastq_bytes()
    if case == "library":
        assert native.library_path() == os.path.join(
            REPO, "build", "host", "libshotgun_tpu_torch_io.so")
        assert native.LIB_PATH != os.path.join(REPO, "native", "libshotgun_io.so")
        return
    if case == "fastq_parse":
        got, want = native.fastq_parse(data), jnative.fastq_parse(data)
        pairs = [(got[3], want[3])] + list(zip(got[:3] + got[4:], want[:3] + want[4:]))
    elif case in ("fastq_stream_chunks_packed", "fastq_stream_chunks_vpacked"):
        # the port's one fill, held against each of the JAX package's two
        pairs = []
        for with_qual in (False, True):
            args = (data, 64, 96, with_qual)
            got = _chunks(native.fastq_stream_chunks_vpacked(*args))
            want = _chunks(getattr(jnative, case)(*args))
            assert len(got) == len(want) == 5
            pairs += [(g, w) for gc, wc in zip(got, want) for g, w in zip(gc, wc)]
    elif case == "fastq_ids":
        got, want = native.fastq_ids(data, 300), jnative.fastq_ids(data, 300)
        assert got == want and len(got) == 300
        return
    elif case == "fasta_parse":
        text = jsynth.to_fasta(jsynth.synth_genomes(np.random.default_rng(3), 4, 333))
        got, want = native.fasta_parse(text.encode()), jnative.fasta_parse(text.encode())
        assert got[2] == want[2]
        pairs = list(zip(got[:2], want[:2]))
    elif case == "pack2":
        g, _ = _panel()
        gp = -(-g.codes.size // 4) * 4
        outs = []
        for mod in (native, jnative):
            codes2 = np.zeros(gp // 4, np.uint8)
            runs = np.zeros(64, np.int32)
            outs.append((mod.pack2(g.codes, gp, codes2, runs), codes2, runs))
        assert outs[0][0] == outs[1][0] == 1  # the one N run
        pairs = list(zip(outs[0][1:], outs[1][1:]))
    else:
        g, _ = _panel()
        got = native.build_kmer_index(g.codes, g.offsets, 21)
        want = jnative.build_kmer_index(g.codes, g.offsets, 21)
        assert sorted(got) == sorted(want)
        pairs = [(got[name], want[name]) for name in sorted(want)]
    for g, w in pairs:
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


# --- synthetic data ---------------------------------------------------------

@pytest.mark.parametrize("what", ["synth_genomes", "synth_reads", "to_fasta", "to_fastq"])
def test_synth_generators_match_jax(what):
    def make(mod, seed=7):
        rng = np.random.default_rng(seed)
        g = mod.synth_genomes(rng, 5, 1000)
        return g, mod.synth_reads(rng, g, 120, 90, quality_char="?")

    (g, r), (jg, jr) = make(synth), make(jsynth)
    if what == "synth_genomes":
        assert g.descriptions == jg.descriptions
        np.testing.assert_array_equal(g.codes, jg.codes)
        np.testing.assert_array_equal(g.offsets, jg.offsets)
    elif what == "synth_reads":
        assert r.ids == jr.ids
        for name in ("codes", "qual", "lengths"):
            np.testing.assert_array_equal(getattr(r, name), getattr(jr, name))
    elif what == "to_fasta":
        assert synth.to_fasta(g) == jsynth.to_fasta(jg)
    else:
        assert synth.to_fastq(r) == jsynth.to_fastq(jr)
