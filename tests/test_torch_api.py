"""The single-read library API of the port against the JAX package's: the
eight cases of tests/test_api_parity.py, each run on both packages'
classes with equal results, and ``add_read_from_read_record`` at k = 35."""

import pytest
import torch

import shotgun_tpu
import shotgun_tpu_torch
from shotgun_tpu import aligner as jaligner
from shotgun_tpu import reference as jreference
from shotgun_tpu.io import records as jrecords
from shotgun_tpu_torch import aligner as taligner
from shotgun_tpu_torch import reference as treference
from shotgun_tpu_torch.io import records as trecords

torch.set_num_threads(2)

#: (package, reference module, aligner module, records module) of each side
SIDES = {"jax": (shotgun_tpu, jreference, jaligner, jrecords),
         "port": (shotgun_tpu_torch, treference, taligner, trecords)}


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("SHOTGUN_TPU_TORCH_DEVICE", "cpu")


def _ref(side, fasta, k):
    _, ref_mod, _, rec = SIDES[side]
    p = rec.FASTAParser()
    p.parse_records(fasta)
    return ref_mod.KmerReference(k, p)


def _read(side, fastq):
    _, _, al, rec = SIDES[side]
    p = rec.FASTQParser()
    p.parse_records(fastq)
    return al.Read(list(p)[0])


def _both(fn):
    """fn(side) on each package; the two results must be equal."""
    jax_out, port_out = fn("jax"), fn("port")
    assert port_out == jax_out
    return port_out


def test_reverse_complement():
    out = _both(lambda s: [SIDES[s][1].reverse_complement(x) for x in ("ACGT", "AAGG", "A")])
    assert out == ["ACGT", "CCTT", "T"]


def test_extract_kmers_from_genome():
    out = _both(lambda s: [list(SIDES[s][1].extract_kmers_from_genome(k, g))
                           for k, g in ((3, "ACGTA"), (9, "ACGT"), (0, "ACGT"))])
    assert out == [[(0, "ACG"), (1, "CGT"), (2, "GTA")], [], []]


def test_kmer_reference_attrs():
    def attrs(side):
        ref = _ref(side, ">g1\nACGTACGT\n", 4)
        return ref.kmer_len, [g.identifier for g in ref.genomes], ref.similarity_info
    assert _both(attrs) == (4, ["g1"], None)


def test_get_kmer_and_reverse_references():
    # ACGT's reverse complement is itself; AAAA's is TTTT
    def refs(side):
        ref = _ref(side, ">g1\nAAAACGT\n", 4)
        both = ref.get_kmer_and_reverse_references("TTTT")
        return ([(rec.identifier, pos) for rec, pos in both.items()],
                ref.get_kmer_references("TTTT"),
                [(rec.identifier, pos) for rec, pos in ref.get_kmer_references("ACGT").items()])
    # TTTT is absent, but its reverse complement AAAA is present
    assert _both(refs) == ([("g1", {0})], {}, [("g1", {3})])


_GA = "ACGTTGCAAGGCTTACCGATAGCTTGACCATGGATCAGT"
_GB = "TTGACCATGGATCCGGTAACGTGCATGCAATTCGAAGC"
_SHARED = "GATCGATCGGCTAGCTAGGATCCATGCATGCAACGTCAGTA"
_GETITEM_FASTA = f">g1\n{_GA}{_SHARED}\n>g2\n{_GB}{_SHARED}{_SHARED[:20]}\n"
#: case -> (k, query, device-built reference); the mapping, None or the error
GETITEM_CASES = {
    "hit k=11": (11, _GA[3:14], False),
    "hit k=35, two genomes": (35, _SHARED[2:37], False),
    "miss": (11, "C" * 11, False),
    "wrong length": (11, _GA[3:15], False),
    "N": (11, _GA[3:8] + "N" + _GA[9:14], False),
    "device-built": (11, _GA[3:14], True),
    "device-built, wrong length": (11, _GA[3:15], True),
    "device-built, N": (11, _GA[3:8] + "N" + _GA[9:14], True),
}


@pytest.mark.parametrize("case", list(GETITEM_CASES))
def test_getitem(case):
    """``ref[kmer]``: the mapping by record identifier and position set, or
    None, equal to the JAX package's; a device-built reference has no host
    index for a k-mer it can encode and raises AttributeError in both."""
    k, query, device_built = GETITEM_CASES[case]

    def lookup(side):
        _, ref_mod, _, rec = SIDES[side]
        if device_built:
            p = rec.FASTAParser()
            p.parse_records(_GETITEM_FASTA)
            ref = ref_mod.KmerReference.from_device_build(p.to_genome_arrays(), k)
        else:
            ref = _ref(side, _GETITEM_FASTA, k)
        try:
            got = ref[query]
        except AttributeError:
            return "AttributeError"
        return None if got is None else {r.identifier: pos for r, pos in got.items()}

    out = _both(lookup)
    if case.startswith("hit"):
        assert out and all(out.values())
        assert len(out) == (2 if "two" in case else 1)
    else:
        assert out == ("AttributeError" if case == "device-built" else None)


def test_read_method_decomposition():
    def steps(side):
        al = SIDES[side][2]
        ref = _ref(side, ">g1\nAAAACCCC\n>g2\nGGGGTTTT\n", 4)
        read = _read(side, "@r\nAAAACCCC\n+\nIIIIIIII\n")
        read.extract_kmer_references(ref)
        counts = read.generate_genome_counts(map_count=True)
        aligned = read.try_to_align_specific(1)
        mtype = read.mapping.type.name
        read.validate_unique_mappings(1)
        kmer = read.kmers["AAAA"]
        assert kmer.specifity == al.KmerSpecifity.SPECIFIC
        return (len(read.kmers), {g.identifier: c for g, c in counts.items()}, aligned,
                mtype, read.mapping.type.name,
                [(rec.identifier, pos) for rec, pos in kmer.references.items()])
    assert _both(steps) == (5, {"g1": 5}, True, "UNIQUELY_MAPPED", "UNIQUELY_MAPPED",
                            [("g1", {0})])


def test_mean_and_kmer_quality_raw_ord():
    def quality(side):
        read = _read(side, "@r\nACGT\n+\n!I!I\n")
        return read.mean_quality(), read.kmer_quality(0, 2)
    # raw ord values, no PHRED offset
    assert _both(quality) == ((33 + 73 + 33 + 73) / 4, (33 + 73) / 2)


def _by_type(side, fasta, fastq, k, **gates):
    al, rec = SIDES[side][2], SIDES[side][3]
    aln = al.PseudoAlignment(_ref(side, fasta, k))
    p = rec.FASTQParser()
    p.parse_records(fastq)
    for r in p:
        aln.add_read_from_read_record(r, **gates)
    return ({t.name: aln.get_reads_by_mapping_type(t) for t in al.ReadMappingType},
            aln.get_summary())


def test_get_reads_by_mapping_type():
    by_type, _ = _both(lambda s: _by_type(
        s, ">g1\nAAAACCCC\n",
        "@u\nAAAACCCC\n+\nIIIIIIII\n@n\nGGGGGGGG\n+\nIIIIIIII\n", 4))
    assert by_type["UNIQUELY_MAPPED"] == ["u"] and by_type["UNMAPPED"] == ["n"]


def test_add_read_from_read_record_at_k35():
    """Multi-word keys on the host path: reads unique to one genome, shared
    by two (ambiguous), off every genome, and under the MRQ gate; the
    statistics and the Summary's order equal the JAX package's."""
    a = "ACGTTGCAAGGCTTACCGATAGCTTGACCATGGAT" * 2
    b = "TTGACCATGGATCCGGTAACGTGCATGCAATTCG" * 2
    shared = "GATCGATCGGCTAGCTAGGATCCATGCATGCAACGTCAGT"
    fasta = f">g1\n{a}{shared}\n>g2\n{b}{shared}\n"
    reads = [("u1", b[5:60]), ("u0", a[:50]), ("amb", shared),
             ("none", "C" * 50), ("lowq", a[10:60])]
    fastq = "".join(f"@{rid}\n{seq}\n+\n{('#' if rid == 'lowq' else 'I') * len(seq)}\n"
                    for rid, seq in reads)
    by_type, summary = _both(lambda s: _by_type(s, fasta, fastq, 35, min_read_quality=40,
                                                min_kmer_quality=30, max_genomes=2))
    assert by_type["UNIQUELY_MAPPED"] == ["u1", "u0"] and by_type["AMBIGUOUSLY_MAPPED"] == ["amb"]
    assert list(summary["Summary"]) == ["g2", "g1"]
    assert summary["Statistics"]["filtered_quality_reads"] == 1


def test_lazy_package_exports():
    for pkg, ref_mod, al, _ in SIDES.values():
        assert pkg.KmerReference is ref_mod.KmerReference
        assert pkg.ReadMappingType is al.ReadMappingType
        assert pkg.Read is al.Read and pkg.reverse_complement is ref_mod.reverse_complement
        assert pkg.FASTAFile.__name__ == "FASTAFile"
        with pytest.raises(AttributeError):
            pkg.does_not_exist
    assert shotgun_tpu_torch.KmerReference is not shotgun_tpu.KmerReference
