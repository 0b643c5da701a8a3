"""EXTSIM in the port (shotgun_tpu_torch.index.extsim): the overlap
matrix of the device path equals the JAX package's host product exactly
at G >= 256, the filter equals the JAX package's on both sides of the
256-identifier split, and dumpref --filter-similar on a 256-genome FASTA
equals the JAX CLI's output byte for byte.  Tolerance 0."""

import contextlib
import io

import numpy as np
import pytest
import torch

from shotgun_tpu import cli as jax_cli
from shotgun_tpu.index import extsim as jextsim
from shotgun_tpu.index.build import build_index
from shotgun_tpu_torch import cli, convert
from shotgun_tpu_torch.index import extsim
from shotgun_tpu_torch.utils.synth import make_genomes

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _pairs(rng, g, num_kmers, density, empty_chunk=None, shared=None):
    """Unique (k-mer, identifier) pairs, sorted k-mer-major, as
    ``_ident_pairs`` gives them; no k-mer of ``empty_chunk``, and every
    identifier holds k-mer ``shared``."""
    kmer = rng.integers(0, num_kmers, size=int(num_kmers * g * density))
    ident = rng.integers(0, g, size=kmer.size)
    if empty_chunk is not None:
        keep = kmer // jextsim._CHUNK != empty_chunk
        kmer, ident = kmer[keep], ident[keep]
    if shared is not None:
        kmer = np.concatenate([kmer, np.full(g, shared)])
        ident = np.concatenate([ident, np.arange(g)])
    pairs = np.unique(kmer * g + ident)
    return pairs // g, (pairs % g).astype(np.int32)


@pytest.mark.parametrize("g,num_kmers", [(256, 20_000), (300, 4 * 8192 + 17)])
def test_overlap_matrix_device_equals_host(g, num_kmers):
    rng = np.random.default_rng(g)
    kmer_u, ident_u = _pairs(rng, g, num_kmers, 0.02, empty_chunk=1,
                             shared=num_kmers - 1)
    want = jextsim._overlap_matrix_host(kmer_u, ident_u, g, num_kmers)
    got = extsim.overlap_matrix_device(kmer_u, ident_u, g, num_kmers, CPU)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        extsim.overlap_matrix(kmer_u, ident_u, g, num_kmers, CPU), want)
    assert np.diag(got).tolist() == np.bincount(ident_u, minlength=g).tolist()
    assert got.min() >= 1  # the shared k-mer


def test_overlap_matrix_below_256_is_the_host_product(monkeypatch):
    rng = np.random.default_rng(3)
    kmer_u, ident_u = _pairs(rng, 40, 5000, 0.05)

    def no_device(*args):
        raise AssertionError("the device product ran below 256 identifiers")

    monkeypatch.setattr(extsim, "overlap_matrix_device", no_device)
    np.testing.assert_array_equal(
        extsim.overlap_matrix(kmer_u, ident_u, 40, 5000, CPU),
        jextsim._overlap_matrix_host(kmer_u, ident_u, 40, 5000))


@pytest.mark.parametrize("n_genomes,threshold", [(32, 0.5), (256, 0.5), (256, 0.95)])
def test_similarity_filter_matches_jax(n_genomes, threshold):
    """Copies of 16 ancestors at 1% mutation share about 0.86 of their
    15-mers: 0.5 drops every copy after the first, 0.95 keeps them all.
    At 256 identifiers the JAX package runs its XLA product on the CPU."""
    rng = np.random.default_rng(n_genomes)
    genomes = make_genomes(rng, n_genomes, 600, strains=16, mutation_rate=0.01)
    index = build_index(genomes, 15)
    want = jextsim.apply_similarity_filter(index, threshold)
    got = extsim.apply_similarity_filter(convert.kmer_index(index), threshold, CPU)
    assert got.similarity_info == want.similarity_info
    assert got.descriptions == want.descriptions
    for name in ("kmer_words", "post_offsets", "post_record", "post_pos",
                 "set_id", "set_masks"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    kept = sum(v["kept"] == "yes" for v in got.similarity_info.values())
    assert kept == (16 if threshold == 0.5 else n_genomes)


def test_dumpref_filter_similar_at_256_genomes_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("SHOTGUN_TPU_TORCH_DEVICE", "cpu")
    rng = np.random.default_rng(11)
    genomes = make_genomes(rng, 256, 120, strains=32, mutation_rate=0.02)
    fa = tmp_path / "panel.fa"
    with open(fa, "w") as fh:
        for i in range(genomes.num_records):
            seq = np.frombuffer(b"ACGT", dtype=np.uint8)[genomes.record_codes(i)]
            fh.write(f">{genomes.descriptions[i]}\n{seq.tobytes().decode()}\n")
    argv = ["-t", "dumpref", "-g", str(fa), "-k", "11", "--filter-similar",
            "--similarity-threshold", "0.5"]
    outs = []
    for main in (cli.main, jax_cli.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert '"kept": "no"' in outs[0] and '"kept": "yes"' in outs[0]
