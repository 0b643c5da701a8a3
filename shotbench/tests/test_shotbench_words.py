"""The plain reference past 31 bases: multi-word keys and their exact
lexicographic lookup against a brute-force classifier over Python tuples
of bases and against the port's host-built ``dumpalign -g``; a k = 35
configuration added by files alone runs correct; its control, and a
planted fault that drops the key's last word, do not; and the frozen H3
byte count and the launch list a multi-word stream would make."""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np
import pytest
import torch

from shotbench import reference, yardstick
from shotbench.cells import load_cell
from shotbench.control import control_numbers
from shotbench.harness import Inputs, Resident, row_stride, run_cell

CPU = torch.device("cpu")
GATES = {
    "none": {},
    "quality": {"min_read_quality": 53, "min_kmer_quality": 63},
    "max_genomes": {"max_genomes": 2},
    "all_p0": {"min_read_quality": 66, "min_kmer_quality": 66, "max_genomes": 3,
               "p": 0, "m": 2},
}


def brute_force(codes: np.ndarray, offsets, descriptions, reads: np.ndarray,
                qual: np.ndarray, k: int, gates: reference.Gates) -> dict:
    """The dumpalign summary by the rules in ``reference``'s docstring, one
    read and one window at a time, a k-mer a tuple of bases."""
    index: Dict[Tuple[int, ...], List[int]] = {}
    for g in range(len(offsets) - 1):
        seq = codes[offsets[g]: offsets[g + 1]].tolist()
        for i in range(len(seq) - k + 1):
            key = tuple(seq[i: i + k])
            held = index.setdefault(key, [])
            if not held or held[-1] != g:
                held.append(g)
    stats = dict.fromkeys(("unique_mapped_reads", "ambiguous_mapped_reads",
                           "unmapped_reads", "filtered_quality_reads",
                           "filtered_quality_kmers", "filtered_hr_kmers"), 0)
    unique: Dict[int, int] = {}
    ambiguous: Dict[int, int] = {}
    order: List[int] = []
    for read, q in zip(reads.tolist(), qual.tolist()):
        if gates.min_read_quality is not None and sum(q) < gates.min_read_quality * len(q):
            stats["filtered_quality_reads"] += 1
            continue
        kmers: List[Tuple[int, List[int]]] = []
        seen = set()
        for i in range(len(read) - k + 1):
            if (gates.min_kmer_quality is not None
                    and sum(q[i: i + k]) < gates.min_kmer_quality * k):
                stats["filtered_quality_kmers"] += 1
                continue
            key = tuple(read[i: i + k])
            if key not in index:
                continue
            if gates.max_genomes is not None and len(index[key]) > gates.max_genomes:
                stats["filtered_hr_kmers"] += 1
                continue
            if key not in seen:
                seen.add(key)
                kmers.append((i, index[key]))
        if not kmers:
            stats["unmapped_reads"] += 1
            continue
        spec: Dict[int, int] = {}
        first_spec: Dict[int, int] = {}
        total: Dict[int, int] = {}
        first_total: Dict[int, int] = {}
        for i, held in kmers:
            for g in held:
                total[g] = total.get(g, 0) + 1
                first_total.setdefault(g, i)
                if len(held) == 1:
                    spec[g] = spec.get(g, 0) + 1
                    first_spec.setdefault(g, i)
        met = sorted(spec, key=lambda g: (first_spec[g], g))
        listed: List[int] = []
        is_unique = False
        if met:
            top = max(spec.values())
            winner = next(g for g in met if spec[g] == top)
            second = max((spec[g] for g in met if g != winner), default=0)
            is_unique = len(met) == 1 or top >= second + gates.m
        if is_unique:
            mapped = total[winner]
            if gates.p >= 0 and max(total.values()) - mapped > gates.p:
                is_unique = False
                listed = [winner] + [g for g in sorted(total, key=lambda g: (
                    first_total[g], g)) if total[g] >= mapped]
            else:
                listed = [winner]
        else:
            listed = met
        if is_unique:
            stats["unique_mapped_reads"] += 1
            unique[winner] = unique.get(winner, 0) + 1
        else:
            stats["ambiguous_mapped_reads"] += 1
            for g in listed:
                ambiguous[g] = ambiguous.get(g, 0) + 1
        for g in listed:
            if g not in order:
                order.append(g)
    out = {n: stats[n] for n in ("unique_mapped_reads", "ambiguous_mapped_reads",
                                 "unmapped_reads")}
    for name, gate in (("filtered_quality_reads", gates.min_read_quality),
                       ("filtered_quality_kmers", gates.min_kmer_quality),
                       ("filtered_hr_kmers", gates.max_genomes)):
        if gate is not None:
            out[name] = stats[name]
    return {"Statistics": out,
            "Summary": {descriptions[g]: {"unique_reads": unique.get(g, 0),
                                          "ambiguous_reads": ambiguous.get(g, 0)}
                        for g in order}}


def _gates(name: str) -> reference.Gates:
    return reference.Gates(**dict(dict(m=1, p=1), **GATES[name]))


def _inputs(root, cell, seed, tmp):
    return Inputs(load_cell(root, cell), seed, CPU, str(tmp))


def test_window_words_layout():
    g = torch.Generator().manual_seed(3)
    codes = torch.randint(0, 4, (5, 80), generator=g, dtype=torch.uint8)
    for k in (33, 35, 62, 70):
        words = reference.window_words(codes, k)
        assert words.shape == (5, 80 - k + 1, -(-k // 31))
        row = codes[2].tolist()
        for i in (0, 7, 80 - k):
            bases = row[i: i + k]
            for j in range(words.shape[-1]):
                part = bases[31 * j: 31 * j + 31]
                assert int(words[2, i, j]) == int("".join(map(str, part)), 4)
        assert (words >= 0).all()


def test_word_ranks_are_exact():
    """Rows sharing their first word (and rows sharing all but one base)
    are told apart; a miss ranks past every key."""
    table = torch.tensor([[1, 5], [1, 9], [2, 0], [2, 3], [7, 7]], dtype=torch.int64)
    index = reference.Index(torch.arange(5), torch.arange(5), torch.ones(5, dtype=torch.int64),
                            torch.arange(5), 5, table)
    query = torch.tensor([[[1, 9], [1, 6], [2, 3]], [[0, 5], [7, 7], [9, 0]]])
    assert reference.word_ranks(index, query).tolist() == [[1, 5, 3], [5, 4, 5]]


@pytest.mark.parametrize("k", [33, 35, 62])
@pytest.mark.parametrize("gates", sorted(GATES))
def test_reference_matches_brute_force(tiny_root, tmp_path, k, gates):
    inp = _inputs(tiny_root, "tiny.shallow", 1000 + k, tmp_path)
    n = 300
    codes, qual = inp.samples[0].codes[:n], inp.samples[0].qual[:n]
    index = reference.build_index(torch.from_numpy(inp.codes), inp.offsets, k)
    got = reference.summarize(index, codes, qual, k, _gates(gates), inp.descriptions, CPU)
    want = brute_force(inp.codes, inp.offsets, inp.descriptions, codes, qual, k,
                       _gates(gates))
    assert reference.summary_text(got) == reference.summary_text(want)
    assert got["Statistics"]["ambiguous_mapped_reads"] > 0
    assert got["Statistics"]["unique_mapped_reads"] > 0


def test_reference_at_31_matches_brute_force(tiny_root, tmp_path):
    """The one-word path, held to the same classifier."""
    inp = _inputs(tiny_root, "tiny.shallow", 31, tmp_path)
    codes, qual = inp.samples[0].codes[:300], inp.samples[0].qual[:300]
    index = reference.build_index(torch.from_numpy(inp.codes), inp.offsets, 31)
    got = reference.summarize(index, codes, qual, 31, _gates("all_p0"), inp.descriptions,
                              CPU)
    want = brute_force(inp.codes, inp.offsets, inp.descriptions, codes, qual, 31,
                       _gates("all_p0"))
    assert got == want and list(got["Summary"]) == list(want["Summary"])


@pytest.mark.parametrize("k", [33, 35, 62])
@pytest.mark.parametrize("gates", sorted(GATES))
def test_reference_matches_port_host_build(tiny_root, tmp_path, monkeypatch, k, gates):
    """The reference equals the port's ``dumpalign -g`` (the FASTA parsed
    and built on the host at k > 31) on a strain panel with shared k-mers."""
    from shotgun_tpu_torch import cli
    from shotgun_tpu_torch.constants import DEFAULT_SIMILARITY_THRESHOLD

    from shotbench import gen

    for name in ("SHOTGUN_TPU_PROBE", "SHOTGUN_TPU_DEVICE_BUILD"):
        monkeypatch.delenv(name, raising=False)
    inp = _inputs(tiny_root, "tiny.shallow", 2000 + k, tmp_path)
    fasta = str(tmp_path / "g.fa")
    gen.write_fasta(fasta, gen.Genomes(inp.descriptions, torch.from_numpy(inp.codes),
                                       inp.offsets))
    g = _gates(gates)
    ref = cli.dumpalign_reference(fasta, k, False, DEFAULT_SIMILARITY_THRESHOLD, CPU)
    index = reference.build_index(torch.from_numpy(inp.codes), inp.offsets, k)
    for f in (0, 1):
        got = cli.create_alignment_from_reference(
            ref, inp.paths[f], CPU, g.m, g.p, g.min_read_quality, g.min_kmer_quality,
            g.max_genomes).get_summary()
        want = reference.summarize(index, inp.samples[f].codes, inp.samples[f].qual, k, g,
                                   inp.descriptions, CPU)
        assert reference.summary_text(got) == reference.summary_text(want)
        assert want["Statistics"]["ambiguous_mapped_reads"] > 0


def _add_k35(root: str) -> str:
    """A k = 35 configuration and a oneshot cell on it, by files and
    entries alone; returns the cell's name."""
    with open(os.path.join(root, "shotbench", "configs", "tiny_oneshot_cfg.json")) as fh:
        cfg = dict(json.load(fh), name="tiny35_cfg", k=35)
    with open(os.path.join(root, "shotbench", "configs", "tiny35_cfg.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    if "tiny35.oneshot" not in {w["name"] for w in bench["workloads"]}:
        bench["configs"].append(dict(bench["configs"][1], name="tiny35_cfg",
                                     file="shotbench/configs/tiny35_cfg.json"))
        bench["workloads"].append(dict(name="tiny35.oneshot", config="tiny35_cfg",
                                       traffic="tiny_oneshot", chips=1, why="k = 35"))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "strain.oneshot" in m.get("workloads", []):
                m["workloads"].append("tiny35.oneshot")
        with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
            json.dump(bench, fh)
    return "tiny35.oneshot"


@pytest.fixture(scope="module")
def k35_root(tmp_path_factory):
    from conftest import make_copy

    root = make_copy(str(tmp_path_factory.mktemp("k35")))
    _add_k35(root)
    return root


def test_k35_cell_added_by_files_alone_is_correct(k35_root):
    res = run_cell(k35_root, "tiny35.oneshot", 2**31 + 35, 0.3, False, CPU, 0.0)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 2
    # the kernels' milliseconds a run come from a card's trace alone
    assert set(res["metrics"]) == {"setup_s"}
    assert {m.name for m in load_cell(k35_root, "tiny35.oneshot").end_to_end} == {
        "kernel_ms_per_run", "setup_s"}


@pytest.mark.parametrize("seed", [12, 2**31 + 77, 3_000_000_035])
def test_k35_control_is_not_correct(k35_root, seed):
    out = control_numbers(k35_root, "tiny35.oneshot", seed, CPU)
    assert out["exceeds_a_limit"], out
    assert out["numbers"]["mismatched_summaries"] >= 1


def test_k35_planted_last_word_dropped_is_not_correct(k35_root, monkeypatch):
    """The program's probe given each read window's words with the last
    one dropped (zeroed): a whole run reads not correct."""
    import shotgun_tpu_torch.models.pipeline as pl

    real = pl.encode_words

    def dropped(*args, **kwargs):
        words, sums = real(*args, **kwargs)
        return tuple(words[:-1]) + (torch.zeros_like(words[-1]),), sums

    monkeypatch.setattr(pl, "encode_words", dropped)
    res = run_cell(k35_root, "tiny35.oneshot", 2**31 + 36, 0.2, False, CPU, 0.0)
    assert res["correct"] is False
    assert res["checks"]["mismatched_summaries"]["value"] >= 1


@pytest.mark.parametrize("rows,width,k,sums", [(1, 40, 35, False), (7, 40, 62, True),
                                               (65536, 40, 35, True), (3, 1000, 93, False),
                                               (65536, 40, 33, False)])
def test_h3_bytes_match_port_tool(rows, width, k, sums):
    from shotgun_tpu_torch.tools.bench_encode import h3_bytes

    assert yardstick.h3_bytes(rows, width, k, sums) == h3_bytes(rows, width, k, sums)


def _resident(k: int, kmer_gate, table):
    """A resident kind's launch arithmetic alone, with no inputs or program."""
    kind = Resident.__new__(Resident)
    kind.k, kind.read_len, kind.batch = k, 150, 65536
    kind.gates = reference.Gates(min_kmer_quality=kmer_gate)
    kind._table, kind.mesh = table, None
    return kind


@pytest.mark.parametrize("kmer_gate", [None, 63])
def test_launch_bytes_past_31_bases_are_h3(kmer_gate):
    from shotbench.harness import Request

    reqs = [Request(0, 262144, 4), Request(1, 200000, 4)]
    lpad = row_stride(150, 35)
    out = _resident(35, kmer_gate, None).launch_bytes(reqs)
    assert list(out) == ["encode_words"]
    assert out["encode_words"] == [yardstick.h3_bytes(65536, lpad // 4, 35,
                                                      kmer_gate is not None)] * 8
    one = _resident(31, kmer_gate, None).launch_bytes(reqs)
    assert list(one) == ["encode_window"]
    assert one["encode_window"] == [yardstick.h1_bytes(65536, row_stride(150, 31) // 4, 31,
                                                       True, kmer_gate is not None)] * 8
