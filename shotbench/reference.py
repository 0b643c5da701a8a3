"""The plain reference classifier: the dumpalign summary of a sample, by
the reference tool's rules, in plain PyTorch (or on the CPU the same
code), from the benchmark's own genomes and reads.

It imports nothing of the program.  Its index is a sorted array of the
distinct k-mer keys of the genomes with each key's genome set; a read's
windows are looked up by binary search.  At k <= 31 a key is one int64
(``window_keys``); past 31 bases a window is ceil(k / 31) int64 words,
most significant first (``window_words``), the index holds the distinct
words in lexicographic order, and a window's key is its words' rank in
that order, found by an exact lexicographic search over every word (a
miss ranks past every key).  The rules (the reference tool's
``Read.pseudo_align`` and ``PseudoAlignment.get_summary``):

- a read whose mean raw quality byte is below the read gate is filtered:
  it is counted in ``filtered_quality_reads`` and nowhere else;
- a window whose mean raw quality byte is below the k-mer gate is dropped
  and counted in ``filtered_quality_kmers``; a window found in more
  genomes than the max-genomes gate is dropped and counted in
  ``filtered_hr_kmers``; both per occurrence;
- the remaining windows that hit the index are the read's k-mers, a
  repeated k-mer counted once, at its first position;
- no k-mer: unmapped.  Otherwise the genomes are counted over the
  specific k-mers (found in one genome): one genome, or a top count at
  least the second plus m, is unique (ties go to the genome met first);
  else ambiguous, listing every genome with a specific k-mer in the order
  met (by first window, then genome order) -- an empty list when no
  k-mer is specific;
- a unique read is recounted over all its k-mers; when the best total
  exceeds the mapped genome's by more than p (p >= 0) it becomes
  ambiguous with the list [mapped] + every genome whose total is at
  least the mapped genome's, in the order met: the mapped genome is
  listed, and counted, twice;
- the summary's genomes are in the order first met over the reads in
  file order, each read's list in its order; each unique read counts one
  for its genome, each listed genome of an ambiguous read one.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

_I64_MAX = torch.iinfo(torch.int64).max
#: reads classified per step
READ_CHUNK = 1 << 16
#: bases of a full word of a multi-word key
WORD_BASES = 31


def window_keys(codes: torch.Tensor, k: int) -> torch.Tensor:
    """[..., n] base codes (0..3) -> [..., n - k + 1] int64 keys, base j
    of the window in bits 2 (k - 1 - j)."""
    n = codes.shape[-1]
    w = n - k + 1
    c = codes.to(torch.int64)
    key = torch.zeros(codes.shape[:-1] + (w,), dtype=torch.int64, device=codes.device)
    for j in range(k):
        key = (key << 2) | c[..., j: j + w]
    return key


def window_words(codes: torch.Tensor, k: int) -> torch.Tensor:
    """[..., n] base codes (0..3) -> [..., n - k + 1, ceil(k / 31)] int64
    words, most significant first: word i holds the window's bases
    31 i .. min(31 i + 31, k) - 1, the first of them in its highest bits."""
    w = codes.shape[-1] - k + 1
    words = [window_keys(codes[..., a: a + w + min(WORD_BASES, k - a) - 1],
                         min(WORD_BASES, k - a))
             for a in range(0, k, WORD_BASES)]
    return torch.stack(words, dim=-1)


@dataclass
class Index:
    """Distinct keys, ascending, and the genomes of each: genomes
    ``genome[start[i]: start[i] + gcount[i]]`` hold key ``keys[i]``, in
    genome order.  With multi-word keys ``keys`` are the ranks 0 .. U - 1
    of ``words``, the distinct [U, W] words in lexicographic order."""

    keys: torch.Tensor     # int64 [U]
    start: torch.Tensor    # int64 [U]
    gcount: torch.Tensor   # int64 [U]
    genome: torch.Tensor   # int64 [P]
    n_genomes: int
    words: Optional[torch.Tensor] = None   # int64 [U, W], k > 31 only


KeyMap = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _lex_order(words: torch.Tensor) -> torch.Tensor:
    """The stable lexicographic order of the rows of [N, W] ``words``: a
    stable sort by each word, least significant first."""
    order = torch.arange(words.shape[0], device=words.device)
    for j in reversed(range(words.shape[1])):
        order = order[torch.sort(words[order, j], stable=True)[1]]
    return order


def _lex_less(rows: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """[N] whether row i of [N, W] ``rows`` lies before row i of
    ``query`` in lexicographic order."""
    less = torch.zeros(rows.shape[0], dtype=torch.bool, device=rows.device)
    equal = torch.ones_like(less)
    for j in range(rows.shape[1]):
        less |= equal & (rows[:, j] < query[:, j])
        equal &= rows[:, j] == query[:, j]
    return less


def word_ranks(index: Index, query: torch.Tensor) -> torch.Tensor:
    """[..., W] words -> [...] their rank among ``index.words`` by an
    exact lexicographic binary search; U (no key's rank) for a miss."""
    table = index.words
    u = table.shape[0]
    q = query.reshape(-1, query.shape[-1])
    lo = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    hi = torch.full_like(lo, u)
    for _ in range(u.bit_length()):
        mid = (lo + hi) // 2
        less = _lex_less(table[mid.clamp(max=u - 1)], q)
        active = lo < hi
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    found = (lo < u) & (table[lo.clamp(max=u - 1)] == q).all(1)
    return torch.where(found, lo, u).reshape(query.shape[:-1])


def _window_keys(codes: torch.Tensor, k: int, key_map: KeyMap) -> torch.Tensor:
    """The windows' keys: int64 [..., w] at k <= 31, words [..., w, W]
    past it, each through ``key_map`` when given."""
    keys = window_keys(codes, k) if k <= WORD_BASES else window_words(codes, k)
    return keys if key_map is None else key_map(keys)


def build_index(codes: torch.Tensor, offsets: Sequence[int], k: int,
                key_map: KeyMap = None) -> Index:
    """The index of the genomes ``codes[offsets[g]: offsets[g + 1]]``
    (uint8 0..3, 4 for N: a window with an N has no key).  ``key_map``
    replaces every key (the control's coarser key)."""
    dev = codes.device
    keys_l: List[torch.Tensor] = []
    gen_l: List[torch.Tensor] = []
    for g in range(len(offsets) - 1):
        seq = codes[int(offsets[g]): int(offsets[g + 1])]
        if seq.numel() < k or k < 1:
            continue
        bad = torch.cumsum((seq > 3).to(torch.int64), 0)
        bad = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), bad])
        ok = (bad[k:] - bad[:-k]) == 0
        key = _window_keys(seq & 3, k, None)[ok]
        keys_l.append(key if key_map is None else key_map(key))
        gen_l.append(torch.full((key.shape[0],), g, dtype=torch.int64, device=dev))
    n_genomes = len(offsets) - 1
    if not keys_l:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        words = empty.view(0, 1) if k > WORD_BASES else None
        return Index(empty, empty, empty, empty, n_genomes, words)
    all_keys = torch.cat(keys_l)
    del keys_l
    words = None
    if k <= WORD_BASES:
        all_keys, order = torch.sort(all_keys, stable=True)
    else:
        order = _lex_order(all_keys)
        words = all_keys[order]
        del all_keys
        new_word = torch.ones(words.shape[0], dtype=torch.bool, device=dev)
        new_word[1:] = (words[1:] != words[:-1]).any(1)
        words = words[new_word]
        all_keys = torch.cumsum(new_word, 0) - 1
        del new_word
    all_gen = torch.cat(gen_l)[order]
    del order, gen_l
    new_pair = torch.ones_like(all_keys, dtype=torch.bool)
    new_pair[1:] = (all_keys[1:] != all_keys[:-1]) | (all_gen[1:] != all_gen[:-1])
    pair_keys, pair_gen = all_keys[new_pair], all_gen[new_pair]
    del all_keys, all_gen, new_pair
    new_key = torch.ones_like(pair_keys, dtype=torch.bool)
    new_key[1:] = pair_keys[1:] != pair_keys[:-1]
    start = new_key.nonzero().reshape(-1)
    gcount = torch.diff(start, append=torch.tensor([pair_keys.numel()], device=dev))
    return Index(pair_keys[new_key], start, gcount, pair_gen, n_genomes, words)


@dataclass
class Gates:
    m: int = 1
    p: int = 1
    min_read_quality: Optional[int] = None
    min_kmer_quality: Optional[int] = None
    max_genomes: Optional[int] = None

    @classmethod
    def from_traffic(cls, gates: dict) -> "Gates":
        return cls(**{f: gates.get(f, getattr(cls, f)) for f in
                      ("m", "p", "min_read_quality", "min_kmer_quality", "max_genomes")})


class Tally:
    """The summary's counters over reads in file order."""

    def __init__(self, n_genomes: int, gates: Gates) -> None:
        self.gates = gates
        self.stats = dict.fromkeys(
            ("unique_mapped_reads", "ambiguous_mapped_reads", "unmapped_reads",
             "filtered_quality_reads", "filtered_quality_kmers", "filtered_hr_kmers"), 0)
        self.unique = np.zeros(n_genomes, dtype=np.int64)
        self.ambiguous = np.zeros(n_genomes, dtype=np.int64)
        self.first = np.full(n_genomes, np.iinfo(np.int64).max, dtype=np.int64)

    def summary(self, descriptions: Sequence[str]) -> dict:
        g = self.gates
        stats = {name: self.stats[name] for name in
                 ("unique_mapped_reads", "ambiguous_mapped_reads", "unmapped_reads")}
        for name, gate in (("filtered_quality_reads", g.min_read_quality),
                           ("filtered_quality_kmers", g.min_kmer_quality),
                           ("filtered_hr_kmers", g.max_genomes)):
            if gate is not None:
                stats[name] = self.stats[name]
        seen = np.nonzero(self.first < np.iinfo(np.int64).max)[0]
        order = seen[np.argsort(self.first[seen], kind="stable")]
        summary = {descriptions[i]: {"unique_reads": int(self.unique[i]),
                                     "ambiguous_reads": int(self.ambiguous[i])}
                   for i in order}
        return {"Statistics": stats, "Summary": summary}


def _first_occurrence(ids: torch.Tensor, stored: torch.Tensor) -> torch.Tensor:
    """[B, W] mask of the stored windows whose id no earlier stored window
    of the row has."""
    vals = torch.where(stored, ids, _I64_MAX)
    sv, order = torch.sort(vals, dim=1, stable=True)
    head = torch.ones_like(stored)
    head[:, 1:] = sv[:, 1:] != sv[:, :-1]
    return torch.zeros_like(stored).scatter_(1, order, head) & stored


def classify_chunk(index: Index, codes: torch.Tensor, qual: torch.Tensor, k: int,
                   gates: Gates, tally: Tally, first_read: int,
                   key_map: KeyMap = None) -> None:
    """Classify reads ``codes``/``qual`` ([B, L] uint8 on the index's
    device, reads ``first_read`` on of the sample) into ``tally``."""
    dev = codes.device
    b, length = codes.shape
    r = index.n_genomes
    big = (length + 2) * (r + 1)
    w = length - k + 1
    filtered = torch.zeros(b, dtype=torch.bool, device=dev)
    if gates.min_read_quality is not None:
        filtered = qual.to(torch.int64).sum(1) < gates.min_read_quality * length
    live = ~filtered
    if w < 1 or k < 1 or index.keys.numel() == 0:
        tally.stats["filtered_quality_reads"] += int(filtered.sum())
        tally.stats["unmapped_reads"] += int(live.sum())
        return
    keys = _window_keys(codes, k, key_map)
    if index.words is not None:
        keys = word_ranks(index, keys)
    kq_ok = torch.ones((b, w), dtype=torch.bool, device=dev)
    n_qual = torch.zeros(b, dtype=torch.int64, device=dev)
    if gates.min_kmer_quality is not None:
        cs = torch.cumsum(qual.to(torch.int64), 1)
        cs = torch.cat([torch.zeros((b, 1), dtype=torch.int64, device=dev), cs], 1)
        kq_ok = (cs[:, k:] - cs[:, :w]) >= gates.min_kmer_quality * k
        n_qual = (~kq_ok).sum(1)
    u = torch.searchsorted(index.keys, keys)
    uc = u.clamp(max=index.keys.numel() - 1)
    hit = (u < index.keys.numel()) & (index.keys[uc] == keys) & kq_ok
    gc = torch.where(hit, index.gcount[uc], 0)
    n_hr = torch.zeros(b, dtype=torch.int64, device=dev)
    stored = hit
    if gates.max_genomes is not None:
        redundant = hit & (gc > gates.max_genomes)
        n_hr = redundant.sum(1)
        stored = hit & ~redundant
    first = _first_occurrence(uc, stored)

    # every (read, window, genome) of a first occurrence
    rows, wins = first.nonzero(as_tuple=True)
    ids = uc[rows, wins]
    cnt = index.gcount[ids]
    rows, wins = rows.repeat_interleave(cnt), wins.repeat_interleave(cnt)
    specific = (cnt == 1).repeat_interleave(cnt)
    base = torch.cumsum(cnt, 0) - cnt
    within = torch.arange(int(cnt.sum()), device=dev) - base.repeat_interleave(cnt)
    genome = index.genome[index.start[ids].repeat_interleave(cnt) + within]
    flat = rows * r + genome
    zeros = torch.zeros(b * r, dtype=torch.int64, device=dev)
    spec = zeros.scatter_add(0, flat[specific], torch.ones_like(flat[specific])).view(b, r)
    total = zeros.scatter_add(0, flat, torch.ones_like(flat)).view(b, r)
    far = torch.full((b * r,), big, dtype=torch.int64, device=dev)
    fw_spec = far.scatter_reduce(0, flat[specific], wins[specific], "amin").view(b, r)
    fw_total = far.scatter_reduce(0, flat, wins, "amin").view(b, r)

    # the m decision over specific k-mers, ties to the genome met first
    g_iota = torch.arange(r, device=dev)[None, :]
    has = first.any(1)
    n_spec = (spec > 0).sum(1)
    top = spec.amax(1)
    met = fw_spec * r + g_iota
    winner = torch.where((spec == top[:, None]) & (spec > 0), met, _I64_MAX).argmin(1)
    is_winner = g_iota == winner[:, None]
    second = torch.where(is_winner, -1, spec).amax(1)
    unique = has & ((n_spec == 1) | ((n_spec > 1) & (top >= second + gates.m)))
    # the p validation over all k-mers
    mapped_total = torch.where(is_winner, total, 0).sum(1)
    downgraded = torch.zeros_like(unique)
    if gates.p >= 0:
        downgraded = unique & ((total.amax(1) - mapped_total) > gates.p)
    unique &= ~downgraded
    ambiguous = has & ~unique

    listed = torch.where(unique[:, None], is_winner,
                         torch.where(downgraded[:, None], total >= mapped_total[:, None],
                                     spec > 0) & ambiguous[:, None])
    listed &= live[:, None]
    order_in = torch.where(downgraded[:, None], fw_total * r + g_iota, met)
    order_in = torch.where(downgraded[:, None] & is_winner, -1, order_in)
    read_no = first_read + torch.arange(b, device=dev)[:, None]
    key = torch.where(listed, read_no * big + order_in + 1, _I64_MAX)

    tally.stats["filtered_quality_reads"] += int(filtered.sum())
    tally.stats["unique_mapped_reads"] += int((unique & live).sum())
    tally.stats["ambiguous_mapped_reads"] += int((ambiguous & live).sum())
    tally.stats["unmapped_reads"] += int((~has & live).sum())
    tally.stats["filtered_quality_kmers"] += int(n_qual[live].sum())
    tally.stats["filtered_hr_kmers"] += int(n_hr[live].sum())
    tally.unique += (is_winner & (unique & live)[:, None]).sum(0).cpu().numpy()
    amb = (listed & ambiguous[:, None]).to(torch.int64)
    amb += (is_winner & (downgraded & live)[:, None]).to(torch.int64)
    tally.ambiguous += amb.sum(0).cpu().numpy()
    tally.first = np.minimum(tally.first, key.amin(0).cpu().numpy())


def summarize(index: Index, codes: np.ndarray, qual: np.ndarray, k: int,
              gates: Gates, descriptions: Sequence[str], device: torch.device,
              key_map: KeyMap = None) -> dict:
    """The dumpalign summary of the reads ``codes``/``qual`` ([N, L] uint8
    host arrays, in file order)."""
    tally = Tally(index.n_genomes, gates)
    for a in range(0, codes.shape[0], READ_CHUNK):
        classify_chunk(index,
                       torch.from_numpy(codes[a: a + READ_CHUNK]).to(device),
                       torch.from_numpy(qual[a: a + READ_CHUNK]).to(device),
                       k, gates, tally, a, key_map)
    return tally.summary(descriptions)


def summary_text(summary: dict) -> str:
    """The summary as the CLI prints it."""
    return json.dumps(summary, indent=4)


def low_word(keys: torch.Tensor) -> torch.Tensor:
    """The control's key: only the low 32 bits of the 62-bit key (the last
    16 bases), as a probe that compares the table row's low word alone."""
    return keys & 0xFFFFFFFF


def high_word(words: torch.Tensor) -> torch.Tensor:
    """The control's key past 31 bases: only the most significant word
    (the first 31 bases), as a probe that compares one word of a
    multi-word key."""
    return words[..., :1]


def control_key(k: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """The control's coarser key at ``k``."""
    return low_word if k <= WORD_BASES else high_word


def count_gaps(got: dict, want: dict) -> Dict[str, int]:
    """How far summary ``got`` lies from ``want``: the largest absolute
    difference of any counter (a key missing on one side counts as 0
    there), and whether the Summary's genome order differs (0 or 1)."""
    gap = 0
    gs, ws = got.get("Statistics", {}), want.get("Statistics", {})
    for name in set(gs) | set(ws):
        gap = max(gap, abs(gs.get(name, 0) - ws.get(name, 0)))
    gsum, wsum = got.get("Summary", {}), want.get("Summary", {})
    zero = {"unique_reads": 0, "ambiguous_reads": 0}
    for genome in set(gsum) | set(wsum):
        a, b = gsum.get(genome, zero), wsum.get(genome, zero)
        for field in zero:
            gap = max(gap, abs(a.get(field, 0) - b.get(field, 0)))
    order = int(list(gsum) != list(wsum) or list(gs) != list(ws))
    return {"max_count_gap": gap, "order_differs": order}
