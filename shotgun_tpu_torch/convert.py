"""State carried across from the JAX package to the port.

Each function takes the JAX package's object with its arrays as numpy
(or anything ``np.asarray`` reads, such as a fetched jax array) and
returns the port's counterpart on ``device``.  The tests use these to
feed both packages identical state.
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np
import torch

from shotgun_tpu_torch.index.build import KmerIndex
from shotgun_tpu_torch.io.packing import GenomeArrays
from shotgun_tpu_torch.io.records import SeqRecord
from shotgun_tpu_torch.models.pipeline import FoldCarry
from shotgun_tpu_torch.ops.probe import HashTableDev, hash_table_to_device
from shotgun_tpu_torch.ops import probe_sort
from shotgun_tpu_torch.reference import KmerReference


def hash_table(tab, device: torch.device) -> HashTableDev:
    """A JAX ``ProbeTable`` (host) or ``HashTableDev`` (device) -> the
    port's ``HashTableDev``; both carry ``table`` and ``stash``."""
    return hash_table_to_device(np.asarray(tab.table), np.asarray(tab.stash),
                                device)


def _keys(klo, khi) -> np.ndarray:
    return (np.asarray(khi).astype(np.int64) << 32) | np.asarray(klo).astype(np.int64)


def sorted_table(tab, device: torch.device) -> probe_sort.SortedTableDev:
    """A JAX ``SortedTableDev`` -> the port's, without its dead rows
    (``gc == 0``: shape-bucket pads and invalid device-build windows)."""
    return probe_sort.sorted_table((_keys(tab.klo, tab.khi),), np.array(tab.sid),
                                   np.array(tab.gc), device)


def sorted_table_words(tab, k: int, device: torch.device) -> probe_sort.SortedTableDev:
    """A JAX ``SortedTableDevW`` (uint32 key words, most significant
    first) of k-mers -> the port's, without its pad rows (``gc == 0``)."""
    words_u32 = np.stack([np.asarray(w) for w in tab.kws[::-1]], axis=1)
    return probe_sort.sorted_table(
        probe_sort.key_words_from_u32(words_u32, k), np.array(tab.sid),
        np.array(tab.gc), device)


def device_build(built: dict, device: torch.device) -> dict:
    """A JAX ``device_build_tables`` dict -> the port's: live rows only
    and one row per distinct key (the JAX table keeps one per window)."""
    tab = probe_sort.sorted_table((_keys(built["klo"], built["khi"]),),
                                  np.array(built["sid"]), np.array(built["gc"]), device)
    (keys,) = tab.words
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    return dict(keys=keys[first], sid=tab.sid[first], gc=tab.gc[first],
                num_kmers=int(built["num_kmers"]), num_sets=int(built["num_sets"]),
                set_masks=np.asarray(built["set_masks"]),
                num_records=int(built["num_records"]),
                num_windows=int(built["klo"].shape[0]), prep_s=built["prep_s"])


def fold_carry(carry, device: torch.device) -> FoldCarry:
    """A JAX ``FoldCarry`` -> the port's, field by field (int32)."""
    return FoldCarry(*(
        torch.from_numpy(np.array(x, dtype=np.int32)).to(device)
        for x in carry))


#: the array fields of a ``KmerIndex``, in its declaration order
_INDEX_ARRAYS = ("record_lengths", "kept", "kmer_words", "first_seen",
                 "post_offsets", "post_record", "post_pos", "set_id",
                 "set_masks", "set_sizes")


def kmer_index(index) -> KmerIndex:
    """A JAX ``KmerIndex`` -> the port's, field by field (the arrays as
    numpy, the descriptions and the EXTSIM report copied)."""
    return KmerIndex(
        k=int(index.k), descriptions=list(index.descriptions),
        similarity_info=(None if index.similarity_info is None
                         else {d: dict(v) for d, v in index.similarity_info.items()}),
        **{name: np.asarray(getattr(index, name)) for name in _INDEX_ARRAYS})


def reference(index, device: torch.device) -> KmerReference:
    """A JAX ``KmerIndex`` (what a JAX ``KmerReference`` holds) -> the
    port's ``KmerReference`` over the same arrays, on ``device``."""
    return KmerReference(int(index.k), _index=kmer_index(index), device=device)


def genome_arrays(genomes) -> GenomeArrays:
    """A JAX ``GenomeArrays`` -> the port's (the same records, codes and
    offsets)."""
    return GenomeArrays(descriptions=list(genomes.descriptions),
                        codes=np.asarray(genomes.codes),
                        offsets=np.asarray(genomes.offsets))


def seq_records(records: Iterable) -> List[SeqRecord]:
    """JAX ``SeqRecord``s -> the port's, field by field in their order."""
    return [SeqRecord(list(rec._fields.items())) for rec in records]
