"""``KmerReference`` for the port: the k-mer database facade over
``shotgun_tpu.index.build``'s ``KmerIndex`` (counterpart of
``shotgun_tpu/reference.py``, the parts dumpalign needs).

Built on the host (``build_index``: native C++ for k <= 31, numpy for
any k), loaded from the JAX package's ``.kdb`` npz container, or built
on the device (``from_device_build``), and turned into device probe
tables.  ``auto`` picks the sort join (``sort``) up to
``AUTO_HASH_MIN_KEYS`` distinct k-mers and the 16-slot ``hash16`` table
above, as the JAX package does; ``hash`` is the 4-slot table.  k > 31
raises ``NotImplementedError``; nothing substitutes another probe
quietly.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Optional, Union

import numpy as np
import torch

from shotgun_tpu.errors import UserInputError
from shotgun_tpu.index import extsim
from shotgun_tpu.index.build import KmerIndex, build_index
from shotgun_tpu.io.packing import GenomeArrays, pack_genomes
from shotgun_tpu.io.records import SeqRecord
from shotgun_tpu_torch.index.device_build import device_build_tables, device_hash_table
from shotgun_tpu_torch.index.hashtable import ProbeTable, build_probe_table
from shotgun_tpu_torch.ops.probe import HashTableDev, hash_table_to_device
from shotgun_tpu_torch.ops.probe_sort import SortedTableDev, sorted_table, sorted_table_host

PROBE_ENV = "SHOTGUN_TPU_PROBE"


class KDBFormatError(Exception):
    """A .kdb container cannot be read (the CLI maps this to the
    reference's 'Error: Incorrect format of input file.' message)."""


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not yet ported to shotgun_tpu_torch "
        f"(ROADMAP.md, Queue 1 item {item})")


class _DeviceIndexStub:
    """Index facade of a device-built reference: the align and summary
    paths read only k, the record descriptions and the key and set
    counts; the key-shaped arrays live on the device.  Anything that needs
    host k-mer arrays raises (counterpart of the JAX package's, its
    ``reference.py:79-105``)."""

    def __init__(self, k, descriptions, num_kmers, num_sets):
        self.k = k
        self.descriptions = descriptions
        self.num_kmers = num_kmers
        self.num_sets = num_sets

    @property
    def num_records(self) -> int:
        return len(self.descriptions)

    def __getattr__(self, name):
        raise AttributeError(
            f"device-built reference has no host index array '{name}'; "
            "build it on the host (KmerReference(k, container)) instead")


class KmerReference:
    #: auto probe crossover in distinct k-mers (the JAX package's value,
    #: set on a TPU; to be re-derived from H100 measurements)
    AUTO_HASH_MIN_KEYS = 8_000_000

    def __init__(
        self,
        k: int,
        fasta_record_container: Optional[
            Union[GenomeArrays, Iterable[SeqRecord]]] = None,
        filter_similar: bool = False,
        similarity_threshold: float = 0.95,
        _index: Optional[KmerIndex] = None,
    ) -> None:
        if filter_similar and not (0 <= similarity_threshold <= 1):
            raise UserInputError("similarity_threshold must be between 0 and 1")
        if _index is not None:
            self.index = _index
        else:
            if isinstance(fasta_record_container, GenomeArrays):
                genomes = fasta_record_container
            elif hasattr(fasta_record_container, "to_genome_arrays"):
                genomes = fasta_record_container.to_genome_arrays()
            else:
                genomes = pack_genomes(list(fasta_record_container))
            self.index = build_index(genomes, k)
            if filter_similar:
                # EXTSIM runs its overlap matrix through jax at or above
                # extsim._DEVICE_MIN_G identifiers
                if len(set(self.index.descriptions)) >= extsim._DEVICE_MIN_G:
                    raise _not_ported(
                        f"--filter-similar with >= {extsim._DEVICE_MIN_G} "
                        "genome identifiers (the EXTSIM device matmul)", 6)
                self.index = extsim.apply_similarity_filter(
                    self.index, similarity_threshold)
        self._probe_tables: Dict[str, ProbeTable] = {}
        self._set_member_dense: Optional[np.ndarray] = None
        self._device_tables: Dict[tuple, Union[HashTableDev, SortedTableDev]] = {}
        # device build products (from_device_build), and whether their
        # 16-slot hash table cannot be assembled
        self._built: Optional[dict] = None
        self._hash16_failed = False

    @classmethod
    def from_device_build(cls, genomes: GenomeArrays, k: int,
                          device: torch.device) -> Optional["KmerReference"]:
        """A reference whose tables were built on ``device``
        (``index/device_build.py``): it aligns and summarizes as a
        host-built one does, but holds no host k-mer arrays.  None when
        the device build does not take the input; callers then build on
        the host."""
        built = device_build_tables(genomes, k, device)
        if built is None:
            return None
        index = _DeviceIndexStub(
            k=k, descriptions=list(genomes.descriptions),
            num_kmers=built["num_kmers"], num_sets=built["num_sets"])
        self = cls(k, _index=index)
        r = index.num_records
        bits = np.unpackbits(built["set_masks"], axis=1, bitorder="little")
        dense = np.zeros((max(built["num_sets"], 1), r), dtype=np.uint8)
        dense[: built["num_sets"]] = bits[:, :r]
        self._set_member_dense = dense
        # the hash table assembles lazily, on the first probe above the
        # auto crossover: a build that never aligns never pays for it
        self._built = built
        return self

    # ------------------------------------------------------------------
    # .kdb loading (the JAX package's npz container)
    # ------------------------------------------------------------------

    @classmethod
    def load(cls, ref_file) -> "KmerReference":
        idx = cls._load_index(ref_file)
        return cls(idx.k, _index=idx)

    @staticmethod
    def _load_index(ref_file) -> KmerIndex:
        try:
            with np.load(ref_file, allow_pickle=False) as data:
                meta = json.loads(bytes(data["meta"]).decode("utf-8"))
                if meta.get("format") != "shotgun-tpu-kdb":
                    raise KDBFormatError("not a shotgun-tpu kdb file")
                if "kmer_words" in data:
                    kmer_words = data["kmer_words"]
                else:  # version-1 container: (lo, hi) columns
                    kmer_words = np.stack(
                        [data["kmer_lo"], data["kmer_hi"]], axis=1)
                return KmerIndex(
                    k=int(meta["k"]),
                    descriptions=list(meta["descriptions"]),
                    record_lengths=data["record_lengths"],
                    kept=data["kept"],
                    kmer_words=kmer_words,
                    first_seen=data["first_seen"],
                    post_offsets=data["post_offsets"],
                    post_record=data["post_record"],
                    post_pos=data["post_pos"],
                    set_id=data["set_id"],
                    set_masks=data["set_masks"],
                    set_sizes=data["set_sizes"],
                    similarity_info=meta.get("similarity_info"),
                )
        except KDBFormatError:
            raise
        except Exception as exc:  # zip/npz/json corruption
            raise KDBFormatError(f"cannot read reference file: {exc}") from exc

    # ------------------------------------------------------------------
    # device-side arrays
    # ------------------------------------------------------------------

    def probe_method(self, method: Optional[str] = None) -> str:
        """'sort' (the sort join), 'hash' (4 slots) or 'hash16' (16
        slots); ``method`` defaults to $SHOTGUN_TPU_PROBE or 'auto'.
        'auto' is 'hash16' above ``AUTO_HASH_MIN_KEYS`` distinct k-mers,
        unless the device-built hash table could not be assembled, and
        'sort' otherwise."""
        method = method or os.environ.get(PROBE_ENV, "auto")
        if self.index.k > 31:
            raise _not_ported(
                f"k={self.index.k} > 31 (multi-word keys)", 4)
        if method == "auto":
            big = (self.index.num_kmers > self.AUTO_HASH_MIN_KEYS
                   and not self._hash16_failed)
            return "hash16" if big else "sort"
        if method not in ("sort", "hash", "hash16"):
            raise UserInputError(
                f"unknown probe method {method!r} (auto, sort, hash, hash16)")
        return method

    def probe_table(self, method: str = "hash") -> ProbeTable:
        """Host hash table: 4 slots for 'hash', 16 for 'hash16'."""
        if method not in self._probe_tables:
            idx = self.index
            self._probe_tables[method] = build_probe_table(
                idx.kmer_lo, idx.kmer_hi, idx.set_id, idx.genome_counts(),
                slots_per_bucket=16 if method == "hash16" else 4)
        return self._probe_tables[method]

    def device_probe_tables(self, device: torch.device, method: Optional[str] = None
                            ) -> Union[HashTableDev, SortedTableDev]:
        """The probe table on ``device``, made once.

        A device-built reference assembles its 16-slot table on the
        device from the build products.  When that fails deterministically
        (over the memory budget, or a stash that keeps overflowing) the
        failure is kept: 'auto' takes the sort join from then on, and an
        explicit 'hash16' raises.  Device errors raise."""
        device = torch.device(device)
        requested = method or os.environ.get(PROBE_ENV, "auto")
        method = self.probe_method(requested)
        if method == "hash16" and self._built is not None:
            key = (method, str(device))
            if key not in self._device_tables and not self._hash16_failed:
                ht = device_hash_table(self._built)
                if ht is None:
                    self._hash16_failed = True
                else:
                    self._device_tables[key] = HashTableDev(
                        table=ht[0].to(device), stash=ht[1].to(device))
            if self._hash16_failed:
                if requested != "auto":
                    raise RuntimeError(
                        "the 16-slot hash table of this device-built reference "
                        "does not fit the memory budget or its stash")
                method = "sort"
        key = (method, str(device))
        if key not in self._device_tables:
            if method == "sort" and self._built is not None:
                tab = SortedTableDev(*(self._built[c].to(device)
                                       for c in ("keys", "sid", "gc")))
            elif method == "sort":
                tab = sorted_table(*sorted_table_host(self.index), device)
            else:
                pt = self.probe_table(method)
                tab = hash_table_to_device(pt.table, pt.stash, device)
            self._device_tables[key] = tab
        return self._device_tables[key]

    def set_member_dense(self) -> np.ndarray:
        """[S, R] uint8 record-membership matrix of the genome sets (at
        least one row, so an empty index still has a well-formed shape)."""
        if self._set_member_dense is None:
            idx = self.index
            r = idx.num_records
            dense = np.zeros((max(idx.num_sets, 1), r), dtype=np.uint8)
            if idx.num_sets:
                bits = np.unpackbits(idx.set_masks, axis=1, bitorder="little")
                dense[: idx.num_sets] = bits[:, :r]
            self._set_member_dense = dense
        return self._set_member_dense

    def set_member_device(self, device: torch.device) -> torch.Tensor:
        """``set_member_dense`` as a bool tensor on ``device``."""
        return torch.from_numpy(self.set_member_dense()).to(device) != 0
