"""``KmerReference`` for the port: the k-mer database facade over
``index.build``'s ``KmerIndex`` (counterpart of
``shotgun_tpu/reference.py``), with the reference's single-k-mer lookups.

Built on the host (``build_index``: native C++ for k <= 31, numpy for
any k; EXTSIM's overlap matrix on the device from 256 genome
identifiers, ``index/extsim.py``), loaded from and saved to the JAX
package's ``.kdb`` npz container, or built on the device
(``from_device_build``: it aligns, but has no host k-mer arrays to save
or dump), and turned into device probe tables.  ``write_summary`` streams
the dumpref JSON.  The probe routes are the JAX package's: at k <= 31
``auto`` picks the sort join (``sort``) up to the device's crossover
(``routes.device_routes``: the JAX package's 8M distinct k-mers off a
card) and the 16-slot ``hash16`` table above, and ``hash`` (or
any other value) is the 4-slot table; at k > 31 every route is the sort
join of multi-word keys, and ``hash`` raises.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, List, Optional, Set, Union

import numpy as np
import torch

from shotgun_tpu_torch.constants import BASE_CODE_LUT, BASE_N
from shotgun_tpu_torch.errors import UserInputError
from shotgun_tpu_torch.index.build import (
    KmerIndex,
    build_index,
    num_key_words,
    sort_keys_from_words,
)
from shotgun_tpu_torch.io.packing import GenomeArrays, pack_genomes
from shotgun_tpu_torch.io.records import SeqRecord
from shotgun_tpu_torch.index.device_build import (
    device_build_tables,
    device_hash_table,
    index_hash_table,
    index_table_admitted,
)
from shotgun_tpu_torch.index.extsim import apply_similarity_filter
from shotgun_tpu_torch.index.hashtable import (
    ProbeTable,
    SlotLimitError,
    build_probe_table,
    check_slot_limit,
    first_buckets,
    slot_limit_keys,
)
from shotgun_tpu_torch.models.pipeline import DeviceTable
from shotgun_tpu_torch.ops.probe import HashTableDev, hash_table_to_device
from shotgun_tpu_torch.ops.probe_sort import sorted_table, sorted_table_host
from shotgun_tpu_torch.routes import device_routes
from shotgun_tpu_torch.utils.device import resolve_device
from shotgun_tpu_torch.utils.profiling import phase

PROBE_ENV = "SHOTGUN_TPU_PROBE"


class KDBFormatError(Exception):
    """A .kdb container cannot be read (the CLI maps this to the
    reference's 'Error: Incorrect format of input file.' message)."""


def reverse_complement(seq: str) -> str:
    """Reverse complement of a nucleotide string (reference kmer.py:96-103)."""
    return seq.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def extract_kmers_from_genome(k: int, genome: str):
    """Iterate (position, k-mer) windows (reference kmer.py:84-94)."""
    if k > len(genome) or k <= 0:
        return iter([])
    return ((i, genome[i: i + k]) for i in range(len(genome) - k + 1))


_BASE_ASCII = np.frombuffer(b"ACGT", dtype=np.uint8)


def _decode_kmer_strings(words: np.ndarray, k: int) -> List[str]:
    """[C, nw] key-word rows -> k-mer strings, vectorized over rows
    (``index.build.rolling_encode_words``' layout: word j holds window
    bases [k-16(j+1), k-16j), the leftmost base in the most significant
    bits)."""
    c = words.shape[0]
    out = np.empty((c, k), dtype=np.uint8)
    for j in range(words.shape[1]):
        t_hi = k - 16 * j
        if t_hi <= 0:
            break
        t_lo = max(t_hi - 16, 0)
        wcol = words[:, j]
        for t in range(t_lo, t_hi):
            shift = np.uint32(2 * (t_hi - 1 - t))
            out[:, t] = ((wcol >> shift) & np.uint32(3)).astype(np.uint8)
    ascii_rows = np.ascontiguousarray(_BASE_ASCII[out])
    return np.char.decode(ascii_rows.view(f"S{k}").reshape(-1),
                          "ascii").tolist()


class _DeviceIndexStub:
    """Index facade of a device-built reference: the align and summary
    paths read only k, the record descriptions and lengths and the key
    and set counts; the key-shaped arrays live on the device.  Anything
    that needs host k-mer arrays raises (counterpart of the JAX package's,
    its ``reference.py:79-105``)."""

    def __init__(self, k, descriptions, record_lengths, num_kmers, num_sets):
        self.k = k
        self.descriptions = descriptions
        self.record_lengths = record_lengths
        self.kept = np.ones(len(descriptions), dtype=bool)
        self.num_kmers = num_kmers
        self.num_sets = num_sets
        self.similarity_info = None

    @property
    def num_records(self) -> int:
        return len(self.descriptions)

    def __getattr__(self, name):
        raise AttributeError(
            f"device-built reference has no host index array '{name}'; "
            "build it on the host (KmerReference(k, container)) for "
            "dumpref and .kdb files")


class KmerReference:
    #: auto probe crossover in distinct k-mers; None takes the device's
    #: (``routes.device_routes``), a number overrides it
    AUTO_HASH_MIN_KEYS: Optional[int] = None

    def __init__(
        self,
        k: int,
        fasta_record_container: Optional[
            Union[GenomeArrays, Iterable[SeqRecord]]] = None,
        filter_similar: bool = False,
        similarity_threshold: float = 0.95,
        _index: Optional[KmerIndex] = None,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        """``device`` (default ``resolve_device()``: $SHOTGUN_TPU_TORCH_DEVICE,
        else ``cuda``, which raises where there is none) runs EXTSIM's
        overlap matrix (``filter_similar``) from 256 genome identifiers on;
        nothing else here touches it."""
        self.device = resolve_device(device)
        if filter_similar and not (0 <= similarity_threshold <= 1):
            raise UserInputError("similarity_threshold must be between 0 and 1")
        # the genome records of the single-read API: a parsed container's,
        # or the records given, materialized on first use
        self._container = None
        self._records: Optional[List[SeqRecord]] = None
        if _index is not None:
            self.index = _index
        else:
            if isinstance(fasta_record_container, GenomeArrays):
                genomes = fasta_record_container
            elif hasattr(fasta_record_container, "to_genome_arrays"):
                genomes = fasta_record_container.to_genome_arrays()
                self._container = fasta_record_container
            else:
                self._records = list(fasta_record_container)
                genomes = pack_genomes(self._records)
            self.index = build_index(genomes, k)
            if filter_similar:
                self.index = apply_similarity_filter(
                    self.index, similarity_threshold, self.device)
        self._probe_tables: Dict[str, ProbeTable] = {}
        self._set_member_dense: Optional[np.ndarray] = None
        self._device_tables: Dict[tuple, DeviceTable] = {}
        # device build products (from_device_build), and whether the
        # 16-slot hash table cannot be made (a device build's over the
        # budget or its stash, any past the probe's slot limit)
        self._built: Optional[dict] = None
        self._hash16_failed = False

    @classmethod
    def from_device_build(cls, genomes: GenomeArrays, k: int,
                          device: Optional[Union[str, torch.device]] = None
                          ) -> Optional["KmerReference"]:
        """A reference whose tables were built on ``device`` (default
        ``resolve_device()``; ``index/device_build.py``): it aligns and
        summarizes as a host-built one does, but holds no host k-mer
        arrays.  None when the device build does not take the input;
        callers then build on the host."""
        device = resolve_device(device)
        built = device_build_tables(genomes, k, device)
        if built is None:
            return None
        index = _DeviceIndexStub(
            k=k, descriptions=list(genomes.descriptions),
            record_lengths=np.diff(genomes.offsets).astype(np.int64),
            num_kmers=built["num_kmers"], num_sets=built["num_sets"])
        self = cls(k, _index=index, device=device)
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
    # reference-parity accessors
    # ------------------------------------------------------------------

    @property
    def kmer_len(self) -> int:
        return self.index.k

    @property
    def similarity_info(self) -> Optional[Dict[str, Dict[str, Any]]]:
        return self.index.similarity_info

    @property
    def genomes(self) -> List[SeqRecord]:
        """Kept genome records, input order (reference kmer.py:245-250)."""
        recs = self._materialized_records()
        return [recs[r] for r in range(self.index.num_records) if self.index.kept[r]]

    def _materialized_records(self) -> List[SeqRecord]:
        """The genome records; a reference read from a file or given
        genome arrays holds none, and gets records of its descriptions
        with empty genomes (as the JAX package's does)."""
        if self._records is None:
            if self._container is not None:
                self._records = list(self._container.records)
            else:
                self._records = [SeqRecord([("description", d), ("genome", "")])
                                 for d in self.index.descriptions]
        return self._records

    def _encode_query(self, kmer: str) -> Optional[int]:
        """k-mer string -> k-mer id, or None on a miss or a non-ACGT base
        (found so without the index, also on a device-built reference)."""
        if len(kmer) != self.index.k:
            return None
        raw = np.frombuffer(kmer.encode("ascii", errors="replace"), dtype=np.uint8)
        codes = BASE_CODE_LUT[raw]
        if (codes >= BASE_N).any():
            return None
        val = 0
        for c in codes:
            val = (val << 2) | int(c)
        qwords = np.asarray([(val >> (32 * j)) & 0xFFFFFFFF
                             for j in range(num_key_words(self.index.k))],
                            dtype=np.uint32)[None, :]
        key = sort_keys_from_words(qwords)[0]
        self._require_host_index("k-mer lookups")
        keys = self.index.sort_keys()
        pos = int(np.searchsorted(keys, key))
        if pos < keys.size and keys[pos] == key:
            return pos
        return None

    def __getitem__(self, kmer: str) -> Optional[Dict[SeqRecord, Set[int]]]:
        """{genome record: positions} of one k-mer; None when it cannot be
        encoded (another length than k, a base other than ACGT) or is not
        in the index (the JAX package's ``ref[kmer]``)."""
        kid = self._encode_query(kmer)
        return None if kid is None else self._kmer_mapping(kid)

    def get_kmer_references(self, kmer: str) -> Dict[SeqRecord, Set[int]]:
        """{genome record: positions} of one k-mer, {} when absent."""
        kid = self._encode_query(kmer)
        return {} if kid is None else self._kmer_mapping(kid)

    def _kmer_mapping(self, kid: int) -> Dict[SeqRecord, Set[int]]:
        recs = self._materialized_records()
        return {recs[r]: set(int(x) for x in self.index.positions_of(kid, r))
                for r in self.index.records_of_kmer(kid)}

    def get_kmer_and_reverse_references(self, kmer: str) -> Dict[SeqRecord, Set[int]]:
        """Merged references of a k-mer and its reverse complement
        (reference kmer.py:331-351)."""
        result = {rec: set(pos) for rec, pos in self.get_kmer_references(kmer).items()}
        rev = reverse_complement(kmer)
        if rev != kmer:
            for rec, positions in self.get_kmer_references(rev).items():
                result.setdefault(rec, set()).update(positions)
        return result

    def _require_host_index(self, what: str) -> None:
        if isinstance(self.index, _DeviceIndexStub):
            raise AttributeError(
                f"a device-built reference has no host k-mer arrays for {what}; "
                "build it on the host (KmerReference(k, container))")

    # ------------------------------------------------------------------
    # dumpref summary (exact dict orders; reference kmer.py:300-329)
    # ------------------------------------------------------------------

    def write_summary(self, fh, chunk: int = 1 << 16) -> None:
        """Stream the dumpref JSON to ``fh``, byte-identical to
        ``json.dumps(self.get_summary(), indent=4)`` (the JAX package's
        ``write_summary``).  Walks ``display_order`` in chunks: k-mer
        strings decode vectorized, postings gather per chunk, per-genome
        stats accumulate in flat arrays, and each chunk's text is written
        at once, so extra memory is O(chunk).  Every dict order of the
        reference is kept: k-mer first-seen, records per k-mer, genomes in
        first-encounter order, and duplicate descriptions (the FIRST slot,
        the LAST record's positions and length)."""
        self._require_host_index("dumpref")
        idx = self.index
        gc_all = np.asarray(idx.genome_counts())
        disp = idx.display_order()
        u = int(disp.size)
        r_count = idx.num_records
        # collapse duplicate descriptions exactly like dict keys do
        desc_ids: Dict[str, int] = {}
        rec2desc = np.empty(max(r_count, 1), np.int64)
        for rci, d in enumerate(idx.descriptions):
            rec2desc[rci] = desc_ids.setdefault(d, len(desc_ids))
        nd = max(len(desc_ids), 1)
        desc_json = [json.dumps(d) for d in desc_ids]  # insertion order
        uniq_d = np.zeros(nd, np.int64)
        tot_d = np.zeros(nd, np.int64)
        last_rec_d = np.full(nd, -1, np.int64)
        first_pair_d = np.full(nd, np.iinfo(np.int64).max, np.int64)
        pair_counter = 0

        w = fh.write
        w('{\n    "Kmers": {')
        first_entry = True
        for c0 in range(0, u, chunk):
            kids = disp[c0: c0 + chunk]
            starts = idx.post_offsets[kids].astype(np.int64)
            lens = (idx.post_offsets[kids + 1] - starts).astype(np.int64)
            total = int(lens.sum())
            # flat posting gather: the postings of a k-mer are contiguous,
            # (record, position) ascending
            step = np.ones(total, np.int64)
            step[0] = 0
            cs = np.cumsum(lens)[:-1]
            step[cs] = starts[1:] - (starts[:-1] + lens[:-1] - 1)
            flat_idx = np.cumsum(step) + starts[0]
            recs = idx.post_record[flat_idx].astype(np.int64)
            poss = idx.post_pos[flat_idx]
            kid_local = np.repeat(np.arange(kids.size, dtype=np.int64), lens)
            newrec = np.empty(total, bool)
            newrec[0] = True
            newrec[1:] = ((kid_local[1:] != kid_local[:-1])
                          | (recs[1:] != recs[:-1]))
            b_idx = np.flatnonzero(newrec)
            seg_end = np.append(b_idx[1:], total)
            b_kid = kid_local[b_idx]
            b_rec = recs[b_idx]
            b_desc = rec2desc[b_rec]
            # per-genome stats over distinct (kid, desc) pairs
            ukey = np.unique(b_kid * np.int64(nd) + b_desc)
            ud = ukey % nd
            spec = gc_all[kids[(ukey // nd)]] == 1
            tot_d += np.bincount(ud, minlength=nd)
            uniq_d += np.bincount(ud[spec], minlength=nd)
            last_rec_d[b_desc] = b_rec  # fancy assign: last writer wins
            np.minimum.at(first_pair_d, b_desc,
                          pair_counter + np.arange(b_idx.size))
            pair_counter += int(b_idx.size)

            kstrs = _decode_kmer_strings(idx.kmer_words[kids], idx.k)
            # per-kid boundary ranges (b_kid is nondecreasing)
            b_start = np.searchsorted(b_kid, np.arange(kids.size + 1))
            pos_l = poss.tolist()
            parts: List[str] = []
            ap = parts.append
            for i in range(kids.size):
                ap("," if not first_entry else "")
                first_entry = False
                ap('\n        "')
                ap(kstrs[i])
                ap('": {')
                bs, be = int(b_start[i]), int(b_start[i + 1])
                if be - bs == 1:
                    # single record (the common case)
                    j = bs
                    ap('\n            ')
                    ap(desc_json[b_desc[j]])
                    ap(': [\n                ')
                    ap(",\n                ".join(
                        map(str, pos_l[b_idx[j]: seg_end[j]])))
                    ap('\n            ]\n        }')
                else:
                    # multiple records; duplicate descriptions keep the
                    # FIRST slot but the LAST record's positions
                    inner: Dict[int, str] = {}
                    for j in range(bs, be):
                        inner[int(b_desc[j])] = (
                            '[\n                '
                            + ",\n                ".join(
                                map(str, pos_l[b_idx[j]: seg_end[j]]))
                            + '\n            ]')
                    ap('\n            ')
                    ap(',\n            '.join(
                        f'{desc_json[di]}: {body}'
                        for di, body in inner.items()))
                    ap('\n        }')
            w("".join(parts))
        w('\n    }' if not first_entry else '}')

        # Summary: genomes in first-encounter order over the k-mer walk
        live = np.flatnonzero(first_pair_d < np.iinfo(np.int64).max)
        order = live[np.argsort(first_pair_d[live], kind="stable")]
        rl = np.asarray(idx.record_lengths)
        names = list(desc_ids)
        summary = {
            names[di]: {
                "total_bases": int(rl[last_rec_d[di]]),
                "unique_kmers": int(uniq_d[di]),
                "multi_mapping_kmers": int(tot_d[di] - uniq_d[di]),
            }
            for di in order
        }
        w(',\n    "Summary": ')
        w(json.dumps(summary, indent=4).replace("\n", "\n    "))
        if idx.similarity_info is not None:
            w(',\n    "Similarity": ')
            w(json.dumps(idx.similarity_info, indent=4).replace("\n", "\n    "))
        w("\n}")

    def get_summary(self) -> Dict[str, Any]:
        """The dumpref dict (the per-k-mer form ``write_summary`` streams)."""
        self._require_host_index("dumpref")
        idx = self.index
        genome_counts = idx.genome_counts()
        kmer_details: Dict[str, Dict[str, List[int]]] = {}
        genome_summary: Dict[str, Dict[str, int]] = {}
        genome_kmer_sets: Dict[str, Set[int]] = {}
        for kid in idx.display_order():
            kid = int(kid)
            inner: Dict[str, List[int]] = {}
            for r in idx.records_of_kmer(kid):
                desc = idx.descriptions[r]
                inner[desc] = sorted(int(x) for x in idx.positions_of(kid, r))
                entry = genome_summary.setdefault(
                    desc,
                    {"total_bases": 0, "unique_kmers": 0, "multi_mapping_kmers": 0})
                entry["total_bases"] = int(idx.record_lengths[r])
                genome_kmer_sets.setdefault(desc, set()).add(kid)
            kmer_details[idx.kmer_string(kid)] = inner
        for desc, kset in genome_kmer_sets.items():
            unique = sum(1 for kid in kset if genome_counts[kid] == 1)
            genome_summary[desc]["unique_kmers"] = unique
            genome_summary[desc]["multi_mapping_kmers"] = len(kset) - unique
        summary: Dict[str, Any] = {"Kmers": kmer_details, "Summary": genome_summary}
        if idx.similarity_info is not None:
            summary["Similarity"] = idx.similarity_info
        return summary

    # ------------------------------------------------------------------
    # .kdb files (the JAX package's npz container, version 2)
    # ------------------------------------------------------------------

    def save(self, ref_file) -> None:
        """Write the .kdb container to a path or a binary file object."""
        self._require_host_index(".kdb files")
        if hasattr(ref_file, "write"):
            self.save_to(ref_file)
            return
        with open(ref_file, "wb") as fh:
            self.save_to(fh)

    def save_to(self, fh) -> None:
        """The JAX package's ``save_to``: an uncompressed npz (the 2-bit
        key packs barely deflate), the meta keys in its order."""
        self._require_host_index(".kdb files")
        idx = self.index
        meta = {
            "format": "shotgun-tpu-kdb",
            "version": 2,
            "k": idx.k,
            "descriptions": idx.descriptions,
            "similarity_info": idx.similarity_info,
        }
        np.savez(
            fh,
            meta=np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8),
            record_lengths=idx.record_lengths,
            kept=idx.kept,
            kmer_words=idx.kmer_words,
            first_seen=idx.first_seen,
            post_offsets=idx.post_offsets,
            post_record=idx.post_record,
            post_pos=idx.post_pos,
            set_id=idx.set_id,
            set_masks=idx.set_masks,
            set_sizes=idx.set_sizes,
        )

    @classmethod
    def load(cls, ref_file, device: Optional[Union[str, torch.device]] = None
             ) -> "KmerReference":
        """A ``.kdb`` of either package, on ``device`` (default
        ``resolve_device()``, decided before the file is read)."""
        device = resolve_device(device)
        idx = cls._load_index(ref_file)
        return cls(idx.k, _index=idx, device=device)

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
        The JAX package's routes (its ``reference.py:574-628``, ``:645``):
        at k <= 31 'auto' is 'hash16' above the crossover
        (``AUTO_HASH_MIN_KEYS``, else this reference's device's) distinct
        k-mers, unless the hash table could not be made, and 'sort'
        otherwise, and any value but 'sort' and 'hash16' is 'hash'.  At
        k > 31 every value but 'hash' is the sort join of multi-word keys,
        and 'hash' raises.

        On every device the probe numbers at most ``STASH_POS_BASE`` slots
        (``index.hashtable``), where the JAX package's positions wrap: past
        ``slot_limit_keys(16)`` keys 'auto' is 'sort', and an explicit
        'hash16', or 'hash' past ``slot_limit_keys(4)``, raises
        ``SlotLimitError`` (a ``ValueError``) before any table is made."""
        method = method or os.environ.get(PROBE_ENV, "auto")
        k = self.index.k
        if k > 31:
            if method == "hash":
                raise ValueError(
                    "the bucketized hash probe supports k <= 31 only; "
                    "use the sort-merge probe (SHOTGUN_TPU_PROBE=sort) for "
                    f"k={k}")
            return "sort"
        if method == "auto":
            crossover = self.AUTO_HASH_MIN_KEYS
            if crossover is None:
                crossover = device_routes(self.device).auto_hash_min_keys
            u = self.index.num_kmers
            big = crossover < u <= slot_limit_keys(16) and not self._hash16_failed
            return "hash16" if big else "sort"
        method = method if method in ("sort", "hash16") else "hash"
        if method != "sort":
            slots = 16 if method == "hash16" else 4
            check_slot_limit(first_buckets(self.index.num_kmers, slots), slots)
        return method

    def probe_table(self, method: str = "hash") -> ProbeTable:
        """Host hash table: 4 slots for 'hash', 16 for 'hash16'."""
        if self.index.k > 31:
            raise ValueError(
                "the bucketized hash table packs keys as (lo, hi) pairs "
                f"and supports k <= 31 only (k={self.index.k})")
        if method not in self._probe_tables:
            idx = self.index
            self._probe_tables[method] = build_probe_table(
                idx.kmer_lo, idx.kmer_hi, idx.set_id, idx.genome_counts(),
                slots_per_bucket=16 if method == "hash16" else 4)
        return self._probe_tables[method]

    def device_probe_tables(self, device: torch.device, method: Optional[str] = None
                            ) -> DeviceTable:
        """The probe table on ``device``, made once.  Every hash table is
        assembled on a device when ``$SHOTGUN_TPU_HASH_HBM_BUDGET`` admits
        it (``index/device_build.py``), and the budget's refusal routes
        as in the JAX package:

        - a device-built reference assembles its 16-slot table from the
          build products.  When that fails deterministically (over the
          budget, or a stash that keeps overflowing) the failure is kept:
          'auto' takes the sort join from then on, and an explicit
          'hash16' raises;
        - a host index (built, loaded or EXTSIM-filtered) assembles its
          4- or 16-slot table on ``device`` (``index_hash_table``), the
          host builder's bit for bit; over the budget it takes the host
          builder (``probe_table``) and uploads that table.  When a stash
          doubling would take either past the probe's slot limit
          (``SlotLimitError``), 'auto' takes the sort join from then on
          and an explicit method raises.

        The CLI's ``--profile`` names a host index's route inside
        ``table_build``: stage ``hash_table_device`` or
        ``hash_table_host``.  Device errors raise; nothing falls back to
        the host on one."""
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
                        "does not fit the memory budget, its stash or the "
                        "probe's slot limit")
                method = "sort"
        key = (method, str(device))
        if key not in self._device_tables and method != "sort":
            try:
                self._device_tables[key] = self._index_hash_table(method, device)
            except SlotLimitError:
                if requested != "auto":
                    raise
                self._hash16_failed = True
                method, key = "sort", ("sort", str(device))
        if key not in self._device_tables:
            self._device_tables[key] = sorted_table(*self.sort_columns(), device)
        return self._device_tables[key]

    def _index_hash_table(self, method: str, device: torch.device) -> HashTableDev:
        """The host index's hash table on ``device``: assembled there when
        the budget admits it, else the host builder's, uploaded."""
        slots = 16 if method == "hash16" else 4
        ht = None
        if index_table_admitted(self.index, slots, device):
            with phase("hash_table_device"):
                ht = index_hash_table(self.index, slots, device)
        if ht is not None:
            return HashTableDev(*ht)
        with phase("hash_table_host"):
            pt = self.probe_table(method)
            return hash_table_to_device(pt.table, pt.stash, device)

    def sort_columns(self) -> tuple:
        """(words, sid, gc): the key-sorted table's columns where they live,
        a device build's rows on its device, else the host index's
        (``sorted_table_host``)."""
        if self._built is not None:
            return (self._built["keys"],), self._built["sid"], self._built["gc"]
        return sorted_table_host(self.index)

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
