"""The port's DP x TP mesh (shotgun_tpu_torch.parallel.table_sharded): the
key-sorted table range-partitioned over a 'table' axis, reads over 'data'.
Held against the JAX package's align_aggregate_table_sharded on the 8
virtual CPU devices of tests/conftest.py and against the port's single
device, for every mesh shape; every field exactly (tolerance 0).  The
library route (align_packed_reads on a 2-D mesh) is held against the
JAX package's on every probe route, above the auto crossover too, and
places only key ranges on the devices.  A table axis across processes:
tests/test_torch_distributed.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shotgun_tpu.index.build import build_index
from shotgun_tpu.io.packing import pack_reads as jax_pack_reads
from shotgun_tpu.io.records import SeqRecord as JaxSeqRecord
from shotgun_tpu.ops.probe_sort import sorted_table_host as jax_sorted_table_host
from shotgun_tpu.ops.probe_sort import sorted_table_host_words
from shotgun_tpu.aligner import PseudoAlignment as JaxPseudoAlignment
from shotgun_tpu.parallel import mesh as jmesh
from shotgun_tpu.parallel import table_sharded as jts
from shotgun_tpu.reference import KmerReference as JaxKmerReference
from shotgun_tpu.utils.synth import synth_genomes, synth_reads
from shotgun_tpu_torch import aligner, convert
from shotgun_tpu_torch.aligner import PseudoAlignment
from shotgun_tpu_torch.io.packing import ReadBatch
from shotgun_tpu_torch.models import pipeline as tpipe
from shotgun_tpu_torch.ops.encode import pack_codes_2bit
from shotgun_tpu_torch.ops.probe_sort import SortedTableDev, sorted_table_host
from shotgun_tpu_torch.parallel import mesh as tmesh
from shotgun_tpu_torch.parallel import table_sharded as tts
from shotgun_tpu_torch.reference import KmerReference

torch.set_num_threads(2)
CPU = torch.device("cpu")
K, L, B = 11, 60, 64
MESHES = [(4, 2), (2, 4), (1, 8), (8, 1)]
#: align_packed_reads' MRQ, MKQ and MG on the corpus of _setup: each
#: filters some reads or windows, and most reads map
LIBRARY_GATES = (64, 65, 1)


def _genomes():
    return synth_genomes(np.random.default_rng(7), 4, 3000)


def _setup(k=K):
    """tests/test_table_sharded.py's corpus (4 random 3 kbp genomes, 64
    reads of 60 bases), with random qualities so the MKQ gate bites; the
    JAX index and read batch."""
    rng = np.random.default_rng(7)
    genomes = synth_genomes(rng, 4, 3000)
    reads = synth_reads(rng, genomes, B, L)
    reads.qual[:] = rng.integers(55, 75, size=reads.qual.shape)
    return build_index(genomes, k), reads


def _packed(batch, lpad=64):
    n, length = batch.codes.shape
    codes = np.zeros((n, lpad), dtype=np.uint8)
    codes[:, :length] = batch.codes
    qual = np.zeros((n, lpad), dtype=np.uint8)
    qual[:, :length] = batch.qual
    return (pack_codes_2bit(codes), qual, np.asarray(batch.lengths, dtype=np.int32),
            np.ones(n, dtype=bool))


def _port_batch(reads) -> ReadBatch:
    """The port's ReadBatch of a JAX one."""
    return ReadBatch(ids=list(reads.ids), codes=reads.codes, qual=reads.qual,
                     lengths=reads.lengths)


def _assert_agg_equal(got, want):
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)


def _assert_matches_jax(got, want, r):
    """As tests/test_torch_parallel.py: per-record fields on the first r of
    JAX's padded R records, order keys re-encoded to R."""
    for name in ("n_unique", "n_ambiguous", "n_unmapped", "n_filtered_reads",
                 "n_filtered_kmers", "n_hr_kmers"):
        assert int(getattr(got, name)) == int(getattr(want, name)), name
    for name in ("unique_by_rec", "amb_by_rec"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name))[:r], err_msg=name)
    wk = np.asarray(want.first_key)
    fk = got.first_key.numpy().astype(np.int64)
    big = tpipe.BIG
    np.testing.assert_array_equal(
        np.where(fk < big, fk // (r + 2) * (wk.shape[0] + 2) + fk % (r + 2), big),
        wk[:r], err_msg="first_key")


def _port(index, arrays, data, table, params, gates, k=K):
    """(the port's DP x TP result on a data x table mesh of the CPU, its
    single-device result, R)."""
    ref = convert.reference(index, CPU)
    member = ref.set_member_device(CPU)
    tab = ref.device_probe_tables(CPU, "sort")
    one = tpipe.aggregate_batch(tpipe.align_batch(
        tab, member, *(torch.from_numpy(a) for a in arrays[:3]), *params, k=k,
        **gates), torch.from_numpy(arrays[3]))
    mesh = tts.make_mesh_2d([CPU] * (data * table), data=data, table=table)
    parts = tts.shard_sorted_table(sorted_table_host(ref.index), table)
    assert len(parts) == table
    tab_d = tts.device_put_sharded_table(mesh, parts)
    (members,) = tmesh.replicate(mesh, member)
    got = tts.align_aggregate_table_sharded(
        tab_d, members, *tmesh.shard_read_arrays(mesh, *arrays), *params, mesh=mesh,
        k=k, **gates)
    return got, one, member.shape[1]


def _jax(tab_p, jmember, reads, data, table, params, gates, k=K):
    mesh = jts.make_mesh_2d(jax.devices()[: data * table], data=data, table=table)
    tab_d = jts.device_put_sharded_table(mesh, tab_p)
    (member_d,) = jmesh.replicate(mesh, jmember)
    arrays = jmesh.shard_read_arrays(mesh, reads.codes, reads.qual, reads.lengths,
                                     np.ones(reads.codes.shape[0], bool))
    return jts.align_aggregate_table_sharded(
        tab_d, member_d, *arrays, *(jnp.int32(v) for v in params), mesh=mesh, k=k,
        **gates)


@pytest.mark.parametrize("data,table", MESHES)
def test_table_sharded_matches_jax_and_one_device(data, table):
    """MKQ and MG on: equal to JAX's DP x TP result and to one device."""
    index, reads = _setup()
    params = (1, 1, 0, 65, 2)
    gates = dict(has_mrq=False, has_mkq=True, has_mg=True)
    got, one, r = _port(index, _packed(reads), data, table, params, gates)
    _assert_agg_equal(got, one)
    jref = JaxKmerReference(K, _index=index)
    want = _jax(jts.pad_table_for_sharding(jax_sorted_table_host(index), table),
                jref.set_member_dense(), reads, data, table, params, gates)
    _assert_matches_jax(got, want, r)
    assert int(got.n_filtered_kmers) and int(got.n_unique)


def _downgrade_corpus():
    """tests/test_table_sharded.py's reads for MRQ filtering and the
    p-downgrade quirk: genome A's prefix + a segment B and C share."""
    rng = np.random.default_rng(99)
    bases = np.array(list("ACGT"))

    def mk(n):
        return "".join(rng.choice(bases, size=n))

    a = mk(200)
    shared = mk(120)
    b = mk(60) + shared + mk(40)
    c = shared + mk(100)
    genomes = [("gA", a), ("gB", b), ("gC", c)]
    reads = []
    for i in range(B):
        kind = i % 4
        if kind == 0:
            seq, qual = a[:20] + shared[:40], "I" * 60
        elif kind == 1:
            seq, qual = a[20:80], "#" * 60
        elif kind == 2:
            start = rng.integers(0, len(a) - L)
            seq, qual = a[start: start + L], "I" * 60
        else:
            seq, qual = mk(L), "I" * 60
        reads.append((f"r{i}", seq, qual))
    return genomes, reads


@pytest.mark.parametrize("data,table", [(4, 2), (2, 4)])
def test_table_sharded_mrq_and_downgrade(data, table):
    genomes, reads = _downgrade_corpus()
    jref = JaxKmerReference(K, [JaxSeqRecord([("description", d), ("genome", s)])
                                for d, s in genomes])
    batch = jax_pack_reads([
        JaxSeqRecord([("identifier", rid), ("sequence", s), ("space", ""),
                      ("quality_sequence", q)]) for rid, s, q in reads])
    params = (1, 1, 60, 0, 0)
    gates = dict(has_mrq=True, has_mkq=False, has_mg=False)
    got, one, r = _port(jref.index, _packed(batch), data, table, params, gates)
    _assert_agg_equal(got, one)
    want = _jax(jts.pad_table_for_sharding(jax_sorted_table_host(jref.index), table),
                jref.set_member_dense(), batch, data, table, params, gates)
    _assert_matches_jax(got, want, r)
    assert int(got.n_filtered_reads) and int(got.n_ambiguous) and int(got.n_unique)
    # the downgraded winner counts twice: ambiguous counts exceed the reads
    assert int(got.amb_by_rec.sum()) > int(got.n_ambiguous)


@pytest.mark.parametrize("data,table", [(4, 2), (2, 4)])
def test_table_sharded_multi_word_keys(data, table):
    """k = 35: the table's two 31-base key words, split at key boundaries;
    equal to JAX's words path and to one device."""
    k = 35
    index, reads = _setup(k)
    params = (1, 1, 0, 65, 3)
    gates = dict(has_mrq=False, has_mkq=True, has_mg=True)
    got, one, r = _port(index, _packed(reads), data, table, params, gates, k=k)
    _assert_agg_equal(got, one)
    jref = JaxKmerReference(k, _index=index)
    want = _jax(jts.pad_table_words_for_sharding(sorted_table_host_words(index), table),
                jref.set_member_dense(), reads, data, table, params, gates, k=k)
    _assert_matches_jax(got, want, r)
    assert int(got.n_unique)


@pytest.mark.parametrize("n_shards", [2, 3, 5])
def test_split_keeps_each_key_on_one_shard(n_shards):
    """A table whose keys repeat (a device-built table keeps one row per
    occurrence) and that holds dead rows (genome count 0): the split drops
    the dead rows, cuts only where the key changes, and aligns as the
    table of distinct keys does."""
    index, reads = _setup()
    ref = convert.reference(index, CPU)
    (words,), sid, gc = sorted_table_host(ref.index)
    rng = np.random.default_rng(n_shards)
    reps = rng.integers(1, 4, size=sid.size)
    gc_rep = np.repeat(gc, reps)
    gc_rep[rng.random(gc_rep.size) < 0.1] = 0   # dead rows among the repeats
    gc_rep[np.r_[0, np.cumsum(reps)[:-1]]] = gc  # each key keeps a live row
    table = ((np.repeat(words, reps),), np.repeat(sid, reps), gc_rep)
    parts = tts.shard_sorted_table(table, n_shards)
    assert len(parts) == n_shards
    joined = [torch.cat([p.words[0] for p in parts]), torch.cat([p.sid for p in parts]),
              torch.cat([p.gc for p in parts])]
    live = gc_rep > 0
    np.testing.assert_array_equal(joined[0].numpy(), table[0][0][live])
    np.testing.assert_array_equal(joined[2].numpy(), gc_rep[live])
    for a, b in zip(parts[:-1], parts[1:]):
        if a.sid.numel() and b.sid.numel():
            assert int(a.words[0][-1]) < int(b.words[0][0])
    sizes = [p.sid.numel() for p in parts]
    assert max(sizes) - min(sizes) <= 2 * 3  # near-equal: off by a key's rows

    arrays = _packed(reads)
    params = (1, 1, 0, 65, 2)
    gates = dict(has_mrq=False, has_mkq=True, has_mg=True)
    member = ref.set_member_device(CPU)
    one = tpipe.aggregate_batch(tpipe.align_batch(
        ref.device_probe_tables(CPU, "sort"), member,
        *(torch.from_numpy(a) for a in arrays[:3]), *params, k=K, **gates),
        torch.from_numpy(arrays[3]))
    mesh = tts.make_mesh_2d([CPU] * (2 * n_shards), data=2, table=n_shards)
    (members,) = tmesh.replicate(mesh, member)
    got = tts.align_aggregate_table_sharded(
        tts.device_put_sharded_table(mesh, parts), members,
        *tmesh.shard_read_arrays(mesh, *arrays), *params, mesh=mesh, k=K, **gates)
    _assert_agg_equal(got, one)


def test_split_of_an_empty_and_a_tiny_table():
    empty = SortedTableDev((torch.zeros(0, dtype=torch.int64),),
                           torch.zeros(0, dtype=torch.int32), torch.zeros(0, dtype=torch.int32))
    assert [p.sid.numel() for p in tts.shard_sorted_table(empty, 3)] == [0, 0, 0]
    one_key = SortedTableDev((torch.tensor([5, 5, 5]),), torch.tensor([1, 1, 1], dtype=torch.int32),
                             torch.tensor([2, 2, 2], dtype=torch.int32))
    assert [p.sid.numel() for p in tts.shard_sorted_table(one_key, 2)] == [3, 0]


def test_hash_table_rejected_under_table_sharding():
    """The bucket hash table cannot range-partition: the port raises the
    JAX package's TypeError at every entry point."""
    index, reads = _setup()
    ref = convert.reference(index, CPU)
    hash_tab = ref.device_probe_tables(CPU, "hash")
    mesh = tts.make_mesh_2d([CPU] * 2, data=1, table=2)
    for call in (lambda: tts.device_put_sharded_table(mesh, hash_tab),
                 lambda: tts.shard_sorted_table(hash_tab, 2),
                 lambda: tts.align_aggregate_table_sharded(
                     (hash_tab, hash_tab), None, *tmesh.shard_read_arrays(
                         mesh, *_packed(reads)), 1, 1, 0, 0, 0, mesh=mesh, k=K,
                     has_mrq=False, has_mkq=False, has_mg=False)):
        with pytest.raises(TypeError, match="sort-merge probe only"):
            call()
    jmesh2 = jts.make_mesh_2d(jax.devices()[:2], data=1, table=2)
    with pytest.raises(TypeError, match="sort-merge probe only"):
        jts.device_put_sharded_table(
            jmesh2, JaxKmerReference(K, _index=index).device_probe_tables("hash"))


def test_make_mesh_2d_shapes(monkeypatch):
    """One process, and process 3 of 4 in the two layouts a mesh takes
    across processes (the groups stubbed; tests/test_torch_distributed.py
    makes real ones): whole data rows a process, or a part of one row;
    any other layout raises ValueError naming the sizes."""
    mesh = tts.make_mesh_2d([CPU] * 8, table=2)
    assert mesh.shape == {"data": 4, "table": 2} and mesh.local_data == 4
    assert (mesh.local_table, mesh.first_shard, mesh.first_column) == (2, 0, 0)
    with pytest.raises(ValueError, match="needs 6 devices"):
        tts.make_mesh_2d([CPU] * 8, data=3, table=2)
    group = object()
    monkeypatch.setattr(tts, "world_size", lambda g: 4)
    monkeypatch.setattr(tts, "mesh_groups", lambda g, n, table: ("row", "col"))
    monkeypatch.setattr(tmesh.dist, "get_rank", lambda g: 3)
    # 4 devices a process, table 2: two whole rows, global rows 6 and 7
    mesh = tts.make_mesh_2d([CPU] * 4, table=2, group=group)
    assert mesh.shape == {"data": 8, "table": 2}
    assert (mesh.local_data, mesh.local_table, mesh.first_shard, mesh.first_column) == (
        2, 2, 6, 0)
    # 2 devices a process, table 4: columns 2 and 3 of global row 1
    mesh = tts.make_mesh_2d([CPU] * 2, table=4, group=group)
    assert mesh.shape == {"data": 2, "table": 4}
    assert (mesh.local_data, mesh.local_table, mesh.first_shard, mesh.first_column) == (
        1, 2, 1, 2)
    assert (mesh.row_group, mesh.col_group) == ("row", "col")
    assert tmesh.shard_read_arrays(mesh, np.arange(4))[0][1].tolist() == [2, 3]
    # 3 processes of 4 devices, table 6: a row would split a process
    monkeypatch.setattr(tts, "world_size", lambda g: 3)
    with pytest.raises(ValueError, match="table axis of 6 devices .* of 4 devices"):
        tts.make_mesh_2d([CPU] * 4, table=6, group=group)


def test_merge_over_a_missing_or_wrong_group_raises(monkeypatch):
    """A data or table axis that spans processes merges over its own group
    only: a mesh without it, or with a group of another size, raises."""
    index, reads = _setup()
    ref = convert.reference(index, CPU)
    member = ref.set_member_device(CPU)
    monkeypatch.setattr(tmesh.dist, "get_rank", lambda g: 0)
    group = object()
    args = (1, 1, 0, 0, 0)
    flags = dict(k=K, has_mrq=False, has_mkq=False, has_mg=False)
    # a 1 x 2 mesh whose row spans 2 processes of one device, no row group
    mesh = tmesh.Mesh((CPU,), {"data": 1, "table": 2}, group)
    parts = tts.shard_sorted_table(ref.sort_columns(), 2)
    with pytest.raises(ValueError, match="table axis spans 2 processes, but its group "
                                         "is missing"):
        tts.align_aggregate_table_sharded(
            (parts[0],), (member,), *tmesh.shard_read_arrays(mesh, *_packed(reads)),
            *args, mesh=mesh, **flags)
    # a 2-row data mesh over 2 processes whose data group has 3
    monkeypatch.setattr(tmesh, "world_size", lambda g: 3)
    mesh = tmesh.Mesh((CPU,), {"data": 2}, group, None, group)
    with pytest.raises(ValueError, match="data axis spans 2 processes, but its group is 3"):
        tmesh.align_aggregate_sharded(
            (ref.device_probe_tables(CPU, "sort"),), (member,),
            *tmesh.shard_read_arrays(mesh, *_packed(reads)), *args, mesh=mesh, **flags)


@pytest.mark.parametrize("data,table", [(2, 2), (4, 2), (1, 4)])
def test_align_packed_reads_on_a_2d_mesh(data, table, monkeypatch):
    """The library route: align_packed_reads over a (data, table) mesh
    splits the reference's sort table and equals one device, with an
    uneven last batch; on the hash route it runs data parallel with the
    table replicated, as the JAX package runs every mesh, and equals one
    device too."""
    index, reads = _setup()
    ref = convert.reference(index, CPU)
    batch = _port_batch(reads)
    gates = LIBRARY_GATES
    one = PseudoAlignment(ref, CPU)
    one.align_packed_reads(batch, 1, 1, *gates, batch_size=24)
    mesh = tts.make_mesh_2d([CPU] * (data * table), data=data, table=table)
    sharded = PseudoAlignment(ref, CPU)
    sharded.align_packed_reads(batch, 1, 1, *gates, batch_size=24, mesh=mesh,
                               store_reads=False)
    assert sharded.get_summary() == one.get_summary()
    stats = one.get_summary()["Statistics"]
    assert stats["unique_mapped_reads"] and stats["filtered_quality_reads"]
    assert stats["filtered_quality_kmers"] and stats["filtered_hr_kmers"]
    monkeypatch.setenv("SHOTGUN_TPU_PROBE", "hash")
    hashed = PseudoAlignment(ref, CPU)
    hashed.align_packed_reads(batch, 1, 1, *gates, batch_size=24, mesh=mesh,
                              store_reads=False)
    assert hashed.mesh_probe_tables(mesh)[0] is tmesh.align_aggregate_sharded
    assert hashed.get_summary() == one.get_summary()


@pytest.mark.parametrize("probe", ["auto", "hash", "hash16"])
def test_2d_mesh_above_the_auto_crossover_matches_jax(probe, monkeypatch):
    """With AUTO_HASH_MIN_KEYS below the corpus's distinct k-mers on both
    packages, so that auto picks the 16-slot table for one device,
    align_packed_reads on a 2 x 2 mesh prints the JAX package's summary on
    a JAX 2 x 2 mesh: on auto through the split sort table (no hash table
    is made, the whole table placed on no device), on an explicit hash or
    hash16 data parallel with that table replicated."""
    index, reads = _setup()
    for cls in (JaxKmerReference, KmerReference):
        monkeypatch.setattr(cls, "AUTO_HASH_MIN_KEYS", 100)
    if probe == "auto":
        monkeypatch.delenv("SHOTGUN_TPU_PROBE", raising=False)
    else:
        monkeypatch.setenv("SHOTGUN_TPU_PROBE", probe)
    batch = _port_batch(reads)
    gates = LIBRARY_GATES
    jaln = JaxPseudoAlignment(JaxKmerReference(K, _index=index))
    jaln.align_packed_reads(reads, 1, 1, *gates, batch_size=24, store_reads=False,
                            mesh=jts.make_mesh_2d(jax.devices()[:4], data=2, table=2))
    ref = convert.reference(index, CPU)
    assert ref.probe_method("auto") == "hash16"
    if probe == "auto":
        monkeypatch.setattr(ref, "device_probe_tables", None)
    aln = PseudoAlignment(ref, CPU)
    aln.align_packed_reads(batch, 1, 1, *gates, batch_size=24, store_reads=False,
                           mesh=tts.make_mesh_2d([CPU] * 4, data=2, table=2))
    assert aln.get_summary() == jaln.get_summary()
    # the hash table, made only on an explicit hash route, is assembled on
    # the device (the host builder's cache stays empty)
    assert any(m != "sort" for m, _ in ref._device_tables) == (probe != "auto")
    assert not ref._probe_tables


@pytest.mark.parametrize("data,table", [(2, 2), (1, 4), (2, 3)])
def test_table_axis_places_key_ranges_only(data, table, monkeypatch):
    """A host-built reference on a (data, table) mesh: device_probe_tables
    is never called, each device holds its column's key range cut from the
    host columns, the ranges' rows sum to the table's, and two runs on one
    alignment place them once; a device-built reference's ranges are the
    same rows, sliced where they were built."""
    index, reads = _setup()
    ref = convert.reference(index, CPU)
    monkeypatch.setattr(ref, "device_probe_tables", None)
    cuts = []
    monkeypatch.setattr(aligner, "shard_sorted_table",
                        lambda cols, n: cuts.append(n) or tts.shard_sorted_table(cols, n))
    batch = _port_batch(reads)
    mesh = tts.make_mesh_2d([CPU] * (data * table), data=data, table=table)
    aln = PseudoAlignment(ref, CPU)
    for _ in range(2):
        aln.align_packed_reads(batch, 1, 1, *LIBRARY_GATES, batch_size=24, mesh=mesh,
                               store_reads=False)
    assert cuts == [table]
    step, tabs = aln.mesh_probe_tables(mesh)
    assert step is tts.align_aggregate_table_sharded and len(tabs) == data * table
    rows = [t.sid.numel() for t in tabs]
    assert rows[:table] * data == rows and sum(rows[:table]) == index.num_kmers
    assert max(rows) < index.num_kmers
    (words,), _, _ = sorted_table_host(ref.index)
    np.testing.assert_array_equal(torch.cat([t.words[0] for t in tabs[:table]]).numpy(),
                                  words)
    monkeypatch.undo()
    one = PseudoAlignment(ref, CPU)
    one.align_packed_reads(batch, 1, 1, *LIBRARY_GATES, batch_size=24)
    assert aln._n_unique == 2 * one._n_unique > 0
    # the device build numbers its sets otherwise: compare their members
    built = KmerReference.from_device_build(convert.genome_arrays(_genomes()), K, CPU)
    for got, want in zip(tts.shard_sorted_table(built.sort_columns(), table),
                         tts.shard_sorted_table(ref.sort_columns(), table)):
        assert torch.equal(got.words[0], want.words[0]) and torch.equal(got.gc, want.gc)
        np.testing.assert_array_equal(built.set_member_dense()[got.sid.numpy()],
                                      ref.set_member_dense()[want.sid.numpy()])
