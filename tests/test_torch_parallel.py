"""The port's data-parallel mesh (shotgun_tpu_torch.parallel.mesh) and its
process helpers (parallel.distributed) against the JAX package's
parallel/mesh.py, on the 8 virtual CPU devices of tests/conftest.py, and
against the port's own single-device path.  The port's mesh repeats the
CPU.  Every field is an integer and is compared exactly (tolerance 0)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shotgun_tpu.aligner import PseudoAlignment as JaxPseudoAlignment
from shotgun_tpu.io.packing import pack_reads as jax_pack_reads
from shotgun_tpu.io.records import FASTAParser, FASTQParser
from shotgun_tpu.parallel import mesh as jmesh
from shotgun_tpu.reference import KmerReference as JaxKmerReference
from shotgun_tpu_torch import convert
from shotgun_tpu_torch.aligner import PseudoAlignment
from shotgun_tpu_torch.io.packing import ReadBatch
from shotgun_tpu_torch.io.records import SeqRecord
from shotgun_tpu_torch.models import pipeline as tpipe
from shotgun_tpu_torch.ops.encode import pack_codes_2bit
from shotgun_tpu_torch.parallel import distributed
from shotgun_tpu_torch.parallel import mesh as tmesh
from shotgun_tpu_torch.reference import KmerReference

torch.set_num_threads(2)
CPU = torch.device("cpu")
QUALITY_CHARS = (
    r"`1234567890-=qwertyuiop[]\asdfghjkl;'zxcvbnm,./"
    r'~!@#$%^&*()_+QWERTYUIOP{}|ASDFGHJKL:"ZXCVBNM<>?'
)
#: m, p, mrq, mkq, mg with every gate on, and their flags
PARAMS = (1, 1, 70, 75, 2)
GATES = dict(has_mrq=True, has_mkq=True, has_mg=True)


def _setup(seed=0, n_reads=64, read_len=40, k=11):
    """tests/test_parallel.py's corpus: 4 genomes, two of them sharing 60
    bases, and reads (70% sampled, the rest random) with random quality
    characters; the JAX reference and read batch."""
    rng = random.Random(seed)
    shared = "".join(rng.choice("ACGT") for _ in range(120))
    fasta = ""
    genomes = []
    for gi in range(4):
        seq = (shared[:60] if gi % 2 else "") + "".join(
            rng.choice("ACGT") for _ in range(120))
        genomes.append(seq)
        fasta += f">g{gi}\n{seq}\n"
    fastq_lines = []
    for ri in range(n_reads):
        if rng.random() < 0.7:
            src = genomes[rng.randrange(4)]
            s = rng.randrange(0, len(src) - read_len)
            seq = src[s: s + read_len]
        else:
            seq = "".join(rng.choice("ACGT") for _ in range(read_len))
        qual = "".join(rng.choice(QUALITY_CHARS) for _ in range(read_len))
        fastq_lines += [f"@r{ri}", seq, "+", qual]
    fp = FASTAParser()
    fp.parse_records(fasta)
    qp = FASTQParser()
    qp.parse_records("\n".join(fastq_lines) + "\n")
    return JaxKmerReference(k, list(fp)), jax_pack_reads(list(qp))


def _port_batch(batch) -> ReadBatch:
    return ReadBatch(ids=list(batch.ids), codes=np.asarray(batch.codes),
                     qual=np.asarray(batch.qual), lengths=np.asarray(batch.lengths))


def _packed(batch, lpad=64):
    """(2-bit packed codes, quality, lengths, row_valid) of the batch, its
    rows padded to ``lpad``."""
    n, length = batch.codes.shape
    codes = np.zeros((n, lpad), dtype=np.uint8)
    codes[:, :length] = batch.codes
    qual = np.zeros((n, lpad), dtype=np.uint8)
    qual[:, :length] = batch.qual
    return (pack_codes_2bit(codes), qual, np.asarray(batch.lengths, dtype=np.int32),
            np.ones(n, dtype=bool))


def _assert_agg_equal(got, want):
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)


def _assert_matches_jax(got, want, r):
    """The port's AggResult (r records) against the JAX package's, whose
    record axis is padded to R: the per-record fields on the first r
    records (the rest empty), the order keys row * (r + 2) + rank
    re-encoded to R."""
    for name in tmesh._COUNTERS:
        assert int(getattr(got, name)) == int(getattr(want, name)), name
    for name in ("unique_by_rec", "amb_by_rec"):
        w = np.asarray(getattr(want, name))
        np.testing.assert_array_equal(getattr(got, name).numpy(), w[:r], err_msg=name)
        assert not w[r:].any()
    wk = np.asarray(want.first_key)
    big = tpipe.BIG
    fk = got.first_key.numpy().astype(np.int64)
    lifted = np.where(fk < big, fk // (r + 2) * (wk.shape[0] + 2) + fk % (r + 2), big)
    np.testing.assert_array_equal(lifted, wk[:r], err_msg="first_key")
    assert (wk[r:] == big).all()


@pytest.mark.parametrize("method", ["sort", "hash", "hash16"])
@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_shard_count_invariance_matches_jax(n_shards, method):
    """align_aggregate_sharded over n shards of one batch (every gate on)
    equals the port's single-device aggregate_batch and the JAX package's
    align_aggregate_sharded over n virtual devices."""
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    jref, batch = _setup()
    k = jref.index.k
    arrays = _packed(batch)
    ref = convert.reference(jref.index, CPU)
    tab = ref.device_probe_tables(CPU, method)
    member = ref.set_member_device(CPU)
    r = member.shape[1]

    one = tpipe.aggregate_batch(tpipe.align_batch(
        tab, member, *(torch.from_numpy(a) for a in arrays[:3]), *PARAMS, k=k,
        **GATES), torch.from_numpy(arrays[3]))
    mesh = tmesh.make_mesh([CPU] * n_shards)
    tabs, members = tmesh.replicate(mesh, tab, member)
    got = tmesh.align_aggregate_sharded(tabs, members, *tmesh.shard_read_arrays(mesh, *arrays),
                                        *PARAMS, mesh=mesh, k=k, **GATES)
    _assert_agg_equal(got, one)

    jm = jmesh.make_mesh(jax.devices()[:n_shards])
    jtab = jax.tree.map(lambda a: jax.device_put(a, jax.sharding.NamedSharding(
        jm, jax.sharding.PartitionSpec())), jref.device_probe_tables(method))
    (jmember,) = jmesh.replicate(jm, jref.set_member_dense())
    want = jmesh.align_aggregate_sharded(
        jtab, jmember, *jmesh.shard_read_arrays(jm, *arrays),
        *(jnp.int32(v) for v in PARAMS), mesh=jm, k=k, packed=True, **GATES)
    _assert_matches_jax(got, want, r)
    assert int(got.n_unique) and int(got.n_ambiguous) and int(got.n_filtered_reads)


@pytest.mark.parametrize("n_reads,batch_size,gates,n_batches", [
    (48, 48, (None, None, None), 1),
    # 100 reads in batches of 24 (20 rounded up to 8 shards): the last
    # batch uneven, its shards partly padding
    (100, 20, (70, 75, 2), 5),
])
def test_sharded_summary_matches_jax_and_one_device(n_reads, batch_size, gates,
                                                    n_batches):
    """PseudoAlignment.align_packed_reads over an 8-shard mesh: the JAX
    package's 8-way mesh, and one device, give the same summary."""
    jref, batch = _setup(seed=3, n_reads=n_reads)
    jsharded = JaxPseudoAlignment(jref)
    jsharded.align_packed_reads(batch, 1, 1, *gates, batch_size=batch_size,
                                mesh=jmesh.make_mesh(jax.devices()[:8]),
                                store_reads=False)
    ref = convert.reference(jref.index, CPU)
    pbatch = _port_batch(batch)
    one = PseudoAlignment(ref, CPU)
    one.align_packed_reads(pbatch, 1, 1, *gates, batch_size=batch_size)
    sharded = PseudoAlignment(ref, CPU)
    sharded.align_packed_reads(pbatch, 1, 1, *gates, batch_size=batch_size,
                               mesh=tmesh.make_mesh([CPU] * 8), store_reads=False)
    assert sharded.get_summary() == one.get_summary() == jsharded.get_summary()
    assert sharded._batch_no == jsharded._batch_no == n_batches


def test_mesh_at_k_below_1_maps_no_read():
    """k < 1 over a mesh: every read unmapped (MRQ-filtered reads apart),
    as on one device."""
    _, batch = _setup(seed=4, n_reads=40)
    ref = KmerReference(0, [SeqRecord([("description", "g"), ("genome", "ACGTTGCA" * 8)])],
                        device=CPU)
    pbatch = _port_batch(batch)
    runs = []
    for mesh in (None, tmesh.make_mesh([CPU] * 4)):
        aln = PseudoAlignment(ref, CPU)
        aln.align_packed_reads(pbatch, 1, 1, 70, None, None, batch_size=16,
                               mesh=mesh, store_reads=False)
        runs.append(aln.get_summary())
    assert runs[0] == runs[1]
    stats = runs[0]["Statistics"]
    assert stats["unique_mapped_reads"] == stats["ambiguous_mapped_reads"] == 0
    assert stats["unmapped_reads"] + stats["filtered_quality_reads"] == 40


def test_mesh_requires_store_reads_false():
    jref, batch = _setup(n_reads=16)
    msgs = []
    for aln, mesh, b in (
            (JaxPseudoAlignment(jref), jmesh.make_mesh(jax.devices()[:2]), batch),
            (PseudoAlignment(convert.reference(jref.index, CPU), CPU),
             tmesh.make_mesh([CPU] * 2), _port_batch(batch))):
        with pytest.raises(ValueError) as exc:
            aln.align_packed_reads(b, mesh=mesh, store_reads=True)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] == "mesh-sharded alignment requires store_reads=False"


def test_replicate_keeps_a_tensor_where_it_is():
    """A device that holds the value gets that same tensor (no copy), for
    a tensor and for every tensor of a probe table."""
    jref, _ = _setup(n_reads=4)
    ref = convert.reference(jref.index, CPU)
    mesh = tmesh.make_mesh([CPU] * 4)
    member = ref.set_member_device(CPU)
    tab = ref.device_probe_tables(CPU, "hash16")
    reps, tabs = tmesh.replicate(mesh, member, tab)
    assert len(reps) == len(tabs) == 4
    assert all(x is member and x.data_ptr() == member.data_ptr() for x in reps)
    for t in tabs:
        assert type(t) is type(tab)
        assert all(a.data_ptr() == b.data_ptr() for a, b in zip(t, tab))


def test_shard_read_arrays_gives_each_device_its_rows():
    mesh = tmesh.make_mesh([CPU] * 4)
    arr = np.arange(24, dtype=np.int32).reshape(12, 2)
    codes, none = tmesh.shard_read_arrays(mesh, arr, None)
    assert none == (None,) * 4
    np.testing.assert_array_equal(torch.cat(codes).numpy(), arr)
    assert [c.shape[0] for c in codes] == [3] * 4
    with pytest.raises(ValueError, match="do not split into 4"):
        tmesh.shard_read_arrays(mesh, arr[:10])


def test_merge_lifts_order_keys_to_global_rows():
    """A key of shard s, local row i, rank j becomes (s * rows + i) * (r + 2)
    + j; BIG stays BIG; counters add up."""
    mesh = tmesh.make_mesh([CPU] * 3)
    r, rows = 2, 5
    big = tpipe.BIG

    def agg(n, fk):
        z = torch.tensor(n, dtype=torch.int32)
        return tpipe.AggResult(z, z, z, z, z, z, torch.ones(r, dtype=torch.int32),
                               torch.zeros(r, dtype=torch.int32),
                               torch.tensor(fk, dtype=torch.int32))

    got = tmesh.merge_data_shards(
        mesh, [agg(1, [big, big]), agg(2, [3 * 4 + 1, big]), agg(4, [0, 2 * 4])], rows, r)
    assert int(got.n_unique) == 7 and got.unique_by_rec.tolist() == [3, 3]
    assert got.first_key.tolist() == [(5 + 3) * 4 + 1, (10 + 2) * 4]


def test_local_read_slice_covers_input_exactly(monkeypatch):
    """Per-process contiguous slices partition any read count, uneven
    tails included (tests/test_distributed.py's cases)."""
    dist = distributed.dist
    for nproc in (1, 2, 3, 4):
        for total in (0, 1, 7, 8, 9, 100):
            covered = []
            for pid in range(nproc):
                monkeypatch.setattr(dist, "is_initialized", lambda: True)
                monkeypatch.setattr(dist, "get_world_size", lambda n=nproc: n)
                monkeypatch.setattr(dist, "get_rank", lambda p=pid: p)
                covered.extend(range(*distributed.local_read_slice(total).indices(total)))
            assert covered == list(range(total)), (nproc, total)
    monkeypatch.undo()
    assert distributed.local_read_slice(9) == slice(0, 9)


def test_initialize_from_env(monkeypatch):
    """Neither variable: None; SHOTGUN_TPU_MESH=data: one process's mesh
    over the local devices (the CPU when it is asked for); NPROCS=1: one
    process, no group."""
    for name in ("SHOTGUN_TPU_NPROCS", "SHOTGUN_TPU_PROC_ID", "SHOTGUN_TPU_MESH"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("SHOTGUN_TPU_TORCH_DEVICE", "cpu")
    assert distributed.initialize_from_env() is None
    monkeypatch.setenv("SHOTGUN_TPU_NPROCS", "1")
    assert distributed.initialize_from_env() is None
    monkeypatch.setenv("SHOTGUN_TPU_MESH", "data")
    mesh = distributed.initialize_from_env()
    assert mesh == tmesh.Mesh((CPU,), {"data": 1}, None)
    assert distributed.is_primary() and not distributed.dist.is_initialized()
    distributed.shutdown()  # no group: nothing to leave


def test_backend_rule():
    """nccl only when each process has a card of its own; gloo on the CPU
    and for processes sharing a card."""
    n = torch.cuda.device_count()
    assert distributed.backend_for(2, CPU) == "gloo"
    assert distributed.backend_for(n + 1, torch.device("cuda", 0)) == "gloo"
    assert distributed.rank_device(3, "cpu") == CPU
