// H2 hash_probe: single-gather bucket-hash probe, one int64 k-mer key per
// window -> (set_id, genome_count, slot_pos).
//
// Replaces the TPU kernel shotgun_tpu/ops/pallas/kernels.py
//   K3 resolve_rows_pallas (:162, body _resolve_kernel :129)
// together with the bucket-row gather that feeds it
// (shotgun_tpu/ops/probe.py:66-67 and :163-167) and the stash merge of
// shotgun_tpu/ops/probe.py resolve_rows (:111-136).
//
// Semantics follow the XLA reduction of shotgun_tpu/ops/probe.py:100-143,
// not the Pallas kernel (which keeps the last matching slot): over the
// slots whose (key_lo, key_hi) equal the window's and whose set id is not
// EMPTY take the minimum set id, the maximum genome count and the minimum
// flat slot position bucket*slots+s; merge the stash matches by min / max
// / min with positions 0x7FFF0000 + i.  Misses give -1 / 0 / -1.  Flat
// positions stay below the stash range because the entry point refuses a
// table of more than 0x7FFF0000 slots.
//
// Table layout (index/hashtable.py): uint32 [n_buckets, slots, 4] rows of
// (key_lo, key_hi, set_id, genome_count), n_buckets a power of two, bucket
// index mix32(lo, hi) & (n_buckets - 1).
//
// Bound: the bytes of random bucket rows read from device memory (slots x
// 16 B: 256 B for the 16-slot layout, 64 B for the 4-slot one) out of a
// table of one to several GB, far past the 50 MB L2; the keys in and the
// three outputs are a tenth of it.  A gather of rows is bound by DRAM and
// its latency, so the kernel must keep many rows in flight and spend one
// memory request per row line, not one per 16 B.
//
// Design: a warp takes 32 consecutive probes; lane i loads key i (one
// coalesced 256 B load) and computes its bucket.  A group of kSlots lanes
// reads one row together, lane l of the group slot l as one 16 B load, so
// one warp-wide load reads two whole 256 B rows (or eight 64 B rows): two
// requests a probe's row, where a thread a probe would make one a slot.
// In iteration j the group of lanes [g, g + kSlots) reads the row of probe
// g + j, whose key and bucket come by __shfl_sync from lane g + j; kDepth
// iterations' loads are issued before any is compared, so that many rows
// per warp are in flight.  One __ballot_sync of the slot matches gives
// each group its matching slots (a redux.sync over each group would run
// the groups of a warp one after another); lane g + j, which owns the
// probe, takes the lowest as the position and the set id and genome count
// of each match by shuffle from its lane (one round for a row that holds
// the key once; a row built by hand may hold it twice, so the rounds go
// on, warp by warp, while any group has a match left: min set id, max
// count).  Each lane then compares its own key against the stash, staged
// once per block in shared memory (every lane reads the same entry, a
// broadcast), four key_lo words at a time before any full compare.  Lane
// i stores probe i's three int32s, one coalesced 128 B store per output
// and warp.  A block of 8 warps takes 256 probes.  Every lane of a warp
// runs the loops to the end (lanes past n only mask), so the full-mask
// shuffles and votes are legal.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kEmpty = 0xFFFFFFFFu;
constexpr uint32_t kStashBase = 0x7FFF0000u;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxStash = 64;
constexpr int kThreads = 256;
// iterations whose row loads are in flight together (at most the slots)
constexpr int kMaxDepth = 4;

__device__ __forceinline__ uint32_t mix32(uint32_t lo, uint32_t hi) {
  uint32_t h = (lo ^ 0x9E3779B9u) * 0x85EBCA6Bu;
  h ^= h >> 15;
  h = (h ^ (hi * 0xC2B2AE35u)) * 0x27D4EB2Fu;
  h ^= h >> 13;
  h *= 0x85EBCA6Bu;
  h ^= h >> 16;
  return h;
}

// kSlots: the table's slot count (4 or 16), also the lane-group width.
template <int kSlots>
__global__ void __launch_bounds__(kThreads)
    hash_probe_kernel(const int64_t* __restrict__ keys,
                      const uint4* __restrict__ table, uint32_t bucket_mask,
                      const uint4* __restrict__ stash, int stash_n,
                      int32_t* __restrict__ sid_out,
                      int32_t* __restrict__ gc_out,
                      int32_t* __restrict__ pos_out, int64_t n) {
  constexpr int kDepth = kMaxDepth < kSlots ? kMaxDepth : kSlots;
  static_assert(kSlots % kDepth == 0, "the depth must divide the slot count");
  constexpr unsigned kGroupBits = (1u << kSlots) - 1u;
  __shared__ uint4 s_stash[kMaxStash];
  __shared__ __align__(16) uint32_t s_lo[kMaxStash];  // each entry's key_lo
  if (stash_n > 0) {  // uniform over the block; stash_n <= kMaxStash < kThreads
    const int i = threadIdx.x;
    if (i < stash_n) {
      const uint4 e = stash[i];
      s_stash[i] = e;
      s_lo[i] = e.x;
    }
    __syncthreads();
  }
  // the warp's first probe: uniform over the warp, so whole warps leave
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads + (threadIdx.x & ~31);
  if (base >= n) return;
  const int lane = threadIdx.x & 31;
  const int group = lane & ~(kSlots - 1);  // the group's first lane
  const int slot = lane & (kSlots - 1);
  const int live = n - base < 32 ? static_cast<int>(n - base) : 32;
  const uint64_t key = lane < live ? static_cast<uint64_t>(__ldg(
      reinterpret_cast<const long long*>(keys) + base + lane)) : 0;
  const uint32_t lo = static_cast<uint32_t>(key);
  const uint32_t hi = static_cast<uint32_t>(key >> 32);
  const uint32_t bucket = mix32(lo, hi) & bucket_mask;

  uint32_t sid = kEmpty, gc = 0, pos = kEmpty;
#pragma unroll
  for (int j0 = 0; j0 < kSlots; j0 += kDepth) {
    uint4 e[kDepth];
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const int src = group | (j0 + d);
      const uint32_t b = __shfl_sync(kFull, bucket, src);
      e[d] = make_uint4(0u, 0u, kEmpty, 0u);
      if (src < live) e[d] = __ldg(table + static_cast<size_t>(b) * kSlots + slot);
    }
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const int src = group | (j0 + d);
      const uint32_t plo = __shfl_sync(kFull, lo, src);
      const uint32_t phi = __shfl_sync(kFull, hi, src);
      const bool m = e[d].x == plo && e[d].y == phi && e[d].z != kEmpty;
      // the group's matching slots, lowest first
      uint32_t bits = (__ballot_sync(kFull, m) >> group) & kGroupBits;
      const bool owner = slot == j0 + d;  // this lane owns probe src
      // bucket * kSlots + slot < 0x7FFF0000: the entry point's check
      if (owner && bits) pos = bucket * static_cast<uint32_t>(kSlots) + (__ffs(bits) - 1);
      while (__any_sync(kFull, bits != 0)) {
        const int from = group | (bits ? __ffs(bits) - 1 : 0);
        const uint32_t z = __shfl_sync(kFull, e[d].z, from);
        const uint32_t w = __shfl_sync(kFull, e[d].w, from);
        if (owner && bits) {
          sid = min(sid, z);
          gc = max(gc, w);
        }
        bits &= bits - 1;
      }
    }
  }
  for (int i = 0; i < stash_n; i += 4) {
    // words past stash_n may match here; the full compare stops at it
    const uint4 l4 = *reinterpret_cast<const uint4*>(s_lo + i);
    if (l4.x == lo || l4.y == lo || l4.z == lo || l4.w == lo) {
      const int end = i + 4 < stash_n ? i + 4 : stash_n;
      for (int q = i; q < end; ++q) {
        const uint4 e = s_stash[q];
        if (e.x == lo && e.y == hi) {
          sid = min(sid, e.z);
          gc = max(gc, e.w);
          pos = min(pos, kStashBase + static_cast<uint32_t>(q));
        }
      }
    }
  }
  if (lane < live) {
    const bool hit = sid != kEmpty;
    sid_out[base + lane] = hit ? static_cast<int32_t>(sid) : -1;
    gc_out[base + lane] = static_cast<int32_t>(gc);
    pos_out[base + lane] = hit ? static_cast<int32_t>(pos) : -1;
  }
}

}  // namespace

// keys: int64 [n]; table: uint32 [n_buckets, slots, 4] with slots 4 or 16
// and n_buckets * slots <= 0x7FFF0000 (so that slot positions stay below
// the stash's); stash: uint32 [stash_n, 4] (stash_n <= 64, may be null when
// 0); outputs int32 [n].  Launches on `stream`; returns cudaGetLastError()
// after the launch, cudaErrorInvalidValue for an input it does not take.
extern "C" int stt_hash_probe(const void* keys, const void* table,
                              int64_t n_buckets, int slots, const void* stash,
                              int stash_n, void* sid, void* gc, void* pos,
                              int64_t n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  if (stash_n < 0 || stash_n > kMaxStash || (slots != 4 && slots != 16) ||
      n_buckets < 1 || n_buckets > static_cast<int64_t>(kStashBase) / slots)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const uint32_t mask = static_cast<uint32_t>(n_buckets - 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* k = static_cast<const int64_t*>(keys);
  auto* tb = static_cast<const uint4*>(table);
  auto* sh = static_cast<const uint4*>(stash);
  auto* o0 = static_cast<int32_t*>(sid);
  auto* o1 = static_cast<int32_t*>(gc);
  auto* o2 = static_cast<int32_t*>(pos);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (slots == 16) {
    hash_probe_kernel<16><<<grid, kThreads, 0, st>>>(k, tb, mask, sh, stash_n, o0, o1, o2, n);
  } else {
    hash_probe_kernel<4><<<grid, kThreads, 0, st>>>(k, tb, mask, sh, stash_n, o0, o1, o2, n);
  }
  return static_cast<int>(cudaGetLastError());
}
