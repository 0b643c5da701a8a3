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
// / min with positions 0x7FFF0000 + i.  Misses give -1 / 0 / -1.
//
// Table layout (index/hashtable.py): uint32 [n_buckets, slots, 4] rows of
// (key_lo, key_hi, set_id, genome_count), n_buckets a power of two, bucket
// index mix32(lo, hi) & (n_buckets - 1).
//
// Bound: the latency of one random bucket-row read (slots x 16 B, 256 B
// for the 16-slot layout) from a table of several GB, far past the 50 MB
// L2.  Design: one thread per window computes its bucket on native uint32,
// reads the row as independent 16-byte loads (unrolled for 4 and 16 slots
// so they are in flight together) and compares the stash, staged once per
// block in shared memory.  Later work: a warp-cooperative row read or
// cp.async prefetch to keep more rows in flight per SM.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kEmpty = 0xFFFFFFFFu;
constexpr uint32_t kStashBase = 0x7FFF0000u;
constexpr int kMaxStash = 64;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t mix32(uint32_t lo, uint32_t hi) {
  uint32_t h = (lo ^ 0x9E3779B9u) * 0x85EBCA6Bu;
  h ^= h >> 15;
  h = (h ^ (hi * 0xC2B2AE35u)) * 0x27D4EB2Fu;
  h ^= h >> 13;
  h *= 0x85EBCA6Bu;
  h ^= h >> 16;
  return h;
}

// kSlots: the table's slot count (4 or 16), fixed at compile time so the
// row's loads unroll.
template <int kSlots>
__global__ void hash_probe_kernel(const int64_t* __restrict__ keys,
                                  const uint4* __restrict__ table,
                                  uint32_t bucket_mask,
                                  const uint4* __restrict__ stash,
                                  int stash_n, int32_t* __restrict__ sid_out,
                                  int32_t* __restrict__ gc_out,
                                  int32_t* __restrict__ pos_out, int64_t n) {
  __shared__ uint4 s_stash[kMaxStash];
  for (int i = threadIdx.x; i < stash_n; i += blockDim.x) s_stash[i] = stash[i];
  __syncthreads();

  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const uint64_t key = static_cast<uint64_t>(keys[t]);
  const uint32_t lo = static_cast<uint32_t>(key);
  const uint32_t hi = static_cast<uint32_t>(key >> 32);
  const uint32_t bucket = mix32(lo, hi) & bucket_mask;
  const uint4* row = table + static_cast<int64_t>(bucket) * kSlots;

  uint32_t sid = kEmpty, gc = 0, pos = kEmpty;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const uint4 e = __ldg(row + s);  // (key_lo, key_hi, set_id, genome_count)
    if (e.x == lo && e.y == hi && e.z != kEmpty) {
      sid = min(sid, e.z);
      gc = max(gc, e.w);
      pos = min(pos, bucket * static_cast<uint32_t>(kSlots) + static_cast<uint32_t>(s));
    }
  }
  for (int i = 0; i < stash_n; ++i) {
    const uint4 e = s_stash[i];
    if (e.x == lo && e.y == hi) {
      sid = min(sid, e.z);
      gc = max(gc, e.w);
      pos = min(pos, kStashBase + static_cast<uint32_t>(i));
    }
  }
  const bool hit = sid != kEmpty;
  sid_out[t] = hit ? static_cast<int32_t>(sid) : -1;
  gc_out[t] = static_cast<int32_t>(gc);
  pos_out[t] = hit ? static_cast<int32_t>(pos) : -1;
}

}  // namespace

// keys: int64 [n]; table: uint32 [n_buckets, slots, 4] with slots 4 or 16;
// stash: uint32 [stash_n, 4] (stash_n <= 64, may be null when 0); outputs
// int32 [n].  Launches on `stream`; returns cudaGetLastError() after the
// launch, cudaErrorInvalidValue for another slot count.
extern "C" int stt_hash_probe(const void* keys, const void* table,
                              int64_t n_buckets, int slots, const void* stash,
                              int stash_n, void* sid, void* gc, void* pos,
                              int64_t n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  if (stash_n < 0 || stash_n > kMaxStash || (slots != 4 && slots != 16))
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
