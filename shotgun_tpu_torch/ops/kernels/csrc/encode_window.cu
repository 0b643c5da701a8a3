// H1 encode_window: fused 2-bit unpack + k-mer encode + window quality
// sums, one int64 key (and one int32 quality sum) per window.
//
// Replaces the TPU kernels in shotgun_tpu/ops/pallas/kernels.py
//   K1 rolling_encode_pallas (:74, body _encode_kernel :63)
//   K2 window_qsums_pallas   (:107, body _qsum_kernel :100)
// and the unpack in front of them (shotgun_tpu/ops/encode.py:104
// unpack_codes_2bit): the codes arrive 2-bit packed, 4 bases per byte,
// base i of a row in bits 2*(i%4) of byte i/4.
//
// For row b and window w < W = L - k + 1 (L = 4 * packed row bytes):
//   keys[b, w]  = sum_{j<k} code(b, w+j) << 2*(k-1-j)   (int64, < 2^62)
//   qsums[b, w] = sum_{j<k} qual[b, w+j]                (int32)
// i.e. hi << 32 | lo of the TPU kernel's (lo, hi) pair.  Pad positions
// hold code 0 and quality 0, so windows that reach into the padding get
// the same values as the plain version (callers mask them by read length).
//
// Bound: the bytes written.  Each window writes 12 B (8 B key + 4 B sum)
// against about 1.25 B read (a quarter byte of codes and one quality byte).
//
// Design.  Both inputs have row stride L positions (L / 4 packed bytes, L
// quality bytes), so position f = b * L + w of the flattened batch names
// the same base in both, and window (b, w) starts at f.  A block owns the
// windows that start in a tile of kTile consecutive positions (several
// whole rows of a batch, or a stretch of one long row); its outputs are one
// contiguous range of the flattened [rows, W] outputs.  It stages the
// tile plus a halo, kSpan positions, with coalesced 16-byte loads: the
// packed bytes as 64-bit words in shared memory, and the quality bytes into
// registers, from which a block prefix sum P (int32, shared memory) is made.
// Then thread t of the block computes output t, t + kThreads, ... (lane i
// of a warp stores window i, so every warp store covers whole sectors):
//   key:  the 2k bits of the window are a funnel shift of two 64-bit words
//         (base j in bits 2j), turned around (bit reverse, then swap each
//         bit pair: base j in bits 62-2j, 63-2j) and shifted right by
//         64 - 2k, which leaves exactly the k bases, leftmost highest;
//   sum:  P[f + k] - P[f].
// No rolling state and no prime: each window reads its own two words.
// Index arithmetic inside a tile is 32-bit; the tile's origin is int64.
// The prior design (each thread walking 16 windows of one row) stored
// 128 B apart across a warp and re-read k - 1 bases per 16 windows.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// positions staged per block: one 16-byte quality chunk a thread
constexpr int kSpan = kThreads * 16;
// positions whose windows a block owns; a multiple of 64 so that every
// tile starts on a 16-byte boundary of both inputs, and the halo (k - 1
// <= 30 positions, and the second word of the last window) fits in kSpan
constexpr int kTile = kSpan - 64;
constexpr int kWords = kSpan / 32;  // 64-bit words of packed codes

__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ base,
                                        int64_t off, int64_t n, bool vec) {
  // 16 bytes at base[off], zero past n; a vector load when aligned and whole
  if (vec && off + 16 <= n) {
    return __ldg(reinterpret_cast<const uint4*>(base + off));
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (off + i < n) w[i >> 2] |= static_cast<uint32_t>(base[off + i]) << (8 * (i & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint64_t window_key(const uint64_t* words, int f, int k) {
  const uint64_t lo = words[f >> 5];
  const uint64_t hi = words[(f >> 5) + 1];
  const int s = 2 * (f & 31);
  // (hi << 1) << (63 - s) is hi << (64 - s), and 0 when s == 0
  const uint64_t x = (lo >> s) | ((hi << 1) << (63 - s));
  uint64_t r = __brevll(x);
  r = ((r >> 1) & 0x5555555555555555ull) | ((r & 0x5555555555555555ull) << 1);
  return r >> (64 - 2 * k);
}

// the quality prefix sum of the tile: P[i] = sum of staged bytes < i
__device__ __forceinline__ void quality_prefix(const uint8_t* __restrict__ qual,
                                               int64_t origin, int64_t n, bool vec,
                                               int32_t* P, int32_t* warp_sum) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint4 v = load16(qual, origin + 16 * tid, n, vec);
  const uint32_t q[4] = {v.x, v.y, v.z, v.w};
  int32_t ex[16];  // exclusive prefix inside the thread's 16 bytes
  int32_t s = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    ex[i] = s;
    s += static_cast<int32_t>((q[i >> 2] >> (8 * (i & 3))) & 0xFFu);
  }
  int32_t incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int32_t x = lane < kThreads / 32 ? warp_sum[lane] : 0;
    const int32_t own = x;
#pragma unroll
    for (int o = 1; o < kThreads / 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xFFFFFFFFu, x, o);
      if (lane >= o) x += y;
    }
    if (lane < kThreads / 32) warp_sum[lane] = x - own;  // exclusive
  }
  __syncthreads();
  const int32_t base = warp_sum[warp] + incl - s;
  // four 16-byte stores; the order is skewed by tid / 2 so that the eight
  // lanes of a quarter warp hit eight distinct groups of four banks
  const int4 c0 = make_int4(base + ex[0], base + ex[1], base + ex[2], base + ex[3]);
  const int4 c1 = make_int4(base + ex[4], base + ex[5], base + ex[6], base + ex[7]);
  const int4 c2 = make_int4(base + ex[8], base + ex[9], base + ex[10], base + ex[11]);
  const int4 c3 = make_int4(base + ex[12], base + ex[13], base + ex[14], base + ex[15]);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int m = (c + (tid >> 1)) & 3;
    const int4 val = m == 0 ? c0 : m == 1 ? c1 : m == 2 ? c2 : c3;
    reinterpret_cast<int4*>(P)[4 * tid + m] = val;
  }
  if (tid == kThreads - 1) P[kSpan] = base + s;
}

template <bool kKeys, bool kQual>
__global__ void __launch_bounds__(kThreads)
encode_window_kernel(const uint8_t* __restrict__ packed,
                     const uint8_t* __restrict__ qual,
                     int64_t* __restrict__ keys, int32_t* __restrict__ qsums,
                     int64_t rows, int64_t len, int k, bool vec_packed,
                     bool vec_qual) {
  __shared__ __align__(16) uint64_t words[kKeys ? kWords : 1];
  __shared__ __align__(16) int32_t P[kQual ? kSpan + 4 : 4];
  __shared__ int32_t warp_sum[kThreads / 32];

  const int64_t total = rows * len;        // positions of the batch
  const int64_t nwin = len - k + 1;        // windows a row
  const int64_t f0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t f1 = f0 + kTile < total ? f0 + kTile : total;

  // stage the packed words: positions [f0, f0 + kSpan) are bytes
  // [f0 / 4, f0 / 4 + kSpan / 4), 16 bytes a thread
  if constexpr (kKeys) {
    if (threadIdx.x < kSpan / 64) {
      const uint4 v = load16(packed, f0 / 4 + 16 * threadIdx.x, total / 4, vec_packed);
      reinterpret_cast<uint4*>(words)[threadIdx.x] = v;
    }
  }
  if constexpr (kQual) {
    quality_prefix(qual, f0, total, vec_qual, P, warp_sum);  // syncs inside
  }
  __syncthreads();

  // the tile's windows: from the first window starting at or after f0 to
  // the last one starting before f1; output index g = b * W + w
  const int64_t b0 = f0 / len;
  const int64_t r0 = f0 - b0 * len;
  const int64_t b1 = f1 / len;
  const int64_t r1 = f1 - b1 * len;
  const int64_t g0 = b0 * nwin + (r0 < nwin ? r0 : nwin);
  const int64_t g1 = b1 * nwin + (r1 < nwin ? r1 : nwin);
  const int n_out = static_cast<int>(g1 - g0);
  // position of window g0 inside the tile, and its column in the row
  const int first = r0 < nwin ? 0 : static_cast<int>(len - r0);
  const int64_t w_first = r0 < nwin ? r0 : 0;
  // windows t before a row end: t crosses floor((w_first + t) / W) row
  // ends, each skipping the k - 1 positions that start no window
  const bool short_rows = nwin < kTile;
  const int w0 = short_rows ? static_cast<int>(w_first) : 0;
  const int nw32 = short_rows ? static_cast<int>(nwin) : 0;
  const int64_t left = nwin - w_first;  // windows before the first row end
  const int until_end = left < kTile ? static_cast<int>(left) : kTile;

  for (int t = threadIdx.x; t < n_out; t += kThreads) {
    const int ends = short_rows ? (w0 + t) / nw32 : (t >= until_end ? 1 : 0);
    const int f = first + t + ends * (k - 1);
    if constexpr (kKeys) keys[g0 + t] = static_cast<int64_t>(window_key(words, f, k));
    if constexpr (kQual) qsums[g0 + t] = P[f + k] - P[f];
  }
}

template <bool kKeys, bool kQual>
void launch(const void* packed, const void* qual, void* keys, void* qsums,
            int64_t rows, int64_t len, int k, int64_t blocks, cudaStream_t stream) {
  const bool vec_packed = reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  const bool vec_qual = reinterpret_cast<uintptr_t>(qual) % 16 == 0;
  encode_window_kernel<kKeys, kQual><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(packed), static_cast<const uint8_t*>(qual),
      static_cast<int64_t*>(keys), static_cast<int32_t*>(qsums), rows, len, k,
      vec_packed, vec_qual);
}

}  // namespace

// packed: uint8 [rows, len/4] or null; qual: uint8 [rows, len] or null;
// keys: int64 [rows, len-k+1] (written when packed is given);
// qsums: int32 [rows, len-k+1] (written when qual is given).
// 1 <= k <= 31, k <= len, len % 4 == 0 when packed is given.  Launches on
// `stream`; returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue, without a launch, for arguments outside that
// contract).
extern "C" int stt_encode_window(const void* packed, const void* qual,
                                 void* keys, void* qsums, int64_t rows,
                                 int64_t len, int k, int device,
                                 void* stream) {
  if (k < 1 || k > 31 || len < k || (packed != nullptr && len % 4 != 0) ||
      rows < 0 || (packed == nullptr && qual == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = rows * len;
  if (total <= 0) return 0;
  const int64_t blocks = (total + kTile - 1) / kTile;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (packed != nullptr && qual != nullptr) {
    launch<true, true>(packed, qual, keys, qsums, rows, len, k, blocks, s);
  } else if (packed != nullptr) {
    launch<true, false>(packed, qual, keys, qsums, rows, len, k, blocks, s);
  } else {
    launch<false, true>(packed, qual, keys, qsums, rows, len, k, blocks, s);
  }
  return static_cast<int>(cudaGetLastError());
}
