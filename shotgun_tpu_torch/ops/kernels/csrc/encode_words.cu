// H3 encode_words: multi-word k-mer keys (k >= 32) and window quality sums
// in one pass, ceil(k / 31) int64 words and one int32 sum per window.
//
// Replaces, at k > 31, the TPU kernel in shotgun_tpu/ops/pallas/kernels.py
//   K2 window_qsums_pallas (:107, body _qsum_kernel :100)
// and the JAX package's multi-word encode in front of it
// (shotgun_tpu/ops/encode.py:125 rolling_encode_words_jnp), which the JAX
// word path (shotgun_tpu/models/pipeline.py:370, :331) runs at any k.
// Kernel H1 (encode_window.cu) covers both at k <= 31.
//
// For row b and window w < W = L - k + 1 (L = 4 * packed row bytes), with
// nw = ceil(k / 31) words, word j holding bases [31j, 31j + n_j) of the
// window (n_j = 31, or k mod 31 for a tail word):
//   words[j, b, w] = sum_{i<n_j} code(b, w+31j+i) << 2*(n_j-1-i)  (int64, < 2^62)
//   qsums[b, w]    = sum_{i<k} qual[b, w+i]                       (int32)
// the layout of ops/encode.py word_spans.  Pad positions hold code 0 and
// quality 0, so windows that reach into the padding get the plain
// version's values (callers mask them by read length).
//
// Bound: the bytes written.  At k = 75 a window writes 28 B (three 8 B
// words and a 4 B sum) against about 1.25 B read.
//
// Design.  As H1: both inputs have row stride L positions, so position
// f = b * L + w of the flattened batch names the same base in both, and
// window (b, w) starts at f.  A block owns the windows that start in a
// tile of kTile positions; its outputs are one contiguous range of each
// flattened [rows, W] plane, and thread t stores output t, t + kThreads,
// ... of the range (lane i of a warp stores window i, so every store
// covers whole sectors).  Planes are written one after another, plane j
// at j * rows * W, so each word is a contiguous [rows, W] tensor.
//   words: the codes of [origin, origin + kCodeSpan) are staged as 64-bit
//     words in shared memory, origin = f0 + 31 * j0 rounded down to 64
//     positions (16 bytes) and d = f0 + 31 * j0 - origin < 64; words
//     j0 .. j0 + kGroup - 1 of the window at tile position f are then
//     H1's extract (a funnel shift of two 64-bit words, a bit reverse and
//     a pair swap) at staged position d + f + 31 * (j - j0) with n_j
//     bases.  One group holds every word up to k = 31 * kGroup; beyond,
//     the block stages the next group and runs over its windows again.
//   sums: one difference of prefix sums, S(f + k) - S(f), with S split so
//     that no k is limited by shared memory: A is the block prefix of
//     [f0, f0 + kSpan), B that of [fb, fb + kSpan) with fb = f0 + k
//     rounded down to 16 bytes and e = f0 + k - fb, and C = S(fb) - S(f0)
//     = A[fb - f0] when fb - f0 <= kSpan, else A[kSpan] plus a block sum
//     of [f0 + kSpan, fb).  Then sum = B[f + e] + C - A[f].
// Index arithmetic inside a tile is 32-bit; origins and planes are int64.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// positions of a quality prefix: one 16-byte chunk a thread
constexpr int kSpan = kThreads * 16;
// positions whose windows a block owns: a multiple of 64, so every tile
// starts on a 16-byte boundary of both inputs; B's prefix is read up to
// position kTile + 15 and a code group up to kTile + 63 + 31 * (kGroup - 1)
// + 64 (the second word of the last extract)
constexpr int kTile = kSpan - 128;
constexpr int kWordBases = 31;
// words a staged code group serves; its span, in positions, fits them
constexpr int kGroup = 128;
constexpr int kCodeSpan = 8192;
static_assert(kTile + 63 + kWordBases * (kGroup - 1) + 64 <= kCodeSpan, "code span");
constexpr int kCodeWords = kCodeSpan / 32;  // 64-bit words of staged codes

__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ base,
                                        int64_t off, int64_t n, bool vec) {
  // 16 bytes at base[off] (off a multiple of 16), zero past n; a vector
  // load when the base is aligned and the chunk whole
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

__device__ __forceinline__ int32_t byte_sum(uint32_t x) {
  return static_cast<int32_t>((x & 0xFFu) + ((x >> 8) & 0xFFu) + ((x >> 16) & 0xFFu) +
                              (x >> 24));
}

__device__ __forceinline__ uint64_t extract(const uint64_t* words, int f, int n) {
  const uint64_t lo = words[f >> 5];
  const uint64_t hi = words[(f >> 5) + 1];
  const int s = 2 * (f & 31);
  // (hi << 1) << (63 - s) is hi << (64 - s), and 0 when s == 0
  const uint64_t x = (lo >> s) | ((hi << 1) << (63 - s));
  uint64_t r = __brevll(x);
  r = ((r >> 1) & 0x5555555555555555ull) | ((r & 0x5555555555555555ull) << 1);
  return r >> (64 - 2 * n);
}

__device__ __forceinline__ int32_t chunk_sum(const uint4 v) {
  return byte_sum(v.x) + byte_sum(v.y) + byte_sum(v.z) + byte_sum(v.w);
}

// the inclusive sum of x over the lanes up to this one
__device__ __forceinline__ int32_t warp_inclusive(int32_t x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// warp 0 or 1 turns the kThreads / 32 warp totals in sums into exclusive
// prefixes, in place
__device__ __forceinline__ void warp_totals_exclusive(int32_t* sums) {
  const int lane = threadIdx.x & 31;
  int32_t x = lane < kThreads / 32 ? sums[lane] : 0;
  const int32_t own = x;
#pragma unroll
  for (int o = 1; o < kThreads / 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane < kThreads / 32) sums[lane] = x - own;
}

// P[16 * tid + i] = base + the sum of the chunk's bytes before byte i:
// four 16-byte stores, skewed by tid / 2 so that the eight lanes of a
// quarter warp hit eight distinct groups of four banks
__device__ __forceinline__ void store_prefix(const uint4 v, int32_t base, int32_t* P) {
  const uint32_t q[4] = {v.x, v.y, v.z, v.w};
  int32_t ex[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    ex[i] = base;
    base += static_cast<int32_t>((q[i >> 2] >> (8 * (i & 3))) & 0xFFu);
  }
  const int tid = threadIdx.x;
  const int4 c0 = make_int4(ex[0], ex[1], ex[2], ex[3]);
  const int4 c1 = make_int4(ex[4], ex[5], ex[6], ex[7]);
  const int4 c2 = make_int4(ex[8], ex[9], ex[10], ex[11]);
  const int4 c3 = make_int4(ex[12], ex[13], ex[14], ex[15]);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int m = (c + (tid >> 1)) & 3;
    const int4 val = m == 0 ? c0 : m == 1 ? c1 : m == 2 ? c2 : c3;
    reinterpret_cast<int4*>(P)[4 * tid + m] = val;
  }
  if (tid == kThreads - 1) P[kSpan] = base;
}

// positions [origin, origin + kCodeSpan) of the packed codes (origin a
// multiple of 64) as 64-bit words: bytes [origin / 4, origin / 4 +
// kCodeSpan / 4), 16 bytes a thread
__device__ __forceinline__ void stage_codes(const uint8_t* __restrict__ packed, int64_t origin,
                                            int64_t n, bool vec, uint64_t* codes) {
  for (int i = threadIdx.x; i < kCodeSpan / 64; i += kThreads) {
    reinterpret_cast<uint4*>(codes)[i] = load16(packed, origin / 4 + 16 * i, n, vec);
  }
}

// the sum of quality bytes [from, to) (both multiples of 16) over the
// block, returned to every thread; red holds kThreads / 32 + 1 ints
__device__ __forceinline__ int32_t quality_sum(const uint8_t* __restrict__ qual,
                                               int64_t from, int64_t to, int64_t n,
                                               bool vec, int32_t* red) {
  int32_t s = 0;
  for (int64_t off = from + 16 * threadIdx.x; off < to; off += 16 * kThreads) {
    s += chunk_sum(load16(qual, off, n, vec));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t t = 0;
    for (int w = 0; w < kThreads / 32; ++w) t += red[w];
    red[kThreads / 32] = t;
  }
  __syncthreads();
  return red[kThreads / 32];
}

template <bool kQual>
__global__ void __launch_bounds__(kThreads)
encode_words_kernel(const uint8_t* __restrict__ packed, const uint8_t* __restrict__ qual,
                    int64_t* __restrict__ words, int32_t* __restrict__ qsums,
                    int64_t rows, int64_t len, int k, bool vec_packed, bool vec_qual) {
  __shared__ __align__(16) uint64_t codes[kCodeWords];
  __shared__ __align__(16) int32_t A[kQual ? kSpan + 4 : 4];
  __shared__ __align__(16) int32_t B[kQual ? kSpan + 4 : 4];
  __shared__ int32_t warp_a[kThreads / 32];
  __shared__ int32_t warp_b[kThreads / 32];
  __shared__ int32_t red[kThreads / 32 + 1];

  const int64_t total = rows * len;        // positions of the batch
  const int64_t nwin = len - k + 1;        // windows a row
  const int64_t plane = rows * nwin;       // int64 words a plane
  const int64_t f0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t f1 = f0 + kTile < total ? f0 + kTile : total;

  // the tile's windows, as in H1: from the first window starting at or
  // after f0 to the last one starting before f1; output index g = b * W + w
  const int64_t b0 = f0 / len;
  const int64_t r0 = f0 - b0 * len;
  const int64_t b1 = f1 / len;
  const int64_t r1 = f1 - b1 * len;
  const int64_t g0 = b0 * nwin + (r0 < nwin ? r0 : nwin);
  const int64_t g1 = b1 * nwin + (r1 < nwin ? r1 : nwin);
  const int n_out = static_cast<int>(g1 - g0);
  if (n_out == 0) return;  // the whole block: a tile inside one row's tail
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
  const int nw = (k + kWordBases - 1) / kWordBases;
  const int tail = k % kWordBases;

  // the loads of the first code group and of both quality prefixes are
  // all issued before the scans
  const int64_t fb = (f0 + k) & ~static_cast<int64_t>(15);
  const int e = static_cast<int>(f0 + k - fb);
  uint4 va = make_uint4(0u, 0u, 0u, 0u), vb = va;
  if constexpr (kQual) {
    va = load16(qual, f0 + 16 * threadIdx.x, total, vec_qual);
    vb = load16(qual, fb + 16 * threadIdx.x, total, vec_qual);
  }
  stage_codes(packed, f0 & ~static_cast<int64_t>(63), total / 4, vec_packed, codes);
  int32_t c = 0;
  if constexpr (kQual) {
    // A and B: one block scan of both, each thread a 16-byte chunk of each
    const int warp = threadIdx.x >> 5;
    const int32_t sa = chunk_sum(va), sb = chunk_sum(vb);
    const int32_t ia = warp_inclusive(sa), ib = warp_inclusive(sb);
    if ((threadIdx.x & 31) == 31) {
      warp_a[warp] = ia;
      warp_b[warp] = ib;
    }
    __syncthreads();
    if (warp == 0) warp_totals_exclusive(warp_a);
    if (warp == 1) warp_totals_exclusive(warp_b);
    __syncthreads();
    store_prefix(va, warp_a[warp] + ia - sa, A);
    store_prefix(vb, warp_b[warp] + ib - sb, B);
  }
  __syncthreads();
  if constexpr (kQual) {
    c = fb - f0 <= kSpan
            ? A[fb - f0]
            : A[kSpan] + quality_sum(qual, f0 + kSpan, fb, total, vec_qual, red);
  }

  for (int j0 = 0; j0 < nw; j0 += kGroup) {
    // the group's codes: positions [origin, origin + kCodeSpan), staged
    // for the first group above
    const int64_t start = f0 + static_cast<int64_t>(kWordBases) * j0;
    const int64_t origin = start & ~static_cast<int64_t>(63);
    const int d = static_cast<int>(start - origin);
    const int j1 = j0 + kGroup < nw ? j0 + kGroup : nw;
    if (j0 > 0) {
      __syncthreads();  // the previous group's extracts are done
      stage_codes(packed, origin, total / 4, vec_packed, codes);
      __syncthreads();
    }

    for (int t = threadIdx.x; t < n_out; t += kThreads) {
      const int ends = short_rows ? (w0 + t) / nw32 : (t >= until_end ? 1 : 0);
      const int f = first + t + ends * (k - 1);
      const int64_t g = g0 + t;
      if constexpr (kQual) {
        if (j0 == 0) qsums[g] = B[f + e] + c - A[f];
      }
      for (int j = j0; j < j1; ++j) {
        const int n = (j == nw - 1 && tail != 0) ? tail : kWordBases;
        words[j * plane + g] = static_cast<int64_t>(
            extract(codes, d + f + kWordBases * (j - j0), n));
      }
    }
  }
}

template <bool kQual>
void launch(const void* packed, const void* qual, void* words, void* qsums, int64_t rows,
            int64_t len, int k, int64_t blocks, cudaStream_t stream) {
  const bool vec_packed = reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  const bool vec_qual = reinterpret_cast<uintptr_t>(qual) % 16 == 0;
  encode_words_kernel<kQual><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(packed), static_cast<const uint8_t*>(qual),
      static_cast<int64_t*>(words), static_cast<int32_t*>(qsums), rows, len, k,
      vec_packed, vec_qual);
}

}  // namespace

// packed: uint8 [rows, len/4]; qual: uint8 [rows, len] or null;
// words: int64 [ceil(k/31), rows, len-k+1], the planes most significant
// first; qsums: int32 [rows, len-k+1], written when qual is given (null
// when it is not).  32 <= k <= len, len % 4 == 0.  Launches on `stream`;
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue,
// without a launch, for arguments outside that contract).
extern "C" int stt_encode_words(const void* packed, const void* qual, void* words,
                                void* qsums, int64_t rows, int64_t len, int k,
                                int device, void* stream) {
  if (packed == nullptr || words == nullptr || (qual == nullptr) != (qsums == nullptr) ||
      k < 32 || len < k || len % 4 != 0 || rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = rows * len;
  if (total <= 0) return 0;
  const int64_t blocks = (total + kTile - 1) / kTile;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qual != nullptr) {
    launch<true>(packed, qual, words, qsums, rows, len, k, blocks, s);
  } else {
    launch<false>(packed, qual, words, qsums, rows, len, k, blocks, s);
  }
  return static_cast<int>(cudaGetLastError());
}
