// H1 encode_window: fused 2-bit unpack + rolling k-mer encode + window
// quality sums, one int64 key (and one int32 quality sum) per window.
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
// the same deterministic values as the plain version (callers mask them
// by read length).
//
// Bound: on the H100 the kernel writes 12 B per window (8 B key + 4 B
// quality sum) against about 1.25 B read (a quarter byte of codes plus one
// quality byte), so it is bound by the bytes it writes.  Design: the TPU
// kernel recomputes each window from k bases; here each thread walks a run
// of kRun consecutive windows of one row and shifts in one base (and one
// quality byte) per step after a (k-1)-step prime, so the arithmetic is a
// few instructions per window and the row bytes come from L1.  Later work:
// stage each run in shared memory so the stores coalesce across the warp.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRun = 16;
constexpr int kThreads = 256;

__device__ __forceinline__ uint64_t base_at(const uint8_t* row, int64_t i) {
  return (row[i >> 2] >> ((i & 3) * 2)) & 3u;
}

__global__ void encode_window_kernel(const uint8_t* __restrict__ packed,
                                     const uint8_t* __restrict__ qual,
                                     int64_t* __restrict__ keys,
                                     int32_t* __restrict__ qsums,
                                     int64_t rows, int64_t len, int k,
                                     int64_t segs) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= rows * segs) return;
  const int64_t b = t / segs;
  const int64_t nwin = len - k + 1;
  const int64_t w0 = (t - b * segs) * kRun;
  const int64_t w1 = w0 + kRun < nwin ? w0 + kRun : nwin;
  if (packed != nullptr) {
    const uint8_t* row = packed + b * (len / 4);
    const uint64_t mask = (1ull << (2 * k)) - 1;  // k <= 31
    uint64_t key = 0;
    for (int j = 0; j < k - 1; ++j) key = (key << 2) | base_at(row, w0 + j);
    int64_t* out = keys + b * nwin;
    for (int64_t w = w0; w < w1; ++w) {
      key = ((key << 2) | base_at(row, w + k - 1)) & mask;
      out[w] = static_cast<int64_t>(key);
    }
  }
  if (qual != nullptr) {
    const uint8_t* row = qual + b * len;
    int32_t acc = 0;
    for (int j = 0; j < k - 1; ++j) acc += row[w0 + j];
    int32_t* out = qsums + b * nwin;
    for (int64_t w = w0; w < w1; ++w) {
      acc += row[w + k - 1];
      out[w] = acc;
      acc -= row[w];
    }
  }
}

}  // namespace

// packed: uint8 [rows, len/4] or null; qual: uint8 [rows, len] or null;
// keys: int64 [rows, len-k+1] (written when packed is given);
// qsums: int32 [rows, len-k+1] (written when qual is given).
// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int stt_encode_window(const void* packed, const void* qual,
                                 void* keys, void* qsums, int64_t rows,
                                 int64_t len, int k, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t nwin = len - k + 1;
  const int64_t segs = (nwin + kRun - 1) / kRun;
  const int64_t total = rows * segs;
  if (total <= 0) return 0;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  encode_window_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed), static_cast<const uint8_t*>(qual),
      static_cast<int64_t*>(keys), static_cast<int32_t*>(qsums), rows, len,
      k, segs);
  return static_cast<int>(cudaGetLastError());
}
