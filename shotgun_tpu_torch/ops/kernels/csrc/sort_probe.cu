// H4 sort_probe: the sort join's probe and within-read dedupe in one pass
// over a batch's windows, against the resident key-sorted table
// (ops/probe_sort.py SortedTableDev) -> (hit, set_id, genome_count,
// first_occ), each [B, W].
//
// Replaces no Pallas kernel: the JAX package's sort join
// (shotgun_tpu/ops/probe_sort2.py:163-354) is jnp, one sort of the table
// merged with the queries.  It replaces the port's torch join
// (ops/probe_sort2.py probe_dedupe_sorted_words_plain), which stable-sorts
// every table row with the batch's windows, once per key word, each batch:
// at 198.4M table rows and 8.26M windows, 206.7M rows sorted twice to place
// 4% of them.  The table never changes, so each window finds its row by a
// binary search instead.
//
// Semantics, those of the plain join bit for bit: a key is nw int64 words,
// most significant first, compared lexicographically.  A window that passed
// the gates (ok) takes row r = (the rows whose key is <= its key) - 1, the
// last table row at or before it in the plain join's merged order (table
// rows sort before queries of an equal key there), and hits when r >= 0 and
// row r's words all equal its own: then set_id = sid[r] and genome_count =
// gc[r]; otherwise -1 and 0.  Rows of an equal key are a run, and r is its
// last row, so r names the key: first_occ is a hit whose r no earlier window
// of its read has.  A gated window misses and searches nothing.
//
// Bound: the bytes a batch must move.  Per window: its words and gate byte
// in (17 B at two words), hit, set id, genome count and first_occ out
// (10 B), and the row it finds, which a search over a table of one to
// several GB reaches in device memory: that row's words, set id and genome
// count, four 32 B sectors.  At [65536, 126] and two words: 8,257,536 x 155
// B = 1.28 GB, 0.38 ms at 3.35 TB/s.  A search also reads the rows it
// passes on the way down: all windows share the top levels, which stay in
// the 50 MB L2 (level l touches min(2^l, windows) rows), so only the last
// few levels of each search reach device memory.
//
// Design.  Branch-free search: the interval halves a fixed ceil(log2 u)
// times whatever the key, so every lane of a warp runs the same loop and
// its loads are the only dependency; a step reads word 0 of one row and a
// later word only where word 0 ties.  A block owns whole reads: R =
// kChunk / W reads when W <= kChunk (W = 126 at the benchmark's batch: 8
// reads, 1008 windows), else one read, walked in chunks of kChunk windows.
// Each thread searches the windows t, t + kThreads, ... of a chunk (loads
// of neighbouring windows' words coalesce) and writes its row, -1 for a
// miss, to shared memory.  After a barrier each hit compares its row with
// those of the earlier windows of its read in the chunk (the lanes of a
// warp mostly share a read, so a step is one broadcast read); a window of
// a read longer than a chunk also compares its key with the earlier
// chunks' gated-in windows in device memory (an equal key there would have
// found the same row).  Outputs are written in window order, coalesced.
// The kernel allocates nothing.  Word pointers travel by value in the
// launch's parameters (__grid_constant__, so a word's pointer indexed at
// run time is read in place, not copied to local memory): up to kNarrow
// words (k <= 124) in a small struct, up to kWide (k <= 7440) in one that
// fills the 4 KB parameter space.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// windows whose rows a block holds in shared memory at once
constexpr int kChunk = 1024;
constexpr int kNarrow = 4;
constexpr int kWide = 240;

template <int kMaxWords>
struct Words {
  const int64_t* table[kMaxWords];  // int64 [u] each
  const int64_t* query[kMaxWords];  // int64 [rows * w] each
};

// the last row whose key is <= window f's key, or -1 when there is none or
// its key differs (a miss); u >= 1
template <int kMaxWords>
__device__ __forceinline__ int64_t find_row(const Words<kMaxWords>& words, int nw,
                                            int64_t u, int64_t f) {
  const int64_t q0 = __ldg(words.query[0] + f);
  const int64_t q1 = nw > 1 ? __ldg(words.query[1] + f) : 0;
  // row r's key <= the window's, word 0 first, a later word only on a tie
  auto le = [&](int64_t r) -> bool {
    const int64_t a = __ldg(words.table[0] + r);
    if (a != q0) return a < q0;
    for (int j = 1; j < nw; ++j) {
      const int64_t b = __ldg(words.table[j] + r);
      const int64_t q = j == 1 ? q1 : __ldg(words.query[j] + f);
      if (b != q) return b < q;
    }
    return true;
  };
  int64_t base = 0, n = u;
  while (n > 1) {
    const int64_t half = n >> 1;
    base = le(base + half) ? base + half : base;
    n -= half;
  }
  const int64_t row = base + (le(base) ? 1 : 0) - 1;
  if (row < 0) return -1;
  if (__ldg(words.table[0] + row) != q0) return -1;
  for (int j = 1; j < nw; ++j) {
    const int64_t q = j == 1 ? q1 : __ldg(words.query[j] + f);
    if (__ldg(words.table[j] + row) != q) return -1;
  }
  return row;
}

// an earlier window in [a, b) of window f's read passed the gates with f's key
template <int kMaxWords>
__device__ __forceinline__ bool key_before(const Words<kMaxWords>& words, int nw,
                           const uint8_t* __restrict__ ok, int64_t a, int64_t b,
                           int64_t f) {
  for (int64_t g = a; g < b; ++g) {
    if (!ok[g]) continue;
    bool same = true;
    for (int j = 0; j < nw && same; ++j) {
      same = __ldg(words.query[j] + g) == __ldg(words.query[j] + f);
    }
    if (same) return true;
  }
  return false;
}

template <int kMaxWords>
__global__ void __launch_bounds__(kThreads)
    sort_probe_kernel(const __grid_constant__ Words<kMaxWords> words, int nw,
                      const int32_t* __restrict__ tsid, const int32_t* __restrict__ tgc,
                      int64_t u, const uint8_t* __restrict__ ok, int64_t rows, int w,
                      int reads_per_block, uint8_t* __restrict__ hit_out,
                      int32_t* __restrict__ sid_out, int32_t* __restrict__ gc_out,
                      uint8_t* __restrict__ first_out) {
  __shared__ int64_t s_row[kChunk];
  const int64_t read0 = static_cast<int64_t>(blockIdx.x) * reads_per_block;
  const int64_t reads = rows - read0 < reads_per_block ? rows - read0 : reads_per_block;
  const int64_t f0 = read0 * w;    // the block's first window, flat
  const int64_t span = reads * w;  // its windows
  for (int64_t c0 = 0; c0 < span; c0 += kChunk) {
    const int n = static_cast<int>(span - c0 < kChunk ? span - c0 : kChunk);
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int64_t f = f0 + c0 + i;
      s_row[i] = ok[f] && u > 0 ? find_row(words, nw, u, f) : -1;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int64_t f = f0 + c0 + i;
      const int64_t row = s_row[i];
      bool first = row >= 0;
      if (first) {
        // the read's first window, as an index of the block's span
        const int64_t start = c0 + i - (c0 + i) % w;
        for (int j = start > c0 ? static_cast<int>(start - c0) : 0; j < i; ++j) {
          if (s_row[j] == row) {
            first = false;
            break;
          }
        }
        if (first && start < c0) first = !key_before(words, nw, ok, f0 + start, f0 + c0, f);
      }
      hit_out[f] = row >= 0;
      sid_out[f] = row >= 0 ? __ldg(tsid + row) : -1;
      gc_out[f] = row >= 0 ? __ldg(tgc + row) : 0;
      first_out[f] = first;
    }
    __syncthreads();  // the next chunk overwrites s_row
  }
}

template <int kMaxWords>
cudaError_t launch(const void* const* table_words, const void* const* query_words,
                   int nw, const void* sid, const void* gc, int64_t u, const void* ok,
                   int64_t rows, int w, void* hit, void* sid_out, void* gc_out,
                   void* first, cudaStream_t stream) {
  Words<kMaxWords> words{};
  for (int j = 0; j < nw; ++j) {
    words.table[j] = static_cast<const int64_t*>(table_words[j]);
    words.query[j] = static_cast<const int64_t*>(query_words[j]);
  }
  const int per_block = w <= kChunk ? kChunk / w : 1;
  const int64_t blocks = (rows + per_block - 1) / per_block;
  sort_probe_kernel<kMaxWords><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      words, nw, static_cast<const int32_t*>(sid), static_cast<const int32_t*>(gc), u,
      static_cast<const uint8_t*>(ok), rows, w, per_block, static_cast<uint8_t*>(hit),
      static_cast<int32_t*>(sid_out), static_cast<int32_t*>(gc_out),
      static_cast<uint8_t*>(first));
  return cudaGetLastError();
}

}  // namespace

// table_words: nw pointers to int64 [u] (key-sorted, most significant word
// first); sid, gc: int32 [u]; query_words: nw pointers to int64 [rows, w];
// ok: bool [rows, w]; outputs bool / int32 / int32 / bool [rows, w].  Every
// array contiguous; the pointer arrays are host memory.  1 <= nw <= 240,
// 1 <= w < 2^31, at most 2^31 - 1 blocks (of kChunk / w reads, or one).
// rows is the batch's reads, u the table's rows.  Launches on `stream`;
// returns cudaGetLastError() after the launch, cudaErrorInvalidValue for
// an input it does not take.
extern "C" int stt_sort_probe(const void* const* table_words,
                              const void* const* query_words, int nw, const void* sid,
                              const void* gc, int64_t u, const void* ok, int64_t rows,
                              int64_t w, void* hit, void* sid_out, void* gc_out,
                              void* first, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nw < 1 || nw > kWide || u < 0 || rows < 0 || w < 1 || w > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const int wi = static_cast<int>(w);
  const int per_block = wi <= kChunk ? kChunk / wi : 1;
  if ((rows + per_block - 1) / per_block > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = nw <= kNarrow
            ? launch<kNarrow>(table_words, query_words, nw, sid, gc, u, ok, rows, wi, hit,
                              sid_out, gc_out, first, st)
            : launch<kWide>(table_words, query_words, nw, sid, gc, u, ok, rows, wi, hit,
                            sid_out, gc_out, first, st);
  return static_cast<int>(err);
}
