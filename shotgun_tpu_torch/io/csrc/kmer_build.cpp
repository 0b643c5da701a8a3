// Native k-mer index builder, k <= 31 fast path (the port's copy of the JAX package's native/kmer_build.cpp).
//
// Replaces the host-numpy assembly in shotgun_tpu/index/build.py for the
// common k <= 31 case (u64-packable keys): parallel rolling 2-bit encode
// with N-run skipping, an MSD-partition + per-bucket comparison sort
// over (key, recpos) pairs, parallel group-boundary detection, CSR
// postings gather, and the deduplicated genome-set table -- producing
// byte-identical kmer_words / first_seen / postings to the numpy path
// (set ids are assigned in first-appearance order, a permutation of the
// numpy path's sorted-mask order; set-id numbering is internal and
// observationally irrelevant, see index/build.py KmerIndex docstring).
//
// The reference this replaces is the nested-dict build loop at
// reference kmer.py:135-150 (k-mer -> {record -> positions}); the array
// layout contract is KmerIndex in shotgun_tpu/index/build.py.
//
// Sort strategy: one scatter pass over the top 16 used key bits into
// 64K buckets, then each bucket is std::sort'ed independently (and in
// parallel) as (key, recpos) pairs.  Lexicographic pair order IS the
// stable order: recpos = rec << 32 | pos is strictly increasing in scan
// order (record-major, position-ascending, N-windows never emitted), so
// sorting by (key, recpos) reproduces exactly what a stable sort by key
// would.  At 1M occurrences each bucket is ~16 elements (L1-resident);
// composition-skewed genomes just make some buckets bigger, which
// std::sort absorbs at n log n -- no correctness cliff.
//
// Two-call protocol like the parser: stpu_build_stage1 runs the build
// and returns an opaque handle plus output sizes; stpu_build_stage2
// streams into caller-allocated numpy buffers; stpu_build_free releases.

#include <sys/mman.h>

#include <atomic>
#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <utility>
#include <vector>

namespace {

// Allocator backing large buffers with MADV_HUGEPAGE mmaps.  This host's
// first-touch page-fault rate on 4K pages is ~0.08 GB/s (measured) while
// hugepage-advised regions fault at ~1.8 GB/s -- a 20x difference that
// dominates the whole build at multi-Mbp scale, since every buffer here
// is written exactly once.
template <class T>
struct HugeAlloc {
  using value_type = T;
  static constexpr size_t kThreshold = 1 << 20;
  HugeAlloc() = default;
  template <class U>
  HugeAlloc(const HugeAlloc<U>&) {}
  T* allocate(size_t n) {
    size_t bytes = n * sizeof(T);
    if (bytes >= kThreshold) {
      void* p = mmap(nullptr, bytes, PROT_READ | PROT_WRITE,
                     MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
      if (p != MAP_FAILED) {
        madvise(p, bytes, MADV_HUGEPAGE);
        return (T*)p;
      }
    }
    return (T*)std::malloc(bytes);
  }
  void deallocate(T* p, size_t n) {
    size_t bytes = n * sizeof(T);
    if (bytes >= kThreshold)
      munmap(p, bytes);
    else
      std::free(p);
  }
  template <class U>
  bool operator==(const HugeAlloc<U>&) const { return true; }
  template <class U>
  bool operator!=(const HugeAlloc<U>&) const { return false; }
};

template <class T>
using hvec = std::vector<T, HugeAlloc<T>>;

// (key, recpos) occurrence; lexicographic order = stable-by-key order
// (see top).  Deliberately trivially-constructible: the occurrence
// buffers are written exactly once, and a std::pair resize would pay a
// full zero-fill first-touch pass before the real fill.
struct Occ {
  uint64_t first, second;
  Occ() {}  // uninitialized: every element is written before it is read
  Occ(uint64_t k, uint64_t v) : first(k), second(v) {}
  bool operator<(const Occ& o) const {
    return first != o.first ? first < o.first : second < o.second;
  }
};

// phase timing to stderr when STPU_BUILD_DEBUG=1
struct PhaseTimer {
  bool on;
  std::chrono::steady_clock::time_point t;
  PhaseTimer() : on(std::getenv("STPU_BUILD_DEBUG") != nullptr) { reset(); }
  void reset() { t = std::chrono::steady_clock::now(); }
  void mark(const char* name) {
    if (!on) return;
    auto now = std::chrono::steady_clock::now();
    std::fprintf(stderr, "[stpu_build] %s: %.3fs\n", name,
                 std::chrono::duration<double>(now - t).count());
    t = now;
  }
};

int num_threads(int64_t work) {
  unsigned hw = std::thread::hardware_concurrency();
  if (hw < 2 || work < (1 << 16)) return 1;
  return (int)std::min(hw, 8u);
}

template <class F>
void run_parallel(int nt, F&& body) {
  if (nt <= 1) {
    body(0);
    return;
  }
  std::vector<std::thread> th;
  th.reserve(nt - 1);
  for (int t = 1; t < nt; ++t) th.emplace_back(body, t);
  body(0);
  for (auto& x : th) x.join();
}

struct BuildState {
  int64_t num_kmers = 0;   // U (known after stage 1)
  int64_t num_post = 0;    // P
  int64_t num_records = 0;
  int64_t gbytes = 0;
  hvec<Occ> occ;           // sorted (key, recpos)
  std::vector<uint8_t> set_masks;  // [S, gbytes] (filled by stage 2)
  std::vector<int32_t> set_sizes;  // [S]
};

// MSD partition by the top (up to) 16 used bits, then per-bucket
// std::sort in parallel with dynamic bucket assignment.
void msd_sort(hvec<Occ>& occ, int used_bits, int nt) {
  const size_t n = occ.size();
  if (n < 2) return;
  // bucket-count heuristic: ~64-256 elements per bucket keeps each
  // std::sort L1-resident while the scatter touches few enough open
  // bucket streams to stay TLB/cache-friendly; clamp to the used bits
  int want = 8;
  while ((n >> want) > 128 && want < 16) ++want;
  const int bbits = used_bits < want ? used_bits : want;
  const int shift = used_bits - bbits;
  const int nb = 1 << bbits;

  hvec<Occ> buf(n);
  std::vector<size_t> cut(nt + 1);
  for (int t = 0; t <= nt; ++t) cut[t] = n * (size_t)t / (size_t)nt;

  // parallel histogram over the bucket digit
  std::vector<std::vector<uint64_t>> hist(nt, std::vector<uint64_t>(nb));
  run_parallel(nt, [&](int t) {
    auto& h = hist[t];
    for (size_t i = cut[t]; i < cut[t + 1]; ++i)
      ++h[(occ[i].first >> shift) & (nb - 1)];
  });

  // global offsets, thread-major within each bucket, plus bucket bounds
  std::vector<uint64_t> bstart(nb + 1);
  uint64_t run = 0;
  for (int b = 0; b < nb; ++b) {
    bstart[b] = run;
    for (int t = 0; t < nt; ++t) {
      uint64_t c = hist[t][b];
      hist[t][b] = run;
      run += c;
    }
  }
  bstart[nb] = run;

  // parallel scatter into buckets
  run_parallel(nt, [&](int t) {
    auto& off = hist[t];
    for (size_t i = cut[t]; i < cut[t + 1]; ++i)
      buf[off[(occ[i].first >> shift) & (nb - 1)]++] = occ[i];
  });

  // parallel per-bucket sort (dynamic assignment; bucket sizes vary)
  std::atomic<int> next{0};
  run_parallel(nt, [&](int) {
    for (;;) {
      int b = next.fetch_add(1, std::memory_order_relaxed);
      if (b >= nb) break;
      Occ* lo = buf.data() + bstart[b];
      Occ* hi = buf.data() + bstart[b + 1];
      if (hi - lo > 1) std::sort(lo, hi);
    }
  });
  occ.swap(buf);
}

// Open-addressing dedupe table for set masks (mask bytes -> set id).
struct MaskTable {
  int64_t gbytes;
  std::vector<int32_t> slots;     // sid + 1, 0 = empty
  std::vector<uint64_t> hashes;   // cached hash per slot
  size_t mask_count = 0;
  std::vector<uint8_t>* arena;    // set_masks storage (sid-indexed rows)

  explicit MaskTable(int64_t gb, std::vector<uint8_t>* masks)
      : gbytes(gb), slots(1024, 0), hashes(1024, 0), arena(masks) {}

  static uint64_t hash_bytes(const uint8_t* p, int64_t n) {
    uint64_t h = 1469598103934665603ull;  // FNV-1a
    for (int64_t i = 0; i < n; ++i) {
      h ^= p[i];
      h *= 1099511628211ull;
    }
    return h | 1;  // never 0
  }

  void grow() {
    size_t cap = slots.size() * 2;
    std::vector<int32_t> ns(cap, 0);
    std::vector<uint64_t> nh(cap, 0);
    for (size_t i = 0; i < slots.size(); ++i) {
      if (!slots[i]) continue;
      size_t j = hashes[i] & (cap - 1);
      while (ns[j]) j = (j + 1) & (cap - 1);
      ns[j] = slots[i];
      nh[j] = hashes[i];
    }
    slots.swap(ns);
    hashes.swap(nh);
  }

  // returns sid of mask (inserting if new)
  int32_t intern(const uint8_t* mask) {
    if (mask_count * 10 >= slots.size() * 7) grow();
    uint64_t h = hash_bytes(mask, gbytes);
    size_t cap = slots.size();
    size_t j = h & (cap - 1);
    while (slots[j]) {
      if (hashes[j] == h &&
          std::memcmp(arena->data() + (size_t)(slots[j] - 1) * gbytes, mask,
                      (size_t)gbytes) == 0)
        return slots[j] - 1;
      j = (j + 1) & (cap - 1);
    }
    int32_t sid = (int32_t)mask_count++;
    slots[j] = sid + 1;
    hashes[j] = h;
    arena->insert(arena->end(), mask, mask + gbytes);
    return sid;
  }
};

}  // namespace

// out_sizes (int64[8]): [0]=U [1]=P [2]=gbytes [3..7] reserved.
// Returns nullptr when the input is out of the fast path's domain
// (k > 31, records longer than 2^31, or >= 2^32-1 valid windows) --
// the caller falls back to the numpy assembly (any k).
extern "C" void* stpu_build_stage1(const uint8_t* codes, int64_t n_bases,
                                   const int64_t* offsets, int64_t n_records,
                                   int64_t k, int64_t* out_sizes) {
  if (k < 1 || k > 31) return nullptr;
  if (n_records >= (int64_t)1 << 31) return nullptr;
  for (int64_t r = 0; r < n_records; ++r)
    if (offsets[r + 1] - offsets[r] >= (int64_t)1 << 31) return nullptr;
  (void)n_bases;
  PhaseTimer pt;
  auto* st = new BuildState();
  st->num_records = n_records;
  st->gbytes = n_records > 0 ? (n_records + 7) / 8 : 1;

  // ---- phase 1: occurrence generation (rolling encode, N-run skip) ----
  // reference kmer.py:84-94 extract_kmers_from_genome + the N skip at
  // kmer.py:145; key layout: first base most significant 2-bit group
  // (matches index/build.py rolling_encode_words little-word columns).
  //
  // Parallel over window-range chunks: chunk c of record r emits the
  // windows at positions [wstart, wend) after a (k-1)-base halo warm-up,
  // writing at a precomputed dense offset (exact when the chunk has no
  // N; chunks that skipped windows leave gaps that one sequential
  // compaction pass closes, preserving scan order).
  int64_t total_max = 0;
  struct EncChunk {
    int32_t rec;
    int64_t wstart, wend;  // window-position range within the record
    int64_t out_base;      // dense output offset assuming no skips
    int64_t count;         // actual emitted (<= wend - wstart)
  };
  std::vector<EncChunk> chunks;
  {
    const int64_t chunk_windows = 4 << 20;
    for (int64_t r = 0; r < n_records; ++r) {
      int64_t len = offsets[r + 1] - offsets[r];
      int64_t nwin = len >= k ? len - k + 1 : 0;
      for (int64_t w = 0; w < nwin; w += chunk_windows) {
        int64_t we = std::min(w + chunk_windows, nwin);
        chunks.push_back({(int32_t)r, w, we, total_max + w, 0});
      }
      total_max += nwin;
    }
  }
  if (total_max >= (int64_t)UINT32_MAX) {
    delete st;
    return nullptr;
  }
  st->occ.resize(total_max);
  const uint64_t mask =
      (k >= 32) ? ~0ull : ((1ull << (2 * (unsigned)k)) - 1ull);
  {
    int nt = num_threads(total_max);
    std::atomic<size_t> next{0};
    run_parallel(nt, [&](int) {
      for (;;) {
        size_t ci = next.fetch_add(1, std::memory_order_relaxed);
        if (ci >= chunks.size()) break;
        EncChunk& ch = chunks[ci];
        const uint8_t* p = codes + offsets[ch.rec];
        const int64_t len = offsets[ch.rec + 1] - offsets[ch.rec];
        const uint64_t rbits = (uint64_t)(uint32_t)ch.rec << 32;
        const int64_t iend = std::min(len, ch.wend + k - 1);
        Occ* out = st->occ.data() + ch.out_base;
        uint64_t key = 0;
        int64_t run = 0;
        for (int64_t i = ch.wstart; i < iend; ++i) {
          uint8_t c = p[i];
          if (c >= 4) {  // N (or invalid) breaks every window containing it
            run = 0;
            key = 0;
            continue;
          }
          key = ((key << 2) | c) & mask;
          if (++run >= k)
            *out++ = {key, rbits | (uint64_t)(uint32_t)(i - k + 1)};
        }
        ch.count = out - (st->occ.data() + ch.out_base);
      }
    });
    // compaction (no-op when nothing was skipped)
    int64_t dst = 0;
    bool moved = false;
    for (auto& ch : chunks) {
      if (moved && ch.count)
        std::memmove(st->occ.data() + dst, st->occ.data() + ch.out_base,
                     (size_t)ch.count * sizeof(Occ));
      dst += ch.count;
      if (ch.count != ch.wend - ch.wstart) moved = true;
    }
    st->occ.resize(dst);
  }
  pt.mark("encode");
  const int64_t P = (int64_t)st->occ.size();
  st->num_post = P;

  if (P) {
    // ---- phase 2: MSD partition + parallel per-bucket sort ----
    msd_sort(st->occ, 2 * (int)k, num_threads(P));
    pt.mark("sort");

    // ---- phase 3: count groups (pre-sizes every output exactly) ----
    int nt = num_threads(P);
    int64_t U = 0;
    const Occ* oc = st->occ.data();
    std::vector<int64_t> part(nt, 0);
    run_parallel(nt, [&](int t) {
      int64_t lo = P * (int64_t)t / nt, hi = P * (int64_t)(t + 1) / nt;
      int64_t c = 0;
      for (int64_t i = lo; i < hi; ++i)
        c += (i == 0) || (oc[i].first != oc[i - 1].first);
      part[t] = c;
    });
    for (int t = 0; t < nt; ++t) U += part[t];
    st->num_kmers = U;
    pt.mark("count");
  }

  out_sizes[0] = st->num_kmers;
  out_sizes[1] = st->num_post;
  out_sizes[2] = st->gbytes;
  return st;
}

// Stage 2: stream the sorted occurrences into the caller's buffers
// (kmer_words [U,2] u32, first_seen [U] i64, post_offsets [U+1] i64,
// post_record [P] i32, post_pos [P] i64, set_id [U] i32) and build the
// set table.  Returns S (number of distinct genome sets).
//
// Parallel layout: slice the postings at group boundaries; each thread
// fills its disjoint ranges of kmer_words / first_seen / post_offsets
// and a per-group descriptor (singleton record id, or -1 for a
// multi-record group).  The postings split runs concurrently.  Set-id
// interning stays a single sequential pass in u order (first-appearance
// numbering), consuming the descriptors; multi-record groups (the rare
// case) re-derive their mask from the group's postings.
extern "C" int64_t stpu_build_stage2(void* handle, uint32_t* kmer_words,
                                     int64_t* first_seen,
                                     int64_t* post_offsets,
                                     int32_t* post_record, int64_t* post_pos,
                                     int32_t* set_id) {
  auto* st = (BuildState*)handle;
  PhaseTimer pt;
  const int64_t P = st->num_post;
  const int64_t U = st->num_kmers;
  const int64_t gbytes = st->gbytes;
  if (P == 0) {
    post_offsets[0] = 0;
    return 0;
  }
  const Occ* oc = st->occ.data();
  const int nt = num_threads(P);

  // slice bounds aligned to group starts
  std::vector<int64_t> gs(nt + 1);
  gs[0] = 0;
  gs[nt] = P;
  for (int t = 1; t < nt; ++t) {
    int64_t i = std::max(P * (int64_t)t / nt, gs[t - 1]);
    while (i < P && i > 0 && oc[i].first == oc[i - 1].first) ++i;
    gs[t] = i;
  }
  // group count per slice -> output base per slice
  std::vector<int64_t> ucnt(nt, 0);
  run_parallel(nt, [&](int t) {
    int64_t c = 0;
    for (int64_t i = gs[t]; i < gs[t + 1]; ++i)
      c += (i == 0) || (oc[i].first != oc[i - 1].first);
    ucnt[t] = c;
  });
  std::vector<int64_t> ubase(nt + 1, 0);
  for (int t = 0; t < nt; ++t) ubase[t + 1] = ubase[t] + ucnt[t];

  // desc[u]: singleton record id, or -1 for multi-record groups
  hvec<int64_t> desc(U);

  // fill pass: groups (parallel slices) + postings split (chunked in)
  run_parallel(nt, [&](int t) {
    // one fused pass per slice: postings split + group walk (group
    // boundaries never span slices -- gs is aligned to group starts).
    // Reading each Occ exactly once matters on this bandwidth-bound
    // host: the separate split + walk loops streamed the 16-byte
    // occurrences twice
    int64_t u = ubase[t];
    for (int64_t gstart = gs[t]; gstart < gs[t + 1];) {
      const uint64_t key = oc[gstart].first;
      const int32_t first_rec = (int32_t)(oc[gstart].second >> 32);
      bool single = true;
      int64_t i = gstart;
      for (; i < P && oc[i].first == key; ++i) {
        const uint64_t v = oc[i].second;
        const int32_t rr = (int32_t)(v >> 32);
        post_record[i] = rr;
        post_pos[i] = (int64_t)(uint32_t)v;
        if (rr != first_rec) single = false;
      }
      kmer_words[2 * u] = (uint32_t)(key & 0xFFFFFFFFu);
      kmer_words[2 * u + 1] = (uint32_t)(key >> 32);
      first_seen[u] = (int64_t)oc[gstart].second;
      post_offsets[u] = gstart;
      desc[u] = single ? (int64_t)first_rec : -1;
      ++u;
      gstart = i;
    }
  });
  post_offsets[U] = P;
  pt.mark("groups");

  // sequential intern pass in u order (first-appearance set numbering;
  // distinct records of a group are adjacent-unique: the sort is stable
  // in scan order and occurrences are generated record-major)
  st->set_masks.reserve(4096 * gbytes);
  MaskTable table(gbytes, &st->set_masks);
  std::vector<int32_t> singleton_sid(
      st->num_records > 0 ? st->num_records : 1, -1);
  std::vector<uint8_t> scratch(gbytes);
  for (int64_t u = 0; u < U; ++u) {
    int64_t d = desc[u];
    int32_t sid;
    if (d >= 0) {
      sid = singleton_sid[d];
      if (sid < 0) {
        std::memset(scratch.data(), 0, (size_t)gbytes);
        scratch[d >> 3] = (uint8_t)(1u << (d & 7));
        sid = table.intern(scratch.data());
        singleton_sid[d] = sid;
        st->set_sizes.push_back(1);
      }
    } else {
      const int64_t gend = u + 1 < U ? post_offsets[u + 1] : P;
      std::memset(scratch.data(), 0, (size_t)gbytes);
      int32_t prev = -1, dcount = 0;
      for (int64_t j = post_offsets[u]; j < gend; ++j) {
        int32_t rr = post_record[j];
        if (rr != prev) {
          scratch[rr >> 3] |= (uint8_t)(1u << (rr & 7));
          prev = rr;
          ++dcount;
        }
      }
      size_t before = table.mask_count;
      sid = table.intern(scratch.data());
      if (table.mask_count > before) st->set_sizes.push_back(dcount);
    }
    set_id[u] = sid;
  }
  pt.mark("intern");
  return (int64_t)st->set_sizes.size();
}

extern "C" void stpu_build_fetch_sets(void* handle, uint8_t* set_masks,
                                      int32_t* set_sizes) {
  auto* st = (BuildState*)handle;
  if (!st->set_masks.empty())
    std::memcpy(set_masks, st->set_masks.data(), st->set_masks.size());
  if (!st->set_sizes.empty())
    std::memcpy(set_sizes, st->set_sizes.data(),
                st->set_sizes.size() * sizeof(int32_t));
}

extern "C" void stpu_build_free(void* handle) { delete (BuildState*)handle; }

// ---------------------------------------------------------------------------
// 2-bit pack + sparse N-run extraction for the device-side DB build
// upload (shotgun_tpu/index/device_build.py _host_prep).  One pass over
// the raw code plane; N positions pack as code 0 and are invalidated on
// device via the run list.  Runs are emitted as (start, end) int32 pairs;
// a run split at a thread boundary is fine (the device rebuilds the mask
// from +1/-1 deltas, which cancel at the split point).  Returns the run
// count, or -1 if it exceeds runs_cap (caller falls back).
// ---------------------------------------------------------------------------
extern "C" int64_t stpu_pack2(const uint8_t* codes, int64_t g, int64_t gp,
                              uint8_t* codes2, int32_t* runs_out,
                              int64_t runs_cap, int64_t n_threads) {
  int64_t nt = n_threads < 1 ? 1 : n_threads;
  int64_t blocks = gp / 4;  // one output byte per 4 bases
  std::vector<std::vector<int32_t>> runs(nt);
  auto work = [&](int64_t t, int64_t b0, int64_t b1) {
    auto& rv = runs[t];
    bool in_run = false;
    for (int64_t blk = b0; blk < b1; ++blk) {
      int64_t base = blk * 4;
      uint8_t c2 = 0;
      for (int j = 0; j < 4; ++j) {
        int64_t i = base + j;
        uint8_t c = (i < g) ? codes[i] : 0;  // pad handled by caller run
        c2 |= (uint8_t)((c & 3) << (2 * j));
        bool bad = (i < g) && c >= 4;
        if (bad && !in_run) {
          rv.push_back((int32_t)i);
          in_run = true;
        } else if (!bad && in_run) {
          rv.push_back((int32_t)i);
          in_run = false;
        }
      }
      codes2[blk] = c2;
    }
    if (in_run) rv.push_back((int32_t)(b1 * 4));  // close at block edge
  };
  if (nt == 1 || blocks < (1 << 16)) {
    work(0, 0, blocks);
  } else {
    std::vector<std::thread> ts;
    int64_t per = (blocks + nt - 1) / nt;
    for (int64_t t = 0; t < nt; ++t) {
      int64_t b0 = t * per, b1 = std::min(blocks, b0 + per);
      if (b0 >= b1) break;
      ts.emplace_back(work, t, b0, b1);
    }
    for (auto& t : ts) t.join();
  }
  int64_t n = 0;
  for (auto& rv : runs) n += (int64_t)rv.size() / 2;
  if (n > runs_cap) return -1;
  int64_t w = 0;
  for (auto& rv : runs)
    for (size_t i = 0; i < rv.size(); ++i) runs_out[w++] = rv[i];
  return n;
}
