// Native strict FASTA/FASTQ parser (the port's copy of the JAX package's native/shotgun_io.cpp).
//
// Byte-exact reimplementation of the reference's regex grammar
// (reference src/records.py:141-302) as a line-based scanner:
//  * FASTQ records are 4 consecutive lines (@id / ACGT seq / +dots /
//    quality) whose next line starts with '@' or is EOF with at most one
//    trailing newline; scan resyncs at every line on failure, exactly like
//    re.finditer with a MULTILINE ^ anchor.
//  * FASTA records are one '>' header line plus a nonempty body region of
//    [ACGTN + whitespace] running to the newline before the next '>' line
//    (or EOF minus one optional trailing newline).
//  * Characters outside any match must be whitespace (UnparsedDataError
//    semantics); duplicate FASTQ ids are detected during the scan in
//    match order; sequence/quality length mismatches are reported by
//    record number after a successful parse.
//
// ASCII-only: any byte >= 0x80 returns STATUS_NON_ASCII so the Python
// caller falls back to the regex engine (unicode whitespace semantics
// differ at the byte level).
//
// Two-call protocol per format: *_scan validates and sizes, *_fill
// re-walks the (now known valid) input writing packed arrays:
// 2-bit base codes (+N=4 for FASTA), raw quality bytes, lengths/offsets
// and concatenated id/description bytes.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_set>
#include <vector>

namespace {

enum Status {
  OK = 0,
  NO_RECORDS = 1,
  DUPLICATE_ID = 2,
  UNPARSED = 3,
  LEN_MISMATCH = 4,
  NON_ASCII = 5,
};

// out_info layout (int64[8]):
//  [0] n_records  [1] max_seq_len (fastq) / total_bases (fasta)
//  [2] total_id_bytes  [3] err_index  [4] err_aux  [5..7] reserved
constexpr int INFO_N = 0, INFO_SIZE = 1, INFO_IDB = 2, INFO_ERRI = 3,
              INFO_AUX = 4;

struct Line {
  int64_t start;    // first content byte
  int64_t end;      // one past last content byte (excludes \r?\n)
  int64_t raw_end;  // one past the newline (== next line's raw start)
};

// character classes
struct Tables {
  bool id_ok[256] = {};    // [\S\t ] over ASCII: all except \n \r \f \v
  bool seq_ok[256] = {};   // ACGT
  bool base_ok[256] = {};  // ACGTN
  bool qual_ok[256] = {};  // the 94 PHRED33 chars
  bool ws[256] = {};       // ASCII str.strip() whitespace
  uint8_t code[256];       // base -> 2-bit code, N=4, else 255
  Tables() {
    const char* q =
        "`1234567890-=qwertyuiop[]\\asdfghjkl;'zxcvbnm,./"
        "~!@#$%^&*()_+QWERTYUIOP{}|ASDFGHJKL:\"ZXCVBNM<>?";
    for (const char* p = q; *p; ++p) qual_ok[(uint8_t)*p] = true;
    const char* wsc = " \t\n\r\x0b\x0c";
    for (const char* p = wsc; *p; ++p) ws[(uint8_t)*p] = true;
    for (int c = 0; c < 128; ++c) id_ok[c] = true;
    id_ok[(uint8_t)'\n'] = id_ok[(uint8_t)'\r'] = false;
    id_ok[(uint8_t)'\x0b'] = id_ok[(uint8_t)'\x0c'] = false;
    seq_ok[(uint8_t)'A'] = seq_ok[(uint8_t)'C'] = seq_ok[(uint8_t)'G'] =
        seq_ok[(uint8_t)'T'] = true;
    std::memcpy(base_ok, seq_ok, sizeof(base_ok));
    base_ok[(uint8_t)'N'] = true;
    std::memset(code, 0xFF, sizeof(code));
    code[(uint8_t)'A'] = 0;
    code[(uint8_t)'C'] = 1;
    code[(uint8_t)'G'] = 2;
    code[(uint8_t)'T'] = 3;
    code[(uint8_t)'N'] = 4;
  }
};
const Tables T;

bool split_lines(const uint8_t* d, int64_t n, std::vector<Line>* out) {
  // returns false on non-ascii byte
  int64_t i = 0;
  while (i < n) {
    int64_t s = i;
    const void* nl = std::memchr(d + i, '\n', (size_t)(n - i));
    int64_t e, raw;
    if (nl) {
      raw = (const uint8_t*)nl - d + 1;
      e = raw - 1;
      if (e > s && d[e - 1] == '\r') --e;
    } else {
      raw = e = n;
    }
    out->push_back({s, e, raw});
    i = raw;
  }
  for (int64_t j = 0; j < n; ++j)
    if (d[j] >= 0x80) return false;
  return true;
}

bool all_in(const uint8_t* d, int64_t s, int64_t e, const bool* tbl) {
  for (int64_t i = s; i < e; ++i)
    if (!tbl[d[i]]) return false;
  return true;
}

// strip ASCII whitespace from [s,e) like str.strip()
void strip_span(const uint8_t* d, int64_t* s, int64_t* e) {
  while (*s < *e && T.ws[d[*s]]) ++*s;
  while (*e > *s && T.ws[d[*e - 1]]) --*e;
}

int64_t first_nonws(const uint8_t* d, int64_t s, int64_t e) {
  for (int64_t i = s; i < e; ++i)
    if (!T.ws[d[i]]) return i;
  return -1;
}

// ---------------------------------------------------------------------------
// FASTQ
// ---------------------------------------------------------------------------

// A 4-line group match at line index i (lines must exist).
bool fastq_group_ok(const uint8_t* d, int64_t n, const std::vector<Line>& L,
                    size_t i) {
  if (i + 3 >= L.size()) return false;
  const Line &l0 = L[i], &l1 = L[i + 1], &l2 = L[i + 2], &l3 = L[i + 3];
  if (l0.end <= l0.start || d[l0.start] != '@') return false;
  if (l0.end - l0.start < 2) return false;  // id must be nonempty
  if (!all_in(d, l0.start + 1, l0.end, T.id_ok)) return false;
  {
    // id nonempty after strip? reference: ([\S\t ]+?) needs >=1 char of the
    // class which includes \t and space -- so raw nonempty suffices.
  }
  if (l1.end <= l1.start || !all_in(d, l1.start, l1.end, T.seq_ok))
    return false;
  if (l2.end <= l2.start || d[l2.start] != '+') return false;
  for (int64_t j = l2.start + 1; j < l2.end; ++j)
    if (d[j] != '.') return false;
  if (l3.end <= l3.start || !all_in(d, l3.start, l3.end, T.qual_ok))
    return false;
  // terminator: next line starts with '@', or group is last line with at
  // most one trailing newline (raw_end == n covers both "no newline" and
  // "exactly one newline" because raw_end includes it)
  if (i + 4 < L.size()) {
    const Line& l4 = L[i + 4];
    if (l4.end <= l4.start || d[l4.start] != '@') return false;
  } else {
    if (l3.raw_end != n) return false;  // unreachable: l3 is last line
  }
  return true;
}

}  // namespace

extern "C" int stpu_fastq_scan(const uint8_t* d, int64_t n, int64_t* info) {
  std::vector<Line> L;
  if (!split_lines(d, n, &L)) return NON_ASCII;
  std::unordered_set<std::string> seen;
  std::vector<uint8_t> in_match(L.size(), 0);
  int64_t n_rec = 0, max_len = 0, id_bytes = 0;
  int64_t mismatch_rec = -1, mismatch_aux = 0;
  for (size_t i = 0; i < L.size();) {
    if (fastq_group_ok(d, n, L, i)) {
      int64_t is = L[i].start + 1, ie = L[i].end;
      strip_span(d, &is, &ie);
      std::string id((const char*)d + is, (size_t)(ie - is));
      if (!seen.insert(std::move(id)).second) {
        info[INFO_ERRI] = (int64_t)n_rec;  // duplicate found at this record
        return DUPLICATE_ID;
      }
      int64_t sl = L[i + 1].end - L[i + 1].start;
      int64_t ql = L[i + 3].end - L[i + 3].start;
      if (mismatch_rec < 0 && sl != ql) {
        mismatch_rec = n_rec;
        mismatch_aux = (sl << 28) | ql;
      }
      if (sl > max_len) max_len = sl;
      if (ql > max_len) max_len = ql;
      id_bytes += ie - is;
      in_match[i] = in_match[i + 1] = in_match[i + 2] = in_match[i + 3] = 1;
      ++n_rec;
      i += 4;
    } else {
      ++i;
    }
  }
  if (n_rec == 0) return NO_RECORDS;
  for (size_t i = 0; i < L.size(); ++i) {
    if (in_match[i]) continue;
    int64_t bad = first_nonws(d, L[i].start, L[i].end);
    if (bad >= 0) {
      info[INFO_ERRI] = bad;
      return UNPARSED;
    }
  }
  if (mismatch_rec >= 0) {
    info[INFO_ERRI] = mismatch_rec;
    info[INFO_AUX] = mismatch_aux;
    return LEN_MISMATCH;
  }
  info[INFO_N] = n_rec;
  info[INFO_SIZE] = max_len;
  info[INFO_IDB] = id_bytes;
  return OK;
}

extern "C" int stpu_fastq_fill(const uint8_t* d, int64_t n, uint8_t* codes,
                               uint8_t* qual, int32_t* lengths, int64_t lmax,
                               int64_t* id_offsets, uint8_t* id_buf,
                               int32_t* space_len) {
  std::vector<Line> L;
  if (!split_lines(d, n, &L)) return NON_ASCII;
  int64_t rec = 0, idp = 0;
  id_offsets[0] = 0;
  for (size_t i = 0; i < L.size();) {
    if (fastq_group_ok(d, n, L, i)) {
      int64_t is = L[i].start + 1, ie = L[i].end;
      strip_span(d, &is, &ie);
      std::memcpy(id_buf + idp, d + is, (size_t)(ie - is));
      idp += ie - is;
      id_offsets[rec + 1] = idp;
      const Line& ls = L[i + 1];
      int64_t sl = ls.end - ls.start;
      lengths[rec] = (int32_t)sl;
      uint8_t* crow = codes + rec * lmax;
      for (int64_t j = 0; j < sl; ++j) crow[j] = T.code[d[ls.start + j]];
      const Line& lq = L[i + 3];
      std::memcpy(qual + rec * lmax, d + lq.start,
                  (size_t)(lq.end - lq.start));
      space_len[rec] = (int32_t)(L[i + 2].end - L[i + 2].start - 1);
      ++rec;
      i += 4;
    } else {
      ++i;
    }
  }
  return OK;
}

// ---------------------------------------------------------------------------
// FASTQ streaming fill (chunked): parse/pack overlapped with device compute
// ---------------------------------------------------------------------------
//
// After a successful stpu_fastq_scan (which validates the WHOLE input --
// duplicate ids, unparsed data, length mismatches -- and sizes the output),
// the stream API re-walks the input in record chunks so the Python caller
// can hand each chunk to the accelerator while the next one fills.  Record
// ids are not materialized (the scan already enforced uniqueness); the
// caller uses the scan's n_records/max_len for shapes.

// The stream parses incrementally from a byte cursor -- no up-front
// split_lines pass, no Line vector, no ASCII pre-scan.  The whole-input
// contracts stay enforced by stpu_fastq_scan (run before, or -- in the
// lazy-overlap path -- concurrently on another thread, in which case any
// validation failure discards the streamed results); on scanned-valid
// input the cursor walk visits exactly the scan's 4-line groups.  On
// not-yet-validated input the walk is overrun-safe and terminates (the
// cursor is strictly monotone), which is all the lazy path needs.
struct FastqStream {
  const uint8_t* d;
  int64_t n;
  int64_t pos;  // byte cursor (start of the next unread line)
};

// Advance *pos past one line; [*s, *e) is the content span (\r?\n
// excluded).  Returns false at end of input.
inline bool next_line(const uint8_t* d, int64_t n, int64_t* pos, int64_t* s,
                      int64_t* e) {
  if (*pos >= n) return false;
  *s = *pos;
  const void* nl = std::memchr(d + *pos, '\n', (size_t)(n - *pos));
  int64_t end, raw;
  if (nl) {
    raw = (const uint8_t*)nl - d + 1;
    end = raw - 1;
    if (end > *s && d[end - 1] == '\r') --end;
  } else {
    raw = end = n;
  }
  *e = end;
  *pos = raw;
  return true;
}

extern "C" void* stpu_fastq_stream_open(const uint8_t* d, int64_t n) {
  return new FastqStream{d, n, 0};
}

namespace {

// Pull the next 4-line record group starting at the cursor.  Mirrors the
// scan's resync rule cheaply: a line that does not open a group ('@'
// head + '+' third line) is skipped and scanning resumes at the next
// line.  Full per-character class validation is NOT repeated here -- the
// scan owns it; on scanned-valid input every line opens a group exactly
// where the scan matched one.
inline bool next_group(const uint8_t* d, int64_t n, int64_t* pos, Line* seq,
                       Line* qual) {
  int64_t l0s, l0e;
  while (next_line(d, n, pos, &l0s, &l0e)) {
    if (l0e <= l0s || d[l0s] != '@') continue;
    const int64_t resync = *pos;  // next line after the '@' head
    int64_t s1, e1, s2, e2, s3, e3;
    if (!next_line(d, n, pos, &s1, &e1) || !next_line(d, n, pos, &s2, &e2) ||
        !next_line(d, n, pos, &s3, &e3)) {
      *pos = n;
      return false;
    }
    if (e2 <= s2 || d[s2] != '+') {
      *pos = resync;
      continue;
    }
    seq->start = s1;
    seq->end = e1;
    qual->start = s3;
    qual->end = e3;
    return true;
  }
  return false;
}

}  // namespace

// Fill up to max_records records into row-major [max_records, lmax] buffers.
// Returns the number of records written (0 at end of input), or -1 when a
// record exceeds lmax -- the same LmaxExceeded contract as the packed
// variant, so lazy callers whose lmax is a first-record guess can retry at
// a wider stride instead of silently receiving truncated sequences
// (ADVICE.md r3 #3).
extern "C" int64_t stpu_fastq_stream_next(void* handle, int64_t max_records,
                                          uint8_t* codes, uint8_t* qual,
                                          int32_t* lengths, int64_t lmax) {
  auto* s = (FastqStream*)handle;
  const uint8_t* d = s->d;
  Line ls, lq;
  int64_t rec = 0;
  while (rec < max_records && next_group(d, s->n, &s->pos, &ls, &lq)) {
    int64_t sl = ls.end - ls.start;
    int64_t ql = lq.end - lq.start;
    if (sl > lmax || ql > lmax) return -1;
    lengths[rec] = (int32_t)sl;
    uint8_t* crow = codes + rec * lmax;
    for (int64_t j = 0; j < sl; ++j) crow[j] = T.code[d[ls.start + j]];
    std::memcpy(qual + rec * lmax, d + lq.start, (size_t)ql);
    ++rec;
  }
  return rec;
}

// Packed variant: codes are written 2-bit packed (4 bases/byte, little
// bit-pairs -- the layout of shotgun_tpu.ops.encode.pack_codes_2bit) into
// row-major [max_records, lmax/4] buffers, and the quality plane is
// OPTIONAL (pass qual == nullptr when no quality gate consumes it).  This
// is the transfer-diet fill: the accelerator unpacks on device, so the
// host never materializes the 1-byte-per-base plane at all.
//
// Unlike stpu_fastq_stream_next, this fill is SAFE on unvalidated input
// (the lazy-scan overlap path runs it concurrently with the validating
// scan): a record longer than lmax returns -1 instead of overrunning the
// row, and the caller restarts with a bigger stride.
extern "C" int64_t stpu_fastq_stream_next_packed(
    void* handle, int64_t max_records, uint8_t* codes_packed, uint8_t* qual,
    int32_t* lengths, int64_t lmax) {
  auto* s = (FastqStream*)handle;
  const uint8_t* d = s->d;
  const int64_t stride = lmax / 4;
  Line ls, lq;
  int64_t rec = 0;
  while (rec < max_records && next_group(d, s->n, &s->pos, &ls, &lq)) {
    int64_t sl = ls.end - ls.start;
    int64_t ql = lq.end - lq.start;
    if (sl > lmax || ql > lmax) return -1;
    lengths[rec] = (int32_t)sl;
    uint8_t* crow = codes_packed + rec * stride;
    const uint8_t* src = d + ls.start;
    int64_t j = 0;
    for (; j + 4 <= sl; j += 4) {
      crow[j >> 2] = (uint8_t)(T.code[src[j]] | (T.code[src[j + 1]] << 2) |
                               (T.code[src[j + 2]] << 4) |
                               (T.code[src[j + 3]] << 6));
    }
    if (j < sl) {
      uint8_t acc = 0;
      for (int64_t t = 0; j + t < sl; ++t)
        acc |= (uint8_t)(T.code[src[j + t]] << (2 * t));
      crow[j >> 2] = acc;
    }
    if (qual)
      std::memcpy(qual + rec * lmax, d + lq.start, (size_t)ql);
    ++rec;
  }
  return rec;
}

extern "C" void stpu_fastq_stream_close(void* handle) {
  delete (FastqStream*)handle;
}

// ---------------------------------------------------------------------------
// Validating packed stream: the whole-input contract (structure, character
// classes, duplicate ids, length equality, unparsed data) is enforced IN
// the fill pass itself, so lazy callers need no separate whole-input scan
// thread.  Detection is complete but statuses are advisory: ANY nonzero
// status makes the Python caller rerun the input through the regex engine,
// which raises the reference's exact error type and message
// (io/data_file.py).
//
// Two phases per chunk, each on up to n_threads threads:
//   1. structure walk -- line splitting, '@' header + id class, '+'
//      separator dots, terminator lookahead, length equality,
//      whitespace-only junk lines, each id's hash.  A chunk of at least
//      kSplitMin records, with the bytes of kSplitMin records (at the
//      stream's bytes a record so far) left to walk, is cut into byte
//      ranges, one a thread, each starting at a record head, and the
//      ranges are walked at once; smaller chunks are walked on one thread;
//   2. duplicate ids, in a set sharded by hash bits (each shard filled by
//      one thread, in walk order), and the encode -- per-record 2-bit seq
//      pack (a non-ACGT byte flags UNPARSED) and quality-class validation
//      (+ optional copy) over independent output rows.
//
// Every call returns what the serial walk returns.  The walk is a function
// of the cursor alone, so a range that starts where the serial walk has a
// record boundary walks on as the serial walk would.  Range t + 1 starts
// at a line that opens with '@' and whose second-next line opens with '+':
// in valid input exactly the records' '@' lines (a quality line that opens
// with '@' has a sequence line two lines on).  Range t's records are kept
// only when the ranges before it each ended exactly where the next began;
// where one did not (only in invalid input), or the ranges held too few
// records, the rest of the chunk is walked serially from where the last
// kept range stopped.  Records walked past the chunk's size are dropped
// and walked again in the next chunk.
// ---------------------------------------------------------------------------

#include <algorithm>
#include <thread>

namespace {

// the fill's thread cap, and the chunk size (records) below which a phase
// runs on one thread
constexpr int kMaxThreads = 8;
constexpr int64_t kSplitMin = 4096;
// the duplicate-id set's shards, by the top bits of an id's hash: a fixed
// count, so the thread count may change from chunk to chunk (thread u of
// nt fills the shards s with s % nt == u)
constexpr int kShardBits = 6, kShards = 1 << kShardBits;
// a walk's fault for a record wider than lmax (the call returns -1)
constexpr int LMAX_EXCEEDED = -1;

// what one thread writes on its own: a cache line pair of its own, so
// threads that write side by side do not share a line
constexpr size_t kOwnLines = 128;

// Zero-allocation duplicate-id set: open addressing over (hash, span)
// entries pointing back into the input buffer -- the std::string-per-id
// of the scan's unordered_set dominated the validating fill's walk.
struct alignas(kOwnLines) IdSpanSet {
  struct Entry {
    uint64_t hash = 0;
    int64_t start = -1;
    int32_t len = 0;
  };
  std::vector<Entry> slots;
  size_t count = 0;
  const uint8_t* base = nullptr;

  static uint64_t hash_bytes(const uint8_t* p, int64_t len) {
    uint64_t h = 1469598103934665603ull;  // FNV-1a 64
    for (int64_t i = 0; i < len; ++i) {
      h ^= p[i];
      h *= 1099511628211ull;
    }
    return h | 1;  // nonzero
  }

  void grow() {
    size_t cap = slots.empty() ? 4096 : slots.size() * 2;
    std::vector<Entry> ns(cap);
    for (const Entry& e : slots) {
      if (e.start < 0) continue;
      size_t j = (size_t)e.hash & (cap - 1);
      while (ns[j].start >= 0) j = (j + 1) & (cap - 1);
      ns[j] = e;
    }
    slots.swap(ns);
  }

  // h = hash_bytes of the id; returns false if the id was already present
  bool insert(uint64_t h, int64_t start, int64_t len) {
    if (slots.empty() || count * 10 >= slots.size() * 7) grow();
    size_t mask = slots.size() - 1;
    size_t j = (size_t)h & mask;
    while (slots[j].start >= 0) {
      if (slots[j].hash == h && slots[j].len == (int32_t)len &&
          std::memcmp(base + slots[j].start, base + start, (size_t)len) == 0)
        return false;
      j = (j + 1) & mask;
    }
    slots[j] = {h, start, (int32_t)len};
    ++count;
    return true;
  }
};

// A record the walk accepted: byte offsets into the input.
struct Rec {
  int64_t head;       // its '@' line
  int64_t seq, qual;  // its sequence and quality lines
  int64_t end;        // one past its quality line: the next record's head
  int64_t id;         // its id, stripped
  int32_t len, id_len;
};

// One walk: the records it accepted, each id's hash, where the cursor
// stopped, and the fault (OK, UNPARSED, LEN_MISMATCH or LMAX_EXCEEDED) of
// the record after the last one accepted.
struct alignas(kOwnLines) Walk {
  std::vector<Rec> recs;
  std::vector<uint64_t> hash;
  int64_t pos = 0;
  int fault = OK;
};

// The serial walk from byte `pos` while the cursor is before `end` and
// fewer than `cap` records are accepted: each record's structure, stride
// and length equality.
void walk_records(const uint8_t* d, int64_t n, int64_t pos, int64_t end,
                  int64_t cap, int64_t lmax, Walk* w) {
  w->recs.clear();
  w->hash.clear();
  w->fault = OK;
  int64_t l0s, l0e;
  while ((int64_t)w->recs.size() < cap && pos < end &&
         next_line(d, n, &pos, &l0s, &l0e)) {
    // empty/whitespace line tolerance applies only BEFORE the first
    // group: between groups the terminator check below (next line must
    // open with '@') fires first, so blank separator lines are UNPARSED
    // -- matching the regex engine (ADVICE.md r4 #4)
    if (l0e <= l0s) continue;
    if (d[l0s] != '@') {
      // not a group head: the scan leaves it unmatched, so it must be
      // whitespace-only (UnparsedDataError otherwise)
      if (first_nonws(d, l0s, l0e) >= 0) {
        w->fault = UNPARSED;
        break;
      }
      continue;
    }
    // '@' head: in a valid input this ALWAYS opens a group (quality
    // lines that start with '@' are consumed as part of their group and
    // never reach here)
    if (l0e - l0s < 2 || !all_in(d, l0s + 1, l0e, T.id_ok)) {
      w->fault = UNPARSED;
      break;
    }
    int64_t s1, e1, s2, e2, s3, e3;
    if (!next_line(d, n, &pos, &s1, &e1) || !next_line(d, n, &pos, &s2, &e2) ||
        !next_line(d, n, &pos, &s3, &e3)) {
      w->fault = UNPARSED;  // truncated group
      break;
    }
    if (e1 <= s1 || e2 <= s2 || d[s2] != '+' || e3 <= s3) {
      w->fault = UNPARSED;
      break;
    }
    bool dots = true;
    for (int64_t j = s2 + 1; j < e2; ++j) dots &= (d[j] == '.');
    // terminator: next line must open with '@', or this group ends the
    // input with at most one trailing newline (pos == n covers both)
    if (!dots || (pos < n && d[pos] != '@')) {
      w->fault = UNPARSED;
      break;
    }
    int64_t sl = e1 - s1, ql = e3 - s3;
    if (sl > lmax || ql > lmax) {
      w->fault = LMAX_EXCEEDED;
      break;
    }
    if (sl != ql) {
      w->fault = LEN_MISMATCH;
      break;
    }
    int64_t is = l0s + 1, ie = l0e;
    strip_span(d, &is, &ie);
    w->recs.push_back({l0s, s1, s3, pos, is, (int32_t)sl, (int32_t)(ie - is)});
    w->hash.push_back(IdSpanSet::hash_bytes(d + is, ie - is));
  }
  w->pos = pos;
}

// The first record head at or after byte p, else n: the start of a line
// that opens with '@' and whose second-next line opens with '+'.
int64_t next_head(const uint8_t* d, int64_t n, int64_t p) {
  if (p > 0 && p < n && d[p - 1] != '\n') {
    const void* nl = std::memchr(d + p, '\n', (size_t)(n - p));
    p = nl ? (const uint8_t*)nl - d + 1 : n;
  }
  while (p < n) {
    int64_t q = p, s0, e0, s, e;
    next_line(d, n, &q, &s0, &e0);
    const int64_t next = q;
    if (e0 > s0 && d[s0] == '@' && next_line(d, n, &q, &s, &e) &&
        next_line(d, n, &q, &s, &e) && e > s && d[s] == '+')
      return p;
    p = next;
  }
  return n;
}

// Phase 2's per-record work: the 2-bit pack into crow, and the quality
// check and copy into qrow (none when null).  True when a byte is out of
// class: a base other than ACGT, or a quality byte outside PHRED33.
bool encode_record(const uint8_t* d, const Rec& r, uint8_t* crow,
                   uint8_t* qrow) {
  const uint8_t* src = d + r.seq;
  const int64_t sl = r.len;
  uint8_t ored = 0;
  int64_t j = 0;
  for (; j + 4 <= sl; j += 4) {
    uint8_t c0 = T.code[src[j]], c1 = T.code[src[j + 1]];
    uint8_t c2 = T.code[src[j + 2]], c3 = T.code[src[j + 3]];
    ored |= c0 | c1 | c2 | c3;
    crow[j >> 2] = (uint8_t)(c0 | (c1 << 2) | (c2 << 4) | (c3 << 6));
  }
  if (j < sl) {
    uint8_t acc = 0;
    for (int64_t t = 0; j + t < sl; ++t) {
      uint8_t c = T.code[src[j + t]];
      ored |= c;
      acc |= (uint8_t)(c << (2 * t));
    }
    crow[j >> 2] = acc;
  }
  // any non-ACGT byte has code >= 4 (N or 255): reads reject N too
  bool bad = (ored & 0xFC) != 0;
  const uint8_t* qsrc = d + r.qual;
  if (qrow) {
    for (int64_t t = 0; t < sl; ++t) {
      bad |= !T.qual_ok[qsrc[t]];
      qrow[t] = qsrc[t];
    }
  } else {
    for (int64_t t = 0; t < sl; ++t) bad |= !T.qual_ok[qsrc[t]];
  }
  return bad;
}

// Calls fn(0) .. fn(nt - 1) at once, fn(0) on the calling thread, and
// returns when every call has returned.  Two such runs a chunk spawn their
// threads anew: on 8 cores a pool kept across chunks filled no faster.
template <class F>
void run_threads(int nt, const F& fn) {
  std::vector<std::thread> ts;
  for (int t = 1; t < nt; ++t) ts.emplace_back([&fn, t] { fn(t); });
  fn(0);
  for (auto& t : ts) t.join();
}

// The kept records of one walk: walk->recs[0, count) are chunk rows
// [row, row + count).
struct Part {
  const Walk* walk;
  int64_t row, count;
};

// The first chunk row, in walk order, whose id the stream already holds,
// among the shards s with s % nt == u (filled here, by this thread alone);
// INT64_MAX if none.
int64_t first_duplicate(IdSpanSet* shards, const std::vector<Part>& parts,
                        int u, int nt) {
  for (const Part& p : parts) {
    for (int64_t i = 0; i < p.count; ++i) {
      const uint64_t h = p.walk->hash[(size_t)i];
      const int sh = (int)(h >> (64 - kShardBits));
      if (sh % nt != u) continue;
      const Rec& r = p.walk->recs[(size_t)i];
      if (!shards[sh].insert(h, r.id, r.id_len)) return p.row + i;
    }
  }
  return INT64_MAX;
}

struct VFastqStream {
  const uint8_t* d;
  int64_t n;
  int64_t pos;
  IdSpanSet seen[kShards];  // every id of the stream so far
  int64_t n_rec = 0;
  int64_t max_len = 0;
  int64_t first_head = -1;  // the first record's '@' line
  int status = OK;          // sticky; advisory (see header comment)
  bool eof = false;
  int ranges = 0;  // the last chunk's walk: its ranges, 1 on one thread
  std::vector<Walk> walks;  // reused across chunks
};

}  // namespace

extern "C" void* stpu_fastq_vstream_open(const uint8_t* d, int64_t n) {
  auto* s = new VFastqStream;
  s->d = d;
  s->n = n;
  s->pos = 0;
  for (IdSpanSet& set : s->seen) set.base = d;
  return s;
}

extern "C" int stpu_fastq_vstream_status(void* handle) {
  auto* s = (VFastqStream*)handle;
  if (s->status != OK) return s->status;
  if (s->eof && s->n_rec == 0) return NO_RECORDS;
  return OK;
}

extern "C" int64_t stpu_fastq_vstream_nrec(void* handle) {
  return ((VFastqStream*)handle)->n_rec;
}

extern "C" int64_t stpu_fastq_vstream_maxlen(void* handle) {
  return ((VFastqStream*)handle)->max_len;
}

extern "C" int stpu_fastq_vstream_ranges(void* handle) {
  return ((VFastqStream*)handle)->ranges;
}

extern "C" void stpu_fastq_vstream_close(void* handle) {
  delete (VFastqStream*)handle;
}

// Returns records written (0 at end of input), -1 when a record exceeds
// lmax (caller restarts wider -- the handle must be reopened), or -2 on a
// validation failure (sticky status readable via vstream_status).
extern "C" int64_t stpu_fastq_vstream_next_packed(
    void* handle, int64_t max_records, uint8_t* codes_packed, uint8_t* qual,
    int32_t* lengths, int64_t lmax, int64_t n_threads) {
  auto* s = (VFastqStream*)handle;
  if (s->status != OK) return -2;
  const uint8_t* d = s->d;
  const int64_t n = s->n;
  const int64_t stride = lmax / 4;
  const int nt = (int)std::min<int64_t>(std::max<int64_t>(n_threads, 1),
                                        kMaxThreads);
  if ((int)s->walks.size() < nt + 2) s->walks.resize(nt + 2);

  // ---- phase 1: the structure walk ----
  std::vector<Part> parts;
  int64_t rec = 0, pos = s->pos;
  int fault = OK;
  // keep w's records up to the chunk's size; true once that decides the
  // chunk: full, or the serial walk's fault reached
  auto keep = [&](const Walk& w) {
    const int64_t k = std::max<int64_t>(
        std::min((int64_t)w.recs.size(), max_records - rec), 0);
    if (k > 0) parts.push_back({&w, rec, k});
    rec += k;
    if (k > 0 && rec == max_records) {
      pos = w.recs[(size_t)k - 1].end;
      return true;
    }
    pos = w.pos;
    fault = w.fault;
    return fault != OK;
  };
  bool decided = false;
  s->ranges = 1;
  if (nt > 1 && max_records >= kSplitMin) {
    int64_t bpr = 0;  // bytes a record so far; the first record sizes it
    if (s->n_rec > 0) {
      bpr = (s->pos - s->first_head) / s->n_rec;
    } else {
      Walk& w = s->walks[0];
      walk_records(d, n, pos, n, 1, lmax, &w);
      decided = keep(w);
      if (!w.recs.empty()) bpr = w.recs[0].end - w.recs[0].head;
    }
    if (!decided && bpr > 0 && n - pos >= kSplitMin * bpr) {
      // a window expected to hold the chunk's other records, 1/64 over
      const int64_t need = max_records - rec;
      const int64_t span = need * bpr + need * bpr / 64 + bpr;
      const int64_t win_end = span >= n - pos ? n : pos + span;
      std::vector<int64_t> starts(nt + 1, pos);
      for (int t = 1; t <= nt; ++t)
        starts[t] = next_head(
            d, n, std::max(pos + (win_end - pos) * t / nt, starts[t - 1]));
      run_threads(nt, [&](int t) {
        walk_records(d, n, starts[t], starts[t + 1], max_records, lmax,
                     &s->walks[1 + t]);
      });
      s->ranges = nt;
      for (int t = 0; t < nt && !decided; ++t) {
        decided = keep(s->walks[1 + t]);
        if (pos != starts[t + 1]) break;  // not abutting: walk on serially
      }
    }
  }
  if (!decided) {
    Walk& w = s->walks[nt + 1];
    walk_records(d, n, pos, n, max_records - rec, lmax, &w);
    keep(w);
  }
  if (fault == OK) {
    s->pos = pos;
    if (pos >= n) s->eof = true;
    if (rec == 0) return 0;
  }

  // ---- phase 2: duplicate ids, and the encode when the walk passed ----
  // (a duplicate comes first: the serial walk checks each record's id
  // before it walks the next record)
  const int nt2 = rec < kSplitMin ? 1 : nt;
  int64_t dup[kMaxThreads], longest[kMaxThreads];
  bool bad[kMaxThreads];
  run_threads(nt2, [&](int u) {
    dup[u] = first_duplicate(s->seen, parts, u, nt2);
    bool w_bad = false;
    int64_t w_longest = 0;
    const int64_t per = (rec + nt2 - 1) / nt2;
    const int64_t lo = u * per, hi = std::min(rec, lo + per);
    for (const Part& p : parts) {
      if (fault != OK) break;
      for (int64_t r = std::max(lo, p.row); r < std::min(hi, p.row + p.count);
           ++r) {
        const Rec& x = p.walk->recs[(size_t)(r - p.row)];
        lengths[r] = x.len;
        w_longest = std::max(w_longest, (int64_t)x.len);
        w_bad |= encode_record(d, x, codes_packed + r * stride,
                               qual ? qual + r * lmax : nullptr);
      }
    }
    bad[u] = w_bad;
    longest[u] = w_longest;
  });
  if (*std::min_element(dup, dup + nt2) != INT64_MAX) {
    s->status = DUPLICATE_ID;
    return -2;
  }
  if (fault == LMAX_EXCEEDED) return -1;
  if (fault != OK) {
    s->status = fault;
    return -2;
  }
  if (std::any_of(bad, bad + nt2, [](bool b) { return b; })) {
    s->status = UNPARSED;
    return -2;
  }
  if (s->n_rec == 0) s->first_head = parts[0].walk->recs[0].head;
  s->n_rec += rec;
  s->max_len = std::max(s->max_len, *std::max_element(longest, longest + nt2));
  return rec;
}

// ---------------------------------------------------------------------------
// FASTA
// ---------------------------------------------------------------------------

struct FastaGroup {
  size_t header;      // line index
  size_t body_first;  // first body line index
  size_t body_last;   // last body line index (inclusive); header if none
  bool valid;
};

// find the group starting at header line i; j_out = next scan line
FastaGroup fasta_group_at(const uint8_t* d, int64_t n,
                          const std::vector<Line>& L, size_t i,
                          size_t* j_out) {
  FastaGroup g{i, i + 1, i, false};
  const Line& h = L[i];
  size_t j = i + 1;
  while (j < L.size() && !(L[j].end > L[j].start && d[L[j].start] == '>'))
    ++j;
  *j_out = j;
  if (h.end <= h.start || d[h.start] != '>') return g;
  if (h.end - h.start < 2) return g;  // description needs >= 1 char
  if (!all_in(d, h.start + 1, h.end, T.id_ok)) return g;
  // body region: from after header newline to the newline before line j
  // (or EOF minus at most one trailing newline)
  int64_t body_begin = h.raw_end;
  int64_t body_end;
  if (j < L.size()) {
    const Line& prev = L[j - 1];
    body_end = prev.end;  // excludes the newline separating from '>'
    // inner newlines of earlier body lines are inside [begin, end) and are
    // legal whitespace
  } else {
    // at EOF the lazy body may stop anywhere the remainder matches
    // (\r?\n)?\Z -- newlines are legal body chars, so validity reduces to
    // "the whole tail is in-class and nonempty" (e.g. ">g\n\n" parses with
    // an empty cleaned genome)
    body_end = n;
  }
  if (body_end <= body_begin) return g;  // empty region -> no match
  for (int64_t x = body_begin; x < body_end; ++x) {
    uint8_t c = d[x];
    if (!T.base_ok[c] && !T.ws[c]) return g;
  }
  g.body_first = i + 1;
  g.body_last = j - 1;
  g.valid = true;
  return g;
}

extern "C" int stpu_fasta_scan(const uint8_t* d, int64_t n, int64_t* info) {
  std::vector<Line> L;
  if (!split_lines(d, n, &L)) return NON_ASCII;
  std::vector<uint8_t> in_match(L.size(), 0);
  int64_t n_rec = 0, total_bases = 0, desc_bytes = 0;
  for (size_t i = 0; i < L.size();) {
    size_t j;
    FastaGroup g = fasta_group_at(d, n, L, i, &j);
    if (g.valid) {
      for (size_t x = g.header; x <= g.body_last; ++x) in_match[x] = 1;
      int64_t ds = L[i].start + 1, de = L[i].end;
      strip_span(d, &ds, &de);
      desc_bytes += de - ds;
      for (size_t x = g.body_first; x <= g.body_last; ++x)
        for (int64_t y = L[x].start; y < L[x].end; ++y)
          if (T.base_ok[d[y]]) ++total_bases;
      ++n_rec;
      i = j;
    } else {
      ++i;
    }
  }
  if (n_rec == 0) return NO_RECORDS;
  for (size_t i = 0; i < L.size(); ++i) {
    if (in_match[i]) continue;
    int64_t bad = first_nonws(d, L[i].start, L[i].end);
    if (bad >= 0) {
      info[INFO_ERRI] = bad;
      return UNPARSED;
    }
  }
  info[INFO_N] = n_rec;
  info[INFO_SIZE] = total_bases;
  info[INFO_IDB] = desc_bytes;
  return OK;
}

extern "C" int stpu_fasta_fill(const uint8_t* d, int64_t n, uint8_t* codes,
                               int64_t* seq_offsets, int64_t* desc_offsets,
                               uint8_t* desc_buf) {
  std::vector<Line> L;
  if (!split_lines(d, n, &L)) return NON_ASCII;
  int64_t rec = 0, cp = 0, dp = 0;
  seq_offsets[0] = 0;
  desc_offsets[0] = 0;
  for (size_t i = 0; i < L.size();) {
    size_t j;
    FastaGroup g = fasta_group_at(d, n, L, i, &j);
    if (g.valid) {
      int64_t ds = L[i].start + 1, de = L[i].end;
      strip_span(d, &ds, &de);
      std::memcpy(desc_buf + dp, d + ds, (size_t)(de - ds));
      dp += de - ds;
      desc_offsets[rec + 1] = dp;
      for (size_t x = g.body_first; x <= g.body_last; ++x)
        for (int64_t y = L[x].start; y < L[x].end; ++y) {
          uint8_t c = T.code[d[y]];
          if (c != 0xFF) codes[cp++] = c;
        }
      seq_offsets[rec + 1] = cp;
      ++rec;
      i = j;
    } else {
      ++i;
    }
  }
  return OK;
}

// ---------------------------------------------------------------------------
// Id-span extraction for the streamed align-task path: on a
// SCAN-VALIDATED input, walk the 4-line groups and emit each record's
// stripped identifier bytes.  The caller sizes id_offsets to the known
// record count + 1 and id_buf conservatively (total id bytes < n).
// Returns the record count walked (== the scan's n_records on valid
// input), or -1 if more than max_records groups appear.
// ---------------------------------------------------------------------------
extern "C" int64_t stpu_fastq_ids(const uint8_t* d, int64_t n,
                                  int64_t max_records, int64_t* id_offsets,
                                  uint8_t* id_buf) {
  int64_t pos = 0, s, e, rec = 0, idp = 0;
  id_offsets[0] = 0;
  while (next_line(d, n, &pos, &s, &e)) {
    if (e <= s || d[s] != '@') continue;  // leading blanks on valid input
    if (rec >= max_records) return -1;
    int64_t is = s + 1, ie = e;
    strip_span(d, &is, &ie);
    std::memcpy(id_buf + idp, d + is, (size_t)(ie - is));
    idp += ie - is;
    ++rec;
    id_offsets[rec] = idp;
    int64_t s2, e2;  // consume seq, '+', quality lines of the group
    next_line(d, n, &pos, &s2, &e2);
    next_line(d, n, &pos, &s2, &e2);
    next_line(d, n, &pos, &s2, &e2);
  }
  return rec;
}
