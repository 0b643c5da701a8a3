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
// thread -- on a 2-core host the scan pass used to burn the second core
// that the (parallel) encode phase now uses.  Detection is complete but
// statuses are advisory: ANY nonzero status makes the Python caller rerun
// the input through the regex engine, which raises the reference's exact
// error type and message (io/data_file.py).
//
// Two phases per chunk:
//   1. sequential structure walk -- line splitting, '@' header + id class,
//      '+' separator dots, terminator lookahead, duplicate-id hash set,
//      length equality, whitespace-only junk lines;
//   2. parallel encode -- per-record 2-bit seq pack (a non-ACGT byte
//      flags UNPARSED) and quality-class validation (+ optional copy),
//      split across worker threads over independent output rows.
// ---------------------------------------------------------------------------

#include <atomic>
#include <thread>

namespace {

// Zero-allocation duplicate-id set: open addressing over (hash, span)
// entries pointing back into the input buffer -- the std::string-per-id
// of the scan's unordered_set dominated the sequential phase of the
// validating fill.
struct IdSpanSet {
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

  // returns false if the id was already present
  bool insert(int64_t start, int64_t len) {
    if (slots.empty() || count * 10 >= slots.size() * 7) grow();
    uint64_t h = hash_bytes(base + start, len);
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

struct VFastqStream {
  const uint8_t* d;
  int64_t n;
  int64_t pos;
  IdSpanSet seen;
  int64_t n_rec = 0;
  int64_t max_len = 0;
  int status = OK;  // sticky; advisory (see header comment)
  bool eof = false;
  // phase-1 scratch, reused across chunks
  std::vector<int64_t> seq_s, qual_s;
  std::vector<int32_t> lens;
};

}  // namespace

extern "C" void* stpu_fastq_vstream_open(const uint8_t* d, int64_t n) {
  auto* s = new VFastqStream;
  s->d = d;
  s->n = n;
  s->pos = 0;
  s->seen.base = d;
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

  s->seq_s.clear();
  s->qual_s.clear();
  s->lens.clear();

  // ---- phase 1: sequential structure walk ----
  int64_t rec = 0;
  int64_t l0s, l0e;
  while (rec < max_records && next_line(d, n, &s->pos, &l0s, &l0e)) {
    // empty/whitespace line tolerance applies only BEFORE the first
    // group: between groups the terminator check below (next line must
    // open with '@') fires first, so blank separator lines are UNPARSED
    // -- matching the regex engine (ADVICE.md r4 #4)
    if (l0e <= l0s) continue;
    if (d[l0s] != '@') {
      // not a group head: the scan leaves it unmatched, so it must be
      // whitespace-only (UnparsedDataError otherwise)
      if (first_nonws(d, l0s, l0e) >= 0) {
        s->status = UNPARSED;
        return -2;
      }
      continue;
    }
    // '@' head: in a valid input this ALWAYS opens a group (quality
    // lines that start with '@' are consumed as part of their group and
    // never reach here)
    if (l0e - l0s < 2 || !all_in(d, l0s + 1, l0e, T.id_ok)) {
      s->status = UNPARSED;
      return -2;
    }
    int64_t s1, e1, s2, e2, s3, e3;
    if (!next_line(d, n, &s->pos, &s1, &e1) ||
        !next_line(d, n, &s->pos, &s2, &e2) ||
        !next_line(d, n, &s->pos, &s3, &e3)) {
      s->status = UNPARSED;  // truncated group
      return -2;
    }
    if (e1 <= s1 || e2 <= s2 || d[s2] != '+' || e3 <= s3) {
      s->status = UNPARSED;
      return -2;
    }
    bool dots = true;
    for (int64_t j = s2 + 1; j < e2; ++j) dots &= (d[j] == '.');
    if (!dots) {
      s->status = UNPARSED;
      return -2;
    }
    // terminator: next line must open with '@', or this group ends the
    // input with at most one trailing newline (s->pos == n covers both)
    if (s->pos < n && d[s->pos] != '@') {
      s->status = UNPARSED;
      return -2;
    }
    int64_t sl = e1 - s1, ql = e3 - s3;
    if (sl > lmax || ql > lmax) return -1;
    if (sl != ql) {
      s->status = LEN_MISMATCH;
      return -2;
    }
    int64_t is = l0s + 1, ie = l0e;
    strip_span(d, &is, &ie);
    if (!s->seen.insert(is, ie - is)) {
      s->status = DUPLICATE_ID;
      return -2;
    }
    if (sl > s->max_len) s->max_len = sl;
    s->seq_s.push_back(s1);
    s->qual_s.push_back(s3);
    s->lens.push_back((int32_t)sl);
    lengths[rec] = (int32_t)sl;
    ++rec;
  }
  if (s->pos >= n) s->eof = true;
  if (rec == 0) return 0;
  s->n_rec += rec;

  // ---- phase 2: parallel encode + charclass validation ----
  std::atomic<int> bad{0};
  auto worker = [&](int64_t lo, int64_t hi) {
    bool w_bad = false;
    for (int64_t r = lo; r < hi; ++r) {
      const uint8_t* src = d + s->seq_s[(size_t)r];
      const int64_t sl = s->lens[(size_t)r];
      uint8_t* crow = codes_packed + r * stride;
      uint8_t ored = 0;
      int64_t j = 0;
      for (; j + 4 <= sl; j += 4) {
        uint8_t c0 = T.code[src[j]], c1 = T.code[src[j + 1]];
        uint8_t c2 = T.code[src[j + 2]], c3 = T.code[src[j + 3]];
        ored |= c0 | c1 | c2 | c3;
        crow[j >> 2] =
            (uint8_t)(c0 | (c1 << 2) | (c2 << 4) | (c3 << 6));
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
      w_bad |= (ored & 0xFC) != 0;
      const uint8_t* qsrc = d + s->qual_s[(size_t)r];
      if (qual) {
        uint8_t* qrow = qual + r * lmax;
        for (int64_t t = 0; t < sl; ++t) {
          w_bad |= !T.qual_ok[qsrc[t]];
          qrow[t] = qsrc[t];
        }
      } else {
        for (int64_t t = 0; t < sl; ++t) w_bad |= !T.qual_ok[qsrc[t]];
      }
    }
    if (w_bad) bad.store(1, std::memory_order_relaxed);
  };
  int64_t nt = n_threads < 1 ? 1 : (n_threads > 8 ? 8 : n_threads);
  if (rec < 4096) nt = 1;
  if (nt == 1) {
    worker(0, rec);
  } else {
    std::vector<std::thread> ts;
    int64_t per = (rec + nt - 1) / nt;
    for (int64_t t = 0; t < nt; ++t) {
      int64_t lo = t * per, hi = lo + per > rec ? rec : lo + per;
      if (lo >= hi) break;
      ts.emplace_back(worker, lo, hi);
    }
    for (auto& t : ts) t.join();
  }
  if (bad.load()) {
    s->status = UNPARSED;
    return -2;
  }
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
