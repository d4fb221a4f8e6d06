// Native host-side data loader: FASTA/FASTQ record framing + 2-bit packing.
//
// The port's own copy of kmer_mapper_tpu/native/kmer_host.cpp (the code is
// identical; tests hold both loaders' buffers equal). The counterpart of the
// reference's native IO stack (ISA-L igzip + bionumpy's vectorized record
// framing, kmer_mapper/util.py:78-101): a single pass over decompressed bytes
// frames complete records, encodes ACGTN (N->A, matching the reference's N
// substitution at command_line_interface.py:40-41), counts invalid bases,
// packs 16 bases per uint32 word, and emits one fixed-shape host buffer per
// call (the shapes the device step takes). Partial trailing records are left
// unconsumed for the caller to carry into the next block (the reference's
// "prepend mode" semantics, util.py:99-100).
//
// Reads longer than min(65535, max_bases) are split into segments overlapping
// by k-1 bases (exact k-mer window preservation); a record whose segments do
// not all fit the current buffer resumes in the next one via
// `resume_bases`/`Out::next_resume` (so whole-chromosome FASTA records stream
// through fixed-size buffers).
//
// Build: g++ -O3 -march=native -shared -fPIC into kmer_mapper_tpu_torch/_build
// (see io/native.py). C ABI only.

#include <cstdint>
#include <cstring>

#include <vector>

#if defined(__SSSE3__)
#include <immintrin.h>
#define KMH_SIMD 1
#endif

namespace {

struct CodeTable {
  uint8_t code[256];
  uint8_t invalid[256];
  CodeTable() {
    for (int i = 0; i < 256; ++i) { code[i] = 0; invalid[i] = 1; }
    auto set = [&](char c, uint8_t v) {
      code[(uint8_t)c] = v; invalid[(uint8_t)c] = 0;
      code[(uint8_t)(c + 32)] = v; invalid[(uint8_t)(c + 32)] = 0;  // lowercase
    };
    set('A', 0); set('C', 1); set('G', 2); set('T', 3);
    set('N', 0);  // N -> A, counted as valid (reference substitutes N->A)
  }
};
const CodeTable kTable;

enum {
  OK = 0,
  ERR_FASTA_NO_HEADER = 1,
  ERR_FASTQ_BAD_HEADER = 2,
  ERR_FASTQ_BAD_PLUS = 3,
  ERR_FASTQ_TRUNCATED = 4,
  ERR_TRAILING_DATA = 5,
};

struct Out {
  int64_t consumed;     // input bytes consumed (complete records only)
  int64_t n_bases;      // bases written to the buffer
  int64_t n_reads;      // read segments written
  int64_t n_invalid;    // invalid (non-ACGTN) bases encountered
  int64_t next_resume;  // >0: bases of the first unconsumed record already emitted
  int32_t error;
  int32_t stopped_capacity;  // 1 = stopped because the buffer filled
  int32_t strided;      // 1 = buffer is in the word-aligned strided layout
};

inline int64_t strip_cr(const uint8_t* buf, int64_t s, int64_t e) {
  return (e > s && buf[e - 1] == '\r') ? e - 1 : e;
}

// A record's sequence bytes as [start, end) line spans (heap-backed: a
// whole-chromosome FASTA record can have millions of wrapped lines).
struct SeqSpans {
  std::vector<int64_t> s, e;
  int64_t total = 0;
  int n = 0;
  bool add(int64_t a, int64_t b) {
    s.push_back(a); e.push_back(b); ++n; total += b - a;
    return true;
  }
};

struct Packer {
  const uint8_t* buf;
  uint32_t* words;
  uint16_t* lengths;
  int64_t max_bases, max_reads, k;
  // read_len > 0: emit the word-aligned strided layout directly (each read at
  // word row n_reads * stride/16, 'A'-padded to stride bases — bit-identical
  // to readers.pack_for_device(read_len=...)/kmh_restride). n_bases keeps
  // counting REAL bases (capacity accounting is unchanged); w_bases is the
  // write cursor, which only diverges from n_bases in strided mode. A record
  // that is not exactly read_len bases (or a cross-buffer resume) sets
  // abort_strided: the caller discards this pass and re-frames the identical
  // window continuously, so chunk boundaries match the numpy packer's.
  int64_t read_len = 0, stride = 0;
  int64_t n_bases = 0, n_reads = 0, n_invalid = 0;
  int64_t w_bases = 0;
  bool abort_strided = false;

  int64_t cap() const { return max_bases < 65535 ? max_bases : 65535; }

  void push(uint8_t byte) {
    uint8_t c = kTable.code[byte];
    n_invalid += kTable.invalid[byte];
    words[w_bases >> 4] |= (uint32_t)c << ((w_bases & 15) * 2);
    ++w_bases;
    ++n_bases;
  }

#ifdef KMH_SIMD
  // Encode+pack 16 ASCII bases into one uint32 word (requires n_bases % 16
  // == 0 so the bases fill exactly one zeroed output word). A=0 C=1 G=2 T=3,
  // N->A, case-insensitive; non-ACGTN bytes encode as A and are counted.
  void push_block16(const uint8_t* p) {
    __m128i v = _mm_loadu_si128((const __m128i*)p);
    __m128i lower = _mm_or_si128(v, _mm_set1_epi8(0x20));
    __m128i is_c = _mm_cmpeq_epi8(lower, _mm_set1_epi8('c'));
    __m128i is_g = _mm_cmpeq_epi8(lower, _mm_set1_epi8('g'));
    __m128i is_t = _mm_cmpeq_epi8(lower, _mm_set1_epi8('t'));
    __m128i valid = _mm_or_si128(
        _mm_or_si128(_mm_cmpeq_epi8(lower, _mm_set1_epi8('a')),
                     _mm_cmpeq_epi8(lower, _mm_set1_epi8('n'))),
        _mm_or_si128(_mm_or_si128(is_c, is_g), is_t));
    n_invalid +=
        __builtin_popcount(~(unsigned)_mm_movemask_epi8(valid) & 0xFFFFu);
    __m128i code = _mm_or_si128(
        _mm_and_si128(is_c, _mm_set1_epi8(1)),
        _mm_or_si128(_mm_and_si128(is_g, _mm_set1_epi8(2)),
                     _mm_and_si128(is_t, _mm_set1_epi8(3))));
    // 16 x 2-bit codes -> u32, base i at bits [2i, 2i+1]:
    // bytes (c0,c1) -> c0 + 4*c1 per u16 lane, u16 pairs -> v0 + 16*v1 per
    // u32 lane (8 bits each), then 4 lanes -> one word
    __m128i pair = _mm_maddubs_epi16(code, _mm_set1_epi16(0x0401));
    __m128i quad = _mm_madd_epi16(pair, _mm_set1_epi32(0x00100001));
    alignas(16) uint32_t q[4];
    _mm_store_si128((__m128i*)q, quad);
    words[w_bases >> 4] |= q[0] | (q[1] << 8) | (q[2] << 16) | (q[3] << 24);
    w_bases += 16;
    n_bases += 16;
  }
#endif

  // Copy record bases [from, to) (record-relative) into the buffer as one
  // read segment, walking the line spans.
  void copy_segment(const SeqSpans& sp, int64_t from, int64_t to) {
    lengths[n_reads] = (uint16_t)(to - from);
    int64_t pos = 0;
    for (int i = 0; i < sp.n && pos < to; ++i) {
      int64_t len = sp.e[i] - sp.s[i];
      int64_t lo = from > pos ? from - pos : 0;
      int64_t hi = to - pos < len ? to - pos : len;
      int64_t j = lo;
#ifdef KMH_SIMD
      for (; (w_bases & 15) != 0 && j < hi; ++j) push(buf[sp.s[i] + j]);
      for (; j + 16 <= hi; j += 16) push_block16(buf + sp.s[i] + j);
#endif
      for (; j < hi; ++j) push(buf[sp.s[i] + j]);
      pos += len;
    }
    ++n_reads;
    // strided: the next read starts at the next word-aligned row; the skipped
    // pad bases stay 0 ('A') because the output buffer arrives zeroed
    if (read_len) w_bases = n_reads * stride;
  }

  // Emit the record's segments starting at `resume` emitted-bases; returns
  // the new emitted-base count (== sp.total when the record completed).
  // Returns -1 for a capacity stop on a ZERO-length record: done == 0 ==
  // sp.total would otherwise read as "completed" and silently swallow the
  // record, where the numpy packer ships the buffer and carries the
  // 0-length read into the next one (callers clamp next_resume to 0).
  int64_t emit_record(const SeqSpans& sp, int64_t resume) {
    if (read_len && (resume != 0 || sp.total != read_len)) {
      // Nonconforming record: abort to a continuous re-frame of this window —
      // but ONLY if the continuous pass would place (a segment of) it in THIS
      // buffer. Otherwise it's a plain capacity stop: the all-conforming
      // buffer ships strided and the record opens the next buffer, exactly
      // like pack_for_device's per-buffer layout decision.
      int64_t c0 = cap();
      int64_t seg0 = sp.total < c0 ? sp.total : c0;
      if (n_bases + seg0 > max_bases || n_reads + 1 > max_reads)
        return sp.total == 0 ? -1 : resume;
      abort_strided = true;  // caller re-frames this window continuously
      return resume;
    }
    int64_t total = sp.total, c = cap(), step = c - (k - 1);
    if (step <= 0) step = 1;
    int64_t done = resume;
    while (true) {
      int64_t seg_start = done == 0 ? 0 : done - (k - 1);
      int64_t seg_len = total - seg_start < c ? total - seg_start : c;
      if (n_bases + seg_len > max_bases || n_reads + 1 > max_reads)
        return total == 0 ? -1 : done;
      copy_segment(sp, seg_start, seg_start + seg_len);
      done = seg_start + seg_len;
      if (done >= total) return total;
    }
  }
};

}  // namespace

extern "C" {

// `read_len > 0` asks for the word-aligned strided layout (every record must
// be exactly read_len bases and `packed` must hold
// (max_bases/read_len) * (stride/16) zeroed words, stride = read_len rounded
// up to 16): on any nonconforming record the call returns out->strided == 0
// with nothing consumed/emitted, and the caller retries with read_len == 0
// on the identical window (see io/native.py).
void kmh_pack_fastq(const uint8_t* buf, int64_t len, int32_t eof, int64_t k,
                    int64_t read_len, int64_t resume_bases, int64_t max_bases,
                    int64_t max_reads, uint32_t* packed, uint16_t* lengths,
                    Out* out) {
  Packer pk{buf, packed, lengths, max_bases, max_reads, k};
  pk.read_len = read_len;
  pk.stride = (read_len + 15) / 16 * 16;
  int64_t pos = 0, resume = resume_bases;
  out->error = OK;
  out->stopped_capacity = 0;
  out->next_resume = 0;
  out->strided = read_len > 0 ? 1 : 0;
  if (read_len > 0 && resume_bases > 0) {  // mid-record resume: not uniform
    out->strided = 0;
    out->consumed = 0; out->n_bases = 0; out->n_reads = 0; out->n_invalid = 0;
    return;
  }
  while (true) {
    int64_t ls[4], le[4], cursor = pos;
    bool complete = true;
    for (int i = 0; i < 4; ++i) {
      const uint8_t* nl =
          (const uint8_t*)memchr(buf + cursor, '\n', (size_t)(len - cursor));
      if (!nl) {
        if (eof && i == 3 && cursor < len) {  // final line without newline
          ls[i] = cursor; le[i] = strip_cr(buf, cursor, len); cursor = len;
          continue;
        }
        complete = false;
        break;
      }
      ls[i] = cursor;
      le[i] = strip_cr(buf, cursor, nl - buf);
      cursor = (nl - buf) + 1;
    }
    if (!complete) {
      if (eof && pos < len) {
        bool only_ws = true;
        for (int64_t i = pos; i < len; ++i)
          if (buf[i] != '\n' && buf[i] != '\r' && buf[i] != ' ') only_ws = false;
        if (!only_ws) out->error = ERR_FASTQ_TRUNCATED;
        pos = len;
      }
      break;
    }
    if (le[0] == ls[0] || buf[ls[0]] != '@') { out->error = ERR_FASTQ_BAD_HEADER; break; }
    if (le[2] == ls[2] || buf[ls[2]] != '+') { out->error = ERR_FASTQ_BAD_PLUS; break; }
    SeqSpans sp;
    sp.add(ls[1], le[1]);
    int64_t done = pk.emit_record(sp, resume);
    if (pk.abort_strided) break;
    if (done < sp.total) {
      out->stopped_capacity = 1;
      out->next_resume = done < 0 ? 0 : done;  // -1 = zero-length record stop
      break;
    }
    resume = 0;
    pos = cursor;
  }
  if (pk.abort_strided) {
    out->strided = 0;
    out->stopped_capacity = 0;
    out->error = OK;
    out->consumed = 0; out->n_bases = 0; out->n_reads = 0; out->n_invalid = 0;
    return;
  }
  out->consumed = pos;
  out->n_bases = pk.n_bases;
  out->n_reads = pk.n_reads;
  out->n_invalid = pk.n_invalid;
}

// `read_len` as in kmh_pack_fastq (FASTA records may wrap across lines; the
// strided layout only requires each record's TOTAL length == read_len).
void kmh_pack_fasta(const uint8_t* buf, int64_t len, int32_t eof, int64_t k,
                    int64_t read_len, int64_t resume_bases, int64_t max_bases,
                    int64_t max_reads, uint32_t* packed, uint16_t* lengths,
                    Out* out) {
  Packer pk{buf, packed, lengths, max_bases, max_reads, k};
  pk.read_len = read_len;
  pk.stride = (read_len + 15) / 16 * 16;
  int64_t pos = 0, resume = resume_bases;
  out->error = OK;
  out->stopped_capacity = 0;
  out->next_resume = 0;
  out->strided = read_len > 0 ? 1 : 0;
  if (read_len > 0 && resume_bases > 0) {  // mid-record resume: not uniform
    out->strided = 0;
    out->consumed = 0; out->n_bases = 0; out->n_reads = 0; out->n_invalid = 0;
    return;
  }
  if (len > 0 && buf[0] != '>') {
    out->error = ERR_FASTA_NO_HEADER;
    out->consumed = 0; out->n_bases = 0; out->n_reads = 0; out->n_invalid = 0;
    return;
  }
  while (pos < len) {
    const uint8_t* hnl =
        (const uint8_t*)memchr(buf + pos, '\n', (size_t)(len - pos));
    if (!hnl && !eof) break;  // incomplete header line
    int64_t body = hnl ? (hnl - buf) + 1 : len;
    // collect sequence line spans until the next '>' at line start (or EOF)
    SeqSpans sp;
    int64_t cursor = body, rec_end = -1;
    bool spans_ok = true;
    while (cursor < len) {
      if (buf[cursor] == '>') { rec_end = cursor; break; }
      const uint8_t* nl =
          (const uint8_t*)memchr(buf + cursor, '\n', (size_t)(len - cursor));
      int64_t line_end = nl ? (nl - buf) : len;
      if (!nl && !eof) { spans_ok = false; break; }  // line may continue
      spans_ok = spans_ok && sp.add(cursor, strip_cr(buf, cursor, line_end));
      cursor = nl ? line_end + 1 : len;
    }
    if (!spans_ok) break;  // too many lines for one pass or incomplete: carry
    if (rec_end < 0) {
      if (!eof) break;  // record may continue in the next block
      rec_end = len;
    }
    int64_t done = pk.emit_record(sp, resume);
    if (pk.abort_strided) break;
    if (done < sp.total) {
      out->stopped_capacity = 1;
      out->next_resume = done < 0 ? 0 : done;  // -1 = zero-length record stop
      break;
    }
    resume = 0;
    pos = rec_end;
  }
  if (pk.abort_strided) {
    out->strided = 0;
    out->stopped_capacity = 0;
    out->error = OK;
    out->consumed = 0; out->n_bases = 0; out->n_reads = 0; out->n_invalid = 0;
    return;
  }
  out->consumed = pos;
  out->n_bases = pk.n_bases;
  out->n_reads = pk.n_reads;
  out->n_invalid = pk.n_invalid;
}

// Continuous 2-bit packing -> the word-aligned strided layout consumed by
// the device's fixed-read-length plane hash (see readers.restride_packed,
// whose numpy form this must match bit-exactly; tests enforce). Read r's
// bases start at bit 2*read_len*r of the continuous stream; the strided
// layout gives each read ceil(read_len/16) whole words padded with base
// code 0 ('A'). `in` must extend one word past the last read's bits (the
// packer's +2 slack words guarantee it); `out` holds rows*npr words.
void kmh_restride(const uint32_t* in, int64_t n_reads, int64_t read_len,
                  int64_t rows, uint32_t* out) {
  int64_t stride = (read_len + 15) / 16 * 16, npr = stride / 16;
  int64_t last = (2 * read_len - 1) / 32;  // last used word within a read
  int64_t tail_bits = 2 * read_len - 32 * last;
  uint32_t tail_mask =
      tail_bits >= 32 ? 0xFFFFFFFFu : ((1u << tail_bits) - 1u);
  memset(out, 0, (size_t)(rows * npr) * sizeof(uint32_t));
  for (int64_t r = 0; r < n_reads; ++r) {
    int64_t bit = 2 * read_len * r;
    const uint32_t* p = in + (bit >> 5);
    uint32_t* o = out + r * npr;
    int s = (int)(bit & 31);
    if (s == 0) {
      for (int64_t j = 0; j <= last; ++j) o[j] = p[j];
    } else {
      for (int64_t j = 0; j <= last; ++j)
        o[j] = (p[j] >> s) | (p[j + 1] << (32 - s));
    }
    o[last] &= tail_mask;
  }
}

}  // extern "C"
