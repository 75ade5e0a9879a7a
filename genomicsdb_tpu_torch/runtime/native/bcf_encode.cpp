// Native BCF2.2 record encoder: the byte-identical C form of
// vcf/bcf.py::_encode_record (htslib vcf.c write path semantics; see
// reference htslib usage in genomicsdb_bcf_generator.cc / vcf_adapter.cc).
//
// Encodes rendered combined-VCF text record lines into BCF2 binary
// records in one pass.  Header dictionaries (contigs; the shared
// FILTER/INFO/FORMAT string dictionary with per-id type codes) are
// passed in as blobs; lookups use small open-addressing tables built
// per call.
//
// Build: make -C genomicsdb_tpu/runtime/native

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int32_t I32_MISSING = INT32_MIN;          // 0x80000000
constexpr int32_t I32_EOV = INT32_MIN + 1;          // 0x80000001
constexpr uint32_t F_MISSING = 0x7F800001u;
constexpr uint32_t F_EOV = 0x7F800002u;
constexpr int BT_INT8 = 1, BT_INT16 = 2, BT_INT32 = 3, BT_FLOAT = 5,
              BT_CHAR = 7;

// type codes for the per-id INFO/FORMAT type arrays
constexpr uint8_t T_NONE = 0, T_INT = 1, T_FLOAT = 2, T_STRING = 3;

struct Writer {
  char* base;
  int64_t cap;
  int64_t w = 0;
  bool overflow = false;
  inline void need(int64_t n) {
    if (w + n > cap) overflow = true;
  }
  inline void put_u8(uint8_t v) {
    need(1);
    if (overflow) return;
    base[w++] = static_cast<char>(v);
  }
  inline void put_bytes(const void* p, int64_t n) {
    need(n);
    if (overflow) return;
    std::memcpy(base + w, p, static_cast<size_t>(n));
    w += n;
  }
  inline void put_i32(int32_t v) { put_bytes(&v, 4); }
  inline void put_u32(uint32_t v) { put_bytes(&v, 4); }
  inline void put_i16(int16_t v) { put_bytes(&v, 2); }
};

// typed int scalar: width bounds match htslib (BCF_MIN_BT_INT8 = -120,
// BCF_MIN_BT_INT16 = -32760)
inline void typed_int(Writer& o, int32_t v) {
  if (v >= -120 && v <= 127) {
    o.put_u8((1 << 4) | BT_INT8);
    o.put_u8(static_cast<uint8_t>(static_cast<int8_t>(v)));
  } else if (v >= -32760 && v <= 32767) {
    o.put_u8((1 << 4) | BT_INT16);
    o.put_i16(static_cast<int16_t>(v));
  } else {
    o.put_u8((1 << 4) | BT_INT32);
    o.put_i32(v);
  }
}

inline void typed_descriptor(Writer& o, int64_t n, int btype) {
  if (n < 15) {
    o.put_u8(static_cast<uint8_t>((n << 4) | btype));
  } else {
    o.put_u8((15 << 4) | btype);
    typed_int(o, static_cast<int32_t>(n));
  }
}

inline void typed_string(Writer& o, const char* p, int64_t len) {
  typed_descriptor(o, len, BT_CHAR);
  o.put_bytes(p, len);
}

inline int int_width(const int32_t* vals, int64_t n) {
  int32_t lo = 0, hi = 0;
  bool any = false;
  for (int64_t i = 0; i < n; ++i) {
    int32_t v = vals[i];
    if (v == I32_MISSING || v == I32_EOV) continue;
    if (!any) {
      lo = hi = v;
      any = true;
    } else {
      if (v < lo) lo = v;
      if (v > hi) hi = v;
    }
  }
  if (lo >= -120 && hi <= 127) return BT_INT8;
  if (lo >= -32760 && hi <= 32767) return BT_INT16;
  return BT_INT32;
}

inline void pack_ints(Writer& o, const int32_t* vals, int64_t n, int bt) {
  for (int64_t i = 0; i < n; ++i) {
    int32_t v = vals[i];
    if (bt == BT_INT8) {
      int8_t b = (v == I32_MISSING) ? int8_t(-128)
                 : (v == I32_EOV) ? int8_t(-127)
                                  : static_cast<int8_t>(v);
      o.put_u8(static_cast<uint8_t>(b));
    } else if (bt == BT_INT16) {
      int16_t s = (v == I32_MISSING) ? int16_t(-32768)
                  : (v == I32_EOV) ? int16_t(-32767)
                                   : static_cast<int16_t>(v);
      o.put_i16(s);
    } else {
      o.put_i32(v);
    }
  }
}

inline void typed_int_vec(Writer& o, const int32_t* vals, int64_t n) {
  if (n == 0) {
    typed_descriptor(o, 0, BT_INT8);
    return;
  }
  int bt = int_width(vals, n);
  typed_descriptor(o, n, bt);
  pack_ints(o, vals, n, bt);
}

// -2 on malformed int (matches the Python int() ValueError)
inline bool parse_i32(const char* p, const char* e, int32_t* out) {
  if (p >= e) return false;
  bool neg = false;
  if (*p == '-' || *p == '+') {
    neg = *p == '-';
    ++p;
  }
  if (p >= e) return false;
  int64_t v = 0;
  for (; p < e; ++p) {
    if (*p < '0' || *p > '9') return false;
    v = v * 10 + (*p - '0');
    if (v > INT32_MAX + 1ll) return false;
  }
  v = neg ? -v : v;
  if (v < INT32_MIN || v > INT32_MAX) return false;
  *out = static_cast<int32_t>(v);
  return true;
}

inline bool parse_f32_bits(const char* p, const char* e, uint32_t* out) {
  if (e - p == 1 && *p == '.') {
    *out = F_MISSING;
    return true;
  }
  char buf[64];
  size_t n = static_cast<size_t>(e - p);
  if (n == 0 || n >= sizeof(buf)) return false;
  std::memcpy(buf, p, n);
  buf[n] = 0;
  char* endp = nullptr;
  float f = std::strtof(buf, &endp);
  if (endp != buf + n) return false;
  std::memcpy(out, &f, 4);
  return true;
}

// open-addressing span dictionary (FNV-1a)
struct SpanDict {
  const char* blob;
  const int64_t* offs;
  int64_t n;
  uint64_t mask;
  std::vector<int64_t> slots;  // -1 empty, else id
  void build(const char* b, const int64_t* o, int64_t count) {
    blob = b;
    offs = o;
    n = count;
    uint64_t cap = 16;
    while (cap < static_cast<uint64_t>(count) * 4) cap <<= 1;
    mask = cap - 1;
    slots.assign(cap, -1);
    for (int64_t i = 0; i < count; ++i) {
      uint64_t s = hash(blob + offs[i], offs[i + 1] - offs[i]) & mask;
      while (slots[s] >= 0) s = (s + 1) & mask;
      slots[s] = i;
    }
  }
  static uint64_t hash(const char* p, int64_t len) {
    uint64_t h = 1469598103934665603ull;
    for (int64_t j = 0; j < len; ++j) {
      h ^= static_cast<uint8_t>(p[j]);
      h *= 1099511628211ull;
    }
    return h;
  }
  int64_t find(const char* p, int64_t len) const {
    uint64_t s = hash(p, len) & mask;
    for (;;) {
      int64_t id = slots[s];
      if (id < 0) return -1;
      if (offs[id + 1] - offs[id] == len &&
          std::memcmp(blob + offs[id], p, static_cast<size_t>(len)) == 0)
        return id;
      s = (s + 1) & mask;
    }
  }
};

struct Tok {
  const char* p;
  const char* e;
  int64_t len() const { return e - p; }
  bool is(const char* s) const {
    int64_t l = static_cast<int64_t>(std::strlen(s));
    return len() == l && std::memcmp(p, s, l) == 0;
  }
};

// split [p, e) on delim into out; returns count
inline int split(const char* p, const char* e, char delim, Tok* out,
                 int max_out) {
  int k = 0;
  const char* tok = p;
  for (const char* q = p;; ++q) {
    if (q == e || *q == delim) {
      if (k >= max_out) return -1;
      out[k].p = tok;
      out[k].e = q;
      ++k;
      if (q == e) break;
      tok = q + 1;
    }
  }
  return k;
}

// GT token -> htslib encoding ((allele+1)<<1 | phased, '.' -> 0)
inline int encode_gt(const Tok& t, int32_t* out, int max_out, bool* err) {
  if (t.len() == 0 || (t.len() == 1 && *t.p == '.')) {
    out[0] = 0;
    return 1;
  }
  int k = 0;
  bool phased = false;
  const char* buf = t.p;
  for (const char* q = t.p;; ++q) {
    if (q == t.e || *q == '/' || *q == '|') {
      int32_t base = 0;
      if (!(q - buf == 1 && *buf == '.')) {
        int32_t a;
        if (!parse_i32(buf, q, &a)) {
          *err = true;
          return 0;
        }
        base = (a + 1) << 1;
      }
      if (k >= max_out) {
        *err = true;
        return 0;
      }
      out[k++] = base | (phased ? 1 : 0);
      if (q == t.e) break;
      phased = *q == '|';
      buf = q + 1;
    }
  }
  return k;
}

}  // namespace

namespace {

// Encode lines [lo, hi) into `o` (which starts at its own offset 0);
// out_offs[li - lo + 1] = o.w after line li (out_offs[0] pre-set by the
// caller).  Returns 0, or -2 malformed numeric / -3 missing dict name.
// On Writer overflow the caller retries with a larger buffer.
int encode_lines(
    const char* text, const int64_t* line_offs, int64_t lo, int64_t hi,
    const SpanDict& contigs, const SpanDict& strs,
    const uint8_t* info_type, const uint8_t* fmt_type, int32_t n_sample,
    Writer& o, int64_t* out_offs) {
  char* out = o.base;
  constexpr int MAXC = 4096;   // columns per line
  constexpr int MAXT = 4096;   // sub-tokens
  std::vector<Tok> cols(MAXC), toks(MAXT), ftoks(64);
  std::vector<int32_t> ibuf;
  std::vector<uint32_t> fbuf;
  std::vector<int32_t> gt_enc;
  std::vector<int> gt_len;
  for (int64_t gi = lo; gi < hi; ++gi) {
    const int64_t li = gi - lo;
    const char* p = text + line_offs[gi];
    const char* e = text + line_offs[gi + 1];
    while (e > p && (e[-1] == '\n' || e[-1] == '\r')) --e;
    if (e <= p) {
      out_offs[li + 1] = o.w;
      continue;
    }
    int nc = split(p, e, '\t', cols.data(), MAXC);
    if (nc < 8) return -2;
    int64_t cid = contigs.find(cols[0].p, cols[0].len());
    if (cid < 0) return -3;
    int32_t pos;
    if (!parse_i32(cols[1].p, cols[1].e, &pos)) return -2;
    // alleles
    int n_allele = 1;
    int n_alt = 0;
    Tok alts[256];
    if (!cols[4].is(".")) {
      n_alt = split(cols[4].p, cols[4].e, ',', alts, 256);
      if (n_alt < 0) return -2;
      n_allele += n_alt;
    }
    // rlen: REF length, overridden by INFO END
    int32_t rlen = static_cast<int32_t>(cols[3].len());
    // INFO pairs
    int n_info = 0;
    Tok ikeys[512], ivals[512];
    bool iflag[512];
    if (!cols[7].is(".")) {
      int ni = split(cols[7].p, cols[7].e, ';', toks.data(), MAXT);
      if (ni < 0) return -2;
      for (int i = 0; i < ni; ++i) {
        const char* eq = toks[i].p;
        while (eq < toks[i].e && *eq != '=') ++eq;
        if (n_info >= 512) return -2;
        ikeys[n_info].p = toks[i].p;
        ikeys[n_info].e = eq;
        if (eq < toks[i].e) {
          iflag[n_info] = false;
          ivals[n_info].p = eq + 1;
          ivals[n_info].e = toks[i].e;
          if (eq - toks[i].p == 3 &&
              std::memcmp(toks[i].p, "END", 3) == 0) {
            int32_t endv;
            if (!parse_i32(ivals[n_info].p, ivals[n_info].e, &endv))
              return -2;
            rlen = endv - pos + 1;
          }
        } else {
          iflag[n_info] = true;
        }
        ++n_info;
      }
    }
    // FORMAT names
    int n_fmt = 0;
    Tok fmts[64];
    if (nc > 8 && !cols[8].is(".")) {
      n_fmt = split(cols[8].p, cols[8].e, ':', fmts, 64);
      if (n_fmt < 0) return -2;
    }
    const int n_scol = nc > 9 ? nc - 9 : 0;
    // qual
    uint32_t qbits = F_MISSING;
    if (!cols[5].is(".")) {
      if (!parse_f32_bits(cols[5].p, cols[5].e, &qbits)) return -2;
    }
    // --- shared block ---
    int64_t rec_hdr_at = o.w;
    o.put_u32(0);  // l_shared placeholder
    o.put_u32(0);  // l_indiv placeholder
    int64_t shared_at = o.w;
    o.put_i32(static_cast<int32_t>(cid));
    o.put_i32(pos - 1);
    o.put_i32(rlen);
    o.put_u32(qbits);
    o.put_u32((static_cast<uint32_t>(n_allele) << 16) |
              static_cast<uint32_t>(n_info));
    o.put_u32((static_cast<uint32_t>(n_fmt) << 24) |
              static_cast<uint32_t>(n_sample));
    // ID
    if (cols[2].is(".")) {
      typed_string(o, "", 0);
    } else {
      typed_string(o, cols[2].p, cols[2].len());
    }
    // alleles
    typed_string(o, cols[3].p, cols[3].len());
    for (int i = 0; i < n_alt; ++i)
      typed_string(o, alts[i].p, alts[i].len());
    // FILTER
    if (cols[6].is(".")) {
      typed_int_vec(o, nullptr, 0);
    } else {
      int nf = split(cols[6].p, cols[6].e, ';', toks.data(), MAXT);
      if (nf < 0) return -2;
      ibuf.clear();
      for (int i = 0; i < nf; ++i) {
        int64_t id = strs.find(toks[i].p, toks[i].len());
        if (id < 0) return -3;
        ibuf.push_back(static_cast<int32_t>(id));
      }
      typed_int_vec(o, ibuf.data(), static_cast<int64_t>(ibuf.size()));
    }
    // INFO
    for (int i = 0; i < n_info; ++i) {
      int64_t id = strs.find(ikeys[i].p, ikeys[i].len());
      if (id < 0) return -3;
      typed_int(o, static_cast<int32_t>(id));
      if (iflag[i]) {
        typed_descriptor(o, 0, BT_INT8);
        continue;
      }
      uint8_t ty = info_type[id];
      if (ty == T_INT) {
        int nt = split(ivals[i].p, ivals[i].e, ',', toks.data(), MAXT);
        if (nt < 0) return -2;
        ibuf.clear();
        for (int t = 0; t < nt; ++t) {
          int32_t v = I32_MISSING;
          if (!toks[t].is(".")) {
            if (!parse_i32(toks[t].p, toks[t].e, &v)) return -2;
          }
          ibuf.push_back(v);
        }
        typed_int_vec(o, ibuf.data(), static_cast<int64_t>(ibuf.size()));
      } else if (ty == T_FLOAT) {
        int nt = split(ivals[i].p, ivals[i].e, ',', toks.data(), MAXT);
        if (nt < 0) return -2;
        typed_descriptor(o, nt, BT_FLOAT);
        for (int t = 0; t < nt; ++t) {
          uint32_t b;
          if (!parse_f32_bits(toks[t].p, toks[t].e, &b)) return -2;
          o.put_u32(b);
        }
      } else {
        typed_string(o, ivals[i].p, ivals[i].len());
      }
    }
    int64_t l_shared = o.w - shared_at;
    // --- indiv block ---
    int64_t indiv_at = o.w;
    for (int fi = 0; fi < n_fmt; ++fi) {
      int64_t id = strs.find(fmts[fi].p, fmts[fi].len());
      if (id < 0) return -3;
      typed_int(o, static_cast<int32_t>(id));
      const bool is_gt =
          fmts[fi].len() == 2 && std::memcmp(fmts[fi].p, "GT", 2) == 0;
      // resolve field fi of each sample column
      // (re-splitting per field keeps memory flat; n_fmt is small)
      if (is_gt) {
        gt_enc.clear();
        gt_len.assign(n_scol, 0);
        int width = 0;
        std::vector<int32_t> per(n_scol * 16);
        for (int s = 0; s < n_scol; ++s) {
          int nt = split(cols[9 + s].p, cols[9 + s].e, ':', ftoks.data(),
                         64);
          if (nt < 0) return -2;
          static const char dot[] = ".";
          Tok t{dot, dot + 1};  // missing sample sub-field -> '.'
          if (fi < nt) t = ftoks[fi];
          bool err = false;
          int k = encode_gt(t, per.data() + s * 16, 16, &err);
          if (err) return -2;
          gt_len[s] = k;
          if (k > width) width = k;
        }
        ibuf.clear();
        for (int s = 0; s < n_scol; ++s) {
          for (int k = 0; k < gt_len[s]; ++k)
            ibuf.push_back(per[s * 16 + k]);
          for (int k = gt_len[s]; k < width; ++k) ibuf.push_back(I32_EOV);
        }
        int bt = int_width(ibuf.data(), static_cast<int64_t>(ibuf.size()));
        typed_descriptor(o, width, bt);
        pack_ints(o, ibuf.data(), static_cast<int64_t>(ibuf.size()), bt);
        continue;
      }
      uint8_t ty = fmt_type[id];
      if (ty == T_STRING || ty == T_NONE) {
        // width = max token length (min 1), NUL-padded
        int64_t width = 1;
        for (int s = 0; s < n_scol; ++s) {
          int nt = split(cols[9 + s].p, cols[9 + s].e, ':', ftoks.data(),
                         64);
          if (nt < 0) return -2;
          int64_t l = fi < nt ? ftoks[fi].len() : 1;
          if (fi >= nt) l = 1;  // '.' placeholder
          if (l > width) width = l;
        }
        typed_descriptor(o, width, BT_CHAR);
        for (int s = 0; s < n_scol; ++s) {
          int nt = split(cols[9 + s].p, cols[9 + s].e, ':', ftoks.data(),
                         64);
          const char* tp = ".";
          int64_t tl = 1;
          if (fi < nt) {
            tp = ftoks[fi].p;
            tl = ftoks[fi].len();
          }
          o.put_bytes(tp, tl);
          for (int64_t z = tl; z < width; ++z) o.put_u8(0);
        }
        continue;
      }
      // numeric: two passes — widths, then values
      int width = 0;
      for (int s = 0; s < n_scol; ++s) {
        int nt = split(cols[9 + s].p, cols[9 + s].e, ':', ftoks.data(),
                       64);
        if (nt < 0) return -2;
        int cnt = 1;
        if (fi < nt && !ftoks[fi].is(".")) {
          cnt = split(ftoks[fi].p, ftoks[fi].e, ',', toks.data(), MAXT);
          if (cnt < 0) return -2;
        }
        if (cnt > width) width = cnt;
      }
      if (ty == T_FLOAT) {
        fbuf.clear();
        for (int s = 0; s < n_scol; ++s) {
          int nt = split(cols[9 + s].p, cols[9 + s].e, ':', ftoks.data(),
                         64);
          int cnt = 0;
          if (fi < nt && !ftoks[fi].is(".")) {
            cnt = split(ftoks[fi].p, ftoks[fi].e, ',', toks.data(), MAXT);
            for (int t = 0; t < cnt; ++t) {
              uint32_t b;
              if (!parse_f32_bits(toks[t].p, toks[t].e, &b)) return -2;
              fbuf.push_back(b);
            }
          } else {
            fbuf.push_back(F_MISSING);
            cnt = 1;
          }
          for (int z = cnt; z < width; ++z) fbuf.push_back(F_EOV);
        }
        typed_descriptor(o, width, BT_FLOAT);
        for (uint32_t b : fbuf) o.put_u32(b);
      } else {
        ibuf.clear();
        for (int s = 0; s < n_scol; ++s) {
          int nt = split(cols[9 + s].p, cols[9 + s].e, ':', ftoks.data(),
                         64);
          int cnt = 0;
          if (fi < nt && !ftoks[fi].is(".")) {
            cnt = split(ftoks[fi].p, ftoks[fi].e, ',', toks.data(), MAXT);
            for (int t = 0; t < cnt; ++t) {
              int32_t v = I32_MISSING;
              if (!toks[t].is(".")) {
                if (!parse_i32(toks[t].p, toks[t].e, &v)) return -2;
              }
              ibuf.push_back(v);
            }
          } else {
            ibuf.push_back(I32_MISSING);
            cnt = 1;
          }
          for (int z = cnt; z < width; ++z) ibuf.push_back(I32_EOV);
        }
        int bt = int_width(ibuf.data(), static_cast<int64_t>(ibuf.size()));
        typed_descriptor(o, width, bt);
        pack_ints(o, ibuf.data(), static_cast<int64_t>(ibuf.size()), bt);
      }
    }
    int64_t l_indiv = o.w - indiv_at;
    if (o.overflow) return 0;        // caller retries with more space
    uint32_t ls = static_cast<uint32_t>(l_shared);
    uint32_t liv = static_cast<uint32_t>(l_indiv);
    std::memcpy(out + rec_hdr_at, &ls, 4);
    std::memcpy(out + rec_hdr_at + 4, &liv, 4);
    out_offs[li + 1] = o.w;
  }
  return 0;
}

}  // namespace

extern "C" {

// Encode n record lines to BCF2 records, parallel over line chunks
// (each chunk encodes into its own growable scratch, then chunks are
// stitched back to back — record encoding is independent per line).
// Lines are [line_offs[i], line_offs[i+1]) spans of `text` WITHOUT the
// trailing newline handled (a trailing '\n' or '\r' is stripped).
// Dictionaries: contig names; shared string dict in IDX order with
// per-id info/format type codes (0 none, 1 Integer, 2 Float, 3 String;
// Flag INFO ids also use 1/3 — a valueless key encodes as a flag
// regardless).  Returns bytes written, -1 on out overflow, -2 on a
// malformed numeric token, -3 on a name missing from a dictionary.
int64_t gdb_bcf_encode_records(
    const char* text, const int64_t* line_offs, int64_t n_lines,
    const char* contig_blob, const int64_t* contig_offs, int64_t n_contig,
    const char* str_blob, const int64_t* str_offs, int64_t n_str,
    const uint8_t* info_type, const uint8_t* fmt_type, int32_t n_sample,
    char* out, int64_t cap, int64_t* out_offs) {
  SpanDict contigs, strs;
  contigs.build(contig_blob, contig_offs, n_contig);
  strs.build(str_blob, str_offs, n_str);
  out_offs[0] = 0;
  if (n_lines <= 0) return 0;
  unsigned hw = std::thread::hardware_concurrency();
  int nthreads = hw ? static_cast<int>(hw) : 4;
  if (nthreads > 8) nthreads = 8;
  const int64_t text_len = line_offs[n_lines] - line_offs[0];
  if (n_lines < 512 || text_len < (1 << 18) || nthreads <= 1) {
    Writer o{out, cap};
    int rc = encode_lines(text, line_offs, 0, n_lines, contigs, strs,
                          info_type, fmt_type, n_sample, o, out_offs);
    if (rc < 0) return rc;
    if (o.overflow) return -1;
    return o.w;
  }
  const int64_t nchunks = std::min<int64_t>(
      static_cast<int64_t>(nthreads) * 4, (n_lines + 255) / 256);
  const int64_t step = (n_lines + nchunks - 1) / nchunks;
  std::vector<std::vector<char>> bufs(nchunks);
  std::vector<std::vector<int64_t>> offs_local(nchunks);
  std::vector<int64_t> written(nchunks, 0);
  std::vector<int> rcs(nchunks, 0);
  auto run_chunk = [&](int64_t c) {
    const int64_t lo = c * step;
    const int64_t hi = std::min(n_lines, lo + step);
    if (lo >= hi) return;
    const int64_t tl = line_offs[hi] - line_offs[lo];
    int64_t scratch = tl * 2 + (hi - lo) * 96 + 4096;
    offs_local[c].assign(hi - lo + 1, 0);
    for (;;) {
      bufs[c].resize(static_cast<size_t>(scratch));
      Writer o{bufs[c].data(), scratch};
      int rc = encode_lines(text, line_offs, lo, hi, contigs, strs,
                            info_type, fmt_type, n_sample, o,
                            offs_local[c].data());
      if (rc < 0) {
        rcs[c] = rc;
        return;
      }
      if (!o.overflow) {
        written[c] = o.w;
        return;
      }
      scratch *= 2;
    }
  };
  std::vector<std::thread> ts;
  const int64_t per = (nchunks + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    const int64_t c0 = t * per;
    const int64_t c1 = std::min(nchunks, c0 + per);
    if (c0 >= c1) break;
    ts.emplace_back([&, c0, c1]() {
      for (int64_t c = c0; c < c1; ++c) run_chunk(c);
    });
  }
  for (auto& t : ts) t.join();
  for (int64_t c = 0; c < nchunks; ++c)
    if (rcs[c] < 0) return rcs[c];
  int64_t total = 0;
  for (int64_t c = 0; c < nchunks; ++c) total += written[c];
  if (total > cap) return -1;
  int64_t base = 0;
  for (int64_t c = 0; c < nchunks; ++c) {
    const int64_t lo = c * step;
    const int64_t hi = std::min(n_lines, lo + step);
    if (lo >= hi) continue;
    std::memcpy(out + base, bufs[c].data(),
                static_cast<size_t>(written[c]));
    for (int64_t i = 0; i < hi - lo; ++i)
      out_offs[lo + i + 1] = base + offs_local[c][i + 1];
    base += written[c];
  }
  return total;
}

}  // extern "C"
