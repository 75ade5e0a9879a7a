// Native BCF2.2 record decoder: typed binary records -> VCF text lines.
//
// The BCF2 *input* edge previously round-tripped through the Python
// cleanroom decoder (~2 MB/s), so BCF-native cohorts imported 25x
// slower than VCF text.  This decoder renders the record section in one
// native pass; the Python side keeps header parsing and falls back to
// the cleanroom decoder on any malformed byte (return -2).  Semantics
// mirror vcf/bcf.py::_decode_record exactly (the equality oracle:
// native text == Python text on the golden corpus + fuzz round-trips).
//
// Reference parity: htslib-native BCF reads in the loader
// (vcf2binary.cc:481-546 uses bcf_read/bcf_get_* directly).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

constexpr int32_t I32_MISSING = INT32_MIN;        // 0x80000000
constexpr int32_t I32_EOV = INT32_MIN + 1;        // 0x80000001
constexpr uint32_t F_MISSING = 0x7F800001u;
constexpr uint32_t F_EOV = 0x7F800002u;

constexpr int BT_INT8 = 1, BT_INT16 = 2, BT_INT32 = 3, BT_FLOAT = 5,
              BT_CHAR = 7;

struct Cursor {
  const uint8_t* d;
  int64_t n;
  int64_t o = 0;
  bool bad = false;

  bool need(int64_t k) {
    if (o + k > n) { bad = true; return false; }
    return true;
  }
  uint32_t u32() {
    if (!need(4)) return 0;
    uint32_t v; std::memcpy(&v, d + o, 4); o += 4; return v;
  }
  int32_t i32() { return static_cast<int32_t>(u32()); }
  uint8_t u8() {
    if (!need(1)) return 0;
    return d[o++];
  }
};

struct Out {
  char* buf;
  int64_t cap;
  int64_t len = 0;
  bool overflow = false;

  void put(char c) {
    if (len >= cap) { overflow = true; return; }
    buf[len++] = c;
  }
  void put(const char* s, int64_t k) {
    if (len + k > cap) { overflow = true; len = cap; return; }
    std::memcpy(buf + len, s, k); len += k;
  }
  void puts(const char* s) { put(s, (int64_t)std::strlen(s)); }
  void put_i64(int64_t v) {
    char tmp[24];
    char* p = tmp + sizeof tmp;
    bool neg = v < 0;
    uint64_t u = neg ? 0 - (uint64_t)v : (uint64_t)v;
    do { *--p = char('0' + u % 10); u /= 10; } while (u);
    if (neg) *--p = '-';
    put(p, tmp + sizeof tmp - p);
  }
};

// vcf/bcf.py _fmt_float_bits + core/formats.py format_float_vcf
// (htslib kputd): 6 significant digits fixed-point, trailing zeros
// trimmed but >= 1 decimal digit, %g outside [0.0001, 999999].
// NaN payloads other than F_MISSING go through %g ("nan") — the Python
// formatter raises there, so no output to match.
void put_float_bits(Out& out, uint32_t bits) {
  if (bits == F_MISSING) { out.put('.'); return; }
  float f; std::memcpy(&f, &bits, 4);
  double d = (double)f;
  char tmp[48];
  if (d == 0.0) {
    out.puts(std::signbit(d) ? "-0" : "0");
    return;
  }
  const char* sign = "";
  if (d < 0) { sign = "-"; d = -d; }
  if (!(d >= 0.0001) || d > 999999.0) {
    int k = std::snprintf(tmp, sizeof tmp, "%s%g", sign, d);
    out.put(tmp, k);
    return;
  }
  int int_digits = (int)std::floor(std::log10(d)) + 1;
  int decimals = 6 - int_digits;
  if (decimals < 0) decimals = 0;
  int k = std::snprintf(tmp, sizeof tmp, "%.*f", decimals, d);
  // strip trailing zeros, keep at least one decimal digit
  bool has_dot = std::memchr(tmp, '.', k) != nullptr;
  if (has_dot) {
    while (k > 0 && tmp[k - 1] == '0') --k;
    if (k > 0 && tmp[k - 1] == '.') tmp[k++] = '0';
  } else {
    tmp[k++] = '.';
    tmp[k++] = '0';
  }
  out.puts(sign);
  out.put(tmp, k);
}

struct Typed {
  int btype = 0;
  int64_t n = 0;
  int64_t off = 0;   // byte offset of the values
};

// parse one typed descriptor (+ overlong count) and skip to the end of
// its values; returns byte size of one element
int elem_size(int btype) {
  switch (btype) {
    case BT_INT8: case BT_CHAR: return 1;
    case BT_INT16: return 2;
    case BT_INT32: case BT_FLOAT: return 4;
    default: return -1;
  }
}

int32_t read_int_at(const Cursor& c, int btype, int64_t off) {
  if (btype == BT_INT8) {
    int8_t v; std::memcpy(&v, c.d + off, 1);
    if (v == -128) return I32_MISSING;
    if (v == -127) return I32_EOV;
    return v;
  }
  if (btype == BT_INT16) {
    int16_t v; std::memcpy(&v, c.d + off, 2);
    if (v == -32768) return I32_MISSING;
    if (v == -32767) return I32_EOV;
    return v;
  }
  int32_t v; std::memcpy(&v, c.d + off, 4);
  return v;
}

bool read_typed(Cursor& c, Typed& t) {
  uint8_t desc = c.u8();
  if (c.bad) return false;
  t.n = desc >> 4;
  t.btype = desc & 0xF;
  if (t.n == 15) {
    Typed nt;
    if (!read_typed(c, nt)) return false;
    if (nt.n < 1 || elem_size(nt.btype) < 0) { c.bad = true; return false; }
    t.n = read_int_at(c, nt.btype, nt.off);
    if (t.n < 0) { c.bad = true; return false; }
  }
  t.off = c.o;
  if (t.n > 0) {
    int es = elem_size(t.btype);
    if (es < 0) { c.bad = true; return false; }
    if (!c.need(t.n * es)) return false;
    c.o += t.n * es;
  }
  return true;
}

void put_string_name(Out& out, const char* blob, const int64_t* offs,
                     int64_t n_names, int64_t idx, bool* bad) {
  if (idx < 0 || idx >= n_names) { *bad = true; return; }
  out.put(blob + offs[idx], offs[idx + 1] - offs[idx]);
}

// GT rendering (vcf/bcf.py _decode_gt): stop at vector-end; allele 0
// encoding means '.', separator phase from the CURRENT element.
void put_gt(Out& out, const Cursor& c, int btype, int64_t off,
            int64_t width) {
  int es = elem_size(btype);
  bool any = false;
  for (int64_t i = 0; i < width; ++i) {
    int32_t v = (btype == BT_FLOAT)
        ? I32_EOV   // float GT is malformed; render as empty
        : read_int_at(c, btype, off + i * es);
    if (v == I32_EOV) break;
    if (i > 0) out.put((v & 1) ? '|' : '/');
    if ((v >> 1) == 0) out.put('.');
    else out.put_i64((v >> 1) - 1);
    any = true;
  }
  if (!any) out.put('.');
}

}  // namespace

extern "C" int64_t gdb_bcf_decode_records(
    const uint8_t* body, int64_t body_len,
    const char* contig_blob, const int64_t* contig_offs,
    int64_t n_contig,
    const char* str_blob, const int64_t* str_offs, int64_t n_str,
    const uint8_t* str_is_gt,
    int32_t n_sample,
    char* out_buf, int64_t cap) {
  Cursor c{body, body_len};
  Out out{out_buf, cap};
  bool bad = false;
  while (c.o < c.n && !c.bad && !bad) {
    uint32_t l_shared = c.u32();
    uint32_t l_indiv = c.u32();
    if (c.bad || !c.need((int64_t)l_shared + l_indiv)) { c.bad = true; break; }
    int64_t end_shared = c.o + l_shared;
    int64_t end_indiv = end_shared + l_indiv;
    int32_t rid = c.i32();
    int32_t pos = c.i32();
    c.i32();                        // rlen (unused by the text form)
    uint32_t qbits = c.u32();
    uint32_t x = c.u32();
    int64_t n_allele = x >> 16, n_info = x & 0xFFFF;
    uint32_t y = c.u32();
    int64_t n_fmt = y >> 24;
    // CHROM POS
    put_string_name(out, contig_blob, contig_offs, n_contig, rid, &bad);
    out.put('\t');
    out.put_i64((int64_t)pos + 1);
    out.put('\t');
    // ID
    Typed t;
    if (!read_typed(c, t)) break;
    if (t.btype == BT_CHAR && t.n > 0)
      out.put((const char*)c.d + t.off, t.n);
    else
      out.put('.');
    out.put('\t');
    // REF / ALT
    for (int64_t a = 0; a < n_allele; ++a) {
      if (!read_typed(c, t)) { bad = true; break; }
      if (a > 1) out.put(',');
      out.put((const char*)c.d + t.off, t.n);
      if (a == 0) out.put('\t');
    }
    if (bad || c.bad) break;
    if (n_allele <= 1) out.put('.');
    out.put('\t');
    // QUAL
    if (qbits == F_MISSING) out.put('.');
    else put_float_bits(out, qbits);
    out.put('\t');
    // FILTER
    if (!read_typed(c, t)) break;
    if (t.n == 0) out.put('.');
    else {
      int es = elem_size(t.btype);
      for (int64_t i = 0; i < t.n; ++i) {
        if (i) out.put(';');
        int32_t v = read_int_at(c, t.btype, t.off + i * es);
        put_string_name(out, str_blob, str_offs, n_str, v, &bad);
      }
    }
    out.put('\t');
    // INFO
    if (n_info == 0) out.put('.');
    for (int64_t i = 0; i < n_info && !bad; ++i) {
      if (i) out.put(';');
      Typed kt, vt;
      if (!read_typed(c, kt)) { bad = true; break; }
      int kes = elem_size(kt.btype);
      if (kt.n < 1 || kt.btype == BT_CHAR || kt.btype == BT_FLOAT) {
        bad = true; break;
      }
      int32_t key = read_int_at(c, kt.btype, kt.off);
      put_string_name(out, str_blob, str_offs, n_str, key, &bad);
      if (!read_typed(c, vt)) { bad = true; break; }
      (void)kes;
      if (vt.n == 0) continue;      // flag
      out.put('=');
      if (vt.btype == BT_CHAR) {
        out.put((const char*)c.d + vt.off, vt.n);
      } else if (vt.btype == BT_FLOAT) {
        for (int64_t k = 0; k < vt.n; ++k) {
          if (k) out.put(',');
          uint32_t b; std::memcpy(&b, c.d + vt.off + 4 * k, 4);
          put_float_bits(out, b);
        }
      } else {
        int es = elem_size(vt.btype);
        for (int64_t k = 0; k < vt.n; ++k) {
          if (k) out.put(',');
          int32_t v = read_int_at(c, vt.btype, vt.off + k * es);
          if (v == I32_MISSING) out.put('.');
          else out.put_i64(v);
        }
      }
    }
    if (bad || c.bad) break;
    if (c.o != end_shared) { bad = true; break; }
    // FORMAT names + per-sample columns
    if (n_fmt > 0) {
      out.put('\t');
      // first pass: collect the n_fmt (key, descriptor) layout
      constexpr int MAXF = 64;
      if (n_fmt > MAXF) { bad = true; break; }
      int32_t keys[MAXF];
      Typed vts[MAXF];
      int64_t widths[MAXF];
      for (int64_t f = 0; f < n_fmt; ++f) {
        Typed kt;
        if (!read_typed(c, kt)) { bad = true; break; }
        if (kt.n < 1 || kt.btype == BT_CHAR || kt.btype == BT_FLOAT) {
          bad = true; break;
        }
        keys[f] = read_int_at(c, kt.btype, kt.off);
        // per-sample descriptor: width applies to EVERY sample
        uint8_t desc = c.u8();
        if (c.bad) { bad = true; break; }
        int64_t w = desc >> 4;
        int bt = desc & 0xF;
        if (w == 15) {
          Typed nt;
          if (!read_typed(c, nt)) { bad = true; break; }
          if (elem_size(nt.btype) < 0 || nt.btype == BT_CHAR ||
              nt.btype == BT_FLOAT) { bad = true; break; }
          w = read_int_at(c, nt.btype, nt.off);
        }
        int es = elem_size(bt);
        if (es < 0 || w < 0) { bad = true; break; }
        vts[f].btype = bt;
        vts[f].off = c.o;
        widths[f] = w;
        if (!c.need(w * es * (int64_t)n_sample)) { bad = true; break; }
        c.o += w * es * (int64_t)n_sample;
        if (f) out.put(':');
        put_string_name(out, str_blob, str_offs, n_str, keys[f], &bad);
        if (bad) break;
      }
      if (bad || c.bad) break;
      for (int32_t s = 0; s < n_sample && !bad; ++s) {
        out.put('\t');
        for (int64_t f = 0; f < n_fmt; ++f) {
          if (f) out.put(':');
          int bt = vts[f].btype;
          int es = elem_size(bt);
          int64_t w = widths[f];
          int64_t off = vts[f].off + w * es * (int64_t)s;
          bool is_gt = keys[f] >= 0 && keys[f] < n_str
                       && str_is_gt[keys[f]];
          if (bt == BT_CHAR) {
            int64_t k = w;
            while (k > 0 && c.d[off + k - 1] == 0) --k;
            if (k == 0) out.put('.');
            else out.put((const char*)c.d + off, k);
          } else if (is_gt) {
            put_gt(out, c, bt, off, w);
          } else if (bt == BT_FLOAT) {
            bool any = false;
            for (int64_t k = 0; k < w; ++k) {
              uint32_t b; std::memcpy(&b, c.d + off + 4 * k, 4);
              if (b == F_EOV) continue;   // python filters EOV anywhere
              if (any) out.put(',');
              put_float_bits(out, b);
              any = true;
            }
            if (!any) out.put('.');
          } else {
            bool any = false;
            for (int64_t k = 0; k < w; ++k) {
              int32_t v = read_int_at(c, bt, off + k * es);
              if (v == I32_EOV) continue;
              if (any) out.put(',');
              if (v == I32_MISSING) out.put('.');
              else out.put_i64(v);
              any = true;
            }
            if (!any) out.put('.');
          }
        }
      }
    }
    if (bad || c.bad) break;
    if (c.o != end_indiv) { bad = true; break; }
    out.put('\n');
    if (out.overflow) return -1;
  }
  if (out.overflow) return -1;
  if (bad || c.bad || c.o != c.n) return -2;
  return out.len;
}
