// Native import kernels: VCF record tokenizer + numeric list parsers.
//
// The host-side equivalent of the reference's htslib-backed decode hot path
// (reference src/main/cpp/src/vcf/vcf2binary.cc:481-546 prefetch +
// :991-1160 per-callset serialization): byte-crunching runs here, the
// vid-driven cell assembly stays in Python, and the columnar arrays upload
// to the device unchanged.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).
//
// Build: make -C genomicsdb_tpu/runtime/native

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <thread>
#include <cmath>
#include <cstdio>
#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <functional>
#include <mutex>
#ifdef __linux__
#include <sched.h>
#endif

// ---------------------------------------------------------------------------
// Persistent worker pool.  Per-call std::thread spawning costs ~0.5-1 ms
// per parallel section, which dominates small interval queries (the
// GATK split pattern fires 4-6 parallel sections per query).  Workers
// are created once, woken by epoch, and chunks are work-stealing via an
// atomic cursor; the caller participates.  Runs are serialized by
// run_mu (concurrent sections would contend for the same cores anyway).
// The pool is intentionally leaked: joining detached workers in static
// destructors deadlocks on some libc exit paths.
// ---------------------------------------------------------------------------

namespace gdbpool {

struct Pool {
  std::vector<std::thread> workers;
  std::mutex mu;
  std::mutex run_mu;
  std::condition_variable cv_work;
  std::condition_variable cv_done;
  const std::function<void(int64_t, int64_t)>* fn = nullptr;
  int64_t chunk = 0;
  int64_t n = 0;
  std::atomic<int64_t> next{0};
  std::atomic<int> active{0};
  uint64_t epoch = 0;
  int nworkers;

  Pool() {
    unsigned hw = std::thread::hardware_concurrency();
    int total = hw ? static_cast<int>(hw) : 4;
#ifdef __linux__
    // respect CPU affinity (taskset / rank-per-core pinning): a worker
    // pinned to one core must not spawn threads that fight for it
    cpu_set_t cs;
    if (sched_getaffinity(0, sizeof(cs), &cs) == 0) {
      const int c = CPU_COUNT(&cs);
      if (c > 0 && c < total) total = c;
    }
#endif
    if (total > 8) total = 8;
    nworkers = total - 1;                  // the caller participates
    for (int i = 0; i < nworkers; ++i)
      workers.emplace_back([this]() { worker(); });
  }

  void run_chunks(const std::function<void(int64_t, int64_t)>& f) {
    for (;;) {
      const int64_t lo = next.fetch_add(chunk);
      if (lo >= n) return;
      f(lo, std::min(n, lo + chunk));
    }
  }

  void worker() {
    uint64_t seen = 0;
    for (;;) {
      const std::function<void(int64_t, int64_t)>* f;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] { return epoch != seen; });
        seen = epoch;
        f = fn;
      }
      run_chunks(*f);
      if (active.fetch_sub(1) == 1) {
        std::lock_guard<std::mutex> lg(mu);
        cv_done.notify_all();
      }
    }
  }

  void run(int64_t total, const std::function<void(int64_t, int64_t)>& f) {
    if (nworkers <= 0) { f(0, total); return; }
    std::lock_guard<std::mutex> serial(run_mu);
    {
      std::lock_guard<std::mutex> lg(mu);
      fn = &f;
      n = total;
      chunk = std::max<int64_t>(1, total / ((nworkers + 1) * 4));
      next.store(0, std::memory_order_relaxed);
      active.store(nworkers, std::memory_order_relaxed);
      ++epoch;
      cv_work.notify_all();
    }
    run_chunks(f);
    std::unique_lock<std::mutex> lk(mu);
    cv_done.wait(lk, [&] { return active.load() == 0; });
  }
};

inline Pool& pool() {
  static Pool* p = new Pool();           // leaked by design (see above)
  return *p;
}

// Parallel-for over [0, n): f(lo, hi) on pool workers + caller when
// `work` (approximate total elements) crosses the threading threshold.
template <typename F>
inline void par_for(int64_t n, F f, int64_t work) {
  if (n <= 0) return;
  if (work < 16384 || n < 2) { f(int64_t(0), n); return; }
  const std::function<void(int64_t, int64_t)> fn = f;
  pool().run(n, fn);
}

}  // namespace gdbpool

namespace {

constexpr int32_t INT_MISSING = INT32_MIN;
constexpr uint32_t FLOAT_MISSING_BITS = 0x7F800001u;

inline float float_missing() {
  float f;
  uint32_t b = FLOAT_MISSING_BITS;
  std::memcpy(&f, &b, sizeof(f));
  return f;
}

// Fast int parse over [p, end); '.' or empty -> missing.  Returns false
// on a malformed token (non-digit, e.g. "2.5") or int32 overflow so the
// caller can fail loudly — the pure-Python loader raises ValueError /
// OverflowError on the same inputs and the two must not diverge.
inline bool parse_int(const char* p, const char* end, int32_t* out) {
  if (p >= end || (*p == '.' && p + 1 == end)) {
    *out = INT_MISSING;
    return true;
  }
  bool neg = false;
  if (*p == '-') { neg = true; ++p; }
  if (p >= end) return false;
  int64_t v = 0;
  for (; p < end; ++p) {
    if (*p < '0' || *p > '9') return false;
    v = v * 10 + (*p - '0');
    if (v > INT32_MAX) return false;
  }
  v = neg ? -v : v;
  // INT32_MIN itself is the missing sentinel: a literal -2147483648
  // cannot be represented and counts as out of range
  if (v <= INT32_MIN || v > INT32_MAX) return false;
  *out = static_cast<int32_t>(v);
  return true;
}

inline float parse_float(const char* p, const char* end) {
  if (p >= end || (*p == '.' && p + 1 == end)) return float_missing();
  char buf[64];
  size_t n = static_cast<size_t>(end - p);
  if (n >= sizeof(buf)) n = sizeof(buf) - 1;
  std::memcpy(buf, p, n);
  buf[n] = 0;
  char* e = nullptr;
  float v = std::strtof(buf, &e);
  if (e == buf) return float_missing();
  return v;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Record tokenizer.
//
// Scans the record section of a VCF text (no header lines) and emits, per
// record, the byte offsets of each tab-separated column.  Caller passes
// pre-sized output arrays:
//   col_offsets: [max_records * (max_cols + 1)] int64 — column k of record
//                r spans [col_offsets[r*(max_cols+1)+k],
//                         col_offsets[r*(max_cols+1)+k+1] - 1)  (the -1
//                drops the delimiter; the last real column ends at the
//                newline).
//   num_cols:    [max_records] int32 — actual #columns of each record.
// Returns the number of records tokenized (<= max_records), or -1 if the
// buffers were too small.
// ---------------------------------------------------------------------------
int64_t gdb_tokenize_records(const char* text, int64_t len,
                             int64_t max_records, int32_t max_cols,
                             int64_t* col_offsets, int32_t* num_cols) {
  int64_t rec = 0;
  int64_t i = 0;
  const int64_t stride = max_cols + 1;
  while (i < len) {
    // skip blank lines
    if (text[i] == '\n') { ++i; continue; }
    if (rec >= max_records) return -1;
    int64_t* offs = col_offsets + rec * stride;
    int32_t ncol = 0;
    offs[0] = i;
    while (i < len && text[i] != '\n') {
      if (text[i] == '\t') {
        if (ncol + 1 >= max_cols) return -1;
        offs[++ncol] = i + 1;
      }
      ++i;
    }
    offs[++ncol] = i + 1;  // past-newline sentinel (or past-EOF)
    num_cols[rec] = ncol;
    ++rec;
    ++i;  // past newline
  }
  return rec;
}

// ---------------------------------------------------------------------------
// Batched delimited-number parsing.
//
// For n spans [starts[i], ends[i]) of `text`, split on `delim` and parse
// elements as int32 (missing '.' -> INT32_MIN).  Output is a ragged pair
// (values, offsets): offsets has n+1 entries; values must hold
// sum(#elements).  Empty spans produce zero elements.
// Returns total #values written, -1 on overflow of values_cap, or -2 on
// a malformed / out-of-int32-range token.
// ---------------------------------------------------------------------------
int64_t gdb_parse_int_lists(const char* text, const int64_t* starts,
                            const int64_t* ends, int64_t n, char delim,
                            int32_t* values, int64_t values_cap,
                            int64_t* offsets) {
  int64_t total = 0;
  offsets[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    const char* p = text + starts[i];
    const char* lim = text + ends[i];
    if (p >= lim) { offsets[i + 1] = total; continue; }
    const char* tok = p;
    for (const char* q = p;; ++q) {
      if (q == lim || *q == delim) {
        if (total >= values_cap) return -1;
        if (!parse_int(tok, q, &values[total])) return -2;
        ++total;
        tok = q + 1;
        if (q == lim) break;
      }
    }
    offsets[i + 1] = total;
  }
  return total;
}

int64_t gdb_parse_float_lists(const char* text, const int64_t* starts,
                              const int64_t* ends, int64_t n, char delim,
                              float* values, int64_t values_cap,
                              int64_t* offsets) {
  int64_t total = 0;
  offsets[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    const char* p = text + starts[i];
    const char* lim = text + ends[i];
    if (p >= lim) { offsets[i + 1] = total; continue; }
    const char* tok = p;
    for (const char* q = p;; ++q) {
      if (q == lim || *q == delim) {
        if (total >= values_cap) return -1;
        values[total++] = parse_float(tok, q);
        tok = q + 1;
        if (q == lim) break;
      }
    }
    offsets[i + 1] = total;
  }
  return total;
}

// ---------------------------------------------------------------------------
// GT parser: spans of "a/b|c" genotype strings -> allele idx vectors,
// optionally interleaved with phase flags (reference vcf2binary.cc
// m_store_phase_information_for_GT).  '.' alleles -> -1.
// ---------------------------------------------------------------------------
int64_t gdb_parse_gt(const char* text, const int64_t* starts,
                     const int64_t* ends, int64_t n, int store_phase,
                     int32_t* values, int64_t values_cap,
                     int64_t* offsets) {
  int64_t total = 0;
  offsets[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    const char* p = text + starts[i];
    const char* lim = text + ends[i];
    if (p >= lim) { offsets[i + 1] = total; continue; }
    const char* tok = p;
    bool first = true;
    for (const char* q = p;; ++q) {
      if (q == lim || *q == '/' || *q == '|') {
        int32_t allele = -1;
        if (!(q == tok || (*tok == '.' && q == tok + 1))) {
          if (!parse_int(tok, q, &allele)) return -2;
          if (allele == INT_MISSING) allele = -1;
        }
        if (!first && store_phase) {
          if (total >= values_cap) return -1;
          // phase flag of the PREVIOUS separator
          values[total++] = (*(tok - 1) == '|') ? 1 : 0;
        }
        if (total >= values_cap) return -1;
        values[total++] = allele;
        first = false;
        tok = q + 1;
        if (q == lim) break;
      }
    }
    offsets[i + 1] = total;
  }
  return total;
}

// ---------------------------------------------------------------------------
// Sub-field splitter: within n spans, find the k-th `delim`-separated
// sub-span (used for FORMAT sample columns "GT:AD:DP" -> field k).
// Writes out_starts/out_ends (absolute offsets); missing -> start==end.
// ---------------------------------------------------------------------------
void gdb_split_field(const char* text, const int64_t* starts,
                     const int64_t* ends, int64_t n, char delim,
                     int32_t field_idx, int64_t* out_starts,
                     int64_t* out_ends) {
  for (int64_t i = 0; i < n; ++i) {
    const char* base = text;
    int64_t s = starts[i];
    int64_t e = ends[i];
    int32_t k = 0;
    int64_t fs = s;
    int64_t fe = e;
    bool found = (field_idx == 0);
    for (int64_t j = s; j <= e; ++j) {
      if (j == e || base[j] == delim) {
        if (k == field_idx) {
          fe = j;
          found = true;
          break;
        }
        ++k;
        fs = j + 1;
      }
    }
    if (!found || fs > e) {
      out_starts[i] = 0;
      out_ends[i] = 0;
    } else {
      out_starts[i] = fs;
      out_ends[i] = fe;
    }
  }
}

// ---------------------------------------------------------------------------
// Multi-field splitter: like gdb_split_field but resolves ALL requested
// field indices in ONE scan per span (a sample column "GT:AD:DP:..." is
// scanned once for every FORMAT field instead of once per field).
// field_idxs must be ascending; outputs are [k, n] row-major.
// Missing fields -> start==end==0 (matches gdb_split_field).
// ---------------------------------------------------------------------------
void gdb_split_fields_multi(const char* text, const int64_t* starts,
                            const int64_t* ends, int64_t n, char delim,
                            const int32_t* field_idxs, int32_t k,
                            int64_t* out_starts, int64_t* out_ends) {
  for (int64_t i = 0; i < n; ++i) {
    const int64_t s = starts[i];
    const int64_t e = ends[i];
    int32_t fld = 0;
    int32_t ki = 0;
    int64_t fs = s;
    for (int64_t j = s; j <= e && ki < k; ++j) {
      if (j == e || text[j] == delim) {
        while (ki < k && field_idxs[ki] == fld) {
          out_starts[ki * n + i] = fs;
          out_ends[ki * n + i] = j;
          ++ki;
        }
        ++fld;
        fs = j + 1;
      }
    }
    for (; ki < k; ++ki) {  // fields past the span's last sub-field
      out_starts[ki * n + i] = 0;
      out_ends[ki * n + i] = 0;
    }
  }
}

// ---------------------------------------------------------------------------
// Cohort-wide FORMAT parsing (the import hot path at production width).
//
// One call parses EVERY mapped sample of a FORMAT-signature group for
// every requested field, two-pass:
//   mode 0 (count): per-cell element counts -> lens[cid] per field
//     (cid = rec * K_s + k, the final cell layout), with the
//     all-elements-missing rule (a numeric field whose span contains
//     no character outside {'.', ','} is invalid -> 0; reference
//     variant_field_data.h:360-384) applied during the scan.
//   mode 1 (parse): values written straight at their final offsets
//     (ragged: offsets[cid]; fixed: mat[cid * width]), skipping cells
//     counted 0.
// Replaces the per-(signature x sample) Python jobs (split + parse +
// reduceat + scatter, ~16 interpreter ops per sample) whose GIL-bound
// glue capped 1000-wide imports at ~240k cells/s.
// Parallel over records via the worker pool.  Field positions fidxs
// must be ascending (one ':' scan per sample cell resolves all).
// kinds: 0 = int list, 1 = float list, 2 = GT, 3 = GT with interleaved
// phase (vcf2binary.cc m_store_phase_information_for_GT).
// Returns 0, or -2 on a malformed numeric token.
// ---------------------------------------------------------------------------
int gdb_fmt_cohort(
    const char* text, const int64_t* offs, int64_t stride,
    const int64_t* recs, int64_t R,
    const int64_t* scols, int64_t K, int64_t K_s,
    const int32_t* fidxs, const int32_t* kinds, int64_t F,
    int mode,
    const void* const* lens_ptrs,
    const void* const* offs_ptrs,
    const void* const* vals_ptrs,
    const int32_t* dst_fixed_w) {
  std::atomic<int> rc{0};
  auto body = [&](int64_t r0, int64_t r1) {
    std::vector<int64_t> fs(F), fe(F);
    for (int64_t r = r0; r < r1; ++r) {
      const int64_t rec = recs[r];
      const int64_t* ro = offs + rec * stride;
      for (int64_t k = 0; k < K; ++k) {
        const int64_t cid = rec * K_s + k;
        const int64_t s = ro[scols[k]];
        const int64_t e = ro[scols[k] + 1] - 1;
        // one ':' scan resolves every requested field position
        {
          int32_t fld = 0;
          int64_t ki = 0;
          int64_t cur = s;
          for (int64_t j = s; j <= e && ki < F; ++j) {
            if (j == e || text[j] == ':') {
              while (ki < F && fidxs[ki] == fld) {
                fs[ki] = cur;
                fe[ki] = j;
                ++ki;
              }
              ++fld;
              cur = j + 1;
            }
          }
          for (; ki < F; ++ki) { fs[ki] = 0; fe[ki] = 0; }
        }
        for (int64_t f = 0; f < F; ++f) {
          const char* p = text + fs[f];
          const char* lim = text + fe[f];
          const int32_t kind = kinds[f];
          int64_t* lens = static_cast<int64_t*>(
              const_cast<void*>(lens_ptrs[f]));
          if (mode == 0) {
            int64_t cnt = 0;
            if (p < lim) {
              if (kind >= 2) {                       // GT
                int64_t a = 1;
                for (const char* q = p; q < lim; ++q)
                  if (*q == '/' || *q == '|') ++a;
                cnt = (kind == 3) ? 2 * a - 1 : a;
              } else {
                // invalid only when the field is a SINGLE missing
                // value (reference convert_field_to_tiledb:
                // num_values == 1 && missing); ".,." stays a valid
                // 2-vector of missing elements
                int64_t nsep = 0;
                for (const char* q = p; q < lim; ++q)
                  if (*q == ',') ++nsep;
                cnt = (nsep == 0 && lim - p == 1 && *p == '.')
                          ? 0 : nsep + 1;
              }
            }
            lens[cid] = cnt;
            continue;
          }
          // mode 1: parse values at their final destination
          if (lens[cid] <= 0) continue;
          const int32_t w_fixed = dst_fixed_w[f];
          if (kind >= 2) {                           // GT
            int32_t* dst;
            const int64_t* off64 = static_cast<const int64_t*>(
                offs_ptrs[f]);
            dst = static_cast<int32_t*>(
                const_cast<void*>(vals_ptrs[f])) + off64[cid];
            const char* tok = p;
            bool first = true;
            for (const char* q = p;; ++q) {
              if (q == lim || *q == '/' || *q == '|') {
                int32_t allele = -1;
                if (!(q == tok || (*tok == '.' && q == tok + 1))) {
                  if (!parse_int(tok, q, &allele)) {
                    rc.store(-2);
                    return;
                  }
                  if (allele == INT32_MIN) allele = -1;
                }
                if (!first && kind == 3)
                  *dst++ = (*(tok - 1) == '|') ? 1 : 0;
                *dst++ = allele;
                first = false;
                tok = q + 1;
                if (q == lim) break;
              }
            }
            continue;
          }
          const bool is_float = kind == 1;
          int64_t j = 0;
          int32_t* di = nullptr;
          float* df = nullptr;
          if (w_fixed > 0) {
            if (is_float)
              df = static_cast<float*>(
                  const_cast<void*>(vals_ptrs[f])) + cid * w_fixed;
            else
              di = static_cast<int32_t*>(
                  const_cast<void*>(vals_ptrs[f])) + cid * w_fixed;
          } else {
            const int64_t* off64 = static_cast<const int64_t*>(
                offs_ptrs[f]);
            if (is_float)
              df = static_cast<float*>(
                  const_cast<void*>(vals_ptrs[f])) + off64[cid];
            else
              di = static_cast<int32_t*>(
                  const_cast<void*>(vals_ptrs[f])) + off64[cid];
          }
          const char* tok = p;
          for (const char* q = p;; ++q) {
            if (q == lim || *q == ',') {
              if (w_fixed <= 0 || j < w_fixed) {
                if (is_float) {
                  df[j] = parse_float(tok, q);
                } else if (!parse_int(tok, q, &di[j])) {
                  rc.store(-2);
                  return;
                }
              }
              ++j;
              tok = q + 1;
              if (q == lim) break;
            }
          }
        }
      }
    }
  };
  gdbpool::par_for(R, body, R * K * (F > 0 ? F : 1) * 4);
  return rc.load();
}

// ---------------------------------------------------------------------------
// Record-prefix kernels: the per-record byte work of the import fast path
// (CHROM runs, REF/ALT extraction, INFO key lookup) that would otherwise be
// 200k-iteration Python loops (reference hot path: vcf2binary.cc:991-1160).
// ---------------------------------------------------------------------------

// Copy n byte spans into one contiguous blob + offsets.  Returns total
// bytes, or -1 if out_cap too small.
int64_t gdb_extract_spans(const char* text, const int64_t* starts,
                          const int64_t* ends, int64_t n, char* out,
                          int64_t out_cap, int64_t* out_offs) {
  int64_t w = 0;
  out_offs[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t len = ends[i] - starts[i];
    if (len < 0) len = 0;
    if (w + len > out_cap) return -1;
    std::memcpy(out + w, text + starts[i], static_cast<size_t>(len));
    w += len;
    out_offs[i + 1] = w;
  }
  return w;
}

// ALT-column transform (vcf2binary.cc:1048-1076 serialization form):
// ',' -> '|', "<NON_REF>" -> '&', "." -> empty.  Also flags records with a
// deletion allele (non-symbolic ALT strictly shorter than REF,
// VariantUtils::is_deletion) for the deletions-as-intervals END rule.
// ref spans give REF lengths.  Returns blob bytes or -1 on overflow.
namespace {
inline bool alt_is_symbolic(const char* p, int64_t len) {
  if (len == 0) return false;
  char a = p[0], b = p[len - 1];
  return a == '<' || b == '>' || (len == 1 && a == '*') || a == '[' ||
         b == '[' || a == ']' || b == ']';
}
}  // namespace

int64_t gdb_transform_alt(const char* text, const int64_t* starts,
                          const int64_t* ends, const int64_t* ref_starts,
                          const int64_t* ref_ends, int64_t n, char* out,
                          int64_t out_cap, int64_t* out_offs,
                          uint8_t* del_flag) {
  int64_t w = 0;
  out_offs[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    const char* p = text + starts[i];
    const char* lim = text + ends[i];
    const int64_t ref_len = ref_ends[i] - ref_starts[i];
    uint8_t del = 0;
    if (!(lim - p == 1 && *p == '.')) {
      const char* tok = p;
      for (const char* q = p;; ++q) {
        if (q == lim || *q == ',') {
          int64_t len = q - tok;
          if (len == 9 && std::memcmp(tok, "<NON_REF>", 9) == 0) {
            if (w + 1 > out_cap) return -1;
            out[w++] = '&';
          } else {
            if (w + len > out_cap) return -1;
            std::memcpy(out + w, tok, static_cast<size_t>(len));
            w += len;
            if (!del && len < ref_len && !alt_is_symbolic(tok, len))
              del = 1;
          }
          if (q == lim) break;
          if (w + 1 > out_cap) return -1;
          out[w++] = '|';
          tok = q + 1;
        }
      }
    }
    del_flag[i] = del;
    out_offs[i + 1] = w;
  }
  return w;
}

// Intern n byte spans: identical spans share a group id (first-seen order).
// uniq_idx[g] = index of the first span with group g.  Returns the number
// of distinct spans, or -1 if it exceeds max_uniq.
int64_t gdb_intern_spans(const char* text, const int64_t* starts,
                         const int64_t* ends, int64_t n, int32_t* gids,
                         int64_t* uniq_idx, int64_t max_uniq) {
  uint64_t cap = 64;
  while (cap < static_cast<uint64_t>(max_uniq) * 4) cap <<= 1;
  std::vector<int64_t> table(cap, -1);  // slot -> uniq id
  std::vector<uint64_t> hashes(cap, 0);
  int64_t n_uniq = 0;
  for (int64_t i = 0; i < n; ++i) {
    const char* p = text + starts[i];
    const int64_t len = ends[i] - starts[i] < 0 ? 0 : ends[i] - starts[i];
    uint64_t h = 1469598103934665603ull;  // FNV-1a
    for (int64_t j = 0; j < len; ++j) {
      h ^= static_cast<uint8_t>(p[j]);
      h *= 1099511628211ull;
    }
    uint64_t slot = h & (cap - 1);
    int32_t gid = -1;
    for (;;) {
      int64_t g = table[slot];
      if (g < 0) {
        if (n_uniq >= max_uniq) return -1;
        table[slot] = n_uniq;
        hashes[slot] = h;
        uniq_idx[n_uniq] = i;
        gid = static_cast<int32_t>(n_uniq++);
        break;
      }
      if (hashes[slot] == h) {
        const int64_t fi = uniq_idx[g];
        const int64_t flen = ends[fi] - starts[fi];
        if (flen == len &&
            std::memcmp(text + starts[fi], p,
                        static_cast<size_t>(len)) == 0) {
          gid = static_cast<int32_t>(g);
          break;
        }
      }
      slot = (slot + 1) & (cap - 1);
    }
    gids[i] = gid;
  }
  return n_uniq;
}

// Resolve k INFO keys over n "K=V;K2;K3=V3" spans in one pass.
// Outputs [k, n] row-major value spans (start==end==0 when absent) and a
// presence byte (1 when the key appears, with or without '=' — flag
// fields).  A later duplicate key overwrites (dict semantics of the
// Python loader).  '.' spans have no entries.
void gdb_info_values(const char* text, const int64_t* starts,
                     const int64_t* ends, int64_t n,
                     const char* keys_blob, const int64_t* key_offs,
                     int32_t k, int64_t* val_starts, int64_t* val_ends,
                     uint8_t* present) {
  std::memset(present, 0, static_cast<size_t>(k) * n);
  for (int64_t col = 0; col < static_cast<int64_t>(k) * n; ++col) {
    val_starts[col] = 0;
    val_ends[col] = 0;
  }
  for (int64_t i = 0; i < n; ++i) {
    const char* p = text + starts[i];
    const char* lim = text + ends[i];
    if (lim - p == 1 && *p == '.') continue;
    const char* entry = p;
    for (const char* q = p;; ++q) {
      if (q == lim || *q == ';') {
        // entry spans [entry, q)
        const char* eq = entry;
        while (eq < q && *eq != '=') ++eq;
        const int64_t klen = eq - entry;
        if (klen > 0) {
          for (int32_t j = 0; j < k; ++j) {
            if (key_offs[j + 1] - key_offs[j] == klen &&
                std::memcmp(keys_blob + key_offs[j], entry,
                            static_cast<size_t>(klen)) == 0) {
              present[j * n + i] = 1;
              if (eq < q) {
                val_starts[j * n + i] = (eq + 1) - text;
                val_ends[j * n + i] = q - text;
              } else {
                val_starts[j * n + i] = 0;
                val_ends[j * n + i] = 0;
              }
              break;
            }
          }
        }
        if (q == lim) break;
        entry = q + 1;
      }
    }
  }
}

// Batched ragged segment copy: out[dest0[i] .. dest0[i]+len[i]) =
// src[src0[i] .. src0[i]+len[i]) per segment (offsets in elements).
// The native form of the numpy _ragged_arange + double-fancy-index
// gather that dominates columnar (re)assembly.
void gdb_copy_segments(const char* src, const int64_t* src0,
                       const int64_t* lens, const int64_t* dest0,
                       int64_t n, int64_t elem_size, char* out) {
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i)
    if (lens[i] > 0) total += lens[i];
  gdbpool::par_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      if (lens[i] > 0)
        std::memcpy(out + dest0[i] * elem_size,
                    src + src0[i] * elem_size,
                    static_cast<size_t>(lens[i] * elem_size));
    }
  }, total * elem_size / 16);   // memcpy is cheap per element
}

// Replicate a per-record ragged array to K consecutive cells per record:
// out cell r*K+j gets record r's payload.  Element size in bytes (1 for
// text, 4 for int32/float32).  Returns total out elements or -1.
int64_t gdb_replicate_ragged(const char* values, int64_t elem_size,
                             const int64_t* rec_offs, int64_t n, int64_t K,
                             char* out, int64_t out_cap_elems,
                             int64_t* out_offs) {
  int64_t w = 0;
  out_offs[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t lo = rec_offs[i], hi = rec_offs[i + 1];
    const int64_t len = hi - lo;
    for (int64_t j = 0; j < K; ++j) {
      if (w + len > out_cap_elems) return -1;
      if (len)
        std::memcpy(out + w * elem_size, values + lo * elem_size,
                    static_cast<size_t>(len * elem_size));
      w += len;
      out_offs[i * K + j + 1] = w;
    }
  }
  return w;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Output rendering kernels (the combined-VCF text edge).
// ---------------------------------------------------------------------------

extern "C" {

// Render n ragged int32 vectors as delimited decimal text.
// offsets: [n+1]; INT32_MIN renders '.'; a row of length 0 renders '.'.
// Returns bytes written or -1 on overflow.
int64_t gdb_render_int_lists(const int32_t* values, const int64_t* offsets,
                             int64_t n, char delim, char* out,
                             int64_t out_cap, int64_t* out_offsets) {
  int64_t w = 0;
  out_offsets[0] = 0;
  char buf[16];
  for (int64_t i = 0; i < n; ++i) {
    int64_t lo = offsets[i], hi = offsets[i + 1];
    if (hi <= lo) {
      if (w + 1 > out_cap) return -1;
      out[w++] = '.';
      out_offsets[i + 1] = w;
      continue;
    }
    for (int64_t j = lo; j < hi; ++j) {
      if (j > lo) {
        if (w + 1 > out_cap) return -1;
        out[w++] = delim;
      }
      int32_t v = values[j];
      if (v == INT32_MIN) {
        if (w + 1 > out_cap) return -1;
        out[w++] = '.';
        continue;
      }
      // int -> decimal
      char* p = buf + sizeof(buf);
      bool neg = v < 0;
      uint32_t u = neg ? static_cast<uint32_t>(-(int64_t)v)
                       : static_cast<uint32_t>(v);
      do { *--p = '0' + (u % 10); u /= 10; } while (u);
      if (neg) *--p = '-';
      int64_t len = buf + sizeof(buf) - p;
      if (w + len > out_cap) return -1;
      std::memcpy(out + w, p, len);
      w += len;
    }
    out_offsets[i + 1] = w;
  }
  return w;
}

// Join consecutive groups of `group` rows with `delim`:
// n input rows -> n/group output rows.  Returns bytes written or -1.
int64_t gdb_join_rows(const char* values, const int64_t* offsets, int64_t n,
                      int64_t group, char delim, char* out, int64_t out_cap,
                      int64_t* out_offsets) {
  int64_t w = 0;
  out_offsets[0] = 0;
  int64_t n_out = n / group;
  for (int64_t r = 0; r < n_out; ++r) {
    for (int64_t g = 0; g < group; ++g) {
      if (g > 0) {
        if (w + 1 > out_cap) return -1;
        out[w++] = delim;
      }
      int64_t i = r * group + g;
      int64_t lo = offsets[i], hi = offsets[i + 1];
      if (w + (hi - lo) > out_cap) return -1;
      std::memcpy(out + w, values + lo, hi - lo);
      w += hi - lo;
    }
    out_offsets[r + 1] = w;
  }
  return w;
}

// Join k rendered ragged text columns row-wise with `delim`:
// cols_values[c] / cols_offsets[c] describe column c's n rows.
// Returns bytes written or -1 on overflow.
int64_t gdb_join_columns(const char** cols_values,
                         const int64_t** cols_offsets, int32_t k,
                         int64_t n, char delim, char* out,
                         int64_t out_cap, int64_t* out_offsets) {
  int64_t w = 0;
  out_offsets[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    for (int32_t c = 0; c < k; ++c) {
      if (c > 0) {
        if (w + 1 > out_cap) return -1;
        out[w++] = delim;
      }
      int64_t lo = cols_offsets[c][i], hi = cols_offsets[c][i + 1];
      if (w + (hi - lo) > out_cap) return -1;
      std::memcpy(out + w, cols_values[c] + lo, hi - lo);
      w += hi - lo;
    }
    out_offsets[i + 1] = w;
  }
  return w;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Combined-VCF line assembler (the text-edge prefix kernel).
//
// Builds complete VCF record lines from columnar inputs:
//   CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO[\tFORMAT\tsamples]
// INFO = "END=<e>" (when info_end >= 0) + ";"-joined pre-rendered extra
// text + ";DP=<d>" (when info_dp >= 0), "." when empty — the
// BroadCombinedGVCFOperator prefix layout (broad_combined_gvcf.cc:765-
// 910) whose per-record Python rendering dominates genome-scale output.
//
// Ragged text columns are (blob, offsets[n+1]); a null blob renders ".".
// fmt_idx selects a FORMAT string from the (small) fmt dictionary, -1
// meaning no FORMAT/sample columns for that record.
// Returns total bytes written or -1 on overflow of `cap`.
// ---------------------------------------------------------------------------
namespace {
inline char* put_int(char* w, int64_t v) {
  if (v < 0) { *w++ = '-'; v = -v; }
  char tmp[24];
  int k = 0;
  do { tmp[k++] = static_cast<char>('0' + v % 10); v /= 10; } while (v);
  while (k) *w++ = tmp[--k];
  return w;
}
inline char* put_span(char* w, const char* b, int64_t lo, int64_t hi) {
  std::memcpy(w, b + lo, static_cast<size_t>(hi - lo));
  return w + (hi - lo);
}
}  // namespace

extern "C" int64_t gdb_assemble_lines(
    int64_t n, const char* names, const int64_t* name_offs,
    const int32_t* cidx, const int64_t* pos1,
    const char* id_b, const int64_t* id_o,
    const char* ref_b, const int64_t* ref_o,
    const char* alt_b, const int64_t* alt_o,
    const char* qual_b, const int64_t* qual_o,
    const char* filt_b, const int64_t* filt_o,
    const int64_t* info_end,
    const char* ex_b, const int64_t* ex_o,
    const int64_t* info_dp,
    const char* fmt_b, const int64_t* fmt_o, const int32_t* fmt_idx,
    const char* samp_b, const int64_t* samp_o,
    char* out, int64_t cap, int64_t* out_offs) {
  char* w = out;
  char* lim = out + cap;
  out_offs[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    // worst-case bound for the fixed pieces of this line
    int64_t need = 96;
    if (id_b) need += id_o[i + 1] - id_o[i];
    need += ref_o[i + 1] - ref_o[i];
    need += alt_o[i + 1] - alt_o[i];
    if (qual_b) need += qual_o[i + 1] - qual_o[i];
    if (filt_b) need += filt_o[i + 1] - filt_o[i];
    if (ex_b) need += ex_o[i + 1] - ex_o[i];
    const int32_t fi = fmt_idx ? fmt_idx[i] : -1;
    if (fi >= 0) {
      need += fmt_o[fi + 1] - fmt_o[fi];
      if (samp_b) need += samp_o[i + 1] - samp_o[i];
    }
    const int32_t ci = cidx[i];
    need += name_offs[ci + 1] - name_offs[ci];
    if (w + need > lim) return -1;
    w = put_span(w, names, name_offs[ci], name_offs[ci + 1]);
    *w++ = '\t';
    w = put_int(w, pos1[i]);
    *w++ = '\t';
    if (id_b && id_o[i + 1] > id_o[i]) {
      w = put_span(w, id_b, id_o[i], id_o[i + 1]);
    } else {
      *w++ = '.';
    }
    *w++ = '\t';
    w = put_span(w, ref_b, ref_o[i], ref_o[i + 1]);
    *w++ = '\t';
    w = put_span(w, alt_b, alt_o[i], alt_o[i + 1]);
    *w++ = '\t';
    if (qual_b && qual_o[i + 1] > qual_o[i]) {
      w = put_span(w, qual_b, qual_o[i], qual_o[i + 1]);
    } else {
      *w++ = '.';
    }
    *w++ = '\t';
    if (filt_b && filt_o[i + 1] > filt_o[i]) {
      w = put_span(w, filt_b, filt_o[i], filt_o[i + 1]);
    } else {
      *w++ = '.';
    }
    *w++ = '\t';
    // INFO
    char* info_start = w;
    if (info_end[i] >= 0) {
      std::memcpy(w, "END=", 4);
      w += 4;
      w = put_int(w, info_end[i]);
    }
    if (ex_b && ex_o[i + 1] > ex_o[i]) {
      if (w != info_start) *w++ = ';';
      w = put_span(w, ex_b, ex_o[i], ex_o[i + 1]);
    }
    if (info_dp[i] >= 0) {
      if (w != info_start) *w++ = ';';
      std::memcpy(w, "DP=", 3);
      w += 3;
      w = put_int(w, info_dp[i]);
    }
    if (w == info_start) *w++ = '.';
    if (fi >= 0) {
      *w++ = '\t';
      w = put_span(w, fmt_b, fmt_o[fi], fmt_o[fi + 1]);
      if (samp_b && samp_o[i + 1] > samp_o[i]) {
        *w++ = '\t';
        w = put_span(w, samp_b, samp_o[i], samp_o[i + 1]);
      }
    }
    *w++ = '\n';
    out_offs[i + 1] = w - out;
  }
  return w - out;
}

// ---------------------------------------------------------------------------
// Identity combine outputs for REF-BLOCK-ONLY records (the host half of
// the variant-row-only device fetch).  Mirrors
// ops/combine_step.py::host_identity_outputs exactly — for these rows
// the allele LUT is the identity [REF, NON_REF] and the combine
// degenerates to a masked passthrough (reference semantics:
// broad_combined_gvcf.cc handle_* on pure reference blocks).  The numpy
// form costs ~1 s per 20k-record x 100-sample block; this loop is the
// same arithmetic at memory speed, threaded over records.
// ---------------------------------------------------------------------------

namespace {

constexpr int32_t INT_VECTOR_END = INT32_MIN + 1;

struct IdentArgs {
  const int32_t* live;   // [B, S]
  const int64_t* dest;   // output row of record b (nullptr: b)
  int64_t B, S, C;
  const int32_t* pl; int64_t wpl;    // [S, C, wpl]
  const int32_t* pl_len;             // [S, C]
  const int32_t* ad; int64_t wad;
  const int32_t* ad_len;
  const int32_t* gt; int64_t wgt;
  const int32_t* gq;
  const int32_t* dp;
  const int32_t* min_dp;
  const int32_t* gt_len;             // [B, S] (mixed) or nullptr
  int64_t g_out, m_out, p_out;
  int32_t ploidy, gt_phase, mixed;
  int32_t* pl_o; int32_t* ad_o; int32_t* gt_o;
  int32_t* gq_o; int32_t* dp_o; int32_t* mdp_o;
};

void ident_rows(const IdentArgs& a, int64_t b0, int64_t b1) {
  for (int64_t b = b0; b < b1; ++b) {
    const int64_t bo = a.dest ? a.dest[b] : b;
    for (int64_t s = 0; s < a.S; ++s) {
      const int64_t bs = b * a.S + s;
      const int64_t bso = bo * a.S + s;
      const int32_t k = a.live[bs];
      const bool ok = k >= 0;
      int64_t kk = k < 0 ? 0 : k;
      if (kk > a.C - 1) kk = a.C - 1;
      const int64_t sc = s * a.C + kk;
      int32_t p_b;
      if (a.mixed) {
        const int32_t gl = a.gt_len[bs];
        p_b = a.gt_phase ? (gl + 1) / 2 : gl;
      } else {
        p_b = a.ploidy;
      }
      // PL: genotypes over [REF, NON_REF] at ploidy p are slots <= p,
      // gated by pl_len; mixed ploidy-0 calls read VECTOR_END
      int32_t* plo = a.pl_o + bso * a.g_out;
      const int32_t plen = ok ? a.pl_len[sc] : 0;
      for (int64_t g = 0; g < a.g_out; ++g) {
        int32_t v = INT_MISSING;
        if (ok && g <= p_b && g < plen && g < a.wpl)
          v = a.pl[sc * a.wpl + g];
        if (a.mixed && p_b == 0) v = INT_VECTOR_END;
        plo[g] = v;
      }
      // AD: slots m < num_merged (=2) gated by ad_len
      int32_t* ado = a.ad_o + bso * a.m_out;
      const int32_t alen = ok ? a.ad_len[sc] : 0;
      for (int64_t m = 0; m < a.m_out; ++m) {
        int32_t v = INT_MISSING;
        if (ok && m < 2 && m < alen && m < a.wad)
          v = a.ad[sc * a.wad + m];
        ado[m] = v;
      }
      // GT: identity allele remap with NON_REF fallback (merged idx 1)
      int32_t* gto = a.gt_o + bso * a.p_out;
      for (int64_t p = 0; p < a.p_out; ++p) {
        int32_t raw = (ok && p < a.wgt) ? a.gt[sc * a.wgt + p]
                                        : INT_MISSING;
        int32_t o;
        if (a.gt_phase && (p % 2) == 1) {
          o = raw;
        } else {
          o = (raw >= 0) ? (raw < 2 ? raw : 1) : raw;
        }
        if (a.mixed) {
          const int32_t gl = a.gt_len[bs];
          if (p >= gl) o = INT_VECTOR_END;
        }
        gto[p] = o;
      }
      a.gq_o[bso] = ok ? a.gq[sc] : INT_MISSING;
      a.dp_o[bso] = ok ? a.dp[sc] : INT_MISSING;
      a.mdp_o[bso] = ok ? a.min_dp[sc] : INT_MISSING;
    }
  }
}

}  // namespace

extern "C" int gdb_identity_outputs(
    const int32_t* live, const int64_t* dest_rows,
    int64_t B, int64_t S, int64_t C,
    const int32_t* pl, int64_t wpl, const int32_t* pl_len,
    const int32_t* ad, int64_t wad, const int32_t* ad_len,
    const int32_t* gt, int64_t wgt,
    const int32_t* gq, const int32_t* dp, const int32_t* min_dp,
    const int32_t* gt_len,
    int64_t g_out, int64_t m_out, int64_t p_out,
    int32_t ploidy, int32_t gt_phase, int32_t mixed,
    int32_t* pl_o, int32_t* ad_o, int32_t* gt_o,
    int32_t* gq_o, int32_t* dp_o, int32_t* mdp_o) {
  if (B <= 0 || S <= 0 || C <= 0) return 0;
  if (mixed && gt_len == nullptr) return -1;
  IdentArgs a{live, dest_rows, B, S, C, pl, wpl, pl_len, ad, wad,
              ad_len, gt, wgt, gq, dp, min_dp, gt_len, g_out, m_out,
              p_out, ploidy, gt_phase, mixed, pl_o, ad_o, gt_o,
              gq_o, dp_o, mdp_o};
  const int64_t cells = B * S;
  gdbpool::par_for(B, [&a](int64_t lo, int64_t hi) {
    ident_rows(a, lo, hi);
  }, cells);
  return 0;
}

// ---------------------------------------------------------------------------
// Strided ragged int renderer: the FORMAT-column hot path.  Renders
// entry (r, s) as vals[rows[r], s, 0:lens[r*S+s]] joined by `delim`
// ('.' when the length is 0; INT32_MIN renders '.').  Replaces the
// numpy gather-then-boolean-mask pipeline (pl[bs][sel]) that copied
// each [R, S, W] column twice before rendering.  Text semantics are
// exactly gdb_render_int_lists'.
// ---------------------------------------------------------------------------

extern "C" int64_t gdb_render_strided_lists(
    const int32_t* vals, int64_t S, int64_t W,
    const int64_t* rows, int64_t R,
    const int64_t* lens, char delim, char* out, int64_t out_cap,
    int64_t* out_offsets) {
  int64_t w = 0;
  out_offsets[0] = 0;
  char buf[16];
  int64_t i = 0;
  for (int64_t r = 0; r < R; ++r) {
    const int64_t b = rows[r];
    for (int64_t s = 0; s < S; ++s, ++i) {
      int64_t n = lens[i];
      if (n > W) n = W;
      if (n <= 0) {
        if (w + 1 > out_cap) return -1;
        out[w++] = '.';
        out_offsets[i + 1] = w;
        continue;
      }
      const int32_t* src = vals + (b * S + s) * W;
      for (int64_t j = 0; j < n; ++j) {
        if (j) {
          if (w + 1 > out_cap) return -1;
          out[w++] = delim;
        }
        const int32_t v = src[j];
        if (v == INT32_MIN) {
          if (w + 1 > out_cap) return -1;
          out[w++] = '.';
          continue;
        }
        char* p = buf + sizeof(buf);
        bool neg = v < 0;
        uint32_t u = neg ? static_cast<uint32_t>(-(int64_t)v)
                         : static_cast<uint32_t>(v);
        do { *--p = '0' + (u % 10); u /= 10; } while (u);
        if (neg) *--p = '-';
        int64_t len = buf + sizeof(buf) - p;
        if (w + len > out_cap) return -1;
        std::memcpy(out + w, p, len);
        w += len;
      }
      out_offsets[i + 1] = w;
    }
  }
  return w;
}

// ---------------------------------------------------------------------------
// Fused FORMAT-group renderer: emits each record's complete sample
// columns ("a:b:c\ta:b:c...") in ONE pass from column descriptors,
// replacing the render -> join_columns -> join_rows pipeline (three
// full passes over the sample text).  Column kinds:
//   0 = strided int lists: vals [B,S,W] + lens [R,S] (<=0 -> '.')
//   1 = pre-rendered blob: blob + offs [R*S+1], spans copied verbatim
//   2 = missing-call dots: lens [R,S] -> '.' x len joined by delim
// Threaded two-pass (length pass + write pass) over records.
// ---------------------------------------------------------------------------

namespace {

inline int64_t int_text_len(int32_t v) {
  if (v == INT32_MIN) return 1;          // '.'
  uint32_t u = v < 0 ? static_cast<uint32_t>(-(int64_t)v)
                     : static_cast<uint32_t>(v);
  int64_t n = v < 0 ? 2 : 1;
  while (u >= 10) { u /= 10; ++n; }
  return n;
}

inline int64_t emit_int(char* out, int32_t v) {
  if (v == INT32_MIN) { *out = '.'; return 1; }
  char buf[16];
  char* p = buf + sizeof(buf);
  bool neg = v < 0;
  uint32_t u = neg ? static_cast<uint32_t>(-(int64_t)v)
                   : static_cast<uint32_t>(v);
  do { *--p = '0' + (u % 10); u /= 10; } while (u);
  if (neg) *--p = '-';
  int64_t len = buf + sizeof(buf) - p;
  std::memcpy(out, p, len);
  return len;
}

constexpr uint32_t F_MISSING_BITS = 0x7F800001u;
constexpr uint32_t F_VECTOR_END_BITS = 0x7F800002u;

inline int64_t emit_float_vcf(char* out, float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, sizeof(bits));
  if (bits == F_MISSING_BITS || bits == F_VECTOR_END_BITS) {
    *out = '.';
    return 1;
  }
  double d = static_cast<double>(f);
  if (d == 0.0) {
    if (std::signbit(d)) { out[0] = '-'; out[1] = '0'; return 2; }
    out[0] = '0';
    return 1;
  }
  int64_t w = 0;
  if (d < 0) { out[w++] = '-'; d = -d; }
  if (d < 0.0001 || d > 999999.0) {
    w += std::snprintf(out + w, 32, "%g", d);
    return w;
  }
  int decimals = 6 - (static_cast<int>(std::floor(std::log10(d))) + 1);
  if (decimals < 0) decimals = 0;
  int n = std::snprintf(out + w, 40, "%.*f", decimals, d);
  char* s = out + w;
  bool has_dot = false;
  for (int i = 0; i < n; ++i) if (s[i] == '.') { has_dot = true; break; }
  if (has_dot) {
    while (n > 0 && s[n - 1] == '0') --n;
    if (n > 0 && s[n - 1] == '.') s[n++] = '0';
  } else {
    s[n++] = '.';
    s[n++] = '0';
  }
  return w + n;
}

inline int64_t float_text_len(float f) {
  char buf[48];
  return emit_float_vcf(buf, f);
}

struct GroupArgs {
  int64_t n_cols;
  const int32_t* kinds;
  const void* const* vals_ptrs;
  const int64_t* Ws;
  const void* const* lens_ptrs;
  const void* const* blob_ptrs;
  const void* const* offs_ptrs;
  const char* delims;
  const int64_t* rows;
  int64_t R, S;
};

int64_t group_rec_len(const GroupArgs& a, int64_t r) {
  int64_t w = 0;
  for (int64_t s = 0; s < a.S; ++s) {
    if (s) ++w;                                   // '\t'
    const int64_t i = r * a.S + s;
    for (int64_t c = 0; c < a.n_cols; ++c) {
      if (c) ++w;                                 // ':'
      const int k = a.kinds[c];
      if (k == 1) {
        const int64_t* offs = static_cast<const int64_t*>(a.offs_ptrs[c]);
        w += offs[i + 1] - offs[i];
        continue;
      }
      const int32_t* lens = static_cast<const int32_t*>(a.lens_ptrs[c]);
      int64_t n = lens[i];
      if (k == 2) {
        w += n <= 0 ? 1 : 2 * n - 1;
        continue;
      }
      if (k == 4) {
        // GT text (encode_GT_vector): lens is the 0/1 cell mask; the
        // delims byte carries flags bit0=produce_GT, bit1=phase_in
        if (n <= 0) { ++w; continue; }
        const int64_t W = a.Ws[c];
        const int32_t* gv = static_cast<const int32_t*>(a.vals_ptrs[c])
            + (a.rows[r] * a.S + s) * W;
        const bool produce = a.delims[c] & 1;
        const bool phase = a.delims[c] & 2;
        int64_t wrote = 0;
        for (int64_t e = 0;; ++e) {
          const int64_t slot = phase ? (e == 0 ? 0 : 2 * e) : e;
          if (slot >= W) break;
          const int32_t v = gv[slot];
          if (v == INT32_MIN + 1) break;          // VECTOR_END
          if (wrote) ++w;                         // separator
          w += (produce && v >= 0) ? int_text_len(v) : 1;
          ++wrote;
        }
        if (!wrote) ++w;                          // '.'
        continue;
      }
      const int64_t W = a.Ws[c];
      if (n > W) n = W;
      if (n <= 0) { ++w; continue; }
      w += n - 1;                                 // delims
      if (k == 3) {
        const float* srcf = static_cast<const float*>(a.vals_ptrs[c])
            + (a.rows[r] * a.S + s) * W;
        for (int64_t j = 0; j < n; ++j) w += float_text_len(srcf[j]);
        continue;
      }
      const int32_t* src = static_cast<const int32_t*>(a.vals_ptrs[c])
          + (a.rows[r] * a.S + s) * W;
      for (int64_t j = 0; j < n; ++j) w += int_text_len(src[j]);
    }
  }
  return w;
}

void group_rec_write(const GroupArgs& a, int64_t r, char* out) {
  int64_t w = 0;
  for (int64_t s = 0; s < a.S; ++s) {
    if (s) out[w++] = '\t';
    const int64_t i = r * a.S + s;
    for (int64_t c = 0; c < a.n_cols; ++c) {
      if (c) out[w++] = ':';
      const int k = a.kinds[c];
      if (k == 1) {
        const int64_t* offs = static_cast<const int64_t*>(a.offs_ptrs[c]);
        const int64_t n = offs[i + 1] - offs[i];
        std::memcpy(out + w,
                    static_cast<const char*>(a.blob_ptrs[c]) + offs[i],
                    n);
        w += n;
        continue;
      }
      const int32_t* lens = static_cast<const int32_t*>(a.lens_ptrs[c]);
      int64_t n = lens[i];
      if (k == 2) {
        if (n <= 0) { out[w++] = '.'; continue; }
        const char d = a.delims[c];
        for (int64_t j = 0; j < n; ++j) {
          if (j) out[w++] = d;
          out[w++] = '.';
        }
        continue;
      }
      if (k == 4) {
        if (n <= 0) { out[w++] = '.'; continue; }
        const int64_t W = a.Ws[c];
        const int32_t* gv = static_cast<const int32_t*>(a.vals_ptrs[c])
            + (a.rows[r] * a.S + s) * W;
        const bool produce = a.delims[c] & 1;
        const bool phase = a.delims[c] & 2;
        int64_t wrote = 0;
        for (int64_t e = 0;; ++e) {
          const int64_t slot = phase ? (e == 0 ? 0 : 2 * e) : e;
          if (slot >= W) break;
          const int32_t v = gv[slot];
          if (v == INT32_MIN + 1) break;          // VECTOR_END
          if (wrote)
            out[w++] = (phase && gv[slot - 1] > 0) ? '|' : '/';
          if (produce && v >= 0) w += emit_int(out + w, v);
          else out[w++] = '.';
          ++wrote;
        }
        if (!wrote) out[w++] = '.';
        continue;
      }
      const int64_t W = a.Ws[c];
      if (n > W) n = W;
      if (n <= 0) { out[w++] = '.'; continue; }
      const char d = a.delims[c];
      if (k == 3) {
        const float* srcf = static_cast<const float*>(a.vals_ptrs[c])
            + (a.rows[r] * a.S + s) * W;
        for (int64_t j = 0; j < n; ++j) {
          if (j) out[w++] = d;
          w += emit_float_vcf(out + w, srcf[j]);
        }
        continue;
      }
      const int32_t* src = static_cast<const int32_t*>(a.vals_ptrs[c])
          + (a.rows[r] * a.S + s) * W;
      for (int64_t j = 0; j < n; ++j) {
        if (j) out[w++] = d;
        w += emit_int(out + w, src[j]);
      }
    }
  }
}

template <typename F>
void par_records(int64_t R, F f, int64_t work = -1) {
  // `work` approximates total elements; wide cohorts have few records
  // x many samples, so the threshold must scale with R*S, not R
  if (work < 0) work = R;
  gdbpool::par_for(R, f, work);
}

}  // namespace

extern "C" int64_t gdb_render_group(
    int64_t n_cols, const int32_t* kinds, const void* const* vals_ptrs,
    const int64_t* Ws, const void* const* lens_ptrs,
    const void* const* blob_ptrs, const void* const* offs_ptrs,
    const char* delims, const int64_t* rows, int64_t R, int64_t S,
    char* out, int64_t cap, int64_t* rec_offs) {
  GroupArgs a{n_cols, kinds, vals_ptrs, Ws, lens_ptrs, blob_ptrs,
              offs_ptrs, delims, rows, R, S};
  const int64_t work = R * S * (n_cols > 0 ? n_cols : 1);
  rec_offs[0] = 0;
  par_records(R, [&a, rec_offs](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r)
      rec_offs[r + 1] = group_rec_len(a, r);
  }, work);
  for (int64_t r = 0; r < R; ++r) rec_offs[r + 1] += rec_offs[r];
  if (rec_offs[R] > cap) return -1;
  par_records(R, [&a, rec_offs, out](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r)
      group_rec_write(a, r, out + rec_offs[r]);
  }, work);
  return rec_offs[R];
}

// ---------------------------------------------------------------------------
// Direct-write grouped render + gapped line assembly.
//
// The single-buffer pipeline (gdb_render_group per signature group ->
// scatter-concatenate group blobs -> gdb_assemble_lines memcpying the
// sample blob again) writes every sample byte three times.  These
// entry points write each byte exactly once:
//   1. gdb_render_group_lens: per-record sample-text length per group
//   2. gdb_assemble_lens: exact per-line prefix lengths -> line offsets
//      + per-record sample destinations in the final blob
//   3. gdb_assemble_write: prefixes + '\n' (parallel), sample gaps left
//   4. gdb_render_group_at: sample text straight into the gaps
// ---------------------------------------------------------------------------

extern "C" void gdb_render_group_lens(
    int64_t n_cols, const int32_t* kinds, const void* const* vals_ptrs,
    const int64_t* Ws, const void* const* lens_ptrs,
    const void* const* blob_ptrs, const void* const* offs_ptrs,
    const char* delims, const int64_t* rows, int64_t R, int64_t S,
    int64_t* rec_lens) {
  GroupArgs a{n_cols, kinds, vals_ptrs, Ws, lens_ptrs, blob_ptrs,
              offs_ptrs, delims, rows, R, S};
  const int64_t work = R * S * (n_cols > 0 ? n_cols : 1);
  par_records(R, [&a, rec_lens](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) rec_lens[r] = group_rec_len(a, r);
  }, work);
}

extern "C" void gdb_render_group_at(
    int64_t n_cols, const int32_t* kinds, const void* const* vals_ptrs,
    const int64_t* Ws, const void* const* lens_ptrs,
    const void* const* blob_ptrs, const void* const* offs_ptrs,
    const char* delims, const int64_t* rows, int64_t R, int64_t S,
    const int64_t* dest, char* out) {
  GroupArgs a{n_cols, kinds, vals_ptrs, Ws, lens_ptrs, blob_ptrs,
              offs_ptrs, delims, rows, R, S};
  const int64_t work = R * S * (n_cols > 0 ? n_cols : 1);
  par_records(R, [&a, dest, out](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r)
      group_rec_write(a, r, out + dest[r]);
  }, work);
}

namespace {

inline int64_t int64_text_len(int64_t v) {
  uint64_t u = v < 0 ? static_cast<uint64_t>(-v)
                     : static_cast<uint64_t>(v);
  int64_t n = v < 0 ? 2 : 1;
  while (u >= 10) { u /= 10; ++n; }
  return n;
}

struct AsmArgs {
  const char* names; const int64_t* name_offs;
  const int32_t* cidx; const int64_t* pos1;
  const char* id_b; const int64_t* id_o;
  const char* ref_b; const int64_t* ref_o;
  const char* alt_b; const int64_t* alt_o;
  const char* qual_b; const int64_t* qual_o;
  const char* filt_b; const int64_t* filt_o;
  const int64_t* info_end;
  const char* ex_b; const int64_t* ex_o;
  const int64_t* info_dp;
  const char* fmt_b; const int64_t* fmt_o; const int32_t* fmt_idx;
  const int64_t* samp_lens;
};

// Exact byte count of line i EXCLUDING sample text and the trailing
// '\n' (must mirror asm_prefix_write below byte for byte).
int64_t asm_prefix_len(const AsmArgs& a, int64_t i) {
  const int32_t ci = a.cidx[i];
  int64_t w = a.name_offs[ci + 1] - a.name_offs[ci] + 1;       // name \t
  w += int64_text_len(a.pos1[i]) + 1;                          // pos \t
  w += (a.id_b && a.id_o[i + 1] > a.id_o[i])
       ? a.id_o[i + 1] - a.id_o[i] : 1;
  ++w;                                                         // \t
  w += a.ref_o[i + 1] - a.ref_o[i] + 1;
  w += a.alt_o[i + 1] - a.alt_o[i] + 1;
  w += (a.qual_b && a.qual_o[i + 1] > a.qual_o[i])
       ? a.qual_o[i + 1] - a.qual_o[i] : 1;
  ++w;
  w += (a.filt_b && a.filt_o[i + 1] > a.filt_o[i])
       ? a.filt_o[i + 1] - a.filt_o[i] : 1;
  ++w;
  int64_t iw = 0;                                              // INFO
  if (a.info_end[i] >= 0) iw += 4 + int64_text_len(a.info_end[i]);
  if (a.ex_b && a.ex_o[i + 1] > a.ex_o[i]) {
    if (iw) ++iw;
    iw += a.ex_o[i + 1] - a.ex_o[i];
  }
  if (a.info_dp[i] >= 0) {
    if (iw) ++iw;
    iw += 3 + int64_text_len(a.info_dp[i]);
  }
  w += iw ? iw : 1;
  const int32_t fi = a.fmt_idx ? a.fmt_idx[i] : -1;
  if (fi >= 0) {
    w += 1 + (a.fmt_o[fi + 1] - a.fmt_o[fi]);
    if (a.samp_lens && a.samp_lens[i] > 0) ++w;   // '\t' before samples
  }
  return w;
}

void asm_prefix_write(const AsmArgs& a, int64_t i, char* w) {
  const int32_t ci = a.cidx[i];
  w = put_span(w, a.names, a.name_offs[ci], a.name_offs[ci + 1]);
  *w++ = '\t';
  w = put_int(w, a.pos1[i]);
  *w++ = '\t';
  if (a.id_b && a.id_o[i + 1] > a.id_o[i]) {
    w = put_span(w, a.id_b, a.id_o[i], a.id_o[i + 1]);
  } else {
    *w++ = '.';
  }
  *w++ = '\t';
  w = put_span(w, a.ref_b, a.ref_o[i], a.ref_o[i + 1]);
  *w++ = '\t';
  w = put_span(w, a.alt_b, a.alt_o[i], a.alt_o[i + 1]);
  *w++ = '\t';
  if (a.qual_b && a.qual_o[i + 1] > a.qual_o[i]) {
    w = put_span(w, a.qual_b, a.qual_o[i], a.qual_o[i + 1]);
  } else {
    *w++ = '.';
  }
  *w++ = '\t';
  if (a.filt_b && a.filt_o[i + 1] > a.filt_o[i]) {
    w = put_span(w, a.filt_b, a.filt_o[i], a.filt_o[i + 1]);
  } else {
    *w++ = '.';
  }
  *w++ = '\t';
  char* info_start = w;
  if (a.info_end[i] >= 0) {
    std::memcpy(w, "END=", 4);
    w += 4;
    w = put_int(w, a.info_end[i]);
  }
  if (a.ex_b && a.ex_o[i + 1] > a.ex_o[i]) {
    if (w != info_start) *w++ = ';';
    w = put_span(w, a.ex_b, a.ex_o[i], a.ex_o[i + 1]);
  }
  if (a.info_dp[i] >= 0) {
    if (w != info_start) *w++ = ';';
    std::memcpy(w, "DP=", 3);
    w += 3;
    w = put_int(w, a.info_dp[i]);
  }
  if (w == info_start) *w++ = '.';
  const int32_t fi = a.fmt_idx ? a.fmt_idx[i] : -1;
  if (fi >= 0) {
    *w++ = '\t';
    w = put_span(w, a.fmt_b, a.fmt_o[fi], a.fmt_o[fi + 1]);
    if (a.samp_lens && a.samp_lens[i] > 0) *w++ = '\t';
  }
}

}  // namespace

extern "C" int64_t gdb_assemble_lens(
    int64_t n, const char* names, const int64_t* name_offs,
    const int32_t* cidx, const int64_t* pos1,
    const char* id_b, const int64_t* id_o,
    const char* ref_b, const int64_t* ref_o,
    const char* alt_b, const int64_t* alt_o,
    const char* qual_b, const int64_t* qual_o,
    const char* filt_b, const int64_t* filt_o,
    const int64_t* info_end,
    const char* ex_b, const int64_t* ex_o,
    const int64_t* info_dp,
    const char* fmt_b, const int64_t* fmt_o, const int32_t* fmt_idx,
    const int64_t* samp_lens,
    int64_t* line_offs, int64_t* samp_dest) {
  AsmArgs a{names, name_offs, cidx, pos1, id_b, id_o, ref_b, ref_o,
            alt_b, alt_o, qual_b, qual_o, filt_b, filt_o, info_end,
            ex_b, ex_o, info_dp, fmt_b, fmt_o, fmt_idx, samp_lens};
  par_records(n, [&a, line_offs, samp_lens](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i)
      line_offs[i + 1] = asm_prefix_len(a, i)
          + (samp_lens ? samp_lens[i] : 0) + 1;          // + '\n'
  }, n * 4);
  line_offs[0] = 0;
  for (int64_t i = 0; i < n; ++i) line_offs[i + 1] += line_offs[i];
  for (int64_t i = 0; i < n; ++i)
    samp_dest[i] = line_offs[i + 1] - 1
        - (samp_lens ? samp_lens[i] : 0);
  return line_offs[n];
}

extern "C" void gdb_assemble_write(
    int64_t n, const char* names, const int64_t* name_offs,
    const int32_t* cidx, const int64_t* pos1,
    const char* id_b, const int64_t* id_o,
    const char* ref_b, const int64_t* ref_o,
    const char* alt_b, const int64_t* alt_o,
    const char* qual_b, const int64_t* qual_o,
    const char* filt_b, const int64_t* filt_o,
    const int64_t* info_end,
    const char* ex_b, const int64_t* ex_o,
    const int64_t* info_dp,
    const char* fmt_b, const int64_t* fmt_o, const int32_t* fmt_idx,
    const int64_t* samp_lens,
    const int64_t* line_offs, char* out) {
  AsmArgs a{names, name_offs, cidx, pos1, id_b, id_o, ref_b, ref_o,
            alt_b, alt_o, qual_b, qual_o, filt_b, filt_o, info_end,
            ex_b, ex_o, info_dp, fmt_b, fmt_o, fmt_idx, samp_lens};
  const int64_t work = n ? line_offs[n] / 8 : 0;
  par_records(n, [&a, line_offs, out](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      asm_prefix_write(a, i, out + line_offs[i]);
      out[line_offs[i + 1] - 1] = '\n';
    }
  }, work);
}


// ---------------------------------------------------------------------------
// Widen + scatter: narrow (int8/int16) variant-row device fetches ->
// the int32 full-size output arrays, sentinel-remapped, threaded.
// Replaces astype + two boolean-mask writes + a fancy-index scatter
// (five numpy passes over the data).  elem = elements per row (S*W).
// ---------------------------------------------------------------------------

namespace {

template <typename T>
void widen_rows(const T* src, const int64_t* rows, int64_t n_rows,
                int64_t elem, T miss, T eov, int32_t* out,
                int64_t r0, int64_t r1) {
  for (int64_t r = r0; r < r1; ++r) {
    const T* s = src + r * elem;
    int32_t* o = out + rows[r] * elem;
    for (int64_t j = 0; j < elem; ++j) {
      const T v = s[j];
      o[j] = v == miss ? INT32_MIN
           : v == eov ? INT32_MIN + 1
           : static_cast<int32_t>(v);
    }
  }
}

}  // namespace

extern "C" int gdb_widen_scatter(
    const void* src, int32_t itemsize, const int64_t* rows,
    int64_t n_rows, int64_t elem, int64_t miss, int64_t eov,
    int32_t* out) {
  if (n_rows <= 0 || elem <= 0) return 0;
  auto run = [&](auto tag) {
    using T = decltype(tag);
    const T* s = static_cast<const T*>(src);
    par_records(n_rows, [&](int64_t lo, int64_t hi) {
      widen_rows<T>(s, rows, n_rows, elem, static_cast<T>(miss),
                    static_cast<T>(eov), out, lo, hi);
    }, n_rows * elem);
  };
  if (itemsize == 1) run(int8_t{});
  else if (itemsize == 2) run(int16_t{});
  else return -1;
  return 0;
}

// ---------------------------------------------------------------------------
// Live-cell sweep: for ascending record starts, the per-(record, sample)
// live cell is the last cell with col <= start whose END covers start —
// a monotone pointer walk (O(C+B) per sample) replacing B*S binary
// searches plus three full [B, S] numpy gathers (cells / start-eq /
// end-min).  Threaded over samples with per-thread end-min partials.
// ---------------------------------------------------------------------------

extern "C" int gdb_live_sweep(
    const int64_t* col, const int64_t* end_, const int64_t* cell_of,
    const int64_t* starts, int64_t B, int64_t S, int64_t C,
    int32_t* live, int64_t* cells, uint8_t* starteq, int64_t* endmin) {
  if (B <= 0 || S <= 0) return 0;
  constexpr int64_t I64MAX = INT64_MAX;
  for (int64_t b = 0; b < B; ++b) endmin[b] = I64MAX;
  std::vector<std::vector<int64_t>> partials;
  auto sweep = [&](int64_t s0, int64_t s1, int64_t* emin) {
    for (int64_t s = s0; s < s1; ++s) {
      const int64_t* cs = col + s * C;
      const int64_t* es = end_ + s * C;
      // seek to the first start: interval queries touch a tiny span of
      // a store-wide [S, C] layout — the walk must not start at cell 0
      int64_t j = static_cast<int64_t>(
          std::upper_bound(cs, cs + C, starts[0]) - cs) - 1;
      for (int64_t b = 0; b < B; ++b) {
        const int64_t st = starts[b];
        while (j + 1 < C && cs[j + 1] <= st) ++j;
        const bool ok = j >= 0 && es[j] >= st;
        live[b * S + s] = ok ? static_cast<int32_t>(j) : -1;
        if (cells)
          cells[b * S + s] = ok ? cell_of[s * C + j] : -1;
        if (starteq)
          starteq[b * S + s] = ok && cs[j] == st;
        if (ok && es[j] < emin[b]) emin[b] = es[j];
      }
    }
  };
  if (B * S < (1 << 14) || S < 2) {
    sweep(0, S, endmin);
    return 0;
  }
  // per-CHUNK end-min partials (the pool schedules chunks dynamically,
  // so partials cannot be per thread), merged after the run
  const int64_t nchunks = std::min<int64_t>(S, 32);
  const int64_t step = (S + nchunks - 1) / nchunks;
  partials.assign(nchunks, std::vector<int64_t>(B, I64MAX));
  gdbpool::par_for(nchunks, [&](int64_t c0, int64_t c1) {
    for (int64_t c = c0; c < c1; ++c)
      sweep(c * step, std::min<int64_t>(S, (c + 1) * step),
            partials[c].data());
  }, B * S);
  for (auto& pr : partials)
    for (int64_t b = 0; b < B; ++b)
      if (pr[b] < endmin[b]) endmin[b] = pr[b];
  return 0;
}
