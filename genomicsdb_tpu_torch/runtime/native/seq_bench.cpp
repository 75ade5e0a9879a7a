// C++-speed sequential combine micro-benchmark for baseline calibration.
//
// Implements the reference's per-record, per-call hot loop at compiled
// speed: forward cell pointers per sample (the END-ordered sweep of
// query_variants.cc:334-478 reduced to its data movement), then for
// every live call the PL genotype reorder / AD allele reorder /
// INFO-DP logic of variant_field_handler.cc:42-296 and
// broad_combined_gvcf.cc:689-726.  This gives BENCH vs_baseline a
// defensible meaning: "vs a C++-speed sequential engine running the
// same semantics on the same cohort" — the reference itself cannot be
// built here (TileDB submodule is not vendored).
//
// Exposed via the same C ABI .so as the import/render kernels.

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

namespace {
constexpr int32_t INT_MISSING = INT32_MIN;

// The shared per-record hot loop over records [b0, b1).  Pointers are
// initialized by binary search so a thread can start mid-scan with the
// exact state the sequential sweep would have (cells are col-sorted per
// sample) — the record axis partitions like the reference's
// rank-per-column-partition process model (tools/src/vcf2tiledb.cc:44-52).
int32_t combine_records(
    const int64_t* col, const int64_t* end_, int64_t S, int64_t C,
    const int32_t* pl, int64_t G_in, const int32_t* pl_len,
    const int32_t* ad, int64_t A_in, const int32_t* ad_len,
    const int32_t* inv_bs, const int32_t* nr_bs, int64_t M,
    const int32_t* dp_info, const int32_t* dp_fmt, const int32_t* min_dp,
    const int64_t* starts, const int32_t* rec_nm, int64_t b0, int64_t b1,
    int64_t* ptr) {
  uint32_t checksum = 0;
  for (int64_t b = b0; b < b1; ++b) {
    const int64_t st = starts[b];
    const int32_t nm = rec_nm[b];
    int32_t dp_sum = 0;
    for (int64_t s = 0; s < S; ++s) {
      const int64_t* cs = col + s * C;
      const int64_t* es = end_ + s * C;
      int64_t& p = ptr[s];
      while (p + 1 < C && cs[p + 1] <= st) ++p;
      if (!(cs[p] <= st && st <= es[p])) continue;  // no live call
      const int64_t cell = s * C + p;
      const int32_t* inv = inv_bs + (b * S + s) * M;
      const int32_t nr = nr_bs[b * S + s];
      const int32_t pll = pl_len[cell];
      const int32_t* plv = pl + cell * G_in;
      for (int32_t a2 = 0; a2 < nm; ++a2) {
        int32_t i2 = (a2 < M) ? inv[a2] : -1;
        if (i2 == -1) i2 = nr;
        for (int32_t a1 = 0; a1 <= a2; ++a1) {
          int32_t i1 = (a1 < M) ? inv[a1] : -1;
          if (i1 == -1) i1 = nr;
          int32_t out = INT_MISSING;
          if (i1 >= 0 && i2 >= 0) {
            const int32_t lo = i1 < i2 ? i1 : i2;
            const int32_t hi = i1 < i2 ? i2 : i1;
            const int32_t gt = hi * (hi + 1) / 2 + lo;
            if (gt < pll && gt < G_in) out = plv[gt];
          }
          checksum += static_cast<uint32_t>(out);
        }
      }
      const int32_t adl = ad_len[cell];
      const int32_t* adv = ad + cell * A_in;
      for (int32_t m = 0; m < nm; ++m) {
        int32_t ia = (m < M) ? inv[m] : -1;
        if (ia == -1) ia = nr;
        int32_t out = INT_MISSING;
        if (ia >= 0 && ia < adl && ia < A_in) out = adv[ia];
        checksum += static_cast<uint32_t>(out);
      }
      int32_t dv = dp_info[cell];
      if (dv == INT_MISSING) {
        dv = (min_dp[cell] != INT_MISSING) ? min_dp[cell] : dp_fmt[cell];
      }
      if (dv != INT_MISSING) dp_sum += dv;
    }
    checksum += static_cast<uint32_t>(dp_sum);
  }
  return static_cast<int32_t>(checksum);
}
}  // namespace

extern "C" {

// Multi-threaded variant: records are range-partitioned across threads
// (the reference's rank-per-partition model run across cores).  The
// int32 wraparound checksum is a commutative sum over records, so the
// result is bit-identical to the single-threaded run.
int32_t gdb_seq_combine_bench_mt(
    const int64_t* col, const int64_t* end_, int64_t S, int64_t C,
    const int32_t* pl, int64_t G_in, const int32_t* pl_len,
    const int32_t* ad, int64_t A_in, const int32_t* ad_len,
    const int32_t* inv_bs, const int32_t* nr_bs, int64_t M,
    const int32_t* dp_info, const int32_t* dp_fmt, const int32_t* min_dp,
    const int64_t* starts, const int32_t* rec_nm, int64_t B,
    int64_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > B) n_threads = B > 0 ? B : 1;
  std::vector<int32_t> partial(n_threads, 0);
  std::vector<std::thread> workers;
  const int64_t per = (B + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    const int64_t b0 = t * per;
    const int64_t b1 = std::min(B, b0 + per);
    if (b0 >= b1) break;
    workers.emplace_back([=, &partial]() {
      // per-thread forward pointers, initialized to the last cell with
      // col <= starts[b0] (exactly where the sequential sweep would be)
      std::vector<int64_t> ptr(S, 0);
      const int64_t st0 = starts[b0];
      for (int64_t s = 0; s < S; ++s) {
        const int64_t* cs = col + s * C;
        const int64_t* ub = std::upper_bound(cs, cs + C, st0);
        ptr[s] = std::max<int64_t>(0, (ub - cs) - 1);
      }
      partial[t] = combine_records(col, end_, S, C, pl, G_in, pl_len,
                                   ad, A_in, ad_len, inv_bs, nr_bs, M,
                                   dp_info, dp_fmt, min_dp, starts,
                                   rec_nm, b0, b1, ptr.data());
    });
  }
  for (auto& w : workers) w.join();
  uint32_t checksum = 0;
  for (int32_t p : partial) checksum += static_cast<uint32_t>(p);
  return static_cast<int32_t>(checksum);
}

// Returns an int32 wraparound checksum over all remapped outputs (the
// same reduction bench.py fetches from the device), so the work cannot
// be dead-code-eliminated and results are comparable.
int32_t gdb_seq_combine_bench(
    const int64_t* col, const int64_t* end_, int64_t S, int64_t C,
    const int32_t* pl, int64_t G_in, const int32_t* pl_len,
    const int32_t* ad, int64_t A_in, const int32_t* ad_len,
    const int32_t* inv_bs, const int32_t* nr_bs, int64_t M,
    const int32_t* dp_info, const int32_t* dp_fmt, const int32_t* min_dp,
    const int64_t* starts, const int32_t* rec_nm, int64_t B) {
  // forward pointer per sample (the scan keeps an iterator per row);
  // hot loop = PL genotype reorder (variant_field_handler.cc:135-198),
  // AD allele reorder (:42-82), INFO DP (broad_combined_gvcf.cc:689-726)
  std::vector<int64_t> ptr(S, 0);
  return combine_records(col, end_, S, C, pl, G_in, pl_len, ad, A_in,
                         ad_len, inv_bs, nr_bs, M, dp_info, dp_fmt,
                         min_dp, starts, rec_nm, 0, B, ptr.data());
}

}  // extern "C"
