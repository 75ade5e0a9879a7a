// Fused live-cell gather + allele remap for the combined-gVCF block
// engine, hand-written for Hopper (sm_90a).
//
// Replaces: genomicsdb_tpu/ops/pallas_combine.py::_make_kernel_rt (the
// TPU kernel launched by fused_gather_remap_rt), in its wide form and in
// its narrow form (cfg.narrow / cfg.narrow_scalars), and
// pallas_combine.py::_make_kernel (launched by fused_gather_remap), whose
// function is the wide, non-mixed case of this one.  Same outputs, bit
// for bit, at every (record b, sample s), including those with no live
// cell.
//
// What it computes, per (b, s):
//   * gathers the live cell c = live[b, s] of sample s: PL, PL length,
//     AD, AD length, GT, GQ, FORMAT DP, MIN_DP, INFO DP and the median /
//     int-median / ordered-sum INFO rows;
//   * PL: for every genotype g of the record's merged alleles, maps each
//     ploidy slot through the inverse LUT inv_bs[b, s, :] (NON_REF
//     fallback), sorts the slots and takes the canonical genotype index
//     sum_i C(a_i + i, i + 1) into the cell's input PL;
//   * AD: maps each merged allele through the inverse LUT;
//   * GT: maps each input allele to the LAST merged allele whose LUT entry
//     equals it (NON_REF fallback when the merge has one); phase slots
//     pass through;
//   * mixed ploidy: a call's ploidy comes from its stored GT length; PL
//     rows past that ploidy's genotype count and GT slots past the GT
//     length are INT_VECTOR_END;
//   * passthroughs: integer fields INT_MISSING and float INFO fields the
//     quiet-NaN bits 0x7FC00000 where there is no live cell (a stored
//     -0.0 survives).
//
// Narrow form (template flag kNarrow): PL, AD and GT are stored as int16
// with the BCF16 sentinels (INT_MISSING -> -32768, INT_VECTOR_END ->
// -32767), and with kNarrowScalars so are GQ, FORMAT DP and MIN_DP.  Any
// other value is cast unclamped: the host checked that every input value
// lies in [-32000, 32000] before it chose this form, and the remap only
// permutes values and adds sentinels.  INFO DP and the INFO rows stay
// 32-bit.  One kernel body serves both forms, so the remap is written
// once.
//
// What bounds it: bytes.  It is an int32 gather and select with no
// matrix work, so the tensor cores have nothing to do: per (b, s) it
// reads one cell's fields and the LUT row, and writes G_out + M + gt_w
// + 4 + F words (int32 wide; the PL/AD/GT and scalar words int16 narrow).
// On an H100 the floor is the output write at device-memory bandwidth.
//
// Design (a first, simple kernel): one thread per (b, s), samples on the
// fast thread axis, so a warp covers 32 neighbouring samples of one
// record and their inv_bs / live / output rows are neighbours in
// memory.  The thread reads its cell straight from global memory: the
// Pallas kernel's VMEM windows, payload slab and sublane packing exist
// to fit the TPU's memory and have no counterpart here.  The genotype
// combo tables (genotype_combo_table(m, p) for each ploidy the launch
// needs) and their per-genotype max allele arrive as one small int32
// device array, so one build serves every shape.  Outputs are written in
// the consumer layout ([B, S, W] and [F, B, S]), so no transpose follows.
// No tensor cores, no TMA, no shared memory.
//
// Inputs are int32 (float INFO tensors are read as their int32 bits);
// the Python wrapper (ops/fused_combine.py) checks device, dtype, shape
// and contiguity before it launches.  The launch goes to the caller's
// stream; the entry point allocates nothing, does not synchronise, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kIntMissing = INT32_MIN;            // bcf_int32_missing
constexpr int kIntVectorEnd = INT32_MIN + 1;      // bcf_int32_vector_end
constexpr int kNanBits = 0x7FC00000;              // float32 quiet NaN
constexpr int16_t kInt16Missing = -32768;         // bcf_int16_missing
constexpr int16_t kInt16VectorEnd = -32767;       // bcf_int16_vector_end
constexpr int kMaxPloidy = 6;
constexpr int kMaxMerged = 16;
constexpr int kThreads = 256;

struct Args {
  // cell tensors, [S, C, ...] (info rows [F, S, C])
  const int* pl;        // [S, C, G_in]
  const int* pl_len;    // [S, C]
  const int* ad;        // [S, C, A_in]
  const int* ad_len;    // [S, C]
  const int* gt;        // [S, C, gt_w]
  const int* gq;        // [S, C]
  const int* dp;        // [S, C]
  const int* min_dp;    // [S, C]
  const int* dp_info;   // [S, C]
  const int* info_f;    // [F, S, C] float32 bits
  const int* info_i;    // [Fi, S, C]
  const int* info_fs;   // [Fs, S, C] float32 bits
  // per-record / per-(record, sample) tensors
  const int* live;      // [B, S]
  const int* inv_bs;    // [B, S, M]
  const int* nr_bs;     // [B, S]
  const int* rec_nm;    // [B]
  const int* rec_nr;    // [B] 0/1
  const int* gt_len;    // [B, S] (mixed ploidy only, else null)
  // combo tables: header of 3 ints per ploidy p (combo offset, max-allele
  // offset, genotype count G_p) for p = 0..6, then the data
  const int* tables;
  // outputs: int32, or int16 where the narrow form says so
  void* pl_out;         // [B, S, G_out]
  void* ad_out;         // [B, S, M]
  void* gt_out;         // [B, S, gt_w]
  void* gq_out;         // [B, S]
  void* dpf_out;        // [B, S]
  void* mdp_out;        // [B, S]
  int* dpi_out;         // [B, S]
  int* info_f_out;      // [F, B, S] float32 bits
  int* info_i_out;      // [Fi, B, S]
  int* info_fs_out;     // [Fs, B, S] float32 bits
  int64_t B, S, C;
  int G_in, A_in, gt_w, M, G_out, ploidy, F, Fi, Fs, phase, mixed;
};

// C(a + i, i + 1): the canonical genotype-index term of sorted slot i
// (variant_field_handler.cc:299-321).  The product of i + 1 consecutive
// integers divides exactly by (i + 1)!; computed in 64 bits, the result
// fits int32 for every allele index the store produces.
__device__ __forceinline__ int gt_index_term(int a, int i) {
  long long t = a;
  long long f = 1;
  for (int j = 1; j <= i; ++j) {
    t *= (long long)(a + j);
    f *= (long long)(j + 1);
  }
  return (int)(t / f);
}

// Stores v at out[i]: as int32, or as int16 with the BCF16 sentinels
// (pallas_combine.py's to16).
template <bool kNarrowOut>
__device__ __forceinline__ void put(void* out, int64_t i, int v) {
  if constexpr (kNarrowOut) {
    static_cast<int16_t*>(out)[i] = v == kIntMissing ? kInt16Missing
        : v == kIntVectorEnd ? kInt16VectorEnd : (int16_t)v;
  } else {
    static_cast<int*>(out)[i] = v;
  }
}

template <bool kNarrow, bool kNarrowScalars>
__global__ void __launch_bounds__(kThreads)
fused_gather_remap_kernel(const Args A) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= A.B * A.S) return;
  const int64_t b = idx / A.S;
  const int64_t s = idx - b * A.S;
  const int64_t bs = idx;                       // b * S + s

  const int lv = A.live[bs];
  const bool valid = lv >= 0;
  const int64_t c = valid ? (int64_t)lv : 0;
  const int64_t cell = s * A.C + c;             // index into [S, C]
  const int nm = A.rec_nm[b];
  const int nr = A.nr_bs[bs];
  const int nr_merged = A.rec_nr[b] ? nm - 1 : -1;

  int inv[kMaxMerged];
  for (int m = 0; m < A.M; ++m) inv[m] = A.inv_bs[bs * A.M + m];

  // ---- PL genotype remap ----
  const int pll = valid ? A.pl_len[cell] : 0;
  const int* plrow = A.pl + cell * A.G_in;
  const int64_t plo = bs * A.G_out;
  int p_call = A.ploidy;
  if (A.mixed) {
    const int gl = A.gt_len[bs];
    p_call = A.phase ? (gl + 1) / 2 : gl;
  }
  int G_p = 0;
  const int* combos = nullptr;
  const int* max_a = nullptr;
  if (p_call >= 1 && p_call <= A.ploidy) {
    combos = A.tables + A.tables[3 * p_call];
    max_a = A.tables + A.tables[3 * p_call + 1];
    G_p = A.tables[3 * p_call + 2];
  }
  for (int g = 0; g < G_p; ++g) {
    int a[kMaxPloidy];
    bool missing = false;
    for (int i = 0; i < p_call; ++i) {
      int x = inv[combos[g * p_call + i]];
      if (x == -1) x = nr >= 0 ? nr : -1;
      if (x == -1) missing = true;
      // insertion sort of max(x, 0): the sorted multiset the Pallas
      // sorting network produces
      int v = x > 0 ? x : 0;
      int k = i;
      while (k > 0 && a[k - 1] > v) {
        a[k] = a[k - 1];
        --k;
      }
      a[k] = v;
    }
    int in_gt = 0;
    for (int i = 0; i < p_call; ++i) in_gt += gt_index_term(a[i], i);
    const bool ok = !missing && in_gt < pll && in_gt < A.G_in
        && max_a[g] < nm;
    put<kNarrow>(A.pl_out, plo + g, ok ? plrow[in_gt] : kIntMissing);
  }
  // rows past this call's genotype count: only in mixed ploidy, where
  // they (and every row of a ploidy-0 call) are VECTOR_END
  for (int g = G_p; g < A.G_out; ++g)
    put<kNarrow>(A.pl_out, plo + g, kIntVectorEnd);

  // ---- AD allele remap ----
  const int adl = valid ? A.ad_len[cell] : 0;
  const int* adrow = A.ad + cell * A.A_in;
  const int64_t ado = bs * A.M;
  for (int m = 0; m < A.M; ++m) {
    int x = inv[m];
    if (x == -1) x = nr >= 0 ? nr : -1;
    const bool ok = x >= 0 && x < adl && x < A.A_in && m < nm;
    put<kNarrow>(A.ad_out, ado + m, ok ? adrow[x] : kIntMissing);
  }

  // ---- GT remap ----
  const int* gtrow = A.gt + cell * A.gt_w;
  const int64_t gto = bs * A.gt_w;
  const int gl = A.mixed ? A.gt_len[bs] : A.gt_w;
  for (int p = 0; p < A.gt_w; ++p) {
    const int x = valid ? gtrow[p] : kIntMissing;
    int o = x;
    if (!(A.phase && (p & 1))) {
      int merged = -1;
      for (int m = 0; m < A.M; ++m)
        if (inv[m] == x) merged = m;
      if (x >= 0 && x != kIntMissing)
        o = merged >= 0 ? merged : nr_merged;
    }
    put<kNarrow>(A.gt_out, gto + p, p < gl ? o : kIntVectorEnd);
  }

  // ---- passthrough scalars + INFO rows ----
  put<kNarrowScalars>(A.gq_out, bs, valid ? A.gq[cell] : kIntMissing);
  put<kNarrowScalars>(A.dpf_out, bs, valid ? A.dp[cell] : kIntMissing);
  put<kNarrowScalars>(A.mdp_out, bs, valid ? A.min_dp[cell] : kIntMissing);
  A.dpi_out[bs] = valid ? A.dp_info[cell] : kIntMissing;
  const int64_t sc = A.S * A.C;
  const int64_t bsz = A.B * A.S;
  for (int f = 0; f < A.F; ++f)
    A.info_f_out[f * bsz + bs] = valid ? A.info_f[f * sc + cell] : kNanBits;
  for (int f = 0; f < A.Fi; ++f)
    A.info_i_out[f * bsz + bs] =
        valid ? A.info_i[f * sc + cell] : kIntMissing;
  for (int f = 0; f < A.Fs; ++f)
    A.info_fs_out[f * bsz + bs] =
        valid ? A.info_fs[f * sc + cell] : kNanBits;
}

}  // namespace

// narrow = 0: every output int32 (the wide form).  narrow = 1: PL/AD/GT
// int16; narrow_scalars = 1 (only with narrow = 1): GQ/DP/MIN_DP int16
// too.  Output pointers must match those widths.
extern "C" int gdb_fused_gather_remap(
    const void* pl, const void* pl_len, const void* ad, const void* ad_len,
    const void* gt, const void* gq, const void* dp, const void* min_dp,
    const void* dp_info, const void* info_f, const void* info_i,
    const void* info_fs, const void* live, const void* inv_bs,
    const void* nr_bs, const void* rec_nm, const void* rec_nr,
    const void* gt_len, const void* tables, void* pl_out, void* ad_out,
    void* gt_out, void* gq_out, void* dpf_out, void* mdp_out,
    void* dpi_out, void* info_f_out, void* info_i_out, void* info_fs_out,
    long long B, long long S, long long C, int G_in, int A_in, int gt_w,
    int M, int G_out, int ploidy, int F, int Fi, int Fs, int phase,
    int mixed, int narrow, int narrow_scalars, void* stream) {
  if (M > kMaxMerged || ploidy > kMaxPloidy || ploidy < 1
      || (narrow_scalars && !narrow))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.pl = (const int*)pl;
  a.pl_len = (const int*)pl_len;
  a.ad = (const int*)ad;
  a.ad_len = (const int*)ad_len;
  a.gt = (const int*)gt;
  a.gq = (const int*)gq;
  a.dp = (const int*)dp;
  a.min_dp = (const int*)min_dp;
  a.dp_info = (const int*)dp_info;
  a.info_f = (const int*)info_f;
  a.info_i = (const int*)info_i;
  a.info_fs = (const int*)info_fs;
  a.live = (const int*)live;
  a.inv_bs = (const int*)inv_bs;
  a.nr_bs = (const int*)nr_bs;
  a.rec_nm = (const int*)rec_nm;
  a.rec_nr = (const int*)rec_nr;
  a.gt_len = (const int*)gt_len;
  a.tables = (const int*)tables;
  a.pl_out = pl_out;
  a.ad_out = ad_out;
  a.gt_out = gt_out;
  a.gq_out = gq_out;
  a.dpf_out = dpf_out;
  a.mdp_out = mdp_out;
  a.dpi_out = (int*)dpi_out;
  a.info_f_out = (int*)info_f_out;
  a.info_i_out = (int*)info_i_out;
  a.info_fs_out = (int*)info_fs_out;
  a.B = B;
  a.S = S;
  a.C = C;
  a.G_in = G_in;
  a.A_in = A_in;
  a.gt_w = gt_w;
  a.M = M;
  a.G_out = G_out;
  a.ploidy = ploidy;
  a.F = F;
  a.Fi = Fi;
  a.Fs = Fs;
  a.phase = phase;
  a.mixed = mixed;
  const long long n = B * S;
  if (n == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (!narrow)
    fused_gather_remap_kernel<false, false><<<blocks, kThreads, 0, st>>>(a);
  else if (!narrow_scalars)
    fused_gather_remap_kernel<true, false><<<blocks, kThreads, 0, st>>>(a);
  else
    fused_gather_remap_kernel<true, true><<<blocks, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* gdb_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
