// The device code of the fused gather + remap kernel (see the note at the
// top of fused_gather_remap.cu): its tile machinery, its instantiation
// families and the host-side `launch` of one instantiation.
//
// Every instantiation is built in exactly one translation unit, so that
// the build runs one nvcc per source at once: fused_gather_remap.cu holds
// the entry point and `dispatch`, and fused_gather_remap_<family>.cu each
// instantiate `launch` for one family (GDB_FGR_<FAMILY> below, three forms
// each).  Every other unit sees them as `extern template`.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace gdb_fgr {

constexpr int kIntMissing = INT32_MIN;            // bcf_int32_missing
constexpr int kIntVectorEnd = INT32_MIN + 1;      // bcf_int32_vector_end
constexpr int kNanBits = 0x7FC00000;              // float32 quiet NaN
constexpr int16_t kInt16Missing = -32768;         // bcf_int16_missing
constexpr int16_t kInt16VectorEnd = -32767;       // bcf_int16_vector_end
constexpr int kMaxPloidy = 6;
constexpr int kMaxMerged = 16;
constexpr int kThreads = 256;
constexpr int kLog2Threads = 8;
// the device tables: a header of 2 ints per ploidy p = 0..6 (offset of
// its genotype words, genotype count G_p), the term table C(a + i, i + 1)
// for i < 6 and a < kTermRows, then one word per genotype: allele q in
// bits 4q..4q+3, the genotype's largest allele in bits 24..27
constexpr int kHeaderInts = 2 * (kMaxPloidy + 1);
constexpr int kTermRows = 64;
constexpr int kTermInts = kMaxPloidy * kTermRows;

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
  const int* tables;    // header, term table, combo tables (see above)
  // outputs: int32, or int16 where the narrow form says so
  char* pl_out;         // [B, S, G_out]
  char* ad_out;         // [B, S, M]
  char* gt_out;         // [B, S, gt_w]
  char* gq_out;         // [B, S]
  char* dpf_out;        // [B, S]
  char* mdp_out;        // [B, S]
  char* dpi_out;        // [B, S] int32
  char* info_f_out;     // [F, B, S] float32 bits
  char* info_i_out;     // [Fi, B, S]
  char* info_fs_out;    // [Fs, B, S] float32 bits
  int64_t B, S, C;
  int G_in, A_in, gt_w, M, G_out, ploidy, F, Fi, Fs, phase, mixed;
};

// The tile plan, field for field as ops/fused_combine.PLAN_FIELDS orders
// it.  Offsets are bytes; every staging slot is a multiple of 16 bytes
// and holds one output run at its destination's offset modulo 16.
struct Plan {
  int tb, ts, log2_tb, log2_nbs;    // tile: tb records x ts samples
  int gc, n_chunks;                 // genotype chunk of a PL pass
  int n_ts, n_tiles, grid, smem;    // tiles are record-block-major
  // one LUT buffer (two are kept), offsets relative to the buffer
  int lut_bytes, lut_live, lut_nr, lut_gtl, lut_inv, lut_recnm, lut_recnr;
  int lut_row, inv_row;             // row strides in ints
  // block-wide sections, from the start of dynamic shared memory
  int off_lut, off_hdr, off_term, off_cell, off_pll, off_pcall;
  // staging: region offset, slot bytes, log2 of 16-byte units per slot
  int off_ad, slot_ad, l2u_ad;
  int off_gt, slot_gt, l2u_gt;
  int off_sc, slot_sc, l2u_sc;      // GQ, FORMAT DP, MIN_DP regions
  int off_dpi, slot_w, l2u_w;       // INFO DP; slot_w serves the INFO rows
  int off_info;                     // F + Fi + Fs INFO row regions
  int off_pl, slot_pl, l2u_pl;
};
constexpr int kPlanInts = sizeof(Plan) / sizeof(int);

template <typename T>
__device__ __forceinline__ T narrow_to(int v) {
  if constexpr (sizeof(T) == 2) {
    return v == kIntMissing ? kInt16Missing
        : v == kIntVectorEnd ? kInt16VectorEnd : (int16_t)v;
  } else {
    return v;
  }
}

// ---- cp.async ----

__device__ __forceinline__ void cp_async4(void* smem_dst, const void* src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// ---- the tile ----

struct Tile {
  int64_t b0, s0;
  int tbv, tsv;        // valid records / samples (ragged edges)
};

__device__ __forceinline__ Tile tile_at(const Args& A, const Plan& P,
                                        int tile) {
  Tile t;
  const int tbi = tile / P.n_ts;
  const int tsi = tile - tbi * P.n_ts;
  t.b0 = (int64_t)tbi * P.tb;
  t.s0 = (int64_t)tsi * P.ts;
  t.tbv = (int)min((int64_t)P.tb, A.B - t.b0);
  t.tsv = (int)min((int64_t)P.ts, A.S - t.s0);
  return t;
}

// Issues the cp.async copies of one tile's LUT rows into `buf`.
static __device__ void load_lut(const Args& A, const Plan& P,
                                unsigned char* buf, int tile) {
  const Tile t = tile_at(A, P, tile);
  int* live = (int*)(buf + P.lut_live);
  int* nr = (int*)(buf + P.lut_nr);
  int* gtl = (int*)(buf + P.lut_gtl);
  int* inv = (int*)(buf + P.lut_inv);
  const int log2_ts = P.log2_nbs - P.log2_tb;
  const int nbs = 1 << P.log2_nbs;
  for (int i = threadIdx.x; i < nbs; i += kThreads) {
    const int bl = i >> log2_ts;              // s fastest: coalesced
    const int sl = i & (P.ts - 1);
    if (bl >= t.tbv || sl >= t.tsv) continue;
    const int64_t g = (t.b0 + bl) * A.S + t.s0 + sl;
    const int o = bl * P.lut_row + sl;
    cp_async4(live + o, A.live + g);
    cp_async4(nr + o, A.nr_bs + g);
    if (A.mixed) cp_async4(gtl + o, A.gt_len + g);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int run = t.tsv * A.M;                // one record's inv row run
  for (int bl = warp; bl < t.tbv; bl += kThreads / 32) {
    const int* src = A.inv_bs + ((t.b0 + bl) * A.S + t.s0) * A.M;
    for (int k = lane; k < run; k += 32)
      cp_async4(inv + bl * P.inv_row + k, src + k);
  }
  for (int bl = threadIdx.x; bl < t.tbv; bl += kThreads) {
    cp_async4((int*)(buf + P.lut_recnm) + bl, A.rec_nm + t.b0 + bl);
    cp_async4((int*)(buf + P.lut_recnr) + bl, A.rec_nr + t.b0 + bl);
  }
}

// The LUT rows of one tile in shared memory.
struct LutRows {
  const int *live, *nr, *gtl, *inv, *recnm, *recnr;
};

__device__ __forceinline__ LutRows lut_rows(const Plan& P,
                                            const unsigned char* lut) {
  return {(const int*)(lut + P.lut_live), (const int*)(lut + P.lut_nr),
          (const int*)(lut + P.lut_gtl), (const int*)(lut + P.lut_inv),
          (const int*)(lut + P.lut_recnm), (const int*)(lut + P.lut_recnr)};
}

// One kind of staged output run: row r = f * tb + bl holds the tile's
// values of record b0 + bl in output array f, W values per sample
// (W = M for AD, gt_w for GT, the chunk's genotypes for PL, else 1).
struct Runs {
  unsigned char* sm;   // staging region
  int slot;            // bytes per row slot
  char* base;          // output array f = 0
  int64_t f_stride;    // bytes between output arrays f and f + 1
  int64_t row0;        // element offset of row bl = 0: (b0 S + s0) W + g0
  int64_t b_stride;    // elements between records: S * W
};

// Where value e of run (f, bl) is staged: the run sits at its
// destination's offset modulo 16, which 32-bit arithmetic gives exactly.
template <int ES>
__device__ __forceinline__ unsigned char* stage_at(const Runs& R, int f,
                                                   int bl, int tb, int e) {
  const unsigned g = (unsigned)(uintptr_t)R.base
      + (unsigned)f * (unsigned)R.f_stride
      + ((unsigned)R.row0 + (unsigned)bl * (unsigned)R.b_stride) * ES;
  return R.sm + (f * tb + bl) * R.slot + (g & 15) + e * ES;
}

template <typename T>
__device__ __forceinline__ void put(unsigned char* dst, int e, int v) {
  ((T*)dst)[e] = narrow_to<T>(v);
}

// Writes n_f * tb staged runs of `len` bytes each to device memory:
// unit u of a row is the 16-byte-aligned destination chunk u; whole
// chunks leave as one 16-byte store, the ragged ends element by element.
template <int ES>
__device__ void copy_out(const Runs& R, int n_f, const Plan& P, int tbv,
                         int len, int l2u) {
  const int n_units = (n_f * P.tb) << l2u;
  const int umask = (1 << l2u) - 1;
  for (int u = threadIdx.x; u < n_units; u += kThreads) {
    const int r = u >> l2u;
    const int k = u & umask;
    const int bl = r & (P.tb - 1);
    if (bl >= tbv) continue;
    const int f = r >> P.log2_tb;
    char* g = R.base + f * R.f_stride + (R.row0 + bl * R.b_stride) * ES;
    const int lead = (int)((uintptr_t)g & 15);
    const int lo = 16 * k, hi = lo + 16;      // bytes from g - lead
    if (lo >= lead + len) continue;
    char* dst = g - lead + lo;
    const unsigned char* src = R.sm + r * R.slot + lo;
    if (lo >= lead && hi <= lead + len) {
      *(uint4*)dst = *(const uint4*)src;
    } else {
      const int x0 = max(lead - lo, 0), x1 = min(lead + len - lo, 16);
      for (int x = x0; x < x1; x += ES) {
        if constexpr (ES == 2)
          *(int16_t*)(dst + x) = *(const int16_t*)(src + x);
        else
          *(int*)(dst + x) = *(const int*)(src + x);
      }
    }
  }
}

// The output runs of one tile (PL at genotype chunk g0 of width gcv).
struct TileRuns {
  Runs pl, ad, gt, sc[3], dpi, info[3];
};

template <typename VT, typename ST>
__device__ TileRuns tile_runs(const Args& A, const Plan& P,
                              unsigned char* smem, const Tile& t, int g0,
                              int gcv) {
  TileRuns T;
  const int64_t bs0 = t.b0 * A.S + t.s0;
  const int64_t bsz = A.B * A.S * 4;
  T.pl = {smem + P.off_pl, P.slot_pl, A.pl_out, 0,
          bs0 * A.G_out + g0, A.S * A.G_out};
  T.ad = {smem + P.off_ad, P.slot_ad, A.ad_out, 0, bs0 * A.M, A.S * A.M};
  T.gt = {smem + P.off_gt, P.slot_gt, A.gt_out, 0, bs0 * A.gt_w,
          A.S * A.gt_w};
  char* sc_base[3] = {A.gq_out, A.dpf_out, A.mdp_out};
  for (int k = 0; k < 3; ++k)
    T.sc[k] = {smem + P.off_sc + k * P.tb * P.slot_sc, P.slot_sc,
               sc_base[k], 0, bs0, A.S};
  T.dpi = {smem + P.off_dpi, P.slot_w, A.dpi_out, 0, bs0, A.S};
  unsigned char* info_sm = smem + P.off_info;
  char* info_base[3] = {A.info_f_out, A.info_i_out, A.info_fs_out};
  const int nf[3] = {A.F, A.Fi, A.Fs};
  for (int k = 0; k < 3; ++k) {
    T.info[k] = {info_sm, P.slot_w, info_base[k], bsz, bs0, A.S};
    info_sm += nf[k] * P.tb * P.slot_w;
  }
  return T;
}

// Writes every staged run of the tile except PL.
template <typename VT, typename ST>
__device__ void copy_out_small(const Args& A, const Plan& P,
                               const TileRuns& T, const Tile& t) {
  copy_out<sizeof(VT)>(T.ad, 1, P, t.tbv, t.tsv * A.M * (int)sizeof(VT),
                       P.l2u_ad);
  copy_out<sizeof(VT)>(T.gt, 1, P, t.tbv, t.tsv * A.gt_w * (int)sizeof(VT),
                       P.l2u_gt);
  for (int k = 0; k < 3; ++k)
    copy_out<sizeof(ST)>(T.sc[k], 1, P, t.tbv, t.tsv * (int)sizeof(ST),
                         P.l2u_sc);
  copy_out<4>(T.dpi, 1, P, t.tbv, t.tsv * 4, P.l2u_w);
  const int nf[3] = {A.F, A.Fi, A.Fs};
  for (int k = 0; k < 3; ++k)
    if (nf[k]) copy_out<4>(T.info[k], nf[k], P, t.tbv, t.tsv * 4, P.l2u_w);
}

// Stages the outputs of (record bl, sample sl) other than PL: AD and GT
// remapped through the LUT row `iv` (kLoopM entries, -1 past M), GQ,
// FORMAT DP, MIN_DP, INFO DP and the INFO rows passed through.
template <typename VT, typename ST, int kLoopM>
__device__ __forceinline__ void stage_small(const Args& A, const Plan& P,
                                            const TileRuns& T, int bl,
                                            int sl, bool valid,
                                            int64_t cell, int nm, int nr,
                                            int nr_merged, int gl,
                                            const int (&iv)[kLoopM]) {
  // AD allele remap
  const int adl = valid ? __ldg(A.ad_len + cell) : 0;
  const int* adrow = A.ad + cell * A.A_in;
  unsigned char* ad_dst = stage_at<sizeof(VT)>(T.ad, 0, bl, P.tb, sl * A.M);
#pragma unroll
  for (int m = 0; m < kLoopM; ++m) {
    if (m < A.M) {
      int x = iv[m];
      if (x == -1) x = nr >= 0 ? nr : -1;
      const bool ok = x >= 0 && x < adl && x < A.A_in && m < nm;
      put<VT>(ad_dst, m, ok ? __ldg(adrow + x) : kIntMissing);
    }
  }
  // GT remap
  const int* gtrow = A.gt + cell * A.gt_w;
  unsigned char* gt_dst = stage_at<sizeof(VT)>(T.gt, 0, bl, P.tb,
                                               sl * A.gt_w);
  for (int p = 0; p < A.gt_w; ++p) {
    const int x = valid ? __ldg(gtrow + p) : kIntMissing;
    int o = x;
    if (!(A.phase && (p & 1))) {
      int merged = -1;
#pragma unroll
      for (int m = 0; m < kLoopM; ++m)
        if (m < A.M && iv[m] == x) merged = m;
      if (x >= 0 && x != kIntMissing)
        o = merged >= 0 ? merged : nr_merged;
    }
    put<VT>(gt_dst, p, p < gl ? o : kIntVectorEnd);
  }
  // passthrough scalars + INFO rows
  put<ST>(stage_at<sizeof(ST)>(T.sc[0], 0, bl, P.tb, sl), 0,
          valid ? __ldg(A.gq + cell) : kIntMissing);
  put<ST>(stage_at<sizeof(ST)>(T.sc[1], 0, bl, P.tb, sl), 0,
          valid ? __ldg(A.dp + cell) : kIntMissing);
  put<ST>(stage_at<sizeof(ST)>(T.sc[2], 0, bl, P.tb, sl), 0,
          valid ? __ldg(A.min_dp + cell) : kIntMissing);
  put<int>(stage_at<4>(T.dpi, 0, bl, P.tb, sl), 0,
           valid ? __ldg(A.dp_info + cell) : kIntMissing);
  const int64_t sc = A.S * A.C;
  for (int f = 0; f < A.F; ++f)
    put<int>(stage_at<4>(T.info[0], f, bl, P.tb, sl), 0,
             valid ? __ldg(A.info_f + f * sc + cell) : kNanBits);
  for (int f = 0; f < A.Fi; ++f)
    put<int>(stage_at<4>(T.info[1], f, bl, P.tb, sl), 0,
             valid ? __ldg(A.info_i + f * sc + cell) : kIntMissing);
  for (int f = 0; f < A.Fs; ++f)
    put<int>(stage_at<4>(T.info[2], f, bl, P.tb, sl), 0,
             valid ? __ldg(A.info_fs + f * sc + cell) : kNanBits);
}

// Genotype index of sorted (lo, hi) for the diploid path: C(lo, 1) +
// C(hi + 1, 2).  An allele index past the term table's rows cannot occur
// (a cell's alleles are a subset of the record's merged alleles, at most
// 16); it reads as an index past every PL row, as a too-large index does.
__device__ __forceinline__ int diploid_index(int lo, int hi) {
  return hi < kTermRows ? lo + ((hi * (hi + 1)) >> 1) : INT32_MAX;
}

// Sorts v ascending: an unrolled insertion network.
template <int kP>
__device__ __forceinline__ void sort_slots(int (&v)[kP]) {
#pragma unroll
  for (int q = 1; q < kP; ++q) {
#pragma unroll
    for (int r = q; r > 0; --r) {
      const int lo = min(v[r - 1], v[r]);
      v[r] = max(v[r - 1], v[r]);
      v[r - 1] = lo;
    }
  }
}

// The input PL index of the genotype whose packed word is `word`, for a
// call of ploidy pc <= kP (kP: the launch's largest ploidy): each slot's
// allele is mapped through the inverse LUT row `invrow` (NON_REF `nr` as
// the fallback), the slots are sorted, and the index is the sum of the
// term table's C(a_q + q, q + 1).  INT32_MAX (past every PL row) when a
// slot has no input allele or an allele lies past the term table (which
// cannot occur: a cell's alleles are below 16).  All kP slots are read,
// those past pc as allele 0 and then dropped: straight-line code, whose
// loads leave together.
template <int kP>
__device__ __forceinline__ int genotype_index(int word, int pc,
                                              const int* invrow, int nr,
                                              const int* term) {
  bool bad = false;
  int a[kP];
#pragma unroll
  for (int q = 0; q < kP; ++q) {
    int x = invrow[(word >> (4 * q)) & 15];
    if (x == -1) x = nr >= 0 ? nr : -1;
    bad |= q < pc && x == -1;
    a[q] = q < pc ? max(x, 0) : INT32_MAX;
  }
  // unused slots hold INT_MAX and stay last
  sort_slots<kP>(a);
  int in_gt = 0;
#pragma unroll
  for (int q = 0; q < kP; ++q) {
    const int t = term[q * kTermRows + min(a[q], kTermRows - 1)];
    if (q < pc) {
      bad |= a[q] >= kTermRows;
      in_gt += t;
    }
  }
  return bad ? INT32_MAX : in_gt;
}

// The instantiation families (see the note in fused_gather_remap.cu):
// kFamily is a template argument, with kM the bound on M (0 for the
// general family) and kP the bound on the ploidy (the polyploid family's
// only).
constexpr int kGeneral = 0;     // ploidy 3-6 in genotype chunks
constexpr int kDiploid = 1;     // ploidy 2, not mixed
constexpr int kPloidy2 = 2;     // largest ploidy <= 2, mixed; or ploidy 1
constexpr int kPolyploid = 3;   // ploidy 3-6, whole PL rows

// Blocks per SM the register-bound families are built for: five (48
// registers) at M <= 8, four (64) at M <= 16, where five would spill;
// the ploidy <= 2 family spills at five at M <= 4 too (4 bytes), and
// takes four there.  Uncapped they take more registers and run slower
// on the card.
constexpr int min_blocks(int family, int m) {
  return family == kGeneral ? 1
      : m > 8 || (family == kPloidy2 && m <= 4) ? 4 : 5;
}

template <typename VT, typename ST, int kFamily, int kM>
__global__ void __launch_bounds__(kThreads, min_blocks(kFamily, kM))
fused_gather_remap_kernel(const Args A, const Plan P) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kFast = kFamily != kGeneral;
  constexpr int kLoopM = kFast ? kM : kMaxMerged;
  int* hdr = (int*)(smem + P.off_hdr);
  int* term = (int*)(smem + P.off_term);
  if constexpr (!kFast) {
    for (int i = threadIdx.x; i < kHeaderInts + kTermInts; i += kThreads) {
      if (i < kHeaderInts) hdr[i] = A.tables[i];
      else term[i - kHeaderInts] = A.tables[i];
    }
  }
  const int nbs = 1 << P.log2_nbs;
  // work item w: tile w / n_chunks, PL chunk w % n_chunks (the chunks of
  // one tile go to different blocks)
  const int n_work = P.n_tiles * P.n_chunks;
  int w = blockIdx.x;
  if (w < n_work) load_lut(A, P, smem + P.off_lut, w / P.n_chunks);
  cp_async_commit();
  int cur = 0;
  for (; w < n_work; w += gridDim.x) {
    const int next = w + gridDim.x;
    if (next < n_work)
      load_lut(A, P, smem + P.off_lut + (cur ^ 1) * P.lut_bytes,
               next / P.n_chunks);
    cp_async_commit();
    const int tile = w / P.n_chunks;
    const int chunk = w - tile * P.n_chunks;
    cp_async_wait_prev();         // this tile's rows have landed
    __syncthreads();
    const LutRows L = lut_rows(P, smem + P.off_lut + cur * P.lut_bytes);
    int64_t* cell_s = (int64_t*)(smem + P.off_cell);
    int* pll_s = (int*)(smem + P.off_pll);
    int* pcall_s = (int*)(smem + P.off_pcall);
    const Tile t = tile_at(A, P, tile);
    const TileRuns T = tile_runs<VT, ST>(A, P, smem, t, 0,
                                         kFast ? A.G_out : 0);

    // ---- per (record, sample): everything but the general PL (the
    // outputs other than PL only with a tile's first chunk) ----
    for (int i = threadIdx.x; i < nbs; i += kThreads) {
      const int bl = i & (P.tb - 1);
      const int sl = i >> P.log2_tb;
      if (bl >= t.tbv || sl >= t.tsv) continue;
      const int64_t s = t.s0 + sl;
      const int lv = L.live[bl * P.lut_row + sl];
      const bool valid = lv >= 0;
      const int64_t cell = s * A.C + (valid ? lv : 0);
      const int nm = L.recnm[bl];
      const int nr = L.nr[bl * P.lut_row + sl];
      const int nr_merged = L.recnr[bl] ? nm - 1 : -1;
      const int* invrow = L.inv + bl * P.inv_row + sl * A.M;
      int iv[kLoopM];
#pragma unroll
      for (int m = 0; m < kLoopM; ++m) iv[m] = m < A.M ? invrow[m] : -1;
      const int pll = valid ? __ldg(A.pl_len + cell) : 0;
      int gl = A.gt_w;
      if (A.mixed) gl = L.gtl[bl * P.lut_row + sl];
      // the call's ploidy (0: none the launch takes; unused on the
      // diploid family)
      int p_call = A.ploidy;
      if (A.mixed) p_call = A.phase ? (gl + 1) >> 1 : gl;
      p_call = p_call >= 1 && p_call <= A.ploidy ? p_call : 0;
      if (!kFast) {
        cell_s[i] = cell;
        pll_s[i] = pll;
        pcall_s[i] = p_call;
        if (chunk > 0) continue;
      }
      stage_small<VT, ST, kLoopM>(A, P, T, bl, sl, valid, cell, nm, nr,
                                  nr_merged, gl, iv);

      if constexpr (kFast) {
        // PL of a diploid call: genotype g = k (k + 1) / 2 + j is the
        // sorted pair (j, k), j <= k < M; its largest allele is k
        int xm[kLoopM];
#pragma unroll
        for (int m = 0; m < kLoopM; ++m)
          xm[m] = iv[m] == -1 ? (nr >= 0 ? nr : -1) : iv[m];
        const int* plrow = A.pl + cell * A.G_in;
        unsigned char* pl_dst = stage_at<sizeof(VT)>(T.pl, 0, bl, P.tb,
                                                     sl * A.G_out);
        if (kFamily == kDiploid || A.ploidy == 2) {
#pragma unroll
          for (int k = 0; k < kLoopM; ++k) {
#pragma unroll
            for (int j = 0; j <= k; ++j) {
              if (k < A.M) {
                const int g = k * (k + 1) / 2 + j;
                const int x0 = xm[j], x1 = xm[k];
                bool missing = x0 == -1 || x1 == -1;
                const int a0 = max(x0, 0), a1 = max(x1, 0);
                int in_gt = diploid_index(min(a0, a1), max(a0, a1));
                bool in_rec = k < nm;
                if constexpr (kFamily == kPloidy2) {
                  // a haploid call's entry g is merged allele g's; no
                  // load where the entry is VECTOR_END
                  if (p_call != 2) {
                    const int xh = g < kLoopM ? xm[min(g, kLoopM - 1)] : -1;
                    missing = p_call == 0 || g >= A.M || xh == -1;
                    in_gt = max(xh, 0);
                    in_rec = g < nm;
                  }
                }
                const bool ok = !missing && in_gt < pll && in_gt < A.G_in
                    && in_rec;
                int v = ok ? __ldg(plrow + in_gt) : kIntMissing;
                if constexpr (kFamily == kPloidy2) {
                  if (p_call == 0 || (p_call == 1 && g >= A.M))
                    v = kIntVectorEnd;
                }
                put<VT>(pl_dst, g, v);
              }
            }
          }
        } else {
          // a haploid-only launch (ploidy 1, mixed or not): G_out = M,
          // entry k is merged allele k's
#pragma unroll
          for (int k = 0; k < kLoopM; ++k) {
            if (k < A.M) {
              const int x = xm[k];
              const bool ok = p_call == 1 && x != -1 && x < pll
                  && x < A.G_in && k < nm;
              put<VT>(pl_dst, k, p_call == 0 ? kIntVectorEnd
                                 : ok ? __ldg(plrow + x) : kIntMissing);
            }
          }
        }
      }
    }
    __syncthreads();

    if constexpr (kFast) {
      copy_out<sizeof(VT)>(T.pl, 1, P, t.tbv,
                           t.tsv * A.G_out * (int)sizeof(VT), P.l2u_pl);
      copy_out_small<VT, ST>(A, P, T, t);
    } else {
      // ---- general PL: one (record, sample, genotype) per thread ----
      const int g0 = chunk * P.gc;
      const int gcv = min(P.gc, A.G_out - g0);
      const TileRuns Tc = tile_runs<VT, ST>(A, P, smem, t, g0, gcv);
      for (int u = threadIdx.x;; u += kThreads) {
        const int gi = u >> P.log2_nbs;
        if (gi >= gcv) break;
        const int i = u & (nbs - 1);
        const int bl = i & (P.tb - 1);
        const int sl = i >> P.log2_tb;
        if (bl >= t.tbv || sl >= t.tsv) continue;
        const int g = g0 + gi;
        const int pc = pcall_s[i];
        int v = kIntVectorEnd;
        if (pc > 0 && g < hdr[2 * pc + 1]) {
          const int word = __ldg(A.tables + hdr[2 * pc] + g);
          const int* invrow = L.inv + bl * P.inv_row + sl * A.M;
          const int nr = L.nr[bl * P.lut_row + sl];
          int in_gt;
          // uniform: the launch's largest ploidy, 3-6 on this family
          switch (A.ploidy) {
            case 3: in_gt = genotype_index<3>(word, pc, invrow, nr, term);
                    break;
            case 4: in_gt = genotype_index<4>(word, pc, invrow, nr, term);
                    break;
            case 5: in_gt = genotype_index<5>(word, pc, invrow, nr, term);
                    break;
            default: in_gt = genotype_index<6>(word, pc, invrow, nr, term);
          }
          const bool ok = in_gt < pll_s[i] && in_gt < A.G_in
              && (word >> 24) < L.recnm[bl];
          v = ok ? __ldg(A.pl + cell_s[i] * A.G_in + in_gt) : kIntMissing;
        }
        put<VT>(stage_at<sizeof(VT)>(Tc.pl, 0, bl, P.tb, sl * gcv), gi,
                v);
      }
      __syncthreads();
      copy_out<sizeof(VT)>(Tc.pl, 1, P, t.tbv,
                           t.tsv * gcv * (int)sizeof(VT), P.l2u_pl);
      if (chunk == 0) copy_out_small<VT, ST>(A, P, T, t);
    }
    __syncthreads();              // staging and this LUT buffer are free
    cur ^= 1;
  }
  cp_async_wait_all();
}

// ---- the polyploid family ----

// Its term table, in shared memory where the general family keeps its
// header and term table (1,600 bytes, which this family does not
// otherwise use): row q, column x holds C(x + q, q + 1) for x < 64, and
// kBadTerm at x = 64, the code of a slot with no input allele.  kBadTerm
// is past every PL row, and six of them stay below INT32_MAX.
constexpr int kTermCols = kTermRows + 1;
constexpr int kNoAllele = kTermRows;
constexpr int kBadTerm = 1 << 28;
// an unused slot's allele: above every allele the walk reaches
constexpr int kUnusedSlot = 1 << 20;
// Blocks per SM the polyploid family is built for: four (64
// registers, no stack).  Five (48) spills at M <= 16 and was no faster on
// the card, three (72-80) slower (PERF.md).
constexpr int kPolyploidMinBlocks = 4;

// The input allele of each merged allele m of one (record, sample), in
// byte m (four per word).  Named words, not an array: a lookup by a
// runtime allele is a select of words, which stays in registers (an
// array would be indexed in local memory).
struct AlleleBytes {
  unsigned w0, w1, w2, w3;
};

template <int kM>
__device__ __forceinline__ int allele_byte(const AlleleBytes& x, int a) {
  unsigned w = a < 4 ? x.w0 : x.w1;
  if constexpr (kM > 8) w = a < 8 ? w : a < 12 ? x.w2 : x.w3;
  return (int)__byte_perm(w, 0, 0x4440 | (a & 3));
}

// One thread's contiguous run [g_lo, g_end) of the PL row of (record,
// sample): the call's genotypes walked in canonical order by an odometer
// over its sorted merged-allele slots a[] (the colex successor: the
// lowest slot below its upper neighbour steps up, the slots under it
// drop to 0), each slot's input allele x[] kept beside it.  A genotype's
// input index is the sum over the sorted x[] of the term table.  A call
// of ploidy pc < kP leaves kP - pc slots unused: their allele is
// kUnusedSlot (never stepped) and their input allele 0.  Genotypes whose
// alleles all lie below the record's merged count come first in this
// order (g < g_nm), those of the call's ploidy before VECTOR_END
// (g < g_pc).
//
// kInOrder: every pair of the warp maps its merged alleles to input
// alleles that do not decrease (reference blocks, and most calls: the
// merge keeps a call's alleles in their order), so the slots in
// canonical order are sorted by input allele too.  The index is then the
// sum of row q's term of x[q] over the real slots, and a step of slot 0
// (most steps) moves it by the change of that one term: no sort.
// Otherwise the slots are sorted, the unused ones first (they read row
// 0, column 0: C(0, 1) = 0), and the real slots take rows 0..pc-1
// through `rowoff`.
template <typename VT, int kM, int kP, bool kInOrder>
__device__ __forceinline__ void polyploid_run(
    const int* term, const AlleleBytes& xw, int pc, int nm, int M,
    int lim, const int* plrow, unsigned char* pl_dst, int g_lo,
    int g_end) {
  const int g_pc = pc ? term[(pc - 1) * kTermCols + M] : 0;
  const int g_nm = pc ? term[(pc - 1) * kTermCols + nm] : 0;
  int rowoff[kP];
#pragma unroll
  for (int q = 0; q < kP; ++q)
    rowoff[q] = kInOrder ? q * kTermCols
                         : max(q - (kP - pc), 0) * kTermCols;
  // unrank g_lo: slot q takes the largest a with C(a + q, q + 1) <= rest
  int a[kP], x[kP];
  int rest = g_lo;
#pragma unroll
  for (int q = kP - 1; q >= 0; --q) {
    int aq = 0;
    if (q < pc) {
#pragma unroll
      for (int c = 1; c < kM; ++c) aq += term[q * kTermCols + c] <= rest;
      rest -= term[q * kTermCols + aq];
    }
    a[q] = q < pc ? aq : kUnusedSlot;
    x[q] = q < pc ? allele_byte<kM>(xw, aq) : 0;
  }
  const int x0 = allele_byte<kM>(xw, 0);
  // the index of the slots' genotype: in order, the real slots' terms;
  // else the sorted slots' terms
  auto index = [&]() {
    int sum = 0;
    if constexpr (kInOrder) {
#pragma unroll
      for (int q = 0; q < kP; ++q)
        sum += q < pc ? term[rowoff[q] + x[q]] : 0;
    } else {
      int s[kP];
#pragma unroll
      for (int q = 0; q < kP; ++q) s[q] = x[q];
      sort_slots<kP>(s);
#pragma unroll
      for (int q = 0; q < kP; ++q) sum += term[rowoff[q] + s[q]];
    }
    return sum;
  };
  int in_gt = index();
  auto gather = [&](int g) {
    return g < g_nm && in_gt < lim ? __ldg(plrow + in_gt) : kIntMissing;
  };
  // genotype g's value is gathered one step earlier, so that its load is
  // in flight while the next genotype is found
  int v = gather(g_lo);
  for (int g = g_lo; g < g_end; ++g) {
    // the next genotype
    if (a[0] < a[1]) {
      ++a[0];
      const int x_new = allele_byte<kM>(xw, a[0]);
      if constexpr (kInOrder)
        in_gt += (x_new < kNoAllele ? x_new : kBadTerm)
                 - (x[0] < kNoAllele ? x[0] : kBadTerm);
      x[0] = x_new;
      if constexpr (!kInOrder) in_gt = index();
    } else {
      int inc = kP - 1;
#pragma unroll
      for (int q = kP - 2; q >= 1; --q)
        if (a[q] < a[q + 1]) inc = q;
      int a_new = 0;
#pragma unroll
      for (int q = 1; q < kP; ++q)
        if (q == inc) a_new = a[q] + 1;
      const int x_new = allele_byte<kM>(xw, a_new);
#pragma unroll
      for (int q = 0; q < kP; ++q) {
        if (q < inc) {
          a[q] = 0;
          x[q] = x0;
        } else if (q == inc) {
          a[q] = a_new;
          x[q] = x_new;
        }
      }
      in_gt = index();
    }
    const int v_next = g + 1 < g_end ? gather(g + 1) : 0;
    put<VT>(pl_dst, g, g < g_pc ? v : kIntVectorEnd);
    v = v_next;
  }
}

// What one (record, sample) of a tile brings to the polyploid family.
template <int kM>
struct PairState {
  bool valid;
  int64_t cell;
  int nm, nr, gl, pc;
  int iv[kM];          // inverse LUT row, -1 past M
};

template <int kM>
__device__ __forceinline__ PairState<kM> pair_state(const Args& A,
                                                    const Plan& P,
                                                    const LutRows& L,
                                                    const Tile& t, int bl,
                                                    int sl) {
  PairState<kM> q;
  const int lv = L.live[bl * P.lut_row + sl];
  q.valid = lv >= 0;
  q.cell = (t.s0 + sl) * A.C + (q.valid ? lv : 0);
  q.nm = L.recnm[bl];
  q.nr = L.nr[bl * P.lut_row + sl];
  const int* invrow = L.inv + bl * P.inv_row + sl * A.M;
#pragma unroll
  for (int m = 0; m < kM; ++m) q.iv[m] = m < A.M ? invrow[m] : -1;
  q.gl = A.gt_w;
  if (A.mixed) q.gl = L.gtl[bl * P.lut_row + sl];
  // the call's ploidy (0: none the launch takes)
  int pc = A.ploidy;
  if (A.mixed) pc = A.phase ? (q.gl + 1) >> 1 : q.gl;
  q.pc = pc >= 1 && pc <= A.ploidy ? pc : 0;
  return q;
}

// Launches whose largest ploidy is 3-6 (kP: 3, 4, or 6 for 5 and 6),
// mixed or not, whose whole PL row a tile stages in one pass.  Each
// (record, sample) of the tile is served by 256 / (tile pairs) threads
// (thread i takes pair i % pairs: a warp's lanes walk the same
// genotypes of 32 pairs, so the odometer's branches are uniform), each
// walking a contiguous run of its PL row; the first of them also stages
// the pair's other outputs.  One barrier before the staged runs leave,
// as in the fast families.
template <typename VT, typename ST, int kM, int kP>
__global__ void __launch_bounds__(kThreads, kPolyploidMinBlocks)
polyploid_kernel(const Args A, const Plan P) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* term = (int*)(smem + P.off_hdr);
  for (int i = threadIdx.x; i < kP * kTermCols; i += kThreads) {
    const int q = i / kTermCols, c = i - q * kTermCols;
    term[i] = c < kTermRows ? A.tables[kHeaderInts + q * kTermRows + c]
                            : kBadTerm;
  }
  const int pair = threadIdx.x & ((1 << P.log2_nbs) - 1);
  const int bl = pair & (P.tb - 1);
  const int sl = pair >> P.log2_tb;
  const int part = threadIdx.x >> P.log2_nbs;
  const int log2_parts = kLog2Threads - P.log2_nbs;
  const int run = (A.G_out + (1 << log2_parts) - 1) >> log2_parts;
  const int g_lo = min(part * run, A.G_out);
  const int g_end = min(g_lo + run, A.G_out);
  int w = blockIdx.x;
  if (w < P.n_tiles) load_lut(A, P, smem + P.off_lut, w);
  cp_async_commit();
  int cur = 0;
  for (; w < P.n_tiles; w += gridDim.x) {
    const int next = w + gridDim.x;
    if (next < P.n_tiles)
      load_lut(A, P, smem + P.off_lut + (cur ^ 1) * P.lut_bytes, next);
    cp_async_commit();
    cp_async_wait_prev();         // this tile's rows have landed
    __syncthreads();
    const LutRows L = lut_rows(P, smem + P.off_lut + cur * P.lut_bytes);
    const Tile t = tile_at(A, P, w);
    const TileRuns T = tile_runs<VT, ST>(A, P, smem, t, 0, A.G_out);
    const bool mine = bl < t.tbv && sl < t.tsv;
    PairState<kM> q;
    // each merged allele's input allele (NON_REF fallback), once, one
    // byte each: kNoAllele where there is none (or one past the term
    // table, which cannot occur: a cell's alleles are below 16)
    AlleleBytes xw = {0, 0, 0, 0};
    bool in_order = true;
    if (mine) {
      q = pair_state<kM>(A, P, L, t, bl, sl);
      if (part == 0)
        stage_small<VT, ST, kM>(A, P, T, bl, sl, q.valid, q.cell, q.nm,
                                q.nr, L.recnr[bl] ? q.nm - 1 : -1, q.gl,
                                q.iv);
      int prev = 0;
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const int xv = q.iv[m] == -1 ? q.nr : q.iv[m];
        const int b = xv < 0 ? kNoAllele : min(xv, kNoAllele);
        in_order &= m >= A.M || b >= prev;
        prev = b;
        const unsigned w8 = (unsigned)b << (8 * (m & 3));
        if (m < 4) xw.w0 |= w8;
        else if (m < 8) xw.w1 |= w8;
        else if (m < 12) xw.w2 |= w8;
        else xw.w3 |= w8;
      }
    }
    // one path per warp (every lane reaches the vote)
    in_order = __all_sync(0xffffffffu, in_order);
    if (mine) {
      const int pll = q.valid ? __ldg(A.pl_len + q.cell) : 0;
      const int lim = min(pll, A.G_in);
      const int* plrow = A.pl + q.cell * A.G_in;
      unsigned char* pl_dst = stage_at<sizeof(VT)>(T.pl, 0, bl, P.tb,
                                                   sl * A.G_out);
      if (in_order)
        polyploid_run<VT, kM, kP, true>(term, xw, q.pc, q.nm, A.M, lim,
                                        plrow, pl_dst, g_lo, g_end);
      else
        polyploid_run<VT, kM, kP, false>(term, xw, q.pc, q.nm, A.M, lim,
                                         plrow, pl_dst, g_lo, g_end);
    }
    __syncthreads();
    copy_out<sizeof(VT)>(T.pl, 1, P, t.tbv,
                         t.tsv * A.G_out * (int)sizeof(VT), P.l2u_pl);
    copy_out_small<VT, ST>(A, P, T, t);
    __syncthreads();              // staging and this LUT buffer are free
    cur ^= 1;
  }
  cp_async_wait_all();
}

// The plan's grid counts the blocks an SM holds by shared memory alone;
// the instantiation's registers may hold fewer, and a grid past what is
// resident runs its last work items in a second wave, so the grid is cut
// to the resident blocks.
template <typename VT, typename ST, int kFamily, int kM, int kP = 0>
cudaError_t launch(const Args& a, const Plan& p, cudaStream_t st) {
  void (*k)(const Args, const Plan);
  if constexpr (kFamily == kPolyploid)
    k = polyploid_kernel<VT, ST, kM, kP>;
  else
    k = fused_gather_remap_kernel<VT, ST, kFamily, kM>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads,
                                                      p.smem);
  if (e != cudaSuccess) return e;
  const int grid = min(p.grid, max(1, per_sm * sms));
  k<<<grid, kThreads, p.smem, st>>>(a, p);
  return cudaGetLastError();
}

// Every instantiation, (family, bound on M, bound on ploidy) per family,
// each in the three forms: wide, narrow, narrow + scalars.
#define GDB_FGR_DIPLOID(X) X(kDiploid, 4, 0) X(kDiploid, 8, 0) \
                           X(kDiploid, 16, 0)
#define GDB_FGR_PLOIDY2(X) X(kPloidy2, 4, 0) X(kPloidy2, 8, 0) \
                           X(kPloidy2, 16, 0)
#define GDB_FGR_GENERAL(X) X(kGeneral, 0, 0)
#define GDB_FGR_POLYPLOID3(X) X(kPolyploid, 8, 3) X(kPolyploid, 16, 3)
#define GDB_FGR_POLYPLOID4(X) X(kPolyploid, 8, 4) X(kPolyploid, 16, 4)
#define GDB_FGR_POLYPLOID6(X) X(kPolyploid, 8, 6) X(kPolyploid, 16, 6)

#define GDB_FGR_FORM(EXT, VT, ST, F, M, P) \
  EXT template cudaError_t launch<VT, ST, F, M, P>(const Args&, \
                                                   const Plan&, \
                                                   cudaStream_t);
#define GDB_FGR_FORMS(EXT, F, M, P) GDB_FGR_FORM(EXT, int, int, F, M, P) \
  GDB_FGR_FORM(EXT, int16_t, int, F, M, P) \
  GDB_FGR_FORM(EXT, int16_t, int16_t, F, M, P)
// an explicit instantiation, and its declaration for the other units
#define GDB_FGR_DEFINE(F, M, P) GDB_FGR_FORMS(, F, M, P)
#define GDB_FGR_EXTERN(F, M, P) GDB_FGR_FORMS(extern, F, M, P)

GDB_FGR_DIPLOID(GDB_FGR_EXTERN)
GDB_FGR_PLOIDY2(GDB_FGR_EXTERN)
GDB_FGR_GENERAL(GDB_FGR_EXTERN)
GDB_FGR_POLYPLOID3(GDB_FGR_EXTERN)
GDB_FGR_POLYPLOID4(GDB_FGR_EXTERN)
GDB_FGR_POLYPLOID6(GDB_FGR_EXTERN)

}  // namespace gdb_fgr
