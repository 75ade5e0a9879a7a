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
// Narrow form (VT = int16_t): PL, AD and GT are stored as int16 with the
// BCF16 sentinels (INT_MISSING -> -32768, INT_VECTOR_END -> -32767), and
// with ST = int16_t so are GQ, FORMAT DP and MIN_DP.  Any other value is
// cast unclamped: the host checked that every input value lies in
// [-32000, 32000] before it chose this form, and the remap only permutes
// values and adds sentinels.  INFO DP and the INFO rows stay 32-bit.
// One kernel body serves every form, so the remap is written once.
//
// What bounds it: bytes.  It is an integer gather and select with no
// matrix work: per (b, s) it reads a LUT row and, once per distinct live
// cell, that cell's fields, and writes G_out + M + gt_w + 4 + F words.
// The cell slabs are store-wide ([S, C_store, ...], uploaded once per
// query): at the JAX bench's shape they fit L2, on the main path's
// 1,000-sample store they do not, so its gathers come from device
// memory.  The floor is those bytes at device-memory bandwidth; the
// kernel reaches about a third of it (PERF.md), and its staged writes
// cost more than its gathers.
//
// Design.  One block owns a tile of TB records x TS samples (8 x 32 by
// preference: faster than 16 x 16 on the card, PERF.md) and walks
// tiles in a grid-stride loop.  The tile plan (tile sizes, genotype
// chunk, shared-memory layout, grid) is computed by the Python wrapper
// (ops/fused_combine.tile_plan) and passed in as `Plan`.
//   * LUT rows: the tile's live / NON_REF / GT-length rows ([B, S]) and
//     inv_bs rows ([B, S, M]) are contiguous along s; they are copied to
//     shared memory with cp.async, double-buffered, so the next tile's
//     rows arrive while this tile computes.  Rows are padded by one word
//     against bank conflicts.
//   * Gather mapping: thread i takes b = i % TB, s = i / TB, so a warp
//     holds runs of neighbouring records of a few samples.  live[b, s] does
//     not decrease with b, so their cells are neighbours in each input
//     slab (often the same reference-block cell): each load instruction
//     touches a few sectors, not 32 rows C words apart.
//   * No division and no local memory in the remap.  Three families of
//     instantiations, which `dispatch` picks per launch:
//       - diploid (ploidy 2, not mixed: the main path), at a bound kM on
//         M of 4, 8 or 16: inv in registers, loops fully unrolled, the
//         index of sorted (lo, hi) taken as lo + hi (hi + 1) / 2 (a
//         shift), one (record, sample) per thread;
//       - ploidy <= 2 (a launch whose largest ploidy is at most 2 that is
//         mixed, as chrX/chrY blocks with haploid and diploid calls are,
//         or a haploid-only launch), at the same bounds on M: the diploid
//         family's registers and loops, with each call's ploidy taken in
//         registers from its GT length.  A diploid call writes the
//         diploid PL row; a haploid call writes entry k from merged
//         allele k and VECTOR_END from M on; a call of no ploidy the
//         launch takes writes VECTOR_END.  Every PL entry is a select
//         and one gather in the same unrolled loop, so haploid and
//         diploid calls in one warp do not diverge;
//       - general (ploidy 3-6, mixed or not): reads inv from shared
//         memory, sorts the slots with an unrolled network over as many
//         registers as the launch's largest ploidy (a template bound,
//         chosen per launch; unused slots hold INT_MAX) and sums
//         C(a + i, i + 1) from a term table in shared memory, in
//         straight-line code whose loads leave together; it computes PL
//         one (record, sample, genotype) element per thread, in genotype
//         chunks when a row does not fit shared memory (m 16, ploidy 6:
//         54,264 genotypes; the chunks of one tile are separate work
//         items, taken by different blocks).  A genotype's alleles and
//         its largest allele are one packed word, read from device
//         memory through the read-only path (the lanes of a warp read one
//         or two words; at ploidy <= 4 the words fit L1).  Staging them
//         in shared memory was no faster on the card (PERF.md).
//     The first two families stage a whole PL row (at most 136
//     genotypes at M 16) and write it out with the other outputs.
//   * Outputs are staged in shared memory in the consumer layout and
//     written out coalesced: for one record, a tile's TS samples x W
//     values are one contiguous run of [B, S, W] (one run of TS values
//     for [B, S] scalars and each [F, B, S] INFO row).  A run is staged
//     at the same offset modulo 16 as its destination, so it leaves in
//     16-byte stores, with element stores only at its two ragged ends.
//
// Inputs are int32 (float INFO tensors are read as their int32 bits);
// the Python wrapper (ops/fused_combine.py) checks device, dtype, shape
// and contiguity and computes the plan before it launches.  The launch
// goes to the caller's stream; the entry point allocates nothing, does
// not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kIntMissing = INT32_MIN;            // bcf_int32_missing
constexpr int kIntVectorEnd = INT32_MIN + 1;      // bcf_int32_vector_end
constexpr int kNanBits = 0x7FC00000;              // float32 quiet NaN
constexpr int16_t kInt16Missing = -32768;         // bcf_int16_missing
constexpr int16_t kInt16VectorEnd = -32767;       // bcf_int16_vector_end
constexpr int kMaxPloidy = 6;
constexpr int kMaxMerged = 16;
constexpr int kThreads = 256;
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
__device__ void load_lut(const Args& A, const Plan& P, unsigned char* buf,
                         int tile) {
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

// Genotype index of sorted (lo, hi) for the diploid path: C(lo, 1) +
// C(hi + 1, 2).  An allele index past the term table's rows cannot occur
// (a cell's alleles are a subset of the record's merged alleles, at most
// 16); it reads as an index past every PL row, as a too-large index does.
__device__ __forceinline__ int diploid_index(int lo, int hi) {
  return hi < kTermRows ? lo + ((hi * (hi + 1)) >> 1) : INT32_MAX;
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
  // ascending sort: an unrolled insertion network (unused slots hold
  // INT_MAX and stay last)
#pragma unroll
  for (int q = 1; q < kP; ++q) {
#pragma unroll
    for (int r = q; r > 0; --r) {
      const int lo = min(a[r - 1], a[r]);
      a[r] = max(a[r - 1], a[r]);
      a[r - 1] = lo;
    }
  }
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

// The instantiation families (see the header): kFamily is a template
// argument, with kM the bound on M (0 for the general family).
constexpr int kGeneral = 0;   // ploidy 3-6, mixed or not
constexpr int kDiploid = 1;   // ploidy 2, not mixed
constexpr int kPloidy2 = 2;   // largest ploidy <= 2, mixed; or ploidy 1

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
    const unsigned char* lut = smem + P.off_lut + cur * P.lut_bytes;
    const int* live_s = (const int*)(lut + P.lut_live);
    const int* nr_s = (const int*)(lut + P.lut_nr);
    const int* gtl_s = (const int*)(lut + P.lut_gtl);
    const int* inv_s = (const int*)(lut + P.lut_inv);
    const int* recnm_s = (const int*)(lut + P.lut_recnm);
    const int* recnr_s = (const int*)(lut + P.lut_recnr);
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
      const int lv = live_s[bl * P.lut_row + sl];
      const bool valid = lv >= 0;
      const int64_t cell = s * A.C + (valid ? lv : 0);
      const int nm = recnm_s[bl];
      const int nr = nr_s[bl * P.lut_row + sl];
      const int nr_merged = recnr_s[bl] ? nm - 1 : -1;
      const int* invrow = inv_s + bl * P.inv_row + sl * A.M;
      int iv[kLoopM];
#pragma unroll
      for (int m = 0; m < kLoopM; ++m) iv[m] = m < A.M ? invrow[m] : -1;
      const int pll = valid ? __ldg(A.pl_len + cell) : 0;
      int gl = A.gt_w;
      if (A.mixed) gl = gtl_s[bl * P.lut_row + sl];
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

      // AD allele remap
      const int adl = valid ? __ldg(A.ad_len + cell) : 0;
      const int* adrow = A.ad + cell * A.A_in;
      unsigned char* ad_dst = stage_at<sizeof(VT)>(T.ad, 0, bl, P.tb,
                                                   sl * A.M);
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
          const int* invrow = inv_s + bl * P.inv_row + sl * A.M;
          const int nr = nr_s[bl * P.lut_row + sl];
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
              && (word >> 24) < recnm_s[bl];
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

// The plan's grid counts the blocks an SM holds by shared memory alone;
// the instantiation's registers may hold fewer, and a grid past what is
// resident runs its last work items in a second wave, so the grid is cut
// to the resident blocks.
template <typename VT, typename ST, int kFamily, int kM>
cudaError_t launch(const Args& a, const Plan& p, cudaStream_t st) {
  auto k = fused_gather_remap_kernel<VT, ST, kFamily, kM>;
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

// The instantiation for the launch (ops/fused_combine.instantiation
// mirrors this): diploid non-mixed, or ploidy <= 2 mixed or haploid, at a
// bound on M (4, 8 or 16); the general one for ploidy 3-6.
template <typename VT, typename ST>
cudaError_t dispatch(const Args& a, const Plan& p, cudaStream_t st) {
  if (a.ploidy == 2 && !a.mixed) {
    if (a.M <= 4) return launch<VT, ST, kDiploid, 4>(a, p, st);
    if (a.M <= 8) return launch<VT, ST, kDiploid, 8>(a, p, st);
    return launch<VT, ST, kDiploid, 16>(a, p, st);
  }
  if (a.ploidy <= 2) {
    // a whole PL row per tile: one pass
    if (p.n_chunks != 1) return cudaErrorInvalidValue;
    if (a.M <= 4) return launch<VT, ST, kPloidy2, 4>(a, p, st);
    if (a.M <= 8) return launch<VT, ST, kPloidy2, 8>(a, p, st);
    return launch<VT, ST, kPloidy2, 16>(a, p, st);
  }
  return launch<VT, ST, kGeneral, 0>(a, p, st);
}

}  // namespace

// narrow = 0: every output int32 (the wide form).  narrow = 1: PL/AD/GT
// int16; narrow_scalars = 1 (only with narrow = 1): GQ/DP/MIN_DP int16
// too.  Output pointers must match those widths.  `plan` points to
// `plan_len` host ints, the fields of Plan in order.
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
    int mixed, int narrow, int narrow_scalars, const int* plan,
    int plan_len, void* stream) {
  if (M > kMaxMerged || M < 1 || ploidy > kMaxPloidy || ploidy < 1
      || (narrow_scalars && !narrow) || plan_len != kPlanInts
      || (mixed && gt_len == nullptr))
    return (int)cudaErrorInvalidValue;
  Plan p;
  memcpy(&p, plan, sizeof(Plan));
  if (B * S == 0 || p.n_tiles == 0 || p.n_chunks < 1)
    return (int)cudaSuccess;
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
  a.pl_out = (char*)pl_out;
  a.ad_out = (char*)ad_out;
  a.gt_out = (char*)gt_out;
  a.gq_out = (char*)gq_out;
  a.dpf_out = (char*)dpf_out;
  a.mdp_out = (char*)mdp_out;
  a.dpi_out = (char*)dpi_out;
  a.info_f_out = (char*)info_f_out;
  a.info_i_out = (char*)info_i_out;
  a.info_fs_out = (char*)info_fs_out;
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
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (!narrow)
    e = dispatch<int, int>(a, p, st);
  else if (!narrow_scalars)
    e = dispatch<int16_t, int>(a, p, st);
  else
    e = dispatch<int16_t, int16_t>(a, p, st);
  return (int)e;
}

extern "C" const char* gdb_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
