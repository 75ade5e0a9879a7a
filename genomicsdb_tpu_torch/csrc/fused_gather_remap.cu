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
// cost more than its gathers.  At ploidy 3-6 a PL row holds 100-800
// genotypes, each a sort of its slots and a sum of table terms, so
// instructions come close to the bytes there.
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
//   * No division and no local memory in the remap.  Four families of
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
//       - polyploid (largest ploidy 3-6, mixed or not, whose whole PL
//         row a tile stages: every such launch at 1,000 samples, where
//         the block's PL budget caps M at 10 for ploidy 3 and at 7 for
//         ploidy 4), at a bound kP on the ploidy of 3, 4 or 6 (5 runs
//         as 6 with a slot unused) and kM of 8 or 16.  Each (record,
//         sample) maps its merged alleles through the inverse LUT, with
//         the NON_REF fallback, once, into bytes packed in registers.
//         Its PL row is split among the 256 / (tile pairs) threads that
//         serve it in contiguous runs: a thread unranks its run's first
//         genotype once, then walks its run with an odometer over the
//         sorted merged-allele slots in registers (the next genotype in
//         canonical order moves one slot), sorts the slots' input
//         alleles with an unrolled network and sums C(x + q, q + 1)
//         from a table in shared memory; its gathers stay on one cell's
//         row, each issued one genotype ahead of its store.  Where every
//         pair of a warp maps its merged alleles to input alleles that
//         do not decrease (reference blocks and most calls), the slots
//         need no sort and a step of the lowest slot moves the index by
//         one term.  A call's ploidy comes from its GT length in
//         registers: a call below the launch's ploidy leaves slots
//         unused (they sort first and add 0), so calls of different
//         ploidy in one warp run one loop; its row ends in VECTOR_END,
//         as does the row of a call of no ploidy the launch takes.  PL
//         is staged with the other outputs and leaves with them after
//         one barrier; registers are capped at four blocks per SM.  The
//         family is bound by instructions, not bytes (PERF.md);
//       - general (ploidy 3-6 whose PL row does not fit a tile's shared
//         memory: m 16, ploidy 6, 54,264 genotypes; the launch's plan
//         has genotype chunks): reads inv from shared memory, sorts the
//         slots with an unrolled network over as many registers as the
//         launch's largest ploidy (unused slots hold INT_MAX) and sums
//         C(a + i, i + 1) from a term table in shared memory; it
//         computes PL one (record, sample, genotype) element per thread,
//         one chunk of genotypes per work item (the chunks of one tile
//         are taken by different blocks).  A genotype's alleles and its
//         largest allele are one packed word, read from device memory
//         through the read-only path.
//     The first three stage a whole PL row and write it out with the
//     other outputs.
//   * Outputs are staged in shared memory in the consumer layout and
//     written out coalesced: for one record, a tile's TS samples x W
//     values are one contiguous run of [B, S, W] (one run of TS values
//     for [B, S] scalars and each [F, B, S] INFO row).  A run is staged
//     at the same offset modulo 16 as its destination, so it leaves in
//     16-byte stores, with element stores only at its two ragged ends.
//
// Sources: this file holds `dispatch` and the C entry point;
// fused_gather_remap.cuh the device code; fused_gather_remap_<family>.cu
// one family's instantiations each, so that the build compiles them at
// once (ops/_kernel_build.py).
//
// Inputs are int32 (float INFO tensors are read as their int32 bits);
// the Python wrapper (ops/fused_combine.py) checks device, dtype, shape
// and contiguity and computes the plan before it launches.  The launch
// goes to the caller's stream; the entry point allocates nothing, does
// not synchronise, and returns cudaGetLastError().

#include "fused_gather_remap.cuh"

using namespace gdb_fgr;

namespace {

// The instantiation for the launch (ops/fused_combine.instantiation
// mirrors this): diploid non-mixed, or ploidy <= 2 mixed or haploid, at a
// bound on M (4, 8 or 16); ploidy 3-6 in one PL pass the polyploid one,
// at a bound on the ploidy and on M (8 or 16); the general one for
// ploidy 3-6 in genotype chunks.
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
  if (p.n_chunks == 1) {
    if (a.ploidy == 3) {
      if (a.M <= 8) return launch<VT, ST, kPolyploid, 8, 3>(a, p, st);
      return launch<VT, ST, kPolyploid, 16, 3>(a, p, st);
    }
    if (a.ploidy == 4) {
      if (a.M <= 8) return launch<VT, ST, kPolyploid, 8, 4>(a, p, st);
      return launch<VT, ST, kPolyploid, 16, 4>(a, p, st);
    }
    if (a.M <= 8) return launch<VT, ST, kPolyploid, 8, 6>(a, p, st);
    return launch<VT, ST, kPolyploid, 16, 6>(a, p, st);
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
