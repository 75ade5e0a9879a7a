"""Framework-free block layout and host helpers (numpy only).

Copies of the pieces of `genomicsdb_tpu.ops.combine_step` and
`genomicsdb_tpu.ops.jax_kernels` that carry no device code but live in
modules that import jax: the `CellBlock` layout, the genotype combo
tables, the host live-cell sweep and LUT gather, and the synthetic
cohort generator.  A `CellBlock` built by either package has the same
fields, so one block can be fed to both.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from ..core import formats
from . import merge as M

INT_MISSING = formats.INT_MISSING


@dataclass
class CellBlock:
    """Dense per-row cell layout for one column-partition block.

    S samples x C cells per sample (padded); B aligned intervals.
    All int32 except coordinates.
    """
    col: np.ndarray        # [S, C] int64, padded with INT64_MAX
    end: np.ndarray        # [S, C] int64 effective ENDs
    pl: np.ndarray         # [S, C, G_in] int32 padded INT_MISSING
    pl_len: np.ndarray     # [S, C] int32
    ad: np.ndarray         # [S, C, A_in] int32
    ad_len: np.ndarray     # [S, C]
    gt: np.ndarray         # [S, C, P] int32 allele idxs (-1 no-call)
    gq: np.ndarray         # [S, C] int32 (INT_MISSING invalid)
    dp: np.ndarray         # [S, C] int32 FORMAT DP
    min_dp: np.ndarray     # [S, C] int32
    dp_info: np.ndarray    # [S, C] int32 INFO DP
    info_f: np.ndarray     # [F, S, C] float32 scalar INFO fields, MEDIAN op
    info_i: np.ndarray     # [Fi, S, C] int32 scalar INFO fields, MEDIAN op
    info_fs: np.ndarray    # [Fs, S, C] float32 scalar INFO fields, SUM op
    inv_bs: np.ndarray     # [B, S, M] merged->input allele idx (-1 absent)
    nr_bs: np.ndarray      # [B, S] input NON_REF allele idx (-1 none)
    # per-interval (precomputed by the sweep):
    starts: np.ndarray     # [B] int64 interval starts
    rec_num_merged: np.ndarray  # [B] int32 merged alleles per record
    rec_has_nr: np.ndarray = None  # [B] bool: merged alleles include
    # NON_REF (gates the GT remap's absent-allele fallback,
    # variant_operations.cc:233-260 non_ref_exists)
    live: np.ndarray = None  # [B, S] int32 live cell idx (-1 none)
    del_rw: np.ndarray = None  # [B, S] bool: call was spanning-deletion-
    # rewritten -> its INFO combine contributions are invalidated
    # (broad_combined_gvcf.cc:1066-1075)
    gt_len_bs: np.ndarray = None  # [B, S] int32 stored GT length of the
    # live call (0 = missing); drives per-call ploidy for general-ploidy
    # cohorts
    ploidy: int = 2            # max ploidy the block is sized for
    gt_phase: bool = False     # GT stored with interleaved phase slots


@lru_cache(maxsize=64)
def genotype_combo_table(num_alleles: int, ploidy: int) -> np.ndarray:
    """[G, ploidy] int32: allele indices (ascending) of genotype g, in
    canonical VCF enumeration order."""
    combos = M.genotype_combinations(num_alleles, ploidy)
    return np.asarray(combos, dtype=np.int32).reshape(len(combos), ploidy)


@lru_cache(maxsize=8)
def ncr_table(n_max: int) -> np.ndarray:
    """[n_max+1, n_max+2] nCr with the r=-1 column folded in at index 0:
    table[n, r+1] = C(n, r), table[n, 0] = 0."""
    t = np.zeros((n_max + 1, n_max + 2), dtype=np.int32)
    for n in range(n_max + 1):
        for r in range(n + 1):
            t[n, r + 1] = M._ncr(n, r)
    return t


def live_cells_at_host(starts: np.ndarray, col: np.ndarray,
                       end: np.ndarray) -> np.ndarray:
    """Per (interval start, sample): index of the live cell ([B, S]
    int32, -1 none) — the last cell with col <= start and end >= start."""
    B, (S, C) = len(starts), col.shape
    live = np.full((B, S), -1, dtype=np.int32)
    for s in range(S):
        idx = np.searchsorted(col[s], starts, side="right") - 1
        ok = idx >= 0
        idxc = np.clip(idx, 0, C - 1)
        ok &= end[s, idxc] >= starts
        live[:, s] = np.where(ok, idxc, -1)
    return live


def gather_luts_host(inv_cell: np.ndarray, nr_cell: np.ndarray,
                     live: np.ndarray):
    """Per-cell LUTs [S, C, M] / [S, C] -> gathered [B, S, M] / [B, S]
    (for callers whose allele context is constant per cell, e.g. the
    synthetic cohort).  Cells with no live call get -1 LUTs."""
    valid = live >= 0
    k = np.clip(live, 0, inv_cell.shape[1] - 1)
    s_i = np.arange(inv_cell.shape[0])[None, :]
    inv_bs = np.where(valid[..., None], inv_cell[s_i, k], -1)
    nr_bs = np.where(valid, nr_cell[s_i, k], -1)
    return inv_bs.astype(np.int32), nr_bs.astype(np.int32)


def synthesize_cohort(num_samples: int, cells_per_sample: int,
                      region_len: int, seed: int = 0,
                      variant_fraction: float = 0.1,
                      max_merged: int = 4, ploidy: int = 2) -> CellBlock:
    """Synthetic gVCF cohort block: ref blocks + multi-allelic variant
    sites shared across samples.  Same generator, same seed, same
    arrays as `genomicsdb_tpu.ops.combine_step.synthesize_cohort`."""
    rng = np.random.default_rng(seed)
    S, C = num_samples, cells_per_sample
    G_in = max_merged * (max_merged + 1) // 2
    A_in = max_merged
    # per-sample interval tiling of the region
    bounds = np.sort(rng.integers(0, region_len, size=(S, C - 1)), axis=1)
    col = np.concatenate([np.zeros((S, 1), np.int64), bounds], axis=1)
    end = np.concatenate([bounds - 1, np.full((S, 1), region_len - 1,
                                              np.int64)], axis=1)
    # fix zero-length collisions
    bad = end < col
    end = np.where(bad, col, end)
    is_var = rng.random((S, C)) < variant_fraction
    n_in_alleles = np.where(is_var, rng.integers(2, max_merged + 1,
                                                 size=(S, C)), 2)
    pl = rng.integers(0, 2000, size=(S, C, G_in)).astype(np.int32)
    pl_len = (n_in_alleles * (n_in_alleles + 1) // 2).astype(np.int32)
    ad = rng.integers(0, 100, size=(S, C, A_in)).astype(np.int32)
    ad_len = n_in_alleles.astype(np.int32)
    gt = rng.integers(0, 2, size=(S, C, ploidy)).astype(np.int32)
    gq = rng.integers(0, 100, size=(S, C)).astype(np.int32)
    dp = rng.integers(0, 100, size=(S, C)).astype(np.int32)
    min_dp = np.where(is_var, INT_MISSING,
                      rng.integers(0, 40, size=(S, C))).astype(np.int32)
    dp_info = np.where(is_var, rng.integers(0, 100, size=(S, C)),
                       INT_MISSING).astype(np.int32)
    F = 6  # BaseQRankSum/Clipping/MQRankSum/ReadPos/MQ + extra
    info_f = rng.normal(size=(F, S, C)).astype(np.float32)
    info_f = np.where(is_var[None], info_f, np.nan).astype(np.float32)
    info_i = np.where(is_var, rng.integers(0, 50, size=(S, C)),
                      INT_MISSING).astype(np.int32)[None]   # MQ0-like
    info_fs = np.where(is_var, rng.random((S, C)) * 100, np.nan
                       ).astype(np.float32)[None]           # RAW_MQ-like
    # LUTs mirror the real merge invariant: cell alleles 0..n_in-2 map to
    # merged 0..n_in-2, the cell's NON_REF (last input allele) maps to the
    # LAST merged allele, middle merged alleles are absent (-1).
    inv_cell = np.full((S, C, max_merged), -1, dtype=np.int32)
    inv_cell[..., 0] = 0
    for m in range(1, max_merged - 1):
        inv_cell[..., m] = np.where(m < n_in_alleles - 1, m, -1)
    inv_cell[..., max_merged - 1] = n_in_alleles - 1  # NON_REF last
    nr_cell = (n_in_alleles - 1).astype(np.int32)
    # sweep on host for the synthetic block
    events = np.unique(np.concatenate([col.ravel(), end.ravel() + 1]))
    starts = events[events < region_len]
    rec_num_merged = np.full(len(starts), max_merged, dtype=np.int32)
    live = live_cells_at_host(starts, col, end)
    inv_bs, nr_bs = gather_luts_host(inv_cell, nr_cell, live)
    return CellBlock(col=col, end=end, pl=pl, pl_len=pl_len, ad=ad,
                     ad_len=ad_len, gt=gt, gq=gq, dp=dp, min_dp=min_dp,
                     dp_info=dp_info, info_f=info_f, info_i=info_i,
                     info_fs=info_fs,
                     inv_bs=inv_bs, nr_bs=nr_bs, starts=starts,
                     rec_num_merged=rec_num_merged, live=live)
