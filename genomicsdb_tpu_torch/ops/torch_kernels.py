"""Batched torch ops for the combine (counterpart of
`genomicsdb_tpu.ops.jax_kernels`).

Plain PyTorch on whatever device the tensors lie on.  They are the
general combine path (`combine_step`) and, through it, the plain twin
of the hand-written CUDA kernel (`fused_combine.fused_gather_remap_ref`).
Shapes follow the JAX functions:

  R = records (aligned sub-intervals) per block
  S = samples (rows)
  M = max merged alleles (padded)
  G = max genotypes     (padded)

Semantics mirror variant_field_handler.cc:42-420 (remaps) and
:530-700 (combine reductions).  Genotype-index arithmetic stays int32
(the same width the JAX and Pallas versions compute in); sums over the
sample axis come back int64, as the JAX package's x64 `jnp.sum` does.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..core import formats

from .cell_block import genotype_combo_table, ncr_table

INT_MISSING = formats.INT_MISSING
LUT_MISSING = -1
INT32_MAX = 2**31 - 1


def _sorting_network(vals: List[torch.Tensor]) -> List[torch.Tensor]:
    """Ascending sort of a static-length list of equal-shape tensors
    (the ploidy axis stays a Python list: each element is [R, S, G])."""
    vals = list(vals)
    n = len(vals)
    for i in range(n):
        for j in range(0, n - i - 1):
            lo = torch.minimum(vals[j], vals[j + 1])
            hi = torch.maximum(vals[j], vals[j + 1])
            vals[j], vals[j + 1] = lo, hi
    return vals


def _gather_last(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values [R, S, K] gathered at idx [R, S, X] along the last axis,
    with idx clamped into [0, K) (JAX's out-of-range gather rule)."""
    k = values.shape[-1]
    return torch.gather(values, -1, idx.clamp(0, k - 1).long())


def remap_genotype_fields(values: torch.Tensor, inv_lut: torch.Tensor,
                          in_len: torch.Tensor, input_nr: torch.Tensor,
                          num_merged: torch.Tensor,
                          num_merged_alleles: int, ploidy: int
                          ) -> torch.Tensor:
    """Batched G-length remap (PL reorder).

    values:   [R, S, Gin]  int32, padded with INT_MISSING
    inv_lut:  [R, S, M]    merged-allele -> input-allele (-1 = absent)
    in_len:   [R, S]       #valid elements of `values` per call
    input_nr: [R, S]       input NON_REF allele idx (-1 = none)
    num_merged: [R]        actual #merged alleles per record
    Returns [R, S, G] int32 remapped, INT_MISSING where no mapping.
    """
    dev = values.device
    combos_np = genotype_combo_table(num_merged_alleles, ploidy)
    combos = torch.as_tensor(combos_np, device=dev).long()  # [G, P]
    G = combos.shape[0]
    Kv = values.shape[-1]
    R, S = values.shape[:2]
    nr = input_nr[..., None]                               # [R, S, 1]
    slot_alleles = []
    combo_missing = torch.zeros((R, S, G), dtype=torch.bool, device=dev)
    for p in range(ploidy):
        a = inv_lut[..., combos[:, p]]                     # [R, S, G]
        a = torch.where(a == LUT_MISSING,
                        torch.where(nr >= 0, nr, LUT_MISSING), a)
        combo_missing = combo_missing | (a == LUT_MISSING)
        slot_alleles.append(torch.clamp(a, min=0))
    # canonical genotype index of the sorted allele vector:
    # gt = sum_i C(i + a_i, i + 1)  (variant_field_handler.cc:299-321)
    sorted_slots = _sorting_network(slot_alleles)
    ncr = None
    if ploidy > 4:
        ncr = torch.as_tensor(
            ncr_table(num_merged_alleles + ploidy + 2), device=dev)
    in_gt = torch.zeros_like(sorted_slots[0])
    for i, a in enumerate(sorted_slots):
        if i == 0:
            term = a
        elif i == 1:
            term = torch.div((a + 1) * a, 2, rounding_mode="floor")
        elif i == 2:
            term = torch.div((a + 2) * (a + 1) * a, 6,
                             rounding_mode="floor")
        elif i == 3:
            term = torch.div((a + 3) * (a + 2) * (a + 1) * a, 24,
                             rounding_mode="floor")
        else:
            # ncr[i + a, a] = C(i + a, a - 1) (r = -1 folded at column 0)
            n_i = (i + a).clamp(0, ncr.shape[0] - 1).long()
            r_i = a.clamp(0, ncr.shape[1] - 1).long()
            term = ncr[n_i, r_i]
        in_gt = in_gt + term
    in_gt = in_gt.to(torch.int32)
    ok = (~combo_missing) & (in_gt < in_len[..., None])
    gathered = _gather_last(values, in_gt)
    if Kv <= 32:
        # the JAX form selects over the static Kv axis: an index past it
        # matches no slot and stays missing
        ok = ok & (in_gt < Kv)
    # genotypes beyond the record's actual count stay missing
    max_allele = torch.as_tensor(combos_np.max(axis=-1), device=dev)
    ok = ok & (max_allele[None, None, :] < num_merged[:, None, None])
    return torch.where(ok, gathered, INT_MISSING).to(torch.int32)


def remap_allele_fields(values: torch.Tensor, inv_lut: torch.Tensor,
                        in_len: torch.Tensor, input_nr: torch.Tensor,
                        num_merged: torch.Tensor, alt_only: bool
                        ) -> torch.Tensor:
    """Batched R/A-length remap (AD reorder).

    values: [R, S, K] padded; inv_lut: [R, S, M]; returns [R, S, M or
    M-1] int32."""
    if alt_only:
        inv = inv_lut[..., 1:]
        offset = 1
    else:
        inv = inv_lut
        offset = 0
    nr = input_nr[..., None]
    in_allele = torch.where(inv == LUT_MISSING,
                            torch.where(nr >= 0, nr, LUT_MISSING), inv)
    idx = in_allele - offset
    ok = (in_allele != LUT_MISSING) & (idx >= 0) & (idx < in_len[..., None])
    Kv = values.shape[-1]
    gathered = _gather_last(values, idx)
    if Kv <= 32:
        ok = ok & (idx < Kv)
    m = torch.arange(inv.shape[-1], device=values.device)[None, None, :]
    ok = ok & (m < (num_merged[:, None, None] - offset))
    return torch.where(ok, gathered, INT_MISSING).to(torch.int32)


def _median_at_half(v: torch.Tensor, valid: torch.Tensor):
    """Element n//2 of the ascending stable sort of v along the last axis
    (n = #valid); invalid entries must already hold the +max pad."""
    v = torch.sort(v, dim=-1, stable=True).values
    n = valid.sum(dim=-1)
    idx = torch.div(n, 2, rounding_mode="floor").clamp(0, v.shape[-1] - 1)
    med = torch.gather(v, -1, idx[..., None].long())[..., 0]
    return med, n > 0


def masked_median_int(values: torch.Tensor, valid: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference median semantics (variant_field_handler.cc:530-560):
    ascending nth_element at n_valid/2 over the last (sample) axis.

    values: [..., S]; valid: [..., S] bool.  Returns (median [...],
    any_valid [...])."""
    return _median_at_half(torch.where(valid, values, INT32_MAX), valid)


def masked_median_float(values: torch.Tensor, valid: torch.Tensor):
    """Float form of masked_median_int, padding with +inf.  The sort is
    stable, so equal keys (-0.0 and 0.0) keep their input order, as the
    JAX sort does."""
    return _median_at_half(torch.where(valid, values, float("inf")),
                           valid)


def masked_sum(values: torch.Tensor, valid: torch.Tensor):
    s = torch.where(valid, values, 0).sum(dim=-1)
    return s, valid.any(dim=-1)


def dp_combine(dp_info: torch.Tensor, dp_format: torch.Tensor,
               min_dp: torch.Tensor, v_info: torch.Tensor,
               v_format: torch.Tensor, v_min: torch.Tensor) -> torch.Tensor:
    """INFO DP logic (broad_combined_gvcf.cc:690-726), batched [R, S]
    -> [R] int64."""
    dp_val = torch.where(v_info, dp_info,
                         torch.where(v_min, min_dp,
                                     torch.where(v_format, dp_format, 0)))
    use = v_info | v_min | v_format
    return torch.where(use, dp_val, 0).sum(dim=-1, dtype=torch.int64)
