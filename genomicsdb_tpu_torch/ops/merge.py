"""Allele-merge and remap kernels (numpy semantics oracle).

Reimplements the reference merge math:
  * merge_reference_allele   variant_operations.cc:73-122
  * merge_alt_alleles        variant_operations.cc:134-228
  * remap_GT_field           variant_operations.cc:233-263
  * remap_data_based_on_alleles / _genotype{_haploid,_diploid,_general}
                             variant_field_handler.cc:42-420
  * genotype enumeration     http://genome.sph.umich.edu/wiki/Relationship_
                             between_Ploidy,_Alleles_and_Genotypes
The batched JAX formulations in ops/jax_kernels.py are validated against
these.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

NON_REF = "&"
SPANNING_DELETION = "*"
LUT_MISSING = -1


def is_symbolic_allele(allele: str) -> bool:
    return (allele.startswith(NON_REF) or allele == SPANNING_DELETION
            or (len(allele) > 0 and allele[0] == "<" and allele[-1] == ">")
            or "[" in allele or "]" in allele)


def merge_reference_allele(refs: Sequence[Optional[str]]) -> str:
    """Longest-REF merge; 'N' placeholder handling.

    `refs` lists REF of calls that begin AT the variant position (callers
    must exclude mid-interval calls).  Reference:
    variant_operations.cc:73-122.
    """
    def in_the_middle(r: str) -> bool:  # CHECK_IN_THE_MIDDLE_REF
        return r == "N"

    merged = "N"
    for ref in refs:
        if ref is None:
            continue
        if len(ref) > len(merged):
            if in_the_middle(merged):
                merged = ref
            else:
                merged = merged + ref[len(merged):]
        elif in_the_middle(merged) and not in_the_middle(ref):
            merged = ref
    return merged


def merge_alt_alleles(call_refs: Sequence[Optional[str]],
                      call_alts: Sequence[Optional[List[str]]],
                      merged_ref: str
                      ) -> Tuple[List[str], np.ndarray, bool]:
    """Dedup + suffix-extend ALT alleles against the merged REF.

    Returns (merged_alts, lut, non_ref_exists) where
    lut[call_idx, input_allele_idx] = merged allele idx (or -1).
    Allele indices include REF at 0.  Reference:
    variant_operations.cc:134-228.
    """
    ncalls = len(call_refs)
    max_in_alleles = 1 + max((len(a) for a in call_alts if a is not None),
                             default=0)
    seen: Dict[str, int] = {NON_REF: -1}
    merged_alts: List[str] = []
    non_ref_exists = False
    input_non_ref_idx = np.full(ncalls, LUT_MISSING, dtype=np.int32)
    lut = np.full((ncalls, max_in_alleles), LUT_MISSING, dtype=np.int32)
    next_idx = 1
    for c in range(ncalls):
        ref = call_refs[c]
        alts = call_alts[c]
        if ref is None or alts is None:
            continue
        suffix = merged_ref[len(ref):] if len(ref) < len(merged_ref) else ""
        lut[c, 0] = 0
        for i, allele in enumerate(alts):
            in_idx = i + 1
            if allele.startswith(NON_REF):
                input_non_ref_idx[c] = in_idx
                non_ref_exists = True
                continue
            if suffix and not is_symbolic_allele(allele):
                allele = allele + suffix
            if allele not in seen:
                seen[allele] = next_idx
                merged_alts.append(allele)
                lut[c, in_idx] = next_idx
                next_idx += 1
            else:
                lut[c, in_idx] = seen[allele]
    if non_ref_exists:
        merged_alts.append(NON_REF)
        nr_idx = len(merged_alts)  # merged allele idx incl. REF
        for c in range(ncalls):
            if input_non_ref_idx[c] >= 0:
                lut[c, input_non_ref_idx[c]] = nr_idx
    return merged_alts, lut, non_ref_exists


def inverse_lut(lut_row: np.ndarray, num_merged: int) -> np.ndarray:
    """merged allele idx -> input allele idx (-1 if absent)."""
    inv = np.full(num_merged, LUT_MISSING, dtype=np.int32)
    for in_idx, m in enumerate(lut_row):
        if 0 <= m < num_merged:
            inv[m] = in_idx
    return inv


def inverse_lut_matrix(lut: np.ndarray, num_merged: int) -> np.ndarray:
    """inverse_lut for every row of `lut` at once ([n, num_merged])."""
    n, k = lut.shape
    inv = np.full((n, num_merged), LUT_MISSING, dtype=np.int32)
    m = np.asarray(lut).ravel()
    ok = (m >= 0) & (m < num_merged)
    rows = np.repeat(np.arange(n), k)
    in_idx = np.tile(np.arange(k, dtype=np.int32), n)
    # duplicate merged indices: last input index wins (matches the loop)
    inv[rows[ok], m[ok]] = in_idx[ok]
    return inv


def remap_gt_field(input_gt: np.ndarray, lut_row: np.ndarray,
                   num_merged: int, non_ref_exists: bool,
                   contains_phase: bool) -> np.ndarray:
    """reference variant_operations.cc:233-263."""
    INT_MISSING = -(2**31)
    out = input_gt.copy()
    step = 2 if contains_phase else 1
    for i in range(0, len(input_gt), step):
        v = int(input_gt[i])
        if v == -1 or v == INT_MISSING or v == INT_MISSING + 1:
            out[i] = v
            continue
        m = lut_row[v] if 0 <= v < len(lut_row) else LUT_MISSING
        if m == LUT_MISSING:
            out[i] = (num_merged - 1) if non_ref_exists else -1
        else:
            out[i] = m
    return out


@lru_cache(maxsize=4096)
def genotype_combinations(num_alleles: int, ploidy: int
                          ) -> Tuple[Tuple[int, ...], ...]:
    """All genotype combinations in canonical (VCF) enumeration order.

    Combination k lists the (sorted ascending) allele indices of genotype k.
    Matches the reference's stack enumeration
    (variant_field_handler.cc:199-296): genotypes ordered so that the
    highest-index allele varies slowest.
    """
    if ploidy == 0:
        return tuple()
    out: List[Tuple[int, ...]] = []

    def rec(max_allele: int, remaining: int, acc: Tuple[int, ...]):
        if remaining == 0:
            out.append(acc)
            return
        for a in range(0, max_allele + 1):
            rec(a, remaining - 1, (a,) + acc)

    for top in range(0, num_alleles):
        rec(top, ploidy - 1, (top,))
    return tuple(out)


def genotype_index(allele_idx_vec: Sequence[int]) -> int:
    """Canonical genotype index of a combination.

    Reference: variant_field_handler.cc:299-321 (get_genotype_index).
    """
    v = sorted(allele_idx_vec)
    ploidy = len(v)
    if ploidy == 0:
        return 0
    if ploidy == 1:
        return v[0]
    if ploidy == 2:
        a, b = v
        return b * (b + 1) // 2 + a
    idx = 0
    for i, a in enumerate(v):
        idx += _ncr(i + a, a - 1)
    return idx


def _ncr(n: int, r: int) -> int:
    if r < 0:
        return 0
    if r > n:
        return 0
    result = 1
    for i in range(r):
        result = result * (n - i) // (i + 1)
    return result


def remap_by_alleles(input_data: np.ndarray, lut_row: np.ndarray,
                     num_merged: int, non_ref_exists: bool,
                     alt_only: bool, missing_value) -> np.ndarray:
    """A/R-length field remap (variant_field_handler.cc:42-82)."""
    nr_merged = num_merged - 1 if non_ref_exists else LUT_MISSING
    inv = inverse_lut(lut_row, num_merged)
    input_nr = inv[nr_merged] if non_ref_exists else LUT_MISSING
    length = num_merged - 1 if alt_only else num_merged
    out = np.full(length, missing_value, dtype=input_data.dtype)
    for j in range(length):
        allele_j = j + 1 if alt_only else j
        in_j = inv[allele_j] if allele_j < num_merged else LUT_MISSING
        if in_j == LUT_MISSING:
            if input_nr == LUT_MISSING:
                continue
            in_j = input_nr
        idx = in_j - 1 if alt_only else in_j
        if 0 <= idx < len(input_data):
            out[j] = input_data[idx]
    return out


def remap_by_genotype(input_data: np.ndarray, lut_row: np.ndarray,
                      num_merged: int, non_ref_exists: bool, ploidy: int,
                      missing_value) -> np.ndarray:
    """G-length field remap for any ploidy
    (variant_field_handler.cc:84-296)."""
    inv = inverse_lut(lut_row, num_merged)
    input_nr = (inv[num_merged - 1] if non_ref_exists else LUT_MISSING)
    combos = genotype_combinations(num_merged, ploidy)
    out = np.full(len(combos), missing_value, dtype=input_data.dtype)
    for gt_idx, combo in enumerate(combos):
        in_alleles = []
        missing = False
        for a in combo:
            ia = inv[a]
            if ia == LUT_MISSING:
                if input_nr == LUT_MISSING:
                    missing = True
                    break
                ia = input_nr
            in_alleles.append(int(ia))
        if missing:
            continue
        in_gt = genotype_index(in_alleles)
        if in_gt < len(input_data):
            out[gt_idx] = input_data[in_gt]
    return out
