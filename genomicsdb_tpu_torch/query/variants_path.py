"""Variants path: interval query with GA4GH call grouping.

Equivalent of VariantQueryProcessor::gt_get_column_interval
(query_variants.cc:687-845) + Variant::move_calls_to_separate_variants +
GA4GHOperator::operate/copy_back_remapped_fields for multi-call variants.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import formats
from ..core.config import QueryConfig
from ..store.columnar import ColumnarStore
from ..ops import merge as M
from .cells import CallView


def gt_get_column_interval(store: ColumnarStore, qc: QueryConfig,
                           interval: Tuple[int, int]):
    """Returns [(start, end, common_or_None, [CallView,...]), ...]."""
    begin, end = interval
    rows = set(qc.rows_to_query)
    calls: List[CallView] = []
    for ci in store.cells_intersecting(begin):
        if int(store.row[ci]) in rows:
            calls.append(CallView(store, ci, qc))
    if end > begin:
        for ci in store.cells_in_column_range(begin + 1, end):
            if int(store.row[ci]) in rows:
                calls.append(CallView(store, ci, qc))
    # GA4GH grouping by (begin, end, REF, ALT-set)
    # (variant.cc:26-54 GA4GHCallInfoToVariantIdx::find_or_insert)
    variants: List[List[CallView]] = []
    key_to_idx: Dict[tuple, int] = {}
    for call in calls:
        ref = call.ref
        alts = call.alt_list
        if ref is None or alts is None:
            key = None
        else:
            key = (call.col, call.end, ref, frozenset(alts))
        if key is not None and key in key_to_idx:
            variants[key_to_idx[key]].append(call)
        else:
            if key is not None:
                key_to_idx[key] = len(variants)
            variants.append([call])
    out = []
    for group in variants:
        common = None
        if len(group) > 1:
            common = _ga4gh_operate(group, qc)
        first = group[0]
        out.append((first.col, first.end, common, group))
    return out


def gt_get_column_interval_paged(store: ColumnarStore, qc: QueryConfig,
                                 interval: Tuple[int, int],
                                 max_variants_per_page: int):
    """Paged variant production (GA4GHPagingInfo equivalent,
    variant.h:595 / query_variants.cc:687 paging logic): yields pages of at
    most `max_variants_per_page` variants; page boundaries never split the
    variants of one column (forward progress per page is guaranteed by
    finishing the trailing column).  Concatenated pages == unpaged result.
    """
    variants = gt_get_column_interval(store, qc, interval)
    yield from gt_get_column_interval_paged_list(variants,
                                                 max_variants_per_page)


def gt_get_column_interval_paged_list(variants, max_variants_per_page):
    page: List = []
    i = 0
    while i < len(variants):
        page.append(variants[i])
        if len(page) >= max_variants_per_page:
            col = variants[i][0]
            while i + 1 < len(variants) and variants[i + 1][0] == col:
                i += 1
                page.append(variants[i])
            yield page
            page = []
        i += 1
    if page:
        yield page


def _ga4gh_operate(group: List[CallView], qc: QueryConfig):
    """GA4GH merge + in-place remap of allele-dependent fields + GT.

    Reference: variant_operations.cc:572-700 + copy_back_remapped_fields.
    Returns (merged_ref, merged_alts) common fields."""
    refs = [c.field("REF") for c in group]
    alts = [c.alt_list for c in group]
    merged_ref = M.merge_reference_allele(refs)
    merged_alts, lut, non_ref_exists = M.merge_alt_alleles(
        refs, alts, merged_ref)
    is_ref_block_only = (len(merged_ref) == 1 and len(merged_alts) == 1
                         and merged_alts[0] == M.NON_REF)
    if is_ref_block_only:
        return merged_ref, merged_alts
    num_merged = len(merged_alts) + 1
    gt_info = qc.field_info("GT") if qc.is_queried("GT") else None
    max_alt = qc.params.max_diploid_alt_alleles_that_can_be_genotyped
    remap_fields = [a for a in qc.attributes
                    if qc.field_info(a) is not None
                    and qc.field_info(a).length.is_allele_dependent()]
    for ci, call in enumerate(group):
        ploidy = 0
        gt = call.gt
        if gt is not None and gt_info is not None:
            ploidy = gt_info.length.ploidy(len(gt))
            call.set_field("GT", M.remap_gt_field(
                np.asarray(gt), lut[ci], num_merged, non_ref_exists,
                gt_info.length.contains_phase()))
        for name in remap_fields:
            info = qc.field_info(name)
            if (info.length.is_genotype_dependent()
                    and len(merged_alts) > max_alt):
                continue
            val = call.field(name)
            if val is None:
                continue
            if info.length.num_dimensions > 1:
                continue  # multi-D remap not printed in variants goldens
            missing = (formats.FLOAT_MISSING if info.type == "float"
                       else formats.INT_MISSING)
            if info.length.is_genotype_dependent():
                out = M.remap_by_genotype(np.asarray(val), lut[ci],
                                          num_merged, non_ref_exists,
                                          ploidy, missing)
            else:
                out = M.remap_by_alleles(np.asarray(val), lut[ci],
                                         num_merged, non_ref_exists,
                                         info.length.is_only_alt_dependent(),
                                         missing)
            call.set_field(name, out)
    return merged_ref, merged_alts
