"""Multi-sample combine operator (GATK CombineGVCFs semantics).

Reimplements BroadCombinedGVCFOperator + GA4GHOperator (reference
src/main/cpp/src/query_operations/broad_combined_gvcf.cc:765-910 /
variant_operations.cc:572-700) over the columnar store's sweep output,
emitting VCF text lines byte-identical to the reference's htslib output.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import formats
from ..core import known_fields as kf
from ..core.config import QueryConfig
from ..core.vid import VidMapper
from ..ops import merge as M
from ..vcf.fasta import ReferenceGenome
from .cells import CallView
from .scan import Variant

LEGAL_BASES = {"A", "T", "G", "C"}


def _is_valid_arr(v) -> bool:
    return v is not None


class CombineOperator:
    """One instance per query; operate(variant) appends VCF lines."""

    def __init__(self, qc: QueryConfig, vid: VidMapper,
                 ref_genome: Optional[ReferenceGenome],
                 filter_id_order: Optional[List[str]] = None):
        self.qc = qc
        self.vid = vid
        self.ref_genome = ref_genome
        self.lines: List[str] = []
        self.max_diploid_alt = \
            qc.params.max_diploid_alt_alleles_that_can_be_genotyped
        self.produce_GT = qc.params.produce_GT_field
        self.sites_only = qc.params.sites_only_query
        self.produce_min_pl_gt = \
            qc.params.produce_GT_with_min_PL_value_for_spanning_deletions
        gt_info = vid.get_field_info("GT")
        self.gt_phase = (gt_info is not None
                         and gt_info.length.contains_phase())
        self.gt_queried = qc.is_queried("GT")
        # classify queried fields (reference broad_combined_gvcf.cc:165-265)
        self.info_fields: List[str] = []       # INFO combine fields, order
        self.format_fields: List[str] = []     # FORMAT fields, order
        self.histogram_fields: List[Tuple[str, str, str]] = []
        self.dp_info_queried = False
        hist_map: Dict[str, List[Optional[str]]] = {}
        for name in qc.attributes:
            info = vid.get_field_info(name)
            if info is None:
                continue
            op = info.combine_op
            add_info = (info.is_info and name != "END"
                        and not (name == "DP" and op == kf.OP_DP)
                        and op != kf.OP_MOVE_TO_FORMAT)
            add_format = (
                (info.is_format and (not self.sites_only
                                     or name in ("DP_FORMAT", "MIN_DP")))
                or (info.is_info
                    and ((name == "DP" and op == kf.OP_DP)
                         or (op == kf.OP_MOVE_TO_FORMAT
                             and not self.sites_only))))
            if add_info:
                if op == kf.OP_HISTOGRAM_SUM:
                    parent = info.parent_name
                    ent = hist_map.setdefault(parent, [None, None])
                    ent[info.tuple_index] = name
                elif op is not kf.OP_NONE:
                    self.info_fields.append(name)
            if add_format:
                if info.is_format or op == kf.OP_MOVE_TO_FORMAT:
                    self.format_fields.append(name)
                else:  # DP INFO handled at the end
                    self.dp_info_queried = True
        if self.dp_info_queried:
            self.format_fields.append("DP")  # DP INFO as last FORMAT
        for parent, (bin_f, cnt_f) in hist_map.items():
            self.histogram_fields.append((parent, bin_f, cnt_f))
        # allele-length-dependent query fields needing remap
        self.remapped_fields = [
            a for a in qc.attributes
            if vid.get_field_info(a) is not None
            and vid.get_field_info(a).length.is_allele_dependent()]
        # QUAL combine
        qual_info = vid.get_field_info("QUAL")
        self.qual_op = (qual_info.combine_op if qual_info is not None
                        else kf.OP_NONE)
        self.qual_queried = qc.is_queried("QUAL")
        self.filter_id_order = filter_id_order or []

    # ---------------- spanning deletions ----------------

    def handle_deletions(self, variant: Variant):
        """reference broad_combined_gvcf.cc:912-1078 (mutates calls)."""
        for qidx, call in variant.valid_calls():
            if not getattr(call, "contains_deletion_flag", False):
                continue
            if variant.start <= call.col:
                continue
            ref = call.ref
            alts = call.alt_list
            if ref is None or alts is None:
                continue
            # already rewritten?
            if alts and alts[0] == "*" and (
                    len(alts) == 1
                    or (len(alts) == 2 and alts[1].startswith("&"))):
                continue
            num_in_alleles = len(alts) + 1
            lut_row = np.full(num_in_alleles, M.LUT_MISSING, dtype=np.int32)
            lut_row[0] = 0
            gt = call.gt
            gt_info = self.qc.field_info("GT") if self.gt_queried else None
            ploidy = 0
            if gt is not None and gt_info is not None:
                ploidy = gt_info.length.ploidy(len(gt))
            pl = call.field("PL") if self.qc.is_queried("PL") else None
            lowest_del = -1
            lowest_pl = 2**31 - 1
            has_non_ref = False
            for i, alt in enumerate(alts):
                allele_idx = i + 1
                is_del = len(ref) > 1 and (
                    alt == "*" or (not M.is_symbolic_allele(alt)
                                   and len(alt) < len(ref)))
                if is_del:
                    if lowest_del < 0:
                        lowest_del = allele_idx
                    if pl is not None:
                        gt_idx = M.genotype_index([allele_idx] * ploidy)
                        if gt_idx < len(pl) and pl[gt_idx] < lowest_pl:
                            lowest_pl = int(pl[gt_idx])
                            lowest_del = allele_idx
                elif alt.startswith("&"):
                    lut_row[allele_idx] = 2
                    has_non_ref = True
            assert lowest_del >= 1
            lut_row[lowest_del] = 1
            new_alts = ["*", "&"] if has_non_ref else ["*"]
            num_reduced = len(new_alts) + 1
            call.set_field("REF", "N")
            call.set_field("ALT", "|".join(new_alts))
            # remap allele-length-dependent fields into the reduced space
            for name in self.remapped_fields:
                info = self.qc.field_info(name)
                val = call.field(name)
                if val is None:
                    continue
                if info.length.num_dimensions > 1:
                    remapped = self._remap_2d(val, lut_row, num_reduced,
                                              has_non_ref, info)
                    call.set_field(name, remapped)
                else:
                    missing = (formats.FLOAT_MISSING if info.type == "float"
                               else formats.INT_MISSING)
                    if info.length.is_genotype_dependent():
                        out = M.remap_by_genotype(
                            np.asarray(val), lut_row, num_reduced,
                            has_non_ref, ploidy, missing)
                    else:
                        out = M.remap_by_alleles(
                            np.asarray(val), lut_row, num_reduced,
                            has_non_ref, info.length.is_only_alt_dependent(),
                            missing)
                    call.set_field(name, out)
            # GT
            if gt is not None and ploidy > 0:
                new_pl = call.field("PL") if self.qc.is_queried("PL") else None
                done = False
                if new_pl is not None and self.produce_min_pl_gt:
                    combo = self._min_pl_genotype(np.asarray(new_pl),
                                                  num_reduced, ploidy)
                    if combo is not None:
                        out_gt = np.asarray(gt).copy()
                        step = 2 if self.gt_phase else 1
                        for j, i in enumerate(range(0, len(out_gt), step)):
                            out_gt[i] = combo[j]
                        call.set_field("GT", out_gt)
                        done = True
                if not done:
                    out_gt = M.remap_gt_field(np.asarray(gt), lut_row,
                                              num_reduced, has_non_ref,
                                              self.gt_phase)
                    call.set_field("GT", out_gt)
            # invalidate INFO combine fields for this call
            for name in self.info_fields:
                call.set_field(name, None)
            for _, bin_f, cnt_f in self.histogram_fields:
                call.set_field(bin_f, None)
                call.set_field(cnt_f, None)

    @staticmethod
    def _min_pl_genotype(pl: np.ndarray, num_alleles: int, ploidy: int
                         ) -> Optional[List[int]]:
        """Allele combination of the minimum valid PL value
        (variant_field_handler.cc:373-494)."""
        combos = M.genotype_combinations(num_alleles, ploidy)
        best = None
        best_val = 2**31 - 1
        for gt_idx, combo in enumerate(combos):
            if gt_idx >= len(pl):
                continue
            v = int(pl[gt_idx])
            if formats.is_bcf_valid_int(v) and v < best_val:
                best_val = v
                best = list(combo)
        return best

    def _remap_2d(self, val, lut_row, num_merged, non_ref_exists, info):
        """remap_allele_specific_annotations
        (variant_operations.cc:482-570): dim-0 is A or R over alleles."""
        code = info.length.dims[0][0]
        alt_only = code == kf.VL_A
        inv = M.inverse_lut(lut_row, num_merged)
        input_nr = inv[num_merged - 1] if non_ref_exists else M.LUT_MISSING
        length = num_merged - 1 if alt_only else num_merged
        out = []
        empty = np.zeros(0, dtype=val[0].dtype if len(val) else np.float32)
        for j in range(length):
            allele_j = j + 1 if alt_only else j
            in_j = inv[allele_j] if allele_j < num_merged else M.LUT_MISSING
            if in_j == M.LUT_MISSING:
                if input_nr == M.LUT_MISSING:
                    out.append(empty)
                    continue
                in_j = input_nr
            idx = in_j - 1 if alt_only else in_j
            if 0 <= idx < len(val):
                out.append(np.asarray(val[idx]))
            else:
                out.append(empty)
        return out

    # ---------------- GA4GH merge ----------------

    def ga4gh_merge(self, variant: Variant):
        """GA4GHOperator::operate equivalent.  Returns
        (merged_ref, merged_alts, remapped: per-qidx dict, is_ref_block_only)
        """
        refs = []
        valid_calls = list(variant.valid_calls())
        for qidx, call in valid_calls:
            if call.col < variant.start:
                continue
            refs.append(call.field("REF"))
        merged_ref = M.merge_reference_allele(refs)
        call_refs = []
        call_alts = []
        for qidx, call in valid_calls:
            call_refs.append(call.field("REF"))
            alt = call.field("ALT")
            call_alts.append(alt.split("|") if alt is not None else None)
        merged_alts, lut, non_ref_exists = M.merge_alt_alleles(
            call_refs, call_alts, merged_ref)
        is_ref_block_only = (len(merged_ref) == 1 and len(merged_alts) == 1
                             and merged_alts[0] == M.NON_REF)
        remapping_needed = not is_ref_block_only
        num_merged = len(merged_alts) + 1
        remapped: Dict[int, Dict[str, np.ndarray]] = {}
        ploidy_by_qidx: Dict[int, int] = {}
        if remapping_needed:
            gt_info = self.qc.field_info("GT") if self.gt_queried else None
            for ci, (qidx, call) in enumerate(valid_calls):
                rmap: Dict[str, np.ndarray] = {}
                ploidy = 0
                gt = call.gt
                if gt is not None and gt_info is not None:
                    ploidy = gt_info.length.ploidy(len(gt))
                    rmap["GT"] = M.remap_gt_field(
                        np.asarray(gt), lut[ci], num_merged, non_ref_exists,
                        self.gt_phase)
                ploidy_by_qidx[qidx] = ploidy
                remapped[qidx] = rmap
            too_many = self._too_many_alts(len(merged_alts))
            for name in self.remapped_fields:
                info = self.qc.field_info(name)
                if info.length.is_genotype_dependent() and too_many:
                    continue
                for ci, (qidx, call) in enumerate(valid_calls):
                    val = call.field(name)
                    if val is None:
                        continue
                    ploidy = ploidy_by_qidx.get(qidx, 0)
                    if info.length.num_dimensions > 1:
                        remapped[qidx][name] = self._remap_2d_merge(
                            val, lut[ci], num_merged, non_ref_exists, info)
                        continue
                    missing = (formats.FLOAT_MISSING if info.type == "float"
                               else formats.INT_MISSING)
                    if info.length.is_genotype_dependent():
                        out = M.remap_by_genotype(
                            np.asarray(val), lut[ci], num_merged,
                            non_ref_exists, ploidy, missing)
                    else:
                        out = M.remap_by_alleles(
                            np.asarray(val), lut[ci], num_merged,
                            non_ref_exists,
                            info.length.is_only_alt_dependent(), missing)
                    remapped[qidx][name] = out
        return (merged_ref, merged_alts, remapped, is_ref_block_only,
                non_ref_exists, remapping_needed)

    def _remap_2d_merge(self, val, lut_row, num_merged, non_ref_exists, info):
        return self._remap_2d(val, lut_row, num_merged, non_ref_exists, info)

    def _too_many_alts(self, num_alt: int) -> bool:
        """too_many_alt_alleles_for_genotype_length_fields
        (broad_combined_gvcf.h / gt_common.h:48)."""
        return num_alt > self.max_diploid_alt

    # ---------------- per-variant record production ----------------

    def field_src(self, call: CallView, name: str, remapped,
                  remapping_needed: bool, qidx: int):
        """Pick remapped vs original value (reference
        broad_combined_gvcf.cc:380-390 src_variant selection)."""
        if remapping_needed and self._uses_remap(name):
            return remapped.get(qidx, {}).get(name)
        return call.field(name)

    def _uses_remap(self, name: str) -> bool:
        # allele-dependence is a static per-field property; cache it
        # (field_src runs per (call, field) in the sequential engine)
        cache = self.__dict__.setdefault("_remap_name_cache", {})
        try:
            return cache[name]
        except KeyError:
            info = self.qc.field_info(name)
            v = cache[name] = (info is not None
                               and (info.length.is_allele_dependent()
                                    or name == "GT"))
            return v

    # the operate() itself lives in vcf_writer.CombineToVCF to keep
    # text rendering concerns separate.
