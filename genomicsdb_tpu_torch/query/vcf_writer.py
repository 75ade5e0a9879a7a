"""VCF record rendering for the combine path.

Produces text lines byte-identical to the reference's htslib output
(vcf_format + BroadCombinedGVCFOperator::operate,
broad_combined_gvcf.cc:765-910, variant_field_handler.cc:805-880).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core import formats
from ..core import known_fields as kf
from ..core.config import QueryConfig
from ..core.vid import VidMapper
from ..ops import merge as M
from ..vcf.fasta import ReferenceGenome
from .combine import CombineOperator
from .scan import Variant

INT_MISSING = formats.INT_MISSING
INT_VECTOR_END = formats.INT_VECTOR_END


def _valid_int(v: int) -> bool:
    return v != INT_MISSING and v != INT_VECTOR_END


def _float_bits(v) -> int:
    return int(np.asarray(v, dtype=np.float32).view(np.uint32))


def _valid_float(v) -> bool:
    b = _float_bits(v)
    return b != formats.FLOAT_MISSING_BITS and b != formats.FLOAT_VECTOR_END_BITS


def elem_sum_1d_core(values, is_float: bool):
    """compute_valid_element_wise_sum (variant_field_handler.cc:620-668)
    over per-call 1-D vectors, in call order."""
    result: List = []
    num_valid = 0
    missing = formats.FLOAT_MISSING if is_float else INT_MISSING
    for vec in values:
        for i, x in enumerate(vec):
            ok = _valid_float(x) if is_float else _valid_int(int(x))
            if not ok:
                continue
            if i < num_valid and (
                    _valid_float(result[i]) if is_float
                    else _valid_int(int(result[i]))):
                result[i] = (np.float32(result[i]) + np.float32(x)
                             if is_float else int(result[i]) + int(x))
            else:
                while len(result) <= i:
                    result.append(missing)
                result[i] = x
                if i >= num_valid:
                    for j in range(num_valid, i):
                        result[j] = missing
                    num_valid = i + 1
    if num_valid == 0:
        return None
    return result[:num_valid]


def elem_sum_2d_core(values, info):
    """compute_valid_element_wise_sum_2D_vector + stringify
    (variant_field_handler.cc:670-760).  `values`: per-call lists of 1-D
    arrays (dim-0 entries)."""
    is_float = info.type == "float"
    missing = formats.FLOAT_MISSING if is_float else INT_MISSING
    result: List[List] = []
    num_valid = 0
    for val in values:  # val: list of 1-D arrays
        for d0, vec in enumerate(val):
            while len(result) <= d0:
                result.append([])
            row = result[d0]
            for i, x in enumerate(vec):
                ok = _valid_float(x) if is_float else _valid_int(int(x))
                if not ok:
                    continue
                while len(row) <= i:
                    row.append(missing)
                if (_valid_float(row[i]) if is_float
                        else _valid_int(int(row[i]))):
                    row[i] = (np.float32(row[i]) + np.float32(x)
                              if is_float else int(row[i]) + int(x))
                else:
                    row[i] = x
                num_valid += 1
    if num_valid == 0:
        return None
    d0_sep = info.length.delimiter(0)
    d1_sep = info.length.delimiter(1)
    parts = []
    for row in result:
        parts.append(d1_sep.join(
            formats.format_float_fixed3(x) if is_float else str(int(x))
            for x in row
            if (_valid_float(x) if is_float else _valid_int(int(x)))))
    return d0_sep.join(parts)


def hist_sum_core(pairs, bin_info, cnt_info):
    """compute_valid_histogram_sum_2D_vector_and_stringify
    (broad_combined_gvcf.cc:432-521).  `pairs`: per-call (bins, counts)
    lists of 1-D arrays."""
    bin_float = bin_info.type == "float"
    cnt_float = cnt_info.type == "float"
    hist: List[dict] = []
    found = False
    for bv, cv in pairs:
        if bv is None or cv is None:
            continue
        found = True
        for d0 in range(len(bv)):
            while len(hist) <= d0:
                hist.append({})
            bins = bv[d0]
            cnts = cv[d0] if d0 < len(cv) else []
            for b, c in zip(bins, cnts):
                okb = _valid_float(b) if bin_float else _valid_int(int(b))
                okc = _valid_float(c) if cnt_float else _valid_int(int(c))
                if not (okb and okc):
                    continue
                key = float(np.float32(b)) if bin_float else int(b)
                if key in hist[d0]:
                    hist[d0][key] = (
                        np.float32(hist[d0][key]) + np.float32(c)
                        if cnt_float else hist[d0][key] + int(c))
                else:
                    hist[d0][key] = (np.float32(c) if cnt_float
                                     else int(c))
    if not found:
        return None
    d0_sep = bin_info.length.delimiter(0)
    d1_sep = bin_info.length.delimiter(1)
    parts = []
    for m in hist:
        sub = []
        for key in sorted(m.keys()):
            kstr = (formats.format_float_fixed3(key) if bin_float
                    else str(int(key)))
            cstr = (formats.format_float_fixed3(m[key]) if cnt_float
                    else str(int(m[key])))
            sub.append(kstr + d1_sep + cstr)
        parts.append(d1_sep.join(sub))
    return d0_sep.join(parts)


class CombineToVCF(CombineOperator):
    """CombineOperator + VCF text rendering."""

    def __init__(self, qc: QueryConfig, vid: VidMapper,
                 ref_genome: Optional[ReferenceGenome],
                 sample_names: List[str],
                 filter_id_order: Optional[List[str]] = None,
                 filter_name_by_field_idx: Optional[Dict[int, str]] = None):
        super().__init__(qc, vid, ref_genome, filter_id_order)
        self.sample_names = sample_names
        self.filter_name_by_field_idx = filter_name_by_field_idx or {}

    # ---------------- combine-op reductions ----------------

    def _combine_info(self, name: str, variant: Variant, remapped,
                      remapping_needed: bool, num_merged_alts: int):
        """handle_VCF_field_combine_operation
        (broad_combined_gvcf.cc:376-445).  Returns rendered value string or
        None."""
        info = self.qc.field_info(name)
        op = info.combine_op
        if (info.length.is_genotype_dependent()
                and self._too_many_alts(num_merged_alts)):
            return None
        is_float = info.type == "float"
        is_2d = info.length.num_dimensions > 1
        values = []
        for qidx, call in variant.valid_calls():
            v = self.field_src(call, name, remapped, remapping_needed, qidx)
            if v is not None:
                values.append(v if is_2d else np.atleast_1d(np.asarray(v)))
        if op == kf.OP_SUM or op == kf.OP_MEAN or op == kf.OP_MEDIAN:
            firsts = []
            for v in values:
                if len(v) == 0:
                    continue
                x = v[0]
                if (is_float and _valid_float(x)) or \
                   (not is_float and _valid_int(int(x))):
                    firsts.append(x)
            if not firsts:
                return None
            if op == kf.OP_MEDIAN:
                arr = sorted(float(x) if is_float else int(x)
                             for x in firsts)
                res = arr[len(arr) // 2]
            elif op == kf.OP_SUM:
                res = firsts[0]
                for x in firsts[1:]:
                    res = (np.float32(res) + np.float32(x)) if is_float \
                        else int(res) + int(x)
            else:  # mean
                s = firsts[0]
                for x in firsts[1:]:
                    s = (np.float32(s) + np.float32(x)) if is_float \
                        else int(s) + int(x)
                res = (np.float32(s) / np.float32(len(firsts))) if is_float \
                    else int(s) // len(firsts)
            return ("f" if is_float else "i", res)
        if op == kf.OP_ELEMENT_WISE_SUM:
            if info.length.num_dimensions > 1:
                v = self._elem_sum_2d(values, info)
                return ("s", v) if v is not None else None
            v = self._elem_sum_1d(values, is_float)
            return ("fl" if is_float else "il", v) if v is not None else None
        if op == kf.OP_CONCATENATE:
            if not values:
                return None
            cat = np.concatenate(values)
            if len(cat) == 0:
                return None
            return ("fl" if is_float else "il", list(cat))
        return None

    def _elem_sum_1d(self, values, is_float: bool) -> Optional[str]:
        return elem_sum_1d_core(values, is_float)

    def _elem_sum_2d(self, values, info) -> Optional[str]:
        return elem_sum_2d_core(values, info)

    def _histogram_sum(self, bin_name: str, cnt_name: str, variant: Variant,
                       remapped, remapping_needed: bool) -> Optional[str]:
        """compute_valid_histogram_sum_2D_vector_and_stringify
        (broad_combined_gvcf.cc:432-521)."""
        bin_info = self.qc.field_info(bin_name)
        cnt_info = self.qc.field_info(cnt_name)
        pairs = []
        for qidx, call in variant.valid_calls():
            bv = self.field_src(call, bin_name, remapped, remapping_needed,
                                qidx)
            cv = self.field_src(call, cnt_name, remapped, remapping_needed,
                                qidx)
            if bv is None or cv is None:
                continue
            pairs.append((bv, cv))
        return hist_sum_core(pairs, bin_info, cnt_info)

    def _render_element(self, x, is_float: bool) -> str:
        if is_float:
            if not _valid_float(x):
                return "."
            return formats.format_float_vcf(x)
        if not _valid_int(int(x)):
            return "."
        return str(int(x))

    def _render_qual(self, res) -> str:
        return formats.format_float_vcf(res)

    def _render_info_scalar(self, x, is_float: bool) -> str:
        if is_float:
            return formats.format_float_vcf(x)
        return str(int(x))

    def _render_info_typed(self, kind: str, value) -> str:
        if kind == "i":
            return str(int(value))
        if kind == "f":
            return formats.format_float_vcf(value)
        if kind == "s":
            return str(value)
        is_float = kind == "fl"
        return ",".join(self._render_element(x, is_float) for x in value)

    # ---------------- FORMAT machinery ----------------

    def _collect_and_extend(self, variant: Variant, name: str, remapped,
                            remapping_needed: bool, is_gt: bool,
                            num_merged_alts: int = -1
                            ) -> Optional[List[np.ndarray]]:
        """collect_and_extend_fields (variant_field_handler.cc:805-880).

        Returns per-sample arrays, all padded to the max length, or None if
        no call has a valid value.  use_missing_values_only_not_vector_end
        is False (C++ CLI path).

        Genotype-length fields are first shaped per call to the genotype
        count of (merged alleles, call ploidy): the reference remaps
        allele-length-dependent fields for EVERY call
        (GA4GHOperator::operate, variant_operations.cc:572-728), so an
        under-length input (e.g. a diploid-shaped PL under a triploid GT)
        still emits #genotypes entries, the unmapped tail as missing.
        When remapping ran, the remap kernels already produce the target
        length and this is a no-op; it matters on the non-remapped
        (ref-block-only) path."""
        info = self.qc.field_info(name)
        is_char = info is not None and info.type in ("char", "string")
        gt_shape = (not is_gt and num_merged_alts >= 0 and info is not None
                    and info.length.is_genotype_dependent()
                    and self.gt_queried)
        gt_info = self.qc.field_info("GT") if gt_shape else None
        values: List[Optional[np.ndarray]] = []
        max_len = 0
        num_valid = 0
        for qidx in range(len(variant.calls)):
            call = variant.calls[qidx]
            v = None
            if variant.valid[qidx] and call is not None:
                v = self.field_src(call, name, remapped, remapping_needed,
                                   qidx)
            if v is not None:
                if is_char:
                    arr = np.frombuffer(str(v).encode(), dtype=np.uint8)
                elif type(v) is np.ndarray and v.ndim == 1:
                    arr = v            # common case: ragged column slice
                else:
                    arr = np.atleast_1d(np.asarray(v))
                if gt_shape and gt_info is not None:
                    gt = call.gt
                    ploidy = gt_info.length.ploidy(len(gt)) \
                        if gt is not None else 0
                    if ploidy > 0:
                        want = len(M.genotype_combinations(
                            num_merged_alts + 1, ploidy))
                        if len(arr) < want:
                            fill = (formats.FLOAT_MISSING
                                    if info.type == "float"
                                    else INT_MISSING)
                            ext = np.full(want, fill,
                                          dtype=arr.dtype
                                          if arr.dtype in (np.int32,
                                                           np.float32)
                                          else np.int32)
                            ext[:len(arr)] = arr
                            arr = ext
                values.append(arr)
                if len(arr) > max_len:
                    max_len = len(arr)
                num_valid += 1
            else:
                values.append(None)
        if num_valid == 0:
            return None
        is_float = info is not None and info.type == "float"
        out = []
        for v in values:
            if is_char:
                if v is None:
                    # missing char first, vector-end padding
                    s = [formats.CHAR_MISSING.encode()[0]]
                else:
                    s = list(v)
                pad = max_len - len(s)
                arr = np.array(s + [0] * pad, dtype=np.uint8)
                out.append(arr)
                continue
            dtype = np.float32 if is_float else np.int32
            if v is None:
                first = INT_VECTOR_END if is_gt else INT_MISSING
                if dtype == np.float32:
                    first = np.array([formats.FLOAT_VECTOR_END if is_gt
                                      else formats.FLOAT_MISSING],
                                     dtype=np.float32)[0]
                vals = [first]
            elif (type(v) is np.ndarray and v.dtype == dtype
                  and len(v) == max_len):
                out.append(v)          # already full width, right dtype
                continue
            else:
                vals = list(v)
            pad_v = INT_VECTOR_END if dtype == np.int32 \
                else formats.FLOAT_VECTOR_END
            vals = vals + [pad_v] * (max_len - len(vals))
            out.append(np.asarray(vals, dtype=dtype))
        return out

    def _encode_gt(self, per_sample: List[np.ndarray], max_ploidy_elems: int
                   ) -> List[str]:
        """encode_GT_vector 4-way (broad_combined_gvcf.cc:90-140) +
        htslib GT rendering."""
        out = []
        phase_in = self.gt_phase
        produce = self.produce_GT
        for vec in per_sample:
            vals = []  # (allele_txt, phased) encoded htslib-style ints
            n = len(vec)
            elems = []
            if phase_in:
                if n > 0:
                    elems.append((int(vec[0]), False))
                k = 2
                while k < n:
                    elems.append((int(vec[k]), int(vec[k - 1]) > 0))
                    k += 2
            else:
                for k in range(n):
                    elems.append((int(vec[k]), False))
            txt = []
            for i, (v, phased) in enumerate(elems):
                if v == INT_VECTOR_END:
                    break
                if not _valid_int(v):
                    # missing stays missing ('.'); preserve phase
                    allele = "."
                    enc_phased = phased if (phase_in and produce) else \
                        (phased if phase_in and not produce else False)
                elif produce:
                    allele = str(v) if v >= 0 else "."
                    enc_phased = phased if phase_in else False
                else:
                    allele = "."
                    enc_phased = phased if phase_in else False
                sep = ("|" if enc_phased else "/") if i > 0 else ""
                txt.append(sep + allele)
            out.append("".join(txt) if txt else ".")
        return out

    def _render_format_values(self, name: str,
                              per_sample: List[np.ndarray]) -> List[str]:
        info = self.qc.field_info(name)
        is_char = info is not None and info.type in ("char", "string")
        is_float = info is not None and info.type == "float"
        out = []
        for vec in per_sample:
            if is_char:
                # chars until NUL/vector-end
                bs = bytes(int(b) for b in vec if int(b) != 0)
                out.append(bs.decode() if bs else ".")
                continue
            parts = []
            for x in vec:
                if is_float:
                    if _float_bits(x) == formats.FLOAT_VECTOR_END_BITS:
                        break
                    parts.append("." if not _valid_float(x)
                                 else formats.format_float_vcf(x))
                else:
                    if int(x) == INT_VECTOR_END:
                        break
                    parts.append("." if not _valid_int(int(x))
                                 else str(int(x)))
            out.append(",".join(parts) if parts else ".")
        return out

    # ---------------- the operator ----------------

    def operate(self, variant: Variant):
        qc = self.qc
        self.handle_deletions(variant)
        (merged_ref, merged_alts, remapped, is_ref_block_only,
         non_ref_exists, remapping_needed) = self.ga4gh_merge(variant)
        loc = self.vid.get_contig_location(variant.start)
        if loc is None:
            raise ValueError(f"Unknown contig for position {variant.start}")
        contig, cpos = loc
        pos0 = cpos  # 0-based within contig
        # ID
        id_txt = "."
        if qc.is_queried("ID"):
            ids = set()
            for qidx, call in variant.valid_calls():
                v = call.field("ID")
                if v:
                    for tok in str(v).split(";"):
                        if tok:
                            ids.add(tok)
            if ids:
                id_txt = ";".join(sorted(ids))  # DEBUG-sorted (goldens)
        # QUAL
        qual_txt = "."
        if self.qual_queried and self.qual_op is not kf.OP_NONE:
            firsts = []
            for qidx, call in variant.valid_calls():
                v = call.field("QUAL")
                if v is not None and _valid_float(v[0]):
                    firsts.append(np.float32(v[0]))
            if firsts:
                if self.qual_op == kf.OP_MEDIAN:
                    arr = sorted(float(x) for x in firsts)
                    res = arr[len(arr) // 2]
                elif self.qual_op == kf.OP_SUM:
                    res = firsts[0]
                    for x in firsts[1:]:
                        res = np.float32(res) + np.float32(x)
                elif self.qual_op == kf.OP_MEAN:
                    s = firsts[0]
                    for x in firsts[1:]:
                        s = np.float32(s) + np.float32(x)
                    res = np.float32(s) / np.float32(len(firsts))
                else:
                    res = None
                if res is not None:
                    qual_txt = self._render_qual(res)
        # REF: replace 'N' with reference base
        ref_out = merged_ref
        if len(ref_out) == 1 and ref_out == "N" and self.ref_genome:
            base = self.ref_genome.base_at(contig, pos0)
            ref_out = base if base in LEGAL_BASES_SET else "N"
        alt_out = ",".join("<NON_REF>" if a == M.NON_REF else a
                           for a in merged_alts)
        if not merged_alts:
            alt_out = "."
        # FILTER
        filter_txt = "."
        if qc.params.produce_FILTER_field and qc.is_queried("FILTER"):
            idx_set = set()
            for qidx, call in variant.valid_calls():
                v = call.field("FILTER")
                if v is not None and len(v) > 0:
                    for x in v:
                        idx_set.add(int(x))
            if idx_set:
                names = []
                for gidx in sorted(idx_set):
                    nm = self.filter_name_by_field_idx.get(gidx)
                    if nm is not None:
                        names.append(nm)
                if names:
                    filter_txt = ";".join(names)
        # INFO
        info_parts: List[str] = []
        if variant.end > variant.start:
            info_parts.append(f"END={cpos + 1 + (variant.end - variant.start)}")
        num_merged_alts = len(merged_alts)
        for name in self.info_fields:
            info = qc.field_info(name)
            typed = self._combine_info(name, variant, remapped,
                                       remapping_needed, num_merged_alts)
            if typed is not None:
                rendered = self._render_info_typed(*typed)
                info_parts.append(f"{info.vcf_name}={rendered}")
        for parent, bin_f, cnt_f in self.histogram_fields:
            rendered = self._histogram_sum(bin_f, cnt_f, variant, remapped,
                                           remapping_needed)
            if rendered is not None:
                pinfo = self.vid.get_field_info(parent)
                info_parts.append(f"{pinfo.vcf_name}={rendered}")
        # FORMAT
        fmt_names: List[str] = []
        fmt_values: List[List[str]] = []
        ncalls = len(variant.calls)
        dp_format_vec: Optional[List[int]] = None
        min_dp_vec: Optional[List[int]] = None
        dp_info_vec: Optional[List[int]] = None
        for name in self.format_fields:
            info = qc.field_info(name)
            if (info.length.is_genotype_dependent()
                    and self._too_many_alts(num_merged_alts)):
                continue
            is_gt = name == "GT"
            per_sample = self._collect_and_extend(
                variant, name, remapped, remapping_needed, is_gt,
                num_merged_alts)
            if per_sample is None:
                continue
            if is_gt:
                vals = self._encode_gt(per_sample, 0)
                # htslib places GT first in FORMAT regardless of add order
                fmt_names.insert(0, "GT")
                fmt_values.insert(0, vals)
                continue
            if name == "MIN_DP":
                min_dp_vec = [int(v[0]) for v in per_sample]
                fmt_names.append(info.vcf_name)
                fmt_values.append(self._render_format_values(name,
                                                             per_sample))
                continue
            if name == "DP_FORMAT":
                dp_format_vec = [int(v[0]) for v in per_sample]
                continue  # rendered as DP at the end
            if name == "DP" and self.dp_info_queried:
                dp_info_vec = [int(v[0]) for v in per_sample]
                continue
            fmt_names.append(info.vcf_name)
            fmt_values.append(self._render_format_values(name, per_sample))
        # DP handling (broad_combined_gvcf.cc:690-726)
        if dp_info_vec is not None or dp_format_vec is not None:
            sum_info_dp = 0
            found_valid_dp_format = False
            dp_out = []
            for j in range(ncalls):
                dp_info_val = (dp_info_vec[j] if dp_info_vec is not None
                               else INT_MISSING)
                dp_fmt_val = (dp_format_vec[j] if dp_format_vec is not None
                              else INT_MISSING)
                if not _valid_int(dp_info_val):
                    if (min_dp_vec is not None
                            and _valid_int(min_dp_vec[j])):
                        dp_info_val = min_dp_vec[j]
                    else:
                        dp_info_val = dp_fmt_val
                dp_out.append(dp_fmt_val)
                if _valid_int(dp_fmt_val):
                    found_valid_dp_format = True
                if _valid_int(dp_info_val):
                    sum_info_dp += dp_info_val
            if found_valid_dp_format and not self.sites_only:
                fmt_names.append("DP")
                fmt_values.append(["." if not _valid_int(x) else str(x)
                                   for x in dp_out])
            if sum_info_dp > 0 and not is_ref_block_only:
                info_parts.append(f"DP={sum_info_dp}")
        # assemble line (style hook)
        self.lines.append(self._assemble_line(
            contig, cpos, id_txt, ref_out, alt_out, qual_txt, filter_txt,
            info_parts, fmt_names, fmt_values, ncalls))

    def _assemble_line(self, contig, cpos, id_txt, ref_out, alt_out,
                       qual_txt, filter_txt, info_parts, fmt_names,
                       fmt_values, ncalls) -> str:
        info_txt = ";".join(info_parts) if info_parts else "."
        cols = [contig, str(cpos + 1), id_txt, ref_out, alt_out, qual_txt,
                filter_txt, info_txt]
        if not self.sites_only and self.sample_names:
            if fmt_names:
                cols.append(":".join(fmt_names))
                for s in range(ncalls):
                    cols.append(":".join(fmt_values[f][s]
                                         for f in range(len(fmt_names))))
            else:
                cols.append(".")
                cols.extend("." for _ in range(ncalls))
        return "\t".join(cols)


LEGAL_BASES_SET = {"A", "T", "G", "C"}
