"""Single-cell query operators: CSV dump, allele counts, column histogram,
interesting positions.

Reference: src/main/cpp/src/query_operations/variant_operations.cc:732-1089
(ColumnHistogramOperator, VariantCallPrintCSVOperator, AlleleCountOperator,
InterestingLocationsPrinter) — each driven by cell iteration
(`iterate_over_cells`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import formats
from ..core.config import QueryConfig
from ..store.columnar import ColumnarStore
from .cells import CallView
from .scan import Variant, iterate_cells


def print_csv(store: ColumnarStore, qc: QueryConfig,
              intervals: Optional[List[Tuple[int, int]]]) -> str:
    """--print-csv (GenomicsDBColumnarCell::print_csv, variant_cell.cc:167).

    row,col,END, then per queried attribute (skipping END): var-length
    numeric fields print their length first; invalid fixed fields print
    empty slots."""
    out = []
    for iv in (intervals or [None]):
        for call in iterate_cells(store, qc, iv):
            cols = [str(call.row), str(call.col), str(call.end)]
            for name in qc.attributes:
                if name == "END":
                    continue
                cols.append(_csv_field(call, name, qc))
            out.append(",".join(cols))
    return "\n".join(out) + ("\n" if out else "")


def _csv_field(call: CallView, name: str, qc: QueryConfig) -> str:
    fd = call.store.fields.get(name)
    info = qc.field_info(name)
    val = call.field(name)
    if name == "ALT":
        if val is None:
            return ""
        return val  # already '|'-joined
    if fd is None:
        return ""
    if fd.kind == "str":
        return str(val) if val is not None else ""
    is_var = fd.kind in ("ragged", "ragged2d") or (
        info is not None and not info.length.is_fixed())
    if val is None:
        if is_var:
            return "0"
        k = fd.values.shape[1] if fd.kind == "fixed" else 1
        return "," * (k - 1)
    if fd.kind == "ragged2d":
        flat = [x for sub in val for x in sub]
        return f"{len(val)}," + ",".join(_csv_num(x, fd.dtype) for x in flat)
    arr = np.atleast_1d(np.asarray(val))
    prefix = f"{len(arr)}," if is_var else ""
    return prefix + ",".join(_csv_num(x, fd.dtype) for x in arr)


def _csv_num(x, dtype: str) -> str:
    if dtype == "float32":
        return formats.format_float_calls_json(x)
    return str(int(x))


class AlleleCountOperator:
    """--print-AC: GT-based allele counts with REF/ALT normalization
    (variant_operations.cc:900-1089)."""

    def __init__(self, qc: QueryConfig):
        for f in ("GT", "REF", "ALT"):
            if not qc.is_queried(f):
                raise ValueError(f"{f} field must be queried for "
                                 "AlleleCountOperator")
        self.qc = qc
        gt_info = qc.field_info("GT")
        self.step = 2 if gt_info.length.contains_phase() else 1
        # column -> (REF, ALT) -> count
        self.counts: Dict[int, Dict[Tuple[str, str], int]] = {}

    @staticmethod
    def normalize(ref: str, alt: str) -> Tuple[str, str]:
        """Trim the longest common suffix, keeping at least one base."""
        while len(ref) > 1 and len(alt) > 1 and ref[-1] == alt[-1]:
            ref = ref[:-1]
            alt = alt[:-1]
        return ref, alt

    def operate(self, call: CallView):
        ref = call.ref
        alts = call.alt_list
        gt = call.gt
        if ref is None or alts is None or gt is None:
            return
        cmap = self.counts.setdefault(call.col, {})
        for i in range(0, len(gt), self.step):
            v = int(gt[i])
            if formats.is_bcf_valid_int(v) and v > 0:
                if v - 1 >= len(alts):
                    continue
                alt = alts[v - 1]
                if alt == "&":
                    alt = "<NON_REF>"
                key = self.normalize(ref, alt)
                cmap[key] = cmap.get(key, 0) + 1

    def render(self) -> str:
        out = []
        for col in sorted(self.counts):
            for (ref, alt), n in sorted(self.counts[col].items()):
                out.append(f"{col},{ref},{alt},{n}")
        return "\n".join(out) + ("\n" if out else "")


class ColumnHistogramOperator:
    """--produce-histogram (variant_operations.cc:732-788)."""

    def __init__(self, begin: int, end: int, bin_size: int):
        self.begin = begin
        self.end = end
        self.bin_size = bin_size
        nbins = (end - begin) // bin_size + 1
        self.bins = np.zeros(nbins, dtype=np.int64)

    def operate(self, call: CallView):
        c = call.col
        if c <= self.begin:
            b = 0
        elif c >= self.end:
            b = len(self.bins) - 1
        else:
            b = (c - self.begin) // self.bin_size
        self.bins[b] += 1

    def equi_partition_and_render(self, num_bins: int) -> str:
        """Load-balancing partitioner: merge fixed bins into num_bins
        roughly equal-count ranges."""
        if num_bins >= len(self.bins):
            return ""
        total = int(self.bins.sum())
        per_bin = total / num_bins
        out = [f"Total {total} #bins {num_bins} count/bins {per_bin:.1f}"]
        i = 0
        while i < len(self.bins):
            j = i
            curr = 0
            while curr < per_bin and j < len(self.bins):
                curr += int(self.bins[j])
                j += 1
            out.append(f"{self.begin + i * self.bin_size},"
                       f"{self.begin + j * self.bin_size - 1},{curr}")
            i = j
        return "\n".join(out) + "\n\n"


class MaxAllelesCountOperator:
    """determine_sites_with_max_alleles: track the sites with the most
    merged alleles (reference MaxAllelesCountOperator, used by the loader
    when determine_sites_with_max_alleles > 0)."""

    def __init__(self, qc: QueryConfig, top_n: int = 10):
        self.qc = qc
        self.top_n = top_n
        self.sites: List[Tuple[int, int]] = []  # (num_alleles, column)

    def operate(self, variant: Variant):
        from ..ops import merge as M
        refs = []
        alts = []
        for _, call in variant.valid_calls():
            refs.append(call.field("REF"))
            alts.append(call.alt_list)
        if not refs:
            return
        merged_ref = M.merge_reference_allele(refs)
        merged_alts, _, _ = M.merge_alt_alleles(refs, alts, merged_ref)
        import heapq
        item = (len(merged_alts) + 1, variant.start)
        if len(self.sites) < self.top_n:
            heapq.heappush(self.sites, item)
        else:
            heapq.heappushpop(self.sites, item)

    def render(self) -> str:
        out = [f"{col},{n}" for n, col in
               sorted(self.sites, reverse=True)]
        return "\n".join(out) + ("\n" if out else "")


class InterestingLocationsPrinter:
    """--produce-interesting-positions: per aligned interval, counts of
    valid calls / reference blocks / calls beginning at the position
    (variant_operations.h:396-475)."""

    def __init__(self):
        self.lines: List[str] = []

    def operate(self, variant: Variant):
        n_valid = 0
        n_ref_block = 0
        n_begin = 0
        for _, call in variant.valid_calls():
            n_valid += 1
            ref = call.ref
            alts = call.alt_list
            if (ref is not None and alts is not None and len(ref) == 1
                    and len(alts) == 1 and len(alts[0]) == 1
                    and alts[0][0] == "&"):
                n_ref_block += 1
            if call.col == variant.start:
                n_begin += 1
        self.lines.append(
            f"{variant.start} {n_valid} {n_ref_block} {n_begin}")

    def render(self) -> str:
        return "\n".join(self.lines) + ("\n" if self.lines else "")
