"""Cell/call views over the columnar store.

A `CallView` is the query-time face of one cell: typed field access by query
attribute name, deletion/reference-block classification.  Equivalent of the
reference's VariantCall + gt_fill_row (query_variants.cc:1014-1113).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core import formats
from ..core.config import QueryConfig
from ..store.columnar import ColumnarStore

NON_REF = "&"


def is_symbolic_allele(allele: str) -> bool:
    """Reference: known_field_info.h:221-232 (stored-form alleles)."""
    return (allele.startswith(NON_REF)
            or allele == "*"
            or (len(allele) > 0 and allele[0] == "<" and allele[-1] == ">")
            or "[" in allele or "]" in allele)


def is_deletion(ref: str, alt: str) -> bool:
    """Reference: known_field_info.h:213-220."""
    return len(ref) > 1 and (
        alt == "*" or (not is_symbolic_allele(alt) and len(alt) < len(ref)))


def contains_deletion(ref: str, alts: List[str]) -> bool:
    """Reference: known_field_info.cc:310-319."""
    if len(ref) <= 1:
        return False
    return any(not is_symbolic_allele(a) and len(a) < len(ref) for a in alts)


def is_reference_block(ref: str, alts: List[str]) -> bool:
    return len(ref) == 1 and len(alts) == 1 and alts[0].startswith(NON_REF)


def _is_all_missing(arr: np.ndarray) -> bool:
    if arr.dtype == np.int32:
        # fast path: almost every valid vector has a non-missing head
        if arr.size and arr[0] != formats.INT_MISSING:
            return False
        return bool(np.all(arr == formats.INT_MISSING))
    if arr.dtype == np.float32:
        bits = arr.view(np.uint32)
        if bits.size and bits[0] != formats.FLOAT_MISSING_BITS:
            return False
        return bool(np.all(bits == formats.FLOAT_MISSING_BITS))
    return len(arr) == 0


class CallView:
    """One cell of the store seen through a query config."""

    def __init__(self, store: ColumnarStore, cell_idx: int, qc: QueryConfig):
        self.store = store
        self.idx = int(cell_idx)
        self.qc = qc
        self.row = int(store.row[self.idx])
        self.col = int(store.col[self.idx])
        self.end = int(store.end[self.idx])
        self._field_cache = {}
        self._overrides = {}

    # interval used by operators (may be overridden by scan logic)
    @property
    def column_interval(self):
        return (self.col, self.end)

    def field(self, name: str):
        """Query-field value; None if invalid.  Applies the reference's
        validity rules (all-missing vectors and 0-length variable fields
        are invalid, variant_field_data.h:360-384)."""
        if name in self._overrides:
            return self._overrides[name]
        if name in self._field_cache:
            return self._field_cache[name]
        val = self._compute_field(name)
        self._field_cache[name] = val
        return val

    def set_field(self, name: str, value):
        self._overrides[name] = value

    def _compute_field(self, name: str):
        if name == "END":
            return self.end
        fd = self.store.fields.get(name)
        if fd is None or not fd.valid[self.idx]:
            return None
        v = fd.cell_value(self.idx)
        if v is None:
            return None
        if fd.kind in ("ragged",):
            if len(v) == 0 or _is_all_missing(v):
                return None
        elif fd.kind == "fixed":
            if _is_all_missing(v):
                return None
        elif fd.kind == "str":
            if len(v) == 0:
                return None
        elif fd.kind == "ragged2d":
            if len(v) == 0:
                return None
        return v

    # ---------------- typed helpers ----------------

    @property
    def ref(self) -> Optional[str]:
        return self.field("REF")

    @property
    def alt_list(self) -> Optional[List[str]]:
        raw = self.field("ALT")
        if raw is None:
            return None
        return raw.split("|")

    @property
    def gt(self) -> Optional[np.ndarray]:
        return self.field("GT")

    def ploidy(self) -> int:
        gt = self.gt
        if gt is None:
            return 0
        info = self.qc.field_info("GT")
        return info.length.ploidy(len(gt))

    def classify(self):
        """(contains_deletion, is_reference_block)."""
        ref = self.ref
        alts = self.alt_list
        if ref is None or alts is None:
            return False, False
        return contains_deletion(ref, alts), is_reference_block(ref, alts)
