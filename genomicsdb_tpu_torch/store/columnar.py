"""Columnar variant store.

One `ColumnarStore` holds all cells of one column partition as a
Structure-of-Arrays, sorted column-major by (col, row) — the TPU-native
replacement for the reference's TileDB sparse array + END-duplicated cells
(reference src/main/cpp/src/genomicsdb/variant_storage_manager.cc,
load_operators.cc:161-298).

Columns:
  row[n], col[n], end[n]        original cell coordinates / END attribute
  eff_end[n]                    END truncated at the next same-row cell begin
                                (materializes LoaderArrayWriter's overlap
                                truncation, load_operators.cc:209-270)
  fields: name -> FieldData     one per schema attribute

Ragged data is (values, offsets) pairs; 2-D ragged adds an outer offsets
level.  Validity is explicit (`valid` bool per cell) — matches the
reference's "is field valid" notion after NULL filtering.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Dict, List

import numpy as np

from ..core import formats


@dataclass
class FieldData:
    """Per-attribute columnar data for n cells."""
    name: str
    kind: str               # 'fixed' | 'ragged' | 'ragged2d' | 'str'
    dtype: str              # 'int32' | 'float32' | 'bytes'
    valid: np.ndarray = None            # bool [n]
    values: np.ndarray = None           # fixed: [n, k]; ragged: [total]
    offsets: np.ndarray = None          # ragged: int64 [n+1]
    outer_offsets: np.ndarray = None    # ragged2d: int64 [n+1] into offsets

    def lens(self) -> np.ndarray:
        """Per-cell value counts (np.diff(offsets)), cached — the diff
        is store-wide, so repeated interval queries must not redo it."""
        c = getattr(self, "_lens_cache", None)
        if c is None:
            c = self._lens_cache = np.diff(self.offsets)
        return c

    def outer_lens(self) -> np.ndarray:
        c = getattr(self, "_outer_lens_cache", None)
        if c is None:
            c = self._outer_lens_cache = np.diff(self.outer_offsets)
        return c

    def max_len(self) -> int:
        c = getattr(self, "_max_len_cache", None)
        if c is None:
            lens = self.lens()
            c = self._max_len_cache = int(lens.max()) if len(lens) else 0
        return c

    def cell_value(self, i: int):
        """Python value for cell i (None when invalid)."""
        if not self.valid[i]:
            return None
        if self.kind == "fixed":
            return self.values[i]
        if self.kind == "str":
            lo, hi = self.offsets[i], self.offsets[i + 1]
            return self.values[lo:hi].tobytes().decode()
        if self.kind == "ragged":
            lo, hi = self.offsets[i], self.offsets[i + 1]
            return self.values[lo:hi]
        if self.kind == "ragged2d":
            olo, ohi = self.outer_offsets[i], self.outer_offsets[i + 1]
            out = []
            for j in range(olo, ohi):
                lo, hi = self.offsets[j], self.offsets[j + 1]
                out.append(self.values[lo:hi])
            return out
        raise ValueError(self.kind)


@dataclass
class ColumnarStore:
    """All cells of one column partition, sorted by (col, row)."""
    num_rows: int                      # total rows in array (row domain size)
    lb_row: int = 0                    # smallest row idx
    row: np.ndarray = None             # int64 [n]
    col: np.ndarray = None             # int64 [n]
    end: np.ndarray = None             # int64 [n]
    eff_end: np.ndarray = None         # int64 [n]
    fields: Dict[str, FieldData] = dc_field(default_factory=dict)
    attribute_order: List[str] = dc_field(default_factory=list)

    @property
    def num_cells(self) -> int:
        return 0 if self.row is None else len(self.row)

    # ---------------- query primitives ----------------

    def cells_in_column_range(self, begin: int, end: int) -> np.ndarray:
        """Indices of cells with begin <= col <= end, in (col, row) order."""
        lo = np.searchsorted(self.col, begin, side="left")
        hi = np.searchsorted(self.col, end, side="right")
        return np.arange(lo, hi)

    def row_layout(self):
        """Cached row-major cell layout: (row_sorted, sorted_rows,
        col_by_row, eff_by_row).  Within one row col ascends and
        eff_end is non-decreasing (compute_eff_end truncates at the
        next same-row begin), so interval membership per row is a
        contiguous run findable by binary search.  Shared by
        store_to_block and the sequential scan's left sweep."""
        c = getattr(self, "_row_sort_cache", None)
        if c is None or len(c) != 4:
            n = self.num_cells
            row_sorted = np.argsort(self.row, kind="stable") if n \
                else np.zeros(0, dtype=np.int64)
            sorted_rows = self.row[row_sorted] if n else row_sorted
            col_by_row = self.col[row_sorted] if n else row_sorted
            eff_by_row = self.eff_end[row_sorted] if n else row_sorted
            c = self._row_sort_cache = (row_sorted, sorted_rows,
                                        col_by_row, eff_by_row)
        return c

    def cells_intersecting(self, column: int) -> np.ndarray:
        """Indices of cells live at `column` (col <= column <= eff_end),
        in (col, row) order.  Binary search per row via row_layout —
        O(rows log cells), not a store-wide mask."""
        if self.num_cells == 0:
            return np.arange(0)
        row_sorted, sorted_rows, col_by_row, eff_by_row = \
            self.row_layout()
        # per-row segment bounds: distinct rows + boundaries (cached)
        uniq = getattr(self, "_row_bounds_cache", None)
        if uniq is None:
            rows_u = np.unique(sorted_rows)
            starts = np.searchsorted(sorted_rows, rows_u, side="left")
            stops = np.searchsorted(sorted_rows, rows_u, side="right")
            uniq = self._row_bounds_cache = (rows_u, starts, stops)
        _, starts, stops = uniq
        hits = []
        for p, q in zip(starts, stops):
            a = p + np.searchsorted(eff_by_row[p:q], column,
                                    side="left")
            b = p + np.searchsorted(col_by_row[p:q], column,
                                    side="right")
            if b > a:
                hits.append(row_sorted[a:b])
        if not hits:
            return np.arange(0)
        out = np.concatenate(hits)
        return out[np.lexsort((self.row[out], self.col[out]))]


def compute_eff_end(row: np.ndarray, col: np.ndarray, end: np.ndarray
                    ) -> np.ndarray:
    """Effective ENDs: truncate each cell at the next same-row cell begin
    (vectorized; input must be (col,row)-sorted)."""
    eff = end.copy()
    if len(row) == 0:
        return eff
    order = np.lexsort((col, row))  # row-major, col within row
    r_sorted = row[order]
    c_sorted = col[order]
    same_row = r_sorted[:-1] == r_sorted[1:]
    prev_idx = order[:-1][same_row]
    next_col = c_sorted[1:][same_row]
    trunc = eff[prev_idx] >= next_col
    eff[prev_idx[trunc]] = next_col[trunc] - 1
    return eff


def store_take(store: ColumnarStore, idx: np.ndarray) -> ColumnarStore:
    """Subset a store to the given cell indices (in the given order)."""
    out = ColumnarStore(num_rows=store.num_rows, lb_row=store.lb_row)
    out.attribute_order = list(store.attribute_order)
    out.row = store.row[idx]
    out.col = store.col[idx]
    out.end = store.end[idx]
    out.eff_end = compute_eff_end(out.row, out.col, out.end)
    for name, fd in store.fields.items():
        valid = fd.valid[idx]
        if fd.kind == "fixed":
            out.fields[name] = FieldData(name, fd.kind, fd.dtype, valid,
                                         fd.values[idx])
            continue
        if fd.kind == "ragged2d":
            # rebuild two-level ragged by python gather (rare fields)
            outer = np.zeros(len(idx) + 1, dtype=np.int64)
            inner: List[int] = [0]
            chunks = []
            for oi, src in enumerate(idx):
                olo, ohi = fd.outer_offsets[src], fd.outer_offsets[src + 1]
                for j in range(olo, ohi):
                    lo, hi = fd.offsets[j], fd.offsets[j + 1]
                    chunks.append(fd.values[lo:hi])
                    inner.append(inner[-1] + (hi - lo))
                outer[oi + 1] = outer[oi] + (ohi - olo)
            values = (np.concatenate(chunks) if chunks
                      else np.zeros(0, dtype=fd.values.dtype))
            out.fields[name] = FieldData(
                name, fd.kind, fd.dtype, valid, values,
                np.asarray(inner, dtype=np.int64), outer)
            continue
        lens = fd.lens()[idx]
        offsets = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        total = int(offsets[-1])
        values = np.empty(total, dtype=fd.values.dtype)
        if total:
            copy_ragged_segments(fd.values, fd.offsets[:-1][idx], lens,
                                 offsets[:-1], values)
        out.fields[name] = FieldData(name, fd.kind, fd.dtype, valid,
                                     values, offsets)
    return out


def copy_ragged_segments(src: np.ndarray, src0, lens, dest0,
                         out: np.ndarray) -> np.ndarray:
    """out[dest0[i]:dest0[i]+lens[i]] = src[src0[i]:src0[i]+lens[i]] per
    segment — native memcpy kernel when available, vectorized numpy
    otherwise."""
    import os
    if os.environ.get("GENOMICSDB_TPU_NO_NATIVE", "") in ("", "0"):
        from ..runtime import native_loader as nl
        if nl.copy_segments(src, src0, lens, dest0, out) is not None:
            return out
    lens = np.asarray(lens, dtype=np.int64)
    nz = lens > 0
    src0 = np.asarray(src0, dtype=np.int64)[nz]
    dest0 = np.asarray(dest0, dtype=np.int64)[nz]
    lens = lens[nz]
    reps = np.repeat(dest0 - src0, lens)
    src_idx = _ragged_arange(src0, lens)
    out[src_idx + reps] = src[src_idx]
    return out


def _ragged_arange(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenation of arange(start, start+len) per segment, O(total):
    diff-encode the sequence and integrate with one cumsum."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    nz = lens > 0
    starts = np.asarray(starts, dtype=np.int64)[nz]
    lens = np.asarray(lens, dtype=np.int64)[nz]
    incr = np.ones(total, dtype=np.int64)
    incr[0] = starts[0]
    if len(starts) > 1:
        pos = np.cumsum(lens)[:-1]
        incr[pos] = starts[1:] - starts[:-1] - lens[:-1] + 1
    return np.cumsum(incr)


def build_store(cells: List[dict], attribute_order: List[str],
                field_specs: Dict[str, tuple], num_rows: int,
                lb_row: int = 0) -> ColumnarStore:
    """Pack a list of per-cell dicts into a ColumnarStore.

    `cells` must already be in final storage order.  Each cell dict has
    'row', 'col', 'end', and per-attribute entries (missing key == invalid).
    `field_specs[name] = (kind, dtype, fixed_len)`.
    """
    n = len(cells)
    store = ColumnarStore(num_rows=num_rows, lb_row=lb_row)
    store.attribute_order = list(attribute_order)
    store.row = np.array([c["row"] for c in cells], dtype=np.int64)
    store.col = np.array([c["col"] for c in cells], dtype=np.int64)
    store.end = np.array([c["end"] for c in cells], dtype=np.int64)
    # effective END: truncated at next same-row begin
    store.eff_end = compute_eff_end(store.row, store.col, store.end)
    for name in attribute_order:
        kind, dtype, fixed_len = field_specs[name]
        valid = np.zeros(n, dtype=bool)
        if kind == "fixed":
            np_dtype = np.int32 if dtype == "int32" else np.float32
            fill = (formats.INT_MISSING if dtype == "int32"
                    else formats.FLOAT_MISSING)
            vals = np.full((n, fixed_len), fill, dtype=np_dtype)
            for i, c in enumerate(cells):
                v = c.get(name)
                if v is not None:
                    valid[i] = True
                    vals[i, :len(v)] = v
            fd = FieldData(name=name, kind=kind, dtype=dtype, valid=valid,
                           values=vals)
        elif kind in ("ragged", "str"):
            if kind == "str":
                np_dtype = np.uint8
            else:
                np_dtype = np.int32 if dtype == "int32" else np.float32
            offsets = np.zeros(n + 1, dtype=np.int64)
            chunks = []
            for i, c in enumerate(cells):
                v = c.get(name)
                if v is not None:
                    valid[i] = True
                    if kind == "str":
                        arr = np.frombuffer(v.encode(), dtype=np.uint8)
                    else:
                        arr = np.asarray(v, dtype=np_dtype)
                    chunks.append(arr)
                    offsets[i + 1] = offsets[i] + len(arr)
                else:
                    offsets[i + 1] = offsets[i]
            values = (np.concatenate(chunks) if chunks
                      else np.zeros(0, dtype=np_dtype))
            fd = FieldData(name=name, kind=kind, dtype=dtype, valid=valid,
                           values=values, offsets=offsets)
        elif kind == "ragged2d":
            np_dtype = np.int32 if dtype == "int32" else np.float32
            outer = np.zeros(n + 1, dtype=np.int64)
            inner: List[int] = [0]
            chunks = []
            for i, c in enumerate(cells):
                v = c.get(name)  # list of 1-D arrays
                if v is not None:
                    valid[i] = True
                    for sub in v:
                        arr = np.asarray(sub, dtype=np_dtype)
                        chunks.append(arr)
                        inner.append(inner[-1] + len(arr))
                    outer[i + 1] = outer[i] + len(v)
                else:
                    outer[i + 1] = outer[i]
            values = (np.concatenate(chunks) if chunks
                      else np.zeros(0, dtype=np_dtype))
            fd = FieldData(name=name, kind=kind, dtype=dtype, valid=valid,
                           values=values,
                           offsets=np.asarray(inner, dtype=np.int64),
                           outer_offsets=outer)
        else:
            raise ValueError(kind)
        store.fields[name] = fd
    return store
