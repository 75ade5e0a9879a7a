"""Chunked, memory-mappable fragment format (v2) + out-of-core reads.

The reference serves arrays far larger than RAM by reading TileDB
attribute segments at `segment_size` granularity
(variant_storage_manager.cc:478-513, default 10 MB
gt_mpi_gather.cc:467).  The v1 .npz fragment cannot do that: it is
decompressed whole into host RAM.  A v2 fragment is a DIRECTORY of raw
little-endian column files plus a JSON manifest:

    fragment_<ts>.gdbv2/
      manifest.json          dtypes/lengths per column, max_span, bytes
      __row__.bin __col__.bin __end__.bin __eff_end__.bin
      <FIELD>.valid.bin  <FIELD>.values.bin
      <FIELD>.offsets.bin  [<FIELD>.outer.bin]

Raw columns memory-map directly (np.memmap), so opening an array costs
no RAM and the OS pages in exactly the byte ranges a query touches.
`FragmentV2Writer.append` streams cell chunks to disk with bounded
memory; effective ENDs are finalized across chunk boundaries by
patching each row's previous trailing cell in place (the same
truncate-at-next-same-row-begin rule as columnar.compute_eff_end).

Out-of-core queries slice COLUMN WINDOWS: because cells are
(col,row)-sorted and no cell spans more than `max_span` positions
(tracked in the manifest), every cell intersecting [lo, hi] lives in
the contiguous index range
[searchsorted(col, lo - max_span), searchsorted(col, hi, 'right')).
`OocArray.windows` yields materialized ColumnarStore windows sized to
`segment_size`, each carrying the GLOBAL eff_end values, so the block
and sequential engines run on them unchanged and chunk concatenation is
byte-identical to a whole-array query.  `column_window` cuts the same
window out of an open store as views of its columns.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .columnar import ColumnarStore, FieldData, compute_eff_end

V2_SUFFIX = ".gdbv2"
MANIFEST = "manifest.json"

_COORDS = ("__row__", "__col__", "__end__", "__eff_end__")


def _np_dtype(fd_kind: str, fd_dtype: str):
    if fd_kind == "str":
        return np.uint8
    return np.int32 if fd_dtype == "int32" else np.float32


class FragmentV2Writer:
    """Streaming writer: append (col,row)-sorted cell chunks in global
    order; eff_end is finalized across chunks by in-place patches."""

    def __init__(self, frag_dir: str, attribute_order: List[str],
                 field_meta: Dict[str, dict], num_rows: int,
                 lb_row: int = 0):
        os.makedirs(frag_dir, exist_ok=True)
        self.dir = frag_dir
        self.attribute_order = list(attribute_order)
        self.field_meta = {k: dict(v) for k, v in field_meta.items()}
        self.num_rows = num_rows
        self.lb_row = lb_row
        self.n_cells = 0
        self.max_span = 0
        self._files: Dict[str, object] = {}
        for name in _COORDS:
            self._files[name] = open(os.path.join(frag_dir,
                                                  name + ".bin"), "wb+")
        self._value_totals: Dict[str, int] = {}
        self._offset_tails: Dict[str, int] = {}
        for name in self.attribute_order:
            fm = self.field_meta[name]
            for part in self._field_parts(fm):
                key = f"{name}.{part}"
                self._files[key] = open(
                    os.path.join(frag_dir, key + ".bin"), "wb+")
        # per-row trailing-cell state for cross-chunk eff_end patching:
        # row -> (byte offset of its eff_end slot, END value)
        self._pending: Dict[int, Tuple[int, int]] = {}
        self._closed = False

    @staticmethod
    def _field_parts(fm: dict) -> List[str]:
        kind = fm["kind"]
        if kind == "fixed":
            return ["valid", "values"]
        if kind == "ragged2d":
            return ["valid", "values", "offsets", "outer"]
        return ["valid", "values", "offsets"]   # ragged | str

    def append(self, store: ColumnarStore):
        """Append one chunk.  Chunks must arrive in global (col,row)
        order: every col in this chunk >= every col already written."""
        n = store.num_cells
        if n == 0:
            return
        row = np.ascontiguousarray(store.row, dtype=np.int64)
        col = np.ascontiguousarray(store.col, dtype=np.int64)
        end = np.ascontiguousarray(store.end, dtype=np.int64)
        # within-chunk effective ENDs; cross-chunk truncation below
        eff = compute_eff_end(row, col, end)
        # patch each row's previous trailing cell against its first
        # cell in this chunk (load_operators.cc:209-270 truncation)
        if self._pending:
            order = np.lexsort((col, row))
            r_sorted = row[order]
            firsts = np.searchsorted(r_sorted, np.unique(r_sorted),
                                     side="left")
            f_eff = self._files["__eff_end__"]
            here = f_eff.tell()
            for fi in firsts:
                r = int(r_sorted[fi])
                pend = self._pending.get(r)
                if pend is None:
                    continue
                off, pend_end = pend
                first_col = int(col[order[fi]])
                if pend_end >= first_col:
                    f_eff.seek(off)
                    f_eff.write(np.int64(first_col - 1).tobytes())
            f_eff.seek(here)
        # record this chunk's trailing cell per row
        order = np.lexsort((col, row))
        r_sorted = row[order]
        lasts = np.searchsorted(r_sorted, np.unique(r_sorted),
                                side="right") - 1
        base_off = self.n_cells * 8
        for li in lasts:
            src = int(order[li])
            self._pending[int(r_sorted[li])] = (base_off + src * 8,
                                                int(end[src]))
        self._files["__row__"].write(row.tobytes())
        self._files["__col__"].write(col.tobytes())
        self._files["__end__"].write(end.tobytes())
        self._files["__eff_end__"].write(eff.tobytes())
        self.max_span = max(self.max_span,
                            int((end - col).max(initial=0)))
        for name in self.attribute_order:
            fd = store.fields[name]
            fm = self.field_meta[name]
            self._files[f"{name}.valid"].write(
                np.ascontiguousarray(fd.valid, dtype=np.bool_).tobytes())
            vdt = _np_dtype(fm["kind"], fm["dtype"])
            self._files[f"{name}.values"].write(
                np.ascontiguousarray(fd.values, dtype=vdt).tobytes())
            if fm["kind"] == "fixed":
                fm["fixed_len"] = int(fd.values.shape[1])
                continue
            vt = self._value_totals.get(name, 0)
            if fm["kind"] == "ragged2d":
                # inner offsets rebase by total values written so far;
                # outer offsets rebase by total inner entries
                it = self._offset_tails.get(name, 0)
                inner = np.asarray(fd.offsets, dtype=np.int64) + vt
                outer = np.asarray(fd.outer_offsets,
                                   dtype=np.int64) + it
                self._files[f"{name}.offsets"].write(
                    (inner if self.n_cells == 0 and it == 0
                     else inner[1:]).tobytes())
                self._files[f"{name}.outer"].write(
                    (outer if self.n_cells == 0
                     else outer[1:]).tobytes())
                self._offset_tails[name] = it + len(fd.offsets) - 1
                self._value_totals[name] = vt + len(fd.values)
                continue
            offs = np.asarray(fd.offsets, dtype=np.int64) + vt
            self._files[f"{name}.offsets"].write(
                (offs if self.n_cells == 0 else offs[1:]).tobytes())
            self._value_totals[name] = vt + len(fd.values)
        self.n_cells += n

    def close(self, metadata: Optional[dict] = None) -> str:
        if self._closed:
            return self.dir
        total = 0
        for f in self._files.values():
            f.flush()
            total += f.tell()
            f.close()
        manifest = {
            "version": 2,
            "n_cells": self.n_cells,
            "num_rows": self.num_rows,
            "lb_row": self.lb_row,
            "attribute_order": self.attribute_order,
            "field_meta": self.field_meta,
            "max_span": self.max_span,
            "total_bytes": total,
        }
        if metadata:
            manifest.update(metadata)
        with open(os.path.join(self.dir, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
        self._closed = True
        return self.dir


def write_fragment_v2(frag_dir: str, store: ColumnarStore,
                      metadata: Optional[dict] = None) -> str:
    """One-shot v2 fragment from an in-memory store."""
    field_meta = {name: {"kind": fd.kind, "dtype": fd.dtype}
                  for name, fd in store.fields.items()}
    w = FragmentV2Writer(frag_dir, store.attribute_order, field_meta,
                         store.num_rows, store.lb_row)
    w.append(store)
    return w.close(metadata)


def is_v2_fragment(path: str) -> bool:
    return path.endswith(V2_SUFFIX) and \
        os.path.isfile(os.path.join(path, MANIFEST))


def read_manifest(frag_dir: str) -> dict:
    with open(os.path.join(frag_dir, MANIFEST)) as f:
        return json.load(f)


def open_fragment_v2(frag_dir: str, mmap: bool = True) -> ColumnarStore:
    """Open a v2 fragment as a ColumnarStore backed by np.memmap views
    (mmap=True) — zero-copy, paged in on demand — or materialized."""
    man = read_manifest(frag_dir)
    n = man["n_cells"]

    def load(name, dtype, shape=None):
        path = os.path.join(frag_dir, name + ".bin")
        if mmap and os.path.getsize(path) > 0:
            arr = np.memmap(path, dtype=dtype, mode="r")
        else:
            arr = np.fromfile(path, dtype=dtype)
        if shape is not None:
            arr = arr.reshape(shape)
        return arr

    store = ColumnarStore(num_rows=man["num_rows"],
                          lb_row=man.get("lb_row", 0))
    store.attribute_order = list(man["attribute_order"])
    store.row = load("__row__", np.int64)
    store.col = load("__col__", np.int64)
    store.end = load("__end__", np.int64)
    store.eff_end = load("__eff_end__", np.int64)
    for name in store.attribute_order:
        fm = man["field_meta"][name]
        vdt = _np_dtype(fm["kind"], fm["dtype"])
        shape = (n, fm["fixed_len"]) if fm["kind"] == "fixed" else None
        fd = FieldData(name=name, kind=fm["kind"], dtype=fm["dtype"],
                       valid=load(f"{name}.valid", np.bool_),
                       values=load(f"{name}.values", vdt, shape))
        if fm["kind"] != "fixed":
            fd.offsets = load(f"{name}.offsets", np.int64)
        if fm["kind"] == "ragged2d":
            fd.outer_offsets = load(f"{name}.outer", np.int64)
        store.fields[name] = fd
    store._v2_manifest = man
    return store


def slice_store(store: ColumnarStore, i0: int, i1: int) -> ColumnarStore:
    """The CONTIGUOUS cell range [i0, i1) as a store of its own, whose
    columns are views of the store's (memory-mapped) columns: no gathers,
    and the stored GLOBAL eff_end values carry over exactly — unlike
    store_take, which recomputes them from the subset.  Only the ragged
    fields' offsets, rebased to their window's values, are new arrays."""
    out = ColumnarStore(num_rows=store.num_rows, lb_row=store.lb_row)
    out.attribute_order = list(store.attribute_order)
    out.row = store.row[i0:i1]
    out.col = store.col[i0:i1]
    out.end = store.end[i0:i1]
    out.eff_end = store.eff_end[i0:i1]
    for name, fd in store.fields.items():
        valid = fd.valid[i0:i1]
        if fd.kind == "fixed":
            out.fields[name] = FieldData(name, fd.kind, fd.dtype, valid,
                                         fd.values[i0:i1])
            continue
        if fd.kind == "ragged2d":
            o0, o1 = int(fd.outer_offsets[i0]), int(fd.outer_offsets[i1])
            v0, v1 = int(fd.offsets[o0]), int(fd.offsets[o1])
            out.fields[name] = FieldData(
                name, fd.kind, fd.dtype, valid, fd.values[v0:v1],
                np.array(fd.offsets[o0:o1 + 1]) - v0,
                np.array(fd.outer_offsets[i0:i1 + 1]) - o0)
            continue
        v0, v1 = int(fd.offsets[i0]), int(fd.offsets[i1])
        out.fields[name] = FieldData(
            name, fd.kind, fd.dtype, valid, fd.values[v0:v1],
            np.array(fd.offsets[i0:i1 + 1]) - v0)
    return out


def window_bounds(col: np.ndarray, max_span: int, lo: int, hi: int
                  ) -> Tuple[int, int]:
    """[i0, i1): the (col,row)-sorted cells that can intersect columns
    [lo, hi] when no cell spans more than `max_span` positions."""
    return (int(np.searchsorted(col, lo - max_span, side="left")),
            int(np.searchsorted(col, hi, side="right")))


def column_window(store: ColumnarStore, lo: int, hi: int) -> ColumnarStore:
    """The cells of `store` that can intersect columns [lo, hi], as views
    of its columns (`slice_store`) with their GLOBAL eff_end values;
    `store` itself where that is every cell.  A query of intervals inside
    [lo, hi] reads the same bytes from either.  The longest cell span is
    a v2 fragment's manifest's, else one pass over the cells."""
    man = getattr(store, "_v2_manifest", None)
    span = int(man["max_span"]) if man is not None \
        else int((store.end - store.col).max(initial=0))
    i0, i1 = window_bounds(store.col, span, lo, hi)
    if i0 == 0 and i1 == store.num_cells:
        return store
    return slice_store(store, i0, i1)


class _PreadColumn:
    """Random-access raw column file read with os.pread — unlike mmap,
    pages never enter this process's RSS, so serving stays truly
    memory-bounded (ru_maxrss ~ window size, not partition size)."""

    def __init__(self, path: str, dtype):
        self.fd = os.open(path, os.O_RDONLY)
        self.dtype = np.dtype(dtype)
        self.itemsize = self.dtype.itemsize
        self.n = os.path.getsize(path) // self.itemsize

    def read(self, lo: int, hi: int) -> np.ndarray:
        nb = (hi - lo) * self.itemsize
        if nb <= 0:
            return np.zeros(0, dtype=self.dtype)
        buf = os.pread(self.fd, nb, lo * self.itemsize)
        return np.frombuffer(buf, dtype=self.dtype).copy()

    def close(self):
        os.close(self.fd)


class OocArray:
    """Out-of-core view of a single consolidated v2 fragment: yields
    memory-bounded column windows for streaming queries.

    Window payloads are read with os.pread (never mapped), so peak RSS
    ~= segment_size plus the query engine's working set regardless of
    partition size; only the col coordinate column is memmapped (binary
    searches touch O(log n) of its pages).  Nothing store-wide is ever
    materialized — the engines' store-level caches live on the
    per-window stores, which are discarded with the window."""

    def __init__(self, frag_dir: str, segment_size: int = 10 << 20):
        self.frag_dir = frag_dir
        self.manifest = read_manifest(frag_dir)
        self.segment_size = max(int(segment_size), 4096)
        self.store = open_fragment_v2(frag_dir, mmap=True)
        n = max(self.manifest["n_cells"], 1)
        self.bytes_per_cell = max(self.manifest["total_bytes"] / n, 1.0)
        self.max_span = int(self.manifest["max_span"])
        self._cols: Dict[str, _PreadColumn] = {}

    def _col_file(self, name: str, dtype) -> _PreadColumn:
        c = self._cols.get(name)
        if c is None:
            c = self._cols[name] = _PreadColumn(
                os.path.join(self.frag_dir, name + ".bin"), dtype)
        return c

    def read_window(self, i0: int, i1: int) -> ColumnarStore:
        """Materialize cells [i0, i1) via pread (no page mapping)."""
        man = self.manifest
        out = ColumnarStore(num_rows=man["num_rows"],
                            lb_row=man.get("lb_row", 0))
        out.attribute_order = list(man["attribute_order"])
        out.row = self._col_file("__row__", np.int64).read(i0, i1)
        out.col = self._col_file("__col__", np.int64).read(i0, i1)
        out.end = self._col_file("__end__", np.int64).read(i0, i1)
        out.eff_end = self._col_file("__eff_end__",
                                     np.int64).read(i0, i1)
        for name in out.attribute_order:
            fm = man["field_meta"][name]
            vdt = _np_dtype(fm["kind"], fm["dtype"])
            valid = self._col_file(f"{name}.valid",
                                   np.bool_).read(i0, i1)
            if fm["kind"] == "fixed":
                k = fm["fixed_len"]
                vals = self._col_file(f"{name}.values", vdt).read(
                    i0 * k, i1 * k).reshape(i1 - i0, k)
                out.fields[name] = FieldData(name, fm["kind"],
                                             fm["dtype"], valid, vals)
                continue
            if fm["kind"] == "ragged2d":
                outer = self._col_file(f"{name}.outer",
                                       np.int64).read(i0, i1 + 1)
                o0, o1 = int(outer[0]), int(outer[-1])
                offs = self._col_file(f"{name}.offsets",
                                      np.int64).read(o0, o1 + 1)
                v0 = int(offs[0]) if len(offs) else 0
                v1 = int(offs[-1]) if len(offs) else 0
                vals = self._col_file(f"{name}.values",
                                      vdt).read(v0, v1)
                out.fields[name] = FieldData(
                    name, fm["kind"], fm["dtype"], valid, vals,
                    offs - v0, outer - o0)
                continue
            offs = self._col_file(f"{name}.offsets",
                                  np.int64).read(i0, i1 + 1)
            v0, v1 = int(offs[0]), int(offs[-1])
            vals = self._col_file(f"{name}.values", vdt).read(v0, v1)
            out.fields[name] = FieldData(name, fm["kind"], fm["dtype"],
                                         valid, vals, offs - v0)
        return out

    @property
    def num_rows(self) -> int:
        return self.store.num_rows

    @property
    def lb_row(self) -> int:
        return self.store.lb_row

    @property
    def attribute_order(self) -> List[str]:
        return self.store.attribute_order

    def column_bounds(self) -> Tuple[int, int]:
        """[first cell column, last possibly-covered column] without
        scanning the (memmapped) coordinate files."""
        col = self.store.col
        if len(col) == 0:
            return (0, 0)
        return int(col[0]), int(col[-1]) + self.max_span

    def window(self, lo: int, hi: int) -> ColumnarStore:
        """Materialize all cells that can intersect [lo, hi]."""
        return self.read_window(*window_bounds(self.store.col,
                                               self.max_span, lo, hi))

    def windows(self, interval: Tuple[int, int]
                ) -> Iterator[Tuple[int, int, ColumnarStore]]:
        """Yield (wlo, whi, window_store) covering `interval` in order.

        Window boundaries fall on cell-start columns (record starts),
        so per-window query outputs concatenate byte-identically to a
        single whole-interval query (the same record-aligned chunking
        rule as driver.iter_vcf_query_block)."""
        lo, hi = int(interval[0]), int(interval[1])
        col = self.store.col
        budget = max(int(self.segment_size / self.bytes_per_cell), 1024)
        cur = lo
        while cur <= hi:
            i0, j_end = window_bounds(col, self.max_span, cur, hi)
            if j_end - i0 > budget:
                j = i0 + budget
                split_col = int(col[j])
                if split_col <= cur:
                    # a single column holds more cells than the budget:
                    # take the whole column run (cannot split a column)
                    nxt = int(np.searchsorted(col, cur, side="right"))
                    split_col = int(col[nxt]) if nxt < len(col) \
                        else hi + 1
                if split_col > hi:
                    whi, j = hi, j_end
                else:
                    whi = split_col - 1
                    j = int(np.searchsorted(col, split_col,
                                            side="left"))
            else:
                whi, j = hi, j_end
            yield cur, whi, self.read_window(i0, j)
            cur = whi + 1


def consolidate_v2_streaming(frag_dirs: List[str], out_dir: str,
                             segment_size: int = 64 << 20) -> str:
    """k-way merge of v2 fragments into one, at bounded memory: global
    column windows are merged in (col,row) order and appended through
    FragmentV2Writer (which finalizes eff_end across windows).  The
    out-of-core equivalent of workspace.merge_stores /
    consolidate_tiledb_array."""
    from .workspace import merge_stores
    mans = [read_manifest(d) for d in frag_dirs]
    stores = [open_fragment_v2(d, mmap=True) for d in frag_dirs]
    attribute_order = list(mans[0]["attribute_order"])
    field_meta = dict(mans[0]["field_meta"])
    writer = FragmentV2Writer(
        out_dir, attribute_order, field_meta,
        num_rows=max(m["num_rows"] for m in mans),
        lb_row=min(m.get("lb_row", 0) for m in mans))
    total_cells = sum(m["n_cells"] for m in mans)
    bpc = max(sum(m["total_bytes"] for m in mans) / max(total_cells, 1),
              1.0)
    budget = max(int(segment_size / bpc), 1024)
    ptrs = [0] * len(stores)
    while True:
        nexts = [int(s.col[p]) for s, p in zip(stores, ptrs)
                 if p < s.num_cells]
        if not nexts:
            break
        cur = min(nexts)
        # tentative split: the column of each fragment's cell `budget`
        # past its pointer; take the min so no window exceeds ~budget
        # cells per fragment
        split = None
        for s, p in zip(stores, ptrs):
            if p + budget < s.num_cells:
                c = int(s.col[p + budget])
                split = c if split is None else min(split, c)
        if split is not None and split <= cur:
            split = cur + 1   # column run larger than budget: take it
        chunks = []
        new_ptrs = []
        for s, p in zip(stores, ptrs):
            q = int(np.searchsorted(s.col, split, side="left")) \
                if split is not None else s.num_cells
            if q > p:
                chunks.append(slice_store(s, p, q))
            new_ptrs.append(max(q, p))
        ptrs = new_ptrs
        merged = chunks[0] if len(chunks) == 1 else merge_stores(chunks)
        writer.append(merged)
    return writer.close()
