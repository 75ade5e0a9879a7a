"""Scan engine: aligned-interval sweep over the columnar store.

Faithful reimplementation of the reference's resumable scan
(VariantQueryProcessor::scan_and_operate + handle_gvcf_ranges +
scan_handle_cell, src/main/cpp/src/genomicsdb/query_variants.cc:296-560):
an END-ordered priority queue of live calls emits one "Variant" per aligned
sub-interval; overlapping same-row cells overwrite the live call; while any
live call contains a deletion the sweep single-position-steps.

This sequential engine is the semantics oracle; `ops/` holds the batched
TPU formulation used for large cohorts.
"""

from __future__ import annotations

import heapq
from typing import Callable, Iterator, List, Optional, Tuple

from ..core import profile
from ..core.config import QueryConfig, INT64_MAX
from ..store.columnar import ColumnarStore
from .cells import CallView


class Variant:
    """One aligned sub-interval + the live calls of every queried row."""

    def __init__(self, start: int, end: int, calls: List[Optional[CallView]],
                 valid: List[bool]):
        self.start = start
        self.end = end
        self.calls = calls          # per queried row (index = query row idx)
        self.valid = valid

    def valid_calls(self) -> Iterator[Tuple[int, CallView]]:
        for i, (c, v) in enumerate(zip(self.calls, self.valid)):
            if v and c is not None:
                yield i, c


class ScanError(Exception):
    pass


def scan_and_operate(store: ColumnarStore, qc: QueryConfig,
                     operate: Callable[[Variant], None],
                     interval: Optional[Tuple[int, int]] = None,
                     handle_spanning_deletions: bool = True):
    """Run the sweep over one query column interval (or the whole array)."""
    for variant in scan_variants(store, qc, interval,
                                 handle_spanning_deletions):
        operate(variant)


def scan_variants(store: ColumnarStore, qc: QueryConfig,
                  interval: Optional[Tuple[int, int]] = None,
                  handle_spanning_deletions: bool = True
                  ) -> Iterator[Variant]:
    """Generator form of the sweep: yields one Variant per aligned
    sub-interval.  Being a generator, it is naturally resumable — this is
    the engine behind the paged/streaming readers (the reference needs an
    explicit VariantQueryProcessorScanState object for this,
    query_variants.h:126-191)."""
    rows = qc.rows_to_query
    row_to_qidx = {r: i for i, r in enumerate(rows)}
    nrows = len(rows)
    calls: List[Optional[CallView]] = [None] * nrows
    valid = [False] * nrows
    # classification flags captured at fill time (reference stores them on
    # the VariantCall and does NOT recompute after ALT rewrites)
    deleted_flags = [False] * nrows
    ref_block_flags = [False] * nrows
    # priority queue of (end, qidx, generation); lazy deletion via gen check
    pq: List[Tuple[int, int, int]] = []
    gen = [0] * nrows
    num_calls_with_deletions = 0

    def push_call(qidx: int, call: CallView):
        nonlocal num_calls_with_deletions
        has_del, is_ref_blk = call.classify()
        call.contains_deletion_flag = has_del
        call.is_reference_block_flag = is_ref_blk
        calls[qidx] = call
        valid[qidx] = True
        deleted_flags[qidx] = has_del
        ref_block_flags[qidx] = is_ref_blk
        gen[qidx] += 1
        heapq.heappush(pq, (call.end, qidx, gen[qidx]))
        if handle_spanning_deletions and has_del:
            num_calls_with_deletions += 1

    def pq_top():
        while pq:
            end, qidx, g = pq[0]
            if g == gen[qidx] and valid[qidx]:
                return end, qidx
            heapq.heappop(pq)
        return None

    def invalidate(qidx: int):
        nonlocal num_calls_with_deletions
        if handle_spanning_deletions and valid[qidx] and deleted_flags[qidx]:
            num_calls_with_deletions -= 1
        valid[qidx] = False
        gen[qidx] += 1

    current_start = -1

    def handle_gvcf_ranges(next_start: int, is_last: bool):
        """reference query_variants.cc:296-332."""
        nonlocal current_start, num_calls_with_deletions
        while True:
            top = pq_top()
            if top is None:
                break
            if not (current_start < next_start or is_last):
                break
            top_end = top[0]
            if is_last or top_end < next_start - 1:
                min_end = top_end
            else:
                min_end = next_start - 1
            if num_calls_with_deletions:
                min_end = current_start  # single-position stepping
            if profile.ENABLED:
                profile.GLOBAL_STATS.bump("operator_invocations")
            yield Variant(current_start, min_end, list(calls), list(valid))
            # pop all calls ending exactly at min_end
            while True:
                top = pq_top()
                if top is None or top[0] != min_end:
                    break
                _, qidx = top
                heapq.heappop(pq)
                if handle_spanning_deletions and deleted_flags[qidx]:
                    num_calls_with_deletions -= 1
                valid[qidx] = False
            current_start = min_end + 1

    # ---- interval begin: calls intersecting the begin column ----
    start_scan_col = 0
    if interval is not None:
        qbegin, qend = interval
        for ci in store.cells_intersecting(qbegin):
            r = int(store.row[ci])
            if r not in row_to_qidx:
                continue
            qidx = row_to_qidx[r]
            push_call(qidx, CallView(store, ci, qc))
        if pq_top() is not None:
            current_start = qbegin
        start_scan_col = qbegin + 1
    # ---- forward scan (clipped to the interval: a 10 kb query on a
    # genome-scale store must not build a store-wide index range) ----
    if interval is not None:
        cell_idxs = store.cells_in_column_range(start_scan_col,
                                                interval[1])
    else:
        cell_idxs = store.cells_in_column_range(0, INT64_MAX - 1)
    ended = False
    for ci in cell_idxs:
        # interval-end break first (cells are col-sorted, so any cell
        # past the end means every later cell is too)...
        col = int(store.col[ci])
        if interval is not None and col > interval[1]:
            ended = True
            break
        # ...then the row-subset filter BEFORE any boundary handling:
        # the reference's storage iterator is restricted to the queried
        # rows (do_query_bookkeeping row bounds -> TileDB subarray), so
        # cells of non-queried rows must not create aligned-sub-interval
        # boundaries in the sweep
        r = int(store.row[ci])
        if r not in row_to_qidx:
            continue
        if profile.ENABLED:
            profile.GLOBAL_STATS.bump("cells_traversed")
        if current_start < 0:
            current_start = col
        if col != current_start:
            yield from handle_gvcf_ranges(col, False)
            current_start = col
        qidx = row_to_qidx[r]
        # overlapping same-row cell: overwrite live call
        # (reference query_variants.cc:512-541)
        if valid[qidx] and calls[qidx].end >= col:
            if not deleted_flags[qidx] and not ref_block_flags[qidx]:
                raise ScanError(
                    f"Unhandled overlapping variants at columns "
                    f"{calls[qidx].col} and {col} for row {r}")
            invalidate(qidx)
        push_call(qidx, CallView(store, ci, qc))
    # ---- tail ----
    if interval is not None:
        next_start = interval[1]
        if next_start != INT64_MAX:
            next_start += 1
        yield from handle_gvcf_ranges(next_start, False)
    else:
        yield from handle_gvcf_ranges(0, True)
    _ = ended


def iterate_cells(store: ColumnarStore, qc: QueryConfig,
                  interval: Optional[Tuple[int, int]]
                  ) -> Iterator[CallView]:
    """Cell iteration for the calls/CSV paths.

    Equivalent of SingleCellTileDBIterator's two modes
    (genomicsdb_iterators.cc:181-273): first the cells whose interval
    intersects the query begin (in (col,row) order), then simple forward
    traversal of begin cells within the interval.
    """
    rows = set(qc.rows_to_query)
    if interval is None:
        begin, end = 0, INT64_MAX - 1
        intersecting = []
    else:
        begin, end = interval
        intersecting = [ci for ci in store.cells_intersecting(begin)
                        if int(store.col[ci]) < begin]
    for ci in intersecting:
        if int(store.row[ci]) in rows:
            yield CallView(store, ci, qc)
    for ci in store.cells_in_column_range(begin, end):
        if int(store.row[ci]) in rows:
            yield CallView(store, ci, qc)
