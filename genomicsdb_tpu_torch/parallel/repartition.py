"""Online repartitioning: re-shard stores to new column bounds (the
port's copy of `genomicsdb_tpu.parallel.repartition`).

The reference fixes column partitions at import (loader
"column_partitions"); re-balancing means re-importing.  Here a store can
be re-sharded directly: cells are routed to the partitions they
intersect, and a cell spanning a partition's begin is replayed there
(the reference's handle_intervals_spanning_partition_begin semantics,
load_operators.cc:33-79 — only the LAST spanning interval per row
survives).  Pairs with tools/vcf_histogram.py's equi-partitioner.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..store.columnar import ColumnarStore, store_take
from ..store.workspace import merge_stores


def partition_store(store: ColumnarStore, begin: int,
                    end: Optional[int]) -> ColumnarStore:
    """Cells of `store` for partition [begin, end] with spanning replay
    (same semantics as importing with this column_partition)."""
    hi = end if end is not None else 2**63 - 2
    inside = np.nonzero((store.col >= begin) & (store.col <= hi))[0]
    before = np.nonzero(store.col < begin)[0]
    spanning: List[int] = []
    if len(before):
        rows_before = store.row[before]
        for r in np.unique(rows_before):
            ridx = before[rows_before == r]
            last = ridx[-1]   # (col,row)-sorted => latest interval
            if store.end[last] >= begin:
                spanning.append(int(last))
    spanning.sort(key=lambda i: (store.col[i], store.row[i]))
    take = np.concatenate([np.asarray(spanning, dtype=np.int64),
                           inside]).astype(np.int64)
    return store_take(store, take)


def repartition(stores: List[ColumnarStore],
                new_begins: List[int]) -> List[ColumnarStore]:
    """Re-shard existing partition stores onto new begin columns.

    Returns one store per new partition; partition i covers
    [new_begins[i], new_begins[i+1] - 1] (last is unbounded)."""
    merged = stores[0] if len(stores) == 1 else merge_stores(stores)
    if len(stores) > 1 and merged.num_cells:
        # shards carry replayed copies of partition-spanning cells; the
        # merge would duplicate them inside a new partition — keep one
        # cell per (col, row)
        same = np.zeros(merged.num_cells, dtype=bool)
        same[1:] = (np.diff(merged.col) == 0) & (np.diff(merged.row) == 0)
        if same.any():
            merged = store_take(merged,
                                np.nonzero(~same)[0].astype(np.int64))
    out = []
    for i, b in enumerate(new_begins):
        e = new_begins[i + 1] - 1 if i + 1 < len(new_begins) else None
        out.append(partition_store(merged, b, e))
    return out
