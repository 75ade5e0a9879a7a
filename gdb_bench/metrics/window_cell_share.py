"""Cells of the store that a scatter query's block-build tables are
derived over, as a share of the cells of the store it opened, in %
(the program's counters `COUNTS.window_cells` and `COUNTS.store_cells`,
counted in `tools/gdb_query.window_store`, summed over the tallies of
the window's `query` roots): 100 where every query derives its tables
from the whole store.  None against a program without the counters."""

from gdb_bench import program_trace as P


def read(view):
    opened = P.request_count(view, "store_cells")
    if not opened:
        return None
    return 100.0 * P.request_count(view, "window_cells") / opened
