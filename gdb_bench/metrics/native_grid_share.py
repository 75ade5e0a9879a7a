"""Blocks whose records x samples grid the program built in its native
pass, as a share of the blocks it built, in % (the program's counters
`COUNTS.block_grid_native` and `COUNTS.block_grid_numpy`, counted once
a block in `ops/store_block.store_to_block`, summed over the tallies of
the window's `query` roots): 0 where every block falls back to numpy.
None against a program without the counters."""

from gdb_bench import program_trace as P


def read(view):
    native = P.request_count(view, "block_grid_native")
    if native is None:
        return None
    built = native + P.request_count(view, "block_grid_numpy")
    if not built:
        return None
    return 100.0 * native / built
