"""Blocks that took the general combine step, as a share of the blocks
combined, in % (the program's counters `COUNTS.combine_general_blocks`
and `COUNTS.combine_blocks`, counted in
`ops/fused_combine.combine_block`, summed over the tallies of the
window's `query` roots).  None against a program without the
counters."""

from gdb_bench import program_trace as P


def read(view):
    blocks = P.request_count(view, "combine_blocks")
    if not blocks:
        return None
    return 100.0 * P.request_count(view, "combine_general_blocks") / blocks
