"""Blocks that the kernel combined in its mixed-ploidy form (haploid
and diploid calls in one block: the ploidy <= 2 family on the card), as
a share of the blocks combined, in % (the program's counters
`COUNTS.combine_mixed_blocks` and `COUNTS.combine_blocks`, counted in
`ops/fused_combine.combine_block`, summed over the tallies of the
window's `query` roots).  A block that leaves the family takes a slower
route.  None against a program without the counters."""

from gdb_bench import program_trace as P


def read(view):
    blocks = P.request_count(view, "combine_blocks")
    if not blocks:
        return None
    return 100.0 * P.request_count(view, "combine_mixed_blocks") / blocks
