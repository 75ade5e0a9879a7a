"""The per-chunk work of the host block build, in ms per block: the
program's `block.build` spans (`ops/store_block.store_to_block`) less
the outermost `rebuild.*` spans inside them, over the `block.build`
calls: what a store kept open across queries would still pay."""

from gdb_bench import program_trace as P


def read(view):
    builds = P.named(view, "block.build")
    if not builds:
        return None
    rebuilds = P.outermost_rebuilds(view, under="block.build")
    return (P.ms(builds) - P.ms(rebuilds)) / len(builds)
