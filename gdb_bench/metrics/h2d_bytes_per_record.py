"""Bytes copied host -> device (the program's counter
`COUNTS.h2d_bytes`, counted in `ops/combine_step.to_tensor`, summed
over the tallies of the window's `query` roots) per combined record
emitted in the window."""

from gdb_bench import program_trace as P


def read(view):
    n = view.counts.get("records", 0)
    got = P.request_count(view, "h2d_bytes")
    if not n or got is None:
        return None
    return got / n
