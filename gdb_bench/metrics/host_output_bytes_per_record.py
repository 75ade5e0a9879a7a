"""Bytes of the host outputs the fetch returns (the program's counter
`COUNTS.host_output_bytes`, counted in `ops/combine_step.fetch_outputs`
and `fetch_outputs_split`, summed over the tallies of the window's
`query` roots) per combined record emitted in the window.  A program
without the counter tallies none: nothing to read."""

from gdb_bench import program_trace as P


def read(view):
    n = view.counts.get("records", 0)
    got = P.request_count(view, "host_output_bytes")
    if not n or not got:
        return None
    return got / n
