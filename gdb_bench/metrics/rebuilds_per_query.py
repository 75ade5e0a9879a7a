"""Store-wide table rebuilds per query (the program's counter
`COUNTS.store_rebuilds`, one per cache miss, summed over the tallies of
the window's `query` roots, over those roots): a store kept open across
queries would read 0."""

from gdb_bench import program_trace as P


def read(view):
    q = P.queries(view)
    n = P.request_count(view, "store_rebuilds")
    if not q or n is None:
        return None
    return n / q
