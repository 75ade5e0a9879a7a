"""The store-wide rebuilds each scatter query pays again, in ms per
query: the program's outermost `rebuild.*` spans (the miss branches of
the tables cached on the store and its dense layout; a rebuild inside
another counted once) over the program's `query` roots."""

from gdb_bench import program_trace as P


def read(view):
    q = P.queries(view)
    rebuilds = P.outermost_rebuilds(view)
    if not q or rebuilds is None:
        return None
    return P.ms(rebuilds) / q
