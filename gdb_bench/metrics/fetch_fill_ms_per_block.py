"""Host-side time to allocate and fill one block's fetched host outputs
(the program's `device.fetch.fill` span inside `device.fetch`,
`ops/combine_step`: the widening of the narrow blob rows and the
reference rows' identity fill), in ms per call."""

from gdb_bench import program_trace as P


def read(view):
    fills = P.named(view, "device.fetch.fill")
    if not fills:
        return None
    return P.ms(fills) / len(fills)
