"""Bytes rank 0 sends and receives in the mesh's collectives (the
program's counter `COUNTS.collective_bytes`, counted beside the
function attributes `comm.all_gather.bytes`,
`comm.gather_to_root.bytes`, `sharded.scatter_rows.bytes` and
`multihost.gather_blobs_to_root.bytes`, summed over the tallies of the
window's `query` roots) per combined record emitted in the window.
None against a program that does not count them."""

from gdb_bench import mesh_trace as M
from gdb_bench import program_trace as P


def read(view):
    n = view.counts.get("records", 0)
    got = P.request_count(view, "collective_bytes")
    if not n or got is None or not M.counted("collective_bytes"):
        return None
    return got / n
