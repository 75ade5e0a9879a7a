"""Mesh layouts in the window (the program's counter
`COUNTS.mesh_joins`, one per `parallel/sharded.make_mesh` build, summed
over the tallies of the window's `query` roots): 0 where the world lays
its mesh out once, before the window.  None against a program that
does not count its mesh joins."""

from gdb_bench import mesh_trace as M
from gdb_bench import program_trace as P


def read(view):
    n = P.request_count(view, "mesh_joins")
    if n is None or not M.counted("mesh_joins"):
        return None
    return float(n)
