"""Rank 0's time in the mesh's collectives, in ms per block it built:
the program's outermost `mesh.scatter_rows` (the row group's block
rows), `mesh.all_gather` (the cross-sample reductions' all-gather and
the outputs' gather, `parallel/comm`), `mesh.gather_rows` (the row
group's outputs to its row-0 rank) and `mesh.gather_text` (the spans'
texts to the first rank, `parallel/multihost`) spans, over the window's
`block.build` spans.  Each span holds one collective alone (with
tracing on, the program waits for the card before and after it:
`parallel/comm.collective`), so it holds the transfer and the wait for
the slowest rank of its group, and no packing, upload or fetch.  None
against a program without them."""

from gdb_bench import mesh_trace as M
from gdb_bench import program_trace as P

MESH_SPANS = ("mesh.scatter_rows", "mesh.all_gather", "mesh.gather_rows",
              "mesh.gather_text")


def read(view):
    builds = P.named(view, "block.build")
    got = M.outermost(view, MESH_SPANS)
    if not builds or not got:
        return None
    return P.ms(got) / len(builds)
