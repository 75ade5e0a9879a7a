"""Share of the window's device-idle time that no program layer claims,
in %: each idle stretch of the profiler's device timeline is put down
to the innermost program span open on the host then
(`program_trace.idle_by_span`, whose table goes to standard error); a
stretch is unclaimed where no span is open, or where only a request's
root is (the `query` span's own time, between its children)."""

from gdb_bench import program_trace as P


def read(view):
    return P.unattributed_share(view)
