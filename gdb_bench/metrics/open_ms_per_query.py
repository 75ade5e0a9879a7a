"""Workspace open, vid and query configuration per scatter query
(`tools/gdb_query.load_context`), in ms."""

SPANS = {"load_context":
         "genomicsdb_tpu_torch.tools.gdb_query:load_context"}


def read(view):
    return view.mean_ms("load_context", per="queries")
