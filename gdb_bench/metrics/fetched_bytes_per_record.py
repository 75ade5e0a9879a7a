"""Bytes fetched from the device (the program's counter
`combine_step.fetch_outputs.fetched_bytes`) per combined record
emitted in the window."""

COUNTERS = {"fetched_bytes":
            "genomicsdb_tpu_torch.ops.combine_step:"
            "fetch_outputs.fetched_bytes"}


def read(view):
    n = view.counts.get("records", 0)
    return view.counters["fetched_bytes"] / n if n else None
