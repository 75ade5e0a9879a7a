"""Blocks the block engine combined per lookup (the program's counter
`fused_combine.combine_block.blocks`): a 10 kb lookup's ~2,200 records
cut into chunks of about 1,030."""

COUNTERS = {"blocks": "genomicsdb_tpu_torch.ops.fused_combine:"
                      "combine_block.blocks"}


def read(view):
    n = view.counts.get("lookups", 0)
    return view.counters["blocks"] / n if n else None
