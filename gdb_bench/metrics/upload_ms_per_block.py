"""Host-side time of the upload of one block's tensors (the program's
`device.upload` span, `ops/combine_step.block_to_tensors`: the
store-wide slabs where a query uploads them, and the block's own
arrays), in ms per call."""

from gdb_bench import program_trace as P


def read(view):
    ups = P.named(view, "device.upload")
    if not ups:
        return None
    return P.ms(ups) / len(ups)
