"""Host-side time of the general combine step on one block (the
program's `device.combine.general` span inside `device.combine`,
`ops/fused_combine.combine_block`: the plain-torch `combine_step` of a
block past the kernel's gates, more than 16 merged alleles here), in ms
per call.  None where no block took the general step, or against a
program without the span."""

from gdb_bench import program_trace as P


def read(view):
    steps = P.named(view, "device.combine.general")
    if not steps:
        return None
    return P.ms(steps) / len(steps)
