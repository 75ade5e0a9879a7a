"""The combine's share of its byte roofline, in %: the least bytes of
every block handed to `fused_combine.combine_block` in the window
(`gdb_bench.roofline.combine_min_bytes`) over the card's published HBM
rate, against the summed device time of every CUDA kernel the profiler
recorded in the window.  It reads the same work whatever implements
it: a kernel fused into another, or replaced, raises the share."""

from gdb_bench.roofline import combine_min_bytes, peak_bytes_per_s

SPANS = {"combine_block":
         "genomicsdb_tpu_torch.query.block_writer:combine_block"}


def on_call(span, args, kwargs, result, store):
    blk = args[0]
    store["bytes"] = store.get("bytes", 0) + combine_min_bytes(
        blk, max_merged=kwargs["max_merged"], ploidy=kwargs["ploidy"],
        mixed=bool(kwargs.get("mixed_ploidy", False)))


def read(view):
    got = view.store("combine_roofline").get("bytes", 0)
    if not got or view.device is None:
        return None
    kernel_s = view.device.kernel_s()
    if kernel_s <= 0:
        return None
    bound_s = got / peak_bytes_per_s(view.counts["card"])
    return 100.0 * bound_s / kernel_s
