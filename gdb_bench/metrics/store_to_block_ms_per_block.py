"""Host block build (`ops/store_block.store_to_block`, as the block
writer calls it), in ms per call."""

SPANS = {"store_to_block":
         "genomicsdb_tpu_torch.query.block_writer:store_to_block"}


def read(view):
    return view.mean_ms("store_to_block")
