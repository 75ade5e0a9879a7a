"""Text render of one block (`query/block_writer._render_lines` with
the native text kernels under it), in ms per call."""

SPANS = {"render": "genomicsdb_tpu_torch.query.block_writer:_render_lines"}


def read(view):
    return view.mean_ms("render")
