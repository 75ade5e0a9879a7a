"""The port's counterparts of the repository's `examples/` demos, each
runnable as `python -m genomicsdb_tpu_torch.examples.<name>`:

  streaming_import_demo  buffer-stream import, then the sequential query
  query_stream_demo      lazy byte pages and interval queries (--device)
  block_engine_demo      import and the block engine's query (--device)
  sharded_combine_demo   the combine on a 4 x 2 ("pos", "row") mesh of
                         rank processes (--device)

Their inputs are seeded cohorts written by `genomicsdb_tpu_torch.testing`
into a temporary directory, with the cohort's own vid mapping.
"""
