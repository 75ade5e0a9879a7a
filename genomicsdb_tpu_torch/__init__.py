"""genomicsdb_tpu_torch: the block-engine combined-gVCF query on PyTorch.

The PyTorch/CUDA counterpart of `genomicsdb_tpu`.  It stands alone: the
storage layer, the importer, the allele merge, the sequential oracle,
the host query modes and the native text library are its own copies of
the JAX package's framework-free modules, at the same relative paths.
Around them it carries the device combine: the torch ops, the
hand-written CUDA gather+remap kernel, and the block writer and driver
that run them.  It imports `torch`, and nothing of `jax` or
`genomicsdb_tpu`.
"""

__version__ = "0.1.0"
