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


def __getattr__(name):
    """Lazy top-level API (the JAX package's names, mapped to the port's
    modules; nothing of the engine is imported with the package):

        from genomicsdb_tpu_torch import VidMapper, import_callsets, ...
    """
    api = {
        "VidMapper": ("genomicsdb_tpu_torch.core.vid", "VidMapper"),
        "QueryParams": ("genomicsdb_tpu_torch.core.config", "QueryParams"),
        "ImportParams": ("genomicsdb_tpu_torch.core.config",
                         "ImportParams"),
        "import_callsets": ("genomicsdb_tpu_torch.store.import_pipeline",
                            "import_callsets"),
        "StreamingImporter": ("genomicsdb_tpu_torch.store.streaming_import",
                              "StreamingImporter"),
        "FeatureReader": ("genomicsdb_tpu_torch.query.stream",
                          "FeatureReader"),
        "CombinedRecordStream": ("genomicsdb_tpu_torch.query.stream",
                                 "CombinedRecordStream"),
        "driver": ("genomicsdb_tpu_torch.query.driver", None),
    }
    if name in api:
        import importlib
        mod, attr = api[name]
        m = importlib.import_module(mod)
        return m if attr is None else getattr(m, attr)
    raise AttributeError(f"module 'genomicsdb_tpu_torch' has no attribute "
                         f"{name!r}")
