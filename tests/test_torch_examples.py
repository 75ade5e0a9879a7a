"""The port's demos (`genomicsdb_tpu_torch/examples/`), each run as
`python -m genomicsdb_tpu_torch.examples.<name>` in an interpreter where
`jax` and `genomicsdb_tpu` cannot be imported, printing the line
`tests/test_examples.py` looks for in its JAX twin; the block engine
demo's text against the JAX package's block engine on the same seeded
files, and the sharded demo's gathered block against the unsharded
`combine_step`.
"""

import os
import re
import subprocess
import sys

import pytest
import torch

from genomicsdb_tpu.core.config import QueryParams as JQueryParams
from genomicsdb_tpu.core.vid import VidMapper as JVidMapper
from genomicsdb_tpu.query import driver as jdriver
from genomicsdb_tpu.store.import_pipeline import \
    import_callsets as jimport_callsets
from genomicsdb_tpu_torch.examples import (block_engine_demo,
                                           sharded_combine_demo)
from genomicsdb_tpu_torch.ops.combine_step import (block_to_tensors,
                                                   combine_step)
from genomicsdb_tpu_torch.testing import write_cohort

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("import runpy, sys\n"
           "sys.modules['jax'] = None\n"
           "sys.modules['genomicsdb_tpu'] = None\n"
           f"sys.path.insert(0, {ROOT!r})\n"
           "name = sys.argv[1]\n"
           "sys.argv = [name] + sys.argv[2:]\n"
           "runpy.run_module('genomicsdb_tpu_torch.examples.' + name, "
           "run_name='__main__')\n"
           "assert not [m for m in sys.modules if m.startswith(("
           "'jax.', 'genomicsdb_tpu.'))]\n")
DEMOS = {
    "streaming_import_demo": ([], "first combined records"),
    "query_stream_demo": (["--device", "cpu"], "interval 1:12000-13000"),
    "block_engine_demo": (["--device", "cpu"], "block engine"),
    "sharded_combine_demo": (["--device", "cpu"], "mesh=(4 pos x 2 row)"),
}


def _run_blocked(name, argv) -> str:
    res = subprocess.run([sys.executable, "-c", BLOCKED, name, *argv],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


@pytest.fixture(scope="module")
def outputs():
    """{demo: its stdout}, each demo run once per module."""
    runs = {}

    def get(name):
        if name not in runs:
            runs[name] = _run_blocked(name, DEMOS[name][0])
        return runs[name]
    return get


@pytest.mark.parametrize("name", sorted(DEMOS))
def test_demo_runs_with_jax_blocked(name, outputs):
    out = outputs(name)
    assert DEMOS[name][1] in out, out


def test_query_stream_demo_finds_records_in_its_interval(outputs):
    out = outputs("query_stream_demo")
    m = re.search(r"interval 1:12000-13000 -> (\d+) records", out)
    assert m and int(m.group(1)) > 10
    assert re.search(r"streamed \d+ bytes in \d+ pages of <=512b on cpu", out)


def test_block_engine_demo_equals_the_jax_block_engine(tmp_path):
    """The demo's query on the CPU device == the JAX package's
    run_vcf_query_block on the same seeded files (each side imports
    them with its own loaders)."""
    c = write_cohort(str(tmp_path), block_engine_demo.SAMPLES,
                     block_engine_demo.RECORDS, seed=block_engine_demo.SEED)
    timings = {}
    text = block_engine_demo.block_query(c, torch.device("cpu"), timings)
    jvid = JVidMapper.from_files(c.vid, c.callsets)
    jqp = JQueryParams()
    jqp.scan_full = True
    jqp.attributes = []
    want = jdriver.run_vcf_query_block(
        jimport_callsets(jvid), jdriver.make_query_config(jqp, jvid), jqp,
        jvid)
    assert text.count("\n") > 500
    assert text == want
    assert timings["cells"] == block_engine_demo.SAMPLES * \
        block_engine_demo.RECORDS


def test_sharded_demo_equals_the_unsharded_combine_step(outputs):
    """The block the demo's first rank gathers from its 4 x 2 mesh of
    gloo CPU ranks has the SHA-256 of the unsharded combine_step's
    outputs on the same block."""
    out = outputs("sharded_combine_demo")
    m = re.search(r"outputs sha256 ([0-9a-f]{64})", out)
    assert m, out
    ref = combine_step(*block_to_tensors(sharded_combine_demo.demo_block(),
                                         "cpu"), max_merged=4, ploidy=2)
    assert m.group(1) == sharded_combine_demo.digest(
        {k: v.numpy() for k, v in ref.items()})
    assert "on cpu [gloo], combined block: pl[" in out
