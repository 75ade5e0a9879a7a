"""The port's block engine with the fetch pack forced on, on the CPU:
the narrow kernel twin, the med_rows restriction, the packed variant-row
fetch and the host identity rebuild.  The text must be byte-identical
to genomicsdb_tpu's block engine with GENOMICSDB_TPU_FUSED=1 and
GENOMICSDB_TPU_PACK=1 (its Pallas kernel in interpret mode), to its
sequential engine and to the port with the pack off; the same query also
runs in a subprocess where neither jax nor genomicsdb_tpu can be
imported."""

import contextlib
import io
import os
import subprocess
import sys

import pytest
import torch

from genomicsdb_tpu.tools import gdb_query as jax_gdb_query
from genomicsdb_tpu_torch.ops import combine_step as TC
from genomicsdb_tpu_torch.ops import fused_combine as FC
from genomicsdb_tpu_torch.query import block_writer as BW
from genomicsdb_tpu_torch.query import driver as tdriver
from genomicsdb_tpu_torch.testing import write_cohort
from genomicsdb_tpu_torch.tools import gdb_query as torch_gdb_query
from genomicsdb_tpu_torch.tools import vcf2gdb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(main, argv, **kw) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv, **kw)
    return buf.getvalue()


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """The cohort of tests/test_torch_block_engine.py."""
    c = write_cohort(str(tmp_path_factory.mktemp("cohort")), 12, 150,
                     seed=5, n_groups=3)
    vcf2gdb.main([c.loader])
    return c


def test_packed_port_equals_jax_fused_packed_and_sequential(cohort,
                                                            monkeypatch):
    base = ["-j", cohort.query, "--produce-Broad-GVCF"]
    split0 = BW.render_block_vcf_pipelined.split_blocks
    bytes0 = TC.fetch_outputs.fetched_bytes
    wide0 = FC.combine_block.wide_blocks_when_packing
    launches0 = FC.fused_gather_remap.launches
    packed = _run(torch_gdb_query.main, base + ["--device", "cpu"],
                  pack=True)
    assert BW.render_block_vcf_pipelined.split_blocks > split0
    packed_bytes = TC.fetch_outputs.fetched_bytes - bytes0
    assert FC.combine_block.wide_blocks_when_packing == wide0
    assert FC.fused_gather_remap.launches == launches0   # CPU: the twin
    bytes1 = TC.fetch_outputs.fetched_bytes
    plain = _run(torch_gdb_query.main, base + ["--device", "cpu"],
                 pack=False)
    plain_bytes = TC.fetch_outputs.fetched_bytes - bytes1
    assert 0 < 2 * packed_bytes < plain_bytes
    # off by default on the CPU device: the same bytes again
    assert _run(torch_gdb_query.main, base + ["--device", "cpu"]) == plain
    assert TC.fetch_outputs.fetched_bytes - bytes1 == 2 * plain_bytes
    monkeypatch.setenv("GENOMICSDB_TPU_FUSED", "1")
    monkeypatch.setenv("GENOMICSDB_TPU_PACK", "1")
    jax_packed = _run(jax_gdb_query.main, base + ["--engine", "block"])
    monkeypatch.delenv("GENOMICSDB_TPU_FUSED")
    monkeypatch.delenv("GENOMICSDB_TPU_PACK")
    jax_seq = _run(jax_gdb_query.main, base + ["--engine", "sequential"])
    assert len(packed.splitlines()) > 200
    assert packed == jax_packed
    assert packed == jax_seq
    assert packed == plain


def test_packed_port_over_small_chunks(cohort, monkeypatch):
    """Many chunks in the two-phase pipeline (two in flight), each with
    its own med_rows bucket, split decision and blob: equal to one
    chunk without the pack.  Both queries run the engine (the serving
    index would serve the repeat of one store's query)."""
    monkeypatch.setenv("GENOMICSDB_TPU_SERVING_INDEX", "0")
    args = torch_gdb_query._build_parser().parse_args(
        ["-j", cohort.query, "--produce-Broad-GVCF"])
    _, qp, vid, store = torch_gdb_query.load_context(args, 0)
    cpu = torch.device("cpu")

    def query(**kw):
        qc = tdriver.make_query_config(qp, vid)
        return tdriver.run_vcf_query_block(store, qc, qp, vid, cpu, **kw)

    whole = query(pack=False)
    split0 = BW.render_block_vcf_pipelined.split_blocks
    chunked = query(pack=True, max_records_per_block=64)
    assert BW.render_block_vcf_pipelined.split_blocks - split0 > 3
    assert chunked == whole and len(whole.splitlines()) > 200


@pytest.mark.parametrize("library", ["native", "none"])
def test_packed_port_tetraploid_equals_unpacked(tmp_path, monkeypatch,
                                                library):
    """A small tetraploid cohort at 7 merged alleles (210 PL slots a
    call): the packed fetch keeps its reference rows at 5 PL slots and
    2 AD slots, and the text is byte-identical to the port with the
    pack off (dense outputs through the same renderer); also where the
    native library is missing, so the numpy fills and the Python
    columns read the record-strided outputs."""
    from genomicsdb_tpu_torch.runtime import native_loader
    monkeypatch.setenv("GENOMICSDB_TPU_SERVING_INDEX", "0")
    c = write_cohort(str(tmp_path), 12, 120, seed=3, n_groups=3, ploidy=4)
    vcf2gdb.main([c.loader])
    base = ["-j", c.query, "--produce-Broad-GVCF", "--engine", "block",
            "--device", "cpu"]
    plain = _run(torch_gdb_query.main, base, pack=False)
    if library == "none":
        native_loader.get_lib()
        monkeypatch.setattr(native_loader, "_lib", None)
    split0 = BW.render_block_vcf_pipelined.split_blocks
    packed = _run(torch_gdb_query.main, base, pack=True)
    assert BW.render_block_vcf_pipelined.split_blocks > split0
    assert len(packed.splitlines()) > 300
    assert "./././." in packed
    assert packed == plain


def test_packed_port_runs_with_jax_blocked(cohort):
    """The packed query in a fresh interpreter where `import jax` and
    `import genomicsdb_tpu` fail."""
    argv = ["-j", cohort.query, "--produce-Broad-GVCF", "--device", "cpu"]
    expected = _run(torch_gdb_query.main, argv, pack=True)
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['genomicsdb_tpu'] = None\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from genomicsdb_tpu_torch.tools import gdb_query\n"
        "from genomicsdb_tpu_torch.query import block_writer\n"
        f"gdb_query.main({argv!r}, pack=True)\n"
        "assert block_writer.render_block_vcf_pipelined.split_blocks > 0\n"
        "assert sys.modules['jax'] is None\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout == expected
