"""The port's block engine end to end on the CPU: a seeded in-repo gVCF
cohort with deletions and multi-allelic sites (genomicsdb_tpu_torch.
testing), imported with the port's vcf2gdb, queried with the port's
gdb_query (--device cpu) and with genomicsdb_tpu's gdb_query (block and
sequential engines), each side loading the store from the same files.
The texts must be byte-identical; the same port query also runs in a
subprocess where neither jax nor genomicsdb_tpu can be imported."""

import contextlib
import io
import os
import subprocess
import sys

import pytest

from genomicsdb_tpu.tools import gdb_query as jax_gdb_query
from genomicsdb_tpu_torch.ops import fused_combine as FC
from genomicsdb_tpu_torch.testing import write_cohort
from genomicsdb_tpu_torch.tools import gdb_query as torch_gdb_query
from genomicsdb_tpu_torch.tools import vcf2gdb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    c = write_cohort(str(tmp_path_factory.mktemp("cohort")), 12, 150,
                     seed=5, n_groups=3)
    vcf2gdb.main([c.loader])
    return c


def test_port_equals_jax_block_and_sequential(cohort):
    base = ["-j", cohort.query, "--produce-Broad-GVCF"]
    before = (FC.fused_gather_remap.launches, FC.combine_block.blocks)
    port = _run(torch_gdb_query.main, base + ["--device", "cpu"])
    assert FC.combine_block.blocks > before[1]
    assert FC.fused_gather_remap.launches == before[0]
    jax_block = _run(jax_gdb_query.main, base + ["--engine", "block"])
    jax_seq = _run(jax_gdb_query.main, base + ["--engine", "sequential"])
    lines = port.splitlines()
    assert len(lines) > 200
    # the cohort exercises what the engine must get right
    assert any(",<NON_REF>" in ln.split("\t")[4] and
               ln.split("\t")[4].count(",") >= 2 for ln in lines)
    assert any(len(ln.split("\t")[3]) > 1 for ln in lines)   # deletions
    assert any("BaseQRankSum=" in ln and "RAW_MQ=" in ln and "MQ0=" in ln
               for ln in lines)
    assert port == jax_block
    assert port == jax_seq


def test_port_sequential_route_and_head_interval(cohort):
    head = ["-j", cohort.query_head, "--produce-Broad-GVCF",
            "--device", "cpu"]
    blk = _run(torch_gdb_query.main, head)
    seq = _run(torch_gdb_query.main, head + ["--engine", "sequential"])
    assert blk == seq and blk


def test_port_refuses_mesh_and_missing_card(cohort, monkeypatch):
    """The mesh shards the block engine's one-shot combine only (the
    paged stream with --mesh is refused), and --device cuda without a
    card raises, with or without --mesh."""
    import torch
    with pytest.raises(SystemExit, match="--mesh"):
        torch_gdb_query.main(["-j", cohort.query, "--produce-Broad-GVCF",
                              "--device", "cpu", "--mesh", "2x1", "-p",
                              "4096"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--mesh", "2x1"]):
        with pytest.raises(RuntimeError, match="not available"):
            torch_gdb_query.main(["-j", cohort.query,
                                  "--produce-Broad-GVCF", "--device",
                                  "cuda"] + extra)


def test_port_runs_with_jax_blocked(cohort):
    """The same query in a fresh interpreter where `import jax` and
    `import genomicsdb_tpu` fail: the port and its own host modules on
    its path import neither, the extras path's G-length remap
    included."""
    expected = _run(torch_gdb_query.main, ["-j", cohort.query,
                                           "--produce-Broad-GVCF",
                                           "--device", "cpu"])
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['genomicsdb_tpu'] = None\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from genomicsdb_tpu_torch.tools import gdb_query\n"
        f"gdb_query.main(['-j', {cohort.query!r}, '--produce-Broad-GVCF',"
        " '--device', 'cpu'])\n"
        "import numpy as np\n"
        "from genomicsdb_tpu_torch.query.block_fields import "
        "remap_genotype_np\n"
        "z = np.zeros((1, 1, 3), np.int32)\n"
        "remap_genotype_np(z, np.ones((1, 1)), np.zeros((1, 1, 2), "
        "np.int32), -np.ones((1, 1), np.int32), np.full(1, 2, np.int32), "
        "np.full((1, 1), 2), -1)\n"
        "assert sys.modules['jax'] is None\n"
        "assert sys.modules['genomicsdb_tpu'] is None\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout == expected
