"""The port's paged combined stream (`gdb_query -p`), its out-of-core
windows (`gdb_query --ooc`) and its FeatureReader on the CPU, against
the port's one-shot in-RAM query and the JAX tool / reader, byte for
byte.  The store is a seeded `genomicsdb_tpu_torch.testing` cohort
imported with the port's vcf2gdb; each package opens it with its own
loaders.
"""

import contextlib
import io

import numpy as np
import pytest

from genomicsdb_tpu.core.vid import VidMapper as JaxVidMapper
from genomicsdb_tpu.query import driver as jax_driver
from genomicsdb_tpu.query.stream import FeatureReader as JaxFeatureReader
from genomicsdb_tpu.store import workspace as jax_ws
from genomicsdb_tpu.tools import gdb_query as jax_gdb_query
from genomicsdb_tpu_torch.core.config import QueryParams
from genomicsdb_tpu_torch.core.vid import VidMapper
from genomicsdb_tpu_torch.ops import fused_combine as FC
from genomicsdb_tpu_torch.query import driver
from genomicsdb_tpu_torch.query.stream import FeatureReader
from genomicsdb_tpu_torch.store import workspace as ws
from genomicsdb_tpu_torch.testing import write_cohort
from genomicsdb_tpu_torch.tools import gdb_query, vcf2gdb


def _run(main, argv, **kw) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv, **kw)
    return buf.getvalue()


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """About 2,700 cells: several 1,024-cell windows at -s 16384."""
    c = write_cohort(str(tmp_path_factory.mktemp("paged")), 9, 300,
                     seed=8, n_groups=3)
    vcf2gdb.main([c.loader])
    return c


@pytest.fixture(scope="module")
def one_shot(cohort):
    text = _run(gdb_query.main, ["-j", cohort.query, "--produce-Broad-GVCF",
                                 "--device", "cpu"])
    assert len(text.splitlines()) > 300
    return text


@pytest.mark.parametrize("page_size", [1, 4096, 1 << 20])
def test_paged_equals_one_shot_and_the_jax_tool(cohort, one_shot,
                                                page_size):
    argv = ["-j", cohort.query, "--produce-Broad-GVCF", "-p",
            str(page_size)]
    assert _run(gdb_query.main, argv + ["--device", "cpu"]) == one_shot
    assert _run(jax_gdb_query.main, argv) == one_shot


def test_paged_pages_respect_the_budget(cohort, one_shot):
    """Every page but the last holds at least page_size bytes and ends on
    a record boundary; the pages concatenate to the one-shot text."""
    vid = VidMapper.from_files(cohort.vid, cohort.callsets)
    store = ws.open_array(cohort.workspace, cohort.array)
    qp = QueryParams.from_file(cohort.query)
    qc = driver.make_query_config(qp, vid)
    pages = list(driver.run_vcf_query_paged(store, qc, qp, vid, "cpu",
                                            8192, pack=True))
    assert len(pages) > 3
    assert all(len(p) >= 8192 and p.endswith(b"\n") for p in pages[:-1])
    assert b"".join(pages).decode() == one_shot


@pytest.mark.parametrize("pack", [None, True])
def test_ooc_windows_equal_in_ram_and_the_jax_tool(cohort, one_shot,
                                                   pack):
    argv = ["-j", cohort.query, "--produce-Broad-GVCF", "--ooc", "-s",
            "16384"]
    driver.iter_vcf_query_block.ooc_windows = 0
    launches = FC.fused_gather_remap.launches
    got = _run(gdb_query.main, argv + ["--device", "cpu"], pack=pack)
    assert driver.iter_vcf_query_block.ooc_windows > 1
    assert FC.fused_gather_remap.launches == launches
    assert got == one_shot
    assert _run(jax_gdb_query.main, argv) == one_shot


def test_ooc_threshold_opens_windows(cohort, one_shot, monkeypatch):
    """Past GENOMICSDB_TPU_OOC_THRESHOLD the store opens out-of-core
    without --ooc; the paged mode and the host modes then read its
    memory-mapped view."""
    monkeypatch.setenv("GENOMICSDB_TPU_OOC_THRESHOLD", "1")
    base = ["-j", cohort.query, "--device", "cpu", "-s", "16384"]
    driver.iter_vcf_query_block.ooc_windows = 0
    assert _run(gdb_query.main, base + ["--produce-Broad-GVCF"]) == one_shot
    windows = driver.iter_vcf_query_block.ooc_windows
    assert windows > 1
    paged = _run(gdb_query.main, base + ["--produce-Broad-GVCF", "-p",
                                         "4096"])
    assert paged == one_shot
    assert driver.iter_vcf_query_block.ooc_windows == windows
    monkeypatch.delenv("GENOMICSDB_TPU_OOC_THRESHOLD")
    calls = _run(gdb_query.main, base + ["--print-calls", "--ooc"])
    assert calls == _run(gdb_query.main, base + ["--print-calls"])


def _canon(records):
    """FeatureReader tuples as plain values: contig, POS, the variant's
    interval and each live call's row, interval and core fields."""
    out = []
    for contig, pos, v in records:
        calls = []
        for i, c in v.valid_calls():
            vals = []
            for name in ("GT", "PL", "AD", "GQ", "DP"):
                x = c.field(name)
                vals.append(None if x is None
                            else np.asarray(x).tolist())
            calls.append((i, c.row, c.col, c.end, vals))
        out.append((contig, pos, v.start, v.end, calls))
    return out


def test_feature_reader_equals_the_jax_reader(cohort):
    vid = VidMapper.from_files(cohort.vid, cohort.callsets)
    store = ws.open_array(cohort.workspace, cohort.array)
    jvid = JaxVidMapper.from_files(cohort.vid, cohort.callsets)
    jstore = jax_ws.open_array(cohort.workspace, cohort.array)
    qp = QueryParams()
    qc = driver.make_query_config(qp, vid)
    jqp = jax_driver.QueryParams()
    jqc = jax_driver.make_query_config(jqp, jvid)
    port, ref = FeatureReader(store, qc, vid), JaxFeatureReader(jstore, jqc,
                                                                jvid)
    lo = 1 + cohort.region // 4
    got = _canon(port.query("1", lo, lo + 3000))
    assert len(got) > 10
    assert got == _canon(ref.query("1", lo, lo + 3000))
    whole = _canon(port.iterate())
    assert len(whole) > len(got)
    assert whole == _canon(ref.iterate())
