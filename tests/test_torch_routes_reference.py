"""The port's combine on the benchmark's chrX-style routes cohort
(configuration `routes_1000`: diploid first third, the odd samples
haploid in the middle third, hotspots past 16 merged alleles in the
last, 30% of diploid variant calls phased with GT's phase stored), cut
to 24 samples x 150 records in 4 files, on the CPU.

Its text over each interval of the `scatter6_phased` mix equals the
benchmark's plain reference that keeps GT phase separators
(`gdb_bench/reference_phased.py`) byte for byte; each third of the
contig takes its own device route; that reference renders unphased
cohorts as `gdb_bench/reference.py` does; and with tracing on the
general step's span and the route counters agree with
`fused_combine.combine_block`'s attributes."""

import contextlib
import functools
import io
import json

import pytest
import torch

from gdb_bench import manifest, reference, reference_phased
from gdb_bench import traffic as T
from gdb_bench.cohort import write_cohort
from gdb_bench.drivers import query_doc, split_lines
from genomicsdb_tpu_torch.core import profile
from genomicsdb_tpu_torch.core.config import QueryParams
from genomicsdb_tpu_torch.core.vid import VidMapper
from genomicsdb_tpu_torch.ops import fused_combine as FC
from genomicsdb_tpu_torch.query import driver
from genomicsdb_tpu_torch.store import workspace as ws
from genomicsdb_tpu_torch.tools import gdb_query, vcf2gdb

BENCH = manifest.load()
MIX = manifest.traffic("scatter6_phased")
SIZE = dict(n_samples=24, n_records=150, n_groups=4)
SEED = 2 ** 31 + 11
CHUNK = 40                  # records per block where the thirds must part
ATTRS = ("blocks", "general_path_blocks", "mixed_blocks")
COUNTERS = ("combine_blocks", "combine_general_blocks",
            "combine_mixed_blocks")
# each interval's route: intervals 0-1 diploid, 2-3 mixed, 4-5 general
ROUTE = ["diploid", "diploid", "mixed", "mixed", "general", "general"]


def _cohort(path, config: str, n_records: int = SIZE["n_records"]):
    gen = dict(manifest.config(BENCH, config)["generator"], **SIZE)
    gen["n_records"] = n_records
    c = write_cohort(str(path), seed=SEED, **gen)
    with contextlib.redirect_stdout(io.StringIO()):
        vcf2gdb.main([c.loader])
    return c


@pytest.fixture(scope="module")
def routes(tmp_path_factory):
    """The cut routes cohort, its scatter intervals and query files."""
    path = tmp_path_factory.mktemp("routes")
    c = _cohort(path, "routes_1000")
    intervals = T.scatter_intervals(c.region, MIX["intervals"])
    files = []
    for i, (lo, hi) in enumerate(intervals):
        q = path / f"scatter_{i}.json"
        q.write_text(json.dumps(query_doc(c, lo, hi)))
        files.append(str(q))
    return c, intervals, files


def _text(query_file: str, pack: bool) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        gdb_query.main(["-j", query_file] + list(MIX["args"])
                       + ["--device", "cpu"], pack=pack)
    return buf.getvalue()


def _attrs():
    return {k: getattr(FC.combine_block, k) for k in ATTRS}


def _counts():
    return {k: getattr(profile.COUNTS, k) for k in COUNTERS}


def _since(before: dict, now: dict) -> dict:
    return {k: now[k] - before[k] for k in before}


@pytest.mark.parametrize("interval", range(MIX["intervals"]))
def test_port_equals_phased_reference(routes, interval):
    """gdb_query --device cpu, pack off and on, against the phased
    reference, every record byte for byte."""
    c, intervals, files = routes
    lo, hi = intervals[interval]
    ref = reference.reference_lines(
        reference_phased.Cohort(c.vcfs, c.vid), lo, hi)
    assert len(ref) > 10
    for pack in (False, True):
        assert split_lines(_text(files[interval], pack)) == ref
    gts = {cell.split(":", 1)[0] for ln in ref
           for cell in ln.split("\t")[9:]}
    assert ".|." in gts and "./." in gts
    if ROUTE[interval] == "mixed":
        assert "." in gts
    if ROUTE[interval] == "general":
        assert max(ln.split("\t")[4].count(",") for ln in ref) >= 15


@pytest.mark.parametrize("interval", range(MIX["intervals"]))
def test_each_third_takes_its_route(routes, interval):
    """Over chunks of CHUNK records, each interval's blocks take its
    third's route, by `combine_block`'s attributes and the program
    counters alike."""
    c, intervals, _ = routes
    qp = QueryParams.from_file(c.query, 0)
    qp.column_ranges = [[intervals[interval]]]
    vid = VidMapper.from_files(c.vid, c.callsets)
    store = ws.open_array(c.workspace, c.array)
    qc = driver.make_query_config(qp, vid)
    a0, c0 = _attrs(), _counts()
    driver.run_vcf_query_block(store, qc, qp, vid, torch.device("cpu"),
                               pack=True, max_records_per_block=CHUNK)
    got, counted = _since(a0, _attrs()), _since(c0, _counts())
    assert counted == {"combine_blocks": got["blocks"],
                       "combine_general_blocks": got["general_path_blocks"],
                       "combine_mixed_blocks": got["mixed_blocks"]}
    assert got["blocks"] > 1
    route = ROUTE[interval]
    assert (got["mixed_blocks"] > 0) == (route == "mixed"), got
    assert (got["general_path_blocks"] > 0) == (route == "general"), got


@pytest.mark.parametrize("config,intervals", [
    ("human_1000", 8), ("autotetraploid_1000", 4), ("routes_1000", 6)])
def test_phased_reference_folds_to_reference(tmp_path, config, intervals):
    """On unphased cohorts the phased reference renders the bytes of
    `reference.Cohort`; on the routes cohort it differs from them by its
    `|` separators alone."""
    c = _cohort(tmp_path, config, n_records=120)
    plain = reference.Cohort(c.vcfs, c.vid)
    phased = reference_phased.Cohort(c.vcfs, c.vid)
    assert phased.phased == (config == "routes_1000")
    differ = 0
    for lo, hi in T.scatter_intervals(c.region, intervals):
        want = reference.reference_lines(plain, lo, hi)
        got = reference.reference_lines(phased, lo, hi)
        assert len(want) > 5
        assert [ln.replace("|", "/") for ln in got] == want
        differ += sum(a != b for a, b in zip(got, want))
    assert (differ > 0) == (config == "routes_1000")


def test_gt_text_keeps_each_separator():
    g = reference_phased.gt_text
    assert [g(t, True) for t in ("0", "0/1", "1|2", "0|1/2", ".", "./.")] \
        == [".", "./.", ".|.", ".|./.", ".", "./."]
    assert g("1|2", False) == "./."


@pytest.fixture
def tracing(monkeypatch):
    """Tracing on, no records before the test, off and cleared after."""
    monkeypatch.setattr(profile, "ENABLED", True)
    profile.clear()
    yield
    profile.clear()


def test_traced_general_span_and_route_counters(routes, tracing,
                                                monkeypatch):
    """With tracing on, over the mixed and the general thirds in chunks:
    one `device.combine.general` span inside `device.combine` for each
    general-path block, and each query root's tally of the three
    counters equals the change of `combine_block`'s attributes."""
    _, _, files = routes
    monkeypatch.setattr(driver, "run_vcf_query_block", functools.partial(
        driver.run_vcf_query_block, max_records_per_block=CHUNK))
    a0 = _attrs()
    for i in (2, 4, 5):
        _text(files[i], pack=True)
    got = _since(a0, _attrs())
    assert got["general_path_blocks"] > 0 and got["mixed_blocks"] > 0
    recs = profile.spans()
    by_id = {s.id: s for s in recs}
    general = [s for s in recs if s.name == "device.combine.general"]
    assert len(general) == got["general_path_blocks"]
    assert all(by_id[s.parent_id].name == "device.combine" for s in general)
    roots = [s for s in recs if s.parent_id is None and s.name == "query"]
    assert len(roots) == 3
    tally = {k: sum(r.counts.get(k, 0) for r in roots) for k in COUNTERS}
    assert tally == {"combine_blocks": got["blocks"],
                     "combine_general_blocks": got["general_path_blocks"],
                     "combine_mixed_blocks": got["mixed_blocks"]}
