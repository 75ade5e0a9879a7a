"""The routes cell (`routes1000.scatter_combine`) on the CPU at a small
size: its kind's check counts a phase separator flipped in the
program's text, its control reads above 0, a traced run reads the three
route metrics, and the readers find nothing in tallies without the
program's counters or span."""

import sys
import time

import pytest

pytest.importorskip("torch")

from gdb_bench import manifest  # noqa: E402
from gdb_bench.control import control_reading  # noqa: E402
from gdb_bench.run import run_cell  # noqa: E402

BENCH = manifest.load()
CELL = manifest.workload(BENCH, "routes1000.scatter_combine")
READERS = ("general_combine_ms_per_block", "general_block_share",
           "mixed_block_share")


def _cfg(n_samples=16, n_records=120):
    cfg = manifest.config(BENCH, "routes_1000")
    cfg["generator"] = dict(cfg["generator"], n_samples=n_samples,
                            n_records=n_records)
    return cfg


def test_check_counts_one_flipped_phase_separator(tmp_path):
    traffic = manifest.traffic(CELL["traffic"])
    kind = manifest.kind_module(traffic["kind"])
    driver = kind.Driver(_cfg(), traffic, 2 ** 31 + 7, "cpu", str(tmp_path))
    driver.setup()
    driver.window(1.0)
    texts = [q["text"] for q in driver.done]
    assert texts and all(t is not None for t in texts)
    checks = {c["name"]: c["value"] for c in driver.check()}
    assert checks["records_wrong"] == 0 and checks["queries_failed"] == 0
    assert checks["records_compared"] > 0
    at = next(i for i, t in enumerate(texts) if "|" in t)
    texts[at] = texts[at].replace("|", "/", 1)
    for q, t in zip(driver.done, texts):
        q["text"] = t
    assert {c["name"]: c["value"]
            for c in driver.check()}["records_wrong"] == 1
    driver.release()


def test_control_reads_above_zero():
    got = control_reading(BENCH, CELL, 2 ** 31 + 9, cfg=_cfg(24, 200))
    assert got["records"] > 100
    assert got["records_wrong_exact"] == 0
    assert got["records_wrong_control"] > 0


def test_traced_run_reads_the_route_metrics(monkeypatch):
    from genomicsdb_tpu_torch.core import profile
    # the helper turns the tracer on when it is imported: import it anew
    import gdb_bench
    monkeypatch.delitem(sys.modules, "gdb_bench.program_trace",
                        raising=False)
    monkeypatch.delattr(gdb_bench, "program_trace", raising=False)
    profile.disable()
    profile.clear()
    try:
        res = run_cell(BENCH, CELL, 2 ** 31 + 13, 3.0, True, "cpu",
                       time.perf_counter(), cfg=_cfg())
    finally:
        profile.disable()
        profile.clear()
    assert res["correct"] is True, res
    got = {k: res["metrics"][k]["value"] for k in READERS}
    assert got["general_combine_ms_per_block"] > 0
    assert 0 < got["general_block_share"] < 100
    assert 0 < got["mixed_block_share"] < 100


def _root(profile, sid, t0, t1, counts):
    s = profile.Span("query", {}, True)
    s.id, s.parent_id, s.request_id = sid, None, sid
    s.t0_ns, s.t1_ns, s.thread_id = int(t0 * 1e9), int(t1 * 1e9), 0
    s.counts = counts
    return s


@pytest.mark.parametrize("counts,want", [
    ([{"combine_blocks": 2, "combine_general_blocks": 1},
      {"combine_blocks": 2, "combine_mixed_blocks": 2}], (25.0, 50.0)),
    ([{"combine_blocks": 3}, {"combine_blocks": 1}], (0.0, 0.0)),
    ([{"store_rebuilds": 19}, {"block_grid_native": 2}], (None, None)),
])
def test_shares_sum_the_tallies(monkeypatch, counts, want):
    from genomicsdb_tpu_torch.core import profile
    from gdb_bench.trace import Spans, TraceView
    profile.disable()
    harness = Spans()
    harness.add("query", 1.0, 2.0)
    harness.add("query", 2.0, 3.0)
    recs = [_root(profile, i + 1, 1.0 + i, 2.0 + i, c)
            for i, c in enumerate(counts)]
    monkeypatch.setattr(profile, "spans", lambda: list(recs))
    view = TraceView(harness, {}, None, {"queries": 2}, {})
    got = tuple(manifest.metric_module(m).read(view)
                for m in ("general_block_share", "mixed_block_share"))
    assert got == want
    # no `device.combine.general` span among the records
    assert manifest.metric_module(
        "general_combine_ms_per_block").read(view) is None


def test_nothing_to_read_without_the_tracer(monkeypatch):
    from genomicsdb_tpu_torch.core import profile
    from gdb_bench.trace import Spans, TraceView
    profile.disable()
    monkeypatch.setattr(profile, "spans", lambda: [])
    harness = Spans()
    harness.add("query", 1.0, 2.0)
    view = TraceView(harness, {}, None, {"queries": 1}, {})
    assert all(manifest.metric_module(m).read(view) is None
               for m in READERS)
