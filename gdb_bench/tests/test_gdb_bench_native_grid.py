"""The reader of `native_grid_share`: through a whole traced run on the
CPU, where every block's grid runs natively, and on request tallies
built by hand, with and without the program's counters."""

import sys
import time

import pytest

pytest.importorskip("torch")

from gdb_bench import manifest  # noqa: E402
from gdb_bench.run import run_cell  # noqa: E402


def test_traced_run_reads_every_grid_native(monkeypatch):
    from genomicsdb_tpu_torch.core import profile
    # the helper turns the tracer on when it is imported: import it anew
    import gdb_bench
    monkeypatch.delitem(sys.modules, "gdb_bench.program_trace",
                        raising=False)
    monkeypatch.delattr(gdb_bench, "program_trace", raising=False)
    profile.disable()
    profile.clear()
    bench = manifest.load()
    cell = manifest.workload(bench, "human1000.scatter_combine")
    cfg = manifest.config(bench, "human_1000")
    cfg["generator"] = dict(cfg["generator"], n_samples=8, n_records=80)
    try:
        res = run_cell(bench, cell, 2 ** 31 + 29, 0.5, True, "cpu",
                       time.perf_counter(), cfg=cfg)
        roots = [s for s in profile.spans()
                 if s.parent_id is None and s.name == "query"]
    finally:
        profile.disable()
        profile.clear()
    assert res["correct"] is True, res
    share = res["metrics"]["native_grid_share"]
    assert share["unit"] == "%"
    assert share["value"] == 100.0, share
    assert roots and all(r.counts["block_grid_native"] > 0
                         and not r.counts.get("block_grid_numpy")
                         for r in roots)


def _root(profile, sid, t0, t1, counts):
    s = profile.Span("query", {}, True)
    s.id, s.parent_id, s.request_id = sid, None, sid
    s.t0_ns, s.t1_ns, s.thread_id = int(t0 * 1e9), int(t1 * 1e9), 0
    s.counts = counts
    return s


@pytest.mark.parametrize("counts,want", [
    ([{"block_grid_native": 4}, {"block_grid_native": 3}], 100.0),
    ([{"block_grid_numpy": 4}, {"block_grid_numpy": 3}], 0.0),
    ([{"block_grid_native": 3}, {"block_grid_numpy": 1}], 75.0),
    ([{"store_rebuilds": 19}, {"store_rebuilds": 19}], None),
])
def test_share_sums_the_tallies(monkeypatch, counts, want):
    from genomicsdb_tpu_torch.core import profile
    from gdb_bench.trace import Spans, TraceView
    G = manifest.metric_module("native_grid_share")
    profile.disable()
    harness = Spans()
    harness.add("query", 1.0, 2.0)
    harness.add("query", 2.0, 3.0)
    recs = [_root(profile, i + 1, 1.0 + i, 2.0 + i, c)
            for i, c in enumerate(counts)]
    monkeypatch.setattr(profile, "spans", lambda: list(recs))
    view = TraceView(harness, {}, None, {"queries": 2}, {})
    got = G.read(view)
    assert got == (pytest.approx(want) if want is not None else None)


def test_nothing_to_read_without_the_tracer(monkeypatch):
    from genomicsdb_tpu_torch.core import profile
    from gdb_bench.trace import Spans, TraceView
    G = manifest.metric_module("native_grid_share")
    profile.disable()
    harness = Spans()
    harness.add("query", 1.0, 2.0)
    monkeypatch.setattr(profile, "spans", lambda: [])
    assert G.read(TraceView(harness, {}, None, {"queries": 1}, {})) is None
