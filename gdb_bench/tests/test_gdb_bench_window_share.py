"""The reader of `window_cell_share`: through a whole traced run on the
CPU, where each scatter query derives its tables from its column window
only, and on request tallies built by hand, with and without the
program's counters."""

import sys
import time

import pytest

pytest.importorskip("torch")

from gdb_bench import manifest  # noqa: E402
from gdb_bench.run import run_cell  # noqa: E402


def test_traced_run_reads_the_window_share(monkeypatch):
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
        res = run_cell(bench, cell, 2 ** 31 + 17, 0.5, True, "cpu",
                       time.perf_counter(), cfg=cfg)
        roots = [s for s in profile.spans()
                 if s.parent_id is None and s.name == "query"]
    finally:
        profile.disable()
        profile.clear()
    assert res["correct"] is True, res
    share = res["metrics"]["window_cell_share"]
    assert share["unit"] == "%"
    # eight intervals tile the region: a query's window is about an
    # eighth of the store, plus the cells that reach into it
    assert 0 < share["value"] < 50, share
    assert roots and all(
        0 < r.counts["window_cells"] < r.counts["store_cells"]
        for r in roots)


def _root(profile, sid, t0, t1, counts):
    s = profile.Span("query", {}, True)
    s.id, s.parent_id, s.request_id = sid, None, sid
    s.t0_ns, s.t1_ns, s.thread_id = int(t0 * 1e9), int(t1 * 1e9), 0
    s.counts = counts
    return s


def test_share_sums_the_tallies_and_reads_nothing_without_them(monkeypatch):
    from genomicsdb_tpu_torch.core import profile
    from gdb_bench.trace import Spans, TraceView
    W = manifest.metric_module("window_cell_share")
    profile.disable()
    harness = Spans()
    harness.add("query", 1.0, 2.0)
    harness.add("query", 2.0, 3.0)
    recs = [_root(profile, 1, 1.0, 2.0,
                  {"store_cells": 1000, "window_cells": 100}),
            _root(profile, 2, 2.0, 3.0,
                  {"store_cells": 1000, "window_cells": 160})]
    monkeypatch.setattr(profile, "spans", lambda: list(recs))
    view = TraceView(harness, {}, None, {"queries": 2}, {})
    assert W.read(view) == pytest.approx(13.0)
    # a program whose requests count no cells (the parent's) reads none
    for r in recs:
        r.counts = {"store_rebuilds": 19}
    assert W.read(TraceView(harness, {}, None, {"queries": 2}, {})) is None
    # nor does one without the tracer
    monkeypatch.setattr(profile, "spans", lambda: [])
    assert W.read(TraceView(harness, {}, None, {"queries": 2}, {})) is None
