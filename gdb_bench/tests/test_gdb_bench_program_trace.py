"""The readers of the program's own spans and counters, through a whole
traced run on the CPU: the five metrics that need no device trace have
values, and the window's program `query` roots are the harness's
queries.  The device-idle attribution on a timeline built by hand."""

import sys
import time
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

from gdb_bench import manifest  # noqa: E402
from gdb_bench.run import run_cell  # noqa: E402

PROGRAM_METRICS = ("rebuild_ms_per_query", "rebuilds_per_query",
                   "block_build_self_ms_per_block", "upload_ms_per_block",
                   "h2d_bytes_per_record")


def test_traced_run_reads_the_program_spans(monkeypatch):
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
        res = run_cell(bench, cell, 2 ** 31 + 11, 0.5, True, "cpu",
                       time.perf_counter(), cfg=cfg)
        roots = [s for s in profile.spans()
                 if s.parent_id is None and s.name == "query"]
        names = [s.name for s in profile.spans()]
    finally:
        profile.disable()
        profile.clear()
    assert res["correct"] is True, res
    got = {k: v["value"] for k, v in res["metrics"].items()}
    for name in PROGRAM_METRICS:
        assert name in got, (name, got)
    # each query opens the store anew: its tables are derived again
    assert got["rebuilds_per_query"] >= 8
    assert got["rebuild_ms_per_query"] > 0
    assert got["block_build_self_ms_per_block"] > 0
    assert got["upload_ms_per_block"] > 0
    assert got["h2d_bytes_per_record"] == 0       # a CPU run copies none
    assert "idle_unattributed_share" not in got   # no device trace
    assert len(roots) == res["attempted"] >= 1
    assert names.count("block.build") >= len(roots)


def _span(profile, sid, parent, name, t0, t1):
    s = profile.Span(name, {}, parent is None)
    s.id, s.parent_id, s.request_id = sid, parent, 1
    s.t0_ns, s.t1_ns, s.thread_id = int(t0 * 1e9), int(t1 * 1e9), 0
    return s


def test_idle_of_a_request_root_alone_is_unclaimed(monkeypatch):
    from genomicsdb_tpu_torch.core import profile
    from gdb_bench import program_trace as P
    from gdb_bench.trace import Spans, TraceView
    profile.disable()
    recs = [_span(profile, 2, 1, "block.build", 1.1, 1.5),
            _span(profile, 3, 2, "rebuild.dense_layout", 1.2, 1.3),
            _span(profile, 4, 1, "device.combine", 1.6, 1.7),
            _span(profile, 1, None, "query", 1.0, 2.0)]
    monkeypatch.setattr(profile, "spans", lambda: list(recs))
    harness = Spans()
    harness.add("query", 1.0, 2.0)
    dev = SimpleNamespace(window=(0.9, 2.1),
                          ops=[("kernel", 1.65, 1.7, True)])
    view = TraceView(harness, {}, dev, {"queries": 1}, {})
    got = P.idle_by_span(view)
    want = {"no span": 0.2, "query self, after its start": 0.1,
            "block.build": 0.3, "rebuild.dense_layout": 0.1,
            "query self, after block.build": 0.1, "device.combine": 0.05,
            "query self, after device.combine": 0.3}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert abs(got[k] - v) < 1e-6, (k, got[k], v)
    # no span, and the root's own time: 0.7 s of 1.15 s idle
    assert abs(P.unattributed_share(view) - 100 * 0.7 / 1.15) < 1e-6
    # a program without the tracer reads nothing
    monkeypatch.setattr(profile, "spans", lambda: [])
    view = TraceView(harness, {}, dev, {"queries": 1}, {})
    assert P.idle_by_span(view) is None
    assert P.unattributed_share(view) is None
