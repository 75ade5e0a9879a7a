"""The readers of `host_output_bytes_per_record` and
`fetch_fill_ms_per_block`: through a whole traced run on the CPU with
the fetch pack forced on (the card's default), where every block takes
the variant-row split fetch, and on request tallies built by hand,
without the program's counter and span."""

import functools
import sys
import time

import pytest

pytest.importorskip("torch")

from gdb_bench import manifest  # noqa: E402
from gdb_bench.run import run_cell  # noqa: E402

READERS = ("host_output_bytes_per_record", "fetch_fill_ms_per_block")


def test_traced_packed_run_reads_the_fetch_metrics(monkeypatch):
    from genomicsdb_tpu_torch.core import profile
    from genomicsdb_tpu_torch.query import block_writer as BW
    from genomicsdb_tpu_torch.tools import gdb_query
    # the helper turns the tracer on when it is imported: import it anew
    import gdb_bench
    monkeypatch.delitem(sys.modules, "gdb_bench.program_trace",
                        raising=False)
    monkeypatch.delattr(gdb_bench, "program_trace", raising=False)
    monkeypatch.setattr(gdb_query, "main",
                        functools.partial(gdb_query.main, pack=True))
    profile.disable()
    profile.clear()
    bench = manifest.load()
    cell = manifest.workload(bench, "autotetraploid1000.scatter_combine")
    cfg = manifest.config(bench, "autotetraploid_1000")
    cfg["generator"] = dict(cfg["generator"], n_samples=8, n_records=80)
    split0 = BW.render_block_vcf_pipelined.split_blocks
    try:
        res = run_cell(bench, cell, 2 ** 31 + 37, 0.5, True, "cpu",
                       time.perf_counter(), cfg=cfg)
        fills = [s for s in profile.spans()
                 if s.name == "device.fetch.fill"]
    finally:
        profile.disable()
        profile.clear()
    assert res["correct"] is True, res
    assert BW.render_block_vcf_pipelined.split_blocks > split0
    got = {k: v["value"] for k, v in res["metrics"].items()}
    for name in READERS:
        assert name in got, (name, got)
        assert got[name] > 0, (name, got)
    assert res["metrics"]["host_output_bytes_per_record"]["unit"] \
        == "B/record"
    assert fills


def _root(profile, sid, counts):
    s = profile.Span("query", {}, True)
    s.id, s.parent_id, s.request_id = sid, None, sid
    s.t0_ns, s.t1_ns, s.thread_id = int(1.1e9), int(1.9e9), 0
    s.counts = counts
    return s


@pytest.mark.parametrize("counts,want", [
    ({"host_output_bytes": 5000}, 50.0),
    ({"h2d_bytes": 5000}, None),          # a program without the counter
])
def test_nothing_to_read_without_the_programs_counter_and_span(
        monkeypatch, counts, want):
    from genomicsdb_tpu_torch.core import profile
    from gdb_bench.trace import Spans, TraceView
    H = manifest.metric_module("host_output_bytes_per_record")
    F = manifest.metric_module("fetch_fill_ms_per_block")
    profile.disable()
    harness = Spans()
    harness.add("query", 1.0, 2.0)
    recs = [_root(profile, 1, counts)]
    monkeypatch.setattr(profile, "spans", lambda: list(recs))
    view = TraceView(harness, {}, None, {"queries": 1, "records": 100}, {})
    assert H.read(view) == (pytest.approx(want) if want else None)
    assert F.read(view) is None           # no device.fetch.fill span
