"""The mesh cell's traffic kind (`kinds/mesh_combine.py`) through whole
runs on the CPU at a small size: a world of four gloo rank processes
(rank 0 this process, ranks 1-3 `gdb_bench/mesh_rank.py`) kept up for
the run.  A sound run is correct and ends its world; a fault in one
helper rank's rows reads records wrong; a helper that exits, or a
failing rank 0, ends the run and every rank fast; a traced run reads
the cell's per-layer metrics, with the mesh laid out before the
window."""

import os
import sys
import time

import pytest

pytest.importorskip("torch")

from gdb_bench import manifest  # noqa: E402
from gdb_bench.run import run_cell  # noqa: E402

BENCH = manifest.load()
CELL = "human1000.mesh_2x2"
MESH_METRICS = ("mesh_joins_per_window", "collective_ms_per_block",
                "collective_bytes_per_record")
LAUNCHER = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_PORT")


def _run(fault=None, trace=False, seconds=2.0):
    """(result, the run's driver, seconds) of a small run of the cell."""
    cell = manifest.workload(BENCH, CELL)
    cfg = manifest.config(BENCH, cell["config"])
    cfg["generator"] = dict(cfg["generator"], n_samples=16, n_records=120)
    seen = []

    def hook(driver):
        seen.append(driver)
        if fault is not None:
            fault(driver)
    t0 = time.monotonic()
    res = run_cell(BENCH, cell, 2 ** 31 + 17, seconds, trace, "cpu",
                   time.perf_counter(), cfg=cfg, fault=hook)
    return res, seen[0], time.monotonic() - t0


def _helpers_ended(driver):
    return all(p.poll() is not None for p in driver.procs)


# -- the faults, called in a helper rank (`mesh_rank` {"call": ...}) --
def break_rows():
    """This rank's shard of the PL outputs, one higher."""
    from genomicsdb_tpu_torch.parallel import sharded
    inner = sharded.combine_shard

    def combine_shard(*a, **k):
        out = inner(*a, **k)
        out["pl"][..., 0] += 1
        return out
    sharded.combine_shard = combine_shard


def exit_in_combine():
    """This rank exits 3 in its next combine, inside the query."""
    from genomicsdb_tpu_torch.parallel import sharded
    sharded.combine_shard = lambda *a, **k: os._exit(3)


def test_mesh_run_is_correct_and_ends_its_world():
    import torch.distributed as dist
    before = {k: os.environ.get(k) for k in LAUNCHER}
    res, driver, _ = _run()
    assert res["correct"] is True, res
    assert res["checks"]["records_wrong"]["value"] == 0
    assert res["checks"]["queries_failed"]["value"] == 0
    assert res["attempted"] >= 1 and res["counted"]["records_compared"] > 0
    assert driver.backend == "gloo" and len(driver.procs) == 3
    assert [p.returncode for p in driver.procs] == [0, 0, 0]
    assert not dist.is_initialized()
    assert {k: os.environ.get(k) for k in LAUNCHER} == before


@pytest.mark.parametrize("rank", [1, 3])
def test_mesh_fault_in_a_helper_ranks_rows_is_not_correct(rank):
    """Rank 1 holds the second half of the first pos group's samples,
    rank 3 the second pos group's."""
    res, driver, _ = _run(lambda d: d.call_on(rank, __file__, "break_rows"))
    assert res["correct"] is False
    assert res["checks"]["records_wrong"]["value"] > 0
    assert res["checks"]["queries_failed"]["value"] == 0


def test_mesh_helper_exit_ends_the_run_fast():
    res, driver, seconds = _run(
        lambda d: d.call_on(2, __file__, "exit_in_combine"), seconds=30.0)
    assert res["correct"] is False
    assert res["failed"] == 1 and res["attempted"] == 1
    assert "mesh" in driver.broken or "rank" in driver.broken
    assert driver.procs[1].returncode == 3
    assert _helpers_ended(driver)
    assert seconds < 60


def test_mesh_rank0_failure_ends_the_helpers(monkeypatch):
    from genomicsdb_tpu_torch.parallel import sharded

    def fault(driver):
        def combine_shard(*a, **k):
            raise RuntimeError("rank 0's combine fails")
        monkeypatch.setattr(sharded, "combine_shard", combine_shard)
    res, driver, seconds = _run(fault, seconds=30.0)
    assert res["correct"] is False and res["failed"] == 1
    assert "rank 0's combine fails" in res["errors"][0]
    assert _helpers_ended(driver)
    assert seconds < 60


def test_mesh_traced_run_reads_the_mesh_metrics(monkeypatch):
    from genomicsdb_tpu_torch.core import profile
    # the helper turns the tracer on when it is imported: import it anew
    import gdb_bench
    monkeypatch.delitem(sys.modules, "gdb_bench.program_trace",
                        raising=False)
    monkeypatch.delattr(gdb_bench, "program_trace", raising=False)
    profile.disable()
    profile.clear()
    try:
        res, _, _ = _run(trace=True)
    finally:
        profile.disable()
        profile.clear()
    assert res["correct"] is True, res
    got = {k: v["value"] for k, v in res["metrics"].items()}
    # every per-layer metric of the cell but the device trace's (none on
    # the CPU): the mesh's own and those of the layers rank 0 runs
    _, layer_defs = manifest.cell_metrics(BENCH, CELL)
    want = {m["name"] for m in layer_defs if m["source"] != "device_trace"}
    assert set(MESH_METRICS) < want
    assert set(got) == want, got
    # laid out once, by the warm-up query
    assert got["mesh_joins_per_window"] == 0
    assert got["collective_ms_per_block"] > 0
    assert got["collective_bytes_per_record"] > 0


def test_mesh_readers_read_nothing_without_the_programs_counters(
        monkeypatch):
    """Against a program that builds its mesh per query (no
    `mesh_joins`, no `collective_bytes`, no collective spans) each
    reader returns None."""
    from types import SimpleNamespace

    from genomicsdb_tpu_torch.core import profile
    # importing the readers' helpers turns the tracer on: off again after
    monkeypatch.setattr(profile, "ENABLED", profile.ENABLED)
    from gdb_bench import mesh_trace
    from gdb_bench.trace import Spans, TraceView
    s = profile.Span("query", {}, True)
    s.id, s.parent_id, s.request_id = 1, None, 1
    s.t0_ns, s.t1_ns, s.thread_id = int(1.1e9), int(1.9e9), 0
    s.counts = {"h2d_bytes": 10}
    monkeypatch.setattr(profile, "spans", lambda: [s])
    monkeypatch.setattr(profile, "COUNTS", SimpleNamespace(h2d_bytes=10))
    harness = Spans()
    harness.add("query", 1.0, 2.0)
    view = TraceView(harness, {}, None, {"queries": 1, "records": 5}, {})
    assert not mesh_trace.counted("mesh_joins")
    for name in MESH_METRICS:
        assert manifest.metric_module(name).read(view) is None, name
