"""A traffic mix is data: the arguments a scatter mix names reach the
program's `gdb_query.main`, through a whole run on the CPU."""

import json
import shutil
import time

import pytest

pytest.importorskip("torch")

from gdb_bench import manifest  # noqa: E402
from gdb_bench.run import run_cell  # noqa: E402


def test_scatter_mix_args_reach_gdb_query(tmp_path, monkeypatch):
    from genomicsdb_tpu_torch.tools import gdb_query
    bench = manifest.load()
    bench_dir = tmp_path / "gdb_bench"
    shutil.copytree(manifest.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    args = ["--produce-Broad-GVCF", "--engine", "block", "-s", "5000"]
    (bench_dir / "traffic" / "scatter2_segments.json").write_text(
        json.dumps({"kind": "scatter_combine", "intervals": 2,
                    "args": args}))
    monkeypatch.setattr(manifest, "BENCH_DIR", str(bench_dir))
    seen = []
    inner = gdb_query.main

    def main(argv):
        seen.append(list(argv))
        return inner(argv)
    monkeypatch.setattr(gdb_query, "main", main)
    cell = {"name": "human1000.scatter2_segments", "config": "human_1000",
            "traffic": "scatter2_segments", "chips": 1}
    cfg = manifest.config(bench, "human_1000")
    cfg["generator"] = dict(cfg["generator"], n_samples=8, n_records=80)
    res = run_cell(bench, cell, 2 ** 31 + 5, 0.5, False, "cpu",
                   time.perf_counter(), cfg=cfg)
    assert res["correct"] is True, res
    assert len(seen) >= 2                   # the warm-up and the window
    for argv in seen:
        assert argv[0] == "-j" and argv[2:] == args + ["--device", "cpu"]
