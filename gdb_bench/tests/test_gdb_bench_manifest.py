"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import glob
import json
import math
import os
import re
import shutil

from gdb_bench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = manifest.load()


def _text_ok(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gdb_bench"]
    assert len(BENCH["command"]) <= 32
    assert all(_text_ok(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(manifest.ROOT,
                                        "BENCHMARK.json")) <= 64 << 10


def test_names_units_and_texts():
    entries = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
               + BENCH["per_layer"])
    for kind in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer"):
            if key in e:
                assert _text_ok(e[key]), (e["name"], key)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _text_ok(c["source"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)


def test_metrics_cells_exist_and_moves_are_reported():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m["workloads"]) <= cells
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        ends, layers = manifest.cell_metrics(BENCH, cell)
        assert "setup_s" in {m["name"] for m in ends} and len(ends) >= 2
        assert layers


def test_every_config_is_used_and_its_file_holds_it():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith("gdb_bench/")
        cfg = manifest.config(BENCH, c["name"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert set(c["reduced"]) == set(cfg["reduced"])
        assert set(c["reduced"]) <= set(cfg["generator"])


def test_every_entry_found_by_name():
    for w in BENCH["workloads"]:
        kind = manifest.kind_module(manifest.traffic(w["traffic"])["kind"])
        assert callable(kind.Driver) and callable(kind.control_intervals)
        assert callable(kind.FLOATS)
    for m in BENCH["per_layer"]:
        mod = manifest.metric_module(m["name"])
        assert callable(mod.read)


def test_every_reader_and_kind_file_loads():
    """Also those that no cell of BENCHMARK.json names now (the lookup
    kind and its readers, PERF.md §7)."""
    for path in glob.glob(os.path.join(manifest.BENCH_DIR, "metrics",
                                       "*.py")):
        assert callable(manifest.metric_module(
            os.path.basename(path)[:-3]).read)
    for path in glob.glob(os.path.join(manifest.BENCH_DIR, "kinds", "*.py")):
        kind = manifest.kind_module(os.path.basename(path)[:-3])
        assert callable(kind.Driver) and callable(kind.control_intervals)
    for path in glob.glob(os.path.join(manifest.BENCH_DIR, "traffic",
                                       "*.json")):
        mix = manifest.traffic(os.path.basename(path)[:-5])
        assert os.path.exists(os.path.join(manifest.BENCH_DIR, "kinds",
                                           mix["kind"] + ".py"))


def test_run_seconds_fit_the_check_with_24_cells():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_four_chip_cells_within_share():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, math.floor(0.25 * len(BENCH["workloads"])))


def _copy(tmp_path, monkeypatch):
    bench_dir = tmp_path / "gdb_bench"
    shutil.copytree(manifest.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    monkeypatch.setattr(manifest, "BENCH_DIR", str(bench_dir))
    return bench_dir


def test_a_new_metric_file_is_found_without_edits(tmp_path, monkeypatch):
    bench_dir = _copy(tmp_path, monkeypatch)
    (bench_dir / "metrics" / "new_metric.py").write_text(
        "SPANS = {}\n\ndef read(view):\n    return 1.5\n")
    (bench_dir / "traffic" / "new_mix.json").write_text(
        json.dumps({"kind": "scatter_combine", "intervals": 2,
                    "args": ["--produce-Broad-GVCF"]}))
    assert manifest.metric_module("new_metric").read(None) == 1.5
    assert manifest.traffic("new_mix")["intervals"] == 2
    # a quantity split per end-to-end metric reads the quantity's file
    assert manifest.metric_module("new_metric.serve").read(None) == 1.5


def test_a_new_traffic_kind_is_found_without_edits(tmp_path, monkeypatch):
    bench_dir = _copy(tmp_path, monkeypatch)
    (bench_dir / "kinds" / "new_kind.py").write_text(
        "FLOATS = str\n\nclass Driver:\n    pass\n\n"
        "def control_intervals(cohort, traffic, seed):\n"
        "    return [(0, traffic['n'])]\n")
    (bench_dir / "traffic" / "new_mix.json").write_text(
        json.dumps({"kind": "new_kind", "n": 7}))
    mix = manifest.traffic("new_mix")
    kind = manifest.kind_module(mix["kind"])
    assert kind.control_intervals(None, mix, 0) == [(0, 7)]
