"""`BENCHMARK.json` and the files it names, found by name:

    configuration <c>   gdb_bench/configs/<c>.json  (the entry's `file`)
    traffic mix <t>     gdb_bench/traffic/<t>.json
    traffic kind <k>    gdb_bench/kinds/<k>.py  (the mix's `kind`)
    per-layer metric m  gdb_bench/metrics/<m>.py, or for a name split
                        per end-to-end metric, `<q>.<part>`, the
                        quantity's reader gdb_bench/metrics/<q>.py

A later cell, mix or metric is a new file and a new entry; nothing here
changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List, Tuple

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def load(path: str = os.path.join(ROOT, "BENCHMARK.json")) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(ROOT, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    with open(os.path.join(BENCH_DIR, "traffic", f"{name}.json")) as f:
        return json.load(f)


def _load(package: str, name: str, path: str):
    spec = importlib.util.spec_from_file_location(
        f"gdb_bench.{package}." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_module(name: str):
    """The reader of per-layer metric `name`: its own file, or where a
    quantity is split per end-to-end metric (`<q>.<part>`, each part
    in the cells that report its end-to-end metric) the quantity's."""
    d = os.path.join(BENCH_DIR, "metrics")
    path = os.path.join(d, f"{name}.py")
    if not os.path.exists(path) and "." in name:
        path = os.path.join(d, name.rsplit(".", 1)[0] + ".py")
    return _load("metrics", name, path)


def kind_module(kind: str):
    """The traffic kind a mix names: `Driver` and `control_intervals`."""
    return _load("kinds", kind,
                 os.path.join(BENCH_DIR, "kinds", f"{kind}.py"))


def _in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(bench: dict, cell: str) -> Tuple[List[dict], List[dict]]:
    """(end-to-end, per-layer) metrics that the cell reports."""
    return ([m for m in bench["end_to_end"] if _in_cell(m, cell)],
            [m for m in bench["per_layer"] if _in_cell(m, cell)])


def units(bench: dict) -> Dict[str, str]:
    return {m["name"]: m["unit"]
            for m in bench["end_to_end"] + bench["per_layer"]}
