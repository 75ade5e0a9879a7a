"""Render the port's bench result (`python -m genomicsdb_tpu_torch.bench`,
which writes `build/genomicsdb_tpu_torch/bench.json`) as a markdown table
of its headline figures.

The bench calls `write_table` on the file it has just written, so the
table beside the JSON always renders that run.  The rows, their order
and their value formatting are the JAX package's `tools/perf_table`;
the labels name the port's lanes and commands, and the card is the one
the JSON names (its `card` key).  The table goes beside the JSON
(`perf_table.md`) and never under the repository's `docs/`, which holds
the TPU rounds' table.

Usage: python -m genomicsdb_tpu_torch.tools.perf_table [bench.json]
"""

from __future__ import annotations

import argparse
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_BENCH = os.path.join(ROOT, "build", "genomicsdb_tpu_torch",
                             "bench.json")
DOCS = os.path.join(ROOT, "docs")
BENCH_CMD = "python -m genomicsdb_tpu_torch.bench"
TOOL_CMD = "python -m genomicsdb_tpu_torch.tools."


def _get(d, *keys):
    cur = d
    for k in keys:
        if not isinstance(cur, dict) or k not in cur:
            return None
        cur = cur[k]
    return cur


def _fmt(v, nd=2):
    if v is None:
        return "—"
    if isinstance(v, float):
        if abs(v) >= 1e6:
            return f"{v / 1e6:.2f} M"
        if abs(v) >= 1e3 and abs(v) == int(abs(v)):
            return f"{v:,.0f}"
        return f"{v:.{nd}f}"
    if isinstance(v, int) and abs(v) >= 1e6:
        return f"{v / 1e6:.2f} M"
    return str(v)


def render(bench: dict) -> str:
    d = bench.get("detail", bench)
    card = bench.get("card") or "card not named"
    rows = [
        (f"Combine kernel (CUDA gather+remap, {card})",
         "positions/s", _get(d, "device_fused_pallas",
                             "positions_per_sec"),
         f"`{BENCH_CMD} --lanes device_fused` → `device_fused_pallas`"),
        ("Combine kernel, 1024-sample width",
         "cells/s", _get(d, "device_fused_wide_1024_samples",
                         "cells_per_sec"),
         f"`{BENCH_CMD} --lanes device_fused_wide_1024_samples`"),
        ("End-to-end query (100-sample cohort, warm)",
         "positions/s", _get(d, "cohort100_end_to_end",
                             "end_to_end_positions_per_sec"),
         f"`{BENCH_CMD} --lanes cohort100_end_to_end`"),
        ("Native import (20k-record × 8-sample cohort)",
         "cells/s", _get(d, "import", "native_cells_per_sec"),
         f"`{BENCH_CMD} --lanes import`"),
        ("Native import with AS_* 2-D annotations",
         "cells/s", _get(d, "import", "asa", "native_cells_per_sec"),
         f"`{BENCH_CMD} --lanes import` → `import.asa`"),
        ("Wide cohort (1000 samples): full scan, engine",
         "cells/s", _get(d, "wide_cohort_1000", "cells_per_sec"),
         f"`{TOOL_CMD}wide_cohort_bench --skip-seq`"),
        ("Wide cohort: 10 kb interval p50 (served)",
         "ms", _get(d, "wide_cohort_1000", "interval_10kb_p50_ms"),
         "same tool → `interval_10kb_p50_ms`"),
        ("Wide cohort: 10 kb interval p50 (engine)",
         "ms", _get(d, "wide_cohort_1000",
                    "interval_10kb_engine_p50_ms"),
         "same tool → `interval_10kb_engine_p50_ms`"),
        ("Socket stream: one-shot 10 kb query p50",
         "ms", _get(d, "stream_latency", "socket_p50_ms"),
         f"`{TOOL_CMD}stream_latency_bench`"),
        ("Socket stream: persistent connection p50 (served)",
         "ms", _get(d, "stream_latency", "persistent_p50_ms"),
         "same tool → `persistent_p50_ms`"),
        ("Socket stream: persistent p50 (engine, no serving index)",
         "ms", _get(d, "stream_latency", "engine_persistent_p50_ms"),
         "same tool → `engine_persistent_p50_ms`"),
        ("Rank scaling ×4: warm pool wall efficiency",
         "%", _get(d, "process_scaling", "ranks", "4",
                   "efficiency_pct"),
         f"`{TOOL_CMD}scaling_bench --records 600000`"),
        ("Rank scaling ×4: per-job spawn wall efficiency",
         "%", _get(d, "process_scaling", "ranks", "4",
                   "efficiency_spawn_pct"),
         "same tool → `efficiency_spawn_pct`"),
        ("Rank scaling ×4: spawn compute efficiency",
         "%", _get(d, "process_scaling", "ranks", "4",
                   "efficiency_compute_pct"),
         "same tool → `efficiency_compute_pct`"),
        ("Out-of-core 2 GB partition: peak RSS / partition",
         "×", _get(d, "out_of_core", "rss_over_partition"),
         f"`{TOOL_CMD}ooc_bench`"),
        ("vs C++ sequential baseline (1 core)",
         "×", bench.get("vs_baseline"),
         f"`{BENCH_CMD}` → `vs_baseline`"),
        ("vs C++ sequential baseline (all cores)",
         "×", bench.get("vs_baseline_mt"),
         f"`{BENCH_CMD}` → `vs_baseline_mt`"),
    ]
    out = [
        "# Headline performance of the port (generated — do not edit)",
        "",
        f"Source: the bench JSON written by `{BENCH_CMD}`",
        "(default `build/genomicsdb_tpu_torch/bench.json`), rendered by",
        "`genomicsdb_tpu_torch.tools.perf_table` after every bench run.",
        f"Card: {card}.",
        "",
        "| metric | value | unit | reproduce |",
        "|---|---|---|---|",
    ]
    for name, unit, val, cmd in rows:
        out.append(f"| {name} | {_fmt(val)} | {unit} | {cmd} |")
    chip = _get(d, "chip_lane")
    if chip and "passed" in chip:
        out.append("")
        out.append(f"Card test lane: {chip.get('passed')} passed, "
                   f"{chip.get('failed')} failed, "
                   f"{chip.get('skipped')} skipped "
                   "(`pytest -m gpu tests/test_torch_gpu_lane.py`).")
    return "\n".join(out) + "\n"


def write_table(bench_path: str, out_path: str = None) -> str:
    """Render `bench_path` to `out_path` (default: `perf_table.md`
    beside it); returns the path written.  A path under the
    repository's `docs/` is refused."""
    with open(bench_path) as f:
        bench = json.load(f)
    text = render(bench)
    if out_path is None:
        out_path = os.path.join(os.path.dirname(
            os.path.abspath(bench_path)), "perf_table.md")
    out_path = os.path.abspath(out_path)
    if os.path.commonpath([out_path, DOCS]) == DOCS:
        raise ValueError(f"perf_table: {out_path} is under docs/, which "
                         "holds the TPU rounds' table")
    with open(out_path, "w") as f:
        f.write(text)
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="perf_table",
        description="Render the port's bench JSON as a markdown table.")
    p.add_argument("bench_json", nargs="?", default=DEFAULT_BENCH,
                   help="the bench JSON (default "
                        "build/genomicsdb_tpu_torch/bench.json); the "
                        "table goes beside it as perf_table.md")
    args = p.parse_args(argv)
    print(write_table(args.bench_json))


if __name__ == "__main__":
    main()
