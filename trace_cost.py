#!/usr/bin/env python3
"""The cost of the port's tracer (`genomicsdb_tpu_torch.core.profile`)
on the scatter query: per-query wall time of `gdb_query.main` with
`profile.enable()` against `profile.disable()`, in one process on one
device.

    python3 trace_cost.py --device cuda --seed 3150000999 \\
        --configs human_1000:12,autotetraploid_1000:16 \\
        --out chiprun_out/trace_cost.json

For each configuration (`name:pairs`), the benchmark's scatter set-up
of the cell that runs it is made from `--seed` (cohort, import, query
files, one warm-up query); then `pairs` pairs of queries of one
interval, tracing on then off in even pairs, off then on in odd ones.
Prints the card's name and power limit, then for each configuration the
times, their medians, the median and mean of the pairs' on/off ratios
and the spans a traced query records; writes the same as JSON to
`--out`.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

from gdb_bench import manifest
from genomicsdb_tpu_torch.core import profile


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no card"


def measure(bench: dict, config: str, pairs: int, seed: int,
            device: str) -> dict:
    cell = next(w for w in bench["workloads"] if w["config"] == config
                and manifest.traffic(w["traffic"])["kind"]
                == "scatter_combine")
    traffic = manifest.traffic(cell["traffic"])
    work = tempfile.mkdtemp(prefix="trace_cost.")
    driver = manifest.kind_module("scatter_combine").Driver(
        manifest.config(bench, config), traffic, seed, device, work)
    times = {True: [], False: []}
    n_spans = []
    try:
        driver.setup()
        i = next(driver.schedule)[0]
        for k in range(pairs):
            for on in ((True, False) if k % 2 == 0 else (False, True)):
                profile.enable() if on else profile.disable()
                profile.clear()
                t0 = time.perf_counter()
                driver._query(i)
                times[on].append(time.perf_counter() - t0)
                if on:
                    n_spans.append(len(profile.spans()))
    finally:
        profile.disable()
        profile.clear()
        driver.release()
        shutil.rmtree(work, ignore_errors=True)
    ratios = [a / b for a, b in zip(times[True], times[False])]
    return {"cell": cell["name"], "interval": i, "pairs": pairs,
            "on_s": times[True], "off_s": times[False],
            "median_on_s": statistics.median(times[True]),
            "median_off_s": statistics.median(times[False]),
            "paired_ratio_median": statistics.median(ratios),
            "paired_ratio_mean": statistics.fmean(ratios),
            "spans_per_query": statistics.median(n_spans)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="trace_cost")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=3150000999)
    p.add_argument("--configs",
                   default="human_1000:12,autotetraploid_1000:16")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    bench = manifest.load()
    out = {"card": card(), "device": args.device, "seed": args.seed}
    print(out["card"], flush=True)
    for spec in args.configs.split(","):
        name, pairs = spec.split(":")
        got = measure(bench, name, int(pairs), args.seed, args.device)
        out[name] = got
        print(name, json.dumps({k: v for k, v in got.items()
                                if not k.endswith("_s")}), flush=True)
        print(name, "on", [round(t, 4) for t in got["on_s"]],
              "off", [round(t, 4) for t in got["off_s"]], flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
