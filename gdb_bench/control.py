"""The comparison's control: the plain reference computed in the
nearest lower precision (float fields in bfloat16, the DP sum in
int16), put in the program's place and judged as a run judges the
program, at the cell's own size.

    python3 -m gdb_bench.control --workload <name> --seeds <n> [<n> ...]

For each seed it makes the cell's cohort, takes the intervals whose
answers a run judges (the traffic kind's `control_intervals`: every
interval of a scatter; a lookup cell's sample, drawn as a run draws
it), compares them as the kind does (a lookup's floats as float32
bits), and prints one JSON line: the exact reference's `records_wrong`
against itself (0) and the control's.  It runs on the host and needs no
card; the program is not run.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

from . import manifest
from .cohort import write_cohort
from .drivers import lines_wrong
from .reference import Cohort, reference_lines


def control_reading(bench: dict, cell: dict, seed: int, cfg=None) -> dict:
    cfg = cfg or manifest.config(bench, cell["config"])
    work = tempfile.mkdtemp(prefix="gdb_bench.control.")
    try:
        c = write_cohort(work, seed=seed, **cfg["generator"])
        co = Cohort(c.vcfs, c.vid)
        tr = manifest.traffic(cell["traffic"])
        kind = manifest.kind_module(tr["kind"])
        floats = kind.FLOATS
        t0 = time.perf_counter()
        exact = low = records = 0
        for lo, hi in kind.control_intervals(c, tr, seed):
            ref = reference_lines(co, lo, hi, floats=floats)
            exact += lines_wrong(reference_lines(co, lo, hi, floats=floats),
                                 ref)
            low += lines_wrong(reference_lines(co, lo, hi, "low", floats),
                               ref)
            records += len(ref)
        return {"workload": cell["name"], "seed": seed, "records": records,
                "records_wrong_exact": exact, "records_wrong_control": low,
                "seconds": time.perf_counter() - t0}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gdb_bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    bench = manifest.load()
    cell = manifest.workload(bench, args.workload)
    for seed in args.seeds:
        print(json.dumps(control_reading(bench, cell, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
