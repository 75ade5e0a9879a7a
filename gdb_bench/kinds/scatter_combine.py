"""Traffic kind `scatter_combine`: in-process `gdb_query.main` over the
scatter's equal column intervals, in a closed loop of one client; the
VCF text is captured in memory.

Mix keys: `intervals` (how many equal intervals tile the region) and
`args` (the `gdb_query` arguments after `-j <query file>`; the run's
`--device` is appended).  Each call opens the workspace anew, as a
scatter worker does.  `check` compares every record of every query of
the window with the reference.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import time
from typing import Dict, List

from gdb_bench import traffic as T
from gdb_bench.drivers import (HostProbe, lines_wrong, log, make_cohort,
                               query_doc, split_lines)
from gdb_bench.reference import Cohort, format_float, reference_lines

# how the check renders a float field: the program's text, as htslib
# writes it
FLOATS = format_float
# one query before the window: the first query of a process loads the
# kernel library and the program's lazy state; a second reads as a
# window query does (PERF.md §2)
WARMUP_QUERIES = 1


def control_intervals(cohort, traffic: dict, seed: int):
    return T.scatter_intervals(cohort.region, traffic["intervals"])


class Driver:
    def __init__(self, cfg, traffic, seed, device, work):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.work = device, work
        self.done: List[dict] = []

    def setup(self) -> None:
        from genomicsdb_tpu_torch.tools import gdb_query
        self._main = gdb_query.main
        self.cohort = make_cohort(self.cfg, self.seed, self.work)
        self.intervals = T.scatter_intervals(self.cohort.region,
                                             self.traffic["intervals"])
        self.query_files = []
        for i, (lo, hi) in enumerate(self.intervals):
            path = os.path.join(self.work, f"scatter_{i}.json")
            with open(path, "w") as f:
                json.dump(query_doc(self.cohort, lo, hi), f)
            self.query_files.append(path)
        self.schedule = T.scatter_schedule(self.cohort.region,
                                           self.traffic["intervals"],
                                           self.seed)
        for _ in range(WARMUP_QUERIES):
            t0 = time.perf_counter()
            i = next(self.schedule)[0]
            self._query(i)
            log(f"set-up: warm-up query of interval {i} in "
                f"{time.perf_counter() - t0:.3f} s")

    def argv(self, i: int) -> List[str]:
        return (["-j", self.query_files[i]] + list(self.traffic["args"])
                + ["--device", self.device])

    def _query(self, i: int) -> str:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            self._main(self.argv(i))
        return buf.getvalue()

    def window(self, seconds: float, spans=None, marker=None) -> dict:
        marker = marker or contextlib.nullcontext
        probe = HostProbe()
        host = [probe.read()]
        with marker():
            t0 = time.perf_counter()
            deadline = t0 + seconds
            while time.perf_counter() < deadline:
                i, _ = next(self.schedule)
                a = time.perf_counter()
                text, err = None, None
                try:
                    text = self._query(i)
                except Exception as e:      # a failed query is counted
                    err = f"{type(e).__name__}: {e}"
                b = time.perf_counter()
                if spans is not None:
                    spans.add("query", a, b)
                host.append(probe.read())
                self.done.append({"interval": i, "t0": a, "t1": b,
                                  "text": text, "error": err})
            t1 = time.perf_counter()
        probe.close()
        for q, h0, h1 in zip(self.done, host, host[1:]):
            log(f"window: query of interval {q['interval']} in "
                f"{HostProbe.between(h0, h1)}")
        records = sum(q["text"].count("\n") for q in self.done
                      if q["text"] is not None)
        return {"window": (t0, t1),
                "attempted": len(self.done),
                "failed": sum(q["error"] is not None for q in self.done),
                "errors": [q["error"] for q in self.done if q["error"]][:3],
                "e2e": {"combine_records_per_s": records / (t1 - t0)},
                "counts": {"queries": len(self.done), "records": records}}

    def release(self) -> None:
        self._main = None

    def check(self) -> List[dict]:
        """Every record of every query of the window against the
        reference."""
        co = Cohort(self.cohort.vcfs, self.cohort.vid)
        refs: Dict[int, List[str]] = {}
        wrong = compared = 0
        for q in self.done:
            if q["text"] is None:
                continue
            lo, hi = self.intervals[q["interval"]]
            if q["interval"] not in refs:
                refs[q["interval"]] = reference_lines(co, lo, hi,
                                                      floats=FLOATS)
            ref = refs[q["interval"]]
            wrong += lines_wrong(split_lines(q["text"]), ref)
            compared += len(ref)
            q["text"] = None
        failed = sum(q["error"] is not None for q in self.done)
        return [{"name": "records_compared", "value": compared,
                 "limit": None},
                {"name": "queries_failed", "value": failed, "limit": 0},
                {"name": "records_wrong", "value": wrong, "limit": 0}]
