"""Traffic kind `scatter_combine_phased`: the scatter of
`scatter_combine`, judged against the reference that keeps each call's
GT phase separators (`gdb_bench/reference_phased.py`), for cohorts
whose vid stores GT's phase.

Mix keys, the window and the rate are `scatter_combine`'s.  Set-up is
too, then queries every interval once more: the intervals take
different routes (the diploid and mixed-ploidy kernel families, the
general step), and a route loads its code on first use, the kernel
library's build included, which belongs to set-up and not to the
window.  `check` differs in the reference it builds.
"""

from __future__ import annotations

import time
from typing import Dict, List

from gdb_bench import manifest
from gdb_bench.drivers import lines_wrong, log, split_lines
from gdb_bench.reference import reference_lines
from gdb_bench.reference_phased import Cohort

_scatter = manifest.kind_module("scatter_combine")
FLOATS = _scatter.FLOATS
control_intervals = _scatter.control_intervals
WARMUP_QUERIES = _scatter.WARMUP_QUERIES


class Driver(_scatter.Driver):
    def setup(self) -> None:
        super().setup()
        for i in range(len(self.intervals)):
            t0 = time.perf_counter()
            self._query(i)
            log(f"set-up: warm-up query of interval {i} in "
                f"{time.perf_counter() - t0:.3f} s")

    def check(self) -> List[dict]:
        """Every record of every query of the window against the
        phased reference."""
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
