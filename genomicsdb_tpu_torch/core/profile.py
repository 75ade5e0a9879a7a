"""Profiling: phase timers + scan counters.

Equivalent of the reference's DO_PROFILING plane (include/utils/timer.h
Timer, query_variants.h:67-124 GTProfileStats, per-phase prints in
gt_mpi_gather.cc:74-93): wall+cpu timers with named phases and query
counters, printed to stderr when GENOMICSDB_TPU_PROFILE=1.
"""

from __future__ import annotations

import os
import sys
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict

ENABLED = os.environ.get("GENOMICSDB_TPU_PROFILE", "") not in ("", "0")

# reference timer taxonomy (gt_mpi_gather.cc:85-93)
PHASE_NAMES = [
    "array-query", "binary-serialization", "gather",
    "binary-deserialization", "json-printing",
    "fetch-from-vcf", "combining-cells", "flush-output",
]


class Timer:
    """Wall + CPU clock with interval accumulation (utils/timer.h)."""

    def __init__(self):
        self.wall = 0.0
        self.cpu = 0.0
        self._w0 = 0.0
        self._c0 = 0.0

    def start(self):
        self._w0 = time.perf_counter()
        self._c0 = time.process_time()

    def stop(self):
        self.wall += time.perf_counter() - self._w0
        self.cpu += time.process_time() - self._c0

    def print(self, label: str, fptr=sys.stderr):
        fptr.write(f"Wall-clock time(s) : {self.wall:.6f}\n"
                   f"Cpu time(s) : {self.cpu:.6f} for {label}\n")


class ProfileStats:
    """Per-query counters (GTProfileStats equivalent)."""

    COUNTERS = [
        "cells_traversed", "valid_cells", "attr_cells_accessed",
        "operator_invocations", "pq_flushes", "cells_in_left_sweep",
    ]

    def __init__(self):
        self.counters: Dict[str, int] = defaultdict(int)
        self.timers: Dict[str, Timer] = defaultdict(Timer)

    def bump(self, name: str, n: int = 1):
        self.counters[name] += n

    @contextmanager
    def phase(self, name: str):
        t = self.timers[name]
        t.start()
        try:
            yield
        finally:
            t.stop()

    def report(self, fptr=sys.stderr):
        for name, n in sorted(self.counters.items()):
            fptr.write(f"#{name} : {n}\n")
        for name, t in sorted(self.timers.items()):
            fptr.write(f"{name},{t.wall:.6f}s wall,{t.cpu:.6f}s cpu\n")


GLOBAL_STATS = ProfileStats()


def memory_measure() -> dict:
    """Resident/virtual memory of this process in bytes (the reference's
    utils memory_measure, which reads /proc/self/statm)."""
    try:
        with open("/proc/self/statm") as f:
            parts = f.read().split()
        page = os.sysconf("SC_PAGE_SIZE")
        return {"vm_bytes": int(parts[0]) * page,
                "resident_bytes": int(parts[1]) * page}
    except (OSError, IndexError, ValueError):
        return {"vm_bytes": 0, "resident_bytes": 0}


def maybe_report():
    if ENABLED:
        GLOBAL_STATS.report()
        mem = memory_measure()
        sys.stderr.write(
            f"memory,resident={mem['resident_bytes']}b,"
            f"vm={mem['vm_bytes']}b\n")
