"""What the traffic kinds share: the cohort made and imported in
set-up, the comparison of an answer's records with the reference, and
the host's own readings around a window.

A traffic kind is a file of its own, `gdb_bench/kinds/<kind>.py`, found
by the `kind` that a mix's data file names (`manifest.kind_module`).
It exports `Driver(cfg, traffic, seed, device, work)` with `setup()`,
`window(seconds, spans, marker)`, `release()` and `check()`;
`control_intervals(cohort, traffic, seed)`, the query intervals whose
answers a run of the kind judges; and `FLOATS`, how its check renders a
float field (`reference.format_float` or `reference.float_bits`).  The
last two are what the comparison's control (`gdb_bench.control`)
needs.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import resource
import sys
import time
from typing import List


def make_cohort(cfg: dict, seed: int, work: str):
    """The configuration's cohort, written from the seed and imported
    with the program's `vcf2gdb` (its output goes to stderr)."""
    from genomicsdb_tpu_torch.runtime import native_loader
    from genomicsdb_tpu_torch.tools import vcf2gdb

    from .cohort import write_cohort
    t0 = time.perf_counter()
    # the program's native text library, loaded (and built where it is
    # missing or older than its sources) before the import's threads
    # first ask for it: a thread that asks while another builds gets
    # none and parses in Python
    native_loader.get_lib()
    log(f"set-up: native library loaded in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    c = write_cohort(os.path.join(work, "cohort"), seed=seed,
                     **cfg["generator"])
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        vcf2gdb.main([c.loader])
    log(f"set-up: cohort written in {t1 - t0:.3f} s, imported in "
        f"{time.perf_counter() - t1:.3f} s (region {c.region + 1} "
        f"columns)")
    return c


def log(msg: str) -> None:
    print(f"gdb_bench: {msg}", file=sys.stderr, flush=True)


def lines_wrong(out: List[str], ref: List[str]) -> int:
    """Records of `ref` that `out` does not hold byte for byte at the
    same place, plus the records `out` has beyond `ref`."""
    same = sum(1 for a, b in zip(out, ref) if a == b)
    return max(len(out), len(ref)) - same


def split_lines(text: str) -> List[str]:
    out = text.split("\n")
    if out and out[-1] == "":
        out.pop()
    return out


def query_doc(cohort, lo: int, hi: int) -> dict:
    with open(cohort.query) as f:
        q = json.load(f)
    q["query_column_ranges"] = [{"range_list": [{"low": lo, "high": hi}]}]
    return q


def _host_cpu():
    """(steal, idle, total) jiffies of the machine, or None."""
    try:
        with open("/proc/stat") as f:
            v = [int(x) for x in f.readline().split()[1:]]
    except (OSError, ValueError):
        return None
    return (v[7] if len(v) > 7 else 0), v[3] + v[4], sum(v[:8])


def _rss_mb() -> float:
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
    except (OSError, ValueError):
        return float("nan")
    return pages * os.sysconf("SC_PAGE_SIZE") / 2 ** 20


class HostProbe:
    """The host's side of a stretch of the window, for the log only:
    this process's CPU seconds, its garbage collector's seconds, its
    resident memory and page faults, and the machine's stolen and idle
    CPU shares (from /proc/stat)."""

    def __init__(self):
        self.gc_s = 0.0
        self._gc_t0 = None
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase, _info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.gc_s += time.perf_counter() - self._gc_t0
            self._gc_t0 = None

    def read(self) -> dict:
        ru = resource.getrusage(resource.RUSAGE_SELF)
        return {"t": time.perf_counter(), "cpu": time.process_time(),
                "gc": self.gc_s, "rss": _rss_mb(), "minflt": ru.ru_minflt,
                "host": _host_cpu()}

    @staticmethod
    def between(a: dict, b: dict) -> str:
        wall = b["t"] - a["t"]
        out = (f"cpu {b['cpu'] - a['cpu']:.3f} s, gc {b['gc'] - a['gc']:.3f}"
               f" s, rss {b['rss']:.0f} MB, minflt "
               f"{b['minflt'] - a['minflt']}")
        if a["host"] and b["host"]:
            d = [y - x for x, y in zip(a["host"], b["host"])]
            if d[2] > 0:
                out += (f", machine steal {100 * d[0] / d[2]:.2f}% idle "
                        f"{100 * d[1] / d[2]:.2f}%")
        return f"{wall:.3f} s ({out})"

    def close(self) -> None:
        if self._on_gc in gc.callbacks:
            gc.callbacks.remove(self._on_gc)
