"""Spans, counters and the device trace of a `--trace 1` run.

Spans are taken from the benchmark's side: a wrapper put around a named
function of the program for the measured window only, timing each call
on the host clock (a call that returns a generator is timed until the
generator is exhausted).  Counters are the program's own function
attributes, read before and after the window.  The device trace is
`torch.profiler` over the window.

Which functions are wrapped and which counters are read is declared by
the per-layer metric readers (`gdb_bench/metrics/<name>.py`):

    SPANS = {"<span name>": "<module>:<attribute path>", ...}
    COUNTERS = {"<counter name>": "<module>:<attribute path>", ...}
    def on_call(span, args, kwargs, result, store): ...   # optional
    def read(view) -> float or None

`read` gets a `TraceView`; it returns None where the run had nothing
for the metric to read.
"""

from __future__ import annotations

import functools
import importlib
import inspect
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple


def resolve(target: str):
    """(owner object, attribute name) of "<module>:<a.b.c>"."""
    mod, _, path = target.partition(":")
    obj = importlib.import_module(mod)
    parts = path.split(".")
    for p in parts[:-1]:
        obj = getattr(obj, p)
    return obj, parts[-1]


def read_counter(target: str) -> float:
    owner, name = resolve(target)
    return float(getattr(owner, name))


class Spans:
    """Host-clock spans of wrapped functions: (name, start, end, thread)
    in `perf_counter` seconds."""

    def __init__(self):
        self.records: List[Tuple[str, float, float, int]] = []
        self._lock = threading.Lock()
        self._undo: List[Tuple[object, str, object]] = []

    def add(self, name: str, t0: float, t1: float) -> None:
        with self._lock:
            self.records.append((name, t0, t1, threading.get_ident()))

    def wrap(self, name: str, target: str,
             on_call: Optional[Callable] = None) -> None:
        owner, attr = resolve(target)
        inner = getattr(owner, attr)
        if isinstance(inner, staticmethod):      # pragma: no cover
            inner = inner.__func__
        spans = self

        @functools.wraps(inner)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            result = inner(*args, **kwargs)
            if inspect.isgenerator(result):
                return spans._timed(name, t0, result, on_call, args,
                                    kwargs)
            spans.add(name, t0, time.perf_counter())
            if on_call is not None:
                on_call(name, args, kwargs, result)
            return result

        setattr(owner, attr, wrapper)
        self._undo.append((owner, attr, inner))

    def _timed(self, name, t0, gen, on_call, args, kwargs):
        try:
            yield from gen
        finally:
            self.add(name, t0, time.perf_counter())
            if on_call is not None:
                on_call(name, args, kwargs, None)

    def unwrap(self) -> None:
        for owner, attr, inner in reversed(self._undo):
            setattr(owner, attr, inner)
        self._undo.clear()

    def durations(self, name: str) -> List[float]:
        return [t1 - t0 for n, t0, t1, _ in self.records if n == name]


def _union_s(intervals: List[Tuple[float, float]]) -> float:
    total, cur_a, cur_b = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


MARKER = "gdb_bench.window"


class DeviceTrace:
    """What `torch.profiler` recorded on the card in the window:
    kernel and copy intervals on the host's `perf_counter` clock."""

    def __init__(self, prof, marker_t: float, window: Tuple[float, float]):
        """`marker_t`: the host clock when the MARKER range opened;
        `window`: the measured window on the host clock."""
        self.window = window
        self.ops: List[Tuple[str, float, float, bool]] = []  # kernel?
        marker = None
        device_events = []
        for e in prof.events():
            if e.name == MARKER and marker is None \
                    and e.device_type.name == "CPU":
                marker = e
            # a range opened on the host is mirrored on the device's
            # timeline as an annotation: no operation ran in it
            if e.device_type.name == "CUDA" and e.name != MARKER \
                    and not getattr(e, "is_user_annotation", False):
                device_events.append(e)
        if marker is None:
            raise RuntimeError("the profiler recorded no window marker")
        # the profiler's microseconds -> perf_counter seconds
        off = marker_t - marker.time_range.start * 1e-6
        for e in device_events:
            a = e.time_range.start * 1e-6 + off
            b = e.time_range.end * 1e-6 + off
            name = e.name
            kernel = not name.startswith(("Memcpy", "Memset", "memcpy",
                                          "memset"))
            self.ops.append((name, a, b, kernel))

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        w0, w1 = self.window
        return _union_s([(max(a, w0), min(b, w1)) for _, a, b, _ in self.ops
                         if b > w0 and a < w1])

    def kernel_s(self) -> float:
        return sum(b - a for _, a, b, k in self.ops if k)

    def top_ops(self, n: int = 10) -> List[List]:
        by = defaultdict(float)
        for name, a, b, _ in self.ops:
            by[name] += b - a
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, spans: Spans, n: int = 10) -> List[List]:
        """The n longest stretches with no device operation, each named
        by the innermost benchmark span open on the host at its middle
        ("host" where none was)."""
        w0, w1 = self.window
        busy = sorted((max(a, w0), min(b, w1)) for _, a, b, _ in self.ops
                      if b > w0 and a < w1)
        gaps, t = [], w0
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < w1:
            gaps.append((t, w1))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            mid = (a + b) / 2
            open_ = [(t0, nm) for nm, t0, t1, _ in spans.records
                     if t0 <= mid <= t1]
            out.append([max(open_)[1] if open_ else "host", b - a])
        return out


class TraceView:
    """What a metric reader gets: the window's spans, counter deltas,
    device trace and the harness's own counts."""

    def __init__(self, spans: Spans, counters: Dict[str, float],
                 device: Optional[DeviceTrace], counts: Dict[str, float],
                 stores: Dict[str, dict]):
        self.spans = spans
        self.counters = counters
        self.device = device
        self.counts = counts
        self._stores = stores

    def store(self, metric: str) -> dict:
        return self._stores.setdefault(metric, {})

    def mean_ms(self, span: str, per: Optional[str] = None
                ) -> Optional[float]:
        """Total span time in ms over the harness count `per` (default:
        over the span's own calls); None where the span never ran."""
        d = self.spans.durations(span)
        if not d:
            return None
        n = self.counts.get(per, 0) if per else len(d)
        return 1e3 * sum(d) / n if n else None

    def idle_share(self) -> Optional[float]:
        if self.device is None or self.device.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.device.busy_s() / self.device.window_s)
