"""The port's tracer: spans, counters and the operator's report.

  span(name, **attrs)  a context manager that times one piece of work
                       on `time.perf_counter_ns()` and records
                       (id, parent_id, request_id, name, t0_ns, t1_ns,
                       thread_id, attrs) when it closes
  request(kind)        a root span with a new request id: every span
                       opened under it, at any depth, carries that id
  count(name, n=1)     adds n to `COUNTS.<name>` (always on); with
                       tracing on, also to the open request's tally,
                       kept on its root span's record (`counts`)
  enable(), disable()  tracing on / off; on at import when
                       GENOMICSDB_TPU_PROFILE is set (not "0")
  spans(), clear()     the closed spans' records; drop them
  totals(records)      calls, total and self time by span name
  maybe_report()       the operator's report on stderr, when the
                       environment turned tracing on: the spans and
                       counter changes since the previous report, whose
                       spans it then drops

The current span and request live in `contextvars`, so threads and
requests do not mix.  A span must close in the frame that opened it:
none is held across a `yield` (the block engine is a pipelined
generator, and a span held open there would parent the next chunk's
work).  With tracing off, `span()` and `request()` return one shared
no-op context manager after a single check: no clock is read and no
record is made.  Records are kept in memory up to `MAX_SPANS`; past it
a span is counted in `COUNTS.spans_dropped` and not stored.

`perf_counter_ns` is the clock `perf_counter` reads, so spans sit on
the timeline onto which `torch.profiler`'s device events are mapped.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import sys
import threading
import time
from collections import defaultdict
from typing import List

_FROM_ENV = os.environ.get("GENOMICSDB_TPU_PROFILE", "") not in ("", "0")
ENABLED = _FROM_ENV
MAX_SPANS = 1 << 17

_SPAN: contextvars.ContextVar = contextvars.ContextVar(
    "genomicsdb_tpu_torch.span", default=None)
_REQUEST: contextvars.ContextVar = contextvars.ContextVar(
    "genomicsdb_tpu_torch.request", default=None)
_IDS = itertools.count(1)
_REQUEST_IDS = itertools.count(1)
_RECORDS: List["Span"] = []


class _Counts:
    """The port's counters: one attribute each, 0 until first counted
    (so `COUNTS.<name>` reads 0 for a counter nothing has bumped)."""

    def __init__(self):
        self.h2d_bytes = 0           # bytes copied host -> device
        self.store_rebuilds = 0      # store- or layout-wide table misses
        self.kernel_builds = 0       # nvcc builds of the kernel library
        self.native_builds = 0       # make of the native text library
        self.spans_dropped = 0       # spans past MAX_SPANS
        self.store_cells = 0         # cells of the stores queries opened
        self.window_cells = 0        # cells their tables were derived over

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return 0


COUNTS = _Counts()
_COUNT_LOCK = threading.Lock()


def count(name: str, n: int = 1) -> None:
    with _COUNT_LOCK:           # the stream server counts from threads
        d = COUNTS.__dict__
        d[name] = d.get(name, 0) + n
    if ENABLED:
        root = _REQUEST.get()
        if root is not None:
            root.counts[name] = root.counts.get(name, 0) + n


class _Off:
    """The shared no-op span of a process with tracing off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


OFF = _Off()


class Span:
    """One span, its own record once closed.  `counts` is the request's
    tally on a root opened by `request()`, else None."""
    __slots__ = ("id", "parent_id", "request_id", "name", "t0_ns",
                 "t1_ns", "thread_id", "attrs", "counts", "_tokens")

    def __init__(self, name: str, attrs: dict, root: bool):
        self.name = name
        self.attrs = attrs
        self.counts = {} if root else None
        self.t1_ns = None

    def __enter__(self):
        self.id = next(_IDS)
        if self.counts is not None:
            self.parent_id = None
            self.request_id = next(_REQUEST_IDS)
            self._tokens = (_SPAN.set(self), _REQUEST.set(self))
        else:
            parent = _SPAN.get()
            self.parent_id = parent.id if parent is not None else None
            self.request_id = parent.request_id if parent is not None \
                else None
            self._tokens = (_SPAN.set(self),)
        self.thread_id = threading.get_ident()
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1_ns = time.perf_counter_ns()
        for var, tok in zip((_SPAN, _REQUEST), self._tokens):
            var.reset(tok)
        del self._tokens
        if len(_RECORDS) < MAX_SPANS:
            _RECORDS.append(self)
        else:
            count("spans_dropped")
        return False

    def __repr__(self):
        return (f"Span({self.name!r}, id={self.id}, "
                f"parent={self.parent_id}, request={self.request_id}, "
                f"{(self.t1_ns - self.t0_ns) / 1e6:.3f} ms)")


def span(name: str, **attrs):
    if not ENABLED:
        return OFF
    return Span(name, attrs, False)


def request(kind: str):
    if not ENABLED:
        return OFF
    return Span(kind, {}, True)


def rebuild(table: str):
    """The miss branch of a store- or layout-wide cache: counts
    `store_rebuilds` and returns the span `rebuild.<table>`."""
    count("store_rebuilds")
    return span("rebuild." + table)


def enable() -> None:
    global ENABLED
    ENABLED = True


def disable() -> None:
    global ENABLED
    ENABLED = False


def spans() -> List[Span]:
    """The closed spans' records, in the order they closed."""
    return list(_RECORDS)


def clear() -> None:
    _RECORDS.clear()


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


def totals(records: List[Span]) -> dict:
    """{span name: (calls, total ns, self ns)} of `records`: self time is
    the total less the time its child spans among `records` cover."""
    child_ns = defaultdict(int)
    for s in records:
        if s.parent_id is not None:
            child_ns[s.parent_id] += s.t1_ns - s.t0_ns
    out = {}
    for s in records:
        d = s.t1_ns - s.t0_ns
        n, t, own = out.get(s.name, (0, 0, 0))
        out[s.name] = (n + 1, t + d, own + d - child_ns[s.id])
    return out


_REPORTED: dict = {}            # the counters at the previous report


def _report(fptr, records: List[Span]) -> None:
    """Each span name with its calls, total wall time and self time,
    then every counter's change since the previous report, then
    memory."""
    for name, (n, total, own) in sorted(totals(records).items()):
        fptr.write(f"{name},{n} calls,{total / 1e9:.6f}s wall,"
                   f"{own / 1e9:.6f}s self\n")
    now = dict(vars(COUNTS))
    for name, n in sorted(now.items()):
        fptr.write(f"#{name} : {n - _REPORTED.get(name, 0)}\n")
    _REPORTED.update(now)
    mem = memory_measure()
    fptr.write(f"memory,resident={mem['resident_bytes']}b,"
               f"vm={mem['vm_bytes']}b\n")


def maybe_report() -> None:
    """The report, when GENOMICSDB_TPU_PROFILE turned tracing on (a
    process that enabled it through `enable()` prints nothing).  Each
    report covers its own call: the spans it printed are dropped, and
    counters read as their change since the previous report."""
    if _FROM_ENV:
        recs = spans()
        del _RECORDS[:len(recs)]        # a span closed since stays
        _report(sys.stderr, recs)
