"""The program's own spans and counters (its tracer,
`genomicsdb_tpu_torch.core.profile`), for the per-layer readers of a
`--trace 1` run.

Importing this module turns the program's tracer on.  The harness
imports a cell's readers, and through them this module, only in a
`--trace 1` run, after set-up and before the window (`run.Tracer`): so
the program traces the window and nothing before it.

The window's program spans are those inside the harness's own `query`
spans (`view.spans`); the window's queries are the program's `query`
roots among them, and a counter's window value is the sum of those
roots' tallies (the counts made under each request).  Against a
program without the tracer every helper returns None, and so does each
reader.
"""

from __future__ import annotations

import bisect
import sys
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

try:
    from genomicsdb_tpu_torch.core import profile as _profile
except ImportError:             # pragma: no cover
    _profile = None

if hasattr(_profile, "enable"):
    _profile.enable()

NO_SPAN = "no span"


def _window(view):
    q = [(t0, t1) for n, t0, t1, _ in view.spans.records if n == "query"]
    if not q:
        return None
    return min(a for a, _ in q), max(b for _, b in q)


def spans(view) -> Optional[List]:
    """The program's spans inside the window, or None where the program
    recorded none."""
    memo = view.store("program_trace")
    if "spans" not in memo:
        memo["spans"] = None
        w = _window(view)
        if w is not None and hasattr(_profile, "spans"):
            w0, w1 = w[0] * 1e9, w[1] * 1e9
            got = [s for s in _profile.spans()
                   if w0 <= s.t0_ns and s.t1_ns <= w1]
            memo["spans"] = got or None
            if got:
                _print_totals(got)
    return memo["spans"]


def _print_totals(recs) -> None:
    """Each span name's calls, total and self time (total less its
    child spans) in the window, to standard error."""
    print("program_trace: spans in the window (calls, total ms, self ms):",
          file=sys.stderr)
    got = _profile.totals(recs)
    for name, (n, total, own) in sorted(got.items(),
                                        key=lambda kv: -kv[1][1]):
        print(f"program_trace:   {name} {n} {total / 1e6:.3f} "
              f"{own / 1e6:.3f}", file=sys.stderr)


def _roots(view) -> Optional[List]:
    recs = spans(view)
    if recs is None:
        return None
    return [s for s in recs if s.parent_id is None and s.name == "query"]


def queries(view) -> Optional[int]:
    """The window's queries: the program's `query` roots."""
    roots = _roots(view)
    return None if roots is None else len(roots)


def request_count(view, name: str) -> Optional[int]:
    """The program counter `COUNTS.<name>` over the window's queries:
    the sum of their `query` roots' tallies."""
    roots = _roots(view)
    if roots is None:
        return None
    return sum((getattr(r, "counts", None) or {}).get(name, 0)
               for r in roots)


def named(view, name: str) -> Optional[List]:
    recs = spans(view)
    if recs is None:
        return None
    return [s for s in recs if s.name == name]


def ms(recs) -> float:
    return sum(s.t1_ns - s.t0_ns for s in recs) / 1e6


def outermost_rebuilds(view, under: Optional[str] = None) -> Optional[List]:
    """The `rebuild.*` spans with no `rebuild.*` span above them (a
    rebuild inside another is not counted twice); with `under`, those
    with a span of that name above them."""
    recs = spans(view)
    if recs is None:
        return None
    by_id = {s.id: s for s in recs}
    out = []
    for s in recs:
        if not s.name.startswith("rebuild."):
            continue
        names = []
        p = by_id.get(s.parent_id)
        while p is not None:
            names.append(p.name)
            p = by_id.get(p.parent_id)
        if any(n.startswith("rebuild.") for n in names):
            continue
        if under is None or under in names:
            out.append(s)
    return out


def _idle_intervals(dev) -> List[tuple]:
    w0, w1 = dev.window
    busy = sorted((max(a, w0), min(b, w1)) for _, a, b, _ in dev.ops
                  if b > w0 and a < w1)
    out, t = [], w0
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < w1:
        out.append((t, w1))
    return out


def _root_self_label(root, children, t: float) -> str:
    """`<root> self, after <child>`: the root's own time at `t` named
    by the last of its direct children to close before `t`."""
    ends, names = children.get(root.id, ([], []))
    k = bisect.bisect_right(ends, t) - 1
    return (f"{root.name} self, after "
            f"{names[k] if k >= 0 else 'its start'}")


def idle_by_span(view) -> Optional[Dict[str, float]]:
    """Seconds of the window's device-idle time by the innermost program
    span open on the host then: NO_SPAN where none is open, and where
    only a request's root is, `<root> self, after <child>` (the root's
    own time, named by where it falls among the root's children).  The
    two are the idle time no program layer claims.  None without a
    device trace or program spans."""
    dev = view.device
    recs = spans(view)
    if dev is None or recs is None:
        return None
    memo = view.store("program_trace")
    if "idle" in memo:
        return memo["idle"]
    w0, w1 = dev.window
    idle = _idle_intervals(dev)
    # idle seconds in [w0, t], as a function of t
    ia = np.array([a for a, _ in idle] or [w1])
    ib = np.array([b for _, b in idle] or [w1])
    before = np.concatenate([[0.0], np.cumsum(ib - ia)])[:-1]

    def idle_to(t):
        i = np.searchsorted(ia, t, side="right") - 1
        ic = np.clip(i, 0, None)
        return np.where(i < 0, 0.0, before[ic] + np.clip(
            t - ia[ic], 0.0, ib[ic] - ia[ic]))

    t0 = np.array([s.t0_ns for s in recs]) / 1e9
    t1 = np.array([s.t1_ns for s in recs]) / 1e9
    pts = np.unique(np.clip(np.concatenate([[w0, w1], t0, t1]), w0, w1))
    lo, hi = pts[:-1], pts[1:]
    mid = (lo + hi) / 2
    open_ = (t0[None, :] <= mid[:, None]) & (t1[None, :] >= mid[:, None])
    inner = np.argmax(np.where(open_, t0[None, :], -np.inf), axis=1)
    secs = idle_to(hi) - idle_to(lo)
    children: Dict[int, tuple] = {}
    for s in sorted(recs, key=lambda s: s.t1_ns):
        if s.parent_id is not None:
            ends, names = children.setdefault(s.parent_id, ([], []))
            ends.append(s.t1_ns / 1e9)
            names.append(s.name)
    out: Dict[str, float] = defaultdict(float)
    unclaimed = 0.0
    for k, sec in enumerate(secs.tolist()):
        if sec <= 0:
            continue
        s = recs[inner[k]] if open_[k].any() else None
        if s is not None and s.parent_id is not None:
            out[s.name] += sec
            continue
        unclaimed += sec
        out[NO_SPAN if s is None else
            _root_self_label(s, children, float(mid[k]))] += sec
    out = dict(out)
    memo["idle"] = out
    total = sum(out.values())
    memo["unclaimed"] = 100.0 * unclaimed / total if total else None
    print(f"program_trace: device idle {total:.6f} s of a {w1 - w0:.6f} s "
          f"window, by the innermost program span open then:",
          file=sys.stderr)
    for name, sec in sorted(out.items(), key=lambda kv: -kv[1]):
        print(f"program_trace:   {name} {sec:.6f} s "
              f"({100.0 * sec / total if total else 0.0:.2f}%)",
              file=sys.stderr)
    print(f"program_trace: {queries(view)} program query roots, "
          f"{view.counts.get('queries')} harness queries", file=sys.stderr)
    return out


def unattributed_share(view) -> Optional[float]:
    """% of the window's device-idle time that no program layer claims
    (`idle_by_span`'s NO_SPAN and request-root self time)."""
    if not idle_by_span(view):
        return None
    return view.store("program_trace")["unclaimed"]
