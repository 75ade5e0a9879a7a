"""What the mesh cell's per-layer readers share, beside
`program_trace`: whether the program counts a counter at all, and the
outermost of a set of spans.

A counter the program has never bumped is absent from its
`profile.COUNTS`: a program without the mesh's counters (one that
builds its mesh per query and has no collective spans) then reads None,
not 0.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

from gdb_bench import program_trace as P


def counted(name: str) -> bool:
    """The program has counted `name` in this process (set-up's
    warm-up query included)."""
    from genomicsdb_tpu_torch.core import profile
    return name in vars(profile.COUNTS)


def outermost(view, names: Iterable[str]) -> Optional[List]:
    """The window's spans named in `names` with no span of those names
    above them (a gather inside another counted once), or None where
    the program recorded no spans."""
    names = set(names)
    recs = P.spans(view)
    if recs is None:
        return None
    by_id = {s.id: s for s in recs}
    out = []
    for s in recs:
        if s.name not in names:
            continue
        p = by_id.get(s.parent_id)
        while p is not None and p.name not in names:
            p = by_id.get(p.parent_id)
        if p is None:
            out.append(s)
    return out
