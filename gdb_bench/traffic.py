"""The general traffic generator: what a mix's data file
(`gdb_bench/traffic/<name>.json`) asks for, drawn from the seed.

Every seed gives the same amount of work in another order: a scatter
cycles through the same equal intervals from a start the seed draws; a
lookup stream draws interval starts uniformly over the region.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np


def scatter_intervals(region: int, n: int) -> List[Tuple[int, int]]:
    """`n` equal column intervals tiling [0, region]."""
    b = np.linspace(0, region + 1, n + 1).astype(np.int64)
    return [(int(b[i]), int(b[i + 1]) - 1) for i in range(n)]


def scatter_schedule(region: int, n: int, seed: int) -> Iterator[
        Tuple[int, Tuple[int, int]]]:
    """(interval index, interval) without end: the intervals in turn,
    from a start drawn from the seed."""
    ivs = scatter_intervals(region, n)
    i = int(np.random.default_rng([seed, 2]).integers(n))
    while True:
        yield i, ivs[i]
        i = (i + 1) % n


def lookup_stream(region: int, length: int, seed: int, client: int
                  ) -> Iterator[Tuple[int, int]]:
    """Intervals of `length` columns, starts uniform over [0, region],
    for one client (client -1: the set-up's warm-up lookups)."""
    rng = np.random.default_rng([seed, 3, client + 1])
    hi = max(region - length + 1, 0)
    while True:
        lo = int(rng.integers(0, hi + 1))
        yield lo, min(lo + length - 1, region)


def checked_sample(seed: int, done: List[int], k: int
                   ) -> List[Tuple[int, int]]:
    """The (client, lookup number) pairs whose answers a run checks,
    given how many lookups each client completed (`done`): the last of
    each client, and the rest of `k` drawn from the seed without
    replacement among all the others."""
    picks = [(c, n - 1) for c, n in enumerate(done) if n]
    rest = [(c, i) for c, n in enumerate(done) for i in range(n - 1)]
    m = max(0, min(k - len(picks), len(rest)))
    rng = np.random.default_rng([seed, 4])
    drawn = rng.choice(len(rest), size=m, replace=False) if m else []
    return sorted(picks + [rest[int(j)] for j in drawn])
