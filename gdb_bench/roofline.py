"""The yardstick of the combine kernels: the least bytes a block's
combine must move, and the card's published peak.

Peaks are NVIDIA's data sheet for the H100 SXM part (80 GB of HBM3 at
3.35 TB/s), which assumes the card's full 700 W power limit; a card set
lower runs slower under load, so every reading is kept beside the
card's power limit.
"""

from __future__ import annotations

import math

import numpy as np

HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
NARROW_LIMIT = 32000           # |v| that a value of the int16 form holds
_SENTINELS = (-(2 ** 31), -(2 ** 31) + 1)


def peak_bytes_per_s(card: str) -> float:
    try:
        return HBM_BYTES_PER_S[card]
    except KeyError:
        raise KeyError(f"no published HBM rate for {card!r}") from None


def _fits16(a: np.ndarray) -> bool:
    a = np.asarray(a)
    return bool(np.all(((a >= -NARROW_LIMIT) & (a <= NARROW_LIMIT))
                       | np.isin(a, _SENTINELS)))


def combine_min_bytes(blk, *, max_merged: int, ploidy: int,
                      mixed: bool) -> int:
    """The least bytes one block's combine moves, from the block's own
    arrays: each distinct live (sample, cell) pair's fields read once
    (of its PL and AD rows only the entries below its PL and AD
    lengths), the per-(record, sample) allele maps and the per-record
    counts read once, and every output written once, in the int16 form
    where the live values fit it."""
    live = np.asarray(blk.live)
    B, S = live.shape
    C = blk.pl_len.shape[1]
    G_in, A_in, gt_w = blk.pl.shape[2], blk.ad.shape[2], blk.gt.shape[2]
    nf = blk.info_f.shape[0] + blk.info_i.shape[0] + blk.info_fs.shape[0]
    seen = np.zeros((S, C), bool)
    ok = live >= 0
    seen[np.broadcast_to(np.arange(S), (B, S))[ok], live[ok]] = True
    cells = int(seen.sum())
    rows = int(np.clip(blk.pl_len[seen], 0, G_in).sum()
               + np.clip(blk.ad_len[seen], 0, A_in).sum())
    cell_bytes = 4 * rows + cells * 4 * (gt_w + 6 + nf)
    lut = B * S * 4 * (2 + max_merged + (1 if mixed else 0)) + 8 * B
    g_out = math.comb(max_merged + ploidy - 1, ploidy)
    ev = 2 if all(_fits16(getattr(blk, k)[seen])
                  for k in ("pl", "ad", "gt")) else 4
    es = 2 if ev == 2 and all(_fits16(getattr(blk, k)[seen])
                              for k in ("gq", "dp", "min_dp")) else 4
    out = B * S * ((g_out + max_merged + gt_w) * ev + 3 * es + 4 + 4 * nf)
    return cell_bytes + lut + out
