"""The two collectives the port's distribution uses, over
`torch.distributed`.

  all_gather      every rank's tensor, stacked on a leading rank axis, on
                  every rank of the group (the sample-axis gather of the
                  mesh's cross-sample reductions)
  gather_to_root  every rank's tensor, stacked, on the group's first
                  rank only (the mesh's output assembly)

Both take any dtype (bool moves as uint8) and copy bits exactly: the NaN
words of masked float rows (0x7FC00000) arrive as they were sent.

Which backend a group runs on follows the layout, never a failure
(`sharded.choose_backend`): NCCL when each rank has a card of its own,
gloo when ranks share a card or run on the CPU.  Both backends take the
tensors where they lie, on the card or on the host, so both collectives
have one branch for every backend and device.

The gather is `torch.distributed.all_gather_into_tensor` (`ALL_GATHER`):
it exists on every torch the port runs on, and newer ones that mark it
deprecated in favour of `all_gather_single` still run it.

Each call is timed as a span (`collective`: `mesh.all_gather`, or the
caller's name), and the bytes this rank moves are counted in the
function's `bytes` attribute and in `profile.COUNTS.collective_bytes`.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

from ..core import profile

ALL_GATHER = "torch.distributed.all_gather_into_tensor"
#: seconds a collective waits for a rank that does not arrive
PG_TIMEOUT_S = 600


@contextlib.contextmanager
def collective(name: str, device):
    """The span `name` around one collective on `device`, and nothing
    else.  NCCL returns to the host before its transfer ends, so with
    tracing on and a card the card's queued work is waited for before
    the collective (the span then holds no kernel queued before it) and
    after it (the span then holds the transfer and the wait for the
    group's slowest rank).  With tracing off nothing waits."""
    card = profile.ENABLED and torch.device(device).type == "cuda"
    if card:
        torch.cuda.synchronize(device)
    with profile.span(name):
        yield
        if card:
            torch.cuda.synchronize(device)


def _as_words(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x.view(torch.uint8) if x.dtype == torch.bool else x


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """[n, *x.shape]: `x` of each of the group's n ranks, in rank order,
    on x's device.  Counts the call in `all_gather.calls` and the bytes
    this rank receives in `all_gather.bytes`."""
    n = dist.get_world_size(group)
    src = _as_words(x)
    out = torch.empty((n * src.numel(),), dtype=src.dtype,
                      device=src.device)
    with collective("mesh.all_gather", src.device):
        dist.all_gather_into_tensor(out, src.reshape(-1), group=group)
    moved = out.numel() * out.element_size()
    all_gather.calls += 1
    all_gather.bytes += moved
    profile.count("collective_bytes", moved)
    out = out.reshape((n,) + tuple(x.shape))
    return out.view(torch.bool) if x.dtype == torch.bool else out


all_gather.calls = 0
all_gather.bytes = 0


def gather_to_root(x: torch.Tensor, group, span: str = "mesh.all_gather"
                   ) -> Optional[torch.Tensor]:
    """[n, *x.shape] of the group's n ranks' `x`, in rank order, on the
    group's first rank (on x's device); None on the others.  Timed as
    the span `span`.  Counts the bytes this rank sent, or on the first
    rank received, in `gather_to_root.bytes`."""
    n = dist.get_world_size(group)
    src = _as_words(x)
    root = dist.get_global_rank(group, 0) if group is not None else 0
    me = dist.get_rank()
    outs = [torch.empty_like(src) for _ in range(n)] if me == root \
        else None
    with collective(span, src.device):
        dist.gather(src, outs, dst=root, group=group)
    moved = src.numel() * src.element_size() * (n - 1 if me == root else 1)
    gather_to_root.bytes += moved
    profile.count("collective_bytes", moved)
    if me != root:
        return None
    out = torch.stack(outs)
    return out.view(torch.bool) if x.dtype == torch.bool else out


gather_to_root.bytes = 0
