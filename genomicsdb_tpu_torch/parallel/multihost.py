"""Multi-host execution driver over `torch.distributed` (the port's
counterpart of `genomicsdb_tpu.parallel.multihost`).

The reference distributes with one MPI rank per column partition
(tools/src/vcf2tiledb.cc:44-52, gt_mpi_gather.cc:166-263).  Here each
process owns one or more column partitions; inside a process the block
engine's combine may run on a mesh (parallel/sharded.py).  Host-level
results are either partition-local text (combined VCF — stitched by rank
order, no communication, mirroring gt_mpi_gather.cc:322-366) or
serialized variant blobs gathered to process 0 (query/serialize.py — the
MPI_Gatherv equivalent), moved as host bytes on a gloo process group.
"""

from __future__ import annotations

import datetime
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..core import profile
from .comm import PG_TIMEOUT_S


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None):
    """Join the gloo process group of `num_processes` processes whose
    rendezvous is `coordinator` ("host:port"); a no-op for one
    process."""
    if num_processes is None or num_processes <= 1:
        return
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))


def _world(group=None):
    """(this process's index, the process count) in `group` (default:
    the world)."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def my_partitions(num_partitions: int) -> List[int]:
    """Column partitions owned by this process (block distribution)."""
    pid, n = _world()
    per = (num_partitions + n - 1) // n
    return [p for p in range(pid * per, min((pid + 1) * per,
                                            num_partitions))]


# per-transfer ceiling: keeps any single collective payload far below
# the 2 GB int32 offsets limit (the reference needs BigMPI for this,
# gt_mpi_gather.cc:172-217; here large blobs just take more rounds)
GATHER_CHUNK = 1 << 30


def gather_blobs_to_root(blob: bytes, group=None,
                         device="cpu") -> Optional[List[bytes]]:
    """Gather variable-length byte blobs to process 0 with gatherv
    semantics (MPI_Gather lengths + MPI_Gatherv payload,
    gt_mpi_gather.cc:167-263): the lengths are all-gathered first, then
    each process's payload moves to process 0 at its OWN size — no
    max-size padding, so root memory is O(sum(len)) rather than
    O(n_hosts * max_len) — in slices of at most GATHER_CHUNK bytes (>2 GB
    safe, the reference's BigMPI case).  Returns the blobs in process
    order on process 0, None elsewhere.  With `group` the processes are
    the group's and process 0 is its first; the bytes move through
    tensors on `device` (a card for an NCCL group).  Counts the bytes
    this process received in the lengths' all-gather and sent or
    received as payload in `gather_blobs_to_root.bytes` and in
    `profile.COUNTS.collective_bytes`."""
    pid, n = _world(group)
    if n == 1:
        return [blob]

    def member(i):
        return dist.get_global_rank(group, i) if group is not None else i

    length = torch.tensor([len(blob)], dtype=torch.int64, device=device)
    lengths = [torch.zeros(1, dtype=torch.int64, device=device)
               for _ in range(n)]
    dist.all_gather(lengths, length, group=group)
    moved = 8 * n
    src = torch.frombuffer(bytearray(blob), dtype=torch.uint8).to(device) \
        if blob else torch.empty(0, dtype=torch.uint8)
    pieces: List[bytes] = []
    for i in range(n):
        li = int(lengths[i])
        parts = []
        for off in range(0, li, GATHER_CHUNK):
            m = min(GATHER_CHUNK, li - off)
            if i == 0:
                if pid == 0:
                    parts.append(blob[off:off + m])
            elif pid == i:
                dist.send(src[off:off + m].contiguous(), dst=member(0),
                          group=group)
                moved += m
            elif pid == 0:
                got = torch.empty(m, dtype=torch.uint8, device=device)
                dist.recv(got, src=member(i), group=group)
                parts.append(got.cpu().numpy().tobytes())
                moved += m
        if pid == 0:
            pieces.append(b"".join(parts))
    gather_blobs_to_root.bytes += moved
    profile.count("collective_bytes", moved)
    if pid != 0:
        return None
    return pieces


gather_blobs_to_root.bytes = 0


def run_partitioned_query(run_rank: Callable[[int], bytes],
                          partitions: Sequence[int]) -> Optional[bytes]:
    """Run this host's partitions, gather all hosts' outputs in partition
    order on process 0."""
    local = b"".join(run_rank(p) for p in partitions)
    pieces = gather_blobs_to_root(local)
    if pieces is None:
        return None
    return b"".join(pieces)
