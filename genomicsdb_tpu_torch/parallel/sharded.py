"""The sharded combine on a ("pos", "row") mesh of rank processes over
`torch.distributed` (counterpart of `genomicsdb_tpu.parallel.sharded`).

One process per mesh position: the "pos" axis shards a block's records
(like the reference's column partitions: no communication), the "row"
axis shards its samples.  The cross-sample INFO medians and sums need
the whole sample axis, so `_reduce_math` all-gathers it over the row
group before the unchanged local math (the JAX `axis_name="row"`); the
remaps are local.  Outputs therefore equal the unsharded combine bit for
bit.

Every rank builds the same block on its host (`store_to_block` is
deterministic) and takes its shard: its sample rows of the `[S, C, ...]`
cell slabs (cached on the store's dense layout, like the unsharded
upload) and its records x samples of the `[B, S, ...]` LUTs, padded
with the fills of the JAX package's `pad_block_for_mesh` (`_LAYOUT`:
padded samples and records have no live cell, so every kernel and
reduction masks them).  On a CUDA device each
shard runs the CUDA kernel (`fused_combine.fused_gather_remap`, wide
form) on its local slab; blocks past the kernel's gates take the general
step, counted in `mesh_combine.general_path_blocks`.  The first rank
gathers the shards' outputs (all one shape after padding) and trims them
to the block's shape (`gather_outputs`); the JAX mesh branch's layout.

  make_mesh              the process group (backend by `choose_backend`),
                         this rank's device and a DeviceMesh with
                         mesh_dim_names ("pos", "row")
  shard_tensors          one rank's shard of block_to_tensors-order tensors
  shard_block            the same from a CellBlock, on the mesh's device
  shard_block_fused      shard_block, or None past the kernel's gates
  sharded_combine_step   the general step on a shard
  sharded_combine_step_fused  the CUDA kernel (its twin on the CPU) on a
                         shard, then the reductions over the row group
  mesh_combine           the block engine's combine of one block's shard
  gather_outputs         the shards' outputs, assembled on the first rank
"""

from __future__ import annotations

import datetime
import os
import sys
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core import formats
from ..ops import fused_combine as FC
from ..ops.combine_step import block_to_tensors, combine_step, to_tensor
from .comm import PG_TIMEOUT_S, gather_to_root

INT_MISSING = formats.INT_MISSING

# padding of the 19 block_to_tensors tensors, the fills of the JAX
# package's pad_block_for_mesh: (sample axis, record axis, fill); axis
# None = not sharded on that mesh axis
_NAN = float("nan")
_LAYOUT = (
    (0, None, INT_MISSING), (0, None, 0),         # pl, pl_len
    (0, None, INT_MISSING), (0, None, 0),         # ad, ad_len
    (0, None, -1),                                # gt
    (0, None, INT_MISSING), (0, None, INT_MISSING),   # gq, dp
    (0, None, INT_MISSING), (0, None, INT_MISSING),   # min_dp, dp_info
    (1, None, _NAN), (1, None, INT_MISSING), (1, None, _NAN),  # info_*
    (1, 0, -1), (1, 0, -1),                       # inv_bs, nr_bs
    (None, 0, 1), (None, 0, True),                # rec_num_merged, has_nr
    (1, 0, -1), (1, 0, False), (1, 0, 0),         # live, del_rw, gt_lens
)
N_SLABS = 12
_PER_SAMPLE = ("pl", "ad", "gt", "gq", "dp_format", "min_dp", "live")


def choose_backend(world: int, device: torch.device) -> str:
    """NCCL when every rank on this host has a card of its own, gloo when
    ranks share a card or run on the CPU.  The ranks on this host are
    LOCAL_WORLD_SIZE where a launcher (torchrun) sets it, else the
    world."""
    if device.type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def rank_device(device: torch.device, local_rank: int) -> torch.device:
    """Rank r's device: cuda:(r % device_count) on a CUDA device, else
    the CPU."""
    if device.type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


@dataclass(frozen=True)
class Mesh:
    """This rank's place on an n_pos x n_row mesh.  `device_mesh` is None
    for a Mesh made only to cut shards (tests, timing); the collectives
    need the one `make_mesh` returns."""
    n_pos: int
    n_row: int
    pos: int
    row: int
    device: torch.device
    backend: Optional[str] = None
    device_mesh: object = None

    @property
    def rank(self) -> int:
        return self.pos * self.n_row + self.row

    @property
    def size(self) -> int:
        return self.n_pos * self.n_row

    @property
    def row_group(self):
        return self.device_mesh.get_group("row") \
            if self.device_mesh is not None else None


def make_mesh(n_pos: int, n_row: int, device) -> Mesh:
    """Join (or start) the world of n_pos * n_row rank processes and lay
    it out as a ("pos", "row") DeviceMesh.  Without an initialized
    process group it starts one from the launcher's environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT; LOCAL_RANK if set) on the
    backend `choose_backend` picks, and says which on stderr.  Rank r
    runs on `rank_device(device, LOCAL_RANK or r)`.  The DeviceMesh is
    a "cuda" mesh on NCCL and a "cpu" one on gloo, where the collectives
    run on the host."""
    from torch.distributed.device_mesh import init_device_mesh
    device = torch.device(device)
    world = n_pos * n_row
    if dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
        backend = dist.get_backend()
    else:
        rank = int(os.environ["RANK"])
        size = int(os.environ["WORLD_SIZE"])
        backend = choose_backend(size, device)
    if size != world:
        raise RuntimeError(f"mesh {n_pos}x{n_row} needs {world} ranks, the "
                           f"process group has {size}")
    dev = rank_device(device, int(os.environ.get("LOCAL_RANK", rank)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method="env://", world_size=size, rank=rank,
            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu",
                          (n_pos, n_row), mesh_dim_names=("pos", "row"))
    pos, row = dm.get_coordinate()
    if (pos, row) != divmod(rank, n_row):
        raise RuntimeError(f"rank {rank} sits at {(pos, row)} of the mesh, "
                           f"expected {divmod(rank, n_row)}")
    print(f"mesh {n_pos}x{n_row}: rank {rank} (pos {pos}, row {row}) on "
          f"{dev}, backend {backend}", file=sys.stderr)
    return Mesh(n_pos, n_row, pos, row, dev, backend, dm)


def _span(n: int, parts: int, idx: int):
    """(lo, hi, per): shard `idx` of `parts` over n items, each shard
    `per` = ceil(n / parts) long after padding."""
    per = -(-n // parts)
    lo = min(idx * per, n)
    return lo, min(lo + per, n), per


def _cut(t: torch.Tensor, axis: int, span, fill) -> torch.Tensor:
    lo, hi, per = span
    x = t.narrow(axis, lo, hi - lo)
    if hi - lo < per:
        shape = list(t.shape)
        shape[axis] = per - (hi - lo)
        x = torch.cat([x, torch.full(shape, fill, dtype=t.dtype,
                                     device=t.device)], dim=axis)
    return x.contiguous()


def shard_tensors(mesh: Mesh, tensors, B: int, S: int,
                  gt_lens_fill: int = 0) -> tuple:
    """This rank's shard of the 19 block_to_tensors tensors of a block of
    B records x S samples: its sample rows of the cell slabs, its
    records x samples of the LUTs, padded with `_LAYOUT`'s fills.
    `gt_lens_fill` pads the GT lengths: 0, or the GT width for a block
    without stored lengths (block_to_tensors fills those with it)."""
    return _shard(mesh, tensors, _layout(gt_lens_fill), B, S)


def _layout(gt_lens_fill: int):
    return _LAYOUT[:-1] + ((1, 0, gt_lens_fill),)


def _shard(mesh: Mesh, tensors, layout, B: int, S: int) -> tuple:
    s_span = _span(S, mesh.n_row, mesh.row)
    b_span = _span(B, mesh.n_pos, mesh.pos)
    out = []
    for t, (s_ax, b_ax, fill) in zip(tensors, layout):
        if s_ax is not None:
            t = _cut(t, s_ax, s_span, fill)
        if b_ax is not None:
            t = _cut(t, b_ax, b_span, fill)
        out.append(t)
    return tuple(out)


def _upload(t: torch.Tensor, device) -> torch.Tensor:
    if torch.device(device).type != "cpu":
        to_tensor.h2d_bytes += t.numel() * t.element_size()
    return t.to(device)


def shard_block(mesh: Mesh, blk, device=None) -> tuple:
    """This rank's shard of `blk` (block_to_tensors order) on `device`
    (default: the mesh's).  The cell slabs' shard of a block from the
    store path is cached on its store-wide layout, like the unsharded
    upload, so a query uploads its slice of the slabs once."""
    device = torch.device(device if device is not None else mesh.device)
    B, S = np.asarray(blk.live).shape
    host = block_to_tensors(blk, "cpu")
    lay = getattr(blk, "_dense_layout", None)
    key = ("_torch_mesh_slabs", str(device), mesh.n_row, mesh.row)
    slabs = None
    if lay is not None:
        hit = lay.get(key)
        if hit is not None and all(a is b for a, b
                                   in zip(hit[0], host[:N_SLABS])):
            slabs = hit[1]
    if slabs is None:
        slabs = tuple(_upload(t, device) for t in _shard(
            mesh, host[:N_SLABS], _LAYOUT[:N_SLABS], B, S))
        if lay is not None:
            lay[key] = (host[:N_SLABS], slabs)
    fill = 0 if blk.gt_len_bs is not None else blk.gt.shape[2]
    per_block = _shard(mesh, host[N_SLABS:], _layout(fill)[N_SLABS:], B, S)
    return slabs + tuple(_upload(t, device) for t in per_block)


def shard_block_fused(mesh: Mesh, blk, device=None, *, max_merged: int,
                      ploidy: int, mixed_ploidy: bool = False):
    """shard_block for the kernel step, or None for a block past the
    kernel's gates (`fused_combine.kernel_takes`)."""
    if not FC.kernel_takes(blk, max_merged, ploidy, mixed_ploidy):
        return None
    return shard_block(mesh, blk, device)


def sharded_combine_step(mesh: Mesh, *local, max_merged: int, ploidy: int,
                         gt_phase: bool = False,
                         mixed_ploidy: bool = False) -> Dict[str,
                                                             torch.Tensor]:
    """The general combine on this rank's shard: gather, remap, and the
    reductions over the row group.  Outputs are the shard's: pl / ad /
    gt / gq / dp_format / min_dp / live [B_loc, S_loc, ...], info_*
    [F, B_loc] and dp_info_sum [B_loc] (equal on every rank of a row
    group)."""
    return combine_step(*local, max_merged=max_merged, ploidy=ploidy,
                        gt_phase=gt_phase, mixed_ploidy=mixed_ploidy,
                        group=mesh.row_group)


def sharded_combine_step_fused(mesh: Mesh, *local, max_merged: int,
                               ploidy: int, gt_phase: bool = False,
                               mixed_ploidy: bool = False
                               ) -> Dict[str, torch.Tensor]:
    """The kernel's step on this rank's shard: `fused_gather_remap` (the
    CUDA kernel, wide form, on the local [S_loc, C] slab with [B_loc,
    S_loc, M] LUTs; the twin on the CPU), then `_fused_post` with the
    reductions over the row group.  The outputs of
    sharded_combine_step."""
    cells, (inv_bs, nr_bs, rec_nm, has_nr, live, del_rw, gt_lens) = \
        local[:N_SLABS], local[N_SLABS:]
    live = live.to(torch.int32)
    k = FC.fused_gather_remap(
        *cells, live, inv_bs.to(torch.int32), nr_bs.to(torch.int32),
        rec_nm.to(torch.int32), has_nr,
        gt_lens.to(torch.int32) if mixed_ploidy else None,
        max_merged=max_merged, ploidy=ploidy, gt_phase=gt_phase,
        mixed=mixed_ploidy)
    return FC._fused_post(k, del_rw, live, group=mesh.row_group)


def mesh_combine(mesh: Mesh, blk, *, max_merged: int, ploidy: int,
                 gt_phase: bool = False, mixed_ploidy: bool = False
                 ) -> Dict[str, torch.Tensor]:
    """The block engine's combine of this rank's shard of `blk`: the
    kernel step where its gates allow, the general step otherwise.
    Counts blocks in `mesh_combine.blocks` and the general-path ones in
    `mesh_combine.general_path_blocks`."""
    mesh_combine.blocks += 1
    kw = dict(max_merged=max_merged, ploidy=ploidy, gt_phase=gt_phase,
              mixed_ploidy=mixed_ploidy)
    local = shard_block_fused(mesh, blk, max_merged=max_merged,
                              ploidy=ploidy, mixed_ploidy=mixed_ploidy)
    if local is not None:
        return sharded_combine_step_fused(mesh, *local, **kw)
    mesh_combine.general_path_blocks += 1
    return sharded_combine_step(mesh, *shard_block(mesh, blk), **kw)


mesh_combine.blocks = 0
mesh_combine.general_path_blocks = 0


def _np_dtype(dt: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dt).numpy().dtype


def gather_outputs(mesh: Mesh, out: Dict[str, torch.Tensor], B: int,
                   S: int) -> Optional[Dict[str, np.ndarray]]:
    """Every shard's outputs, assembled on the mesh's first rank and
    trimmed to the block's B records x S samples (the JAX mesh branch's
    layout: [B, S, ...] per-sample outputs, [F, B] INFO reductions, [B]
    DP sum); None on the other ranks.  One collective: each rank's
    outputs move as one byte blob, the same size on every rank."""
    keys = sorted(out)
    parts = [out[k].contiguous().reshape(-1).view(torch.uint8)
             for k in keys]
    got = gather_to_root(torch.cat(parts), None)
    if got is None:
        return None
    blobs = got.cpu().numpy()
    b_loc, s_loc = -(-B // mesh.n_pos), -(-S // mesh.n_row)
    res = {}
    for k in keys:
        v = out[k]
        shape = tuple(v.shape)
        if k in _PER_SAMPLE:
            shape = (b_loc * mesh.n_pos, s_loc * mesh.n_row) + shape[2:]
        elif k.startswith("info_"):
            shape = (shape[0], b_loc * mesh.n_pos)
        else:
            shape = (b_loc * mesh.n_pos,)
        res[k] = np.empty(shape, _np_dtype(v.dtype))
    for r in range(mesh.size):
        pos, row = divmod(r, mesh.n_row)
        bs = slice(pos * b_loc, (pos + 1) * b_loc)
        off = 0
        for k, p in zip(keys, parts):
            v = out[k]
            a = blobs[r, off:off + p.numel()].view(
                _np_dtype(v.dtype)).reshape(tuple(v.shape))
            off += p.numel()
            if k in _PER_SAMPLE:
                res[k][bs, row * s_loc:(row + 1) * s_loc] = a
            elif row == 0:
                if k.startswith("info_"):
                    res[k][:, bs] = a
                else:
                    res[k][bs] = a
    for k in keys:
        a = res[k]
        res[k] = a[:B, :S] if k in _PER_SAMPLE else \
            a[:, :B] if k.startswith("info_") else a[:B]
    return res
