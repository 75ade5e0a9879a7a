"""The sharded combine on a ("pos", "row") mesh of rank processes over
`torch.distributed` (counterpart of `genomicsdb_tpu.parallel.sharded`).

One process per mesh position: the "pos" axis shards a chunk's records
(like the reference's column partitions: no communication), the "row"
axis shards its samples.  The cross-sample INFO medians and sums need
the whole sample axis, so `_reduce_math` all-gathers it over the row
group before the unchanged local math (the JAX `axis_name="row"`); the
remaps are local.  A row group of one rank already holds the whole
sample axis and runs no collective (`Mesh.row_group` is None), as the
JAX all-gather over a one-device axis moves nothing.  Outputs equal the
unsharded combine bit for bit.

The block engine's query (`query.block_writer`, `gdb_query --mesh`)
builds each record once across the mesh: pos group p takes span p of
each chunk's records (`pos_span`), and only its row-0 rank builds that
span's block (`store_to_block`).  It sends each rank of its row group
that rank's sample rows of the block's seven per-block tensors (LUTs,
live cells, record flags) with a small header (`scatter_rows`); every
rank holds its own sample rows of the store-wide `[S, C, ...]` cell
slabs once per query (`local_slabs`).  Padded samples and records take
the fills of the JAX package's `pad_block_for_mesh` (`_LAYOUT`), so they
have no live cell and every kernel and reduction masks them.  On a CUDA
device each shard runs the CUDA kernel (`fused_combine.
fused_gather_remap`, wide form) on its local slab; blocks past the
kernel's gates take the general step, counted in
`mesh_combine.general_path_blocks`.  The row group's outputs go to its
row-0 rank (`gather_rows`), which renders the span's text.

The step functions below also shard one whole block over the mesh,
records and samples (`shard_block`), and assemble every shard's outputs
on the first rank (`gather_outputs`): the JAX mesh branch's layout, used
by the sharded demo, the graft entry and the parity tests.

  make_mesh              the process group (backend by `choose_backend`),
                         this rank's device and a DeviceMesh with
                         mesh_dim_names ("pos", "row"), built once per
                         world and shape (`drop_meshes` forgets them)
  local_slabs            this rank's sample rows of the store-wide slabs
  scatter_rows           the row group's block rows, each rank its samples
  combine_shard          the kernel step (or the general one past its
                         gates) on one rank's shard
  gather_rows            the row group's outputs, on its row-0 rank
  shard_tensors          one rank's shard of block_to_tensors-order tensors
  shard_block            the same from a CellBlock, on the mesh's device
  sharded_combine_step   the general step on a shard
  sharded_combine_step_fused  the CUDA kernel (its twin on the CPU) on a
                         shard, then the reductions over the row group
  mesh_combine           combine_shard of one whole block's shard
  gather_outputs         the shards' outputs, assembled on the first rank
"""

from __future__ import annotations

import atexit
import copy
import dataclasses
import datetime
import os
import sys
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core import formats, profile
from ..ops import fused_combine as FC
from ..ops.combine_step import (block_to_tensors, combine_step,
                                slab_arrays, to_tensor)
from ..ops.store_block import dense_layout
from .comm import PG_TIMEOUT_S, collective, gather_to_root

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
# the slabs' names in a dense layout (ops.store_block.dense_layout), in
# block_to_tensors order
SLAB_KEYS = ("pl", "pl_len", "ad", "ad_len", "gt", "gq", "dp", "min_dp",
             "dp_info", "info_f", "info_i", "info_fs")
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
        """The ranks of this rank's pos group (its records, every
        sample); None for a group of one, which needs no collective."""
        return self.device_mesh.get_group("row") \
            if self.device_mesh is not None and self.n_row > 1 else None

    @property
    def pos_group(self):
        """The ranks of this rank's row (one per pos group); None for a
        group of one."""
        return self.device_mesh.get_group("pos") \
            if self.device_mesh is not None and self.n_pos > 1 else None

    @property
    def wire(self) -> torch.device:
        """Where tensors that exist only to be sent lie: on the card for
        NCCL, on the host for gloo."""
        return self.device if self.backend == "nccl" \
            else torch.device("cpu")


#: the meshes this process laid out in a world it did not start:
#: (n_pos, n_row, backend, device) -> (the world's default group, Mesh)
_MESHES: Dict[tuple, tuple] = {}


def make_mesh(n_pos: int, n_row: int, device) -> Mesh:
    """Join (or start) the world of n_pos * n_row rank processes and lay
    it out as a ("pos", "row") DeviceMesh.  Without an initialized
    process group it starts one from the launcher's environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT; LOCAL_RANK if set) on the
    backend `choose_backend` picks, and says which on stderr.  Rank r
    runs on `rank_device(device, LOCAL_RANK or r)`.  The DeviceMesh is
    a "cuda" mesh on NCCL and a "cpu" one on gloo, where the collectives
    run on the host.

    A world started before the call (a launcher's or the caller's) that
    serves many queries lays its mesh out once: its Mesh of one (shape,
    backend, device) is kept, and later calls return it with its groups
    (each build makes new row and pos groups, and on NCCL their
    communicators); `drop_meshes` forgets the kept ones (the
    interpreter's exit calls it, and a new world's first build drops an
    ended world's).  A mesh whose world this call starts is not kept:
    its caller ends both.  Each build is timed as the span `mesh.join` and counted
    in `profile.COUNTS.mesh_joins`."""
    device = torch.device(device)
    key = None
    if dist.is_initialized():
        dev = rank_device(device, int(os.environ.get("LOCAL_RANK",
                                                     dist.get_rank())))
        key = (n_pos, n_row, dist.get_backend(), str(dev))
        hit = _MESHES.get(key)
        if hit is not None and hit[0] is dist.group.WORLD:
            return hit[1]
    with profile.span("mesh.join"):
        mesh = _join_mesh(n_pos, n_row, device)
    profile.count("mesh_joins")
    if key is not None:
        for k in [k for k, (w, _) in _MESHES.items()
                  if w is not dist.group.WORLD]:
            del _MESHES[k]          # of a world that has ended
        _MESHES[key] = (dist.group.WORLD, mesh)
    return mesh


@atexit.register
def drop_meshes() -> None:
    """Forget the meshes `make_mesh` kept: their groups go with the last
    reference.  A world's owner may call it before destroy_process_group
    (a group that outlives it can abort the interpreter's exit on
    gloo); the interpreter's exit calls it too, so a caller that ends
    its world without it exits cleanly."""
    _MESHES.clear()


def _join_mesh(n_pos: int, n_row: int, device: torch.device) -> Mesh:
    from torch.distributed.device_mesh import init_device_mesh
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


def pos_span(n: int, mesh: Mesh) -> tuple:
    """(lo, hi): the items [lo, hi) of n that this rank's pos group
    takes (the mesh's record split; empty for a group past the last
    item)."""
    lo, hi, _ = _span(n, mesh.n_pos, mesh.pos)
    return lo, hi


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
        profile.count("h2d_bytes", t.numel() * t.element_size())
    return t.to(device)


def shard_block(mesh: Mesh, blk, device=None) -> tuple:
    """This rank's shard of `blk` (block_to_tensors order) on `device`
    (default: the mesh's).  The cell slabs' shard of a block from the
    store path is the store's table `shard_slabs`, like the unsharded
    upload, so a query uploads its slice of the slabs once."""
    device = torch.device(device if device is not None else mesh.device)
    B, S = np.asarray(blk.live).shape
    host = block_to_tensors(blk, "cpu")
    slabs = blk.derived(
        "shard_slabs", (str(device), mesh.n_row, mesh.row, slab_arrays(blk)),
        lambda: tuple(_upload(t, device) for t in _shard(
            mesh, host[:N_SLABS], _LAYOUT[:N_SLABS], B, S)))
    fill = 0 if blk.gt_len_bs is not None else blk.gt.shape[2]
    per_block = _shard(mesh, host[N_SLABS:], _layout(fill)[N_SLABS:], B, S)
    return slabs + tuple(_upload(t, device) for t in per_block)


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


def combine_shard(mesh: Mesh, local, *, fused: bool, max_merged: int,
                  ploidy: int, gt_phase: bool = False,
                  mixed_ploidy: bool = False) -> Dict[str, torch.Tensor]:
    """The block engine's combine of this rank's shard (block_to_tensors
    order): the kernel step when `fused` (the block passed the kernel's
    gates), the general step otherwise.  Counts blocks in
    `mesh_combine.blocks` and the general-path ones in
    `mesh_combine.general_path_blocks`."""
    mesh_combine.blocks += 1
    kw = dict(max_merged=max_merged, ploidy=ploidy, gt_phase=gt_phase,
              mixed_ploidy=mixed_ploidy)
    if fused:
        return sharded_combine_step_fused(mesh, *local, **kw)
    mesh_combine.general_path_blocks += 1
    return sharded_combine_step(mesh, *local, **kw)


def mesh_combine(mesh: Mesh, blk, *, max_merged: int, ploidy: int,
                 gt_phase: bool = False, mixed_ploidy: bool = False
                 ) -> Dict[str, torch.Tensor]:
    """combine_shard of this rank's shard of the whole block `blk`
    (`shard_block`), the kernel step where its gates allow."""
    return combine_shard(
        mesh, shard_block(mesh, blk),
        fused=FC.kernel_takes(blk, max_merged, ploidy, mixed_ploidy),
        max_merged=max_merged, ploidy=ploidy, gt_phase=gt_phase,
        mixed_ploidy=mixed_ploidy)


mesh_combine.blocks = 0
mesh_combine.general_path_blocks = 0


def local_slabs(mesh: Mesh, store, qc, plan, gt_w: int,
                pad_cells_to: int) -> tuple:
    """This rank's sample rows of the 12 store-wide cell slabs of the
    query's dense layout (`store_block.dense_layout`), padded to the
    shard's width, on the mesh's device.  A row-0 rank builds the
    blocks, so it cuts its rows from the query's layout (the one
    store_to_block builds and caches); a row > 0 rank builds no block
    and lays out its own samples alone.  A row's cell runs do not depend
    on the other rows, so both give the block's live cell indices the
    same meaning.  The tensors are the store's table `mesh_slabs`, keyed
    on the layout's slabs: a query uploads them once."""
    lo, hi, per = _span(len(qc.rows_to_query), mesh.n_row, mesh.row)
    if mesh.row == 0:
        lay = dense_layout(store, qc, plan, gt_w, pad_cells_to)
        cut = (lo, hi, per)
    else:
        own = copy.copy(qc)
        own.rows_to_query = list(qc.rows_to_query[lo:hi])
        lay = dense_layout(store, own, plan, gt_w, pad_cells_to)
        cut = (0, hi - lo, per)
    slabs = tuple(lay[k] for k in SLAB_KEYS)
    return store.tables.get(
        "mesh_slabs", (str(mesh.device), mesh.n_row, mesh.row, slabs),
        lambda: tuple(
            _upload(_cut(to_tensor(a, "cpu"), s_ax, cut, fill), mesh.device)
            for a, (s_ax, _, fill) in zip(slabs, _LAYOUT[:N_SLABS])))


@dataclass(frozen=True)
class RowsHeader:
    """What a row group must agree on to combine one block: its padded
    record count, merged-allele LUT width, ploidy and GT flags, and
    whether the kernel takes it."""
    B: int
    max_merged: int
    ploidy: int
    gt_phase: bool
    mixed_ploidy: bool
    fused: bool


def empty_rows(B: int, S: int, max_merged: int) -> tuple:
    """The seven per-block arrays (`combine_step.per_block_arrays`
    order) of B padded records with no live cell: the block of a span
    that holds no record."""
    fills = [f for _, _, f in _LAYOUT[N_SLABS:]]
    shapes = ((B, S, max_merged), (B, S), (B,), (B,), (B, S), (B, S),
              (B, S))
    return tuple(np.full(sh, f, dtype=bool if isinstance(f, bool)
                         else np.int32) for sh, f in zip(shapes, fills))


def _pack_rows(rows, span) -> np.ndarray:
    """One rank's sample rows of the seven per-block arrays, padded with
    `_LAYOUT`'s fills, as one int32 word vector.  Padded samples have no
    live cell.  Their GT lengths take 0, shard_block's fill for a block
    with stored lengths: the steps read the lengths only for a
    mixed-ploidy block, and such a block has stored lengths."""
    words = []
    for a, (s_ax, _, fill) in zip(rows, _LAYOUT[N_SLABS:]):
        a = np.asarray(a)
        if s_ax is not None:
            lo, hi, per = span
            a = a[:, lo:hi]
            if hi - lo < per:
                pad = [(0, 0)] * a.ndim
                pad[1] = (0, per - (hi - lo))
                a = np.pad(a, pad, constant_values=fill)
        words.append(a.astype(np.int32).reshape(-1))
    return np.concatenate(words)


def _unpack_rows(words: torch.Tensor, B: int, s_loc: int, M: int) -> tuple:
    shapes = ((B, s_loc, M), (B, s_loc), (B,), (B,), (B, s_loc),
              (B, s_loc), (B, s_loc))
    out, off = [], 0
    for sh, (_, _, fill) in zip(shapes, _LAYOUT[N_SLABS:]):
        n = int(np.prod(sh))
        x = words[off:off + n].reshape(sh)
        out.append(x.to(torch.bool) if isinstance(fill, bool) else x)
        off += n
    return tuple(out)


def scatter_rows(mesh: Mesh, header: Optional[RowsHeader], rows,
                 S: int) -> tuple:
    """(header, this rank's shard of the seven per-block arrays on the
    mesh's device).  The row group's row-0 rank holds the block: its
    `header` and its host `rows` (`combine_step.per_block_arrays` order,
    S samples); the others pass None for both.  That rank broadcasts the
    header over the row group, then scatters each rank its sample rows
    (padded with `_LAYOUT`'s fills) as one int32 word vector: two
    collectives, none in a row group of one, each timed as the span
    `mesh.scatter_rows` (`comm.collective`; the pack and its upload are
    outside).  Counts the bytes this rank sent or received in
    `scatter_rows.bytes` and in `profile.COUNTS.collective_bytes`."""
    group = mesh.row_group
    if group is None:
        return header, tuple(to_tensor(np.asarray(a), mesh.device)
                             for a in rows)
    root = dist.get_global_rank(group, 0)
    head = torch.tensor([int(v) for v in dataclasses.astuple(header)]
                        if header is not None else [0] * 6,
                        dtype=torch.int64, device=mesh.wire)
    with collective("mesh.scatter_rows", mesh.wire):
        dist.broadcast(head, src=root, group=group)
    vals = head.tolist()
    header = RowsHeader(*vals[:3], *map(bool, vals[3:]))
    s_loc = -(-S // mesh.n_row)
    B, M = header.B, header.max_merged
    n_words = B * s_loc * (M + 4) + 2 * B
    local = torch.empty(n_words, dtype=torch.int32, device=mesh.wire)
    parts = None
    if mesh.row == 0:
        parts = [_upload(torch.from_numpy(
                     _pack_rows(rows, _span(S, mesh.n_row, r))), mesh.wire)
                 for r in range(mesh.n_row)]
    with collective("mesh.scatter_rows", mesh.wire):
        dist.scatter(local, parts, src=root, group=group)
    moved = (local.numel() * 4 + head.numel() * 8) \
        * (mesh.n_row - 1 if mesh.row == 0 else 1)
    scatter_rows.bytes += moved
    profile.count("collective_bytes", moved)
    if mesh.wire != mesh.device:
        local = _upload(local, mesh.device)
    return header, _unpack_rows(local, B, s_loc, M)


scatter_rows.bytes = 0


def _np_dtype(dt: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dt).numpy().dtype


def _assemble(out: Dict[str, torch.Tensor], group, size: int, n_pos: int,
              n_row: int, B: int, S: int, span: str = "mesh.all_gather"
              ) -> Optional[Dict[str, np.ndarray]]:
    """The outputs of `size` shards (n_pos x n_row, in group rank order)
    on the group's first rank, trimmed to B records x S samples; None on
    the others.  One collective (timed as the span `span`), none for a
    group of one: each rank's outputs move as one byte blob, the same
    size on every rank.  The copy to the host and the assembly there are
    the span `device.fetch`."""
    keys = sorted(out)
    parts = [out[k].contiguous().reshape(-1).view(torch.uint8)
             for k in keys]
    blob = torch.cat(parts)
    got = gather_to_root(blob, group, span) if size > 1 else blob[None]
    if got is None:
        return None
    with profile.span("device.fetch"):
        with profile.span("device.fetch.wait"):
            blobs = got.cpu().numpy()
        b_loc, s_loc = -(-B // n_pos), -(-S // n_row)
        res = {}
        for k in keys:
            v = out[k]
            shape = tuple(v.shape)
            if k in _PER_SAMPLE:
                shape = (b_loc * n_pos, s_loc * n_row) + shape[2:]
            elif k.startswith("info_"):
                shape = (shape[0], b_loc * n_pos)
            else:
                shape = (b_loc * n_pos,)
            res[k] = np.empty(shape, _np_dtype(v.dtype))
        for r in range(size):
            pos, row = divmod(r, n_row)
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


def gather_rows(mesh: Mesh, out: Dict[str, torch.Tensor], B: int,
                S: int) -> Optional[Dict[str, np.ndarray]]:
    """The row group's shards of one block's outputs, assembled on its
    row-0 rank and trimmed to B records x S samples (the unsharded
    combine's layout); None on the other ranks.  A row group of one
    fetches its outputs and moves nothing.  The group's gather is timed
    as the span `mesh.gather_rows`."""
    return _assemble(out, mesh.row_group, mesh.n_row, 1, mesh.n_row, B, S,
                     "mesh.gather_rows")


def gather_outputs(mesh: Mesh, out: Dict[str, torch.Tensor], B: int,
                   S: int) -> Optional[Dict[str, np.ndarray]]:
    """Every shard's outputs of one whole block (`shard_block`),
    assembled on the mesh's first rank and trimmed to the block's B
    records x S samples (the JAX mesh branch's layout: [B, S, ...]
    per-sample outputs, [F, B] INFO reductions, [B] DP sum); None on the
    other ranks.  A mesh of one rank moves nothing."""
    return _assemble(out, None, mesh.size, mesh.n_pos, mesh.n_row, B, S)
