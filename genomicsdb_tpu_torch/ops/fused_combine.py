"""The device combine built on the hand-written CUDA kernel (host side
of `genomicsdb_tpu.ops.pallas_combine`).

  fused_gather_remap      the wrapper: launches csrc/fused_gather_remap.cu
                          (wide, or narrow: int16 outputs) for CUDA
                          tensors, runs the plain twin for CPU tensors,
                          raises for anything else
  tile_plan               the kernel's tiles, genotype chunks, shared
                          memory layout and grid for one launch
  instantiation           which of the kernel's instantiations a launch
                          takes (the .cu's `dispatch`)
  launch_plan             tile_plan for one launch's tensors
  _prepare                one launch bound to its outputs (the wrapper
                          and chip_smoke.py's timing call it)
  fused_gather_remap_ref  the plain twin (torch ops, any device)
  _narrow_inputs_ok,      the host range checks that allow the narrow
  _narrow_scalars_ok      form, kept in the block's store's tables
  combine_step_fused      the kernel plus the cross-sample reductions,
                          under the JAX package's gates
  combine_block           the block engine's combine: combine_step_fused
                          where the gates allow it, the general
                          combine_step otherwise

There is no fallback that hides a kernel failure: a CUDA tensor reaches
the kernel or the call raises.
"""

from __future__ import annotations

import math
from dataclasses import astuple, dataclass, fields
from functools import lru_cache
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core import formats, profile

from .cell_block import genotype_combo_table
from .combine_step import (INT16_MISSING, INT16_VECTOR_END, _reduce_math,
                           _remap_math, _restrict_rows, block_to_tensors,
                           combine_step, gather_on_device)

INT_MISSING = formats.INT_MISSING
INT_VECTOR_END = formats.INT_VECTOR_END
NARROW_LIMIT = 32000         # values the narrow form carries: |v| <= this
MAX_PLOIDY = 6          # the kernel's per-call ploidy limit
MAX_MERGED = 16         # the kernel's merged-allele limit

_OUT_KEYS = ("pl", "ad", "gt", "gq", "dp_format", "min_dp", "dp_info",
             "info_f", "info_i", "info_fs")
_NARROW_KEYS = ("pl", "ad", "gt")              # int16 in narrow mode
_SCALAR_KEYS = ("gq", "dp_format", "min_dp")   # int16 with narrow_scalars


def to16(x: torch.Tensor) -> torch.Tensor:
    """int32 -> int16 with the BCF16 sentinels (the Pallas kernel's
    `to16`): INT_MISSING -> -32768, INT_VECTOR_END -> -32767, any other
    value cast unclamped."""
    y = torch.where(x == INT_MISSING, INT16_MISSING,
                    torch.where(x == INT_VECTOR_END, INT16_VECTOR_END, x))
    return y.to(torch.int16)


def widen16(x16: torch.Tensor) -> torch.Tensor:
    """The inverse of `to16`: int16 -> int32 with the sentinels mapped
    back."""
    x = torch.where(x16 == INT16_MISSING, INT_MISSING, x16.to(torch.int32))
    return torch.where(x16 == INT16_VECTOR_END, INT_VECTOR_END, x)


def _fits_int16(arrays) -> bool:
    for a in arrays:
        a = np.asarray(a)
        fits = (((a >= -NARROW_LIMIT) & (a <= NARROW_LIMIT))
                | (a == INT_MISSING) | (a == INT_VECTOR_END))
        if not fits.all():
            return False
    return True


def _range_check(blk, names) -> bool:
    """_fits_int16 of the block's `names` slabs, the store's table
    ("range_check", names) keyed on the slabs: every chunk and query of
    a store shares them, and a block whose slabs are other arrays is
    checked anew."""
    arrays = tuple(getattr(blk, n) for n in names)
    return blk.derived(("range_check", names), arrays,
                       lambda: _fits_int16(arrays))


def _narrow_inputs_ok(blk) -> bool:
    """True when every PL/AD/GT input value fits the int16 narrow range
    (remaps are permutations + sentinels, so the input range bounds the
    output range); pallas_combine._narrow_inputs_ok."""
    return _range_check(blk, ("pl", "ad", "gt"))


def _narrow_scalars_ok(blk) -> bool:
    """True when the GQ/DP/MIN_DP values fit int16 (masked
    passthroughs); pallas_combine._narrow_scalars_ok."""
    return _range_check(blk, ("gq", "dp", "min_dp"))


TERM_ROWS = 64          # the term table's allele rows (kTermRows)
_HEADER_INTS = 2 * (MAX_PLOIDY + 1)


@lru_cache(maxsize=32)
def combo_tables(max_merged: int, ploidy: int, mixed: bool) -> np.ndarray:
    """The kernel's tables as one int32 array: a header of (genotype
    offset, genotype count) for p = 0..6; the term table C(a + i, i + 1)
    for i < 6, a < TERM_ROWS (row i at i * TERM_ROWS); then one word per
    genotype of genotype_combo_table(max_merged, p), for every ploidy the
    launch needs (all of 1..ploidy in mixed mode, else `ploidy` alone):
    allele q in bits 4q..4q+3 and the largest allele in bits 24..27
    (alleles are below MAX_MERGED = 16)."""
    header = np.zeros(_HEADER_INTS, np.int32)
    term = np.array([[math.comb(a + i, i + 1) for a in range(TERM_ROWS)]
                     for i in range(MAX_PLOIDY)], np.int64)
    parts = [term.ravel()]
    off = len(header) + term.size
    for p in (range(1, ploidy + 1) if mixed else (ploidy,)):
        combos = genotype_combo_table(max_merged, p).astype(np.int64)
        words = ((combos << (4 * np.arange(p))).sum(axis=1)
                 | (combos.max(axis=1) << 24))
        header[2 * p:2 * p + 2] = (off, len(words))
        parts.append(words)
        off += len(words)
    return np.concatenate([header] + parts).astype(np.int32)


@lru_cache(maxsize=64)
def _device_tables(max_merged: int, ploidy: int, mixed: bool,
                   device: torch.device) -> torch.Tensor:
    """combo_tables on `device`, uploaded once per (M, ploidy, mixed,
    device)."""
    return torch.from_numpy(combo_tables(max_merged, ploidy, mixed)
                            ).to(device)


# ---- the tile plan (csrc/fused_gather_remap.cu's `Plan`) ----

THREADS = 256                # the kernel's block size (kThreads)
SMEM_MAX = 232448            # shared memory one block may use on sm_90
SMEM_PER_SM = 233472         # an SM's shared memory for blocks
SMEM_TARGET = 64 * 1024      # preferred: three or more blocks per SM
H100_SMS = 132
# tile shapes tried, largest first: (records, samples) per tile as
# preferred records x the rest; the first that fits the budget wins
_TILE_SIZES = (256, 128, 64, 32, 16)
_PREFERRED_TB = 8


@dataclass(frozen=True)
class TilePlan:
    """One launch's plan: tiles of `tb` records x `ts` samples, walked
    record-block-major by `grid` blocks (as many as the SMs hold by
    shared memory; the launch cuts them to those its registers allow);
    PL in `n_chunks` passes of `gc` genotypes, each (tile, chunk) a work
    item; `smem` bytes of dynamic shared memory laid out at the offsets
    below.  The fields, in this order, are the kernel's `struct Plan`,
    which copies them from `as_array()`."""
    tb: int
    ts: int
    log2_tb: int
    log2_nbs: int
    gc: int
    n_chunks: int
    n_ts: int
    n_tiles: int
    grid: int
    smem: int
    lut_bytes: int
    lut_live: int
    lut_nr: int
    lut_gtl: int
    lut_inv: int
    lut_recnm: int
    lut_recnr: int
    lut_row: int
    inv_row: int
    off_lut: int
    off_hdr: int
    off_term: int
    off_cell: int
    off_pll: int
    off_pcall: int
    off_ad: int
    slot_ad: int
    l2u_ad: int
    off_gt: int
    slot_gt: int
    l2u_gt: int
    off_sc: int
    slot_sc: int
    l2u_sc: int
    off_dpi: int
    slot_w: int
    l2u_w: int
    off_info: int
    off_pl: int
    slot_pl: int
    l2u_pl: int

    def as_array(self) -> np.ndarray:
        return np.array(astuple(self), dtype=np.int32)


PLAN_FIELDS = tuple(f.name for f in fields(TilePlan))


def _r16(n: int) -> int:
    return -(-n // 16) * 16


def _slot(run_bytes: int) -> int:
    """Bytes of a staging slot for a run of `run_bytes` placed at its
    destination's offset modulo 16."""
    return _r16(run_bytes + 15)


def _log2_units(slot: int) -> int:
    return (slot // 16 - 1).bit_length()


def _p2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _layout(tb, ts, gc, *, M, G_out, gt_w, nf, ev, es, mixed):
    """The shared-memory layout of tiles of tb x ts with PL passes of
    gc genotypes: a dict of PLAN_FIELDS' layout entries, "smem" the
    total."""
    d = {}
    lut_row, inv_row = ts + 1, ts * M + 1
    off = 0
    for name, ints in (("lut_live", tb * lut_row), ("lut_nr", tb * lut_row),
                       ("lut_gtl", tb * lut_row if mixed else 0),
                       ("lut_inv", tb * inv_row), ("lut_recnm", tb),
                       ("lut_recnr", tb)):
        d[name] = off
        off += _r16(4 * ints)
    d.update(lut_bytes=off, lut_row=lut_row, inv_row=inv_row, off_lut=0)
    off = 2 * off
    nbs = tb * ts
    for name, nbytes in (("off_hdr", 4 * _HEADER_INTS),
                         ("off_term", 4 * MAX_PLOIDY * TERM_ROWS),
                         ("off_cell", 8 * nbs), ("off_pll", 4 * nbs),
                         ("off_pcall", 4 * nbs)):
        d[name] = off
        off += _r16(nbytes)
    slot_w = _slot(4 * ts)
    for kind, rows, slot in (("ad", tb, _slot(ts * M * ev)),
                             ("gt", tb, _slot(ts * gt_w * ev)),
                             ("sc", 3 * tb, _slot(ts * es)),
                             ("dpi", tb, slot_w), ("info", nf * tb, slot_w),
                             ("pl", tb, _slot(ts * gc * ev))):
        d["off_" + kind] = off
        off += rows * slot
        if kind not in ("dpi", "info"):
            d["slot_" + kind] = slot
            d["l2u_" + kind] = _log2_units(slot)
    d.update(slot_w=slot_w, l2u_w=_log2_units(slot_w), smem=off)
    return d


@lru_cache(maxsize=256)
def tile_plan(B: int, S: int, M: int, G_out: int, gt_w: int, F: int,
              Fi: int, Fs: int, *, mixed: bool, narrow: bool,
              narrow_scalars: bool, n_sm: int = H100_SMS) -> TilePlan:
    """The kernel's plan for one launch.  Tiles hold up to 256
    (record, sample) pairs, 8 records by preference; the largest tile
    whose layout fits SMEM_TARGET wins, else the largest that fits
    SMEM_MAX.  When no whole PL row fits (m 16, ploidy 6: 54,264
    genotypes), tiles are 32 records x 1 sample and PL is written in
    chunks of genotypes, as many as fit; each (tile, chunk) is one work
    item of the grid."""
    ev = 2 if narrow else 4
    es = 2 if narrow_scalars else 4
    kw = dict(M=M, G_out=G_out, gt_w=gt_w, nf=F + Fi + Fs, ev=ev, es=es,
              mixed=mixed)
    shape = None
    for budget in (SMEM_TARGET, SMEM_MAX):
        for nbs in _TILE_SIZES:
            ts = max(1, min(nbs // _PREFERRED_TB, _p2(S)))
            tb_ = max(1, min(nbs // ts, _p2(B)))
            lay = _layout(tb_, ts, G_out, **kw)
            if lay["smem"] <= budget:
                shape = (tb_, ts, G_out, 1, lay)
                break
        if shape:
            break
    if shape is None:
        tb_, ts = 32, 1
        fixed = _layout(tb_, ts, 0, **kw)["smem"] - tb_ * _slot(0)
        gc = ((SMEM_MAX - fixed) // tb_ - 31) // ev
        while _layout(tb_, ts, gc, **kw)["smem"] > SMEM_MAX:
            gc -= 1
        if gc < 1:
            raise ValueError(f"no tile plan fits {SMEM_MAX} bytes of "
                             f"shared memory (M {M}, G_out {G_out})")
        shape = (tb_, ts, gc, -(-G_out // gc),
                 _layout(tb_, ts, gc, **kw))
    tb_, ts, gc, n_chunks, lay = shape
    n_ts = -(-S // ts)
    n_tiles = -(-B // tb_) * n_ts
    per_sm = max(1, min(2048 // THREADS, SMEM_PER_SM // (lay["smem"]
                                                           + 1024)))
    return TilePlan(tb=tb_, ts=ts, log2_tb=tb_.bit_length() - 1,
                    log2_nbs=(tb_ * ts).bit_length() - 1, gc=gc,
                    n_chunks=n_chunks, n_ts=n_ts, n_tiles=n_tiles,
                    grid=max(1, min(n_tiles * n_chunks, n_sm * per_sm)),
                    **lay)


def instantiation(ploidy: int, mixed: bool, M: int,
                  n_chunks: int) -> Tuple[str, int]:
    """The kernel instantiation a launch takes, as the .cu's `dispatch`
    picks it from the launch and its plan's PL passes: (family, bound on
    M).  "diploid" (ploidy 2, not mixed) and "ploidy2" (largest ploidy
    at most 2 and mixed, or ploidy 1) at M <= 4, 8 or 16; "polyploid"
    (ploidy 3-6, mixed or not, in one PL pass) at M <= 8 or 16, built
    per bound on the ploidy (3, 4, and 6 for 5 and 6); "general" (ploidy
    3-6 in genotype chunks), 0."""
    if ploidy == 2 and not mixed:
        return "diploid", 4 if M <= 4 else 8 if M <= 8 else 16
    if ploidy <= 2:
        return "ploidy2", 4 if M <= 4 else 8 if M <= 8 else 16
    if n_chunks == 1:
        return "polyploid", 8 if M <= 8 else 16
    return "general", 0


@lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def fused_gather_remap(pl, pl_len, ad, ad_len, gt, gq, dp, min_dp,
                       dp_info, info_f, info_i, info_fs, live, inv_bs,
                       nr_bs, rec_num_merged, rec_has_nr, gt_len_bs=None,
                       *, max_merged: int, ploidy: int,
                       gt_phase: bool = False, mixed: bool = False,
                       narrow: bool = False, narrow_scalars: bool = False
                       ) -> Dict[str, torch.Tensor]:
    """Live-cell gather + PL/AD/GT remap + masked passthroughs.

    Cell tensors [S, C, ...] (info rows [F, S, C]) as in CellBlock;
    live / nr_bs [B, S], inv_bs [B, S, M] int32, rec_num_merged [B]
    int32, rec_has_nr [B] bool, gt_len_bs [B, S] int32 (mixed only).
    Returns pl [B, S, G_out], ad [B, S, M], gt [B, S, gt_w], gq /
    dp_format / min_dp / dp_info [B, S], info_f / info_i / info_fs
    [F, B, S], int32 (float32 for info_f / info_fs).  With `narrow`,
    pl / ad / gt are int16 with the BCF16 sentinels (`to16`), and with
    `narrow_scalars` so are gq / dp_format / min_dp; the caller must
    have checked the value range (`_narrow_inputs_ok`,
    `_narrow_scalars_ok`).  CPU tensors run the plain twin; CUDA tensors
    launch the kernel and count the launch in
    `fused_gather_remap.launches` (the narrow ones also in
    `fused_gather_remap.narrow_launches`, the mixed-ploidy ones in
    `fused_gather_remap.mixed_launches`, those of the ploidy <= 2
    instantiation, mixed or haploid, in
    `fused_gather_remap.ploidy2_launches`, those of the polyploid one in
    `fused_gather_remap.polyploid_launches`)."""
    if narrow_scalars and not narrow:
        raise ValueError("narrow_scalars needs narrow")
    dev = live.device
    args = (pl, pl_len, ad, ad_len, gt, gq, dp, min_dp, dp_info, info_f,
            info_i, info_fs, live, inv_bs, nr_bs, rec_num_merged,
            rec_has_nr, gt_len_bs)
    kw = dict(max_merged=max_merged, ploidy=ploidy, gt_phase=gt_phase,
              mixed=mixed, narrow=narrow, narrow_scalars=narrow_scalars)
    if dev.type == "cpu":
        return fused_gather_remap_ref(*args, **kw)
    if dev.type != "cuda":
        raise ValueError(f"fused_gather_remap: unsupported device {dev}")
    return _launch(*args, **kw)


fused_gather_remap.launches = 0
fused_gather_remap.narrow_launches = 0
fused_gather_remap.mixed_launches = 0
fused_gather_remap.ploidy2_launches = 0
fused_gather_remap.polyploid_launches = 0


def _launch(*args, **kw):
    """Checks, allocates the outputs and launches the kernel on the
    caller's stream (keywords of `_prepare`); counts the launch."""
    out, launch = _prepare(*args, **kw)
    if launch is not None:
        launch()
        fg = fused_gather_remap
        fg.launches += 1
        if kw["narrow"]:
            fg.narrow_launches += 1
        if kw["mixed"]:
            fg.mixed_launches += 1
        family = instantiation(kw["ploidy"], kw["mixed"], kw["max_merged"],
                               launch.n_chunks)[0]
        if family == "ploidy2":
            fg.ploidy2_launches += 1
        elif family == "polyploid":
            fg.polyploid_launches += 1
    return out


def launch_plan(pl, live, gt, info_f, info_i, info_fs, *, max_merged,
                ploidy, mixed, narrow, narrow_scalars,
                n_sm: int = H100_SMS) -> TilePlan:
    """The tile plan of one launch on these tensors (`_prepare`'s)."""
    return tile_plan(live.shape[0], live.shape[1], max_merged,
                     len(genotype_combo_table(max_merged, ploidy)),
                     gt.shape[2], info_f.shape[0], info_i.shape[0],
                     info_fs.shape[0], mixed=bool(mixed),
                     narrow=bool(narrow),
                     narrow_scalars=bool(narrow_scalars), n_sm=n_sm)


def _prepare(pl, pl_len, ad, ad_len, gt, gq, dp, min_dp, dp_info, info_f,
             info_i, info_fs, live, inv_bs, nr_bs, rec_num_merged,
             rec_has_nr, gt_len_bs, *, max_merged, ploidy, gt_phase, mixed,
             narrow, narrow_scalars):
    """Checks the inputs, allocates the outputs and binds one launch of
    the kernel into them: (outputs, launch), where launch() enqueues the
    kernel on the caller's stream and raises if it was refused, and
    launch.n_chunks is its plan's PL passes (None when there is nothing
    to launch)."""
    from ._kernel_build import load_library
    dev = live.device
    S, C, G_in = pl.shape
    B = live.shape[0]
    A_in = ad.shape[2]
    gt_w = gt.shape[2]
    F, Fi, Fs = info_f.shape[0], info_i.shape[0], info_fs.shape[0]
    M = max_merged
    if not (1 <= ploidy <= MAX_PLOIDY) or not (1 <= M <= MAX_MERGED):
        raise ValueError(f"kernel takes ploidy 1..{MAX_PLOIDY} and "
                         f"1..{MAX_MERGED} merged alleles, got ploidy "
                         f"{ploidy}, {M} merged alleles")
    if mixed and gt_len_bs is None:
        raise ValueError("mixed ploidy needs gt_len_bs")
    i16, i32, f32 = torch.int16, torch.int32, torch.float32
    for name, t, dt, shape in (
            ("pl", pl, i32, (S, C, G_in)), ("pl_len", pl_len, i32, (S, C)),
            ("ad", ad, i32, (S, C, A_in)), ("ad_len", ad_len, i32, (S, C)),
            ("gt", gt, i32, (S, C, gt_w)), ("gq", gq, i32, (S, C)),
            ("dp", dp, i32, (S, C)), ("min_dp", min_dp, i32, (S, C)),
            ("dp_info", dp_info, i32, (S, C)),
            ("info_f", info_f, f32, (F, S, C)),
            ("info_i", info_i, i32, (Fi, S, C)),
            ("info_fs", info_fs, f32, (Fs, S, C)),
            ("live", live, i32, (B, S)), ("inv_bs", inv_bs, i32, (B, S, M)),
            ("nr_bs", nr_bs, i32, (B, S)),
            ("rec_num_merged", rec_num_merged, i32, (B,)),
            ("rec_has_nr", rec_has_nr, torch.bool, (B,))):
        _check(name, t, dt, shape, dev)
    if mixed:
        _check("gt_len_bs", gt_len_bs, i32, (B, S), dev)
    G_out = len(genotype_combo_table(M, ploidy))
    tables = _device_tables(M, ploidy, bool(mixed), dev)
    plan = launch_plan(pl, live, gt, info_f, info_i, info_fs, max_merged=M,
                       ploidy=ploidy, mixed=mixed, narrow=narrow,
                       narrow_scalars=narrow_scalars, n_sm=_sm_count(dev))
    plan_arr = plan.as_array()
    rec_nr = rec_has_nr.to(i32)
    vt = i16 if narrow else i32            # PL / AD / GT
    st = i16 if narrow_scalars else i32    # GQ / DP / MIN_DP
    out = {
        "pl": torch.empty((B, S, G_out), dtype=vt, device=dev),
        "ad": torch.empty((B, S, M), dtype=vt, device=dev),
        "gt": torch.empty((B, S, gt_w), dtype=vt, device=dev),
        "gq": torch.empty((B, S), dtype=st, device=dev),
        "dp_format": torch.empty((B, S), dtype=st, device=dev),
        "min_dp": torch.empty((B, S), dtype=st, device=dev),
        "dp_info": torch.empty((B, S), dtype=i32, device=dev),
        "info_f": torch.empty((F, B, S), dtype=f32, device=dev),
        "info_i": torch.empty((Fi, B, S), dtype=i32, device=dev),
        "info_fs": torch.empty((Fs, B, S), dtype=f32, device=dev),
    }
    if B * S == 0:
        return out, None
    kl = load_library()
    ins = (pl, pl_len, ad, ad_len, gt, gq, dp, min_dp, dp_info, info_f,
           info_i, info_fs, live, inv_bs, nr_bs, rec_num_merged, rec_nr)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
    call_args = (
        *[t.data_ptr() for t in ins],
        gt_len_bs.data_ptr() if mixed else None, tables.data_ptr(),
        *[out[k].data_ptr() for k in _OUT_KEYS],
        B, S, C, G_in, A_in, gt_w, M, G_out, ploidy, F, Fi, Fs,
        int(bool(gt_phase)), int(bool(mixed)), int(bool(narrow)),
        int(bool(narrow_scalars)), plan_arr.ctypes.data, len(plan_arr),
        stream)

    def launch():
        rc = kl.lib.gdb_fused_gather_remap(*call_args)
        if rc != 0:
            mode = "narrow" if narrow else "wide"
            raise RuntimeError(f"fused_gather_remap kernel launch ({mode}) "
                               "failed: "
                               + kl.lib.gdb_cuda_error_string(rc).decode())

    # the memory behind the pointers lives as long as the launch does
    launch.keeps = (ins, gt_len_bs, tables, out, plan_arr)
    launch.n_chunks = plan.n_chunks
    return out, launch


def fused_gather_remap_ref(pl, pl_len, ad, ad_len, gt, gq, dp, min_dp,
                           dp_info, info_f, info_i, info_fs, live, inv_bs,
                           nr_bs, rec_num_merged, rec_has_nr,
                           gt_len_bs=None, *, max_merged: int, ploidy: int,
                           gt_phase: bool = False, mixed: bool = False,
                           narrow: bool = False,
                           narrow_scalars: bool = False
                           ) -> Dict[str, torch.Tensor]:
    """Plain-torch twin of the kernel (same arguments, same outputs),
    built from the general path's gather and remap math; the narrow
    outputs are `to16` of its int32 ones."""
    g = gather_on_device(pl, pl_len, ad, ad_len, gt, gq, dp, min_dp,
                         dp_info, info_f, info_i, info_fs, live)
    pl_out, ad_out, gt_out = _remap_math(
        g["plg"], inv_bs, g["pllg"], nr_bs, g["adg"], g["adlg"], g["gtg"],
        rec_num_merged, rec_has_nr, gt_len_bs, max_merged=max_merged,
        ploidy=ploidy, gt_phase=gt_phase, mixed_ploidy=mixed)
    out = {"pl": pl_out, "ad": ad_out, "gt": gt_out, "gq": g["gqg"],
           "dp_format": g["dpfg"], "min_dp": g["mdpg"],
           "dp_info": g["dpig"], "info_f": g["infog"],
           "info_i": g["infoig"], "info_fs": g["infofsg"]}
    for k in (_NARROW_KEYS if narrow else ()) \
            + (_SCALAR_KEYS if narrow_scalars else ()):
        out[k] = to16(out[k])
    return out


def _fused_post(k: Dict[str, torch.Tensor], del_rw: torch.Tensor,
                live: torch.Tensor, med_rows=None,
                group=None) -> Dict[str, torch.Tensor]:
    """Kernel outputs -> the combine_step output dict
    (pallas_combine._fused_post): INFO rows of spanning-deletion-
    rewritten calls are masked, then the cross-sample reductions run in
    plain torch, over the `med_rows` rows only when given.  Narrow
    GQ/DP/MIN_DP feed the DP sum as widened copies and stay int16 in the
    result, for the fetch pack.  `group` is the mesh's row group when
    the outputs are one shard's (`_reduce_math`)."""
    iok = ~del_rw[None]                              # [1, B, S]
    infog = torch.where(iok, k["info_f"], float("nan"))
    infoig = torch.where(iok, k["info_i"], INT_MISSING)
    infofsg = torch.where(iok, k["info_fs"], float("nan"))
    infog, infoig, infofsg, med_valid = _restrict_rows(
        infog, infoig, infofsg, live >= 0, med_rows)
    scalars = [k[key] for key in _SCALAR_KEYS]
    narrow_scalars = scalars[0].dtype == torch.int16
    wide = [widen16(x) for x in scalars] if narrow_scalars else scalars
    res = _reduce_math(*wide, k["dp_info"], infog, infoig, infofsg,
                       med_valid, group=group)
    res.update(zip(_SCALAR_KEYS, scalars))
    res.update({"pl": k["pl"], "ad": k["ad"], "gt": k["gt"], "live": live})
    return res


def kernel_takes(blk, max_merged: int, ploidy: int,
                 mixed_ploidy: bool) -> bool:
    """The kernel's gates (the JAX combine_step_fused's): False for an
    empty block, ploidy above 6, more than 16 merged alleles, or mixed
    ploidy without stored GT lengths."""
    B, S = np.asarray(blk.live).shape
    return kernel_takes_shape(B, S, max_merged, ploidy) \
        and not (mixed_ploidy and blk.gt_len_bs is None)


def kernel_takes_shape(B: int, S: int, max_merged: int,
                       ploidy: int) -> bool:
    """The kernel's gates on a block's shape alone (`kernel_takes` for a
    block with stored GT lengths)."""
    return not (S == 0 or B == 0 or ploidy > MAX_PLOIDY
                or max_merged > MAX_MERGED)


def combine_step_fused(blk, device, *, max_merged: int, ploidy: int,
                       gt_phase: bool = False, mixed_ploidy: bool = False,
                       med_rows=None, narrow_out: bool = False
                       ) -> Optional[Dict[str, torch.Tensor]]:
    """The combine of one CellBlock through the kernel (its twin on the
    CPU) and the torch reductions.  Returns None for a block the kernel
    does not take — the gates of the JAX combine_step_fused: empty
    blocks, ploidy above 6, more than 16 merged alleles, mixed ploidy
    without stored GT lengths.  `narrow_out` asks for the narrow form,
    which the block gets when its values fit int16 (else the wide one);
    `med_rows` restricts the INFO reductions to those rows."""
    if not kernel_takes(blk, max_merged, ploidy, mixed_ploidy):
        return None
    if blk.inv_bs.shape[2] != max_merged:
        raise ValueError(f"block has {blk.inv_bs.shape[2]} merged-allele "
                         f"LUT columns, max_merged is {max_merged}")
    narrow = bool(narrow_out) and _narrow_inputs_ok(blk)
    t = block_to_tensors(blk, device)
    cells, (inv_bs, nr_bs, rec_nm, has_nr, live, del_rw, gt_lens) = \
        t[:12], t[12:]
    k = fused_gather_remap(
        *cells, live.to(torch.int32), inv_bs.to(torch.int32),
        nr_bs.to(torch.int32), rec_nm.to(torch.int32), has_nr,
        gt_lens.to(torch.int32) if mixed_ploidy else None,
        max_merged=max_merged, ploidy=ploidy, gt_phase=gt_phase,
        mixed=mixed_ploidy, narrow=narrow,
        narrow_scalars=narrow and _narrow_scalars_ok(blk))
    return _fused_post(k, del_rw, live.to(torch.int32), med_rows)


def combine_block(blk, device, *, max_merged: int, ploidy: int,
                  gt_phase: bool = False, mixed_ploidy: bool = False,
                  med_rows=None, narrow_out: bool = False
                  ) -> Dict[str, torch.Tensor]:
    """The block engine's device combine: combine_step_fused where its
    gates allow, else the general combine_step on the same device.
    Counts every block in `combine_block.blocks`, the general-path ones
    in `combine_block.general_path_blocks`, the kernel blocks that
    asked for the narrow form but took the wide one (values past the
    int16 range) in `combine_block.wide_blocks_when_packing`, and the
    kernel blocks of mixed ploidy in `combine_block.mixed_blocks`; the
    program counters `combine_blocks`, `combine_general_blocks` and
    `combine_mixed_blocks` count the same blocks in `profile.COUNTS`
    and the open request's tally.  Timed as the span `device.combine`:
    the upload, the launch and the torch post-pass as the host enqueues
    them; a general-path block's `combine_step` is the span
    `device.combine.general` inside it."""
    combine_block.blocks += 1
    profile.count("combine_blocks")
    with profile.span("device.combine"):
        out = combine_step_fused(blk, device, max_merged=max_merged,
                                 ploidy=ploidy, gt_phase=gt_phase,
                                 mixed_ploidy=mixed_ploidy,
                                 med_rows=med_rows, narrow_out=narrow_out)
        if out is None:
            combine_block.general_path_blocks += 1
            profile.count("combine_general_blocks")
            t = block_to_tensors(blk, device)
            with profile.span("device.combine.general"):
                return combine_step(*t, med_rows=med_rows,
                                    max_merged=max_merged, ploidy=ploidy,
                                    gt_phase=gt_phase,
                                    mixed_ploidy=mixed_ploidy)
    if narrow_out and out["pl"].dtype != torch.int16:
        combine_block.wide_blocks_when_packing += 1
    if mixed_ploidy:
        combine_block.mixed_blocks += 1
        profile.count("combine_mixed_blocks")
    return out


combine_block.blocks = 0
combine_block.general_path_blocks = 0
combine_block.wide_blocks_when_packing = 0
combine_block.mixed_blocks = 0
