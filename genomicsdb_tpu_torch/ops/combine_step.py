"""The general batched combine step in torch (counterpart of
`genomicsdb_tpu.ops.combine_step`).

For a block of B aligned intervals over S samples it performs, per
record, everything the reference's per-position operator stack does
(query_variants.cc:334 / broad_combined_gvcf.cc:765) as dense gathers
and masked reductions:

  1. live-cell gather per (interval, sample)
  2. PL genotype reorder onto merged alleles
  3. AD allele reorder
  4. GT remap
  5. INFO combine ops: median, int median, ordered float sum, DP logic
  6. GQ / MIN_DP / DP FORMAT collection

The same remap and reduction math backs three forms, as in the JAX
package:
  * combine_step        gathers the [S, C] cell tensors on the device;
                        it serves the blocks the CUDA kernel refuses
                        (more than 16 merged alleles, ploidy above 6),
                        and its remap math is the plain twin of that
                        kernel.  `med_rows` restricts the INFO
                        reductions; `remap_rows` restricts the PL/AD/GT
                        gathers and remaps to the given rows (the JAX
                        writer's CPU-device restriction; the port's
                        writer does not take it)
  * combine_step_dense  the same math on inputs the host gathered
                        (`gather_block_host`): the JAX package's
                        PCIe-host configuration; the bench's
                        `device_dense` lane, not the port's writer
  * parallel.sharded    the mesh, `group=` gathering the sample axis
All three are plain torch on either device (their JAX counterparts are
XLA, not Pallas).

Below the combine is the device->host fetch pack (the JAX module's
`PACK_SPECS` ... `host_identity_outputs`): the big outputs are narrowed
to int16 / int8 on the device and fetched, with the small full outputs,
as one contiguous byte blob, optionally holding only the variant rows;
the host widens them and rebuilds the ref-block rows itself, each
record at its own width (`RecordStrided`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core import formats, profile

from . import torch_kernels as K
from .cell_block import genotype_combo_table

INT_MISSING = formats.INT_MISSING
INT_VECTOR_END = formats.INT_VECTOR_END
INT16_MISSING = -32768       # bcf_int16_missing
INT16_VECTOR_END = -32767    # bcf_int16_vector_end


def _gather_cells(x: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """x: [S, C, ...]; live: [B, S] cell idx (-1 none) -> [B, S, ...].
    A row with no live cell reads cell 0 (callers mask it)."""
    idx = live.clamp(0, x.shape[1] - 1).long()
    s_idx = torch.arange(x.shape[0], device=x.device)[None, :]
    return x[s_idx, idx]


def gt_remap_unrolled(gtg: torch.Tensor, invg: torch.Tensor,
                      rec_num_merged: torch.Tensor,
                      rec_has_nr: torch.Tensor,
                      gt_phase: bool = False,
                      gt_lens: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """GT remap: input allele -> merged allele (invert inv_bs).  Matches
    VariantOperations::remap_GT_field (variant_operations.cc:233-260):
    with `gt_phase`, odd slots are interleaved phase flags and pass
    through unremapped; an input allele absent from the merge maps to
    NON_REF only when the merge has one.  When several merged alleles
    map to the same input allele, the last one wins."""
    M_dim = invg.shape[-1]
    P_dim = gtg.shape[-1]
    nr_merged = torch.where(rec_has_nr, rec_num_merged - 1, -1)[:, None]
    gt_cols = []
    for p in range(P_dim):
        a = gtg[..., p]                                 # [B, S]
        if gt_phase and p % 2 == 1:
            out_p = a                                   # phase flag slot
        else:
            merged = torch.full_like(a, -1)
            for m in range(M_dim):
                merged = torch.where(invg[..., m] == a, m, merged)
            ok = (a >= 0) & (a != INT_MISSING)
            out_p = torch.where(ok, torch.where(merged >= 0, merged,
                                                nr_merged), a)
        if gt_lens is not None:
            # slots past the call's stored GT length are VECTOR_END so
            # the renderer stops there (variable-ploidy cohorts)
            out_p = torch.where(p < gt_lens, out_p, INT_VECTOR_END)
        gt_cols.append(out_p.to(torch.int32))
    return torch.stack(gt_cols, dim=-1)


def masked_seq_sum_float(vals: torch.Tensor, ok: torch.Tensor):
    """Float sum over the LAST axis in ascending index order — bit-exact
    against the sequential writer's np.float32 left-fold accumulation
    (a tree-order torch.sum may round differently).  vals: [..., S]."""
    out = torch.zeros(vals.shape[:-1], dtype=torch.float32,
                      device=vals.device)
    for s in range(vals.shape[-1]):
        out = torch.where(ok[..., s], out + vals[..., s], out)
    return out, ok.any(dim=-1)


def _remap_math(plg, invg, pllg, nrg, adg, adlg, gtg, rec_num_merged,
                rec_has_nr, gt_lens=None, *, max_merged: int, ploidy: int,
                gt_phase: bool = False, mixed_ploidy: bool = False):
    """The allele/genotype remap part of the combine over gathered
    [B, S, ...] inputs: (pl_out, ad_out, gt_out)."""
    if mixed_ploidy and gt_lens is not None:
        # general ploidy: remap once per ploidy class (1..pmax) and
        # select per call by its GT-derived ploidy — the batched form of
        # the reference's per-call genotype enumeration
        # (variant_field_handler.cc:199-296)
        ploidy_bs = torch.div(gt_lens + 1, 2, rounding_mode="floor") \
            if gt_phase else gt_lens
        g_max = len(genotype_combo_table(max_merged, ploidy))
        pl_out = torch.full(tuple(plg.shape[:2]) + (g_max,),
                            INT_VECTOR_END, dtype=torch.int32,
                            device=plg.device)
        for p in range(1, ploidy + 1):
            v = K.remap_genotype_fields(plg, invg, pllg, nrg,
                                        rec_num_merged,
                                        num_merged_alleles=max_merged,
                                        ploidy=p)
            pad = g_max - v.shape[-1]
            if pad:
                v = torch.nn.functional.pad(v, (0, pad),
                                            value=INT_VECTOR_END)
            pl_out = torch.where((ploidy_bs == p)[..., None], v, pl_out)
    else:
        pl_out = K.remap_genotype_fields(plg, invg, pllg, nrg,
                                         rec_num_merged,
                                         num_merged_alleles=max_merged,
                                         ploidy=ploidy)
    ad_out = K.remap_allele_fields(adg, invg, adlg, nrg, rec_num_merged,
                                   alt_only=False)
    gt_out = gt_remap_unrolled(gtg, invg, rec_num_merged, rec_has_nr,
                               gt_phase,
                               gt_lens if mixed_ploidy else None)
    return pl_out, ad_out, gt_out


def _gather_sample_axis(group, valid, infog, infoig, infofsg, dpig, dpfg,
                        mdpg):
    """The arguments' full sample axis (their last) from every rank of
    the mesh's `group`, in rank order: the counterpart of the JAX
    `all_gather(x, "row", tiled=True)`.  One collective moves all seven,
    as int32 words stacked on a leading field axis (floats by their
    bits, so the NaN words of masked rows survive); the rank axis the
    gather puts in front moves beside the sample axis with one permute."""
    from ..parallel.comm import all_gather
    F, Fi = infog.shape[0], infoig.shape[0]
    words = torch.cat([valid.to(torch.int32)[None],
                       infog.view(torch.int32), infoig,
                       infofsg.view(torch.int32),
                       torch.stack([dpig, dpfg, mdpg])])   # [K, B, S_loc]
    g = all_gather(words, group)                           # [R, K, B, S_loc]
    R, K, B, S_loc = g.shape
    g = g.permute(1, 2, 0, 3).reshape(K, B, R * S_loc)
    return (g[0] != 0, g[1:1 + F].view(torch.float32),
            g[1 + F:1 + F + Fi], g[1 + F + Fi:K - 3].view(torch.float32),
            g[K - 3], g[K - 2], g[K - 1])


def _reduce_math(gqg, dpfg, mdpg, dpig, infog, infoig, infofsg, valid,
                 group=None) -> Dict[str, torch.Tensor]:
    """Cross-sample INFO reductions over gathered [B, S] inputs (shared
    by the general and the kernel paths).  With `group` (the mesh's row
    group, each rank holding a slice of the sample axis), the inputs'
    full sample axis is gathered from the group's ranks first and the
    local math then runs unchanged, so the results equal the unsharded
    ones bit for bit; GQ / DP / MIN_DP stay the local slices."""
    if group is not None:
        valid, infog, infoig, infofsg, dpig, dpf_f, mdp_f = \
            _gather_sample_axis(group, valid, infog, infoig, infofsg, dpig,
                                dpfg, mdpg)
    else:
        dpf_f, mdp_f = dpfg, mdpg
    # INFO medians over samples (invalid float inputs are NaN -> excluded
    # via isfinite)
    finite = torch.isfinite(infog) & valid[None]
    med, med_ok = K.masked_median_float(
        torch.where(finite, infog, float("inf")), finite)
    # int INFO medians (exact int32 path; float32 cannot represent all)
    i_ok = (infoig != INT_MISSING) & valid[None]
    imed, imed_ok = K.masked_median_int(
        torch.where(i_ok, infoig, K.INT32_MAX), i_ok)
    # float INFO sums, sequential accumulation order
    fs_ok = torch.isfinite(infofsg) & valid[None]
    fsum, fsum_ok = masked_seq_sum_float(
        torch.where(fs_ok, infofsg, 0.0), fs_ok)
    dp_sum = K.dp_combine(dpig, dpf_f, mdp_f, dpig != INT_MISSING,
                          dpf_f != INT_MISSING, mdp_f != INT_MISSING)
    return {
        "info_median": med, "info_median_ok": med_ok,
        "info_imedian": imed, "info_imedian_ok": imed_ok,
        "info_fsum": fsum, "info_fsum_ok": fsum_ok,
        "dp_info_sum": dp_sum, "gq": gqg, "dp_format": dpfg,
        "min_dp": mdpg,
    }


def _restrict_rows(infog, infoig, infofsg, valid, med_rows):
    """The INFO median / sum inputs [F, B, S] and their validity [B, S]
    restricted to `med_rows` (the rows carrying any valid input; the
    writer scatters the [F, len(med_rows)] results back), or unchanged
    when `med_rows` is None."""
    if med_rows is None:
        return infog, infoig, infofsg, valid
    idx = torch.as_tensor(med_rows, device=valid.device).long()
    return infog[:, idx], infoig[:, idx], infofsg[:, idx], valid[idx]


def _gather_info(f: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """[F, S, C] INFO rows -> [F, B, S] at each (record, sample)'s live
    cell."""
    if not f.shape[0]:
        return f.new_empty((0,) + tuple(live.shape))
    return torch.stack([_gather_cells(f[i], live) for i in range(f.shape[0])])


def _gather_reduced(dp, min_dp, dp_info, info_f, info_i, info_fs, live,
                    del_rw):
    """The masked [B, S] DP inputs and [F, B, S] INFO inputs of the
    cross-sample reductions: (dpfg, mdpg, dpig, infog, infoig, infofsg,
    valid).  `del_rw` masks spanning-deletion-rewritten calls out of the
    INFO inputs."""
    valid = live >= 0
    info_ok = valid if del_rw is None else (valid & ~del_rw)

    def g(x):
        return torch.where(valid, _gather_cells(x, live), INT_MISSING)

    return (g(dp), g(min_dp), g(dp_info),
            torch.where(info_ok[None], _gather_info(info_f, live),
                        float("nan")),
            torch.where(info_ok[None], _gather_info(info_i, live),
                        INT_MISSING),
            torch.where(info_ok[None], _gather_info(info_fs, live),
                        float("nan")),
            valid)


def gather_on_device(pl, pl_len, ad, ad_len, gt, gq, dp, min_dp, dp_info,
                     info_f, info_i, info_fs, live, del_rw=None):
    """Per-(record, sample) live-cell gather of the [S, C, ...] cell
    tensors -> dense [B, S, ...] inputs for the remap and reduction
    math.  `del_rw` masks spanning-deletion-rewritten calls out of the
    INFO inputs."""
    dpfg, mdpg, dpig, infog, infoig, infofsg, valid = _gather_reduced(
        dp, min_dp, dp_info, info_f, info_i, info_fs, live, del_rw)

    def g(x):
        return _gather_cells(x, live)

    # plg/adg are not masked: invalid slots gather cell 0, and the remaps
    # mask their outputs through pl_len / ad_len == 0 there
    return {
        "plg": g(pl), "pllg": torch.where(valid, g(pl_len), 0),
        "adg": g(ad), "adlg": torch.where(valid, g(ad_len), 0),
        "gtg": torch.where(valid[..., None], g(gt), INT_MISSING),
        "gqg": torch.where(valid, g(gq), INT_MISSING),
        "dpfg": dpfg, "mdpg": mdpg, "dpig": dpig, "infog": infog,
        "infoig": infoig, "infofsg": infofsg, "valid": valid,
    }


def combine_step(pl, pl_len, ad, ad_len, gt, gq, dp, min_dp,
                 dp_info, info_f, info_i, info_fs, inv_bs, nr_bs,
                 rec_num_merged, rec_has_nr, live, del_rw=None,
                 gt_len_bs=None, med_rows=None, remap_rows=None, *,
                 max_merged: int, ploidy: int, gt_phase: bool = False,
                 mixed_ploidy: bool = False,
                 group=None) -> Dict[str, torch.Tensor]:
    """The whole combine on tensors of one device (argument order of
    `block_to_tensors`).  Returns the output dict of the JAX
    `combine_step`, with the same keys and dtypes; with `med_rows`, the
    INFO reductions cover those rows only.  With `remap_rows` (record
    indices, padding repeats a row), the PL/AD/GT gathers and remaps
    and the GQ gather run on those rows only, and pl / ad / gt / gq /
    dp_format / min_dp come back [len(remap_rows), S, ...]; the DP and
    INFO reductions still cover every row (the JAX CPU-device
    configuration: ref-block rows are identity passthroughs the host
    rebuilds, `host_identity_outputs`).  With `group`, the tensors are
    one mesh shard's and the reductions gather the sample axis over it
    (`_reduce_math`; the JAX `sharded_combine_step`)."""
    live = live.to(torch.int32)
    inv_bs = inv_bs.to(torch.int32)
    nr_bs = nr_bs.to(torch.int32)
    rec_num_merged = rec_num_merged.to(torch.int32)
    if gt_len_bs is not None:
        gt_len_bs = gt_len_bs.to(torch.int32)
    flags = dict(max_merged=max_merged, ploidy=ploidy, gt_phase=gt_phase,
                 mixed_ploidy=mixed_ploidy)
    if remap_rows is None:
        g = gather_on_device(pl, pl_len, ad, ad_len, gt, gq, dp, min_dp,
                             dp_info, info_f, info_i, info_fs, live, del_rw)
        pl_out, ad_out, gt_out = _remap_math(
            g["plg"], inv_bs, g["pllg"], nr_bs, g["adg"], g["adlg"],
            g["gtg"], rec_num_merged, rec_has_nr, gt_len_bs, **flags)
        out = _reduce_math(g["gqg"], g["dpfg"], g["mdpg"], g["dpig"],
                           *_restrict_rows(g["infog"], g["infoig"],
                                           g["infofsg"], g["valid"],
                                           med_rows),
                           group=group)
        out.update({"pl": pl_out, "ad": ad_out, "gt": gt_out, "live": live})
        return out
    rows = torch.as_tensor(np.asarray(remap_rows), device=live.device).long()
    live_r = live[rows]
    valid_r = live_r >= 0

    def g_r(x):
        return _gather_cells(x, live_r)

    pl_out, ad_out, gt_out = _remap_math(
        g_r(pl), inv_bs[rows], torch.where(valid_r, g_r(pl_len), 0),
        nr_bs[rows], g_r(ad), torch.where(valid_r, g_r(ad_len), 0),
        torch.where(valid_r[..., None], g_r(gt), INT_MISSING),
        rec_num_merged[rows], rec_has_nr[rows],
        gt_len_bs[rows] if gt_len_bs is not None else None, **flags)
    dpfg, mdpg, dpig, infog, infoig, infofsg, valid = _gather_reduced(
        dp, min_dp, dp_info, info_f, info_i, info_fs, live, del_rw)
    gqg = torch.where(valid_r, g_r(gq), INT_MISSING)
    out = _reduce_math(gqg, dpfg, mdpg, dpig,
                       *_restrict_rows(infog, infoig, infofsg, valid,
                                       med_rows),
                       group=group)
    out.update({"pl": pl_out, "ad": ad_out, "gt": gt_out, "live": live,
                "dp_format": dpfg[rows], "min_dp": mdpg[rows]})
    return out


def gather_block_host(blk, live: np.ndarray) -> Dict[str, np.ndarray]:
    """Host-side live-cell gather (numpy): the dense per-record inputs
    of combine_step_dense, a copy of the JAX package's
    `gather_block_host`.  Takes a block built by either package."""
    valid = live >= 0
    k = np.clip(live, 0, blk.col.shape[1] - 1)
    s_i = np.arange(blk.col.shape[0])[None, :]

    info_ok = valid if blk.del_rw is None else (valid & ~blk.del_rw)

    def g2(x, fill):
        return np.where(valid, x[s_i, k], fill)

    def g3(x, fill):
        return np.where(valid[..., None], x[s_i, k], fill)

    return {
        "plg": g3(blk.pl, INT_MISSING), "invg": blk.inv_bs,
        "pllg": g2(blk.pl_len, 0), "nrg": blk.nr_bs,
        "adg": g3(blk.ad, INT_MISSING), "adlg": g2(blk.ad_len, 0),
        "gtg": g3(blk.gt, INT_MISSING), "gqg": g2(blk.gq, INT_MISSING),
        "dpfg": g2(blk.dp, INT_MISSING), "mdpg": g2(blk.min_dp,
                                                    INT_MISSING),
        "dpig": g2(blk.dp_info, INT_MISSING),
        "infog": np.where(info_ok[None], blk.info_f[:, s_i, k], np.nan),
        "infoig": np.where(info_ok[None], blk.info_i[:, s_i, k],
                           INT_MISSING),
        "infofsg": np.where(info_ok[None], blk.info_fs[:, s_i, k],
                            np.nan),
        "valid": valid,
    }


#: combine_step_dense's tensor arguments, in order: gather_block_host's
#: keys
DENSE_KEYS = ("plg", "invg", "pllg", "nrg", "adg", "adlg", "gtg", "gqg",
              "dpfg", "mdpg", "dpig", "infog", "infoig", "infofsg", "valid")


def combine_step_dense(plg, invg, pllg, nrg, adg, adlg, gtg, gqg, dpfg,
                       mdpg, dpig, infog, infoig, infofsg, valid,
                       rec_num_merged, rec_has_nr=None, gt_lens=None, *,
                       max_merged: int, ploidy: int,
                       gt_phase: bool = False,
                       mixed_ploidy: bool = False
                       ) -> Dict[str, torch.Tensor]:
    """combine_step on host-pre-gathered dense [B, S, ...] inputs
    (gather_block_host's, as tensors of one device): only the remap and
    reduction math runs there.  The output dict of the JAX
    `combine_step_dense` (combine_step's keys but "live")."""
    rec_num_merged = rec_num_merged.to(torch.int32)
    if rec_has_nr is None:
        rec_has_nr = torch.ones(rec_num_merged.shape, dtype=torch.bool,
                                device=rec_num_merged.device)
    pl_out, ad_out, gt_out = _remap_math(
        plg, invg, pllg, nrg, adg, adlg, gtg, rec_num_merged, rec_has_nr,
        gt_lens, max_merged=max_merged, ploidy=ploidy, gt_phase=gt_phase,
        mixed_ploidy=mixed_ploidy)
    out = _reduce_math(gqg, dpfg, mdpg, dpig, infog, infoig, infofsg, valid)
    out.update({"pl": pl_out, "ad": ad_out, "gt": gt_out})
    return out


def dense_tensors(g: Dict[str, np.ndarray], device) -> tuple:
    """gather_block_host's arrays as tensors on `device`, in
    combine_step_dense's argument order."""
    return tuple(to_tensor(g[k], device) for k in DENSE_KEYS)


def block_to_tensors(blk, device) -> tuple:
    """A CellBlock's arrays as tensors on `device`, in `combine_step`'s
    argument order (the counterpart of the JAX `block_to_args`).  Every
    chunk of every query of a store shares the slabs of its store-wide
    dense layout: their device copies are the store's table
    `slab_upload`, so a query uploads them once, not once per chunk."""
    slabs = slab_arrays(blk)
    with profile.span("device.upload"):
        return blk.derived(
            "slab_upload", (str(torch.device(device)), slabs),
            lambda: tuple(to_tensor(a, device) for a in slabs)) \
            + tuple(to_tensor(a, device) for a in per_block_arrays(blk))


def slab_arrays(blk) -> tuple:
    """The block's 12 [S, C, ...] cell slabs, in combine_step's argument
    order."""
    return (blk.pl, blk.pl_len, blk.ad, blk.ad_len, blk.gt, blk.gq,
            blk.dp, blk.min_dp, blk.dp_info, blk.info_f, blk.info_i,
            blk.info_fs)


def per_block_arrays(blk) -> tuple:
    """The block's last seven combine_step arguments as host arrays:
    inv_bs, nr_bs, rec_num_merged, has_nr, live, del_rw, gt_lens (the
    optional ones filled as block_to_tensors fills them)."""
    del_rw = blk.del_rw if blk.del_rw is not None \
        else np.zeros(blk.live.shape, dtype=bool)
    has_nr = blk.rec_has_nr if blk.rec_has_nr is not None \
        else np.ones(len(blk.rec_num_merged), dtype=bool)
    gt_w = blk.gt.shape[2]
    gt_lens = blk.gt_len_bs if blk.gt_len_bs is not None \
        else np.full(blk.live.shape, gt_w, dtype=np.int32)
    return (blk.inv_bs, blk.nr_bs, blk.rec_num_merged, has_nr, blk.live,
            del_rw, gt_lens)


def to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """numpy -> tensor on `device` (read-only arrays, e.g. memory-mapped
    store columns, are copied first: torch wants writable memory).
    Counts the bytes copied to a device other than the CPU in
    `profile.COUNTS.h2d_bytes`."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    if torch.device(device).type != "cpu":
        profile.count("h2d_bytes", a.nbytes)
    return torch.from_numpy(a).to(device)


# ---------------- device->host fetch compaction ----------------
#
# The JAX module's fetch pack (genomicsdb_tpu.ops.combine_step:443-872).
# The big output tensors carry small values (PL/AD counters, allele
# codes), so the device narrows them to int16/int8 after the combine (or
# the kernel already wrote them narrow); the host fetches the narrow copy
# plus a per-tensor "fits" flag, and fetches the int32 original only
# when a value genuinely overflows.  Sentinels map to the matching BCF
# narrow sentinels.  The blob layout is the JAX package's, byte for
# byte: sorted keys, each part padded to 8 bytes, a fits flag before its
# data, then the small full outputs.

PACK_SPECS = {
    # key -> (np dtype, missing, vector_end, lo, hi)
    "pl": (np.int16, -32768, -32767, -32000, 32000),
    "ad": (np.int16, -32768, -32767, -32000, 32000),
    "gt": (np.int8, -128, -127, -100, 100),
    "gq": (np.int16, -32768, -32767, -32000, 32000),
    "dp_format": (np.int16, -32768, -32767, -32000, 32000),
    "min_dp": (np.int16, -32768, -32767, -32000, 32000),
    "live": (np.int16, -32768, -32767, -32000, 32000),
}

IDENT_KEYS = ("pl", "ad", "gt", "gq", "dp_format", "min_dp")

_TORCH_OF_NP = {np.dtype(np.int8): torch.int8,
                np.dtype(np.int16): torch.int16}
_NP_OF_TORCH = {torch.bool: np.uint8, torch.uint8: np.uint8,
                torch.int8: np.int8, torch.int16: np.int16,
                torch.int32: np.int32, torch.int64: np.int64,
                torch.float32: np.float32, torch.float64: np.float64}


def _narrow_one(k: str, v: torch.Tensor):
    """(fits, packed) for one PACK_SPECS tensor.  An int16 input is
    already narrowed by the kernel (BCF16 sentinels baked in): int16-spec
    keys pass through (fits is constant True: the host proved the input
    ranges before it chose the narrow kernel); int8-spec keys (gt)
    re-narrow 16->8 with the sentinel remap."""
    dt, miss, eov, lo, hi = PACK_SPECS[k]
    if v.dtype == torch.int16:
        if np.dtype(dt) == np.int16:
            return torch.ones((), dtype=torch.bool, device=v.device), v
        src_miss, src_eov = INT16_MISSING, INT16_VECTOR_END
    else:
        src_miss, src_eov = INT_MISSING, INT_VECTOR_END
    is_m = v == src_miss
    is_e = v == src_eov
    ok = (is_m | is_e | ((v >= lo) & (v <= hi))).all()
    p = torch.where(is_m, miss, torch.where(is_e, eov, v.clamp(lo, hi)))
    return ok, p.to(_TORCH_OF_NP[np.dtype(dt)])


def pack_outputs(out: Dict[str, torch.Tensor],
                 rows: Optional[np.ndarray] = None) -> Optional[Dict]:
    """The whole fetch tree of a combine output dict as ONE contiguous
    uint8 tensor on its device: the narrowed PACK_SPECS tensors with
    their fits flags, then every other output whole.  With `rows`, only
    those [B, ...] rows of the narrowed tensors are kept: the
    variant-record-only fetch (ref-block rows are identity remaps the
    host rebuilds, host_identity_outputs).

    On a CUDA device the blob's copy to the host starts here: into a
    pinned host buffer that this pack owns, with an event recorded
    after the copy that the fetch waits on (the JAX writer's
    `copy_to_host_async`).  Returns {"__blob__", "__layout__"} (plus
    "__host__" and "__ready__" on CUDA), or None when `out` holds no
    packable tensor.  Timed as the span `device.pack`."""
    with profile.span("device.pack"):
        return _pack_outputs(out, rows)


def _pack_outputs(out, rows):
    packable = {k: v for k, v in out.items()
                if k in PACK_SPECS and k != "live"}
    if not packable:
        return None
    extras = {k: v for k, v in out.items() if k not in PACK_SPECS}
    dev = next(iter(packable.values())).device
    idx = None if rows is None else torch.as_tensor(
        np.asarray(rows, dtype=np.int64), device=dev)
    parts, layout = [], []

    def emit(name: str, v: torch.Tensor, is_bool: bool = False) -> None:
        dt = np.dtype(_NP_OF_TORCH[v.dtype])
        if v.dtype == torch.bool:
            v = v.to(torch.uint8)
        b = v.contiguous().reshape(-1).view(torch.uint8)
        pad = (-b.numel()) % 8
        parts.append(b)
        if pad:
            parts.append(torch.zeros(pad, dtype=torch.uint8, device=dev))
        layout.append((name, dt.str, tuple(v.shape), is_bool,
                       b.numel() + pad))

    for k in sorted(packable):
        v = packable[k] if idx is None else packable[k][idx]
        ok, p = _narrow_one(k, v)
        emit("fits::" + k, ok.reshape(1), is_bool=True)
        emit("data::" + k, p)
    for k in sorted(extras):
        v = extras[k]
        emit("x::" + k, v, is_bool=v.dtype == torch.bool)
    blob = torch.cat(parts)
    packed = {"__blob__": blob, "__layout__": layout}
    if blob.device.type == "cuda":
        host = torch.empty(blob.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(blob, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(blob.device))
        packed.update({"__host__": host, "__ready__": ready})
    return packed


def _host_blob(packed: Dict) -> np.ndarray:
    """The blob's bytes on the host: the pinned copy pack_outputs
    started, once its event has completed, or the CPU blob itself."""
    fetch_outputs.fetched_bytes += packed["__blob__"].numel()
    host = packed.get("__host__")
    if host is None:
        return packed["__blob__"].numpy()
    with profile.span("device.fetch.wait"):
        packed["__ready__"].synchronize()
    return host.numpy()


def _fetch_whole(v: torch.Tensor) -> np.ndarray:
    fetch_outputs.fetched_bytes += v.numel() * v.element_size()
    with profile.span("device.fetch.wait"):
        return v.cpu().numpy()


def _unpack_blob(blob: np.ndarray, layout) -> Dict[str, np.ndarray]:
    """Host views over the fetched blob (zero extra copies)."""
    out = {}
    off = 0
    for name, dtstr, shape, is_bool, padded in layout:
        dt = np.dtype(dtstr)
        n = int(np.prod(shape, dtype=np.int64))
        a = np.frombuffer(blob, dtype=dt, count=n, offset=off)
        a = a.reshape(shape)
        if is_bool:
            a = a != 0
        out[name] = a
        off += padded
    return out


def _widen(v: np.ndarray, miss: int, eov: int) -> np.ndarray:
    w = v.astype(np.int32)
    w[v == miss] = INT_MISSING
    w[v == eov] = INT_VECTOR_END
    return w


def _fetch_blob_tree(out: Dict[str, torch.Tensor], packed: Dict):
    """ONE device->host copy for the whole fetch tree (see
    pack_outputs): host views over the blob, and a fetch of the whole
    device tensor only for a key whose fits flag reads false (the
    kernel-narrowed int16 tensor then, never a stale int32 one)."""
    parts = _unpack_blob(_host_blob(packed), packed["__layout__"])
    got: Dict[str, np.ndarray] = {}
    narrow = set()
    for k, v in out.items():
        if ("data::" + k) in parts and bool(parts["fits::" + k][0]):
            got[k] = parts["data::" + k]
            narrow.add(k)
        elif ("x::" + k) in parts:
            got[k] = parts["x::" + k]
        else:
            got[k] = _fetch_whole(v)
    return got, narrow


def fetch_outputs(out: Dict[str, torch.Tensor],
                  packed: Optional[Dict] = None) -> Dict[str, np.ndarray]:
    """Host arrays of a combine-step output dict, dense.  With `packed`
    (from pack_outputs), narrow tensors come from the blob and are
    widened on the host (the span `device.fetch.fill`); an int32
    original is fetched only if its values overflowed.  Every fetch
    (this one, fetch_outputs_split) adds the bytes it copies to the host
    to `fetch_outputs.fetched_bytes`, and the bytes of the host outputs
    it returns to the counter `host_output_bytes`.  Timed as the span
    `device.fetch`."""
    with profile.span("device.fetch"):
        return _counted(_fetch_outputs(out, packed))


def _counted(dev: Dict) -> Dict:
    profile.count("host_output_bytes",
                  sum(v.nbytes for k, v in dev.items() if k != "live"))
    return dev


def _fetch_outputs(out, packed):
    if packed is None:
        return {k: _fetch_whole(v) for k, v in out.items()}
    got, narrow = _fetch_blob_tree(out, packed)
    dev: Dict[str, np.ndarray] = {}
    with profile.span("device.fetch.fill"):
        for k, v in got.items():
            if k in narrow:
                _, miss, eov, _, _ = PACK_SPECS[k]
                dev[k] = _widen(v, miss, eov)
            elif k in PACK_SPECS and v.dtype == np.int16:
                # kernel-narrowed tensor fetched whole: BCF16 sentinels
                dev[k] = _widen(v, INT16_MISSING, INT16_VECTOR_END)
            else:
                dev[k] = v
    return dev


fetch_outputs.fetched_bytes = 0


class RecordStrided:
    """A [B, S, ...] int32 output kept at each record's own width:
    element (b, s, j), j < w[b], is vals[off[b] + s * w[b] + j].  The
    split fetch's PL / AD / GT take this form, so a block's reference
    rows hold the few slots their identity remap fills, not the widest
    record's.  A dense [B, S, W] array is the uniform case (`of`:
    off[b] = b * S * W, w[b] = W, its values not copied); the renderer
    reads both through it."""

    __slots__ = ("vals", "off", "w", "S")

    def __init__(self, vals: np.ndarray, off: np.ndarray, w: np.ndarray,
                 S: int):
        self.vals, self.off, self.w, self.S = vals, off, w, S

    @classmethod
    def alloc(cls, w: np.ndarray, S: int) -> "RecordStrided":
        """Unfilled int32 values for records of widths `w` over S
        samples."""
        w = np.ascontiguousarray(w, dtype=np.int64)
        off = np.zeros(len(w), np.int64)
        np.cumsum(S * w[:-1], out=off[1:])
        return cls(np.empty(int(S * w.sum()), np.int32), off, w, S)

    @classmethod
    def of(cls, a) -> "RecordStrided":
        """`a` itself, or a dense [B, S(, W)] array as the uniform case
        (viewed where it is C-contiguous, as every fetched output is)."""
        if isinstance(a, cls):
            return a
        a = np.ascontiguousarray(a)
        if a.ndim == 2:
            a = a[:, :, None]
        B, S, W = a.shape
        return cls(a.reshape(-1), np.arange(B, dtype=np.int64) * (S * W),
                   np.full(B, W, np.int64), S)

    @property
    def nbytes(self) -> int:
        return self.vals.nbytes + self.off.nbytes + self.w.nbytes

    def row(self, b: int) -> np.ndarray:
        """Record b's [S, w[b]] values, viewed."""
        o, w = int(self.off[b]), int(self.w[b])
        return self.vals[o:o + self.S * w].reshape(self.S, w)

    def put(self, rows: np.ndarray, dense: np.ndarray) -> None:
        """Write dense[i] ([n, S, >= w]) into record rows[i], for rows
        that share one width."""
        if not len(rows):
            return
        w = int(self.w[rows[0]])
        idx = self.off[rows][:, None] + np.arange(self.S * w)[None]
        self.vals[idx] = np.ascontiguousarray(
            dense[:, :, :w]).reshape(len(rows), -1)

    def take(self, rows: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """The values (r, s, j < min(lens[r, s], w)) of records `rows`,
        flat in that order."""
        out = []
        for r, b in enumerate(rows):
            v = self.row(int(b))
            out.append(v[np.arange(v.shape[1])[None] < lens[r][:, None]])
        return np.concatenate(out) if out else np.zeros(0, np.int32)


def fetch_outputs_split(out: Dict[str, torch.Tensor], packed: Dict,
                        var_rows: np.ndarray, ref_rows: np.ndarray,
                        live_rows: np.ndarray, ploidy: int,
                        ident) -> Dict:
    """Host outputs from a variant-row-only fetch
    (pack_outputs(rows=var_rows)) plus host-rebuilt ref-block rows.
    The narrowed [B, S, W] outputs (PL / AD / GT) come back
    `RecordStrided`: a variant row at the blob's width, a reference row
    at `ploidy + 1` PL and 2 AD slots, a row with no live cell (`live_rows` false:
    bucket padding, rows never rendered) at width 0.  The narrowed
    [B, S] outputs come back dense, MISSING outside the rows filled.
    `ident(dest, rows)` writes reference rows `rows` into `dest` (the
    narrowed IDENT_KEYS outputs: `identity_fill`).  Reductions and
    int32 overflow fallbacks come back dense and whole.  Timed as the
    span `device.fetch`; the host outputs' allocation and fills as its
    child `device.fetch.fill`; their bytes counted in
    `host_output_bytes`."""
    with profile.span("device.fetch"):
        return _counted(_fetch_outputs_split(
            out, packed, var_rows, ref_rows, live_rows, ploidy, ident))


def _fetch_outputs_split(out, packed, var_rows, ref_rows, live_rows,
                         ploidy, ident):
    from ..runtime import native_loader
    got, narrow = _fetch_blob_tree(
        {k: v for k, v in out.items() if k != "live"}, packed)
    with profile.span("device.fetch.fill"):
        B = len(live_rows)
        ref_rows = ref_rows[live_rows[ref_rows]]
        var_kept = live_rows[var_rows]
        # a reference row's identity remap fills genotypes g <= ploidy
        # and alleles m < 2 (host_identity_outputs), and every GT slot
        ref_w = {"pl": ploidy + 1, "ad": 2, "gt": np.inf}
        dev: Dict = {}
        ident_dest: Dict = {}
        for k, v in got.items():
            if k in narrow:
                _, miss, eov, _, _ = PACK_SPECS[k]
                if v.ndim == 2:
                    # [B, S] presence columns: rows outside the scatter
                    # (no live cell / bucket padding) must read MISSING
                    full = np.full((B,) + v.shape[1:], INT_MISSING,
                                   dtype=np.int32)
                    dest_off = var_rows * v.shape[1]
                    flat = full.reshape(-1)
                else:
                    w = np.zeros(B, np.int64)
                    w[var_rows[var_kept]] = v.shape[2]
                    w[ref_rows] = min(ref_w[k], v.shape[2])
                    full = RecordStrided.alloc(w, v.shape[1])
                    dest_off = np.where(var_kept, full.off[var_rows], -1)
                    flat = full.vals
                # widen + sentinel remap + scatter in one threaded
                # native pass (numpy otherwise)
                if native_loader.widen_scatter(v, dest_off, miss, eov,
                                               flat) is None:
                    if v.ndim == 2:
                        full[var_rows] = _widen(v, miss, eov)
                    else:
                        full.put(var_rows[var_kept],
                                 _widen(v[var_kept], miss, eov))
                if k in IDENT_KEYS:
                    ident_dest[k] = full
                dev[k] = full
            elif k in PACK_SPECS and v.dtype == np.int16:
                # kernel-narrowed tensor fetched whole (not row-sliced)
                dev[k] = _widen(v, INT16_MISSING, INT16_VECTOR_END)
            else:
                dev[k] = v
        if ident_dest and len(ref_rows):
            ident(ident_dest, ref_rows)
    return dev


def identity_fill(blk, dest: Dict, rows: np.ndarray, gt_phase: bool,
                  mixed_ploidy: bool) -> None:
    """Write host_identity_outputs of reference rows `rows` into their
    records of `dest` (some of IDENT_KEYS: PL / AD / GT record-strided
    at the widths they hold there, the rest dense [B, S]); in one
    native pass when `dest` holds every key, else through the dict
    form."""
    from ..runtime import native_loader
    live = np.asarray(blk.live)[rows]
    gtl_r = np.asarray(blk.gt_len_bs)[rows] if mixed_ploidy else None
    if set(dest) == set(IDENT_KEYS) and native_loader.identity_outputs(
            live, blk.pl, blk.pl_len, blk.ad, blk.ad_len, blk.gt, blk.gq,
            blk.dp, blk.min_dp, gtl_r, None, blk.ploidy, gt_phase,
            mixed_ploidy, out=dest, dest_rows=rows) is not None:
        return
    widths = tuple(int(dest[k].w[rows].max()) if k in dest else 1
                   for k in ("pl", "ad", "gt"))
    got = host_identity_outputs(blk, rows, widths, gt_phase, mixed_ploidy)
    for k, v in dest.items():
        if isinstance(v, RecordStrided):
            v.put(rows, got[k])
        else:
            v[rows] = got[k]


def host_identity_outputs(blk, rows: np.ndarray,
                          widths: Tuple[int, int, int], gt_phase: bool,
                          mixed_ploidy: bool) -> Dict[str, np.ndarray]:
    """Combine outputs for REF-BLOCK-ONLY records, computed on the host.

    Every live cell of such a record is a pure reference block: the
    allele LUT is the identity [REF, NON_REF] and the device remap is a
    masked passthrough of the raw cell values, which the host already
    holds.  Equal to the device combine at these rows: PL slots
    g <= ploidy gated by pl_len / ploidy class (ploidy-0 calls stay
    INT_VECTOR_END in mixed mode); AD slots m < 2 gated by ad_len; GT
    allele slots pass through with absent alleles mapped to the NON_REF
    merged index 1, phase slots untouched; GQ/DP/MIN_DP masked
    passthroughs.  The shared native `identity_outputs` computes it;
    the numpy form below runs without the native library."""
    from ..runtime import native_loader
    G_out, M_out, P_out = widths
    S = blk.live.shape[1]
    live = np.asarray(blk.live)[rows]
    gtl_r = np.asarray(blk.gt_len_bs)[rows] if mixed_ploidy else None
    nat = native_loader.identity_outputs(
        live, blk.pl, blk.pl_len, blk.ad, blk.ad_len, blk.gt, blk.gq,
        blk.dp, blk.min_dp, gtl_r, widths, blk.ploidy, gt_phase,
        mixed_ploidy)
    if nat is not None:
        return nat
    ok = live >= 0
    kk = np.clip(live, 0, blk.col.shape[1] - 1)
    s_i = np.arange(S)[None, :]

    def g2(x, fill):
        return np.where(ok, x[s_i, kk], fill).astype(np.int32)

    def g3(x, fill, width):
        g = np.where(ok[..., None], x[s_i, kk], fill)
        if g.shape[2] < width:
            g = np.pad(g, ((0, 0), (0, 0), (0, width - g.shape[2])),
                       constant_values=fill)
        return g[:, :, :width].astype(np.int32)

    if mixed_ploidy:
        p_bs = (gtl_r + 1) // 2 if gt_phase else gtl_r
    else:
        p_bs = np.full(ok.shape, blk.ploidy, dtype=np.int64)
    # PL: genotypes over 2 alleles at ploidy p are the first p+1 slots
    pl_raw = g3(blk.pl, INT_MISSING, G_out)
    pl_len = g2(blk.pl_len, 0)
    g_idx = np.arange(G_out)[None, None, :]
    ok_pl = (g_idx <= p_bs[..., None]) & (g_idx < pl_len[..., None]) \
        & ok[..., None]
    pl_out = np.where(ok_pl, pl_raw, INT_MISSING)
    if mixed_ploidy:
        pl_out = np.where((p_bs == 0)[..., None], INT_VECTOR_END, pl_out)
    # AD: slots m < num_merged (= 2) gated by ad_len
    ad_raw = g3(blk.ad, INT_MISSING, M_out)
    ad_len = g2(blk.ad_len, 0)
    m_idx = np.arange(M_out)[None, None, :]
    ok_ad = (m_idx < 2) & (m_idx < ad_len[..., None]) & ok[..., None]
    ad_out = np.where(ok_ad, ad_raw, INT_MISSING)
    # GT: identity allele remap with NON_REF fallback (merged idx 1)
    gt_raw = g3(blk.gt, INT_MISSING, P_out)
    gt_out = np.empty_like(gt_raw)
    for p in range(P_out):
        a = gt_raw[..., p]
        if gt_phase and p % 2 == 1:
            o = a
        else:
            oka = (a >= 0) & (a != INT_MISSING)
            o = np.where(oka, np.where(a < 2, a, 1), a)
        if mixed_ploidy:
            o = np.where(p < gtl_r, o, INT_VECTOR_END)
        gt_out[..., p] = o
    return {
        "pl": pl_out, "ad": ad_out, "gt": gt_out,
        "gq": g2(blk.gq, INT_MISSING),
        "dp_format": g2(blk.dp, INT_MISSING),
        "min_dp": g2(blk.min_dp, INT_MISSING),
    }
