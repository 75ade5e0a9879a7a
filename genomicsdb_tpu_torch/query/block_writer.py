"""Block-based combined-VCF production on the port (the port's copy of
`genomicsdb_tpu.query.block_writer`).

Renders VCF text records from device combine-step outputs instead of the
sequential per-cell engine.  Field handling is vid/query-driven
(`query/block_fields.BlockPlan`): the hot remaps and
scalar INFO reductions come from the device combine, the long tail
(element-wise sums, 2-D allele-specific fields, histograms, ID/QUAL
combining, chars) is computed here from host-gathered arrays.  Records
the plan cannot realize splice maximal runs of the sequential engine.

A copy, not an import, because the original imports jax.  Only the
device section of `render_block_vcf_pipelined` differs: the combine is
`fused_combine.combine_block` on an explicit torch device (the CUDA
kernel where its gates allow, the general torch combine otherwise), with
the INFO reductions restricted to `meta.med_rows`.  The fetch is the
JAX package's pack (`pack` on, the default on a CUDA device): the
kernel writes PL/AD/GT (and GQ/DP/MIN_DP) as int16, the device packs
the variant rows and the small outputs into one blob whose copy to
pinned host memory starts before the previous chunk renders, and the
host widens it and rebuilds the ref-block rows (the native
`identity_outputs`), each record at its own width
(`combine_step.RecordStrided`, which the renderer reads dense arrays
through too).  With `pack` off (the default on the CPU device)
every output is fetched whole with `.cpu().numpy()`.  The mesh branch
(`mesh=`, `gdb_query --mesh`) renders one pos span of each chunk per
pos group: the group's row-0 rank alone builds the span's block and
sends each rank of the group its samples' rows of the block; each rank
combines its shard (`parallel.sharded`: the CUDA kernel per shard in
its wide form, the cross-sample reductions over the row group, as the
JAX mesh branch does); the row-0 rank gathers its group's outputs and
renders the span, and the mesh's first rank collects the spans' texts
in pos order.  Two JAX
writer branches are left out on purpose: the dense-gather branch
(`GENOMICSDB_TPU_DENSE=1`, for a TPU behind a PCIe host; on an H100 the
kernel path is the faster one) and the CPU-device `remap_rows`
restriction (a CPU speed-up that no measurement here backs).  Their
device functions, `combine_step_dense` and `combine_step(remap_rows=)`,
are in `ops/combine_step`.  The host render below the device section
is unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core import formats, profile
from ..core import known_fields as kf
from ..core.config import INT64_MAX, QueryConfig
from ..core.vid import VidMapper
from ..ops.combine_step import (RecordStrided, fetch_outputs,
                                fetch_outputs_split, identity_fill,
                                pack_outputs, per_block_arrays)
from ..ops.fused_combine import combine_block, kernel_takes_shape
from ..ops.store_block import _block_ploidy, store_to_block
from ..runtime import native_loader
from ..store.columnar import ColumnarStore
from .block_fields import build_block_plan
from .vcf_writer import elem_sum_1d_core, elem_sum_2d_core, hist_sum_core

INT_MISSING = formats.INT_MISSING
INT_VECTOR_END = formats.INT_VECTOR_END
LEGAL = {"A", "T", "G", "C"}


def _valid_float_arr(v: np.ndarray) -> np.ndarray:
    bits = np.asarray(v, dtype=np.float32).view(np.uint32)
    return (bits != formats.FLOAT_MISSING_BITS) \
        & (bits != formats.FLOAT_VECTOR_END_BITS)


def _fmt_elem(x, is_float: bool) -> str:
    if is_float:
        b = int(np.float32(x).view(np.uint32))
        if b in (formats.FLOAT_MISSING_BITS, formats.FLOAT_VECTOR_END_BITS):
            return "."
        return formats.format_float_vcf(x)
    x = int(x)
    if x in (INT_MISSING, INT_VECTOR_END):
        return "."
    return str(x)


def _mesh_device_section(mesh, store, qc, blk, *, B_empty, max_merged,
                         ploidy, pad_cells_to):
    """The combine of one span on the mesh (a generator: it yields once,
    between the launch and the gather).  The row group's row-0 rank
    holds the span's block `blk` (None for a span without records: then
    B_empty padded records with no live cell stand in); it scatters
    each rank of its row group that rank's sample rows of the per-block
    arrays (`sharded.scatter_rows`).  Every rank combines its shard on
    its own device (`sharded.combine_shard`: the CUDA kernel, wide, with
    the reductions over the row group; no med_rows restriction and no
    pack, as in the JAX mesh branch), and after the pipeline's yield the
    row-0 rank gathers its row group's outputs (`sharded.gather_rows`).
    Returns (host outputs or None off row 0, the block's mixed-ploidy
    flag)."""
    from ..parallel import sharded as TS
    S = len(qc.rows_to_query)
    plan = build_block_plan(qc, qc.vid)
    ploidy = _block_ploidy(store, qc, ploidy)
    slabs = TS.local_slabs(mesh, store, qc, plan,
                           2 * ploidy - 1 if plan.gt_phase else ploidy,
                           pad_cells_to)
    header = rows = None
    if mesh.row == 0:
        if blk is not None:
            ploidy, max_merged, mixed = _block_flags(blk)
            rows = per_block_arrays(blk)
        else:
            mixed = False
            rows = TS.empty_rows(B_empty, S, max_merged)
        B = len(rows[2])
        header = TS.RowsHeader(B, max_merged, ploidy, plan.gt_phase, mixed,
                               kernel_takes_shape(B, S, max_merged, ploidy))
    header, local = TS.scatter_rows(mesh, header, rows, S)
    out = TS.combine_shard(mesh, slabs + local, fused=header.fused,
                           max_merged=header.max_merged,
                           ploidy=header.ploidy, gt_phase=header.gt_phase,
                           mixed_ploidy=header.mixed_ploidy)
    yield
    return TS.gather_rows(mesh, out, header.B, S), header.mixed_ploidy


def _render_mesh_span(mesh, store, qc, vid, interval, *, max_merged,
                      ploidy, pad_records, pad_cells_to, render_kw):
    """render_block_vcf_pipelined on a mesh: this rank's part of one
    chunk, whose pos span is `interval` (None: no record)."""
    blk = meta = None
    if mesh.row == 0 and interval is not None:
        blk, meta = _build_block(store, qc, interval, max_merged, ploidy,
                                 pad_records, pad_cells_to)
        render_block_vcf_pipelined.built_spans.append(
            [int(interval[0]), int(interval[1])])
    dev, mixed = yield from _mesh_device_section(
        mesh, store, qc, blk, B_empty=pad_records or 1,
        max_merged=max_merged, ploidy=ploidy, pad_cells_to=pad_cells_to)
    if mesh.row != 0:       # its row-0 rank renders the span
        yield []
        return
    lines = []
    if blk is not None:
        lines = _render_lines(store, qc, vid, interval, blk, meta, dev,
                              np.asarray(blk.live), None, ploidy=blk.ploidy,
                              mixed_ploidy=mixed, **render_kw)
    text = "".join(ln + "\n" for ln in lines).encode()
    render_block_vcf_pipelined.text_bytes += len(text)
    if mesh.pos_group is None:      # one pos group: its span is the chunk
        yield lines
        return
    from ..parallel.multihost import gather_blobs_to_root
    with profile.span("mesh.gather_text"):
        pieces = gather_blobs_to_root(text, mesh.pos_group, mesh.wire)
    if pieces is None:      # the mesh's first rank writes the chunk
        yield []
        return
    lines = []
    for piece in pieces:
        if piece:
            t = piece.decode()[:-1]
            if render_kw["coalesce"]:
                lines.append(t)
            else:
                lines.extend(t.split("\n"))
    yield lines


def _build_block(store, qc, interval, max_merged, ploidy, pad_records,
                 pad_cells_to):
    """store_to_block with its meta, counted in render_block_vcf_pipelined.
    blocks_built and .records_built (padding excluded)."""
    blk, meta = store_to_block(store, qc, interval=interval,
                               max_merged=max_merged, ploidy=ploidy,
                               return_meta=True, pad_records=pad_records,
                               pad_cells_to=pad_cells_to)
    render_block_vcf_pipelined.blocks_built += 1
    # store_to_block starts padded records at INT64_MAX - 1, past every
    # column a query reaches
    render_block_vcf_pipelined.records_built += int(
        np.count_nonzero(blk.starts < INT64_MAX - 1))
    return blk, meta


def _block_flags(blk):
    """(ploidy, max_merged, mixed_ploidy) of a built block: the cohort's
    max ploidy, the LUT width after any allele-merge growth, and whether
    any live call has a GT length other than the block's width."""
    gt_w = blk.gt.shape[2]
    mixed = bool(blk.gt_len_bs is not None
                 and not (((blk.gt_len_bs == gt_w)
                           | (blk.live < 0)).all()))
    return blk.ploidy, blk.inv_bs.shape[2], mixed


def _device_section(blk, meta, device, pack, max_merged, ploidy, gt_phase,
                    mixed_ploidy):
    """The single-device combine and fetch (a generator: it yields once,
    between the launch and the fetch).  Returns (host outputs, live,
    the padded med_rows the INFO reductions were restricted to, or
    None)."""
    pack_on = device.type == "cuda" if pack is None else bool(pack)
    # INFO median/sum restriction: only rows with any valid input
    # (meta.med_rows) enter the cross-sample sorts; bucket-padded
    # (repeating row 0) as the JAX writer does
    med_rows_p = None
    mr = meta.med_rows
    B0 = blk.live.shape[0]
    if mr is not None and B0 and len(mr) < (3 * B0) // 4:
        bucket = 8
        while bucket < len(mr):
            bucket *= 2
        med_rows_p = np.zeros(bucket, np.int32)
        med_rows_p[:len(mr)] = mr
    # with the pack on, the kernel writes PL/AD/GT (and GQ/DP/MIN_DP)
    # already narrowed to int16, so no device re-narrow pass follows
    out = combine_block(blk, device, max_merged=max_merged, ploidy=ploidy,
                        gt_phase=gt_phase, mixed_ploidy=mixed_ploidy,
                        med_rows=med_rows_p, narrow_out=pack_on)
    # the fetch pack: narrowed outputs in one device blob, holding only
    # the variant rows when ref-block-only records are at least a
    # quarter of the block (the host rebuilds those from block data it
    # holds); pack_outputs starts the blob's copy to the host now, so it
    # overlaps the previous chunk's render
    packed = split = None
    if pack_on:
        ref_mask = meta.is_ref_block_only
        var_rows = np.nonzero(~ref_mask)[0]
        ref_rows = np.nonzero(ref_mask)[0]
        if len(ref_rows) >= max(len(ref_mask) // 4, 1):
            packed = pack_outputs(out, rows=var_rows)
            split = (var_rows, ref_rows)
            render_block_vcf_pipelined.split_blocks += 1
        else:
            packed = pack_outputs(out)
    # `live` is a host-computed input and is never fetched
    live = np.asarray(blk.live)
    yield
    if split is not None:
        # only rows with any live cell are filled: records without one
        # (bucket padding included) are never rendered
        var_rows, ref_rows = split
        dev = fetch_outputs_split(
            out, packed, var_rows, ref_rows, (live >= 0).any(axis=1),
            blk.ploidy,
            lambda dest, rows: identity_fill(blk, dest, rows, gt_phase,
                                             mixed_ploidy))
    else:
        dev = fetch_outputs({k: v for k, v in out.items() if k != "live"},
                            packed)
    dev["live"] = live
    return dev, live, med_rows_p


def render_block_vcf_pipelined(store: ColumnarStore, qc: QueryConfig,
                               vid: VidMapper,
                               interval,
                               device,
                               ref_genome=None,
                               max_merged: int = 4, ploidy: int = 2,
                               sequential_fn=None,
                               pad_records: Optional[int] = None,
                               pad_cells_to: int = 1,
                               filter_name_by_field_idx=None,
                               coalesce: bool = False,
                               pack: Optional[bool] = None,
                               mesh=None):
    """Combined records for `interval`, combined on `device` (a
    torch.device), as a two-phase generator: the first next() builds
    the block, launches the device combine (asynchronous on a CUDA
    device) and starts the packed fetch; the second next() fetches
    outputs and returns the text lines.  Callers overlap chunk k+1's
    launch with chunk k's render (the device computes while the host
    formats).

    `pack` (None: on for a CUDA device, off otherwise) selects the
    narrow kernel and the packed, variant-row fetch.  Counts the blocks
    whose fetch took the variant-row split in
    `render_block_vcf_pipelined.split_blocks`.

    `mesh` (a `parallel.sharded.Mesh`): `interval` is this rank's pos
    span of a chunk (None: a span without records), padded to
    `pad_records`.  Only the row-0 rank of the pos group builds the
    span's block; the combine runs sharded over the group's ranks, each
    on its own device (`device` is not used); the row-0 rank renders the
    span and the mesh's first rank collects every pos group's text in
    pos order: the second next() returns the chunk's lines there, none
    on the other ranks.  Every rank must walk the same chunks in the
    same order.  The fetch is whole (no pack) and the INFO reductions
    cover every row.  Counts the blocks this process built, their
    records (padding excluded) and, on a mesh, the spans built
    ([lo, hi] columns) and the bytes of the text rendered in
    `render_block_vcf_pipelined.{blocks_built,records_built,built_spans,
    text_bytes}`.

    `sequential_fn(lo, hi) -> List[str]`: maximal runs of records the
    plan cannot realize are rendered by the sequential engine over
    [lo, hi] and spliced in."""
    render_kw = dict(ref_genome=ref_genome, sequential_fn=sequential_fn,
                     filter_name_by_field_idx=filter_name_by_field_idx,
                     coalesce=coalesce)
    if mesh is not None:
        yield from _render_mesh_span(
            mesh, store, qc, vid, interval, max_merged=max_merged,
            ploidy=ploidy, pad_records=pad_records,
            pad_cells_to=pad_cells_to, render_kw=render_kw)
        return
    blk, meta = _build_block(store, qc, interval, max_merged, ploidy,
                             pad_records, pad_cells_to)
    ploidy, max_merged, mixed_ploidy = _block_flags(blk)
    dev, live, med_rows_p = yield from _device_section(
        blk, meta, device, pack, max_merged, ploidy, meta.plan.gt_phase,
        mixed_ploidy)
    yield _render_lines(store, qc, vid, interval, blk, meta, dev, live,
                        med_rows_p, ploidy=ploidy, mixed_ploidy=mixed_ploidy,
                        **render_kw)


render_block_vcf_pipelined.split_blocks = 0
render_block_vcf_pipelined.blocks_built = 0
render_block_vcf_pipelined.records_built = 0
render_block_vcf_pipelined.built_spans = []
render_block_vcf_pipelined.text_bytes = 0


def _render_lines(store, qc, vid, interval, blk, meta, dev, live,
                  med_rows_p, *, sequential_fn, **kw) -> List[str]:
    """The text lines of one combined block: the host render of the
    block's records from its host outputs `dev` (INFO reductions
    restricted to the padded `med_rows_p` rows when given).  Timed as
    the span `render`, each run of records spliced from the sequential
    engine as its child `render.splice`."""
    with profile.span("render"):
        return _render_block_lines(
            store, qc, vid, interval, blk, meta, dev, live, med_rows_p,
            sequential_fn=_spliced(sequential_fn), **kw)


def _spliced(sequential_fn):
    if sequential_fn is None:
        return None

    def splice(lo, hi):
        with profile.span("render.splice"):
            return sequential_fn(lo, hi)
    return splice


def _render_block_lines(store, qc, vid, interval, blk, meta, dev, live,
                        med_rows_p, *, ploidy, mixed_ploidy, ref_genome,
                        sequential_fn, filter_name_by_field_idx,
                        coalesce) -> List[str]:
    plan = meta.plan
    B, S = live.shape
    if med_rows_p is not None:
        # scatter the row-restricted INFO reductions back to full
        # width; rows outside med_rows read ok=False, exactly what
        # full-width computation gives at rows with no valid input
        mr = meta.med_rows
        n_med = len(mr)
        for key in ("info_median", "info_imedian", "info_fsum"):
            v, okk = dev[key], dev[key + "_ok"]
            fullv = np.zeros((v.shape[0], B), v.dtype)
            fullo = np.zeros((okk.shape[0], B), dtype=bool)
            fullv[:, mr] = v[:, :n_med]
            fullo[:, mr] = okk[:, :n_med]
            dev[key] = fullv
            dev[key + "_ok"] = fullo
    live_ok = live >= 0
    starts = blk.starts
    # ---------------- record plan: block vs splice runs ----------------
    any_live_v = live_ok.any(axis=1)
    emitted_arr = np.nonzero(any_live_v)[0]
    if sequential_fn is None \
            or not meta.needs_fallback[emitted_arr].any():
        # pure block run (the production common case): no per-record
        # plan needed, the native line blob passes through unsplit
        plan_items = None
        block_bs = emitted_arr.tolist()
    else:
        emitted = emitted_arr.tolist()
        plan_items = []
        block_bs = []
        e = 0
        while e < len(emitted):
            b = emitted[e]
            if meta.needs_fallback[b]:
                j = e
                while j < len(emitted) and meta.needs_fallback[emitted[j]]:
                    j += 1
                hi = int(starts[emitted[j]]) - 1 if j < len(emitted) \
                    else int(interval[1])
                plan_items.append(("seq", int(starts[b]), hi))
                e = j
                continue
            plan_items.append(("block", b))
            block_bs.append(b)
            e += 1
    profile.count("block_records", len(block_bs))
    profile.count("spliced_records", len(emitted_arr) - len(block_bs))
    # ---------------- coordinate/contig resolution ----------------
    starts_l = starts.tolist()
    ends_l = meta.ends.tolist()
    c_offsets = np.asarray(vid._contig_offsets, dtype=np.int64)
    c_idx = np.searchsorted(c_offsets, starts, side="right") - 1
    c_names = [c.name for c in vid._contigs_by_offset]
    if block_bs:
        # bounds check matching get_contig_location: every rendered start
        # must fall inside [offset, offset+length) of its resolved contig
        bs_arr = np.asarray(block_bs)
        bidx = c_idx[bs_arr]
        c_lengths = np.asarray(
            [c.length for c in vid._contigs_by_offset], dtype=np.int64)
        bad = (bidx < 0) | (starts[bs_arr]
                            >= c_offsets[np.maximum(bidx, 0)]
                            + c_lengths[np.maximum(bidx, 0)])
        if bad.any():
            b0 = int(bs_arr[np.argmax(bad)])
            raise ValueError(
                f"record start {int(starts[b0])} outside every contig "
                "(vid contig map does not cover this column)")
    c_idx_l = np.maximum(c_idx, 0).tolist()
    c_offs_l = c_offsets.tolist()
    # ---------------- INFO machinery ----------------
    host_info = _HostInfo(store, qc, vid, meta, blk, live, block_bs)
    qual_txt = _qual_column(plan, dev, host_info, block_bs, B)
    id_txt = _id_column(store, plan, meta, live_ok, block_bs, B) \
        if plan.id_queried else None
    filt_txt = _filter_column(store, qc, meta, live_ok, block_bs, B,
                              filter_name_by_field_idx or {}) \
        if plan.produce_filter else None
    dpsum = dev["dp_info_sum"]
    # genotype-length fields are omitted entirely when the merged ALT
    # count exceeds the genotyping cap (gt_common.h:48,
    # too_many_alt_alleles_for_genotype_length_fields)
    max_alt = qc.params.max_diploid_alt_alleles_that_can_be_genotyped
    too_many = (blk.rec_num_merged - 1) > max_alt
    # per-spec validity is sparse (gVCF ref blocks carry no INFO):
    # compute rendered strings only where a spec fires, in spec order
    info_txt: Dict[int, List[str]] = {}
    in_block = np.zeros(B, dtype=bool)
    if block_bs:
        in_block[np.asarray(block_bs)] = True
    for spec in plan.info_specs:
        if spec.source == "med":
            okv = dev["info_median_ok"][spec.slot]
        elif spec.source == "imed":
            okv = dev["info_imedian_ok"][spec.slot]
        elif spec.source == "fsum":
            okv = dev["info_fsum_ok"][spec.slot]
        else:
            ex = meta.extras.get(spec.name)
            okv = ex.valid.any(axis=1) if ex is not None \
                else np.zeros(B, dtype=bool)
        if spec.length_code == kf.VL_G:
            okv = okv & ~too_many
        for b in np.nonzero(okv & in_block)[0]:
            piece = host_info.render_spec(spec, int(b), dev)
            if piece is not None:
                info_txt.setdefault(int(b), []).append(piece)
    for parent, bin_f, cnt_f in plan.hist_specs:
        exb = meta.extras.get(bin_f)
        exc = meta.extras.get(cnt_f)
        if exb is None or exc is None:
            continue
        okv = (exb.valid & exc.valid).any(axis=1)
        for b in np.nonzero(okv & in_block)[0]:
            piece = host_info.render_hist(parent, bin_f, cnt_f, int(b))
            if piece is not None:
                info_txt.setdefault(int(b), []).append(piece)
    # DP= only renders when DP (with the DP op) or DP_FORMAT is queried
    # (vcf_writer: dp_info_vec/dp_format_vec existence); a queried
    # MIN_DP alone never produces the INFO sum
    dp_hit = (dpsum > 0) & ~meta.is_ref_block_only & in_block
    if not (plan.dp_info_queried or qc.is_queried("DP_FORMAT")):
        dp_hit[:] = False
    for b in np.nonzero(dp_hit)[0]:
        info_txt.setdefault(int(b), []).append(f"DP={int(dpsum[b])}")
    # ---------------- FORMAT presence flags ----------------
    fmt_specs = _render_order(plan)
    present: Dict[str, np.ndarray] = {}
    vc = meta.valid_core or {}
    for spec in fmt_specs:
        nm = spec.name
        if nm == "GT":
            p = vc["GT"].any(axis=1) if "GT" in vc \
                else np.zeros(B, dtype=bool)
        elif nm == "GQ":
            p = (dev["gq"] != INT_MISSING).any(axis=1)
        elif nm == "MIN_DP":
            p = (dev["min_dp"] != INT_MISSING).any(axis=1)
        elif nm == "AD":
            p = vc["AD"].any(axis=1) if "AD" in vc \
                else np.zeros(B, dtype=bool)
        elif nm == "PL":
            p = vc["PL"].any(axis=1) if "PL" in vc \
                else np.zeros(B, dtype=bool)
        else:
            ex = meta.extras.get(nm)
            p = ex.valid.any(axis=1) if ex is not None \
                else np.zeros(B, dtype=bool)
        if spec.wkind == "G":   # PL + general genotype-length fields
            p = p & ~too_many
        present[nm] = p
    have_dp_col = (dev["dp_format"] != INT_MISSING).any(axis=1)
    # ---------------- line assembly ----------------
    lines: List[str] = []
    nb = len(block_bs)
    if nb == 0:
        for item in (plan_items or []):
            if item[0] != "block":
                lines.extend(sequential_fn(item[1], item[2]))
        return lines
    bs_arr = np.asarray(block_bs, dtype=np.int64)
    # per-record FORMAT signature codes (vectorized bit-pack)
    sig_codes = np.zeros(nb, dtype=np.int64)
    for k, sp in enumerate(fmt_specs):
        sig_codes |= present[sp.name][bs_arr].astype(np.int64) << k
    sig_codes |= have_dp_col[bs_arr].astype(np.int64) << len(fmt_specs)

    def sig_of(code):
        return tuple(bool((code >> k) & 1)
                     for k in range(len(fmt_specs) + 1))

    # REF: fasta lookup only where the merge produced no concrete base
    meta_refs = meta.refs if isinstance(meta.refs, np.ndarray) \
        else np.array(meta.refs, dtype=object)
    refs_arr = meta_refs[bs_arr]
    refs: List[str] = refs_arr.tolist()
    need_fa = np.nonzero((refs_arr == None) | (refs_arr == "N"))[0]  # noqa: E711
    for i in need_fa.tolist():
        if ref_genome is not None:
            b = int(bs_arr[i])
            ci = c_idx_l[b]
            base = ref_genome.base_at(c_names[ci],
                                      starts_l[b] - c_offs_l[ci])
            refs[i] = base if base in LEGAL else "N"
        else:
            refs[i] = "N"
    # ALT: memoized on the alts-list identity — records sharing a merge
    # signature share one list object (store_block scatters groups)
    alt_txts: List[str] = [""] * nb
    meta_alts = meta.alts
    alt_memo: Dict[int, str] = {}
    for i, b in enumerate(block_bs):
        alts = meta_alts[b]
        t = alt_memo.get(id(alts))
        if t is None:
            if len(alts) == 1 and alts[0].startswith("&"):
                t = "<NON_REF>"
            else:
                t = ",".join("<NON_REF>" if a.startswith("&")
                             else a for a in alts) or "."
            alt_memo[id(alts)] = t
        alt_txts[i] = t
    # sample columns + FORMAT dictionary per signature group
    rec_text: List[Optional[str]] = [None] * nb
    fmt_strings: Dict[int, str] = {}
    with_fmt = not plan.sites_only and S
    sc_order = np.argsort(sig_codes, kind="stable")
    sc_sorted = sig_codes[sc_order]
    uniq_codes, uniq_starts = np.unique(sc_sorted, return_index=True)
    uniq_bounds = np.concatenate([uniq_starts, [nb]])
    groups: Dict[int, np.ndarray] = {
        int(uniq_codes[g]): sc_order[uniq_bounds[g]:uniq_bounds[g + 1]]
        for g in range(len(uniq_codes))}
    direct_groups = None     # [(marshalled desc, idxs)] when the
    # direct-write render engages: sample text lands straight in the
    # final line blob (gdb_render_group_lens/_at + gdb_assemble_*),
    # written exactly once instead of rendered+scattered+memcpy'd
    samp_lens = None
    if with_fmt:
        renderer = _SampleRenderer(plan, fmt_specs, meta, blk, dev, live,
                                   ploidy, store,
                                   mixed_ploidy=mixed_ploidy)
        for code in groups:
            sig = sig_of(code)
            names = [sp.vcf_name for sp, pr in zip(fmt_specs, sig) if pr]
            if sig[-1]:
                names.append("DP")
            fmt_strings[code] = ":".join(names) if names else "."
        lib = native_loader.get_lib()
        if renderer.native and hasattr(lib, "gdb_assemble_lens"):
            direct_groups = []
            samp_lens = np.zeros(nb, np.int64)
            for code, idxs in groups.items():
                desc = native_loader._marshal_group(
                    renderer.group_descs(sig_of(code), bs_arr[idxs]),
                    bs_arr[idxs], S)
                samp_lens[idxs] = native_loader.render_group_lens(desc)
                direct_groups.append((desc, idxs))
        elif renderer.native:
            group_cols = []
            for code, idxs in groups.items():
                col = renderer.render_group_col(sig_of(code),
                                                bs_arr[idxs])
                group_cols.append((col, idxs))
            # scatter-concatenate the group blobs by record index: no
            # per-record byte strings are materialized
            lens = np.zeros(nb, np.int64)
            for (arr, offs), idxs in group_cols:
                lens[idxs] = np.diff(offs)
            samp_offs = np.zeros(nb + 1, np.int64)
            np.cumsum(lens, out=samp_offs[1:])
            blob = np.empty(int(samp_offs[-1]), np.uint8)
            for (arr, offs), idxs in group_cols:
                native_loader.copy_segments(
                    np.asarray(arr), offs[:-1], np.diff(offs),
                    samp_offs[:-1][idxs], blob)
            rec_text = (blob, samp_offs)
        else:
            for code, idxs in groups.items():
                texts = renderer.render_group(sig_of(code),
                                              bs_arr[idxs])
                for i, t in zip(idxs, texts):
                    rec_text[i] = t
    if direct_groups is not None:
        block_lines_text = _assemble_block_lines_direct(
            nb, block_bs, bs_arr, c_idx, c_names, c_offsets, starts,
            meta, refs, alt_txts, info_txt, id_txt, qual_txt, filt_txt,
            fmt_strings, sig_codes, samp_lens, direct_groups)
    else:
        block_lines_text = _assemble_block_lines(
            nb, block_bs, bs_arr, c_idx, c_names, c_offsets, starts,
            meta, refs, alt_txts, info_txt, id_txt, qual_txt, filt_txt,
            fmt_strings, sig_codes, rec_text, with_fmt)
    if isinstance(block_lines_text, tuple):   # native (blob, offsets)
        blob, offs = block_lines_text
        if plan_items is None:
            # pure block run: one multi-line chunk, no per-line split
            if coalesce:
                lines.append(blob.decode()[:-1])
            else:
                lines.extend(blob.decode()[:-1].split("\n"))
            return lines
        pos_of_b = {int(b): i for i, b in enumerate(block_bs)}
        run_start = run_end = -1
        for item in plan_items:
            if item[0] == "block":
                i = pos_of_b[item[1]]
                if run_start < 0:
                    run_start = i
                run_end = i
                continue
            if run_start >= 0:
                lines.extend(blob[offs[run_start]:offs[run_end + 1]]
                             .decode()[:-1].split("\n"))
                run_start = -1
            lines.extend(sequential_fn(item[1], item[2]))
        if run_start >= 0:
            lines.extend(blob[offs[run_start]:offs[run_end + 1]]
                         .decode()[:-1].split("\n"))
        return lines
    # python fallback produced a per-record list
    if plan_items is None:
        lines.extend(block_lines_text)
        return lines
    block_lines = {int(b): block_lines_text[i]
                   for i, b in enumerate(block_bs)}
    for item in plan_items:
        if item[0] == "block":
            lines.append(block_lines[item[1]])
        else:
            lines.extend(sequential_fn(item[1], item[2]))
    return lines


def _strs_to_col(strings: List, dot_is_empty: bool = False):
    """List of per-record strings/bytes -> (bytes, offsets); '.' entries
    become empty spans when dot_is_empty (native renders '.')."""
    n = len(strings)
    arr = None
    # vectorized: one C-level encode into a fixed-width bytes array,
    # packed blob via boolean-mask extraction (VCF text is ASCII and
    # carries no NUL bytes, so strlen == count of non-NUL lanes).
    # Long entries (sample-column text) pad the fixed-width matrix past
    # the join cost -> keep the list path for those (sampled estimate).
    if n and max(len(strings[0]), len(strings[n // 2]),
                 len(strings[-1])) <= 48:
        try:
            arr = np.asarray(strings, dtype=np.bytes_)
        except (UnicodeEncodeError, ValueError):
            arr = None
    if arr is not None and arr.ndim == 1 and len(arr) == n:
        if dot_is_empty:
            arr = np.where(arr == b".", np.bytes_(b""), arr)
        W = arr.dtype.itemsize
        offs = np.zeros(n + 1, dtype=np.int64)
        if W == 0 or n == 0:
            return b"", offs
        u8 = np.ascontiguousarray(arr).view(np.uint8).reshape(n, W)
        keep = u8 != 0
        np.cumsum(keep.sum(axis=1), out=offs[1:])
        return u8[keep].tobytes(), offs
    if dot_is_empty:
        strings = ["" if s == "." else s for s in strings]
    parts = [s if isinstance(s, bytes) else s.encode() for s in strings]
    blob = b"".join(parts)
    lens = np.fromiter((len(b) for b in parts), dtype=np.int64,
                       count=len(parts))
    offs = np.zeros(len(parts) + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    return blob, offs


def _assemble_block_lines(nb, block_bs, bs_arr, c_idx, c_names, c_offsets,
                          starts, meta, refs, alt_txts, info_txt, id_txt,
                          qual_txt, filt_txt, fmt_strings, sig_codes,
                          rec_text, with_fmt):
    """Assemble the block records' full lines: native kernel
    (gdb_assemble_lines) when available, Python loop otherwise.
    Native returns (blob, offsets[nb+1]) of newline-terminated lines;
    Python returns List[str]."""
    cidx_b = c_idx[bs_arr]
    pos1 = starts[bs_arr] - c_offsets[np.maximum(cidx_b, 0)] + 1
    ends_b = meta.ends[bs_arr]
    info_end = np.where(ends_b > starts[bs_arr],
                        pos1 + (ends_b - starts[bs_arr]), -1)
    if native_loader.get_lib() is not None:
        names_blob, name_offs = _strs_to_col(c_names)
        extra_col = None
        if info_txt:
            extra_col = _strs_to_col(
                [";".join(info_txt[int(b)]) if int(b) in info_txt else ""
                 for b in block_bs])
        if with_fmt:
            code_order = {c: i for i, c in enumerate(fmt_strings)}
            fmt_blob, fmt_offs = _strs_to_col(
                [fmt_strings[c] for c in code_order])
            fmt_idx = np.fromiter(
                (code_order[c] for c in sig_codes.tolist()),
                dtype=np.int32, count=nb)
            samp_col = rec_text if isinstance(rec_text, tuple) \
                else _strs_to_col([t or "" for t in rec_text])
        else:
            fmt_blob, fmt_offs = b"", np.zeros(1, dtype=np.int64)
            fmt_idx = np.full(nb, -1, dtype=np.int32)
            samp_col = None
        got = native_loader.assemble_lines(
            cidx_b, pos1, names_blob, name_offs,
            _strs_to_col([id_txt[int(b)] for b in block_bs], True)
            if id_txt is not None else None,
            _strs_to_col(refs), _strs_to_col(alt_txts),
            _strs_to_col([qual_txt[int(b)] for b in block_bs], True)
            if qual_txt is not None else None,
            _strs_to_col([filt_txt[int(b)] for b in block_bs], True)
            if filt_txt is not None else None,
            info_end, extra_col,
            np.full(nb, -1, dtype=np.int64),   # DP already in info_txt
            fmt_blob, fmt_offs, fmt_idx, samp_col)
        if got is not None:
            return got
    # ---- Python fallback ----
    out = []
    pos1_l = pos1.tolist()
    for i, b in enumerate(block_bs):
        extra = info_txt.get(int(b))
        if info_end[i] >= 0:
            info_parts = [f"END={info_end[i]}"]
            if extra:
                info_parts.extend(extra)
        else:
            info_parts = extra or []
        cols = [c_names[c_idx[b]], str(pos1_l[i]),
                id_txt[b] if id_txt is not None else ".",
                refs[i], alt_txts[i],
                qual_txt[b] if qual_txt is not None else ".",
                filt_txt[b] if filt_txt is not None else ".",
                ";".join(info_parts) if info_parts else "."]
        if with_fmt:
            cols.append(fmt_strings[int(sig_codes[i])])
            t = rec_text[i]
            cols.append(t.decode() if isinstance(t, bytes) else t)
        out.append("\t".join(cols))
    return out


def _assemble_block_lines_direct(nb, block_bs, bs_arr, c_idx, c_names,
                                 c_offsets, starts, meta, refs, alt_txts,
                                 info_txt, id_txt, qual_txt, filt_txt,
                                 fmt_strings, sig_codes, samp_lens,
                                 direct_groups):
    """Direct-write form of _assemble_block_lines: exact line lengths
    up front, prefixes written in parallel with per-record sample gaps,
    then each signature group's sample text rendered straight into its
    gap (gdb_assemble_lens/_write + gdb_render_group_at) — every output
    byte is written exactly once.  Returns (bytes, offsets[nb+1])."""
    cidx_b = c_idx[bs_arr]
    pos1 = starts[bs_arr] - c_offsets[np.maximum(cidx_b, 0)] + 1
    ends_b = meta.ends[bs_arr]
    info_end = np.where(ends_b > starts[bs_arr],
                        pos1 + (ends_b - starts[bs_arr]), -1)
    names_blob, name_offs = _strs_to_col(c_names)
    extra_col = None
    if info_txt:
        extra_col = _strs_to_col(
            [";".join(info_txt[int(b)]) if int(b) in info_txt else ""
             for b in block_bs])
    code_order = {c: i for i, c in enumerate(fmt_strings)}
    fmt_blob, fmt_offs = _strs_to_col(
        [fmt_strings[c] for c in code_order])
    fmt_idx = np.fromiter(
        (code_order[c] for c in sig_codes.tolist()),
        dtype=np.int32, count=nb)
    out, line_offs, samp_dest = native_loader.assemble_lines_gapped(
        cidx_b, pos1, names_blob, name_offs,
        _strs_to_col([id_txt[int(b)] for b in block_bs], True)
        if id_txt is not None else None,
        _strs_to_col(refs), _strs_to_col(alt_txts),
        _strs_to_col([qual_txt[int(b)] for b in block_bs], True)
        if qual_txt is not None else None,
        _strs_to_col([filt_txt[int(b)] for b in block_bs], True)
        if filt_txt is not None else None,
        info_end, extra_col,
        np.full(nb, -1, dtype=np.int64),   # DP already in info_txt
        fmt_blob, fmt_offs, fmt_idx, samp_lens)
    for desc, idxs in direct_groups:
        native_loader.render_group_at(desc, samp_dest[idxs], out)
    return out.tobytes(), line_offs


def _render_order(plan):
    """Sequential writer's effective FORMAT order: GT first, then
    format_fields order; DP_FORMAT/DP-INFO render as trailing DP."""
    out = []
    for sp in plan.format_specs:
        if sp.kind == "gt":
            out.insert(0, sp)
        elif sp.name not in ("DP_FORMAT", "DP"):
            out.append(sp)
    return out


def _qual_column(plan, dev, host_info, block_bs, B) -> Optional[List[str]]:
    spec = plan.qual_spec
    if spec is None:
        return None
    out = ["."] * B
    for b in block_bs:
        v = host_info.spec_value(spec, b, dev)
        if v is not None:
            out[b] = formats.format_float_vcf(v)
    return out


def _id_column(store, plan, meta, live_ok, block_bs, B) -> List[str]:
    fd = store.fields.get("ID")
    out = ["."] * B
    if fd is None:
        return out
    cm = meta.cells_mat
    for b in block_bs:
        ids = set()
        for s in np.nonzero(live_ok[b])[0]:
            ci = int(cm[b, s])
            if ci < 0 or not fd.valid[ci]:
                continue
            v = fd.cell_value(ci)
            if v:
                for tok in str(v).split(";"):
                    if tok:
                        ids.add(tok)
        if ids:
            out[b] = ";".join(sorted(ids))  # DEBUG-sorted (goldens)
    return out


def _filter_column(store, qc, meta, live_ok, block_bs, B,
                   names: Dict) -> List[str]:
    fd = store.fields.get("FILTER")
    out = ["."] * B
    if fd is None:
        return out
    cm = meta.cells_mat
    for b in block_bs:
        idx_set = set()
        for s in np.nonzero(live_ok[b])[0]:
            ci = int(cm[b, s])
            if ci < 0 or not fd.valid[ci]:
                continue
            v = fd.cell_value(ci)
            if v is not None and len(v) > 0:
                for x in v:
                    idx_set.add(int(x))
        if idx_set:
            got = [names[g] for g in sorted(idx_set) if g in names]
            if got:
                out[b] = ";".join(got)
    return out


class _HostInfo:
    """Host-side INFO combine values (the long tail the device stacks do
    not cover), in the sequential operator's accumulation order."""

    def __init__(self, store, qc, vid, meta, blk, live, block_bs):
        self.store = store
        self.qc = qc
        self.vid = vid
        self.meta = meta
        self.blk = blk
        self.live_ok = live >= 0
        self.block_set = set(int(b) for b in block_bs)
        self._2d_cache: Dict = {}

    def render_spec(self, spec, b, dev) -> Optional[str]:
        v = self.spec_value(spec, b, dev)
        if v is None:
            return None
        if isinstance(v, str):
            return f"{spec.vcf_name}={v}"
        if isinstance(v, list):
            txt = ",".join(_fmt_elem(x, spec.is_float) for x in v)
            return f"{spec.vcf_name}={txt}"
        if spec.is_float:
            return f"{spec.vcf_name}={formats.format_float_vcf(v)}"
        return f"{spec.vcf_name}={int(v)}"

    def spec_value(self, spec, b, dev):
        if spec.source == "med":
            return np.float32(dev["info_median"][spec.slot, b]) \
                if dev["info_median_ok"][spec.slot, b] else None
        if spec.source == "imed":
            return int(dev["info_imedian"][spec.slot, b]) \
                if dev["info_imedian_ok"][spec.slot, b] else None
        if spec.source == "fsum":
            return np.float32(dev["info_fsum"][spec.slot, b]) \
                if dev["info_fsum_ok"][spec.slot, b] else None
        return self._host_value(spec, b)

    def _host_value(self, spec, b):
        ex = self.meta.extras.get(spec.name)
        if ex is None:
            return None
        if ex.vals is None:     # 2-D field
            return self._value_2d(spec, b)
        valid_s = ex.valid[b]
        if not valid_s.any():
            return None
        is_f = spec.is_float
        if spec.op in (kf.OP_SUM, kf.OP_MEAN, kf.OP_MEDIAN):
            firsts = []
            for s in np.nonzero(valid_s)[0]:
                x = ex.vals[b, s, 0] if ex.vals.ndim == 3 \
                    else ex.vals[b, s]
                if is_f:
                    if _valid_float_arr(np.asarray([x]))[0]:
                        firsts.append(np.float32(x))
                elif int(x) not in (INT_MISSING, INT_VECTOR_END):
                    firsts.append(int(x))
            if not firsts:
                return None
            if spec.op == kf.OP_MEDIAN:
                arr = sorted(float(x) if is_f else int(x) for x in firsts)
                return arr[len(arr) // 2]
            if spec.op == kf.OP_SUM:
                res = firsts[0]
                for x in firsts[1:]:
                    res = (np.float32(res) + np.float32(x)) if is_f \
                        else res + x
                return res
            s_ = firsts[0]
            for x in firsts[1:]:
                s_ = (np.float32(s_) + np.float32(x)) if is_f else s_ + x
            return (np.float32(s_) / np.float32(len(firsts))) if is_f \
                else s_ // len(firsts)
        if spec.op in (kf.OP_ELEMENT_WISE_SUM, kf.OP_CONCATENATE):
            values = []
            for s in np.nonzero(valid_s)[0]:
                ln = int(ex.lens[b, s]) if ex.lens is not None \
                    else ex.vals.shape[-1]
                values.append(np.asarray(ex.vals[b, s, :ln]))
            if spec.op == kf.OP_CONCATENATE:
                if not values:
                    return None
                cat = np.concatenate(values)
                return list(cat) if len(cat) else None
            res = elem_sum_1d_core(values, is_f)
            return res
        return None

    def _value_2d(self, spec, b):
        fd = self.store.fields.get(spec.name)
        if fd is None:
            return None
        values = self._gather_2d(spec.name, b)
        if not values:
            return None
        info = self.qc.field_info(spec.name)
        return elem_sum_2d_core(values, info)

    def _gather_2d(self, name, b):
        """Per-call 2-D values for record b, allele-remapped
        (remap_allele_specific_annotations, variant_operations.cc:482)."""
        fd = self.store.fields.get(name)
        ex = self.meta.extras.get(name)
        if fd is None or ex is None:
            return []
        info = self.qc.field_info(name)
        cm = self.meta.cells_mat
        nm = int(self.blk.rec_num_merged[b])
        non_ref = bool(self.meta.alts[b]
                       and self.meta.alts[b][-1].startswith("&"))
        refonly = bool(self.meta.is_ref_block_only[b])
        out = []
        for s in np.nonzero(ex.valid[b])[0]:
            ci = int(cm[b, s])
            val = fd.cell_value(ci)
            if val is None or len(val) == 0:
                continue
            if refonly or not info.length.is_allele_dependent():
                out.append(val)
                continue
            # rebuild the input->merged LUT row from inv_bs
            inv = self.blk.inv_bs[b, s]
            lut_row = np.full(int(max((inv >= 0).sum(), len(val) + 1)),
                              -1, dtype=np.int32)
            for m_i, in_a in enumerate(inv):
                if 0 <= in_a < len(lut_row):
                    lut_row[in_a] = m_i
            out.append(_remap_2d_vals(val, lut_row, nm, non_ref, info))
        return out

    def render_hist(self, parent, bin_f, cnt_f, b) -> Optional[str]:
        exb = self.meta.extras.get(bin_f)
        exc = self.meta.extras.get(cnt_f)
        if exb is None or exc is None:
            return None
        # pair per valid call: both must be valid on the same call
        both = np.nonzero(exb.valid[b] & exc.valid[b])[0]
        if len(both) == 0:
            return None
        bvs = self._gather_2d_calls(bin_f, b, both)
        cvs = self._gather_2d_calls(cnt_f, b, both)
        bin_info = self.qc.field_info(bin_f)
        cnt_info = self.qc.field_info(cnt_f)
        res = hist_sum_core(list(zip(bvs, cvs)), bin_info, cnt_info)
        if res is None:
            return None
        pinfo = self.vid.get_field_info(parent)
        return f"{pinfo.vcf_name}={res}"

    def _gather_2d_calls(self, name, b, s_list):
        fd = self.store.fields.get(name)
        info = self.qc.field_info(name)
        cm = self.meta.cells_mat
        nm = int(self.blk.rec_num_merged[b])
        non_ref = bool(self.meta.alts[b]
                       and self.meta.alts[b][-1].startswith("&"))
        refonly = bool(self.meta.is_ref_block_only[b])
        out = []
        for s in s_list:
            ci = int(cm[b, s])
            val = fd.cell_value(ci)
            if val is None:
                val = []
            if refonly or not info.length.is_allele_dependent():
                out.append(val)
                continue
            inv = self.blk.inv_bs[b, s]
            lut_row = np.full(int(max((inv >= 0).sum(), len(val) + 1)),
                              -1, dtype=np.int32)
            for m_i, in_a in enumerate(inv):
                if 0 <= in_a < len(lut_row):
                    lut_row[in_a] = m_i
            out.append(_remap_2d_vals(val, lut_row, nm, non_ref, info))
        return out


def _remap_2d_vals(val, lut_row, num_merged, non_ref_exists, info):
    """remap_allele_specific_annotations (variant_operations.cc:482-570):
    dim-0 is A or R over alleles.  Mirrors CombineOperator._remap_2d."""
    from ..ops import merge as M
    code = info.length.dims[0][0]
    alt_only = code == kf.VL_A
    inv = M.inverse_lut(lut_row, num_merged)
    input_nr = inv[num_merged - 1] if non_ref_exists else M.LUT_MISSING
    length = num_merged - 1 if alt_only else num_merged
    out = []
    empty = np.zeros(0, dtype=val[0].dtype if len(val) else np.float32)
    for j in range(length):
        allele_j = j + 1 if alt_only else j
        in_j = inv[allele_j] if allele_j < num_merged else M.LUT_MISSING
        if in_j == M.LUT_MISSING:
            if input_nr == M.LUT_MISSING:
                out.append(empty)
                continue
            in_j = input_nr
        idx = in_j - 1 if alt_only else in_j
        if 0 <= idx < len(val):
            out.append(np.asarray(val[idx]))
        else:
            out.append(empty)
    return out


# ---------------- sample-column rendering ----------------

def _gt_text(vec, produce: bool, phase_in: bool) -> str:
    """encode_GT_vector (broad_combined_gvcf.cc:90-140): phased GT is
    stored interleaved [a0, ph1, a1, ...]; without produce_GT alleles
    render '.' but phase separators survive."""
    n = len(vec)
    elems = []
    if phase_in:
        if n > 0:
            elems.append((int(vec[0]), False))
        k = 2
        while k < n:
            elems.append((int(vec[k]), int(vec[k - 1]) > 0))
            k += 2
    else:
        for k in range(n):
            elems.append((int(vec[k]), False))
    txt = []
    for i, (v, phased) in enumerate(elems):
        if v == INT_VECTOR_END:
            break
        if produce and v not in (INT_MISSING, INT_VECTOR_END) and v >= 0:
            allele = str(v)
        else:
            allele = "."
        enc_phased = phased if phase_in else False
        sep = ("|" if enc_phased else "/") if i > 0 else ""
        txt.append(sep + allele)
    return "".join(txt) if txt else "."

def _num_genotypes(nm, ploidy: int):
    """C(nm + ploidy - 1, ploidy): genotype count for nm alleles at a
    uniform ploidy.  (A previous revision returned the allele count for
    any ploidy != 2 — correct only for haploid — which truncated PL on
    uniform-triploid cohorts, e.g. a row-subset query selecting only a
    triploid sample.)"""
    nm = np.asarray(nm)
    n_alt = nm - 1
    if ploidy == 2:
        return n_alt * (n_alt + 3) // 2 + 1
    if ploidy == 1:
        return nm
    return _num_genotypes_ploidy(nm, np.full_like(nm, ploidy))


def _num_genotypes_ploidy(nm, p):
    """C(nm + p - 1, p) elementwise (genotype count for nm alleles at
    ploidy p; p == 0 -> 0 elements, the no-GT '.' case)."""
    nm = np.asarray(nm)
    p = np.asarray(p)
    out = np.ones(np.broadcast_shapes(nm.shape, p.shape), dtype=np.int64)
    pmax = int(p.max()) if p.size else 0
    # multiplicative C(n+k-1, k) built up over k, masked per element
    val = np.ones_like(out)
    for k in range(1, pmax + 1):
        val = val * (nm + k - 1) // k
        out = np.where(p == k, val, out)
    return np.where(p <= 0, 0, out)


def _ragged_offsets(lengths: np.ndarray) -> np.ndarray:
    out = np.zeros(lengths.size + 1, dtype=np.int64)
    np.cumsum(lengths.ravel(), out=out[1:])
    return out


def _py_to_col(strings: List[List[str]]):
    """List-of-rows of per-sample strings -> (bytes, offsets) column."""
    flat = [t for row in strings for t in row]
    blob = "".join(flat).encode()
    lens = np.array([len(t.encode()) for t in flat], dtype=np.int64)
    return blob, _ragged_offsets(lens)


class _SampleRenderer:
    """Renders per-record sample columns for one FORMAT signature group,
    using the native text kernels for int columns and Python for the
    rare float/char columns."""

    def __init__(self, plan, fmt_specs, meta, blk, dev, live, ploidy,
                 store, mixed_ploidy=False):
        self.plan = plan
        self.fmt_specs = fmt_specs
        self.meta = meta
        self.blk = blk
        self.dev = dev
        self.live = live
        self.ploidy = ploidy
        self.store = store
        self.mixed = mixed_ploidy
        if mixed_ploidy:
            gl = blk.gt_len_bs
            self.ploidy_bs = ((gl + 1) // 2 if plan.gt_phase
                              else gl).astype(np.int64)
        else:
            self.ploidy_bs = None
        self.native = native_loader.get_lib() is not None

    def group_descs(self, sig, bs):
        """Column descriptors for one FORMAT-signature group (the
        gdb_render_group* argument list).  A group with no present
        columns renders '.' per sample (a single dots column)."""
        mask = self.live[bs] >= 0                  # [R, S]
        R, S = mask.shape
        descs = []
        mask64 = mask.astype(np.int32)
        for spec, pres in zip(self.fmt_specs, sig[:-1]):
            if not pres:
                continue
            descs.append(self._column_desc(spec, bs, mask, mask64))
        if sig[-1]:   # trailing DP
            descs.append(("ints", np.asarray(self.dev["dp_format"]),
                          mask64, b","))
        if not descs:
            descs = [("dots", np.ones((R, S), np.int32), b",")]
        return descs

    def render_group_col(self, sig, bs):
        """(uint8 blob, offsets[R+1]) of the tab-joined sample columns
        per record — the zero-slicing native form of render_group (the
        caller scatter-concatenates group blobs by record index instead
        of materializing per-record byte strings)."""
        if not self.native:
            return None
        return native_loader.render_group_fused(
            self.group_descs(sig, bs), np.asarray(bs), self.live.shape[1])

    def render_group(self, sig, bs) -> List[str]:
        col = self.render_group_col(sig, bs)
        if col is not None:
            recs, rec_offs = col
            return [bytes(recs[rec_offs[r]:rec_offs[r + 1]])
                    for r in range(len(rec_offs) - 1)]
        mask = self.live[bs] >= 0                  # [R, S]
        R, S = mask.shape
        columns = []
        for spec, pres in zip(self.fmt_specs, sig[:-1]):
            if not pres:
                continue
            columns.append(self._column(spec, bs, mask))
        if sig[-1]:   # trailing DP
            columns.append(self._scalar_col(self.dev["dp_format"], bs,
                                            mask))
        if not columns:
            return ["\t".join("." for _ in range(S))] * R
        # pure-Python join
        texts = []
        ncol = len(columns)
        for r in range(R):
            row = []
            for s_i in range(S):
                i = r * S + s_i
                parts = []
                for blob, offs in columns:
                    parts.append(
                        blob[offs[i]:offs[i + 1]].decode("ascii"))
                row.append(":".join(parts))
            texts.append("\t".join(row))
        return texts

    # ---- column builders: each returns (bytes, offsets[R*S+1]) ----

    def _ints_col(self, vals, lens):
        if self.native:
            return native_loader.render_int_lists(
                np.ascontiguousarray(vals, dtype=np.int32),
                _ragged_offsets(lens), b",")
        # python fallback
        offs = _ragged_offsets(lens)
        out = []
        flat = np.asarray(vals).ravel()
        for i in range(len(lens.ravel())):
            seg = flat[offs[i]:offs[i + 1]]
            out.append(",".join(_fmt_elem(x, False) for x in seg)
                       if len(seg) else ".")
        return _py_to_col([out])

    def _scalar_col(self, arr, bs, mask):
        vals = np.where(mask, arr[bs], INT_MISSING).astype(np.int32)
        lens = np.ones(mask.shape, dtype=np.int64)
        return self._ints_col(vals.ravel(), lens)

    def _column_desc(self, spec, bs, mask, mask64=None):
        """render_group_fused descriptor for one FORMAT column —
        ("ints", vals, lens, delim) / ("dots", lens, delim) pass the
        raw outputs (PL / AD / GT record-strided or dense) straight to
        the one-pass native renderer;
        python-loop columns (GT text, char/float extras, raw-PL mixed
        cells) pre-render to a ("blob", bytes, offsets) span."""
        nm = spec.name
        if spec.kind == "gt":
            produce = self.plan.produce_gt
            phase = self.plan.gt_phase
            if not produce and not phase:
                per_p = self.ploidy_bs[bs] if self.mixed else self.ploidy
                return ("dots", np.where(mask, per_p, 0), b"/")
            # produce_GT / phased: encode_GT_vector in the native group
            # renderer unless some cell carries a spanning-deletion GT
            # override (rare; python path patches those per cell)
            ov = self.meta.gt_override or {}
            if ov:
                ov_bs = {k[0] for k in ov}
                if any(int(b) in ov_bs for b in bs):
                    return ("blob",) + self._column(spec, bs, mask)
            return ("gt", self.dev["gt"], mask.astype(np.int32), produce,
                    phase)
        if mask64 is None:
            mask64 = mask.astype(np.int32)
        if nm == "GQ":
            return ("ints", np.asarray(self.dev["gq"]), mask64, b",")
        if nm == "MIN_DP":
            return ("ints", np.asarray(self.dev["min_dp"]), mask64,
                    b",")
        if nm == "AD":
            nmm = self.blk.rec_num_merged[bs]
            valid = mask & self.meta.valid_core["AD"][bs]
            return ("ints", self.dev["ad"],
                    np.where(valid, nmm[:, None], 0), b",")
        if nm == "PL":
            nmm = self.blk.rec_num_merged[bs]
            if self.mixed:
                ng = _num_genotypes_ploidy(nmm[:, None],
                                           self.ploidy_bs[bs])
            else:
                ng = _num_genotypes(nmm, self.ploidy)[:, None]
            valid = mask & self.meta.valid_core["PL"][bs]
            lens_out = np.where(valid, ng, 0)
            if self.mixed:
                raw_cells = (self.meta.is_ref_block_only[bs][:, None]
                             & (self.ploidy_bs[bs] == 0) & valid)
                if raw_cells.any():
                    return ("blob",) + self._column(spec, bs, mask)
            return ("ints", self.dev["pl"], lens_out, b",")
        ex = self.meta.extras[nm]
        if spec.kind == "float" and ex.vals is not None:
            valid = mask & ex.valid[bs]
            if spec.wkind in ("A", "R"):
                off = 1 if spec.wkind == "A" else 0
                wrec = self.blk.rec_num_merged[bs] - off
                lens = np.where(valid, wrec[:, None], 0)
            elif spec.wkind in ("scalar", "fixed"):
                lens = np.where(valid, spec.width, 0)
            else:
                lens = np.where(valid, ex.lens[bs], 0)
            return ("floats", ex.vals, lens, b",")
        if spec.kind in ("char", "float"):
            return ("blob",) + self._column(spec, bs, mask)
        valid = mask & ex.valid[bs]
        if spec.wkind in ("scalar", "fixed"):
            return ("ints", ex.vals, np.where(valid, spec.width, 0),
                    b",")
        if spec.wkind in ("A", "R"):
            off = 1 if spec.wkind == "A" else 0
            wrec = self.blk.rec_num_merged[bs] - off
            return ("ints", ex.vals, np.where(valid, wrec[:, None], 0),
                    b",")
        return ("ints", ex.vals, np.where(valid, ex.lens[bs], 0), b",")

    def _column(self, spec, bs, mask):
        nm = spec.name
        R, S = mask.shape
        if spec.kind == "gt":
            produce = self.plan.produce_gt
            phase = self.plan.gt_phase
            if not produce and not phase:
                per_p = self.ploidy_bs[bs] if self.mixed else self.ploidy
                gt_len = np.where(mask, per_p, 0)
                gt_vals = np.full(int(gt_len.sum()), INT_MISSING,
                                  dtype=np.int32)
                if self.native:
                    return native_loader.render_int_lists(
                        gt_vals, _ragged_offsets(gt_len), b"/")
                rows = []
                for r in range(R):
                    for s in range(S):
                        rows.append(
                            "/".join("." for _ in range(self.ploidy))
                            if mask[r, s] else ".")
                return _py_to_col([rows])
            # phased and/or produce_GT: encode_GT_vector 4-way matrix
            # (broad_combined_gvcf.cc:54-138) from the remapped GT
            gtd = RecordStrided.of(self.dev["gt"])
            ov = self.meta.gt_override or {}
            rows = []
            for r, b in enumerate(bs):
                for s in range(S):
                    if not mask[r, s]:
                        rows.append(".")
                        continue
                    vec = ov.get((int(b), s))
                    if vec is None:
                        vec = gtd.row(int(b))[s]
                    rows.append(_gt_text(vec, produce, phase))
            return _py_to_col([rows])
        if nm == "GQ":
            return self._scalar_col(self.dev["gq"], bs, mask)
        if nm == "MIN_DP":
            return self._scalar_col(self.dev["min_dp"], bs, mask)
        if nm == "AD":
            nmm = self.blk.rec_num_merged[bs]
            valid = mask & self.meta.valid_core["AD"][bs]
            lens = np.where(valid, nmm[:, None], 0)
            return self._ragged_ints(
                RecordStrided.of(self.dev["ad"]).take(bs, lens), lens,
                mask)
        if nm == "PL":
            nmm = self.blk.rec_num_merged[bs]
            if self.mixed:
                # per-call genotype count C(nm+p-1, p) from per-call
                # ploidy (general-ploidy cohorts)
                ng = _num_genotypes_ploidy(nmm[:, None],
                                           self.ploidy_bs[bs])
            else:
                ng = _num_genotypes(nmm, self.ploidy)[:, None]
            valid = mask & self.meta.valid_core["PL"][bs]
            pl = RecordStrided.of(self.dev["pl"])
            lens_out = np.where(valid, ng, 0)
            if self.mixed:
                # ploidy-0 calls (no GT) inside ref-block-only records:
                # the sequential operator does no remapping there
                # (remapping_needed is False) and renders the stored PL
                # raw, while the device remap yields nothing
                raw_cells = (self.meta.is_ref_block_only[bs][:, None]
                             & (self.ploidy_bs[bs] == 0) & valid)
                if raw_cells.any():
                    return self._pl_with_raw(pl, bs, lens_out,
                                             raw_cells, mask)
            return self._ragged_ints(pl.take(bs, lens_out), lens_out,
                                     mask)
        # ---- extras ----
        ex = self.meta.extras[nm]
        if spec.kind == "char":
            return self._char_col(nm, ex, bs, mask)
        if spec.kind == "float":
            return self._float_col(spec, ex, bs, mask)
        # int extras
        valid = mask & ex.valid[bs]
        if spec.wkind in ("scalar", "fixed"):
            w = spec.width
            sel_vals = ex.vals[bs][valid]
            return self._ragged_ints(sel_vals.reshape(-1),
                                     np.where(valid, w, 0), mask)
        if spec.wkind in ("A", "R"):
            off = 1 if spec.wkind == "A" else 0
            wrec = self.blk.rec_num_merged[bs] - off
            lens = np.where(valid, wrec[:, None], 0)
            sel = (np.arange(ex.vals.shape[2]) < wrec[:, None, None]) \
                & valid[:, :, None]
            return self._ragged_ints(ex.vals[bs][sel], lens, mask)
        # VAR: per-sample own length
        lens = np.where(valid, ex.lens[bs], 0)
        sel = np.arange(ex.vals.shape[2])[None, None, :] \
            < lens[:, :, None]
        return self._ragged_ints(ex.vals[bs][sel], lens, mask)

    def _pl_with_raw(self, pl, bs, lens_out, raw_cells, mask):
        """PL column where a few cells pass the stored values through
        raw (rare: GT-missing calls in ref-block-only records)."""
        fd = self.store.fields.get("PL")
        cm = self.meta.cells_mat
        R, S = raw_cells.shape
        lens_out = np.asarray(lens_out, dtype=np.int64).copy()
        segs = {}
        for r, s in zip(*np.nonzero(raw_cells)):
            ci = int(cm[bs[r], s])
            seg = fd.cell_value(ci)
            seg = np.asarray(seg if seg is not None else [],
                             dtype=np.int32)
            segs[(int(r), int(s))] = seg
            lens_out[r, s] = len(seg)
        flat = np.empty(int(lens_out.sum()), dtype=np.int32)
        pos = 0
        for r in range(R):
            plr = pl.row(int(bs[r]))
            for s in range(S):
                n = int(lens_out[r, s])
                if not n:
                    continue
                seg = segs.get((r, s))
                flat[pos:pos + n] = seg if seg is not None \
                    else plr[s, :n]
                pos += n
        return self._ragged_ints(flat, lens_out, mask)

    def _ragged_ints(self, flat_vals, lens, mask):
        """Rows with len>0 get their values; len==0 rows render '.'
        (a single missing value), matching collect_and_extend's
        missing-call encoding."""
        lens = np.asarray(lens, dtype=np.int64)
        zero = lens == 0
        if zero.any():
            # splice a single INT_MISSING into empty rows
            out_lens = np.where(zero, 1, lens)
            total = int(out_lens.sum())
            vals = np.empty(total, dtype=np.int32)
            offs = _ragged_offsets(out_lens)
            pos = 0
            src = 0
            flat_vals = np.asarray(flat_vals, dtype=np.int32).ravel()
            lens_f = lens.ravel()
            zero_f = zero.ravel()
            for i in range(len(lens_f)):
                if zero_f[i]:
                    vals[pos] = INT_MISSING
                    pos += 1
                else:
                    n = int(lens_f[i])
                    vals[pos:pos + n] = flat_vals[src:src + n]
                    pos += n
                    src += n
            return self._ints_col(vals, out_lens)
        return self._ints_col(flat_vals, lens)

    def _char_col(self, nm, ex, bs, mask):
        fd = self.store.fields.get(nm)
        cm = self.meta.cells_mat
        rows = []
        for r, b in enumerate(bs):
            for s in range(mask.shape[1]):
                if not (mask[r, s] and ex.valid[b, s]):
                    rows.append(".")
                    continue
                ci = int(cm[b, s])
                v = fd.cell_value(ci)
                rows.append(str(v) if v else ".")
        return _py_to_col([rows])

    def _float_col(self, spec, ex, bs, mask):
        valid = mask & ex.valid[bs]
        if spec.wkind in ("A", "R"):
            off = 1 if spec.wkind == "A" else 0
            wrec = self.blk.rec_num_merged[bs] - off
        elif spec.wkind in ("scalar", "fixed"):
            wrec = np.full(len(bs), spec.width)
        else:
            wrec = None
        rows = []
        for r in range(mask.shape[0]):
            for s in range(mask.shape[1]):
                if not valid[r, s]:
                    rows.append(".")
                    continue
                if wrec is not None and np.ndim(wrec) == 1:
                    w = int(wrec[r])
                elif wrec is not None:
                    w = int(wrec)
                else:
                    w = int(ex.lens[bs][r, s])
                seg = ex.vals[bs][r, s, :w]
                rows.append(",".join(_fmt_elem(x, True) for x in seg)
                            if w else ".")
        return _py_to_col([rows])
