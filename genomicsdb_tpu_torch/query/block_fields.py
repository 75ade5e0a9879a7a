"""Vid-driven field plan for the batched block engine.

Classifies every queried attribute the way BroadCombinedGVCFOperator
does (reference broad_combined_gvcf.cc:165-265, reused from
query/combine.py's CombineOperator so ordering rules cannot drift), and
decides HOW the block path realizes each field:

  FORMAT fields -> per-(record, sample) gathered tensors rendered as
  sample columns (scalar/fixed ints via the native render kernels,
  allele-dependent fields through the batched remap, chars/floats on
  host), in the sequential writer's exact FORMAT order.

  INFO fields -> device reductions for the hot scalar ops
  (median/sum stacks in combine_step) and host reductions for the rare
  rest (int sums, element-wise sums, 2-D allele-specific fields,
  histogram_sum), emitted in the sequential writer's INFO order.

Any queried field the block path cannot realize forces the records that
carry it onto the sequential splice — the plan's `unsupported` set is
the single source of truth for that decision (store_block.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import List, Optional, Set, Tuple

import numpy as np

from ..core import formats
from ..core import known_fields as kf
from ..core.config import QueryConfig
from ..core.vid import VidMapper
from .combine import CombineOperator


@dataclass
class FormatSpec:
    name: str                 # vid field name (DP_FORMAT, SB, ...)
    vcf_name: str             # rendered FORMAT id
    kind: str                 # 'gt' | 'int' | 'float' | 'char'
    wkind: str                # 'scalar' | 'fixed' | 'A' | 'R' | 'G' | 'VAR'
    width: int = 1            # element count for scalar/fixed


@dataclass
class InfoSpec:
    name: str
    vcf_name: str
    op: object                # kf.OP_*
    is_float: bool
    is_2d: bool = False
    length_code: Optional[int] = None  # kf.VL_* of dim 0
    # where the value comes from at render time:
    #   'med' -> device float median stack slot
    #   'imed' -> device int median stack slot
    #   'fsum' -> device float sum stack slot
    #   'host' -> host-computed per record
    source: str = "host"
    slot: int = -1


@dataclass
class BlockPlan:
    format_specs: List[FormatSpec] = dc_field(default_factory=list)
    info_specs: List[InfoSpec] = dc_field(default_factory=list)
    hist_specs: List[Tuple[str, str, str]] = dc_field(default_factory=list)
    med_fields: List[str] = dc_field(default_factory=list)   # device stacks
    imed_fields: List[str] = dc_field(default_factory=list)
    fsum_fields: List[str] = dc_field(default_factory=list)
    dp_info_queried: bool = False
    qual_spec: Optional[InfoSpec] = None
    id_queried: bool = False
    produce_filter: bool = False
    sites_only: bool = False
    produce_gt: bool = False
    produce_min_pl_gt: bool = False
    gt_phase: bool = False
    # fields whose presence on a record forces the sequential splice
    unsupported: Set[str] = dc_field(default_factory=set)
    # every field name consumed by the block path (no splice)
    handled: Set[str] = dc_field(default_factory=set)


def build_block_plan(qc: QueryConfig, vid: VidMapper) -> BlockPlan:
    op_cls = CombineOperator(qc, vid, None)
    plan = BlockPlan()
    plan.dp_info_queried = op_cls.dp_info_queried
    plan.id_queried = qc.is_queried("ID")
    plan.sites_only = qc.params.sites_only_query
    plan.produce_filter = (qc.params.produce_FILTER_field
                           and qc.is_queried("FILTER"))
    plan.produce_gt = qc.params.produce_GT_field
    plan.produce_min_pl_gt = op_cls.produce_min_pl_gt
    plan.gt_phase = op_cls.gt_phase
    plan.hist_specs = list(op_cls.histogram_fields)
    # always-consumed core fields
    plan.handled |= {"END", "REF", "ALT", "FILTER", "GT"}
    if op_cls.qual_queried and op_cls.qual_op is not kf.OP_NONE:
        plan.qual_spec = InfoSpec("QUAL", "QUAL", op_cls.qual_op,
                                  is_float=True)
        _route_scalar(plan, plan.qual_spec)
    plan.handled.add("QUAL")
    if plan.id_queried:
        plan.handled.add("ID")

    # ---- FORMAT ----
    for name in op_cls.format_fields:
        info = qc.field_info(name)
        if info is None:
            continue
        if name == "GT":
            plan.format_specs.append(FormatSpec("GT", "GT", "gt", "P"))
            continue
        if name == "DP" and not op_cls.dp_info_queried:
            # a vid declaring DP as a plain FORMAT field (no "DP"
            # combine op) renders the stored INFO-DP values generically
            # in the sequential writer; rare enough to splice
            plan.unsupported.add(name)
            continue
        is_char = info.type in ("char", "string")
        is_float = info.type == "float"
        ld = info.length
        if is_char:
            spec = FormatSpec(name, info.vcf_name, "char", "VAR")
        elif ld.is_genotype_dependent():
            # PL takes the device remap kernel; any other G-length field
            # goes through the vectorized host twin (remap_genotype_np)
            spec = FormatSpec(name, info.vcf_name,
                              "float" if is_float else "int", "G")
        elif ld.is_allele_dependent():
            spec = FormatSpec(name, info.vcf_name,
                              "float" if is_float else "int",
                              "A" if ld.is_only_alt_dependent() else "R")
        elif ld.is_fixed():
            w = ld.fixed_len
            spec = FormatSpec(name, info.vcf_name,
                              "float" if is_float else "int",
                              "scalar" if w == 1 else "fixed", w)
        else:  # VAR-length numeric
            spec = FormatSpec(name, info.vcf_name,
                              "float" if is_float else "int", "VAR")
        plan.format_specs.append(spec)
        plan.handled.add(name)

    # ---- INFO combine fields ----
    for name in op_cls.info_fields:
        info = qc.field_info(name)
        if info is None:
            continue
        is_float = info.type == "float"
        is_2d = info.length.num_dimensions > 1
        code = info.length.dims[0][0] if info.length.dims else None
        spec = InfoSpec(name, info.vcf_name, info.combine_op, is_float,
                        is_2d, code)
        if not is_2d and info.length.is_fixed() \
                and info.length.fixed_len == 1 \
                and not info.length.is_allele_dependent():
            _route_scalar(plan, spec)
        else:
            spec.source = "host"
        plan.info_specs.append(spec)
        plan.handled.add(name)
    for parent, bin_f, cnt_f in plan.hist_specs:
        plan.handled |= {bin_f, cnt_f}

    # queried fields the sequential VCF writer provably ignores: INFO
    # fields with no combine op (e.g. flags like DS) never render
    # (CombineOperator.__init__ drops them), so they cannot force splice
    for name in qc.attributes:
        if name in plan.handled or name in plan.unsupported:
            continue
        info = vid.get_field_info(name)
        if info is None:
            plan.handled.add(name)
            continue
        renders = (info.is_format
                   or info.combine_op is not kf.OP_NONE
                   or name in ("DP",))
        if not renders:
            plan.handled.add(name)
    return plan


def _route_scalar(plan: BlockPlan, spec: InfoSpec):
    """Assign a scalar INFO spec to a device stack or the host path."""
    if spec.is_float and spec.op == kf.OP_MEDIAN:
        spec.source, spec.slot = "med", len(plan.med_fields)
        plan.med_fields.append(spec.name)
    elif not spec.is_float and spec.op == kf.OP_MEDIAN:
        spec.source, spec.slot = "imed", len(plan.imed_fields)
        plan.imed_fields.append(spec.name)
    elif spec.is_float and spec.op == kf.OP_SUM:
        spec.source, spec.slot = "fsum", len(plan.fsum_fields)
        plan.fsum_fields.append(spec.name)
    else:
        spec.source = "host"    # int sums / means: arbitrary-precision


def effective_valid(fd, num_cells: int) -> np.ndarray:
    """Per-cell validity with the reference's value rules: all-missing
    vectors and zero-length variable fields are invalid
    (variant_field_data.h:360-384, mirrors CallView._compute_field)."""
    if fd is None or fd.valid is None:
        return np.zeros(num_cells, dtype=bool)
    ok = fd.valid.copy()
    if fd.kind == "fixed":
        v = fd.values
        if v.dtype == np.int32:
            ok &= ~(v == formats.INT_MISSING).all(axis=1)
        elif v.dtype == np.float32:
            ok &= ~(v.view(np.uint32)
                    == formats.FLOAT_MISSING_BITS).all(axis=1)
    elif fd.kind in ("ragged", "str"):
        lens = fd.lens()
        ok &= lens > 0
        if fd.kind == "ragged" and len(fd.values):
            if fd.values.dtype == np.int32:
                miss = (fd.values == formats.INT_MISSING).astype(np.int64)
            elif fd.values.dtype == np.float32:
                miss = (fd.values.view(np.uint32)
                        == formats.FLOAT_MISSING_BITS).astype(np.int64)
            else:
                miss = None
            if miss is not None:
                cs = np.concatenate([[0], np.cumsum(miss)])
                n_missing = cs[fd.offsets[1:]] - cs[fd.offsets[:-1]]
                ok &= ~((lens > 0) & (n_missing == lens))
    elif fd.kind == "ragged2d":
        ok &= fd.outer_lens() > 0
    return ok


def remap_allele_np(vals: np.ndarray, lens: np.ndarray,
                    inv_bs: np.ndarray, nr_bs: np.ndarray,
                    rec_nm: np.ndarray, alt_only: bool,
                    missing) -> np.ndarray:
    """numpy twin of jax_kernels.remap_allele_fields over gathered
    [B, S, K] values (used for the rare extra allele-dependent FORMAT
    fields; PL/AD take the device kernels)."""
    offset = 1 if alt_only else 0
    inv = inv_bs[..., offset:]
    nr = nr_bs[..., None]
    in_allele = np.where(inv == -1, np.where(nr >= 0, nr, -1), inv)
    idx = in_allele - offset
    K = vals.shape[-1]
    ok = (in_allele != -1) & (idx >= 0) & (idx < lens[..., None])
    gathered = np.take_along_axis(vals, np.clip(idx, 0, max(K - 1, 0)),
                                  axis=-1)
    m = np.arange(inv.shape[-1])[None, None, :]
    ok &= m < (rec_nm[:, None, None] - offset)
    return np.where(ok, gathered, missing)


def remap_genotype_np(vals: np.ndarray, lens: np.ndarray,
                      inv_bs: np.ndarray, nr_bs: np.ndarray,
                      rec_nm: np.ndarray, ploidy_bs: np.ndarray,
                      missing) -> Tuple[np.ndarray, np.ndarray]:
    """numpy twin of jax_kernels.remap_genotype_fields with per-call
    ploidy: G-length (genotype-dependent) field remap for the extras
    path (variant_field_handler.cc:84-296; PL takes the device kernel).

    vals [B,S,K] raw gathered values, lens [B,S] valid input counts,
    inv_bs [B,S,M] merged->input allele LUT, nr_bs [B,S] input NON_REF
    index (-1 none), rec_nm [B] merged allele counts, ploidy_bs [B,S]
    per-call ploidy (0 = no GT -> empty output, matching
    genotype_combinations(nm, 0) == ()).

    Returns (out [B,S,G_max], ng [B,S]): ng is the per-call output
    genotype count C(nm + p - 1, p); out rows are missing-filled past it.
    Relies on the same canonical-order prefix property as the device
    kernel: genotypes over nm alleles are the first C(nm+p-1,p) rows of
    the max-width combo table.
    """
    import math
    from ..ops.cell_block import genotype_combo_table
    B, S, K = vals.shape
    Mw = inv_bs.shape[2]
    ploidies = sorted(int(p) for p in np.unique(ploidy_bs) if p > 0)
    if not ploidies or K == 0:
        return (np.full((B, S, 1), missing, dtype=vals.dtype),
                np.zeros((B, S), dtype=np.int64))
    tables = {p: genotype_combo_table(Mw, p) for p in ploidies}
    g_max = max(t.shape[0] for t in tables.values())
    out = np.full((B, S, g_max), missing, dtype=vals.dtype)
    ng = np.zeros((B, S), dtype=np.int64)
    for p in ploidies:
        combos = tables[p]                       # [Gp, p] ascending rows
        sel = ploidy_bs == p
        bi, si = np.nonzero(sel)
        if len(bi) == 0:
            continue
        inv = inv_bs[bi, si]                     # [n, Mw]
        a = inv[:, combos]                       # [n, Gp, p]
        nr_c = nr_bs[bi, si][:, None, None]
        a = np.where((a == -1) & (nr_c >= 0), nr_c, a)
        bad = (a == -1).any(axis=2)              # unmappable combo
        a = np.sort(np.maximum(a, 0), axis=2).astype(np.int64)
        # canonical genotype index: sum_i C(i + a_i, i + 1)
        in_gt = np.zeros(a.shape[:2], dtype=np.int64)
        for i in range(p):
            ai = a[:, :, i]
            t = np.ones_like(ai)
            for j in range(i + 1):
                t = t * (ai + i - j)
            in_gt += t // math.factorial(i + 1)
        ok = ~bad & (in_gt < lens[bi, si][:, None])
        # genotypes touching alleles beyond the record's merged count
        # stay missing (the render also stops at ng)
        ok &= combos.max(axis=1)[None, :] < rec_nm[bi][:, None]
        gathered = np.take_along_axis(
            vals[bi, si], np.clip(in_gt, 0, K - 1), axis=1)
        out[bi, si, :combos.shape[0]] = np.where(ok, gathered, missing)
        ng_lut = np.array([math.comb(n + p - 1, p)
                           for n in range(Mw + 1)], dtype=np.int64)
        ng[bi, si] = ng_lut[np.clip(rec_nm[bi], 0, Mw)]
    return out, ng
