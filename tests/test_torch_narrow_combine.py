"""The narrow (int16) form of the port's kernel path, the per-sample
Pallas kernel and the med_rows restriction on the CPU, against
genomicsdb_tpu (Pallas interpret mode).

The plain twin is held to the raw outputs of both Pallas kernels:
`fused_gather_remap_rt` in its narrow form, and `fused_gather_remap`
(`_make_kernel`, one sample per grid step), whose function is the wide,
non-mixed case of the port's CUDA kernel.  Exact comparison throughout:
integers equal (int16 included), floats as int32 bits."""

import dataclasses

import numpy as np
import pytest
import torch

from genomicsdb_tpu.ops import combine_step as JC
from genomicsdb_tpu.ops import pallas_combine as PC
from genomicsdb_tpu_torch.ops import combine_step as TC
from genomicsdb_tpu_torch.ops import fused_combine as FC

from genomicsdb_tpu_torch.ops import cell_block as CB

from test_torch_combine_step import compare_outputs, make_blocks

# Pallas output row name -> the port's output key
_ROW_KEYS = (("pl", "pl"), ("ad", "ad"), ("gt", "gt"), ("gq", "gq"),
             ("dpf", "dp_format"), ("mdp", "min_dp"), ("dpi", "dp_info"),
             ("info_f", "info_f"), ("info_i", "info_i"),
             ("info_fs", "info_fs"))


def _pallas_raw(blk, m, p, phased=False, mixed=False, rt=8, narrow=False,
                narrow_scalars=False):
    """Run a Pallas kernel (interpret mode) on `blk` and reorder its
    stacked output(s) into the port's per-key layout: rt 1 is
    `fused_gather_remap` (`_make_kernel`, [S, Vout, Bpad]), rt > 1 is
    `fused_gather_remap_rt`, narrow or wide."""
    cfg = PC.make_fused_config(blk, max_merged=m, ploidy=p,
                               gt_phase=phased, rt=rt, mixed=mixed)
    if narrow:
        cfg = dataclasses.replace(cfg, narrow=True,
                                  narrow_scalars=narrow_scalars)
    prep = PC.fused_host_prep(blk, cfg)
    assert prep is not None
    cfg, live_p = prep["cfg"], prep["live_p"]
    Bp, S = live_p.shape
    B = blk.live.shape[0]
    if cfg.rt == 1:
        raw = PC.fused_gather_remap(
            prep["pay"], prep["live_t"], prep["inv_t"], prep["nr_t"],
            prep["recnm2"], prep["recnr2"], prep["w0b"], cfg=cfg,
            interpret=True)
        outs = [(np.asarray(raw), cfg.out_rows)]
    else:
        T = Bp // cfg.bt
        gtl = None
        if mixed:
            gtl = np.ascontiguousarray(
                np.pad(blk.gt_len_bs, ((0, Bp - B), (0, 0))).T
            ).astype(np.int8).reshape(S, T, cfg.bt)
        raw = PC.fused_gather_remap_rt(
            prep["pay"], prep["live_t"][:, 0].reshape(S, T, cfg.bt),
            prep["inv_t"].reshape(S, prep["inv_t"].shape[1], T, cfg.bt),
            prep["nr_t"][:, 0].reshape(S, T, cfg.bt),
            prep["recnm2"][0].reshape(T, cfg.bt),
            prep["recnr2"][0].reshape(T, cfg.bt), prep["w2"], gtl,
            cfg=cfg, interpret=True)
        if narrow:
            outs = [(np.asarray(raw[0]).reshape(S, cfg.vout16, Bp),
                     cfg.out_rows16),
                    (np.asarray(raw[1]).reshape(S, cfg.vout32, Bp),
                     cfg.out_rows32)]
        else:
            outs = [(np.asarray(raw).reshape(S, cfg.vout, Bp),
                     cfg.out_rows)]
    res = {}
    for out, rows in outs:
        for name, key in _ROW_KEYS:
            if name not in rows:
                continue
            lo, hi = rows[name]
            if key in ("pl", "ad", "gt"):
                res[key] = np.transpose(out[:, lo:hi], (2, 0, 1))[:B]
            elif key.startswith("info"):
                res[key] = np.transpose(out[:, lo:hi], (1, 2, 0))[:, :B]
            else:
                res[key] = out[:, lo].T[:B]
    return res


def _twin(blk, m, p, phased=False, mixed=False, **kw):
    t = TC.block_to_tensors(blk, "cpu")
    return FC.fused_gather_remap(
        *t[:12], t[16], t[12], t[13], t[14], t[15],
        t[18] if mixed else None, max_merged=m, ploidy=p,
        gt_phase=phased, mixed=mixed, **kw)


def _assert_raw_equal(ref, got):
    assert set(ref) == set(got)
    for key, a in ref.items():
        b = got[key].numpy()
        if b.dtype == np.float32:
            b = b.view(np.int32)
        assert a.dtype == b.dtype, (key, a.dtype, b.dtype)
        assert a.shape == b.shape, (key, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=key)


# `_make_kernel` has no mixed-ploidy form
PER_SAMPLE_CASES = {
    "diploid": dict(S=8, C=64, R=4096, seed=21),
    "odd_sizes": dict(S=5, C=40, R=3000, seed=7),
    "ploidy6": dict(S=4, C=48, R=4096, seed=11, ploidy=6),
    "m16": dict(S=4, C=40, R=2048, seed=5, m=16),
    "phased_triploid": dict(S=4, C=48, R=4096, seed=17, ploidy=3,
                            phased=True),
}


@pytest.mark.parametrize("case", sorted(PER_SAMPLE_CASES))
def test_twin_matches_per_sample_pallas_kernel(case):
    """The raw [S, Vout, Bpad] output of `fused_gather_remap`
    (`_make_kernel`) equals the twin of the port's wide kernel."""
    kw = dict(PER_SAMPLE_CASES[case])
    jblk, tblk = make_blocks(**kw)
    m, p, phased = kw.get("m", 4), kw.get("ploidy", 2), kw.get("phased",
                                                               False)
    ref = _pallas_raw(jblk, m, p, phased, rt=1)
    _assert_raw_equal(ref, _twin(tblk, m, p, phased))


NARROW_CASES = {
    "diploid": (dict(S=8, C=64, R=4096, seed=21), True),
    "diploid_wide_scalars": (dict(S=8, C=64, R=4096, seed=21), False),
    "m16": (dict(S=4, C=40, R=2048, seed=5, m=16), True),
    "mixed_pmax3": (dict(S=4, C=48, R=4096, seed=13, ploidy=3,
                         mixed=True), True),
    "mixed_phased_pmax3": (dict(S=4, C=48, R=4096, seed=17, ploidy=3,
                                mixed=True, phased=True), True),
}


@pytest.mark.parametrize("case", sorted(NARROW_CASES))
def test_narrow_twin_matches_pallas_kernel(case):
    """The narrow twin equals the narrow Pallas kernel's int16 and int32
    outputs (BCF16 sentinels, VECTOR_END rows of mixed ploidy
    included)."""
    kw, scalars = NARROW_CASES[case]
    kw = dict(kw)
    jblk, tblk = make_blocks(**kw)
    m, p = kw.get("m", 4), kw.get("ploidy", 2)
    phased, mixed = kw.get("phased", False), kw.get("mixed", False)
    ref = _pallas_raw(jblk, m, p, phased, mixed, narrow=True,
                      narrow_scalars=scalars)
    got = _twin(tblk, m, p, phased, mixed, narrow=True,
                narrow_scalars=scalars)
    narrow_keys = ("pl", "ad", "gt") + (("gq", "dp_format", "min_dp")
                                        if scalars else ())
    for key in narrow_keys:
        assert got[key].dtype == torch.int16, key
    if mixed:
        assert (got["gt"] == FC.INT16_VECTOR_END).any()
    _assert_raw_equal(ref, got)


def test_narrow_needs_narrow_for_scalars():
    _, blk = make_blocks(S=3, C=16, R=512, seed=2)
    with pytest.raises(ValueError, match="narrow_scalars needs narrow"):
        _twin(blk, 4, 2, narrow_scalars=True)


@pytest.mark.parametrize("mixed", [False, True])
def test_combine_step_fused_narrow_matches_jax(mixed):
    """combine_step_fused(narrow_out=True) against the JAX one, output
    dict for output dict: int16 PL/AD/GT/GQ/DP/MIN_DP, the rest
    exact (tests/test_pallas_combine.py::test_fused_narrow_outputs)."""
    jblk = JC.synthesize_cohort(6, 48, 4096, seed=21)
    tblk = CB.synthesize_cohort(6, 48, 4096, seed=21)
    if mixed:
        B, S = tblk.live.shape
        rng = np.random.default_rng(5)
        tblk.gt_len_bs = rng.integers(1, 3, size=(B, S)).astype(np.int32)
        jblk.gt_len_bs = tblk.gt_len_bs.copy()
    flags = dict(max_merged=4, ploidy=2, mixed_ploidy=mixed)
    ref = PC.combine_step_fused(jblk, interpret=True, narrow_out=True,
                                **flags)
    got = FC.combine_step_fused(tblk, "cpu", narrow_out=True, **flags)
    assert ref is not None and got is not None
    for k in ("pl", "ad", "gt", "gq", "dp_format", "min_dp"):
        assert got[k].dtype == torch.int16, k
    compare_outputs(ref, got)


def test_int16_overflow_takes_the_wide_kernel():
    """A block with a genuine int16 overflow in PL takes the wide form
    (counted), as the JAX gate does; one in GQ alone keeps PL/AD/GT
    narrow and GQ/DP/MIN_DP wide."""
    blk = CB.synthesize_cohort(4, 40, 3000, seed=7)
    assert FC._narrow_inputs_ok(blk) and FC._narrow_scalars_ok(blk)

    def both(edit):
        """(JAX block, port block) with the same edit."""
        pair = (JC.synthesize_cohort(4, 40, 3000, seed=7),
                CB.synthesize_cohort(4, 40, 3000, seed=7))
        for b in pair:
            edit(b)
        return pair

    def big_pl(b):
        b.pl = b.pl.copy()
        b.pl[0, 0, 0] = 100_000

    def big_gq(b):
        b.gq = b.gq.copy()
        b.gq[1, 2] = 40_000

    jwide, wide = both(big_pl)
    assert not FC._narrow_inputs_ok(wide)
    before = FC.combine_block.wide_blocks_when_packing
    got = FC.combine_block(wide, "cpu", max_merged=4, ploidy=2,
                           narrow_out=True)
    assert FC.combine_block.wide_blocks_when_packing == before + 1
    assert got["pl"].dtype == torch.int32 and got["gq"].dtype == torch.int32
    compare_outputs(PC.combine_step_fused(jwide, max_merged=4, ploidy=2,
                                          interpret=True, narrow_out=True),
                    got)
    jgq, gq = both(big_gq)
    assert FC._narrow_inputs_ok(gq) and not FC._narrow_scalars_ok(gq)
    got = FC.combine_block(gq, "cpu", max_merged=4, ploidy=2,
                           narrow_out=True)
    assert FC.combine_block.wide_blocks_when_packing == before + 1
    assert got["pl"].dtype == torch.int16 and got["gq"].dtype == torch.int32
    compare_outputs(PC.combine_step_fused(jgq, max_merged=4, ploidy=2,
                                          interpret=True, narrow_out=True),
                    got)


def test_range_check_cache_follows_the_slabs():
    """The checks are cached on the store-wide layout under the port's
    own keys, together with the slabs they read: the JAX package's
    entries are neither read nor written, and a block whose slabs are
    other arrays is checked anew."""
    blk = CB.synthesize_cohort(4, 40, 3000, seed=7)
    blk._dense_layout = {"_narrow_ok": False, "_narrow_scalars_ok": False}
    assert FC._narrow_inputs_ok(blk) and FC._narrow_scalars_ok(blk)
    lay = blk._dense_layout
    assert lay["_torch_narrow_ok"][1] is True
    assert lay["_torch_narrow_scalars_ok"][1] is True
    assert lay["_narrow_ok"] is False
    blk.ad = blk.ad.copy()
    blk.ad[1, 1, 0] = -40_000
    assert not FC._narrow_inputs_ok(blk)
    assert lay["_torch_narrow_ok"][1] is False
    blk.dp = blk.dp.copy()
    blk.dp[0, 3] = 32_001
    assert not FC._narrow_scalars_ok(blk)


def _med_rows(blk, seed):
    """A bucket-padded med_rows array as the writer builds it: a sorted
    subset of the rows, then row 0 repeated up to a power of two."""
    B = blk.live.shape[0]
    rng = np.random.default_rng(seed)
    mr = np.sort(rng.choice(B, size=B // 3, replace=False))
    bucket = 8
    while bucket < len(mr):
        bucket *= 2
    out = np.zeros(bucket, np.int32)
    out[:len(mr)] = mr
    return out


@pytest.mark.parametrize("path", ["fused", "fused_narrow", "general",
                                  "general_m20"])
def test_med_rows_matches_jax(path):
    """med_rows restricts the INFO reductions to those rows on both
    combine paths, as the JAX ones do: the [F, len(med_rows)] results
    and the full-width passthroughs are equal."""
    m = 20 if path == "general_m20" else 4
    jblk, blk = make_blocks(S=5, C=40, R=3000, seed=7, m=m)
    mr = _med_rows(blk, seed=3)
    flags = dict(max_merged=m, ploidy=2)
    if path.startswith("fused"):
        narrow = path == "fused_narrow"
        ref = PC.combine_step_fused(jblk, interpret=True, med_rows=mr,
                                    narrow_out=narrow, **flags)
        got = FC.combine_step_fused(blk, "cpu", med_rows=mr,
                                    narrow_out=narrow, **flags)
    else:
        ref = JC.combine_step(*JC.block_to_args(jblk), med_rows=mr, **flags)
        got = TC.combine_step(*TC.block_to_tensors(blk, "cpu"),
                              med_rows=mr, **flags)
    assert got["info_median"].shape[1] == len(mr)
    compare_outputs(ref, got)
