"""The port's kernel path on the CPU against genomicsdb_tpu's fused
Pallas path (interpret mode): the plain twin against the raw kernel
output of `fused_gather_remap_rt`, and `combine_step_fused` against the
JAX `combine_step_fused`, on the cases of tests/test_pallas_combine.py
plus a phased one.  Exact comparison throughout."""

import numpy as np
import pytest
import torch

from genomicsdb_tpu.ops import combine_step as JC
from genomicsdb_tpu.ops import pallas_combine as PC
from genomicsdb_tpu_torch.device import resolve_device
from genomicsdb_tpu_torch.ops import cell_block as CB
from genomicsdb_tpu_torch.ops import combine_step as TC
from genomicsdb_tpu_torch.ops import fused_combine as FC

from test_torch_combine_step import compare_outputs, make_block, make_blocks


def _jax_kernel_outputs(blk, m, p, phased, mixed, rt=8):
    """Run the Pallas kernel (interpret mode) on `blk` and reorder its
    stacked [S, Vout, Bpad] output into the port's per-key layout."""
    cfg = PC.make_fused_config(blk, max_merged=m, ploidy=p,
                               gt_phase=phased, rt=rt, mixed=mixed)
    prep = PC.fused_host_prep(blk, cfg)
    cfg, live_p = prep["cfg"], prep["live_p"]
    Bp, S = live_p.shape
    B = blk.live.shape[0]
    T = Bp // cfg.bt
    gtl = None
    if mixed:
        gtl = np.ascontiguousarray(
            np.pad(blk.gt_len_bs, ((0, Bp - B), (0, 0))).T
        ).astype(np.int8).reshape(S, T, cfg.bt)
    out = PC.fused_gather_remap_rt(
        prep["pay"], prep["live_t"][:, 0].reshape(S, T, cfg.bt),
        prep["inv_t"].reshape(S, prep["inv_t"].shape[1], T, cfg.bt),
        prep["nr_t"][:, 0].reshape(S, T, cfg.bt),
        prep["recnm2"][0].reshape(T, cfg.bt),
        prep["recnr2"][0].reshape(T, cfg.bt), prep["w2"], gtl, cfg=cfg,
        interpret=True)
    out = np.asarray(out).reshape(S, cfg.vout, Bp)
    rows = cfg.out_rows
    res = {}
    for name in ("pl", "ad", "gt"):
        lo, hi = rows[name]
        res[name] = np.transpose(out[:, lo:hi], (2, 0, 1))[:B]
    for name, key in (("gq", "gq"), ("dpf", "dp_format"),
                      ("mdp", "min_dp"), ("dpi", "dp_info")):
        res[key] = out[:, rows[name][0]].T[:B]
    for name in ("info_f", "info_i", "info_fs"):
        lo, hi = rows[name]
        res[name] = np.transpose(out[:, lo:hi], (1, 2, 0))[:, :B]
    return res


def _twin_outputs(blk, m, p, phased, mixed):
    t = TC.block_to_tensors(blk, "cpu")
    return FC.fused_gather_remap(
        *t[:12], t[16], t[12], t[13], t[14], t[15],
        t[18] if mixed else None, max_merged=m, ploidy=p,
        gt_phase=phased, mixed=mixed)


KERNEL_CASES = {
    "diploid": dict(S=8, C=64, R=4096, seed=21),
    "ploidy6": dict(S=4, C=48, R=4096, seed=11, ploidy=6),
    "m16": dict(S=4, C=40, R=2048, seed=5, m=16),
    "mixed_phased_pmax3": dict(S=4, C=48, R=4096, seed=13, ploidy=3,
                               mixed=True, phased=True),
    # the kernel's ploidy <= 2 instantiation: haploid-only, and mixed
    # haploid / diploid calls (GT lengths 0-2, phased 0-3)
    "haploid": dict(S=4, C=48, R=4096, seed=31, ploidy=1, m=8),
    "mixed_pmax2": dict(S=4, C=48, R=4096, seed=33, ploidy=2, mixed=True,
                        m=8),
    "mixed_phased_pmax2": dict(S=4, C=48, R=4096, seed=35, ploidy=2,
                               mixed=True, phased=True, m=16),
}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_twin_matches_pallas_kernel(case):
    kw = dict(KERNEL_CASES[case])
    jblk, tblk = make_blocks(**kw)
    m, p = kw.get("m", 4), kw.get("ploidy", 2)
    phased, mixed = kw.get("phased", False), kw.get("mixed", False)
    ref = _jax_kernel_outputs(jblk, m, p, phased, mixed)
    got = _twin_outputs(tblk, m, p, phased, mixed)
    assert set(ref) == set(got)
    for key, a in ref.items():
        b = got[key].numpy()
        if b.dtype == np.float32:
            b = b.view(np.int32)
        assert b.dtype == np.int32, (key, b.dtype)
        assert a.shape == b.shape, (key, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=key)


# the cases of tests/test_pallas_combine.py (synthetic and odd sizes at
# rt 1 and 8, ploidy 3/5/6, mixed pmax 3/6) and a phased mixed block
FUSED_CASES = {
    "synthetic_rt1": (dict(S=8, C=64, R=4096, seed=21), 1),
    "synthetic_rt8": (dict(S=8, C=64, R=4096, seed=21), 8),
    "odd_sizes_rt1": (dict(S=5, C=40, R=3000, seed=7), 1),
    "odd_sizes_rt8": (dict(S=5, C=40, R=3000, seed=7), 8),
    "ploidy3": (dict(S=4, C=48, R=4096, seed=11, ploidy=3), 0),
    "ploidy5": (dict(S=3, C=24, R=1024, seed=11, ploidy=5), 0),
    "ploidy6": (dict(S=4, C=48, R=4096, seed=11, ploidy=6), 0),
    "mixed_pmax3": (dict(S=4, C=48, R=4096, seed=13, ploidy=3,
                         mixed=True), 0),
    "mixed_pmax6": (dict(S=3, C=24, R=1024, seed=13, ploidy=6,
                         mixed=True), 0),
    "mixed_phased_pmax3": (dict(S=4, C=48, R=4096, seed=17, ploidy=3,
                                mixed=True, phased=True), 0),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_combine_step_fused_matches_jax(case):
    kw, rt = FUSED_CASES[case]
    kw = dict(kw)
    jblk, tblk = make_blocks(**kw)
    m, p = kw.get("m", 4), kw.get("ploidy", 2)
    flags = dict(max_merged=m, ploidy=p, gt_phase=kw.get("phased", False),
                 mixed_ploidy=kw.get("mixed", False))
    ref = PC.combine_step_fused(jblk, interpret=True, rt=rt, **flags)
    assert ref is not None
    got = FC.combine_step_fused(tblk, "cpu", **flags)
    assert got is not None
    compare_outputs(ref, got)


def test_gates_route_to_the_general_path():
    """Blocks past the kernel's limits (m > 16, ploidy > 6, mixed ploidy
    without GT lengths) take the general combine_step and are counted."""
    jblk, blk = make_blocks(S=4, C=32, R=1024, seed=9, m=17)
    assert FC.combine_step_fused(blk, "cpu", max_merged=17,
                                 ploidy=2) is None
    before = FC.combine_block.general_path_blocks
    got = FC.combine_block(blk, "cpu", max_merged=17, ploidy=2)
    assert FC.combine_block.general_path_blocks == before + 1
    compare_outputs(JC.combine_step(*JC.block_to_args(jblk), max_merged=17,
                                    ploidy=2), got)
    mixed = make_block(S=4, C=32, R=1024, seed=9)
    assert FC.combine_step_fused(mixed, "cpu", max_merged=4, ploidy=2,
                                 mixed_ploidy=True) is None
    heptaploid = make_block(S=3, C=16, R=512, seed=9, ploidy=7)
    assert FC.combine_step_fused(heptaploid, "cpu", max_merged=4,
                                 ploidy=7) is None


def test_synthesize_cohort_matches_jax():
    for kw in (dict(seed=0), dict(seed=3, max_merged=16, ploidy=3)):
        a = CB.synthesize_cohort(6, 40, 2048, **kw)
        b = JC.synthesize_cohort(6, 40, 2048, **kw)
        for name in ("col", "end", "pl", "pl_len", "ad", "ad_len", "gt",
                     "gq", "dp", "min_dp", "dp_info", "info_f", "info_i",
                     "info_fs", "inv_bs", "nr_bs", "starts",
                     "rec_num_merged", "live"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype and x.shape == y.shape, name
            np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8),
                                          err_msg=name)


def test_cpu_tensors_never_launch_the_kernel():
    blk = make_block(S=4, C=32, R=1024, seed=4)
    before = FC.fused_gather_remap.launches
    out = FC.combine_block(blk, "cpu", max_merged=4, ploidy=2)
    assert out["pl"].device.type == "cpu"
    assert FC.fused_gather_remap.launches == before


def test_wrapper_refuses_other_devices():
    t = TC.block_to_tensors(make_block(S=3, C=16, R=512, seed=2), "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        FC.fused_gather_remap(*t[:12], t[16], t[12], t[13], t[14], t[15],
                              max_merged=4, ploidy=2)


def test_resolve_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
