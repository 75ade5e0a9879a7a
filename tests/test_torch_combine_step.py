"""The port's general combine_step against genomicsdb_tpu's combine_step
on synthetic cohort blocks: each package builds its own block from the
same seed, and the outputs are compared exactly (keys, dtypes,
integers, float bits)."""

import numpy as np
import pytest

from genomicsdb_tpu.ops import combine_step as JC
from genomicsdb_tpu_torch.ops import cell_block as CB
from genomicsdb_tpu_torch.ops import combine_step as TC


def compare_outputs(ref, got):
    """Exact comparison of a JAX output dict with a torch one."""
    assert set(ref) == set(got), set(ref) ^ set(got)
    for key in sorted(ref):
        a = np.asarray(ref[key])
        b = got[key].cpu().numpy()
        assert a.dtype == b.dtype, (key, a.dtype, b.dtype)
        assert a.shape == b.shape, (key, a.shape, b.shape)
        if a.dtype.kind == "f":
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=key)


def make_block(S, C, R, seed, m=4, ploidy=2, mixed=False, phased=False,
               drop=0.05, del_rw=0.2, pkg=CB):
    """A synthetic block built by `pkg` (the port's `cell_block`, or the
    JAX package's `combine_step`), with some (record, sample) cells that
    have no live call (LUTs -1, as the store path writes them),
    spanning-deletion-rewritten calls, and optionally per-call ploidy
    over a phased GT layout.  Both packages give the same arrays for
    the same arguments."""
    blk = pkg.synthesize_cohort(S, C, R, seed=seed, max_merged=m,
                                ploidy=ploidy)
    rng = np.random.default_rng(seed + 1)
    B, S = blk.live.shape
    gone = rng.random((B, S)) < drop
    blk.live = np.where(gone, -1, blk.live).astype(np.int32)
    blk.inv_bs = np.where(gone[..., None], -1, blk.inv_bs).astype(np.int32)
    blk.nr_bs = np.where(gone, -1, blk.nr_bs).astype(np.int32)
    blk.del_rw = (rng.random((B, S)) < del_rw) & ~gone
    blk.rec_has_nr = rng.random(B) < 0.8
    if phased:
        gt = np.zeros((S, blk.col.shape[1], 2 * ploidy - 1), np.int32)
        gt[..., 0::2] = blk.gt
        gt[..., 1::2] = rng.integers(0, 2, gt[..., 1::2].shape)
        blk.gt = gt
    if mixed:
        blk.gt_len_bs = np.where(
            gone, 0, rng.integers(0, blk.gt.shape[2] + 1, (B, S))
        ).astype(np.int32)
    return blk


def make_blocks(**kw):
    """(the JAX package's block, the port's block) of `make_block`."""
    return make_block(pkg=JC, **kw), make_block(pkg=CB, **kw)


CASES = {
    "diploid": dict(S=8, C=64, R=4096, seed=21),
    "odd_sizes": dict(S=5, C=40, R=3000, seed=7),
    "ploidy6": dict(S=4, C=48, R=4096, seed=11, ploidy=6),
    "wide_alleles_m20": dict(S=5, C=40, R=2048, seed=3, m=20),
    "mixed_pmax3": dict(S=4, C=48, R=4096, seed=13, ploidy=3, mixed=True),
    "mixed_phased_pmax3": dict(S=4, C=48, R=4096, seed=17, ploidy=3,
                               mixed=True, phased=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_combine_step_matches_jax(case):
    kw = dict(CASES[case])
    jblk, tblk = make_blocks(**kw)
    m, p = kw.get("m", 4), kw.get("ploidy", 2)
    flags = dict(max_merged=m, ploidy=p, gt_phase=kw.get("phased", False),
                 mixed_ploidy=kw.get("mixed", False))
    ref = JC.combine_step(*JC.block_to_args(jblk), **flags)
    got = TC.combine_step(*TC.block_to_tensors(tblk, "cpu"), **flags)
    compare_outputs(ref, got)


def test_block_to_tensors_takes_either_block():
    """A block built by the port and one built by the JAX package from
    the same seed give the same arrays: the port's tensors equal the JAX
    package's block_to_args, dtype for dtype and byte for byte."""
    jblk, tblk = make_blocks(S=4, C=32, R=1024, seed=2, mixed=True)
    a = JC.block_to_args(jblk)
    b = TC.block_to_tensors(tblk, "cpu")
    assert len(a) == len(b) == 19
    for x, y in zip(a, b):
        x, y = np.asarray(x), y.numpy()
        assert x.dtype == y.dtype and x.shape == y.shape
        assert (x.reshape(-1).view(np.uint8)
                == y.reshape(-1).view(np.uint8)).all()


def test_remap_genotype_np_copy_matches_block_fields():
    """The port's copy of the extras-path G-length remap (its
    query/block_fields, with the genotype tables of ops/cell_block)
    equals genomicsdb_tpu.query.block_fields.remap_genotype_np."""
    from genomicsdb_tpu.query.block_fields import remap_genotype_np
    from genomicsdb_tpu_torch.query import block_fields as TSB
    rng = np.random.default_rng(11)
    B, S, K, M = 6, 5, 15, 5
    vals = rng.integers(0, 900, (B, S, K)).astype(np.int32)
    lens = rng.integers(0, K + 1, (B, S))
    inv = rng.integers(-1, 4, (B, S, M)).astype(np.int32)
    nr = rng.integers(-1, 4, (B, S)).astype(np.int32)
    rec_nm = rng.integers(1, M + 1, B).astype(np.int32)
    ploidy = rng.integers(0, 4, (B, S))
    ref = remap_genotype_np(vals, lens, inv, nr, rec_nm, ploidy, -1)
    got = TSB.remap_genotype_np(vals, lens, inv, nr, rec_nm, ploidy, -1)
    for a, b in zip(ref, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
