"""The port's device->host fetch pack (genomicsdb_tpu_torch.ops.
combine_step: pack_outputs, fetch_outputs, fetch_outputs_split,
host_identity_outputs) against genomicsdb_tpu's: the same outputs give
the same blob, byte for byte, and the same host arrays; narrowing is
lossless, an overflow refetches the whole tensor, and the variant-row
split plus the host identity rebuild equals the full fetch.  Mirrors
tests/test_output_packing.py, tests/test_identity_native.py and
tests/test_pallas_combine.py:154-171; exact comparison throughout."""

import numpy as np
import pytest
import torch

from genomicsdb_tpu.core import formats
from genomicsdb_tpu.ops import combine_step as JC
from genomicsdb_tpu.ops import pallas_combine as PC
from genomicsdb_tpu.runtime import native_loader as jax_native_loader
from genomicsdb_tpu_torch.ops import cell_block as CB
from genomicsdb_tpu_torch.ops import combine_step as TC
from genomicsdb_tpu_torch.ops import fused_combine as FC
from genomicsdb_tpu_torch.ops.store_block import store_to_block
from genomicsdb_tpu_torch.query.driver import make_query_config
from genomicsdb_tpu_torch.runtime import native_loader
from genomicsdb_tpu_torch.testing import write_cohort
from genomicsdb_tpu_torch.tools import gdb_query as torch_gdb_query
from genomicsdb_tpu_torch.tools import vcf2gdb

MISS, EOV = formats.INT_MISSING, formats.INT_VECTOR_END


def _same_blob(jax_packed, torch_packed):
    assert torch_packed["__layout__"] == jax_packed["__layout__"]
    np.testing.assert_array_equal(torch_packed["__blob__"].numpy(),
                                  np.asarray(jax_packed["__blob__"]))


def test_pack_roundtrip_lossless():
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    pl = rng.integers(-30000, 30000, size=(7, 5, 10)).astype(np.int32)
    pl[0, 0, 0] = MISS
    pl[1, 2, 3] = EOV
    gt = rng.integers(-1, 51, size=(7, 5, 3)).astype(np.int32)
    gt[2, 1, 1] = MISS
    out = {"pl": torch.from_numpy(pl), "gt": torch.from_numpy(gt)}
    packed = TC.pack_outputs(out)
    parts = TC._unpack_blob(packed["__blob__"].numpy(),
                            packed["__layout__"])
    assert bool(parts["fits::pl"][0]) and bool(parts["fits::gt"][0])
    assert parts["data::pl"].dtype == np.int16
    assert parts["data::gt"].dtype == np.int8
    _same_blob(JC.pack_outputs({"pl": jnp.asarray(pl),
                                "gt": jnp.asarray(gt)}), packed)
    dev = TC.fetch_outputs(out, packed)
    np.testing.assert_array_equal(dev["pl"], pl)
    np.testing.assert_array_equal(dev["gt"], gt)


def test_pack_overflow_falls_back_to_int32():
    pl = np.full((3, 2, 4), 123, dtype=np.int32)
    pl[1, 1, 1] = 1_000_000          # beyond int16
    out = {"pl": torch.from_numpy(pl)}
    packed = TC.pack_outputs(out)
    parts = TC._unpack_blob(packed["__blob__"].numpy(),
                            packed["__layout__"])
    assert not bool(parts["fits::pl"][0])
    dev = TC.fetch_outputs(out, packed)
    assert dev["pl"].dtype == np.int32
    np.testing.assert_array_equal(dev["pl"], pl)


def test_gt_int16_to_int8_overflow_refetches_int16():
    """A kernel-narrowed GT whose values pass the int8 range reads
    fits=False: the fetch takes the whole int16 tensor and widens it
    with the BCF16 sentinels (never stale int32), in the full and in
    the split fetch, as the JAX fetch does."""
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    gt16 = rng.integers(-1, 4, size=(6, 3, 2)).astype(np.int16)
    gt16[0, 0, 0] = -32768
    gt16[1, 1, 1] = -32767
    gt16[4, 2, 0] = 120                  # fits int16, not int8
    pl16 = rng.integers(0, 900, size=(6, 3, 3)).astype(np.int16)
    live = np.zeros((6, 3), np.int32)
    want = gt16.astype(np.int32)
    want[gt16 == -32768] = MISS
    want[gt16 == -32767] = EOV
    out = {"gt": torch.from_numpy(gt16), "pl": torch.from_numpy(pl16)}
    packed = TC.pack_outputs(out)
    parts = TC._unpack_blob(packed["__blob__"].numpy(),
                            packed["__layout__"])
    assert not bool(parts["fits::gt"][0]) and bool(parts["fits::pl"][0])
    _same_blob(JC.pack_outputs({"gt": jnp.asarray(gt16),
                                "pl": jnp.asarray(pl16)}), packed)
    dev = TC.fetch_outputs(out, packed)
    np.testing.assert_array_equal(dev["gt"], want)
    ref = JC.fetch_outputs({"gt": jnp.asarray(gt16),
                            "pl": jnp.asarray(pl16)},
                           JC.pack_outputs({"gt": jnp.asarray(gt16),
                                            "pl": jnp.asarray(pl16)}))
    for k in ("gt", "pl"):
        np.testing.assert_array_equal(dev[k], ref[k])
    var = np.array([1, 4], np.int64)
    out["live"] = torch.from_numpy(live)
    split = TC.fetch_outputs_split(out, TC.pack_outputs(out, rows=var),
                                   var, np.array([0, 2, 3, 5]),
                                   (live >= 0).any(axis=1), 2,
                                   lambda dest, rows: None)
    np.testing.assert_array_equal(split["gt"], want)
    assert isinstance(split["pl"], TC.RecordStrided)
    np.testing.assert_array_equal(
        np.stack([split["pl"].row(b) for b in var]), pl16[var])


@pytest.mark.parametrize("mixed", [False, True])
def test_narrow_pack_fetch_roundtrip(mixed):
    """Blob pack/fetch of kernel-narrowed outputs reproduces the wide
    int32 outputs exactly (int16 pass-through, the int16->int8 GT
    re-narrow with VECTOR_END -> -127), and the blob equals the JAX
    package's for the same block."""
    blk = CB.synthesize_cohort(6, 48, 4096, seed=9)
    jblk = JC.synthesize_cohort(6, 48, 4096, seed=9)
    if mixed:
        B, S = blk.live.shape
        blk.gt_len_bs = np.random.default_rng(5).integers(
            1, 3, size=(B, S)).astype(np.int32)
        jblk.gt_len_bs = blk.gt_len_bs.copy()
    flags = dict(max_merged=4, ploidy=2, mixed_ploidy=mixed)
    wide = FC.combine_step_fused(blk, "cpu", **flags)
    out = FC.combine_step_fused(blk, "cpu", narrow_out=True, **flags)
    assert out["gt"].dtype == torch.int16
    packed = TC.pack_outputs(out)
    parts = TC._unpack_blob(packed["__blob__"].numpy(),
                            packed["__layout__"])
    if mixed:
        assert (parts["data::gt"] == -127).any()
    got = TC.fetch_outputs({k: v for k, v in out.items() if k != "live"},
                           packed)
    for k, v in wide.items():
        if k == "live":
            continue
        a = v.numpy()
        b = got[k]
        assert a.dtype == b.dtype, k
        if a.dtype.kind == "f":
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=k)
    ref = PC.combine_step_fused(jblk, interpret=True, narrow_out=True,
                                **flags)
    rows = np.arange(0, blk.live.shape[0], 3)
    _same_blob(JC.pack_outputs(ref), packed)
    _same_blob(JC.pack_outputs(ref, rows=rows),
               TC.pack_outputs(out, rows=rows))


#: the cohorts of the split-fetch tests: write_cohort options and the
#: block's starting LUT width (7 merged alleles: the tetraploid bench
#: cell's 210 PL slots a call)
COHORTS = {
    "diploid": (dict(), 4),
    "tetraploid": (dict(ploidy=4), 7),
    "mixed_ploidy": (dict(triploid_every=3, haploid_stretch=True), 4),
    "phased": (dict(phased_share=0.4), 4),
}


@pytest.fixture(scope="module")
def store_blocks(tmp_path_factory):
    """The port's CellBlock and meta of each of COHORTS (built once)."""
    got = {}

    def block(kind):
        if kind not in got:
            opts, max_merged = COHORTS[kind]
            c = write_cohort(str(tmp_path_factory.mktemp(kind)), 12, 120,
                             seed=3, n_groups=3, **opts)
            vcf2gdb.main([c.loader])
            args = torch_gdb_query._build_parser().parse_args(
                ["-j", c.query, "--produce-Broad-GVCF"])
            _, qp, vid, store = torch_gdb_query.load_context(args, 0)
            qc = make_query_config(qp, vid)
            got[kind] = store_to_block(store, qc, interval=(0, c.region),
                                       max_merged=max_merged,
                                       return_meta=True)
        return got[kind]
    return block


def _split_and_full(blk, meta):
    """(the whole fetch of the wide outputs, the split fetch of the
    narrow ones, its host_output_bytes count) of one block."""
    from genomicsdb_tpu_torch.core import profile
    from genomicsdb_tpu_torch.query.block_writer import _block_flags
    ploidy, max_merged, mixed = _block_flags(blk)
    flags = dict(max_merged=max_merged, ploidy=ploidy,
                 gt_phase=meta.plan.gt_phase, mixed_ploidy=mixed)
    full = TC.fetch_outputs(FC.combine_block(blk, "cpu", **flags))
    out = FC.combine_block(blk, "cpu", narrow_out=True, **flags)
    assert out["pl"].dtype == torch.int16
    var_rows = np.nonzero(~meta.is_ref_block_only)[0]
    ref_rows = np.nonzero(meta.is_ref_block_only)[0]
    assert len(ref_rows) > 10 and len(var_rows) > 3
    packed = TC.pack_outputs(out, rows=var_rows)
    n0 = profile.COUNTS.host_output_bytes
    dev = TC.fetch_outputs_split(
        out, packed, var_rows, ref_rows, (blk.live >= 0).any(axis=1),
        blk.ploidy,
        lambda dest, rows: TC.identity_fill(blk, dest, rows,
                                            meta.plan.gt_phase, mixed))
    return full, dev, profile.COUNTS.host_output_bytes - n0


@pytest.mark.parametrize("cohort", sorted(COHORTS))
@pytest.mark.parametrize("fill", ["native", "numpy"])
def test_split_fetch_matches_full_fetch(store_blocks, cohort, fill,
                                        monkeypatch):
    """Variant-row-only fetch of the narrow outputs + host identity
    rebuild, each record at its own width, equals the full fetch of the
    wide outputs at every live cell and every slot below the record's
    width (ref rows are identity remaps; other cells are never read);
    the full fetch's slots past a ref row's width hold only filler
    (MISSING / VECTOR_END), which no renderer reads; rows without a
    live cell take width 0; the [B, S] columns and the reductions are
    equal everywhere.  With the native widen and identity fill, and
    with the numpy forms that run without the native library."""
    if fill == "numpy":
        monkeypatch.setattr(native_loader, "widen_scatter",
                            lambda *a, **k: None)
        monkeypatch.setattr(native_loader, "identity_outputs",
                            lambda *a, **k: None)
    elif native_loader.get_lib() is None:
        pytest.skip("native library unavailable")
    blk, meta = store_blocks(cohort)
    full, dev, _ = _split_and_full(blk, meta)
    live_ok = blk.live >= 0
    emitted = live_ok.any(axis=1)
    ref = meta.is_ref_block_only
    for k in ("pl", "ad", "gt"):
        f = dev[k]
        assert isinstance(f, TC.RecordStrided), k
        W = full[k].shape[2]
        np.testing.assert_array_equal(f.w[~emitted], 0, err_msg=k)
        np.testing.assert_array_equal(f.w[emitted & ~ref], W, err_msg=k)
        assert (f.w[emitted & ref] <= W).all()
        for b in np.nonzero(emitted)[0]:
            w = int(f.w[b])
            s_ok = live_ok[b]
            np.testing.assert_array_equal(
                full[k][b, s_ok, :w], f.row(b)[s_ok],
                err_msg=f"{cohort} {k} record {b}")
            past = full[k][b, s_ok, w:]
            assert np.isin(past, (MISS, EOV)).all(), (k, b)
    if cohort == "mixed_ploidy":
        assert (blk.gt_len_bs[live_ok] != blk.gt.shape[2]).any()
    for k in full:
        if k in ("pl", "ad", "gt", "live"):
            continue
        a, b = full[k], dev[k]
        if a.dtype.kind == "f":
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_split_fetch_host_outputs_are_small(store_blocks):
    """On the tetraploid block at 7 merged alleles (210 PL slots a call)
    the split fetch's host outputs take at most a fifth of a dense
    [B, S, G_out] int32 PL array: no array of that size is made for the
    reference rows.  The counter host_output_bytes equals the returned
    outputs' bytes."""
    blk, meta = store_blocks("tetraploid")
    full, dev, counted = _split_and_full(blk, meta)
    B, S, G_out = full["pl"].shape
    assert G_out == 210
    got = sum(v.nbytes for v in dev.values())
    assert counted == got
    assert got <= B * S * G_out * 4 / 5, (got, B * S * G_out * 4)
    assert dev["pl"].vals.size < B * S * G_out / 5


def test_host_identity_outputs_numpy_matches_native(monkeypatch):
    """The port's copy of host_identity_outputs: its numpy form equals
    the port's native identity_outputs, and the JAX package's numpy
    form equals both, over mixed / phased / ploidy / width draws
    (tests/test_identity_native.py)."""
    if native_loader.get_lib() is None:
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(7)
    for trial in range(24):
        S = int(rng.integers(1, 12))
        C = int(rng.integers(1, 40))
        B = int(rng.integers(0, 50))
        mixed = bool(rng.integers(0, 2))
        phase = bool(rng.integers(0, 2))
        ploidy = int(rng.integers(1, 4))
        wgt = 2 * ploidy - 1 if phase else ploidy

        class Blk:
            pass

        blk = Blk()
        blk.live = rng.integers(-1, C, size=(B, S)).astype(np.int32)
        blk.col = np.zeros((S, C), np.int64)
        blk.pl = rng.integers(-2**31, 500, size=(
            S, C, int(rng.integers(1, 12)))).astype(np.int32)
        blk.pl_len = rng.integers(
            0, blk.pl.shape[2] + 1, size=(S, C)).astype(np.int32)
        blk.ad = rng.integers(-5, 50, size=(
            S, C, int(rng.integers(1, 6)))).astype(np.int32)
        blk.ad_len = rng.integers(
            0, blk.ad.shape[2] + 1, size=(S, C)).astype(np.int32)
        blk.gt = rng.integers(-1, 4, size=(S, C, wgt)).astype(np.int32)
        blk.gt[rng.random((S, C, wgt)) < .1] = MISS
        blk.gq = rng.integers(-2**31, 99, size=(S, C)).astype(np.int32)
        blk.dp = rng.integers(0, 99, size=(S, C)).astype(np.int32)
        blk.min_dp = rng.integers(0, 99, size=(S, C)).astype(np.int32)
        blk.gt_len_bs = rng.integers(
            0, wgt + 1, size=(B, S)).astype(np.int32) if mixed else None
        blk.ploidy = ploidy
        rows = np.arange(B)
        widths = (int(rng.integers(1, 12)), int(rng.integers(2, 6)), wgt)
        nat = TC.host_identity_outputs(blk, rows, widths, phase, mixed)
        with monkeypatch.context() as m:
            for loader in (native_loader, jax_native_loader):
                m.setattr(loader, "identity_outputs", lambda *a, **k: None)
            ref = TC.host_identity_outputs(blk, rows, widths, phase, mixed)
            jax_np = JC.host_identity_outputs(blk, rows, widths, phase,
                                              mixed)
        for k in ref:
            np.testing.assert_array_equal(ref[k], nat[k],
                                          err_msg=f"{trial} {k}")
            np.testing.assert_array_equal(ref[k], jax_np[k],
                                          err_msg=f"{trial} {k}")
