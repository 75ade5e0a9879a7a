"""A chunk's records x samples grid built in one native pass
(`native_loader.block_grid` and `lut_fill`, called by
`ops/store_block._store_to_block`) against the numpy fallback that runs
without the native library, and against the JAX package's
`store_to_block`: every `CellBlock` array and every `BlockRecordMeta`
field equal in dtype, shape and value, the LUT width included, and
`gdb_query`'s text byte for byte on both paths.  Cohorts: spanning
deletions (rewritten calls and GT overrides), tetraploid, a haploid
stretch with phased GT, high PL with triploid samples and hotspots (the
LUT grown past 8, and under a tight PL budget records past the cap that
keep the width of their turn), a padded block, an interval with no live
cell, and one sample."""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest

from genomicsdb_tpu_torch.core import profile
from genomicsdb_tpu_torch.core.config import QueryParams
from genomicsdb_tpu_torch.core.vid import VidMapper
from genomicsdb_tpu_torch.ops import store_block as SB
from genomicsdb_tpu_torch.query.driver import make_query_config
from genomicsdb_tpu_torch.runtime import native_loader
from genomicsdb_tpu_torch.store import workspace as ws
from genomicsdb_tpu_torch.testing import write_cohort
from genomicsdb_tpu_torch.tools import gdb_query, vcf2gdb

# name: (write_cohort arguments, store_to_block arguments, interval,
#        PL-tensor budget or None, query keys over the cohort's query)
CASES = {
    "deletions": (dict(n_samples=16, n_records=160, seed=11), {}, None,
                  None, {"produce_GT_field": True}),
    "tetraploid": (dict(n_samples=12, n_records=120, seed=12, ploidy=4),
                   {}, None, None, {}),
    "haploid_phased": (dict(n_samples=14, n_records=150, seed=13,
                            haploid_stretch=True, phased_share=0.3),
                       {}, None, None, {}),
    "high_pl_grown": (dict(n_samples=24, n_records=200, seed=7, n_groups=3,
                           hotspots=4, high_pl=0.05, triploid_every=7),
                      dict(max_merged=4), None, None, {}),
    "high_pl_overflow": (dict(n_samples=24, n_records=200, seed=7,
                              n_groups=3, hotspots=4, high_pl=0.05,
                              triploid_every=7),
                         dict(max_merged=2), None, 1 << 17, {}),
    "padded": (dict(n_samples=10, n_records=100, seed=14),
               dict(pad_records=512, pad_cells_to=256), None, None, {}),
    "no_live_cell": (dict(n_samples=10, n_records=100, seed=15),
                     dict(pad_records=64), "past", None, {}),
    "one_sample": (dict(n_samples=1, n_records=120, seed=16), {}, None,
                   None, {}),
}


@pytest.fixture(scope="module")
def cohorts(tmp_path_factory):
    made = {}

    def get(name):
        kw = CASES[name][0]
        key = tuple(sorted(kw.items()))
        if key not in made:
            c = write_cohort(str(tmp_path_factory.mktemp("grid")), **kw)
            with contextlib.redirect_stdout(io.StringIO()):
                vcf2gdb.main([c.loader])
            made[key] = c
        return made[key]
    return get


def _query(c, keys) -> str:
    """The cohort's query file, or a copy with `keys` set."""
    if not keys:
        return c.query
    with open(c.query) as f:
        doc = json.load(f)
    doc.update(keys)
    path = c.query[:-len(".json")] + "_" + "_".join(sorted(keys)) + ".json"
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def _interval(c, where):
    return (c.region + 10, c.region + 500) if where == "past" \
        else (0, c.region)


def _torch_block(c, query, kw, interval, budget, monkeypatch):
    if budget is not None:
        monkeypatch.setattr(SB, "PL_TENSOR_BUDGET", budget)
    store = ws.open_array(c.workspace, c.array)
    qc = make_query_config(QueryParams.from_file(query, 0),
                           VidMapper.from_files(c.vid, c.callsets))
    return SB.store_to_block(store, qc, interval=interval,
                             return_meta=True, **kw)


def _jax_block(c, query, kw, interval, budget, monkeypatch):
    from genomicsdb_tpu.core.config import QueryParams as JQP
    from genomicsdb_tpu.core.vid import VidMapper as JVid
    from genomicsdb_tpu.ops import store_block as JSB
    from genomicsdb_tpu.query.driver import make_query_config as jmqc
    from genomicsdb_tpu.store import workspace as jws
    if budget is not None:
        monkeypatch.setattr(JSB, "PL_TENSOR_BUDGET", budget)
    store = jws.open_array(c.workspace, c.array)
    qc = jmqc(JQP.from_file(query, 0), JVid.from_files(c.vid, c.callsets))
    return JSB.store_to_block(store, qc, interval=interval,
                              return_meta=True, **kw)


def _equal(x, y, path):
    if isinstance(x, np.ndarray):
        assert isinstance(y, np.ndarray), path
        assert (x.dtype, x.shape) == (y.dtype, y.shape), path
        if x.dtype == object:
            assert list(x) == list(y), path
        elif x.dtype.kind == "f":       # NaN payloads compare as bits
            assert np.array_equal(x.view(f"i{x.itemsize}"),
                                  y.view(f"i{y.itemsize}")), path
        else:
            assert np.array_equal(x, y), path
    elif isinstance(x, dict):
        assert x.keys() == y.keys(), path
        for k in x:
            _equal(x[k], y[k], f"{path}[{k!r}]")
    elif isinstance(x, (list, tuple)):
        assert len(x) == len(y), path
        for i, (a, b) in enumerate(zip(x, y)):
            _equal(a, b, f"{path}[{i}]")
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        assert type(x).__name__ == type(y).__name__, path
        for f in dataclasses.fields(x):
            _equal(getattr(x, f.name), getattr(y, f.name),
                   f"{path}.{f.name}")
    else:
        assert x == y, (path, x, y)


def _compare_blocks(got, want, skip=()):
    (bg, mg), (bw, mw) = got, want
    # the block's store tables take no part in its equality
    for f in dataclasses.fields(bw):
        if f.compare:
            _equal(getattr(bg, f.name), getattr(bw, f.name),
                   f"blk.{f.name}")
    for f in dataclasses.fields(mw):
        if f.name not in skip:
            _equal(getattr(mg, f.name), getattr(mw, f.name),
                   f"meta.{f.name}")


def _text(query, monkeypatch) -> str:
    monkeypatch.setenv("GENOMICSDB_TPU_SERVING_INDEX", "0")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        gdb_query.main(["-j", query, "--produce-Broad-GVCF", "--engine",
                        "block", "--device", "cpu"])
    return buf.getvalue()


@pytest.mark.parametrize("case", list(CASES))
def test_native_grid_equals_numpy_fallback_and_jax(case, cohorts,
                                                   monkeypatch):
    assert native_loader.get_lib() is not None
    _, kw, where, budget, keys = CASES[case]
    c = cohorts(case)
    query = _query(c, keys)
    iv = _interval(c, where)
    n0 = profile.COUNTS.block_grid_native
    native = _torch_block(c, query, kw, iv, budget, monkeypatch)
    assert profile.COUNTS.block_grid_native == n0 + 1
    text_native = _text(query, monkeypatch)
    with monkeypatch.context() as m:
        m.setattr(native_loader, "block_grid", lambda *a, **k: None)
        f0 = profile.COUNTS.block_grid_numpy
        fallback = _torch_block(c, query, kw, iv, budget, m)
        assert profile.COUNTS.block_grid_numpy == f0 + 1
        text_numpy = _text(query, m)
    _compare_blocks(native, fallback, skip=("plan",))
    assert text_native == text_numpy
    assert text_native.count("\n") > 10
    # the JAX package's build (the LUT grown with np.pad as each record
    # merges) is the reference for the widths and LUT columns
    _compare_blocks(native,
                    _jax_block(c, query, kw, iv, budget, monkeypatch),
                    skip=("plan", "extras"))
    blk, meta = native
    B, S = blk.live.shape
    assert S == c.n_samples and B == len(blk.starts)
    W = blk.inv_bs.shape[2]
    nm = np.array([len(a) + 1 for a in meta.alts])
    if case == "high_pl_grown":
        assert W > 8 and (blk.rec_num_merged > 8).any()
    if case == "high_pl_overflow":
        # a record past the cap merged while the LUTs were narrower than
        # the block's final width, and keeps that width
        over = nm > blk.rec_num_merged
        assert over.any() and meta.needs_fallback[over].all()
        assert (blk.rec_num_merged[over] < W).any()
    if case == "deletions":
        assert blk.del_rw.any() and meta.gt_override
    if case == "no_live_cell":
        assert (blk.live < 0).all() and meta.is_ref_block_only.all()
    if case == "padded":
        assert B == 512 and (blk.live[-1] < 0).all()


@pytest.mark.parametrize("forced_off", [False, True])
def test_each_block_counts_its_grid_path_and_spans_nest(cohorts,
                                                        monkeypatch,
                                                        forced_off):
    """A chunked query counts `block_grid_native` once a block (or
    `block_grid_numpy` with the pass forced off), and with tracing on
    each `block.build` holds two `block.grid` spans (the pass, the LUT
    fill) and one `block.merge`, none holding a store-wide rebuild."""
    import functools

    from genomicsdb_tpu_torch.query import driver
    from genomicsdb_tpu_torch.query.block_writer import \
        render_block_vcf_pipelined as RB
    c = cohorts("deletions")
    monkeypatch.setattr(driver, "run_vcf_query_block", functools.partial(
        driver.run_vcf_query_block, max_records_per_block=40))
    if forced_off:
        monkeypatch.setattr(native_loader, "block_grid",
                            lambda *a, **k: None)
    monkeypatch.setattr(profile, "ENABLED", True)
    profile.clear()
    built = RB.blocks_built
    n0, f0 = profile.COUNTS.block_grid_native, profile.COUNTS.block_grid_numpy
    try:
        text = _text(c.query, monkeypatch)
        recs = profile.spans()
    finally:
        profile.clear()
    blocks = RB.blocks_built - built
    assert blocks >= 4 and text.count("\n") > 10
    ran, idle = (profile.COUNTS.block_grid_numpy - f0,
                 profile.COUNTS.block_grid_native - n0)
    if not forced_off:
        ran, idle = idle, ran
    assert (ran, idle) == (blocks, 0)
    root = next(s for s in recs if s.parent_id is None)
    assert root.counts["block_grid_numpy" if forced_off
                       else "block_grid_native"] == blocks
    by_id = {s.id: s for s in recs}
    names = [s.name for s in recs]
    assert names.count("block.grid") == 2 * blocks
    assert names.count("block.merge") == blocks
    for s in recs:
        if s.name in ("block.grid", "block.merge"):
            assert by_id[s.parent_id].name == "block.build"
        if s.name.startswith("rebuild."):
            assert by_id[s.parent_id].name not in ("block.grid",
                                                   "block.merge")
