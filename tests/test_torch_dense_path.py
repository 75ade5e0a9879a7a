"""The port's dense path against genomicsdb_tpu's: the host live-cell
gather (`gather_block_host`), the dense step on pre-gathered inputs
(`combine_step_dense`), and, on a store's block, the JAX writer's
`GENOMICSDB_TPU_DENSE=1` branch (the port's writer has none: its text
must equal that branch's).  Each package builds its own block from the
same seed, or loads the store from the same files; outputs are compared
exactly (integers equal, floats as int32 bits)."""

import contextlib
import io

import numpy as np
import pytest
import torch

from genomicsdb_tpu.ops import combine_step as JC
from genomicsdb_tpu.tools import gdb_query as jax_gdb_query
from genomicsdb_tpu_torch.ops import combine_step as TC
from genomicsdb_tpu_torch.ops.store_block import store_to_block
from genomicsdb_tpu_torch.query import block_writer as BW
from genomicsdb_tpu_torch.query.driver import make_query_config
from genomicsdb_tpu_torch.testing import write_cohort
from genomicsdb_tpu_torch.tools import gdb_query as torch_gdb_query
from genomicsdb_tpu_torch.tools import vcf2gdb

from test_torch_combine_step import compare_outputs, make_blocks

# the dense step's cases: diploid at m 4 (the bench shape's setting) and
# per-call (mixed) phased ploidy
CASES = {
    "diploid_m4": dict(S=8, C=64, R=4096, seed=21),
    "mixed_phased_pmax3": dict(S=4, C=48, R=4096, seed=17, ploidy=3,
                               mixed=True, phased=True),
}


def _flags(kw):
    return dict(max_merged=kw.get("m", 4), ploidy=kw.get("ploidy", 2),
                gt_phase=kw.get("phased", False),
                mixed_ploidy=kw.get("mixed", False))


@pytest.mark.parametrize("case", sorted(CASES))
def test_gather_block_host_matches_jax(case):
    jblk, tblk = make_blocks(**CASES[case])
    ref = JC.gather_block_host(jblk, jblk.live)
    got = TC.gather_block_host(tblk, tblk.live)
    assert set(ref) == set(got) == set(TC.DENSE_KEYS)
    for k in ref:
        a, b = np.asarray(ref[k]), got[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype.kind == "f":
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_combine_step_dense_matches_jax(case):
    kw = CASES[case]
    jblk, tblk = make_blocks(**kw)
    flags = _flags(kw)
    g = JC.gather_block_host(jblk, jblk.live)
    ref = JC.combine_step_dense(*(g[k] for k in TC.DENSE_KEYS),
                                jblk.rec_num_merged, jblk.rec_has_nr,
                                jblk.gt_len_bs, **flags)
    t = TC.gather_block_host(tblk, tblk.live)
    gt_lens = None if tblk.gt_len_bs is None \
        else torch.from_numpy(tblk.gt_len_bs)
    got = TC.combine_step_dense(*TC.dense_tensors(t, "cpu"),
                                torch.from_numpy(tblk.rec_num_merged),
                                torch.from_numpy(tblk.rec_has_nr), gt_lens,
                                **flags)
    compare_outputs(ref, got)
    # and the dense step equals the general step on the same block
    gen = TC.combine_step(*TC.block_to_tensors(tblk, "cpu"), **flags)
    compare_outputs({k: v.numpy() for k, v in gen.items() if k != "live"},
                    got)


def _run(main, argv, **kw) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv, **kw)
    return buf.getvalue()


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    c = write_cohort(str(tmp_path_factory.mktemp("dense")), 10, 120, seed=9,
                     n_groups=2)
    vcf2gdb.main([c.loader])
    return c


@pytest.mark.parametrize("pack", [False, True])
def test_dense_writer_text(cohort, monkeypatch, pack):
    """The dense step on the store's whole block equals the general step
    (at the writer's flags), and the port's writer text (pack off and
    on) equals the JAX block engine's with `GENOMICSDB_TPU_DENSE=1`."""
    argv = ["-j", cohort.query, "--produce-Broad-GVCF"]
    args = torch_gdb_query._build_parser().parse_args(argv)
    _, qp, vid, store = torch_gdb_query.load_context(args, 0)
    blk, meta = store_to_block(store, make_query_config(qp, vid),
                               interval=(0, cohort.region), max_merged=4,
                               return_meta=True)
    flags = dict(max_merged=blk.inv_bs.shape[2], ploidy=blk.ploidy,
                 gt_phase=meta.plan.gt_phase, mixed_ploidy=False)
    has_nr = blk.rec_has_nr if blk.rec_has_nr is not None \
        else np.ones(len(blk.rec_num_merged), dtype=bool)
    got = TC.combine_step_dense(
        *TC.dense_tensors(TC.gather_block_host(blk, blk.live), "cpu"),
        torch.from_numpy(blk.rec_num_merged), torch.from_numpy(has_nr),
        None, **flags)
    gen = TC.combine_step(*TC.block_to_tensors(blk, "cpu"), **flags)
    assert got["pl"].shape[0] == blk.live.shape[0] > 50
    compare_outputs({k: v.numpy() for k, v in gen.items() if k != "live"},
                    got)

    monkeypatch.setenv("GENOMICSDB_TPU_SERVING_INDEX", "0")
    BW.render_block_vcf_pipelined.split_blocks = 0
    text = _run(torch_gdb_query.main, argv + ["--device", "cpu"], pack=pack)
    assert (BW.render_block_vcf_pipelined.split_blocks > 0) == pack
    monkeypatch.setenv("GENOMICSDB_TPU_DENSE", "1")
    jax_dense = _run(jax_gdb_query.main, argv + ["--engine", "block"])
    assert len(text.splitlines()) > 100
    assert text == jax_dense
