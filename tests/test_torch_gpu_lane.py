"""The port on an NVIDIA card: the CUDA kernel in its wide and narrow
forms against its plain twin (bit-exact, cells with no live call
included), and block queries on the card, with the fetch pack on and
off, against the same query on the CPU.

Marked `gpu`; each test skips where torch sees no CUDA card (decided in
the `cuda` fixture, never at import).  On a machine with a card:

    python -m pytest -m gpu tests/test_torch_gpu_lane.py
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from genomicsdb_tpu_torch.ops import combine_step as TC
from genomicsdb_tpu_torch.ops import fused_combine as FC
from genomicsdb_tpu_torch.ops.cell_block import synthesize_cohort

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible to torch")
    return torch.device("cuda:0")


def _block(S, C, R, m, p, mixed, seed):
    blk = synthesize_cohort(S, C, R, seed=seed, max_merged=m, ploidy=p)
    rng = np.random.default_rng(seed + 1)
    B, S = blk.live.shape
    gone = rng.random((B, S)) < 0.05
    blk.live = np.where(gone, -1, blk.live).astype(np.int32)
    blk.inv_bs = np.where(gone[..., None], -1, blk.inv_bs).astype(np.int32)
    blk.nr_bs = np.where(gone, -1, blk.nr_bs).astype(np.int32)
    blk.rec_has_nr = rng.random(B) < 0.8
    if mixed:
        gt = np.zeros((S, blk.col.shape[1], 2 * p - 1), np.int32)
        gt[..., 0::2] = blk.gt
        gt[..., 1::2] = rng.integers(0, 2, gt[..., 1::2].shape)
        blk.gt = gt
        blk.gt_len_bs = np.where(gone, 0, rng.integers(0, 2 * p, (B, S))
                                 ).astype(np.int32)
    return blk


SHAPES = [(64, 256, 16384, 4, 2, False), (16, 64, 4096, 16, 2, False),
          (8, 64, 4096, 4, 6, False), (16, 64, 4096, 16, 3, True),
          (8, 48, 4096, 4, 6, True)]


def _check_kernel(cuda, S, C, R, m, p, mixed, **mode):
    blk = _block(S, C, R, m, p, mixed, seed=S + m + p)
    t = TC.block_to_tensors(blk, cuda)
    args = (*t[:12], t[16], t[12], t[13], t[14], t[15],
            t[18] if mixed else None)
    kw = dict(max_merged=m, ploidy=p, gt_phase=mixed, mixed=mixed, **mode)
    before = (FC.fused_gather_remap.launches,
              FC.fused_gather_remap.narrow_launches)
    got = FC.fused_gather_remap(*args, **kw)
    torch.cuda.synchronize()
    narrow = int(mode.get("narrow", False))
    assert (FC.fused_gather_remap.launches,
            FC.fused_gather_remap.narrow_launches) == (before[0] + 1,
                                                        before[1] + narrow)
    ref = FC.fused_gather_remap_ref(*args, **kw)
    for key, r in ref.items():
        g = got[key]
        assert g.dtype == r.dtype and g.shape == r.shape, key
        if r.dtype == torch.float32:
            g, r = g.view(torch.int32), r.view(torch.int32)
        assert torch.equal(g, r), key


@pytest.mark.parametrize("S,C,R,m,p,mixed", SHAPES)
def test_kernel_matches_twin(cuda, S, C, R, m, p, mixed):
    _check_kernel(cuda, S, C, R, m, p, mixed)


@pytest.mark.parametrize("scalars", [True, False])
@pytest.mark.parametrize("S,C,R,m,p,mixed", SHAPES)
def test_narrow_kernel_matches_twin(cuda, S, C, R, m, p, mixed, scalars):
    _check_kernel(cuda, S, C, R, m, p, mixed, narrow=True,
                  narrow_scalars=scalars)


def test_block_query_on_the_card(cuda, tmp_path):
    from genomicsdb_tpu.tools import vcf2gdb
    from genomicsdb_tpu_torch.testing import write_cohort
    from genomicsdb_tpu_torch.tools import gdb_query
    c = write_cohort(str(tmp_path), 40, 300, seed=2)
    vcf2gdb.main([c.loader])

    def run(device, pack=None):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            gdb_query.main(["-j", c.query, "--produce-Broad-GVCF",
                            "--device", device], pack=pack)
        return buf.getvalue()

    FC.fused_gather_remap.launches = 0
    FC.fused_gather_remap.narrow_launches = 0
    FC.combine_block.blocks = 0
    FC.combine_block.general_path_blocks = 0
    on_card = run("cuda", pack=False)
    assert FC.fused_gather_remap.launches == FC.combine_block.blocks > 0
    assert FC.fused_gather_remap.narrow_launches == 0
    assert FC.combine_block.general_path_blocks == 0
    assert on_card and on_card == run("cpu")


def test_packed_block_query_on_the_card(cuda, tmp_path):
    """The card's default: the narrow kernel on every block, the packed
    variant-row fetch through pinned memory; the text equals the CPU
    device's."""
    from genomicsdb_tpu.tools import vcf2gdb
    from genomicsdb_tpu_torch.query import block_writer as BW
    from genomicsdb_tpu_torch.testing import write_cohort
    from genomicsdb_tpu_torch.tools import gdb_query
    c = write_cohort(str(tmp_path), 40, 300, seed=2)
    vcf2gdb.main([c.loader])

    def run(device, **kw):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            gdb_query.main(["-j", c.query, "--produce-Broad-GVCF",
                            "--device", device], **kw)
        return buf.getvalue()

    FC.fused_gather_remap.narrow_launches = 0
    FC.combine_block.blocks = 0
    FC.combine_block.wide_blocks_when_packing = 0
    BW.render_block_vcf_pipelined.split_blocks = 0
    on_card = run("cuda")
    assert FC.fused_gather_remap.narrow_launches \
        == FC.combine_block.blocks > 0
    assert FC.combine_block.wide_blocks_when_packing == 0
    assert BW.render_block_vcf_pipelined.split_blocks > 0
    assert on_card and on_card == run("cpu") == run("cpu", pack=True)
