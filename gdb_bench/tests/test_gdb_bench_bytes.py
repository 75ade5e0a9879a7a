"""The roofline's byte count from a block's own arrays equals
chip_smoke.py's count from the kernel launch's arguments."""

import contextlib
import io

import pytest

torch = pytest.importorskip("torch")

from gdb_bench.cohort import write_cohort  # noqa: E402
from gdb_bench.roofline import combine_min_bytes  # noqa: E402


@pytest.mark.parametrize("ploidy", [2, 4])
def test_block_bytes_match_launch_bytes(tmp_path, monkeypatch, ploidy):
    import chip_smoke
    from genomicsdb_tpu_torch.ops import fused_combine as FC
    from genomicsdb_tpu_torch.query import block_writer
    from genomicsdb_tpu_torch.tools import gdb_query, vcf2gdb
    c = write_cohort(str(tmp_path), 24, 60, seed=7, ploidy=ploidy)
    with contextlib.redirect_stdout(io.StringIO()):
        vcf2gdb.main([c.loader])
    blocks, launches = [], []
    inner_block, inner_launch = block_writer.combine_block, \
        FC.fused_gather_remap

    def combine_block(blk, device, **kw):
        blocks.append((blk, kw))
        return inner_block(blk, device, **kw)

    def fused_gather_remap(*args, **kw):
        launches.append((args, kw))
        return inner_launch(*args, **kw)

    monkeypatch.setattr(block_writer, "combine_block", combine_block)
    monkeypatch.setattr(FC, "fused_gather_remap", fused_gather_remap)
    with contextlib.redirect_stdout(io.StringIO()):
        gdb_query.main(["-j", c.query, "--produce-Broad-GVCF",
                        "--device", "cpu"], pack=True)
    assert len(blocks) == len(launches) >= 1
    for (blk, kw), (args, lkw) in zip(blocks, launches):
        want, _ = chip_smoke._launch_bytes(torch, args, lkw)
        got = combine_min_bytes(blk, max_merged=kw["max_merged"],
                                ploidy=kw["ploidy"],
                                mixed=kw.get("mixed_ploidy", False))
        assert got == want
