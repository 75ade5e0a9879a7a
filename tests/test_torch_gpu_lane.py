"""The port on an NVIDIA card: the CUDA kernel in its wide and narrow
forms against its plain twin (bit-exact, cells with no live call
included) at synthetic shapes, at a ragged one (records and samples
not multiples of the tile), at m 16 / ploidy 6 (PL in genotype chunks)
and at the largest launch of the 1,000-sample block query; and block
queries on the card, with the fetch pack on and off, over the socket
server, and on a mesh of rank processes (1x1 on NCCL, 2x1 on gloo
sharing one card), against the same query on the CPU.

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


def _block(S, C, R, m, p, mixed, seed, keep_b=None):
    blk = synthesize_cohort(S, C, R, seed=seed, max_merged=m, ploidy=p)
    if keep_b is not None:
        for name in ("inv_bs", "nr_bs", "rec_num_merged", "live"):
            setattr(blk, name, getattr(blk, name)[:keep_b])
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


# (S, C, R, m, p, mixed, records kept): the last two are ragged (999
# samples, 1001 records against 16 x 16 tiles) and m 16 / ploidy 6
SHAPES = [(64, 256, 16384, 4, 2, False, None),
          (16, 64, 4096, 16, 2, False, None),
          (8, 64, 4096, 4, 6, False, None),
          (16, 64, 4096, 16, 3, True, None),
          (8, 48, 4096, 4, 6, True, None),
          (999, 128, 16384, 4, 2, False, 1001),
          (4, 16, 512, 16, 6, True, 90)]


def _check_args(args, **kw):
    before = (FC.fused_gather_remap.launches,
              FC.fused_gather_remap.narrow_launches)
    got = FC.fused_gather_remap(*args, **kw)
    torch.cuda.synchronize()
    narrow = int(kw.get("narrow", False))
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


def _check_kernel(cuda, S, C, R, m, p, mixed, keep_b, **mode):
    blk = _block(S, C, R, m, p, mixed, seed=S + m + p, keep_b=keep_b)
    t = TC.block_to_tensors(blk, cuda)
    args = (*t[:12], t[16], t[12], t[13], t[14], t[15],
            t[18] if mixed else None)
    _check_args(args, max_merged=m, ploidy=p, gt_phase=mixed, mixed=mixed,
                **mode)


@pytest.mark.parametrize("S,C,R,m,p,mixed,keep_b", SHAPES)
def test_kernel_matches_twin(cuda, S, C, R, m, p, mixed, keep_b):
    _check_kernel(cuda, S, C, R, m, p, mixed, keep_b)


@pytest.mark.parametrize("scalars", [True, False])
@pytest.mark.parametrize("S,C,R,m,p,mixed,keep_b", SHAPES)
def test_narrow_kernel_matches_twin(cuda, S, C, R, m, p, mixed, keep_b,
                                    scalars):
    _check_kernel(cuda, S, C, R, m, p, mixed, keep_b, narrow=True,
                  narrow_scalars=scalars)


def test_main_path_launch_matches_twin(cuda, tmp_path):
    """The largest kernel launch of the 1,000-sample block query (its
    store-wide slabs, as the query hands them over) in every form."""
    from genomicsdb_tpu_torch.testing import write_cohort
    from genomicsdb_tpu_torch.tools import gdb_query, vcf2gdb
    c = write_cohort(str(tmp_path), 1000, 4000, seed=0)
    vcf2gdb.main([c.loader])
    seen = []
    launch = FC._launch

    def recorder(*args, **kw):
        seen.append((args, kw))
        return launch(*args, **kw)

    FC._launch = recorder
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            gdb_query.main(["-j", c.query, "--produce-Broad-GVCF",
                            "--device", "cuda"])
    finally:
        FC._launch = launch
    args, kw = max(seen, key=lambda a: a[0][12].numel())
    assert args[12].shape[1] == 1000 and args[12].shape[0] >= 1024
    base = {k: kw[k] for k in ("max_merged", "ploidy", "gt_phase",
                               "mixed")}
    for narrow, scalars in ((False, False), (True, False), (True, True)):
        _check_args(args, **base, narrow=narrow, narrow_scalars=scalars)


def test_block_query_on_the_card(cuda, tmp_path):
    from genomicsdb_tpu_torch.testing import write_cohort
    from genomicsdb_tpu_torch.tools import gdb_query, vcf2gdb
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
    from genomicsdb_tpu_torch.query import block_writer as BW
    from genomicsdb_tpu_torch.testing import write_cohort
    from genomicsdb_tpu_torch.tools import gdb_query, vcf2gdb
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


def test_socket_server_on_the_card(cuda, tmp_path):
    """A small cohort served over the socket by a server on the card
    (engine lane, then the serving index, one-shot and persistent, four
    concurrent clients) gives the bytes of a server on the CPU."""
    import os
    import threading

    from genomicsdb_tpu_torch.query import stream_server as SS
    from genomicsdb_tpu_torch.testing import write_cohort
    from genomicsdb_tpu_torch.tools import vcf2gdb
    c = write_cohort(str(tmp_path), 40, 300, seed=2)
    vcf2gdb.main([c.loader])
    docs = [{"workspace": c.workspace, "array_name": c.array,
             "vid_mapping_file": c.vid, "callset_mapping_file": c.callsets,
             "query_column_ranges": [{"range_list": [
                 {"low": lo, "high": lo + 3000}]}]}
            for lo in (0, c.region // 3, c.region - 2000)]
    ref = SS.QueryStreamServer(port=0, device="cpu")
    card = SS.QueryStreamServer(port=0, device=cuda)
    ref.start_background()
    card.start_background()
    try:
        want = [SS.read_query_stream(*ref.address, d) for d in docs]
        FC.combine_block.blocks = 0
        FC.fused_gather_remap.narrow_launches = 0
        os.environ["GENOMICSDB_TPU_SERVING_INDEX"] = "0"
        try:
            with SS.QueryStreamClient(*card.address) as cli:
                assert [cli.query(d) for d in docs] == want
        finally:
            del os.environ["GENOMICSDB_TPU_SERVING_INDEX"]
        assert FC.fused_gather_remap.narrow_launches \
            == FC.combine_block.blocks >= len(docs)
        with SS.QueryStreamClient(*card.address) as cli:
            for _ in range(3):
                assert [cli.query(d) for d in docs] == want
        assert [SS.read_query_stream(*card.address, d)
                for d in docs] == want
        errors = []

        def client(tid):
            try:
                with SS.QueryStreamClient(*card.address) as cli:
                    for k in range(6):
                        i = (tid + k) % len(docs)
                        if cli.query(docs[i]) != want[i]:
                            errors.append((tid, k))
            except Exception as e:      # surfaced after join
                errors.append((tid, repr(e)))

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
    finally:
        ref.shutdown()
        card.shutdown()


@pytest.mark.parametrize("shape", ["1x1", "2x1"])
def test_mesh_on_the_card(cuda, tmp_path, shape):
    """`gdb_query --mesh` on the card: 1x1 on NCCL (a card per rank),
    2x1 on gloo where the ranks share a card; every rank launched the
    CUDA kernel for every block, and the text equals the unsharded
    query's on the CPU."""
    from genomicsdb_tpu_torch.testing import write_cohort
    from genomicsdb_tpu_torch.tools import gdb_query, vcf2gdb
    c = write_cohort(str(tmp_path), 40, 300, seed=2)
    vcf2gdb.main([c.loader])

    def run(*extra):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            gdb_query.main(["-j", c.query, "--produce-Broad-GVCF", *extra])
        return buf.getvalue()

    got = run("--device", "cuda", "--mesh", shape)
    assert got and got == run("--device", "cpu")
    world = int(shape[0]) * int(shape[2])
    backend = "nccl" if world <= torch.cuda.device_count() else "gloo"
    reports = gdb_query.spawn_mesh.rank_reports
    assert [r["rank"] for r in reports] == list(range(world))
    for r in reports:
        assert r["backend"] == backend
        assert r["device"].startswith("cuda:")
        assert r["launches"] == r["blocks"] > 0
        assert r["general_path_blocks"] == 0


def _outputs_equal(a, b):
    assert set(a) == set(b)
    for key in a:
        x, y = a[key].cpu(), b[key].cpu()
        assert x.dtype == y.dtype and x.shape == y.shape, key
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), key


@pytest.mark.parametrize("S,C,R,m,p,mixed", [(64, 256, 16384, 4, 2, False),
                                             (16, 64, 4096, 16, 3, True)])
def test_dense_step_on_the_card(cuda, S, C, R, m, p, mixed):
    """combine_step_dense on host-gathered inputs: the card's outputs
    equal the CPU's, and the general step's."""
    blk = _block(S, C, R, m, p, mixed, seed=S + m)
    g = TC.gather_block_host(blk, blk.live)
    flags = dict(max_merged=m, ploidy=p, gt_phase=mixed, mixed_ploidy=mixed)

    def run(dev):
        gtl = TC.to_tensor(blk.gt_len_bs, dev) if mixed else None
        return TC.combine_step_dense(
            *TC.dense_tensors(g, dev), TC.to_tensor(blk.rec_num_merged, dev),
            TC.to_tensor(blk.rec_has_nr, dev), gtl, **flags)

    on_card = run(cuda)
    _outputs_equal(on_card, run("cpu"))
    gen = TC.combine_step(*TC.block_to_tensors(blk, cuda), **flags)
    _outputs_equal(on_card, {k: v for k, v in gen.items() if k != "live"})


@pytest.mark.parametrize("S,C,R,m,p,mixed", [(64, 256, 16384, 4, 2, False),
                                             (8, 48, 4096, 20, 3, True)])
def test_remap_rows_on_the_card(cuda, S, C, R, m, p, mixed):
    """combine_step restricted to every third record (bucket-padded) on
    the card equals the CPU's, and the unrestricted step's rows."""
    blk = _block(S, C, R, m, p, mixed, seed=S + p)
    B = blk.live.shape[0]
    rows = np.arange(0, B, 3)
    bucket = 16
    while bucket < len(rows):
        bucket *= 2
    remap_rows = np.zeros(bucket, np.int32)
    remap_rows[:len(rows)] = rows
    flags = dict(max_merged=m, ploidy=p, gt_phase=mixed, mixed_ploidy=mixed)

    def run(dev, restrict):
        return TC.combine_step(*TC.block_to_tensors(blk, dev),
                               remap_rows=remap_rows if restrict else None,
                               **flags)

    on_card = run(cuda, True)
    _outputs_equal(on_card, run("cpu", True))
    full = run(cuda, False)
    idx = torch.as_tensor(remap_rows, device=cuda).long()
    for key in ("pl", "ad", "gt", "gq", "dp_format", "min_dp"):
        assert torch.equal(on_card[key], full[key][idx]), key
    for key in ("dp_info_sum", "info_median", "info_fsum", "live"):
        assert torch.equal(on_card[key].view(torch.int32)
                           if on_card[key].dtype == torch.float32
                           else on_card[key],
                           full[key].view(torch.int32)
                           if full[key].dtype == torch.float32
                           else full[key]), key


def test_bench_fused_lane_narrow_equals_wide(cuda):
    """The bench's kernel lane at a small shape: its narrow checksum (on
    widened values) equals its wide one (the lane raises otherwise) and
    the general lane's; the kernel launched once per chunk and form."""
    from genomicsdb_tpu_torch import bench as TB
    shape = dict(num_samples=64, cells_per_sample=256, region_len=16384,
                 chunk=1024, reps=1)
    before = FC.fused_gather_remap.narrow_launches
    fused = TB.bench_device_fused(cuda, **shape)
    assert FC.fused_gather_remap.narrow_launches > before
    assert fused["narrow"]["checksum"] == fused["checksum"]
    assert TB.bench_device(cuda, **shape)["checksum"] == fused["checksum"]



def test_streamed_store_block_query_on_the_card(cuda, tmp_path):
    """A store built by the streaming importer from BCF2 streams (GATK4's
    wire format): its block query on the card (narrow kernel on every
    block, packed fetch) equals the same query on the CPU device."""
    from genomicsdb_tpu_torch.core.config import QueryParams
    from genomicsdb_tpu_torch.core.vid import VidMapper
    from genomicsdb_tpu_torch.query import driver
    from genomicsdb_tpu_torch.store.streaming_import import \
        StreamingImporter
    from genomicsdb_tpu_torch.testing import write_cohort
    from genomicsdb_tpu_torch.vcf.bcf import text_to_bcf
    c = write_cohort(str(tmp_path), 40, 300, seed=2)
    vid = VidMapper.from_files(c.vid, c.callsets)
    imp = StreamingImporter(vid)
    for path in c.vcfs:
        imp.add_buffer_stream(path)
    for path in c.vcfs:
        with open(path) as f:
            data = text_to_bcf(f.read())
        for off in range(0, len(data), 65536):
            imp.write(path, data[off:off + 65536])
            imp.import_batch()
    store = imp.finalize()
    qp = QueryParams.from_file(c.query, 0)
    qc = driver.make_query_config(qp, vid)
    FC.fused_gather_remap.narrow_launches = 0
    FC.combine_block.blocks = 0
    on_card = driver.run_vcf_query_block(store, qc, qp, vid, cuda)
    assert FC.fused_gather_remap.narrow_launches \
        == FC.combine_block.blocks > 0
    assert on_card and on_card == driver.run_vcf_query_block(
        store, qc, qp, vid, torch.device("cpu"))
