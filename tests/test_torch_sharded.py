"""The port's sharded combine (`genomicsdb_tpu_torch.parallel.sharded`)
on ("pos", "row") meshes of gloo CPU rank processes, held exactly
(integers equal, floats as int32 bits) against the port's unsharded
combine_step and against the JAX package's `sharded_combine_step` and
`sharded_combine_step_fused` (Pallas in interpret mode, rt 8) on the 8
virtual CPU devices of tests/conftest.py; and `gdb_query --mesh` on the
CPU against the port without the mesh and the JAX tool's `--mesh`.

Each mesh runs as P*R worker processes (this file's WORKER, written to a
temporary directory); each has its own timeout and is killed on failure.
Objects never cross: the worker loads the block's arrays the test wrote
with numpy.
"""

import contextlib
import dataclasses
import io
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from genomicsdb_tpu.ops import combine_step as JC
from genomicsdb_tpu.parallel import sharded as JS
from genomicsdb_tpu.tools import gdb_query as jax_gdb_query
from genomicsdb_tpu_torch.ops import cell_block as CB
from genomicsdb_tpu_torch.ops import combine_step as TC
from genomicsdb_tpu_torch.parallel import sharded as TS
from genomicsdb_tpu_torch.testing import write_cohort
from genomicsdb_tpu_torch.tools import gdb_query, vcf2gdb

from test_torch_combine_step import make_blocks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [(1, 1), (2, 2), (4, 2), (8, 1), (2, 4)]
# (make_block keywords): diploid; samples and records that no mesh side
# divides; a mixed-ploidy phased block
CASES = {
    "diploid": dict(S=8, C=48, R=4096, seed=11),
    "odd": dict(S=5, C=40, R=3000, seed=7),
    "mixed_phased": dict(S=6, C=48, R=4096, seed=17, ploidy=3, mixed=True,
                         phased=True),
}
TIMEOUT_S = 180

WORKER = r"""
import os, sys
sys.path.insert(0, %(root)r)
import numpy as np
import torch
from genomicsdb_tpu_torch.ops.cell_block import CellBlock
from genomicsdb_tpu_torch.parallel import sharded as TS
n_pos, n_row, blocks, out = sys.argv[1:5]
mesh = TS.make_mesh(int(n_pos), int(n_row), "cpu")
res = {}
z = np.load(blocks, allow_pickle=False)
for case in sorted({k.split("/")[0] for k in z.files}):
    f = {k.split("/", 1)[1]: z[k] for k in z.files if k.startswith(case)}
    flags = dict(max_merged=int(f.pop("_m")), ploidy=int(f.pop("_ploidy")),
                 gt_phase=bool(f.pop("_phased")),
                 mixed_ploidy=bool(f.pop("_mixed")))
    blk = CellBlock(ploidy=flags["ploidy"], gt_phase=flags["gt_phase"], **f)
    B, S = blk.live.shape
    local = TS.shard_block(mesh, blk)
    for name, step in (("general", TS.sharded_combine_step),
                       ("fused", TS.sharded_combine_step_fused)):
        got = TS.gather_outputs(mesh, step(mesh, *local, **flags), B, S)
        if got is not None:
            res.update({f"{case}/{name}/{k}": v for k, v in got.items()})
if mesh.rank == 0:
    np.savez(out, **res)
del mesh, local     # the mesh's groups go before the process group
torch.distributed.destroy_process_group()
"""


def run_ranks(script, argv, world, timeout=TIMEOUT_S):
    """Runs `script argv` as `world` gloo ranks on this host (the
    environment `gdb_query --mesh` gives its ranks); every rank
    must exit 0 within `timeout` seconds of the start (all are killed
    otherwise).  Returns their stdouts."""
    port = gdb_query.free_port()
    procs = []
    deadline = time.monotonic() + timeout
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, str(script), *argv],
                env=gdb_query.rank_env(r, world, port), text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        outs = [p.communicate(timeout=max(deadline - time.monotonic(), 1))
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
    return [o for o, _ in outs]


def _flags(kw):
    return dict(max_merged=kw.get("m", 4), ploidy=kw.get("ploidy", 2),
                gt_phase=kw.get("phased", False),
                mixed_ploidy=kw.get("mixed", False))


def _save_blocks(path):
    """The port's CASES blocks as numpy arrays for the workers; returns
    {case: (JAX block, port block)}."""
    arrays, blocks = {}, {}
    for case, kw in CASES.items():
        jblk, tblk = make_blocks(**kw)
        blocks[case] = (jblk, tblk)
        for f in dataclasses.fields(CB.CellBlock):
            v = getattr(tblk, f.name)
            if isinstance(v, np.ndarray):
                arrays[f"{case}/{f.name}"] = v
        fl = _flags(kw)
        arrays.update({f"{case}/_m": fl["max_merged"],
                       f"{case}/_ploidy": fl["ploidy"],
                       f"{case}/_phased": fl["gt_phase"],
                       f"{case}/_mixed": fl["mixed_ploidy"]})
    np.savez(path, **arrays)
    return blocks


def _trim(out, B, S):
    """A padded mesh output dict trimmed to B records x S samples (the
    JAX block writer's mesh-branch layout)."""
    res = {}
    for k, v in out.items():
        a = np.asarray(v)
        if k in ("pl", "ad", "gt", "gq", "dp_format", "min_dp", "live"):
            a = a[:B, :S]
        elif k.startswith("info_"):
            a = a[:, :B]
        else:
            a = a[:B]
        res[k] = a
    return res


def _assert_equal(ref, got, label):
    assert set(ref) == set(got), (label, set(ref) ^ set(got))
    for k in sorted(ref):
        a, b = np.asarray(ref[k]), np.asarray(got[k])
        assert a.dtype == b.dtype and a.shape == b.shape, \
            (label, k, a.dtype, a.shape, b.dtype, b.shape)
        if a.dtype.kind == "f":
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=f"{label} {k}")


@pytest.mark.parametrize("n_pos,n_row", MESHES)
def test_mesh_steps_match_unsharded_and_jax(tmp_path, n_pos, n_row):
    blocks = _save_blocks(tmp_path / "blocks.npz")
    script = tmp_path / "worker.py"
    script.write_text(WORKER % {"root": ROOT})
    out = tmp_path / "out.npz"
    run_ranks(script, [str(n_pos), str(n_row), str(tmp_path / "blocks.npz"),
                       str(out)], n_pos * n_row)
    z = np.load(out)
    jmesh = JS.make_mesh(n_pos, n_row)
    for case, kw in CASES.items():
        jblk, tblk = blocks[case]
        flags = _flags(kw)
        B, S = tblk.live.shape
        unsharded = {k: v.numpy() for k, v in TC.combine_step(
            *TC.block_to_tensors(tblk, "cpu"), **flags).items()}
        general = JS.sharded_combine_step(jmesh, **flags)(
            *JS.shard_block(jmesh, JS.pad_block_for_mesh(jblk, n_pos,
                                                         n_row)))
        args, cfg, b_local, _, _ = JS.shard_block_fused(
            jmesh, jblk, max_merged=flags["max_merged"],
            ploidy=flags["ploidy"], gt_phase=flags["gt_phase"], rt=8,
            mixed_ploidy=flags["mixed_ploidy"])
        fused = JS.sharded_combine_step_fused(jmesh, cfg, b_local,
                                              interpret=True)(*args)
        for step in ("general", "fused"):
            got = {k.split("/")[2]: z[k] for k in z.files
                   if k.startswith(f"{case}/{step}/")}
            _assert_equal(unsharded, got, f"{case} {step} vs unsharded")
            _assert_equal(_trim(general, B, S), got,
                          f"{case} {step} vs JAX sharded_combine_step")
            _assert_equal(_trim(fused, B, S), got,
                          f"{case} {step} vs JAX sharded_combine_step_fused")


@pytest.mark.parametrize("n_pos,n_row", MESHES)
def test_shards_are_slices_of_the_padded_block(n_pos, n_row):
    """shard_block at every mesh position equals the JAX package's
    pad_block_for_mesh sliced to the position: sample rows of the slabs,
    records x samples of the LUTs."""
    jblk, tblk = make_blocks(**CASES["odd"])
    pj = JS.pad_block_for_mesh(jblk, n_pos, n_row)
    full = [np.asarray(a) for a in JC.block_to_args(pj)]
    b_loc, s_loc = full[16].shape[0] // n_pos, full[16].shape[1] // n_row
    for pos in range(n_pos):
        for row in range(n_row):
            mesh = TS.Mesh(n_pos, n_row, pos, row, torch.device("cpu"))
            local = TS.shard_block(mesh, tblk)
            bs = slice(pos * b_loc, (pos + 1) * b_loc)
            ss = slice(row * s_loc, (row + 1) * s_loc)
            for i, (want, got) in enumerate(zip(full, local)):
                s_ax, b_ax, _ = TS._LAYOUT[i]
                idx = [slice(None)] * want.ndim
                if s_ax is not None:
                    idx[s_ax] = ss
                if b_ax is not None:
                    idx[b_ax] = bs
                np.testing.assert_array_equal(
                    want[tuple(idx)].view(np.uint8),
                    got.numpy().view(np.uint8), err_msg=f"tensor {i}")


def test_mesh_combine_routes_past_the_gates_to_the_general_step():
    """On a one-rank mesh without a process group: a block with more
    than 16 merged alleles takes the general step and is counted; one
    the kernel takes is not."""
    mesh = TS.Mesh(1, 1, 0, 0, torch.device("cpu"))
    _, wide = make_blocks(S=4, C=32, R=1024, seed=9, m=17)
    _, ok = make_blocks(S=4, C=32, R=1024, seed=9)
    before = (TS.mesh_combine.blocks, TS.mesh_combine.general_path_blocks)
    got = TS.mesh_combine(mesh, wide, max_merged=17, ploidy=2)
    TS.mesh_combine(mesh, ok, max_merged=4, ploidy=2)
    assert (TS.mesh_combine.blocks, TS.mesh_combine.general_path_blocks) \
        == (before[0] + 2, before[1] + 1)
    ref = TC.combine_step(*TC.block_to_tensors(wide, "cpu"), max_merged=17,
                          ploidy=2)
    _assert_equal({k: v.numpy() for k, v in ref.items()},
                  {k: v.numpy() for k, v in got.items()}, "m 17")


def _run(main, argv, **kw) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv, **kw)
    return buf.getvalue()


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    c = write_cohort(str(tmp_path_factory.mktemp("mesh")), 10, 160, seed=8,
                     n_groups=2)
    vcf2gdb.main([c.loader])
    return c


def run_tool(argv, timeout=TIMEOUT_S):
    """(stdout, the ranks' report dicts) of `python -m
    genomicsdb_tpu_torch.tools.gdb_query argv` in a session of its own:
    on timeout the tool and every rank it spawned are killed."""
    p = subprocess.Popen([sys.executable, "-m",
                          "genomicsdb_tpu_torch.tools.gdb_query", *argv],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, cwd=ROOT, start_new_session=True)
    try:
        out, err = p.communicate(timeout=timeout)
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    assert p.returncode == 0, err[-3000:]
    reports = [json.loads(ln[len(gdb_query.REPORT):])
               for ln in err.splitlines() if ln.startswith(gdb_query.REPORT)]
    return out, sorted(reports, key=lambda r: r["rank"])


CHUNK_SAMPLES, CHUNK_RECORDS = 256, 700
# the chunked cohort's query: a first interval of two chunks (at 256
# samples a chunk holds 1,024 records), an interval whose first pos span
# edge falls inside a deletion, and one of a single record (fewer than
# the pos groups)
FIRST_RECORDS, EDGE_SPAN, SINGLE_AT = 1100, 40, 1800


def _events_and_deletion_starts(c):
    """(the cohort's record starts, [E] bool: the start lies inside a
    deletion that begins before it), by the port's own store reader."""
    from genomicsdb_tpu_torch.core.config import QueryParams
    from genomicsdb_tpu_torch.ops.store_block import record_starts
    from genomicsdb_tpu_torch.query import driver
    from genomicsdb_tpu_torch.store import workspace as ws
    qp = QueryParams.from_file(c.query, 0)
    qc = driver.make_query_config(qp, driver.load_vid_for_query(qp, None))
    store = ws.open_array(c.workspace, c.array)
    starts = record_starts(store, qc, (0, c.region))
    lens = store.fields["REF"].lens()
    dels = lens > 1
    inside = np.zeros(len(starts), dtype=bool)
    for col, n in zip(store.col[dels], lens[dels]):
        inside[np.searchsorted(starts, col, side="right"):
               np.searchsorted(starts, col + n - 1, side="right")] = True
    return starts, inside


@pytest.fixture(scope="module")
def chunked(tmp_path_factory):
    """A cohort of several chunks, its records' starts and, per pos-group
    count P, a query of three intervals (see FIRST_RECORDS) with the
    port's unsharded text of it and the records that run built."""
    from genomicsdb_tpu_torch.query.block_writer import (
        render_block_vcf_pipelined as RB)
    d = str(tmp_path_factory.mktemp("chunked"))
    c = write_cohort(d, CHUNK_SAMPLES, CHUNK_RECORDS, seed=8)
    vcf2gdb.main([c.loader])
    starts, inside = _events_and_deletion_starts(c)
    # the first deletion-internal start far enough past the first
    # interval to open a span edge there for every P
    edge = next(i for i in np.nonzero(inside)[0]
                if i - EDGE_SPAN > FIRST_RECORDS)
    with open(c.query) as f:
        doc = json.load(f)
    queries = {}
    for n_pos in (1, 2, 3):
        lo = edge - EDGE_SPAN        # records lo.. lo + n_pos * EDGE_SPAN
        hi = lo + n_pos * EDGE_SPAN
        assert hi < SINGLE_AT < len(starts) - 1
        ranges = [(0, starts[FIRST_RECORDS] - 1),
                  (starts[lo], starts[hi] - 1),
                  (starts[SINGLE_AT], starts[SINGLE_AT + 1] - 1)]
        doc["query_column_ranges"] = [{"range_list": [
            {"low": int(a), "high": int(b)} for a, b in ranges]}]
        query = os.path.join(d, f"query_p{n_pos}.json")
        with open(query, "w") as f:
            json.dump(doc, f)
        before = RB.records_built
        text = _run(gdb_query.main, ["-j", query, "--produce-Broad-GVCF",
                                     "--device", "cpu"])
        queries[n_pos] = (query, text, RB.records_built - before)
    return starts, queries


def _expected_spans(starts, query, n_pos, n_samples):
    """(per pos group, the [lo, hi] column spans it must build; the
    chunk count): each interval cut into chunks of the driver's record
    cap, each chunk's records split into n_pos spans of
    ceil(n / n_pos)."""
    cap = min(65536, max(1024, (1 << 18) // n_samples))
    with open(query) as f:
        ranges = json.load(f)["query_column_ranges"][0]["range_list"]
    spans = [[] for _ in range(n_pos)]
    chunks = 0
    for r in ranges:
        ev = starts[(starts >= r["low"]) & (starts <= r["high"])]
        assert ev[0] == r["low"]
        for i in range(0, len(ev), cap):
            chunk = ev[i:i + cap]
            chunks += 1
            end = ev[i + cap] - 1 if i + cap < len(ev) else r["high"]
            per = -(-len(chunk) // n_pos)
            for p in range(n_pos):
                part = chunk[p * per:(p + 1) * per]
                if len(part):
                    nxt = chunk[(p + 1) * per] - 1 \
                        if (p + 1) * per < len(chunk) else end
                    spans[p].append([int(part[0]), int(nxt)])
    return spans, chunks


# 1x3 and 2x3 split the 256 samples unevenly: the last row rank's
# shard holds padded samples
@pytest.mark.parametrize("n_pos,n_row", [(1, 1), (2, 1), (1, 2), (2, 2),
                                         (3, 1), (1, 3), (2, 3)])
def test_gdb_query_mesh_matches_unsharded_and_the_jax_tool(
        chunked, n_pos, n_row):
    """`gdb_query --mesh PxR --device cpu` (P*R spawned gloo ranks) on a
    query of several chunks, a span edge inside a deletion and a chunk
    of fewer records than P gives the port's unsharded text (and, on
    2x2, the JAX tool's `--mesh 2x2` text).  Each record is built once
    across the mesh: pos group p's row-0 rank builds exactly span p of
    every chunk, the other ranks build nothing, and a row group of one
    runs no all-gather."""
    starts, queries = chunked
    query, want, records = queries[n_pos]
    argv = ["-j", query, "--produce-Broad-GVCF"]
    got, reports = run_tool(argv + ["--device", "cpu", "--mesh",
                                    f"{n_pos}x{n_row}"])
    assert want.count("\n") > FIRST_RECORDS
    assert got == want
    assert [(r["rank"], r["pos"], r["row"], r["backend"])
            for r in reports] == [(k, *divmod(k, n_row), "gloo")
                                  for k in range(n_pos * n_row)]
    assert sum(r["records_built"] for r in reports) == records
    spans, chunks = _expected_spans(starts, query, n_pos, CHUNK_SAMPLES)
    # two chunks, the deletion-edge interval and the single record:
    # every pos group but the first has a span without records
    assert chunks == 4
    assert [len(s) for s in spans] == [4] + [3] * (n_pos - 1)
    for r in reports:
        # one block combined per chunk: a span without records is
        # padding that takes part all the same
        assert r["blocks"] == chunks and r["general_path_blocks"] == 0
        if r["row"]:
            assert (r["records_built"], r["blocks_built"],
                    r["built_spans"], r["text_bytes"]) == (0, 0, [], 0)
        else:
            assert r["built_spans"] == spans[r["pos"]]
            assert r["blocks_built"] == len(spans[r["pos"]])
        if n_row == 1:
            assert (r["all_gathers"], r["all_gather_bytes"],
                    r["lut_scatter_bytes"]) == (0, 0, 0)
        else:
            assert r["all_gathers"] == r["blocks"]
            assert r["lut_scatter_bytes"] > 0
    assert sum(r["text_bytes"] for r in reports) == len(
        want.encode()) - len("".join(
            ln + "\n" for ln in want.splitlines() if ln.startswith("#")))
    if (n_pos, n_row) == (2, 2):
        assert got == _run(jax_gdb_query.main, argv + ["--mesh", "2x2"])


def test_gdb_query_mesh_failures(cohort, monkeypatch):
    """A failing rank fails the query with its stderr; --mesh on cuda
    without a card raises before any rank starts; modes the mesh does
    not shard are refused."""
    with pytest.raises(SystemExit,
                       match=r"rank \d exited 1:(.|\n)*file not found"):
        gdb_query.main(["-j", cohort.query + ".missing",
                        "--produce-Broad-GVCF", "--device", "cpu",
                        "--mesh", "2x1"])
    with pytest.raises(SystemExit, match="--mesh shards"):
        gdb_query.main(["-j", cohort.query, "--print-calls", "--device",
                        "cpu", "--mesh", "2x1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="not available"):
        gdb_query.main(["-j", cohort.query, "--produce-Broad-GVCF",
                        "--device", "cuda", "--mesh", "1x1"])


SLABS_WORKER = r"""
import json, sys
sys.path.insert(0, %(root)r)
import torch
from genomicsdb_tpu_torch.core.config import QueryParams
from genomicsdb_tpu_torch.core.vid import VidMapper
from genomicsdb_tpu_torch.ops.store_block import store_to_block
from genomicsdb_tpu_torch.parallel import sharded as TS
from genomicsdb_tpu_torch.query import driver
from genomicsdb_tpu_torch.query.block_fields import build_block_plan
from genomicsdb_tpu_torch.store import workspace as ws
workspace, array, vid, callsets, query = sys.argv[1:6]
mesh = TS.make_mesh(1, 1, "cpu")


def opened():
    qc = driver.make_query_config(QueryParams.from_file(query, 0),
                                  VidMapper.from_files(vid, callsets))
    return ws.open_array(workspace, array), qc, build_block_plan(qc, qc.vid)


store, qc, plan = opened()
blk = store_to_block(store, qc)
gt_w = blk.gt.shape[2]
TS.shard_block(mesh, blk)
got = TS.local_slabs(mesh, store, qc, plan, gt_w, 1)
store, qc, plan = opened()
alone = TS.local_slabs(mesh, store, qc, plan, gt_w, 1)
same = [isinstance(a, torch.Tensor) and a.shape == b.shape
        and a.numpy().tobytes() == b.numpy().tobytes()
        for a, b in zip(got, alone)]
print(json.dumps({"got": len(got), "alone": len(alone), "same": same}))
del mesh
torch.distributed.destroy_process_group()
"""


def test_local_slabs_after_shard_block_on_one_store(tmp_path):
    """On one store, shard_block of a block from the store path and then
    local_slabs (a gloo world of one): local_slabs returns the 12 slab
    tensors it returns alone, not shard_block's tables."""
    c = write_cohort(str(tmp_path / "cohort"), 8, 60, seed=8)
    vcf2gdb.main([c.loader])
    script = tmp_path / "slabs.py"
    script.write_text(SLABS_WORKER % {"root": ROOT})
    out, = run_ranks(script, [c.workspace, c.array, c.vid, c.callsets,
                              c.query], 1)
    got = json.loads(out.strip().splitlines()[-1])
    assert got["got"] == got["alone"] == TS.N_SLABS
    assert all(got["same"])
