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
    """Runs `script argv` as `world` gloo ranks on this host; every rank
    must exit 0 within `timeout` seconds of the start (all are killed
    otherwise).  Returns their stdouts."""
    port = gdb_query.free_port()
    procs = []
    deadline = time.monotonic() + timeout
    try:
        for r in range(world):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port))
            procs.append(subprocess.Popen(
                [sys.executable, str(script), *argv], env=env, text=True,
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


def test_gdb_query_mesh_matches_unsharded_and_the_jax_tool(cohort):
    """`gdb_query --mesh 2x2 --device cpu` (four spawned gloo ranks)
    gives the port's unsharded text and the JAX tool's `--mesh 2x2`
    text; every rank combined every block on its shard."""
    argv = ["-j", cohort.query, "--produce-Broad-GVCF"]
    want = _run(gdb_query.main, argv + ["--device", "cpu"])
    got, reports = run_tool(argv + ["--device", "cpu", "--mesh", "2x2"])
    assert want.count("\n") > 100
    assert got == want
    assert [(r["rank"], r["pos"], r["row"], r["backend"])
            for r in reports] == [(0, 0, 0, "gloo"), (1, 0, 1, "gloo"),
                                  (2, 1, 0, "gloo"), (3, 1, 1, "gloo")]
    assert len({r["blocks"] for r in reports}) == 1
    assert all(r["blocks"] > 0 and r["general_path_blocks"] == 0
               and r["all_gathers"] == r["blocks"] for r in reports)
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
