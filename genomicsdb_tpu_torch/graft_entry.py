"""Driver entry points on the port (counterpart of the repository root's
`__graft_entry__.py`): one combine step on a device, and a dryrun of the
mesh over rank processes.

  entry(device)                 (fn, example_args): the port's
                                combine_step (m 4, diploid) and the
                                tensors of synthesize_cohort(8, 32, 2048,
                                seed=0) on `device`
  dryrun_multichip(n, device)   n rank processes on a ("pos", "row")
                                mesh (2 rows when n is even): one
                                sharded step on a synthetic block, then
                                a two-sample gVCF through the mesh's
                                block engine, whose text must equal the
                                sequential engine's

The JAX dryrun ends with the upstream golden t0_1_2 on the same mesh; it
reads the reference's test goldens, which this repository does not
hold, so that part waits until the goldens are in the repository.

Each rank of the dryrun is this module run as

    python -m genomicsdb_tpu_torch.graft_entry --dryrun-rank DIR \\
        --mesh PxR --device cuda|cpu

under the launcher's environment (RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT), which dryrun_multichip
sets.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

#: the JAX dryrun's two-sample cohort (a reference block, then a
#: bi-allelic SNV inside it)
DRYRUN_VCF = [
    "##fileformat=VCFv4.1",
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="g">',
    '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="d">',
    '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="q">',
    '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="p">',
    '##INFO=<ID=END,Number=1,Type=Integer,Description="e">',
    "##contig=<ID=1,length=249250621>",
    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS0\tS1",
    "1\t100\t.\tC\t<NON_REF>\t.\t.\tEND=199\tGT:DP:GQ:PL\t"
    "./.:12:30:0,3,40\t./.:9:20:0,6,80",
    "1\t150\t.\tA\tT,<NON_REF>\t.\t.\t.\tGT:DP:GQ:PL\t"
    "./.:20:50:40,0,30,50,60,90\t./.:15:40:0,10,100,20,30,99",
]
#: seconds every rank of the dryrun has, start-up included
RANK_TIMEOUT_S = 300


def entry(device="cuda"):
    """(fn, example_args): the flagship computation, the batched
    multi-sample combine, as one call: `fn(*example_args)` is the
    port's combine_step on `device`."""
    from .device import resolve_device
    from .ops.cell_block import synthesize_cohort
    from .ops.combine_step import block_to_tensors, combine_step
    device = resolve_device(device)
    blk = synthesize_cohort(num_samples=8, cells_per_sample=32,
                            region_len=2048, seed=0)
    fn = functools.partial(combine_step, max_merged=4, ploidy=2)
    return fn, block_to_tensors(blk, device)


def _mesh_shape(n_devices: int):
    n_row = 2 if n_devices % 2 == 0 else 1
    return n_devices // n_row, n_row


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Spawn `n_devices` rank processes on an n_pos x n_row mesh (NCCL
    with a card per rank, gloo when ranks share a card or run on the
    CPU), run one sharded step on synthesize_cohort(2 * n_row, 16, 512,
    seed=1), then drive the two-sample gVCF through the mesh's block
    engine.  The first rank holds both against the unsharded port and
    the sequential engine; any rank failing fails the dryrun.  Returns
    the first rank's report (its mesh, backend, device, the block's
    shape, the combined text and the seconds it took to join the
    mesh)."""
    from .device import resolve_device
    from .tools.gdb_query import child_env, free_port
    from .tools.genome_bench import write_vid
    dev = resolve_device(device)
    n_pos, n_row = _mesh_shape(n_devices)
    work = tempfile.mkdtemp(prefix="dryrun_")
    procs = []
    try:
        with open(os.path.join(work, "cohort.vcf"), "w") as f:
            f.write("\n".join(DRYRUN_VCF) + "\n")
        write_vid(os.path.join(work, "vid.json"))
        port = str(free_port())
        for r in range(n_devices):
            env = child_env(RANK=str(r), WORLD_SIZE=str(n_devices),
                            LOCAL_RANK=str(r),
                            LOCAL_WORLD_SIZE=str(n_devices),
                            MASTER_ADDR="localhost", MASTER_PORT=port)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "genomicsdb_tpu_torch.graft_entry",
                 "--dryrun-rank", work, "--mesh", f"{n_pos}x{n_row}",
                 "--device", str(dev)], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, env=env))
        deadline = time.monotonic() + RANK_TIMEOUT_S
        outs = [p.communicate(timeout=max(deadline - time.monotonic(), 1))
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"dryrun rank {r} exited {p.returncode}:\n"
                               f"{err[-3000:]}")
    return json.loads(outs[0][0].strip().splitlines()[-1])


def _exact(a: dict, b: dict, what: str) -> None:
    """Every key of `a` equal in `b`, bit for bit (floats as int32)."""
    for k, x in a.items():
        y = b[k]
        x = np.asarray(x)
        y = np.asarray(y)
        if x.dtype.kind == "f":
            x, y = x.view(np.int32), y.view(np.int32)
        if x.shape != y.shape or not np.array_equal(x, y):
            raise AssertionError(f"{what}: {k} differs")


def _dryrun_rank(work: str, n_pos: int, n_row: int, device) -> None:
    """One rank of dryrun_multichip (the process runs this under the
    launcher's environment)."""
    import torch
    import torch.distributed as dist

    from .core.config import QueryParams
    from .core.vid import VidMapper
    from .ops.cell_block import synthesize_cohort
    from .ops.combine_step import block_to_tensors, combine_step
    from .parallel import sharded as TS
    from .query import driver
    from .store.import_pipeline import import_callsets
    t0 = time.perf_counter()
    mesh = TS.make_mesh(n_pos, n_row, device)
    mesh_s = time.perf_counter() - t0
    flags = dict(max_merged=4, ploidy=2)
    blk = synthesize_cohort(num_samples=2 * n_row, cells_per_sample=16,
                            region_len=512, seed=1)
    B, S = blk.live.shape
    local = TS.shard_block(mesh, blk)
    steps = {}
    for name, step in (("general", TS.sharded_combine_step),
                       ("kernel", TS.sharded_combine_step_fused)):
        steps[name] = TS.gather_outputs(mesh, step(mesh, *local, **flags),
                                        B, S)
    if mesh.rank == 0:
        want = {k: v.cpu().numpy() for k, v in combine_step(
            *block_to_tensors(blk, mesh.device), **flags).items()}
        for name, got in steps.items():
            if got["pl"].shape[0] != B:
                raise AssertionError(f"{name} step: {got['pl'].shape[0]} "
                                     f"records, expected {B}")
            _exact(want, got, f"sharded {name} step")
    # end to end: the two-sample cohort's block query on the mesh
    path = os.path.join(work, "cohort.vcf")
    vid = VidMapper.from_files(os.path.join(work, "vid.json"))
    vid.parse_callsets({"callsets": {
        s: {"row_idx": i, "idx_in_file": i, "filename": path}
        for i, s in enumerate(["S0", "S1"])}})
    store = import_callsets(vid)
    qp = QueryParams()
    qp.scan_full = True
    qp.attributes = []
    mesh_text = driver.run_vcf_query_block(
        store, driver.make_query_config(qp, vid), qp, vid, mesh.device,
        mesh=mesh)
    if mesh.rank == 0:
        seq_text = driver.run_vcf_query(
            store, driver.make_query_config(qp, vid), qp, vid)
        if not seq_text or mesh_text != seq_text:
            raise AssertionError("mesh block output != sequential")
        print(json.dumps({
            "ranks": mesh.size, "mesh": f"{n_pos}x{n_row}",
            "backend": mesh.backend, "device": str(mesh.device),
            "records": B, "samples": S, "text": seq_text,
            "mesh_s": mesh_s}))
    del mesh, local     # the mesh's groups go before the process group
    if device.type == "cuda":
        torch.cuda.synchronize()
    dist.destroy_process_group()


def _main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="graft_entry",
        description="One rank of dryrun_multichip.")
    ap.add_argument("--dryrun-rank", metavar="DIR", required=True,
                    help="the dryrun's directory (cohort.vcf, vid.json)")
    ap.add_argument("--mesh", required=True, help="PxR")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    n_pos, n_row = (int(x) for x in args.mesh.split("x"))
    _dryrun_rank(args.dryrun_rank, n_pos, n_row, torch.device(args.device))


if __name__ == "__main__":
    _main()
