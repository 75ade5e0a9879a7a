"""Sharded combine demo on a ("pos", "row") mesh of rank processes.

The production layout: genome positions (a block's records) shard like
the reference's MPI column partitions over the "pos" axis, samples over
the "row" axis, with the cross-sample INFO reductions all-gathered over
the row group (`parallel/sharded.py`).  Run without a launcher, the
demo starts its 4 x 2 = 8 rank processes itself, as `torchrun` would
(gloo on the CPU, and gloo when the ranks share one card); run under a
launcher's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), it
is one rank.  The first rank gathers the shards' outputs and prints the
combined block's shape and a SHA-256 over its arrays, which equals
`digest` of the unsharded `combine_step` on the same block.

    python -m genomicsdb_tpu_torch.examples.sharded_combine_demo [--device cuda]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

from ..device import resolve_device
from ..ops.cell_block import synthesize_cohort

N_POS, N_ROW = 4, 2


def demo_block():
    """The demo's block: the JAX demo's synthetic cohort."""
    return synthesize_cohort(num_samples=8, cells_per_sample=64,
                             region_len=4096, seed=7)


def digest(outputs) -> str:
    """SHA-256 over the outputs' names, dtypes, shapes and bytes (floats
    by their bits, NaN included)."""
    h = hashlib.sha256()
    for k in sorted(outputs):
        a = np.ascontiguousarray(outputs[k])
        h.update(f"{k}:{a.dtype.str}:{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def run_rank(device) -> None:
    """This process as one rank of the N_POS x N_ROW mesh; its report
    line (`gdb_query.REPORT`: rank, device, backend, blocks, kernel
    launches) goes to stderr."""
    import torch.distributed as dist
    from ..ops import fused_combine as FC
    from ..parallel.sharded import gather_outputs, make_mesh, mesh_combine
    from ..tools.gdb_query import REPORT
    mesh = make_mesh(N_POS, N_ROW, device)
    try:
        blk = demo_block()
        B, S = np.asarray(blk.live).shape
        out = mesh_combine(mesh, blk, max_merged=4, ploidy=2)
        res = gather_outputs(mesh, out, B, S)
        where = f"{mesh.device} [{mesh.backend}]"
        report = {"rank": mesh.rank, "device": str(mesh.device),
                  "backend": mesh.backend, "blocks": mesh_combine.blocks,
                  "general_path_blocks": mesh_combine.general_path_blocks,
                  "launches": FC.fused_gather_remap.launches}
    finally:
        # the DeviceMesh's groups go before the process group
        del mesh
        dist.destroy_process_group()
    print(REPORT + json.dumps(report), file=sys.stderr)
    if res is not None:
        print(f"mesh=({N_POS} pos x {N_ROW} row) on {where}, combined "
              f"block: pl{list(res['pl'].shape)}, "
              f"{int((res['dp_info_sum'] > 0).sum())} records with INFO DP")
        print(f"outputs sha256 {digest(res)}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=f"The combine of a synthetic block on a {N_POS} x "
                    f"{N_ROW} mesh of rank processes.")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the ranks ('cuda' default: "
                         "rank r on card r mod the card count; or 'cpu')")
    argv = list(argv) if argv is not None else sys.argv[1:]
    device = resolve_device(ap.parse_args(argv).device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        run_rank(device)
        return
    from ..tools.gdb_query import spawn_mesh
    sys.stdout.write(spawn_mesh(argv, N_POS * N_ROW, module=__spec__.name))


if __name__ == "__main__":
    main()
