"""Process-scaling benchmark on the port (counterpart of
`genomicsdb_tpu.tools.scaling_bench`): strong scaling of the combined
gVCF query across real worker PROCESSES — the reference's execution
model (one MPI rank per column partition, vcf2tiledb.cc:44-52; root
gather, gt_mpi_gather.cc:166-295) — with every worker's block engine on
one torch device.

For K in {1, 2, 4}: the genome axis is split into K column partitions
at record starts, each imported by its own `vcf2gdb --rank r` process,
then the whole-genome query runs in two models:

  spawn  one `gdb_query --num-ranks K --parallel-ranks` process, which
         starts K rank workers and gathers their stdout (each worker
         pays interpreter start-up, imports and its CUDA context)
  pool   a warm `parallel.rank_pool.RankPool` of K forked workers (the
         first pass, which creates each worker's CUDA context and loads
         the kernels, is not timed)

Outputs must be byte-identical across K and models.  Efficiency =
T(1) / (K * T(K)).  On a CUDA device the spawned workers run on
cuda:(i % cards) and the pool's on the default card (this process asks
nothing of CUDA before the pool forks): on a one-card machine all K
share cuda:0.  The serving index is off (this measures the engine).
No worker is pinned to a core.

Usage: python -m genomicsdb_tpu_torch.tools.scaling_bench [--records N]
           [--samples N] [--ranks 1,2,4] [--device cuda|cpu]
Prints one JSON line; the device's name and count are read after the
pools have closed (the pool forks before this process touches CUDA).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

from .gdb_query import child_env
from .genome_bench import make_cohort, write_vid


def _write_cohort(td: str, samples: int, records: int):
    vcf_path = os.path.join(td, "cohort.vcf")
    region = make_cohort(vcf_path, samples, records)
    vid_file = os.path.join(td, "vid.json")
    write_vid(vid_file)
    callset_file = os.path.join(td, "callsets.json")
    with open(callset_file, "w") as f:
        json.dump({"callsets": {
            f"S{i}": {"row_idx": i, "idx_in_file": i,
                      "filename": vcf_path}
            for i in range(samples)}}, f)
    return region, vid_file, callset_file


def _record_starts(vcf_path: str):
    starts = []
    with open(vcf_path, "rb") as f:
        for line in f:
            if line[:1] == b"#":
                continue
            starts.append(int(line.split(b"\t", 2)[1]))
    return starts


def _loader_json(td: str, k: int, starts, vid_file: str,
                 callset_file: str) -> str:
    # partition boundaries fall ON record starts (the cohort tiles the
    # axis contiguously), so no record spans a boundary and the K-rank
    # concatenation is byte-identical to the single-partition output
    ws = os.path.join(td, f"ws_{k}")
    parts = []
    for i in range(k):
        begin = starts[(len(starts) * i) // k] - 1   # 0-based column
        parts.append({"begin": begin if i else 0, "workspace": ws,
                      "array_name": f"p{i}"})
    doc = {"column_partitions": parts,
           "callset_mapping_file": callset_file,
           "vid_mapping_file": vid_file,
           "treat_deletions_as_intervals": True}
    path = os.path.join(td, f"loader_{k}.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def _query_json(td: str, vid_file: str, callset_file: str) -> str:
    doc = {"workspace": "", "array_name": "",
           "query_column_ranges": [
               {"range_list": [{"low": 0, "high": 2**60}]}],
           "vid_mapping_file": vid_file,
           "callset_mapping_file": callset_file,
           "attributes": []}
    path = os.path.join(td, "query.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def _import_partitions(loader: str, k: int, env) -> float:
    """K concurrent vcf2gdb worker processes, one per partition (the
    reference's mpirun import)."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "genomicsdb_tpu_torch.tools.vcf2gdb", loader,
         "--rank", str(r)], stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, env=env) for r in range(k)]
    for p in procs:
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"vcf2gdb failed: "
                               f"{err.decode(errors='replace')[-400:]}")
    return time.perf_counter() - t0


def _spawn_query(k: int, query: str, loader: str, device, env):
    """(wall seconds, output bytes) of one `gdb_query --parallel-ranks`
    run over K partitions."""
    cmd = [sys.executable, "-m", "genomicsdb_tpu_torch.tools.gdb_query",
           "-j", query, "-l", loader, "--num-ranks", str(k),
           "--produce-Broad-GVCF", "--device", device.type]
    if k > 1:
        cmd.append("--parallel-ranks")
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, env=env)
    dt = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"gdb_query K={k} failed: "
                           f"{res.stderr.decode(errors='replace')[-2000:]}")
    return dt, res.stdout


def _pool_query(k: int, query: str, loader: str, device, runs: int = 2):
    """(best wall seconds, output bytes) of the whole-genome query
    against a warm rank pool: the first pass creates each worker's CUDA
    context and loads the kernels (excluded — a serving pool is
    long-lived); later passes are the measured quantity."""
    from ..parallel.rank_pool import RankPool
    argvs = []
    for r in range(k):
        argv = ["-j", query, "-l", loader, "-r", str(r),
                "--num-ranks", "1", "--produce-Broad-GVCF",
                "--device", device.type]
        if r > 0:
            argv.append("--no-vcf-header")
        argvs.append(argv)
    with RankPool(k) as pool:
        pool.run(argvs)                       # warm: contexts, kernels
        best = None
        out = b""
        for _ in range(runs):
            t0 = time.perf_counter()
            pieces = pool.run(argvs)
            dt = time.perf_counter() - t0
            out = "".join(pieces).encode()
            best = dt if best is None else min(best, dt)
    return best, out


def run(samples=8, records=300_000, ranks=(1, 2, 4), device="cuda",
        warm=True):
    # no CUDA query in this process before the pools fork (even asking
    # for the card count marks a forked child as unable to use CUDA):
    # every worker resolves the device itself and fails without a card
    import torch
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device} (use cuda or cpu)")
    td = tempfile.mkdtemp(prefix="scaling_")
    # this lane measures ENGINE scaling: repeated warm queries must not
    # flip to the materialized serving index (query/serving_index.py);
    # forked pool workers inherit os.environ
    os.environ["GENOMICSDB_TPU_SERVING_INDEX"] = "0"
    env = child_env()
    try:
        region, vid_file, callset_file = _write_cohort(
            td, samples, records)
        rec_starts = _record_starts(os.path.join(td, "cohort.vcf"))
        # per-process fixed overhead: interpreter + imports
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c",
                        "import genomicsdb_tpu_torch.query.driver"],
                       check=True, env=env)
        overhead_s = time.perf_counter() - t0
        query = _query_json(td, vid_file, callset_file)
        results = {}
        checks = set()
        for k in ranks:
            loader = _loader_json(td, k, rec_starts, vid_file,
                                  callset_file)
            import_s = _import_partitions(loader, k, env)
            best, out = None, b""
            for _ in range(2 if warm else 1):
                dt, out = _spawn_query(k, query, loader, device, env)
                best = dt if best is None else min(best, dt)
            checks.add(hashlib.sha256(out).hexdigest()[:16])
            pool_best, pool_out = _pool_query(k, query, loader, device)
            if hashlib.sha256(pool_out).hexdigest()[:16] not in checks:
                raise RuntimeError("rank-pool output differs from the "
                                   "spawned model")
            results[k] = {"import_s": import_s, "query_wall_s": pool_best,
                          "spawn_wall_s": best,
                          "spawn_compute_s": best - overhead_s}
        if len(checks) != 1:
            raise RuntimeError(f"outputs differ across rank counts: "
                               f"{checks}")
        k0 = min(ranks)
        t1 = results[k0]["query_wall_s"]
        t1s = results[k0]["spawn_wall_s"]
        for k in ranks:
            scale = k / k0
            results[k]["speedup"] = t1 / results[k]["query_wall_s"]
            results[k]["efficiency_pct"] = \
                100 * t1 / (scale * results[k]["query_wall_s"])
            results[k]["efficiency_spawn_pct"] = \
                100 * t1s / (scale * results[k]["spawn_wall_s"])
        dev = {"device": str(device)}
        if device.type == "cuda":
            dev.update(name=torch.cuda.get_device_name(0),
                       count=torch.cuda.device_count())
        return {"samples": samples, "records": records,
                "positions": region, "checksum": checks.pop(),
                "output_bytes": len(out),
                "proc_overhead_s": overhead_s, **dev,
                "ranks": {str(k): results[k] for k in ranks}}
    finally:
        import shutil
        shutil.rmtree(td, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="scaling_bench")
    ap.add_argument("--samples", type=int, default=8)
    ap.add_argument("--records", type=int, default=300_000)
    ap.add_argument("--ranks", default="1,2,4")
    ap.add_argument("--device", default="cuda",
                   help="torch device of every worker's block engine "
                        "('cuda' default, or 'cpu')")
    ap.add_argument("--cold", action="store_true",
                    help="single timed spawn run per K (default: best of 2)")
    args = ap.parse_args(argv)
    ranks = tuple(int(x) for x in args.ranks.split(","))
    print(json.dumps(run(args.samples, args.records, ranks, args.device,
                         warm=not args.cold)))


if __name__ == "__main__":
    sys.exit(main())
