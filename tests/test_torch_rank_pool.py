"""Rank-per-partition workers on the port: the pre-forked
`parallel.rank_pool.RankPool` and `gdb_query --parallel-ranks`, on a
4-partition import, give the in-process `--num-ranks 4` text and the JAX
tool's `--num-ranks 4` text; failures surface; and N processes that
build the kernel library at once run the compiler once (the file lock in
`ops/_kernel_build.py`).  Every subprocess has its own timeout.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from genomicsdb_tpu.tools import gdb_query as jax_gdb_query
from genomicsdb_tpu_torch.parallel.rank_pool import RankPool
from genomicsdb_tpu_torch.testing import write_cohort
from genomicsdb_tpu_torch.tools import gdb_query, vcf2gdb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RANKS = 4
TIMEOUT_S = 180


def _run(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def partitioned(c, n: int):
    """(loader, query) of an n-partition import of cohort `c` (bounds
    spread evenly over its columns), imported with the port's vcf2gdb
    one rank at a time; the query names no workspace, so each rank
    reads its partition's array from the loader."""
    bounds = np.linspace(0, c.region, n + 1).astype(int)[:-1].tolist()
    ws = os.path.join(c.dir, f"ws{n}")
    loader = os.path.join(c.dir, f"loader{n}.json")
    with open(loader, "w") as f:
        json.dump({"column_partitions": [
            {"begin": b, "workspace": ws, "array_name": f"p{i}"}
            for i, b in enumerate(bounds)],
            "callset_mapping_file": c.callsets, "vid_mapping_file": c.vid,
            "treat_deletions_as_intervals": True}, f)
    for r in range(n):
        vcf2gdb.main([loader, "--rank", str(r)])
    query = os.path.join(c.dir, f"query{n}.json")
    with open(query, "w") as f:
        json.dump({"workspace": "", "array_name": "",
                   "query_column_ranges": [{"range_list": [
                       {"low": 0, "high": c.region}]}],
                   "vid_mapping_file": c.vid,
                   "callset_mapping_file": c.callsets, "attributes": []}, f)
    return loader, query


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    c = write_cohort(str(tmp_path_factory.mktemp("ranks")), 8, 150, seed=5,
                     n_groups=2)
    return partitioned(c, N_RANKS)


POOL = r"""
import json, sys
sys.path.insert(0, %(root)r)
from genomicsdb_tpu_torch.parallel.rank_pool import RankPool
argvs = json.loads(sys.argv[1])
with RankPool(len(argvs)) as pool:
    first = pool.run(argvs)
    again = pool.run(argvs)                  # warm reuse
assert first == again
sys.stdout.write("".join(first))
"""


def test_pool_and_parallel_ranks_match_num_ranks_and_jax(parts):
    loader, query = parts
    base = ["-j", query, "-l", loader, "--produce-Broad-GVCF"]
    want = _run(gdb_query.main, base + ["--num-ranks", str(N_RANKS),
                                        "--device", "cpu"])
    assert want.count("\n") > 100
    assert want == _run(jax_gdb_query.main,
                        base + ["--num-ranks", str(N_RANKS)])
    spawned = subprocess.run(
        [sys.executable, "-m", "genomicsdb_tpu_torch.tools.gdb_query",
         *base, "--num-ranks", str(N_RANKS), "--parallel-ranks",
         "--device", "cpu"], capture_output=True, text=True,
        timeout=TIMEOUT_S, cwd=ROOT)
    assert spawned.returncode == 0, spawned.stderr[-3000:]
    assert spawned.stdout == want
    argvs = [base + ["-r", str(r), "--num-ranks", "1", "--device", "cpu"]
             + (["--no-vcf-header"] if r else []) for r in range(N_RANKS)]
    pool = subprocess.run([sys.executable, "-c", POOL % {"root": ROOT},
                           json.dumps(argvs)], capture_output=True,
                          text=True, timeout=TIMEOUT_S)
    assert pool.returncode == 0, pool.stderr[-3000:]
    assert pool.stdout == want


def test_failing_ranks_fail_the_query(parts):
    loader, query = parts
    err = r"""
import sys
sys.path.insert(0, %(root)r)
from genomicsdb_tpu_torch.parallel.rank_pool import RankPool
with RankPool(1) as pool:
    try:
        pool.run([["-j", "/nonexistent.json", "--produce-Broad-GVCF",
                   "--device", "cpu"]])
    except RuntimeError as e:
        assert "rank worker 0" in str(e)
        print("ERR-OK")
""" % {"root": ROOT}
    r = subprocess.run([sys.executable, "-c", err], capture_output=True,
                       text=True, timeout=TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "ERR-OK" in r.stdout
    with pytest.raises(SystemExit, match="--parallel-ranks failed"):
        gdb_query.main(["-j", query + ".missing", "-l", loader,
                        "--produce-Broad-GVCF", "--num-ranks", "2",
                        "--parallel-ranks", "--device", "cpu"])


def test_pool_refuses_after_cuda_init(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="before this process"):
        RankPool(1)


BUILD = r"""
import ctypes, sys
sys.path.insert(0, %(root)r)
from genomicsdb_tpu_torch.ops import _kernel_build as KB
KB.BUILD_DIR = %(build)r
KB.sources = lambda: [%(src)r]
KB._nvcc = lambda: %(nvcc)r
KB.ctypes.CDLL = lambda path: path
KB._bind = lambda lib: None
kl = KB.load_library()
print(kl.lib, kl.build_seconds > 0)
"""

STUB_NVCC = """#!/bin/sh
# stands in for nvcc: records the call, takes its time, writes -o's file
echo call >> "{counter}"
sleep 1
while [ "$#" -gt 0 ]; do
  if [ "$1" = "-o" ]; then echo lib > "$2"; fi
  shift
done
"""


@pytest.mark.parametrize("n_procs", [2, 3])
def test_processes_starting_at_once_compile_once(tmp_path, n_procs):
    counter = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(STUB_NVCC.format(counter=counter))
    nvcc.chmod(0o755)
    src = tmp_path / "k.cu"
    src.write_text("// kernel\n")
    code = BUILD % {"root": ROOT, "build": str(tmp_path / "build"),
                    "src": str(src), "nvcc": str(nvcc)}
    procs = [subprocess.Popen([sys.executable, "-c", code], text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for _ in range(n_procs)]
    deadline = time.monotonic() + TIMEOUT_S
    try:
        outs = [p.communicate(timeout=max(deadline - time.monotonic(), 1))
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, e) in zip(procs, outs):
        assert p.returncode == 0, e[-2000:]
    paths = {o.split()[0] for o, _ in outs}
    built = sorted(o.split()[1] for o, _ in outs)
    # one build: an nvcc for the one source, then the link
    assert counter.read_text().count("call") == 2
    assert len(paths) == 1 and os.path.isfile(paths.pop())
    assert built == ["False"] * (n_procs - 1) + ["True"]
