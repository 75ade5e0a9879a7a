"""Nothing the benchmark runs imports jax or the JAX package, and its
yardstick imports nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

from gdb_bench import manifest

FORBIDDEN = ("jax", "jaxlib", "flax", "genomicsdb_tpu")
YARDSTICK = ("reference.py", "bcf.py", "cohort.py", "traffic.py",
             "roofline.py")

CHILD = r"""
import importlib.abc, json, sys, time
BLOCKED = {blocked!r}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
import glob, os
import gdb_bench.run as run
import gdb_bench.clients, gdb_bench.bcf, gdb_bench.drivers
import genomicsdb_tpu_torch.query.stream_server
from gdb_bench import manifest
bench = manifest.load()
for m in bench["per_layer"]:
    manifest.metric_module(m["name"])
lookup = dict(name="human1000.interval_engine", config="human_1000",
              traffic="lookup10kb_engine", chips=1)
for cell in (manifest.workload(bench, "human1000.scatter_combine"), lookup):
    cfg = manifest.config(bench, cell["config"])
    cfg["generator"] = dict(cfg["generator"], n_samples=8, n_records=60)
    res = run.run_cell(bench, cell, 3, 0.5, True, "cpu",
                       time.perf_counter(), cfg=cfg)
    assert res["attempted"] > 0 and res["failed"] == 0, res
print(json.dumps(run.forbidden_modules()))
"""


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax():
    for path in glob.glob(os.path.join(manifest.BENCH_DIR, "**", "*.py"),
                          recursive=True):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_yardstick_imports_nothing_of_the_program():
    for f in YARDSTICK:
        for name in _imports(os.path.join(manifest.BENCH_DIR, f)):
            assert name.split(".")[0] != "genomicsdb_tpu_torch", (f, name)


def test_whole_import_graph_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=manifest.ROOT)
    out = subprocess.run(
        [sys.executable, "-c", CHILD.format(blocked=FORBIDDEN)],
        cwd=manifest.ROOT, env=env, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
