"""The cells on the card, each run as the benchmark's command runs it,
for a 20 s window: long enough for the lookups a run checks (`python
-m pytest -m gpu gdb_bench/tests` on a machine with an NVIDIA card)."""

import json
import subprocess
import sys

import pytest

from gdb_bench import manifest

BENCH = manifest.load()


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_correct_on_the_card(cell):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "gdb_bench.run", "--workload", cell,
         "--seed", str(2 ** 31 + 21), "--seconds", "20", "--trace", "0"],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res
    assert res["device"]["platform"] == "gpu"


def test_no_result_without_a_card():
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run(
        [sys.executable, "-m", "gdb_bench.run", "--workload",
         BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1"],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
