"""The port's bench lanes (`genomicsdb_tpu_torch.bench`) on the CPU at
small shapes (8 samples x 64 cells x 4,096 positions), held to the JAX
package: the device lanes' checksums over the block's records equal the
checksum of the JAX `combine_step` (and `combine_step_dense`) on the
same synthetic block, the narrow kernel's equals the wide one's, the
native sequential baseline's equals the JAX bench lane's, and the
result lines carry the JAX bench's keys.  The lanes' cohorts are the
JAX lanes' bytes."""

import ast
import json
import os

import numpy as np
import pytest
import torch

import bench as jax_bench
from genomicsdb_tpu.core import vid as jax_vid
from genomicsdb_tpu.ops import combine_step as JC
from genomicsdb_tpu_torch import bench as TB

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {
    "bench_small": dict(num_samples=8, cells_per_sample=64, region_len=4096),
    "wide_small": dict(num_samples=16, cells_per_sample=32,
                       region_len=2048),
}


def _jax_checksum(out) -> int:
    """The JAX lanes' int32-wraparound checksum of a JAX output dict."""
    s = sum(int(np.asarray(out[k]).astype(np.int32).sum(dtype=np.int64))
            for k in ("pl", "ad", "dp_info_sum"))
    return (s + 2 ** 31) % 2 ** 32 - 2 ** 31


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_device_lanes_checksums_equal_jax(shape):
    kw = SHAPES[shape]
    blk = JC.synthesize_cohort(seed=0, **kw)
    want = _jax_checksum(JC.combine_step(*JC.block_to_args(blk),
                                         max_merged=4, ploidy=2))
    g = JC.gather_block_host(blk, blk.live)
    dense_want = _jax_checksum(JC.combine_step_dense(
        *(g[k] for k in ("plg", "invg", "pllg", "nrg", "adg", "adlg", "gtg",
                         "gqg", "dpfg", "mdpg", "dpig", "infog", "infoig",
                         "infofsg", "valid")),
        blk.rec_num_merged, max_merged=4, ploidy=2))
    cpu = torch.device("cpu")
    # chunks smaller than the block, so that the lanes walk several
    dev = TB.bench_device(cpu, chunk=128, reps=1, **kw)
    fused = TB.bench_device_fused(cpu, chunk=128, reps=1, **kw)
    dense = TB.bench_device_dense(cpu, chunk=8192, reps=1, **kw)
    assert dev["records"] == len(blk.starts) > 128
    assert dev["checksum"] == fused["checksum"] == want
    assert fused["narrow"]["checksum"] == fused["checksum"]
    assert dense["checksum"] == dense_want == want
    assert dense["records"] == len(blk.starts)


def test_wide_1024_lane_reports_cells_per_sec():
    kw = SHAPES["wide_small"]
    out = TB.bench_device_fused_wide_1024(torch.device("cpu"), reps=1, **kw)
    assert out["samples"] == 16
    assert out["cells_per_sec"] == out["records_per_sec"] * 16


def test_cpp_baseline_checksum_equals_the_jax_lane():
    kw = SHAPES["bench_small"]
    got = TB.bench_cpp_baseline(**kw)
    ref = jax_bench.bench_cpp_baseline(**kw)
    assert ref is not None
    assert got["checksum"] == ref["checksum"]
    assert got["records"] == ref["records"]
    assert set(got) == set(ref)


class _NoVid(Exception):
    pass


def _refuse_vid(*a, **k):
    raise _NoVid


def test_host_lanes_and_their_cohorts(tmp_path, monkeypatch):
    """The import and end-to-end lanes at small sizes; their VCFs are the
    JAX lanes' bytes (the JAX lane is stopped where it would read the
    reference's vid, after writing its VCF)."""
    imp = TB.bench_import(n_records=300, n_samples=4)
    assert imp["cells"] == imp["asa"]["cells"] == 1200
    assert imp["native_cells_per_sec"] > 0
    e2e = TB.bench_cohort_end_to_end(torch.device("cpu"), n_samples=6,
                                     n_records=200)
    assert e2e["vcf_text_records"] > 100
    monkeypatch.setattr(jax_vid.VidMapper, "from_files",
                        classmethod(_refuse_vid))
    jdir = tmp_path / "jax"
    jdir.mkdir()
    with pytest.raises(_NoVid):
        jax_bench.bench_cohort_end_to_end(6, 200, tmpdir=str(jdir))
    TB.write_cohort100(str(tmp_path / "port.vcf"), 6, 200)
    assert (jdir / "bench_cohort100.vcf").read_bytes() \
        == (tmp_path / "port.vcf").read_bytes()


def _dict_keys(func: str, target: str, sub=None):
    """The keys of the dict literal assigned to `target` in bench.py's
    `func` (of its value under key `sub`, when given)."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == func)
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(getattr(t, "id", None) == target
                        for t in node.targets):
            d = node.value
            if sub is not None:
                d = next(v for k, v in zip(d.keys, d.values)
                         if k.value == sub)
            return {k.value for k in d.keys}
    raise AssertionError(f"no {target} dict in {func}")


def test_result_lines_carry_the_jax_keys():
    small = dict(SHAPES["bench_small"], reps=1)
    sizes = {"device": small, "device_fused": small,
             "oracle": dict(num_samples=8, cells_per_sample=16,
                            region_len=1024),
             "cpp_sequential_baseline": SHAPES["bench_small"]}
    detail = TB.run_lanes("cpu", list(sizes), sizes)
    full = TB.result_line(detail, TB.card("cpu"))
    assert set(full) - {"card"} == _dict_keys("_bench_impl", "line")
    # the JAX detail's keys (its chip lane is added by its _emit)
    jax_detail = _dict_keys("_bench_impl", "line", "detail") | {"chip_lane"}
    assert set(full["detail"]) == {
        "device", "device_fused_pallas", "oracle_positions_per_sec",
        "vs_python_oracle", "cpp_sequential_baseline"}
    assert {key for key, _ in TB.LANES.values()} - {"oracle"} <= jax_detail
    assert "oracle_positions_per_sec" in jax_detail
    assert full["value"] == max(detail["device"]["positions_per_sec"],
                                detail["device_fused_pallas"]
                                ["positions_per_sec"])
    assert full["vs_baseline"] == full["value"] / detail[
        "cpp_sequential_baseline"]["positions_per_sec"]
    compact = TB.compact_line(full, "bench.json")
    assert set(compact) - {"card"} == _dict_keys("_emit", "compact")
    with pytest.raises(ValueError, match="unknown lanes"):
        TB.run_lanes("cpu", ["device_fused_pallas"])


def test_main_writes_the_full_line_under_out(tmp_path, capsys,
                                            monkeypatch):
    out = tmp_path / "bench.json"
    monkeypatch.setitem(TB.LANES, "cpp_sequential_baseline", (
        "cpp_sequential_baseline",
        lambda device: TB.bench_cpp_baseline(**SHAPES["bench_small"])))
    compact = TB.main(["--device", "cpu", "--lanes", "cpp_sequential_baseline",
                       "--out", str(out)])
    full = json.loads(out.read_text())
    assert full["card"] == "cpu" and full["value"] is None
    assert set(full["detail"]) == {"cpp_sequential_baseline"}
    assert compact["detail_file"] == str(out)
    assert json.loads(capsys.readouterr().out.strip()) == compact
