"""The port's copies of the three jax-pinned bench tools
(`genomicsdb_tpu_torch.tools.deletion_bench`, `wide_cohort_bench`,
`ooc_bench`) on the CPU at tiny sizes: each runs its own checks (engine
against sequential, chunk invariance), prints the JAX tool's JSON keys,
and writes the JAX tool's cohort bytes; each refuses `--device cuda`
where no card is visible, as the port's bench and graft entry do."""

import ast
import contextlib
import io
import json
import os

import pytest
import torch

from genomicsdb_tpu.core import vid as jax_vid
from genomicsdb_tpu.tools import deletion_bench as JD
from genomicsdb_tpu.tools import ooc_bench as JO
from genomicsdb_tpu.tools import wide_cohort_bench as JW
from genomicsdb_tpu_torch.tools import deletion_bench as TD
from genomicsdb_tpu_torch.tools import ooc_bench as TO
from genomicsdb_tpu_torch.tools import wide_cohort_bench as TW


def _json_keys(module, func: str):
    """The keys of the dict literal a JAX tool's `func` prints: the
    argument of json.dumps, or the dict assigned to `out`."""
    tree = ast.parse(open(module.__file__).read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == func)
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(getattr(t, "id", None) == "out"
                        for t in node.targets):
            return {k.value for k in node.value.keys}
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "dumps" and isinstance(node.args[0], ast.Dict):
            return {k.value for k in node.args[0].keys}
    raise AssertionError(f"no printed dict in {module.__name__}.{func}")


def _main(main, argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = main(argv)
    printed = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert printed == ret
    return printed


TOOLS = {
    "deletion_bench": (TD, JD, "main", ["--samples", "8", "--records",
                                        "100"]),
    "wide_cohort_bench": (TW, JW, "run", ["--samples", "16", "--records",
                                          "200", "--windows", "1"]),
    "ooc_bench": (TO, JO, "main", ["--target-bytes", "2e6"]),
}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_runs_on_the_cpu_with_the_jax_keys(tool):
    port, jax_tool, func, argv = TOOLS[tool]
    out = _main(port.main, argv + ["--device", "cpu"])
    assert set(out) == _json_keys(jax_tool, func)
    if tool == "wide_cohort_bench":
        assert out["seq_windows_verified"] == 1 and out["lines"] > 100
    elif tool == "deletion_bench":
        assert out["records_out"] > 100
    else:
        assert out["windows"] >= 1 and out["records"] > 1000


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_refuses_cuda_without_a_card(tool, monkeypatch):
    port, _, _, argv = TOOLS[tool]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="not available"):
        port.main(argv + ["--device", "cuda"])


class _NoVid(Exception):
    pass


def _refuse_vid(*a, **k):
    raise _NoVid


def test_cohorts_are_the_jax_tools_bytes(tmp_path, monkeypatch):
    for name, (port_fn, jax_fn, args) in {
            "del": (TD.make_cohort, JD.make_cohort, (8, 100)),
            "wide": (TW.make_wide_cohort, JW.make_wide_cohort, (16, 200)),
    }.items():
        a, b = tmp_path / f"{name}_jax.vcf", tmp_path / f"{name}_port.vcf"
        assert jax_fn(str(a), *args) == port_fn(str(b), *args)
        assert a.read_bytes() == b.read_bytes()
    # the JAX out-of-core template is written, then the JAX tool would
    # read the reference's vid: stopped there
    monkeypatch.setattr(jax_vid.VidMapper, "from_files",
                        classmethod(_refuse_vid))
    jdir = tmp_path / "ooc_jax"
    jdir.mkdir()
    with pytest.raises(_NoVid):
        JO._template_cohort(str(jdir))
    pos = TO.write_template_vcf(str(tmp_path / "ooc_port.vcf"))
    assert (jdir / "template.vcf").read_bytes() \
        == (tmp_path / "ooc_port.vcf").read_bytes()
    assert pos > 2000
