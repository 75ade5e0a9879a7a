"""The port stands alone: it imports nothing of `jax` or `genomicsdb_tpu`,
imports and queries a cohort with both blocked, writes the same store
files as the JAX package's importer, and serves every host query mode
with the JAX tool's bytes.

Objects never cross between the packages: each side loads the store,
the vid mapping and the query configuration from the same files with
its own loaders.
"""

import ast
import contextlib
import io
import os
import re
import subprocess
import sys

import pytest

from genomicsdb_tpu.tools import gdb_query as jax_gdb_query
from genomicsdb_tpu.tools import vcf2gdb as jax_vcf2gdb
from genomicsdb_tpu_torch.testing import write_cohort
from genomicsdb_tpu_torch.tools import gdb_query as torch_gdb_query
from genomicsdb_tpu_torch.tools import vcf2gdb as torch_vcf2gdb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "genomicsdb_tpu_torch")
FORBIDDEN = ("genomicsdb_tpu", "jax", "jaxlib")
# the one field of a store that differs between two imports: the
# fragment directory is named by the wall clock at write time
# (store/workspace.py, f"fragment_{time.time_ns()}")
FRAGMENT_TIME_NS = re.compile(r"fragment_\d+")


def _run(main, argv, **kw) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv, **kw)
    return buf.getvalue()


def _port_sources():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _imported_names(tree):
    """Top-level package names of every absolute import, and of every
    constant string given to importlib.import_module / __import__."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else \
                getattr(f, "id", "")
            if name in ("import_module", "__import__"):
                yield node.lineno, node.args[0].value


def test_no_source_imports_jax_or_the_jax_package():
    sources = _port_sources()
    assert len(sources) > 40
    bad = []
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for line, name in _imported_names(tree):
            if name.split(".")[0] in FORBIDDEN:
                bad.append(f"{os.path.relpath(path, ROOT)}:{line}: {name}")
    assert not bad, "\n".join(bad)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """A tiny cohort imported with the port's vcf2gdb."""
    c = write_cohort(str(tmp_path_factory.mktemp("cohort")), 8, 90, seed=4,
                     n_groups=2)
    torch_vcf2gdb.main([c.loader])
    return c


def test_import_and_query_with_jax_and_the_jax_package_blocked(tmp_path):
    """In a fresh interpreter where `import jax` and `import
    genomicsdb_tpu` fail: the port writes the cohort, imports it with its
    own vcf2gdb and queries it with its own gdb_query on the CPU; the
    text equals the JAX tool's on the store the port wrote."""
    c = write_cohort(str(tmp_path), 8, 90, seed=6, n_groups=2)
    argv = ["-j", c.query, "--produce-Broad-GVCF", "--device", "cpu"]
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['genomicsdb_tpu'] = None\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from genomicsdb_tpu_torch.tools import gdb_query, vcf2gdb\n"
        f"vcf2gdb.main([{c.loader!r}])\n"
        f"gdb_query.main({argv!r})\n"
        "assert sys.modules['jax'] is None\n"
        "assert sys.modules['genomicsdb_tpu'] is None\n"
        "assert not [m for m in sys.modules if m.startswith(("
        "'jax.', 'genomicsdb_tpu.'))]\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert len(res.stdout.splitlines()) > 100
    jax_text = _run(jax_gdb_query.main, ["-j", c.query, "--produce-Broad-GVCF",
                                         "--engine", "sequential"])
    assert res.stdout == jax_text


SERVING_MODULES = ("genomicsdb_tpu_torch.query.serving_index",
                   "genomicsdb_tpu_torch.query.stream",
                   "genomicsdb_tpu_torch.query.stream_server",
                   "genomicsdb_tpu_torch.tools.genome_bench",
                   "genomicsdb_tpu_torch.tools.stream_latency_bench")
BLOCK = ("import sys\n"
         "sys.modules['jax'] = None\n"
         "sys.modules['genomicsdb_tpu'] = None\n"
         f"sys.path.insert(0, {ROOT!r})\n")


def test_serving_modules_scanned_and_importable_with_jax_blocked(cohort):
    """The serving path's modules are in the AST scan, import in an
    interpreter where jax and genomicsdb_tpu cannot load, and serve a
    query over the socket there (CPU device, one-shot and paged)."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for mod in SERVING_MODULES:
        assert mod.replace(".", os.sep) + ".py" in scanned, mod
    doc = {"workspace": cohort.workspace, "array_name": cohort.array,
           "vid_mapping_file": cohort.vid,
           "callset_mapping_file": cohort.callsets,
           "query_column_ranges": [{"range_list": [{"low": 0,
                                                    "high": 5000}]}]}
    code = (BLOCK
            + "".join(f"import {m}\n" for m in SERVING_MODULES)
            + "from genomicsdb_tpu_torch.query import stream_server as s\n"
            "srv = s.QueryStreamServer(port=0, device='cpu')\n"
            "srv.start_background()\n"
            f"data = s.read_query_stream(*srv.address, {doc!r})\n"
            "srv.shutdown()\n"
            "assert data[:5] == b'BCF\\x02\\x02' and len(data) > 1000\n"
            "from genomicsdb_tpu_torch.tools import gdb_query\n"
            f"gdb_query.main(['-j', {cohort.query!r}, '--produce-Broad-GVCF',"
            " '--device', 'cpu', '-p', '4096'])\n"
            "assert not [m for m in sys.modules if m.startswith(("
            "'jax.', 'genomicsdb_tpu.'))]\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout == _run(torch_gdb_query.main,
                              ["-j", cohort.query, "--produce-Broad-GVCF",
                               "--device", "cpu"])


def test_stream_server_help_runs_with_jax_blocked():
    """`python -m genomicsdb_tpu_torch.query.stream_server --help` with
    jax and genomicsdb_tpu blocked."""
    code = (BLOCK + "import runpy\n"
            "sys.argv = ['stream_server', '--help']\n"
            "runpy.run_module('genomicsdb_tpu_torch.query.stream_server',"
            " run_name='__main__')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "--device" in res.stdout and "--platform" not in res.stdout


BENCH_MODULES = ("genomicsdb_tpu_torch.bench",
                 "genomicsdb_tpu_torch.graft_entry",
                 "genomicsdb_tpu_torch.tools.deletion_bench",
                 "genomicsdb_tpu_torch.tools.wide_cohort_bench",
                 "genomicsdb_tpu_torch.tools.ooc_bench")


@pytest.fixture(scope="module")
def bench_help():
    """{module: its `--help` text}, every module run as `python -m` would
    run it, in one interpreter where jax and genomicsdb_tpu are
    blocked."""
    code = (BLOCK + "import runpy\n"
            f"for m in {BENCH_MODULES!r}:\n"
            "    sys.argv = [m, '--help']\n"
            "    try:\n"
            "        runpy.run_module(m, run_name='__main__')\n"
            "    except SystemExit as e:\n"
            "        assert e.code == 0, (m, e.code)\n"
            "    sys.stdout.write('\\f')\n"
            "assert not [m for m in sys.modules if m.startswith(("
            "'jax.', 'genomicsdb_tpu.'))]\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    texts = res.stdout.split("\f")[:-1]
    assert len(texts) == len(BENCH_MODULES)
    return dict(zip(BENCH_MODULES, texts))


@pytest.mark.parametrize("module", BENCH_MODULES)
def test_bench_modules_help_with_jax_blocked(bench_help, module):
    """The port's bench, graft entry and the three bench tools are in
    the AST scan and print their `--help` where jax and genomicsdb_tpu
    cannot load; every one takes --device, none --platform."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    assert module.replace(".", os.sep) + ".py" in scanned
    text = bench_help[module]
    assert "--device" in text and "--platform" not in text


HOST_TOOL_MODULES = ("genomicsdb_tpu_torch.tools.vcfdiff",
                     "genomicsdb_tpu_torch.tools.workspace_tool",
                     "genomicsdb_tpu_torch.tools.vcf_histogram",
                     "genomicsdb_tpu_torch.tools.generate_config",
                     "genomicsdb_tpu_torch.tools.vcf_combiner",
                     "genomicsdb_tpu_torch.tools.perf_table",
                     "genomicsdb_tpu_torch.tools.cleanroom_bcf_decoder",
                     "genomicsdb_tpu_torch.examples.streaming_import_demo",
                     "genomicsdb_tpu_torch.examples.query_stream_demo",
                     "genomicsdb_tpu_torch.examples.block_engine_demo",
                     "genomicsdb_tpu_torch.examples.sharded_combine_demo")
# the other modules of the last slice, scanned and imported with jax
# blocked
HOST_MODULES = ("genomicsdb_tpu_torch.store.streaming_import",
                "genomicsdb_tpu_torch.core.pb_config",
                "genomicsdb_tpu_torch.core.pb_compat",
                "genomicsdb_tpu_torch.protos")


@pytest.fixture(scope="module")
def host_tool_help():
    """{module: its `--help` text}, every host tool and demo run as
    `python -m` would run it, in one interpreter where jax and
    genomicsdb_tpu are blocked (the other new modules imported there
    too)."""
    code = (BLOCK + "import runpy\n"
            + "".join(f"import {m}\n" for m in HOST_MODULES)
            + f"for m in {HOST_TOOL_MODULES!r}:\n"
            "    sys.argv = [m, '--help']\n"
            "    try:\n"
            "        runpy.run_module(m, run_name='__main__')\n"
            "    except SystemExit as e:\n"
            "        assert e.code in (0, None), (m, e.code)\n"
            "    sys.stdout.write('\\f')\n"
            "assert not [m for m in sys.modules if m.startswith(("
            "'jax.', 'genomicsdb_tpu.'))]\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    texts = res.stdout.split("\f")[:-1]
    assert len(texts) == len(HOST_TOOL_MODULES)
    return dict(zip(HOST_TOOL_MODULES, texts))


@pytest.mark.parametrize("module", HOST_TOOL_MODULES)
def test_host_tools_and_demos_help_with_jax_blocked(host_tool_help, module):
    """The port's host tools and demos are in the AST scan and print
    their usage for `--help` where jax and genomicsdb_tpu cannot load;
    the demos that run on a device take --device."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for mod in HOST_MODULES:
        path = mod.replace(".", os.sep)
        assert path + ".py" in scanned or \
            os.path.join(path, "__init__.py") in scanned, mod
    assert module.replace(".", os.sep) + ".py" in scanned
    text = host_tool_help[module]
    assert "usage" in text.lower() and "--platform" not in text
    name = module.rsplit(".", 1)[1]
    assert name in text or "python -m" in text
    if name in ("query_stream_demo", "block_engine_demo",
                "sharded_combine_demo"):
        assert "--device" in text


LAZY_API = {
    "VidMapper": "genomicsdb_tpu_torch.core.vid",
    "QueryParams": "genomicsdb_tpu_torch.core.config",
    "ImportParams": "genomicsdb_tpu_torch.core.config",
    "import_callsets": "genomicsdb_tpu_torch.store.import_pipeline",
    "StreamingImporter": "genomicsdb_tpu_torch.store.streaming_import",
    "FeatureReader": "genomicsdb_tpu_torch.query.stream",
    "CombinedRecordStream": "genomicsdb_tpu_torch.query.stream",
    "driver": "genomicsdb_tpu_torch.query.driver",
}


def test_lazy_top_level_api_resolves_to_the_ports_objects():
    """The JAX package's eight top-level names, each the port's object;
    importing the package loads none of them, with jax blocked."""
    import importlib
    import genomicsdb_tpu_torch as port
    for name, mod in LAZY_API.items():
        m = importlib.import_module(mod)
        want = m if name == "driver" else getattr(m, name)
        assert getattr(port, name) is want, name
    with pytest.raises(AttributeError, match="no attribute 'combine'"):
        port.combine
    code = (BLOCK + "import genomicsdb_tpu_torch as g\n"
            "assert not [m for m in sys.modules if m.startswith("
            "'genomicsdb_tpu_torch.')]\n"
            f"for n in {sorted(LAZY_API)!r}:\n"
            "    getattr(g, n)\n"
            "print(g.StreamingImporter.__module__)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == LAZY_API["StreamingImporter"]


PARALLEL_MODULES = ("genomicsdb_tpu_torch.parallel.comm",
                    "genomicsdb_tpu_torch.parallel.sharded",
                    "genomicsdb_tpu_torch.parallel.multihost",
                    "genomicsdb_tpu_torch.parallel.rank_pool",
                    "genomicsdb_tpu_torch.parallel.spark_api",
                    "genomicsdb_tpu_torch.parallel.local_spark",
                    "genomicsdb_tpu_torch.parallel.repartition",
                    "genomicsdb_tpu_torch.query.serialize",
                    "genomicsdb_tpu_torch.tools.scaling_bench")


def test_distribution_runs_with_jax_blocked(cohort, tmp_path):
    """The distribution modules are in the AST scan and import where jax
    and genomicsdb_tpu cannot load; there `gdb_query --mesh 2x2` and
    `--parallel-ranks` (a 2-partition loader) run on the CPU and give
    the unsharded, in-process texts."""
    import json
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for mod in PARALLEL_MODULES:
        assert mod.replace(".", os.sep) + ".py" in scanned, mod
    loader = str(tmp_path / "loader2.json")
    with open(loader, "w") as f:
        json.dump({"column_partitions": [
            {"begin": b, "workspace": str(tmp_path / "ws2"),
             "array_name": f"p{i}"}
            for i, b in enumerate((0, cohort.region // 2))],
            "callset_mapping_file": cohort.callsets,
            "vid_mapping_file": cohort.vid,
            "treat_deletions_as_intervals": True}, f)
    query = str(tmp_path / "query2.json")
    with open(query, "w") as f:
        json.dump({"workspace": "", "array_name": "",
                   "query_column_ranges": [{"range_list": [
                       {"low": 0, "high": cohort.region}]}],
                   "vid_mapping_file": cohort.vid,
                   "callset_mapping_file": cohort.callsets,
                   "attributes": []}, f)
    mesh = ["-j", cohort.query, "--produce-Broad-GVCF", "--device", "cpu",
            "--mesh", "2x2"]
    ranks = ["-j", query, "-l", loader, "--produce-Broad-GVCF", "--device",
             "cpu", "--num-ranks", "2", "--parallel-ranks"]
    code = (BLOCK
            + "".join(f"import {m}\n" for m in PARALLEL_MODULES)
            + "from genomicsdb_tpu_torch.tools import gdb_query, vcf2gdb\n"
            f"vcf2gdb.main([{loader!r}, '--rank', '0'])\n"
            f"vcf2gdb.main([{loader!r}, '--rank', '1'])\n"
            f"gdb_query.main({mesh!r})\n"
            "sys.stdout.write('\\f')\n"
            f"gdb_query.main({ranks!r})\n"
            "assert not [m for m in sys.modules if m.startswith(("
            "'jax.', 'genomicsdb_tpu.'))]\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    got_mesh, got_ranks = res.stdout.split("\f")
    assert got_mesh == _run(torch_gdb_query.main, mesh[:-2])
    assert got_ranks.count("\n") > 100
    assert got_ranks == _run(torch_gdb_query.main, ranks[:-1])


def _store_files(workspace):
    """{path relative to the workspace, fragment time masked: bytes}."""
    out = {}
    for d, _, files in os.walk(workspace):
        for f in files:
            path = os.path.join(d, f)
            rel = FRAGMENT_TIME_NS.sub("fragment_<time_ns>",
                                       os.path.relpath(path, workspace))
            with open(path, "rb") as fh:
                out[rel] = fh.read()
    return out


def test_port_vcf2gdb_writes_the_jax_package_store(tmp_path):
    """The same cohort imported by each package's vcf2gdb gives the same
    store, file by file and byte for byte; only the fragment directory's
    name (its write time in ns) is masked."""
    a = write_cohort(str(tmp_path / "jax"), 8, 90, seed=4, n_groups=2)
    b = write_cohort(str(tmp_path / "port"), 8, 90, seed=4, n_groups=2)
    jax_vcf2gdb.main([a.loader])
    torch_vcf2gdb.main([b.loader])
    ref, got = _store_files(a.workspace), _store_files(b.workspace)
    assert len(ref) > 30
    assert any("fragment_<time_ns>" in k for k in ref)
    assert sorted(ref) == sorted(got)
    for rel in ref:
        assert ref[rel] == got[rel], rel


# every mode the port's gdb_query serves on the host, and the sequential
# engine; the JAX tool runs the same command line
HOST_MODES = {
    "calls": ["--print-calls"],
    "csv": ["--print-csv"],
    "allele_count": ["--print-AC"],
    "interesting_positions": ["--produce-interesting-positions"],
    "histogram": ["--produce-histogram", "--bin-size", "500",
                  "--num-equi-bins", "4"],
    "variants": [],
    "cotton_json": ["-O", "Cotton-JSON"],
    "positions_json": ["-O", "Positions-JSON"],
    "sequential": ["--produce-Broad-GVCF", "--engine", "sequential"],
    "java_vcf": ["--produce-Broad-GVCF", "--java-vcf"],
}


@pytest.mark.parametrize("mode", sorted(HOST_MODES))
def test_host_mode_equals_the_jax_tool(cohort, mode):
    argv = ["-j", cohort.query_head] + HOST_MODES[mode]
    port = _run(torch_gdb_query.main, argv + ["--device", "cpu"])
    ref = _run(jax_gdb_query.main, argv)
    assert port.strip()
    assert port == ref
