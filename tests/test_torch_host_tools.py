"""The port's host tools against the JAX package's, on seeded cohorts:
`vcfdiff`, `workspace_tool`, `vcf_histogram` (with `vcf2gdb
--split-files`), `generate_config`, `vcf_combiner`,
`cleanroom_bcf_decoder` and `perf_table`.

Every tool runs on each side from the same input files into outputs of
its own; outputs are compared exactly (bytes, printed text, equal
lists).  Stores are compared as files with the fragment directory's
time-stamped name masked.
"""

import ast
import contextlib
import io
import json
import os
import re
import shutil

import pytest

from genomicsdb_tpu.tools import cleanroom_bcf_decoder as jcr
from genomicsdb_tpu.tools import generate_config as jgen
from genomicsdb_tpu.tools import perf_table as jperf
from genomicsdb_tpu.tools import vcf2gdb as jvcf2gdb
from genomicsdb_tpu.tools import vcf_combiner as jcomb
from genomicsdb_tpu.tools import vcf_histogram as jhist
from genomicsdb_tpu.tools import vcfdiff as jdiff
from genomicsdb_tpu.tools import workspace_tool as jwst
from genomicsdb_tpu_torch.testing import write_cohort
from genomicsdb_tpu_torch.tools import cleanroom_bcf_decoder as cr
from genomicsdb_tpu_torch.tools import (generate_config, perf_table,
                                        vcf2gdb, vcf_combiner,
                                        vcf_histogram, vcfdiff,
                                        workspace_tool)

from test_torch_standalone import _store_files

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _out(main, argv):
    """(return value, stdout) of a tool's main."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    return write_cohort(str(tmp_path_factory.mktemp("cohort")), 10, 120,
                        seed=12, n_groups=2)


# ---------------------------------------------------------------- vcfdiff

def _gidx(j, k):
    j, k = min(j, k), max(j, k)
    return k * (k + 1) // 2 + j


def _swap_alts(line):
    """The record with its first two ALT alleles swapped and AD, PL and
    GT remapped to match (the same calls, another allele order)."""
    cols = line.split("\t")
    alts = cols[4].split(",")
    n = len(alts) + 1
    perm = list(range(n))
    perm[1], perm[2] = 2, 1
    cols[4] = ",".join([alts[1], alts[0]] + alts[2:])
    keys = cols[8].split(":")
    for s in range(9, len(cols)):
        vals = dict(zip(keys, cols[s].split(":")))
        a1, a2 = (int(x) for x in vals["GT"].split("/"))
        vals["GT"] = "/".join(map(str, sorted((perm[a1], perm[a2]))))
        ad = vals["AD"].split(",")
        vals["AD"] = ",".join(ad[perm.index(i)] for i in range(n))
        pl = vals["PL"].split(",")
        new = [None] * len(pl)
        for k in range(n):
            for j in range(k + 1):
                new[_gidx(perm[j], perm[k])] = pl[_gidx(j, k)]
        vals["PL"] = ",".join(new)
        cols[s] = ":".join(vals[k] for k in keys)
    return "\t".join(cols)


def _variant(cohort, pred):
    """The lines of the cohort's first file, AD declared Number=R (as
    GATK declares it, so vcfdiff remaps it by allele), and the index of
    the first record that `pred` accepts."""
    with open(cohort.vcfs[0]) as f:
        lines = f.read().replace("##FORMAT=<ID=AD,Number=.,",
                                 "##FORMAT=<ID=AD,Number=R,").splitlines()
    i = next(i for i, ln in enumerate(lines)
             if not ln.startswith("#") and pred(ln.split("\t")))
    return lines, i


@pytest.mark.parametrize("case", ["equal", "reordered", "value_changed"])
def test_vcfdiff(cohort, tmp_path, case):
    lines, i = _variant(cohort, lambda c: c[4].count(",") >= 2)
    gold = str(tmp_path / "gold.vcf")
    with open(gold, "w") as f:
        f.write("\n".join(lines) + "\n")
    if case == "reordered":
        lines[i] = _swap_alts(lines[i])
    elif case == "value_changed":
        cols = lines[i].split("\t")
        keys = cols[8].split(":")
        vals = cols[9].split(":")
        pl = vals[keys.index("PL")].split(",")
        pl[1] = str(int(pl[1]) + 7)
        vals[keys.index("PL")] = ",".join(pl)
        cols[9] = ":".join(vals)
        lines[i] = "\t".join(cols)
    test = str(tmp_path / "test.vcf")
    with open(test, "w") as f:
        f.write("\n".join(lines) + "\n")
    errors = vcfdiff.vcfdiff(gold, test)
    assert errors == jdiff.vcfdiff(gold, test)
    assert vcfdiff.main([gold, test]) == jdiff.main([gold, test])
    if case == "value_changed":
        assert len(errors) == 1 and " S0 PL: " in errors[0], errors
    else:
        assert errors == []


# --------------------------------------------------------- workspace_tool

def _fragments(array_dir):
    return [f for f in os.listdir(array_dir) if f.startswith("fragment_")]


def test_workspace_tool_create_consolidate_list(cohort, tmp_path):
    """create: equal workspaces; an array of two fragments (the cohort
    imported twice) consolidated by each tool: equal stores; list: equal
    text."""
    made = {}
    for side, main in (("port", workspace_tool.main), ("jax", jwst.main)):
        d = str(tmp_path / f"new_{side}")
        assert main(["create", d]) == 0
        made[side] = _store_files(d)
    assert made["port"] == made["jax"] and made["port"]
    vcf2gdb.main([cohort.loader])
    vcf2gdb.main([cohort.loader])
    stores, listed = {}, {}
    for side, main in (("port", workspace_tool.main), ("jax", jwst.main)):
        d = str(tmp_path / f"ws_{side}")
        shutil.copytree(cohort.workspace, d)
        array = os.path.join(d, cohort.array)
        listed[side] = _out(main, ["list", d])
        assert len(_fragments(array)) == 2
        assert main(["consolidate", d, cohort.array]) == 0
        assert len(_fragments(array)) == 1
        stores[side] = _store_files(d)
        listed[side] += _out(main, ["list", d])
    assert listed["port"] == listed["jax"]
    assert listed["port"][1].startswith(f"{cohort.array}\t")
    assert stores["port"] == stores["jax"] and len(stores["port"]) > 20
    assert _out(workspace_tool.main, ["list", str(tmp_path)]) == \
        _out(jwst.main, ["list", str(tmp_path)]) == (1, "")


# ----------------------------------------------------------- vcf_histogram

def test_vcf_histogram_partitions_and_split_files(cohort, tmp_path):
    argv = [cohort.loader, "--bin-size", "250", "--num-partitions", "3",
            "--workspace", str(tmp_path / "ws3"), "--array", "part"]
    got = _out(vcf_histogram.main, argv)[1]
    assert got == _out(jhist.main, argv)[1]
    parts = json.loads(got.splitlines()[-1])["column_partitions"]
    assert len(parts) == 3 and len(got.splitlines()) > 10
    loader = str(tmp_path / "loader3.json")
    with open(cohort.loader) as f:
        doc = json.load(f)
    doc["column_partitions"] = parts
    with open(loader, "w") as f:
        json.dump(doc, f)
    split = {}
    for side, main in (("port", vcf2gdb.main), ("jax", jvcf2gdb.main)):
        d = str(tmp_path / f"split_{side}")
        main([loader, "--split-files", d])
        split[side] = _store_files(d)
    assert split["port"] == split["jax"]
    assert sorted(split["port"]) == sorted(
        f"partition_{i}/{os.path.basename(v)}"
        for i in range(3) for v in cohort.vcfs)


# ---------------------------------------------------------- generate_config

def test_generate_config(cohort, tmp_path):
    outs = {}
    for side, main in (("port", generate_config.main), ("jax", jgen.main)):
        vid, cs = str(tmp_path / f"vid_{side}"), str(tmp_path / f"cs_{side}")
        assert main([vid, cs, *cohort.vcfs]) == 0
        outs[side] = [open(p).read() for p in (vid, cs)]
    assert outs["port"] == outs["jax"]
    callsets = json.loads(outs["port"][1])["callsets"]
    assert len(callsets) == cohort.n_samples
    assert json.loads(outs["port"][0])["fields"]["PL"]["length"] == "G"


# ------------------------------------------------------------ vcf_combiner

def test_vcf_combiner(cohort):
    got, want = io.StringIO(), io.StringIO()
    vcf_combiner.combine(cohort.vcfs, out=got, produce_GT=True)
    jcomb.combine(cohort.vcfs, out=want, produce_GT=True)
    text = got.getvalue()
    assert text == want.getvalue()
    assert sum(not ln.startswith("#") for ln in text.splitlines()) > 100


# ---------------------------------------------------- cleanroom_bcf_decoder

def test_cleanroom_decoder_on_the_ports_bcf_stream(cohort):
    """The port's BCF2 query stream (CombinedRecordStream.bcf_stream on
    the CPU device), decoded by the port's and the JAX package's
    cleanroom decoders: equal lines, and the records are the port's
    combined text."""
    import torch
    from genomicsdb_tpu_torch.core.config import QueryParams
    from genomicsdb_tpu_torch.core.vid import VidMapper
    from genomicsdb_tpu_torch.query import driver
    from genomicsdb_tpu_torch.query.stream import CombinedRecordStream
    from genomicsdb_tpu_torch.store.import_pipeline import import_callsets
    vid = VidMapper.from_files(cohort.vid, cohort.callsets)
    store = import_callsets(vid)
    qp = QueryParams.from_file(cohort.query, 0)
    qc = driver.make_query_config(qp, vid)
    data = b"".join(CombinedRecordStream(store, qc, qp, vid,
                                         torch.device("cpu")).bcf_stream())
    assert data[:5] == b"BCF\x02\x02"
    got = cr.decode(data)
    assert got == jcr.decode(data)
    text = driver.run_vcf_query_block(store, qc, qp, vid,
                                      torch.device("cpu"))
    recs = [ln for ln in got if not ln.startswith("#")]
    assert len(recs) > 100
    assert recs == text.splitlines()


def test_cleanroom_decoder_imports_nothing_of_the_package():
    with open(cr.__file__) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            assert node.level == 0, "relative import"
            assert not (node.module or "").startswith("genomicsdb")
        elif isinstance(node, ast.Import):
            for a in node.names:
                assert not a.name.startswith("genomicsdb"), a.name


# -------------------------------------------------------------- perf_table

BENCH = {
    "metric": "combine_positions_per_sec_per_chip", "value": 2112064.459,
    "unit": "positions/sec", "vs_baseline": 14.5016, "vs_baseline_mt":
    2.0927, "card": "NVIDIA H100 80GB HBM3, 700.00 W",
    "detail": {
        "device_fused_pallas": {"positions_per_sec": 2112064.459},
        "device_fused_wide_1024_samples": {"cells_per_sec": 245872904.3},
        "cohort100_end_to_end": {"end_to_end_positions_per_sec": 5862126.8},
        "import": {"native_cells_per_sec": 2691361.3,
                   "asa": {"native_cells_per_sec": 1242461.1}},
        "wide_cohort_1000": {"cells_per_sec": 2804049.0,
                             "interval_10kb_p50_ms": 1.1958,
                             "interval_10kb_engine_p50_ms": 62.487},
        "stream_latency": {"socket_p50_ms": 4.2604,
                           "persistent_p50_ms": 1.7709,
                           "engine_persistent_p50_ms": 15.1503},
        "process_scaling": {"ranks": {"4": {
            "efficiency_pct": 114.58, "efficiency_spawn_pct": 16.69}}},
        "out_of_core": {"rss_over_partition": None},
        "chip_lane": {"passed": 33, "failed": 0, "skipped": 0},
    },
}


def _rows(table):
    return [[c.strip() for c in ln.strip("|").split("|")]
            for ln in table.splitlines()
            if ln.startswith("| ") and not ln.startswith("| metric")]


def test_perf_table_values_equal_the_jax_table(tmp_path):
    got, want = _rows(perf_table.render(BENCH)), _rows(jperf.render(BENCH))
    assert len(got) == len(want) == 17
    assert [r[1:3] for r in got] == [r[1:3] for r in want]
    assert "2.11 M" in got[0][1] and BENCH["card"] in got[0][0]
    text = perf_table.render(BENCH)
    assert "v5e" not in text and "pytest -m tpu" not in text
    assert "python -m genomicsdb_tpu_torch.bench" in text
    assert "`pytest -m gpu tests/test_torch_gpu_lane.py`" in text


def test_perf_table_writes_beside_the_json_and_never_under_docs(tmp_path):
    path = tmp_path / "bench.json"
    path.write_text(json.dumps(BENCH))
    out = perf_table.write_table(str(path))
    assert out == str(tmp_path / "perf_table.md")
    assert open(out).read() == perf_table.render(BENCH)
    docs = os.path.join(ROOT, "docs", "perf_table.md")
    before = open(docs).read() if os.path.exists(docs) else None
    with pytest.raises(ValueError, match="docs/"):
        perf_table.write_table(str(path), docs)
    after = open(docs).read() if os.path.exists(docs) else None
    assert before == after
    assert re.search(r"build.genomicsdb_tpu_torch.bench\.json$",
                     perf_table.DEFAULT_BENCH)


def test_port_bench_writes_its_perf_table(tmp_path):
    """The port's bench renders the table beside the JSON it writes."""
    from genomicsdb_tpu_torch import bench
    out = str(tmp_path / "bench.json")
    bench.main(["--device", "cpu", "--lanes", "cpp_sequential_baseline",
                "--out", out])
    table = open(str(tmp_path / "perf_table.md")).read()
    assert table == perf_table.render(json.load(open(out)))
    assert "Card: cpu." in table
