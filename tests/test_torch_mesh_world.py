"""The port's 2x2 mesh in a world that stays up: four gloo CPU rank
processes join one process group, then each serves several interval
queries through `gdb_query.main([... "--mesh", "2x2", "--device",
"cpu"])` in-process, as a launched world (torchrun, mpirun) serving a
scatter would.

Every query's text equals the port's unsharded text and the plain
reference (`gdb_bench/reference.py`, NumPy from the gVCF files); the
mesh is laid out once per world (`sharded.make_mesh`: one
`COUNTS.mesh_joins` and one `mesh.join` span per rank, the same groups
on every call); a pos span without records still joins every
collective; and the tracer (under GENOMICSDB_TPU_PROFILE) holds a
`mesh.gather_text` span per chunk on the row-0 ranks and a
`collective_bytes` tally equal to the function attributes it mirrors.
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

from gdb_bench.cohort import write_cohort
from gdb_bench.drivers import split_lines
from gdb_bench.reference import Cohort, format_float, reference_lines
from genomicsdb_tpu_torch.tools import gdb_query, vcf2gdb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120
N_POS, N_ROW = 2, 2
# 11 samples: the second row rank's shard holds a padded sample
SAMPLES, RECORDS = 11, 160
ATTRS = ("all_gather", "gather_to_root", "scatter_rows",
         "gather_blobs_to_root")

WORKER = r"""
import contextlib, datetime, io, json, os, sys
sys.path.insert(0, %(root)r)
import torch.distributed as dist
from genomicsdb_tpu_torch.core import profile
from genomicsdb_tpu_torch.parallel import comm, multihost, sharded
from genomicsdb_tpu_torch.tools import gdb_query
out_dir, *queries = sys.argv[1:]
rank = int(os.environ["RANK"])
dist.init_process_group("gloo", init_method="env://", rank=rank,
                        world_size=int(os.environ["WORLD_SIZE"]),
                        timeout=datetime.timedelta(seconds=90))
COLLECTIVES = ("mesh.scatter_rows", "mesh.all_gather", "mesh.gather_rows",
               "mesh.gather_text")
meshes, snaps = [], []
make_mesh, report = sharded.make_mesh, profile.maybe_report

def kept(*a, **k):
    meshes.append(make_mesh(*a, **k))
    return meshes[-1]

def snapshot():
    snaps.append(profile.spans())
    report()

sharded.make_mesh, profile.maybe_report = kept, snapshot

def attrs():
    return {"all_gather": comm.all_gather.bytes,
            "gather_to_root": comm.gather_to_root.bytes,
            "scatter_rows": sharded.scatter_rows.bytes,
            "gather_blobs_to_root": multihost.gather_blobs_to_root.bytes,
            "all_gather_calls": comm.all_gather.calls,
            "blocks": sharded.mesh_combine.blocks,
            "collective_bytes": profile.COUNTS.collective_bytes,
            "mesh_joins": profile.COUNTS.mesh_joins}

res = []
for q in queries:
    before, buf = attrs(), io.StringIO()
    with contextlib.redirect_stdout(buf):
        gdb_query.main(["-j", q, "--produce-Broad-GVCF", "--engine",
                        "block", "--mesh", "%(mesh)s", "--device", "cpu"])
    after = attrs()
    names = [s.name for s in snaps[-1]]
    roots = [s for s in snaps[-1] if s.parent_id is None]
    coll = {s.id for s in snaps[-1] if s.name in COLLECTIVES}
    inside = [s.name for s in snaps[-1] if s.parent_id in coll]
    res.append({"text": buf.getvalue(),
                "delta": {k: after[k] - before[k] for k in after},
                "spans": {n: names.count(n) for n in set(names)},
                "roots": [r.name for r in roots],
                "inside_collectives": inside,
                "tally": roots[-1].counts if roots else None})
first = meshes[0]
same = all(m is first and m.row_group is first.row_group
           and m.pos_group is first.pos_group for m in meshes)
with open(os.path.join(out_dir, "rank%%d.json" %% rank), "w") as f:
    json.dump({"rank": rank, "pos": first.pos, "row": first.row,
               "queries": res, "same_mesh": same, "calls": len(meshes),
               "kept": len(sharded._MESHES),
               "mesh_joins": profile.COUNTS.mesh_joins}, f)
del meshes, first
sharded.drop_meshes()
dist.destroy_process_group()
"""


# a caller's own world: two queries, then destroy_process_group alone,
# with no word to the port that the world ends
CALLER = r"""
import contextlib, datetime, io, os, sys
sys.path.insert(0, %(root)r)
import torch.distributed as dist
from genomicsdb_tpu_torch.tools import gdb_query
out_dir, *queries = sys.argv[1:]
rank = int(os.environ["RANK"])
dist.init_process_group("gloo", init_method="env://", rank=rank,
                        world_size=int(os.environ["WORLD_SIZE"]),
                        timeout=datetime.timedelta(seconds=90))
texts = []
for q in queries:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        gdb_query.main(["-j", q, "--produce-Broad-GVCF", "--engine",
                        "block", "--mesh", "%(mesh)s", "--device", "cpu"])
    texts.append(buf.getvalue())
dist.destroy_process_group()
with open(os.path.join(out_dir, "caller%%d.txt" %% rank), "w") as f:
    f.write("\x00".join(texts))
"""


def _starts(c):
    """The cohort's record starts, by the port's own store reader."""
    from genomicsdb_tpu_torch.core.config import QueryParams
    from genomicsdb_tpu_torch.ops.store_block import record_starts
    from genomicsdb_tpu_torch.query import driver
    from genomicsdb_tpu_torch.store import workspace as ws
    qp = QueryParams.from_file(c.query, 0)
    qc = driver.make_query_config(qp, driver.load_vid_for_query(qp, None))
    store = ws.open_array(c.workspace, c.array)
    return record_starts(store, qc, (0, c.region))


def _unsharded(query) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        gdb_query.main(["-j", query, "--produce-Broad-GVCF", "--engine",
                        "block", "--device", "cpu"])
    return buf.getvalue()


def _run_world(script, argv, world):
    """`script argv` as `world` gloo ranks of one process group, each
    with the environment `gdb_query --mesh` gives its ranks; all are
    killed past TIMEOUT_S.  Returns the seconds they took."""
    port = gdb_query.free_port()
    env = dict(GENOMICSDB_TPU_PROFILE="1")
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, str(script), *argv], text=True,
        env={**gdb_query.rank_env(r, world, port), **env},
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        for r in range(world)]
    try:
        errs = [p.communicate(timeout=max(t0 + TIMEOUT_S - time.monotonic(),
                                          1))[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
    return time.monotonic() - t0


# the world's queries, in the order it serves them: (name, record index
# ranges [a, b) of the cohort's starts)
QUERIES = (
    ("head", [(0, 60)]),
    ("two_ranges", [(70, 95), (120, 150)]),
    ("tail", [(150, None)]),
    # one record: the second pos group's span holds none
    ("one_record", [(100, 101)]),
)


@pytest.fixture(scope="module")
def queries(tmp_path_factory):
    """The cohort's directory, its query files, and each query's
    (ranges, unsharded text, reference lines)."""
    d = tmp_path_factory.mktemp("mesh_world")
    c = write_cohort(str(d / "cohort"), SAMPLES, RECORDS, seed=17)
    with contextlib.redirect_stdout(io.StringIO()):
        vcf2gdb.main([c.loader])
    starts = _starts(c)
    assert len(starts) > 160
    ref = Cohort(c.vcfs, c.vid)
    with open(c.query) as f:
        doc = json.load(f)
    files, want = [], {}
    for name, ranges in QUERIES:
        cols = [(int(starts[a]),
                 int(starts[b]) - 1 if b is not None else c.region)
                for a, b in ranges]
        doc["query_column_ranges"] = [{"range_list": [
            {"low": lo, "high": hi} for lo, hi in cols]}]
        path = str(d / f"{name}.json")
        with open(path, "w") as f:
            json.dump(doc, f)
        files.append(path)
        want[name] = (cols, _unsharded(path),
                      [ln for lo, hi in cols for ln in reference_lines(
                          ref, lo, hi, floats=format_float)])
    return d, files, want


@pytest.fixture(scope="module")
def world(queries):
    """Each query's (ranges, unsharded text, reference lines), every
    rank's report of serving all of them in one world, and the seconds
    the world took."""
    d, files, want = queries
    script = d / "worker.py"
    script.write_text(WORKER % {"root": ROOT, "mesh": f"{N_POS}x{N_ROW}"})
    seconds = _run_world(script, [str(d), *files], N_POS * N_ROW)
    reports = []
    for r in range(N_POS * N_ROW):
        with open(d / f"rank{r}.json") as f:
            reports.append(json.load(f))
    return want, reports, seconds


@pytest.mark.parametrize("k", range(len(QUERIES)),
                         ids=[q for q, _ in QUERIES])
def test_world_query_text_matches_unsharded_and_reference(world, k):
    want, reports, seconds = world
    name = QUERIES[k][0]
    cols, unsharded, ref = want[name]
    got = reports[0]["queries"][k]["text"]
    assert got == unsharded
    assert split_lines(got) == ref and ref
    # only the mesh's first rank writes
    assert all(r["queries"][k]["text"] == "" for r in reports[1:])
    assert seconds < 60


def test_world_lays_its_mesh_out_once(world):
    """One mesh per world and shape: the first query joins, the others
    reuse its groups."""
    _, reports, _ = world
    assert [(r["rank"], r["pos"], r["row"]) for r in reports] == [
        (k, *divmod(k, N_ROW)) for k in range(N_POS * N_ROW)]
    for r in reports:
        assert r["mesh_joins"] == 1
        assert r["calls"] == len(QUERIES) and r["same_mesh"]
        assert r["kept"] == 1
        assert [q["delta"]["mesh_joins"] for q in r["queries"]] == \
            [1] + [0] * (len(QUERIES) - 1)


def test_world_span_without_records_joins_every_collective(world):
    """The one-record query leaves the second pos group's span empty:
    its ranks still combine a padded block, all-gather over their row
    group, scatter and gather its rows, and its row-0 rank sends an
    empty text to the first rank."""
    _, reports, _ = world
    k = [q for q, _ in QUERIES].index("one_record")
    deltas = [r["queries"][k]["delta"] for r in reports]
    for d in deltas:
        assert d["blocks"] == 1 and d["all_gather_calls"] == 1
        assert d["scatter_rows"] > 0 and d["all_gather"] > 0
    # the empty span's ranks move as many row-group bytes as the full
    # span's (the padded block has the same shape)
    assert deltas[2]["scatter_rows"] == deltas[0]["scatter_rows"]
    assert deltas[3]["all_gather"] == deltas[1]["all_gather"]
    # the text gather: both row-0 ranks all-gather the lengths, and the
    # empty span's rank sends no payload
    assert deltas[0]["gather_blobs_to_root"] == 8 * N_POS
    assert deltas[2]["gather_blobs_to_root"] == 8 * N_POS
    assert deltas[1]["gather_blobs_to_root"] == 0
    assert reports[2]["queries"][k - 1]["delta"]["gather_blobs_to_root"] \
        > 8 * N_POS


@pytest.mark.parametrize("k", range(len(QUERIES)),
                         ids=[q for q, _ in QUERIES])
def test_world_spans_and_collective_bytes(world, k):
    """Under GENOMICSDB_TPU_PROFILE each call is one request: `mesh.join`
    on the first only; per chunk (one per column range here), on every
    rank two `mesh.scatter_rows` (the header's broadcast and the rows'
    scatter), a `mesh.all_gather` (the combine's) and a
    `mesh.gather_rows`, and on a row-0 rank a `device.fetch` of the
    gathered outputs and a `mesh.gather_text`; no collective span holds
    another span; and the request's `collective_bytes` equals the four
    function attributes' change."""
    _, reports, _ = world
    chunks = len(QUERIES[k][1])
    for r in reports:
        q = r["queries"][k]
        assert q["roots"] == ["query"]
        spans, tally, d = q["spans"], q["tally"], q["delta"]
        assert spans.get("mesh.join", 0) == (1 if k == 0 else 0)
        assert spans.get("mesh.scatter_rows", 0) == 2 * chunks
        row0 = r["row"] == 0
        assert spans.get("mesh.gather_rows", 0) == chunks
        assert spans.get("device.fetch", 0) == (chunks if row0 else 0)
        assert spans.get("device.fetch.wait", 0) == (chunks if row0 else 0)
        assert spans.get("mesh.gather_text", 0) == (chunks if row0 else 0)
        assert spans.get("mesh.all_gather", 0) == chunks
        assert q["inside_collectives"] == []
        assert d["blocks"] == chunks
        moved = sum(d[a] for a in ATTRS)
        assert moved > 0
        assert tally["collective_bytes"] == moved == d["collective_bytes"]
        assert tally.get("mesh_joins", 0) == (1 if k == 0 else 0)
    assert np.all([r["queries"][k]["tally"]["collective_bytes"] > 0
                   for r in reports])


def test_caller_world_ends_without_dropping_meshes(queries):
    """A caller that starts its own gloo world, runs two `--mesh`
    queries in it and ends it with destroy_process_group alone (never
    `sharded.drop_meshes`) exits 0 on every rank, with the unsharded
    texts on the first."""
    d, files, want = queries
    script = d / "caller.py"
    script.write_text(CALLER % {"root": ROOT, "mesh": f"{N_POS}x{N_ROW}"})
    picked = [0, 1]
    _run_world(script, [str(d), *(files[k] for k in picked)],
               N_POS * N_ROW)
    for r in range(N_POS * N_ROW):
        with open(d / f"caller{r}.txt") as f:
            texts = f.read().split("\x00")
        names = [QUERIES[k][0] for k in picked]
        assert texts == ([want[n][1] for n in names] if r == 0
                         else ["", ""])
