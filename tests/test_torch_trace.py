"""The port's tracer (`genomicsdb_tpu_torch.core.profile`) on the CPU:
free when off, well-nested spans with one request id per request when
on, the block engine's spans and store-wide rebuilds over a query of
many blocks, the host->device byte counter, the operator's report, and
the native library's first build from two threads at once."""

import contextlib
import functools
import io
import os
import subprocess
import sys
import threading
from types import SimpleNamespace

import pytest

from genomicsdb_tpu_torch.core import profile
from genomicsdb_tpu_torch.ops.combine_step import block_to_tensors
from genomicsdb_tpu_torch.ops.store_block import store_to_block
from genomicsdb_tpu_torch.query import driver
from genomicsdb_tpu_torch.query.block_writer import \
    render_block_vcf_pipelined as RB
from genomicsdb_tpu_torch.runtime import native_loader
from genomicsdb_tpu_torch.store import workspace as ws
from genomicsdb_tpu_torch.testing import write_cohort
from genomicsdb_tpu_torch.tools import gdb_query, vcf2gdb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 40                      # records per block of the traced queries


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    c = write_cohort(str(tmp_path_factory.mktemp("cohort")), 12, 150,
                     seed=5, n_groups=3)
    vcf2gdb.main([c.loader])
    return c


@pytest.fixture
def tracing(monkeypatch):
    """Tracing on, no records before the test, off and cleared after."""
    monkeypatch.setattr(profile, "ENABLED", True)
    profile.clear()
    yield
    profile.clear()


def _query(cohort, monkeypatch) -> str:
    """One `gdb_query --engine block --device cpu` call, in blocks of
    CHUNK records, with the fetch pack on (as on a CUDA device)."""
    monkeypatch.setattr(driver, "run_vcf_query_block", functools.partial(
        driver.run_vcf_query_block, max_records_per_block=CHUNK))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        gdb_query.main(["-j", cohort.query, "--produce-Broad-GVCF",
                        "--engine", "block", "--device", "cpu"], pack=True)
    return buf.getvalue()


def _by_request(records):
    out = {}
    for s in records:
        out.setdefault(s.request_id, []).append(s)
    return out


def test_off_records_nothing_and_reads_no_clock(cohort, monkeypatch):
    monkeypatch.setattr(profile, "ENABLED", False)
    profile.clear()

    def no_clock():
        raise AssertionError("a span read the clock with tracing off")
    monkeypatch.setattr(profile, "time",
                        SimpleNamespace(perf_counter_ns=no_clock))
    assert profile.span("x") is profile.OFF
    assert profile.span("x", a=1) is profile.OFF
    assert profile.request("query") is profile.OFF
    assert profile.rebuild("dense_layout") is profile.OFF
    before = profile.COUNTS.block_records
    text = _query(cohort, monkeypatch)
    assert text.count("\n") > 100
    assert profile.spans() == []
    # counters stay on
    assert profile.COUNTS.block_records > before


def test_spans_nest_and_requests_stay_apart_across_threads(tracing):
    barrier = threading.Barrier(2)
    roots = {}

    def work(k):
        with profile.request("req") as root:
            roots[k] = root
            barrier.wait()
            with profile.span("outer", k=k):
                profile.count("things", k + 1)
                barrier.wait()
                with profile.span("inner"):
                    barrier.wait()
                    profile.count("things", 10)
    threads = [threading.Thread(target=work, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    recs = profile.spans()
    assert len(recs) == 6
    assert roots[0].request_id != roots[1].request_id
    by_id = {s.id: s for s in recs}
    for k, root in roots.items():
        assert root.parent_id is None and root.name == "req"
        assert root.counts == {"things": k + 1 + 10}
        mine = [s for s in recs if s.request_id == root.request_id]
        assert sorted(s.name for s in mine) == ["inner", "outer", "req"]
        for s in mine:
            assert s.thread_id == root.thread_id
            if s is root:
                continue
            parent = by_id[s.parent_id]
            assert parent.request_id == root.request_id
            assert parent.t0_ns <= s.t0_ns <= s.t1_ns <= parent.t1_ns
        outer = next(s for s in mine if s.name == "outer")
        assert outer.attrs == {"k": k}
    # outside a request a span has no request id, and a count no tally
    with profile.span("alone") as s:
        profile.count("things")
    assert s.request_id is None and s.parent_id is None


def test_counts_from_many_threads_lose_no_update(tracing):
    interval = sys.getswitchinterval()
    threads_n, per = 16, 20000
    before = profile.COUNTS.stress
    roots = []

    def work():
        with profile.request("req") as root:
            roots.append(root)
            for _ in range(per):
                profile.count("stress")
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert profile.COUNTS.stress - before == threads_n * per
    assert all(r.counts == {"stress": per} for r in roots)
    assert len({r.request_id for r in roots}) == threads_n


def test_block_query_one_root_and_no_span_crosses_a_block(cohort,
                                                          monkeypatch,
                                                          tracing):
    built = RB.blocks_built
    _query(cohort, monkeypatch)
    blocks = RB.blocks_built - built
    assert blocks >= 4
    recs = profile.spans()
    roots = [s for s in recs if s.parent_id is None]
    assert [s.name for s in roots] == ["query"]
    root = roots[0]
    assert all(s.request_id == root.request_id for s in recs)
    names = [s.name for s in recs]
    assert names.count("block.build") == blocks
    assert names.count("device.combine") == blocks
    assert names.count("device.fetch") == blocks
    assert names.count("render") == blocks
    assert names.count("device.pack") == blocks
    assert names.count("block.release") == blocks
    assert names.count("query.open") == 1
    assert names.count("query.join") == names.count("query.write") == 1
    by_id = {s.id: s for s in recs}
    parent = {s.name: by_id[s.parent_id].name for s in recs
              if s.parent_id is not None}
    assert parent["block.build"] == parent["device.combine"] == \
        parent["device.fetch"] == parent["render"] == \
        parent["query.open"] == parent["rebuild.events"] == \
        parent["device.pack"] == parent["block.release"] == \
        parent["query.join"] == parent["query.write"] == "query"
    assert parent["device.upload"] == "device.combine"
    assert parent["rebuild.row_layout"] == "rebuild.dense_layout"
    assert parent["rebuild.dense_layout"] == "block.build"
    assert parent["rebuild.range_check"] == "device.combine"
    # every span lies inside its parent, and any two spans are nested or
    # apart: the pipeline interleaves chunk k+1's build and launch with
    # chunk k's fetch and render, and no span is held across it
    for s in recs:
        if s.parent_id is not None:
            p = by_id[s.parent_id]
            assert p.t0_ns <= s.t0_ns <= s.t1_ns <= p.t1_ns, (s, p)
    ivs = sorted((s.t0_ns, -s.t1_ns, s.name) for s in recs)
    for i, (a0, a1, an) in enumerate(ivs):
        for b0, b1, bn in ivs[i + 1:]:
            if b0 >= -a1:
                break
            assert -b1 <= -a1, f"{bn} crosses {an}"
    # the pipeline: block k+1 is built before block k renders
    builds = sorted(s.t0_ns for s in recs if s.name == "block.build")
    renders = sorted(s.t0_ns for s in recs if s.name == "render")
    assert builds[1] < renders[0]


def test_a_new_store_rebuilds_and_a_second_block_does_not(cohort,
                                                         monkeypatch,
                                                         tracing):
    rebuilds0 = profile.COUNTS.store_rebuilds
    _query(cohort, monkeypatch)
    _query(cohort, monkeypatch)
    recs = profile.spans()
    reqs = _by_request(recs)
    assert len(reqs) == 2
    n_rebuilds = 0
    for rid, mine in reqs.items():
        names = [s.name for s in mine]
        assert names.count("block.build") >= 4
        for table in ("dense_layout", "row_layout", "allele_meta",
                      "del_state", "events", "gt_ploidy", "gt_bad"):
            assert names.count("rebuild." + table) == 1, (table, names)
        assert names.count("rebuild.string_codes") == 2       # REF, ALT
        # the first block's build holds every store-wide rebuild
        first = min((s for s in mine if s.name == "block.build"),
                    key=lambda s: s.t0_ns)
        for s in mine:
            if s.name == "rebuild.dense_layout":
                assert first.t0_ns <= s.t0_ns <= first.t1_ns
        root = next(s for s in mine if s.name == "query")
        ours = sum(n.startswith("rebuild.") for n in names)
        assert root.counts["store_rebuilds"] == ours
        n_rebuilds += ours
    assert profile.COUNTS.store_rebuilds - rebuilds0 == n_rebuilds


def test_h2d_bytes_count_the_tensors_block_to_tensors_returns(cohort):
    store = ws.open_array(cohort.workspace, cohort.array)
    from genomicsdb_tpu_torch.core.config import QueryParams
    from genomicsdb_tpu_torch.core.vid import VidMapper
    qp = QueryParams.from_file(cohort.query, 0)
    vid = VidMapper.from_files(cohort.vid, cohort.callsets)
    qc = driver.make_query_config(qp, vid)
    starts = driver.record_starts(store, qc, qc.column_intervals[0])
    mid = int(starts[len(starts) // 2])
    halves = [(int(starts[0]), mid - 1), (mid, int(qc.column_intervals[0][1]))]
    got = []
    for iv in halves:
        blk = store_to_block(store, qc, interval=iv, pad_cells_to=256)
        before = profile.COUNTS.h2d_bytes
        tensors = block_to_tensors(blk, "meta")
        got.append((profile.COUNTS.h2d_bytes - before,
                    sum(t.numel() * t.element_size() for t in tensors),
                    sum(t.numel() * t.element_size() for t in tensors[12:])))
    # the first block uploads the store-wide slabs and its own arrays,
    # the second (same layout) only its own arrays
    assert got[0][0] == got[0][1] > got[0][2] > 0
    assert got[1][0] == got[1][2] > 0
    before = profile.COUNTS.h2d_bytes
    block_to_tensors(blk, "cpu")
    assert profile.COUNTS.h2d_bytes == before


def _python(code: str, **env) -> subprocess.CompletedProcess:
    e = {k: v for k, v in os.environ.items()
         if k != "GENOMICSDB_TPU_PROFILE"}
    e.update(env)
    e["PYTHONPATH"] = ROOT + os.pathsep + e.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-c", code], env=e, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_report_under_the_environment_and_silent_after_enable(cohort):
    query = (f"from genomicsdb_tpu_torch.tools import gdb_query\n"
             f"gdb_query.main(['-j', {cohort.query!r}, "
             f"'--produce-Broad-GVCF', '--device', 'cpu'])\n")
    r = _python(query, GENOMICSDB_TPU_PROFILE="1")
    assert r.returncode == 0, r.stderr
    assert r.stdout.count("\n") > 100
    err = r.stderr.splitlines()
    rows = {ln.split(",")[0]: ln for ln in err if "s wall," in ln}
    assert rows["query"].startswith("query,1 calls,")
    for name in ("query.open", "block.build", "rebuild.dense_layout",
                 "device.combine", "device.fetch", "render"):
        assert name in rows, err
    total, self_ = (float(x.split("s ")[0]) for x in
                    rows["query"].split(",")[2:4])
    assert 0 <= self_ < total
    assert any(ln.startswith("#store_rebuilds : ") and
               int(ln.split(": ")[1]) > 0 for ln in err), err
    assert any(ln.startswith("#block_records : ") for ln in err)
    assert err[-1].startswith("memory,resident=")
    r = _python("from genomicsdb_tpu_torch.core import profile\n"
                "profile.enable()\n"
                "with profile.request('query'):\n"
                "    with profile.span('x'):\n"
                "        profile.count('n')\n"
                "assert len(profile.spans()) == 2\n"
                "profile.maybe_report()\n")
    assert r.returncode == 0 and r.stderr == "", r.stderr


def test_each_report_covers_its_own_call(cohort):
    argv = ["-j", cohort.query, "--produce-Broad-GVCF", "--device", "cpu"]
    r = _python(f"from genomicsdb_tpu_torch.tools import gdb_query\n"
                f"gdb_query.main({argv!r})\n"
                f"gdb_query.main({argv!r})\n",
                GENOMICSDB_TPU_PROFILE="1")
    assert r.returncode == 0, r.stderr
    reports, cur = [], []
    for ln in r.stderr.splitlines():
        cur.append(ln)
        if ln.startswith("memory,resident="):
            reports.append(cur)
            cur = []
    assert len(reports) == 2, r.stderr
    got = []
    for rep in reports:
        rows = {ln.split(",")[0]: ln for ln in rep if "s wall," in ln}
        assert rows["query"].startswith("query,1 calls,"), rep
        assert rows["block.build"].startswith("block.build,1 calls,"), rep
        counts = {ln[1:].split(" : ")[0]: int(ln.split(" : ")[1])
                  for ln in rep if ln.startswith("#")}
        got.append(counts)
    # a new store each call: the same rebuilds and records in each report
    assert got[0]["store_rebuilds"] == got[1]["store_rebuilds"] > 0
    assert got[0]["block_records"] == got[1]["block_records"] > 0


def test_native_library_first_build_from_two_threads(tmp_path,
                                                     monkeypatch):
    lib_path = str(tmp_path / "libgdb_native.so")
    monkeypatch.setattr(native_loader, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native_loader, "_LIB_PATH", lib_path)
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_tried", False)
    builds = profile.COUNTS.native_builds
    barrier = threading.Barrier(2)
    got = [None, None]

    def ask(i):
        barrier.wait()
        got[i] = native_loader.get_lib()
    threads = [threading.Thread(target=ask, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert got[0] is not None and got[0] is got[1]
    assert os.path.isfile(lib_path)
    assert profile.COUNTS.native_builds == builds + 1
    assert native_loader.get_lib() is got[0]
