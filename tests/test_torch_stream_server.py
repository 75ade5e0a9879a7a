"""The port's query-stream socket server on the CPU device against the
JAX package's server: the one-shot protocol (read to EOF), the
persistent protocol (framed `[u32 len][bytes]...` plus a zero frame),
in-band `GDBERR` errors that a persistent connection survives, and
concurrent persistent clients.  Responses must be byte-identical to the
JAX server's for the same query documents.

Both servers open the same workspace, imported once with the port's
vcf2gdb from a seeded `genomicsdb_tpu_torch.testing` cohort, with their
own loaders.
"""

import os
import sys
import threading

import pytest
import torch

from genomicsdb_tpu.query import stream_server as jax_server
from genomicsdb_tpu_torch.ops import _kernel_build
from genomicsdb_tpu_torch.query import serving_index as si
from genomicsdb_tpu_torch.query import stream_server
from genomicsdb_tpu_torch.query.stream import CombinedRecordStream
from genomicsdb_tpu_torch.testing import write_cohort
from genomicsdb_tpu_torch.tools import vcf2gdb
from genomicsdb_tpu_torch.vcf import bcf


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    c = write_cohort(str(tmp_path_factory.mktemp("stream")), 8, 150,
                     seed=11, n_groups=2)
    vcf2gdb.main([c.loader])
    return c


def _doc(c, lo, hi, **extra):
    d = {"workspace": c.workspace, "array_name": c.array,
         "vid_mapping_file": c.vid, "callset_mapping_file": c.callsets,
         "attributes": [],
         "query_column_ranges": [{"range_list": [{"low": lo, "high": hi}]}]}
    d.update(extra)
    return d


@pytest.fixture(scope="module")
def docs(cohort):
    """Whole region, a head slice, a mid slice, a tail slice, two
    intervals in one query, a row subset, and a template header with the
    cohort's reference genome."""
    r = cohort.region
    return [
        _doc(cohort, 0, r),
        _doc(cohort, 0, r // 5),
        _doc(cohort, r // 3, r // 3 + 2000),
        _doc(cohort, r - 3000, r + 10),
        dict(_doc(cohort, 0, 0), query_column_ranges=[{"range_list": [
            {"low": 100, "high": 900}, {"low": r // 2, "high": r // 2 + 500}
        ]}]),
        dict(_doc(cohort, 0, r // 2),
             query_row_ranges=[{"range_list": [{"low": 1, "high": 5}]}]),
        _doc(cohort, r // 4, r // 4 + 4000,
             vcf_header_filename=[cohort.vcfs[0]],
             reference_genome=cohort.fasta),
    ]


@pytest.fixture(scope="module")
def servers():
    port = stream_server.QueryStreamServer(port=0, device="cpu")
    ref = jax_server.QueryStreamServer(port=0)
    port.start_background()
    ref.start_background()
    yield port.address, ref.address
    port.shutdown()
    ref.shutdown()


@pytest.fixture(scope="module")
def want(servers, docs):
    """The JAX server's one-shot bytes per document."""
    _, (host, port) = servers
    return [jax_server.read_query_stream(host, port, d) for d in docs]


def test_one_shot_equals_the_jax_server(servers, docs, want):
    (host, port), _ = servers
    for i, d in enumerate(docs):
        got = stream_server.read_query_stream(host, port, d)
        assert got[:5] == b"BCF\x02\x02"
        assert got == want[i], i
    # the text behind the wire bytes is a real combined gVCF
    text = bcf.bcf_to_text(want[0])
    recs = [ln for ln in text.splitlines() if not ln.startswith("#")]
    assert len(recs) > 100


def test_persistent_connection_and_in_band_errors(servers, docs, want):
    """One connection serves every document (twice, so the second round
    comes from the serving index), survives an in-band GDBERR, and each
    framed response equals the one-shot bytes."""
    (host, port), _ = servers
    with stream_server.QueryStreamClient(host, port) as cli:
        for _ in range(2):
            for i, d in enumerate(docs):
                assert cli.query(d) == want[i], i
        with pytest.raises(RuntimeError, match="GDBERR"):
            cli.query({"vid_mapping_file": "/does/not/exist"})
        assert cli.query(docs[2]) == want[2]


def test_one_shot_error_is_in_band(servers):
    (host, port), _ = servers
    with pytest.raises(RuntimeError, match="GDBERR"):
        stream_server.read_query_stream(host, port,
                                        {"vid_mapping_file": "/nope"})


def test_sequential_engine_document(servers, docs, want):
    (host, port), _ = servers
    got = stream_server.read_query_stream(
        host, port, dict(docs[1], engine="sequential"))
    assert got == want[1]


def test_concurrent_persistent_clients(docs, want):
    """Four clients on a fresh server (its store, layout and index built
    under them), each cycling through the documents: every response
    equals its single-client bytes."""
    srv = stream_server.QueryStreamServer(port=0, device="cpu")
    srv.start_background()
    host, port = srv.address
    errors = []

    def client(tid):
        try:
            with stream_server.QueryStreamClient(host, port) as cli:
                for k in range(2 * len(docs)):
                    i = (tid + k) % len(docs)
                    got = cli.query(docs[i])
                    if got != want[i]:
                        errors.append((tid, k, i, len(got)))
        except Exception as e:          # surfaced after join
            errors.append((tid, repr(e)))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
    finally:
        sys.setswitchinterval(old)
        srv.shutdown()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


def test_main_refuses_cuda_without_a_card(monkeypatch):
    """`--device cuda` with no card exits non-zero before any server is
    constructed (so before it listens)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def never(*a, **kw):
        raise AssertionError("the server was constructed")

    monkeypatch.setattr(stream_server, "QueryStreamServer", never)
    with pytest.raises(SystemExit) as e:
        stream_server.main(["--device", "cuda", "--port", "0"])
    assert e.value.code not in (0, None)
    with pytest.raises(RuntimeError, match="not available"):
        CombinedRecordStream(None, None, None, None, "cuda")


def test_vid_ids_declared_fast_path_engages(cohort):
    """The headerless stream's declaration-synthesis skip fires for the
    cohort's vid (every id the renderer can emit is declared)."""
    from genomicsdb_tpu_torch.core.vid import VidMapper
    stream = CombinedRecordStream.__new__(CombinedRecordStream)
    stream.vid = VidMapper.from_files(cohort.vid)
    hd = bcf._HeaderDict(["##fileformat=VCFv4.1"]
                         + stream._vid_declarations())
    assert stream._vid_ids_declared(hd)


def test_stream_latency_bench_on_the_cpu(capsys, monkeypatch):
    """The port's socket latency bench at a tiny size on `--device cpu`
    (every lane's bytes checked against the engine lane), and its refusal
    of `cuda` without a card."""
    import json

    from genomicsdb_tpu_torch.tools import stream_latency_bench
    stream_latency_bench.main(["--samples", "3", "--records", "400",
                               "--queries", "4", "--warmup", "1",
                               "--interval", "800", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["queries"] == 4
    assert out["persistent_p50_ms"] > 0 and out["mean_stream_bytes"] > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        stream_latency_bench.main(["--device", "cuda"])


def test_kernel_library_builds_once_under_threads(tmp_path, monkeypatch):
    """Eight threads asking for the kernel library at once run one build
    (the lock around the first build); nvcc and the loader are stubbed."""
    src = tmp_path / "k.cu"
    src.write_text("// stub\n")
    builds = []

    class _Res:
        returncode, stdout, stderr = 0, "", ""

    def fake_run(cmd, **kw):
        builds.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"lib")
        return _Res()

    monkeypatch.setattr(_kernel_build, "sources", lambda: [str(src)])
    monkeypatch.setattr(_kernel_build, "BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setattr(_kernel_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_kernel_build.subprocess, "run", fake_run)
    monkeypatch.setattr(_kernel_build.ctypes, "CDLL", lambda p: object())
    monkeypatch.setattr(_kernel_build, "_bind", lambda lib: None)
    _kernel_build._load_library.cache_clear()
    got = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: got.append(_kernel_build.load_library()))
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
        _kernel_build._load_library.cache_clear()
    assert not any(t.is_alive() for t in threads)
    # one build: an nvcc for the one source, then the link
    assert len(builds) == 2 and len(got) == 8
    assert len({id(k) for k in got}) == 1
    assert os.path.isfile(got[0].path)


def test_served_queries_combine_no_block_after_the_build(cohort,
                                                        monkeypatch):
    """The second query of a signature builds the index (one full-store
    block-engine run); later queries are slices plus host-patched or
    sequential edges: no block reaches the device combine."""
    from genomicsdb_tpu_torch.ops import fused_combine as FC
    builds = []
    orig = si.build_index

    def spy(*a, **kw):
        builds.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(si, "build_index", spy)
    srv = stream_server.QueryStreamServer(port=0, device="cpu")
    srv.start_background()
    try:
        host, port = srv.address
        r = cohort.region
        ds = [_doc(cohort, lo, lo + 1500) for lo in (17, r // 3, r - 900)]
        with stream_server.QueryStreamClient(host, port) as cli:
            first = [cli.query(d) for d in ds[:1] * 2]
            blocks = FC.combine_block.blocks
            later = [cli.query(d) for d in ds]
            assert FC.combine_block.blocks == blocks
        monkeypatch.setenv("GENOMICSDB_TPU_SERVING_INDEX", "0")
        engine = [stream_server.read_query_stream(host, port, d)
                  for d in ds]
        assert FC.combine_block.blocks > blocks
    finally:
        srv.shutdown()
    assert len(builds) == 1
    assert first == [engine[0]] * 2 and later == engine


def test_server_with_the_pack_forced_on(docs, want):
    """A CPU server with the fetch pack forced on (narrow outputs, the
    packed variant-row fetch) streams the same bytes."""
    srv = stream_server.QueryStreamServer(port=0, device="cpu", pack=True)
    srv.start_background()
    try:
        with stream_server.QueryStreamClient(*srv.address) as cli:
            for i in (0, 2, 4, 6):
                assert cli.query(docs[i]) == want[i], i
    finally:
        srv.shutdown()
