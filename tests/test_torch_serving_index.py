"""The port's materialized serving index against its live block engine
and against the JAX package, byte for byte, on the CPU.

Cohorts come from `genomicsdb_tpu_torch.testing.write_cohort` (seeded
with numpy), imported once with the port's vcf2gdb; each package opens
the store, the vid mapping and the query configuration from those
files with its own loaders.  Served bytes (BCF2 stream and text) must
equal the port's engine with the index off and the JAX package's
stream and driver over seeded intervals: tiny, mid, straddling a cell,
full, with and without deletions, row subsets, several intervals per
query, the cell cap, and the patched head/tail (reference base from the
cohort's FASTA, the 1 bp collapse).
"""

import random
import sys
import threading
import time

import numpy as np
import pytest
import torch

from genomicsdb_tpu.core.config import QueryParams as JaxQueryParams
from genomicsdb_tpu.core.vid import VidMapper as JaxVidMapper
from genomicsdb_tpu.query import driver as jax_driver
from genomicsdb_tpu.query import serving_index as jax_si
from genomicsdb_tpu.query.stream import CombinedRecordStream as JaxStream
from genomicsdb_tpu.store import workspace as jax_ws
from genomicsdb_tpu_torch.core.config import QueryParams
from genomicsdb_tpu_torch.core.vid import VidMapper
from genomicsdb_tpu_torch.ops import fused_combine as FC
from genomicsdb_tpu_torch.query import driver
from genomicsdb_tpu_torch.query import serving_index as si
from genomicsdb_tpu_torch.query.stream import CombinedRecordStream
from genomicsdb_tpu_torch.store import workspace as ws
from genomicsdb_tpu_torch.testing import write_cohort
from genomicsdb_tpu_torch.tools import vcf2gdb

CPU = torch.device("cpu")


class _Sides:
    """Both packages' view of one imported cohort."""

    def __init__(self, c):
        self.c = c
        self.vid = VidMapper.from_files(c.vid, c.callsets)
        self.store = ws.open_array(c.workspace, c.array)
        self.jvid = JaxVidMapper.from_files(c.vid, c.callsets)
        self.jstore = jax_ws.open_array(c.workspace, c.array)

    def _q(self, qp_cls, drv, vid, ivs, row_hi, produce_gt):
        qp = qp_cls()
        qp.column_ranges = [list(ivs)]
        if row_hi is not None:
            qp.row_ranges = [[(0, row_hi)]]
        qp.produce_GT_field = produce_gt
        return qp, drv.make_query_config(qp, vid)

    def port_bcf(self, ivs, row_hi=None, produce_gt=False, pack=None,
                 ref=None):
        qp, qc = self._q(QueryParams, driver, self.vid, ivs, row_hi,
                         produce_gt)
        s = CombinedRecordStream(self.store, qc, qp, self.vid, CPU,
                                 reference_path=ref, pack=pack)
        return b"".join(s.bcf_stream())

    def jax_bcf(self, ivs, row_hi=None, produce_gt=False, ref=None):
        qp, qc = self._q(JaxQueryParams, jax_driver, self.jvid, ivs,
                         row_hi, produce_gt)
        s = JaxStream(self.jstore, qc, qp, self.jvid, reference_path=ref)
        return b"".join(s.bcf_stream())

    def port_text(self, ivs, ref=None, pack=None):
        qp, qc = self._q(QueryParams, driver, self.vid, ivs, None, False)
        return driver.run_vcf_query_block(self.store, qc, qp, self.vid,
                                          CPU, reference_path=ref,
                                          pack=pack)

    def jax_text(self, ivs, ref=None):
        qp, qc = self._q(JaxQueryParams, jax_driver, self.jvid, ivs, None,
                         False)
        return jax_driver.run_vcf_query_block(self.jstore, qc, qp,
                                              self.jvid, reference_path=ref)


def _import(tmp_path_factory, name, **kw):
    c = write_cohort(str(tmp_path_factory.mktemp(name)), **kw)
    vcf2gdb.main([c.loader])
    return c


@pytest.fixture(scope="module")
def cohorts(tmp_path_factory):
    return {(seed, dels): _import(tmp_path_factory, f"c{seed}{int(dels)}",
                                  n_samples=6, n_records=120, seed=seed,
                                  n_groups=2, deletions=dels)
            for seed in (0, 1) for dels in (False, True)}


@pytest.fixture
def build_now(monkeypatch):
    """Both packages build their index on the first query."""
    monkeypatch.setattr(si, "BUILD_AFTER_QUERIES", 1)
    monkeypatch.setattr(jax_si, "BUILD_AFTER_QUERIES", 1)


@pytest.fixture
def engine_only(monkeypatch):
    """A context in which the serving index is off (the live engine)."""
    class _Off:
        def __enter__(self):
            monkeypatch.setenv("GENOMICSDB_TPU_SERVING_INDEX", "0")

        def __exit__(self, *exc):
            monkeypatch.delenv("GENOMICSDB_TPU_SERVING_INDEX")
    return _Off


def _intervals(store, seed):
    """Tiny, mid, cell-straddling and full intervals over the store."""
    r = random.Random(seed)
    span = int(store.eff_end.max()) + 10
    ivs = [(0, span)]
    for _ in range(8):
        lo = r.randint(0, span)
        ivs.append((lo, lo + r.choice([0, 1, 3, 17, 60, 200, 2000])))
    for ci in range(0, store.num_cells, max(1, store.num_cells // 4)):
        c, e = int(store.col[ci]), int(store.eff_end[ci])
        ivs.append((max(0, c - 1), max(0, c - 1)))
        ivs.append((c, max(c, e - 1)))
        ivs.append(((c + e) // 2, e + 3))
    return ivs


@pytest.mark.parametrize("deletions", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_index_equals_engine_and_the_jax_package(cohorts, build_now,
                                                 engine_only, seed,
                                                 deletions):
    sides = _Sides(cohorts[(seed, deletions)])
    ivs = _intervals(sides.store, seed)
    for produce_gt in (False, True):
        for iv in ivs:
            with engine_only():
                want = sides.port_bcf([iv], produce_gt=produce_gt)
            got = sides.port_bcf([iv], produce_gt=produce_gt)
            assert got == want, (iv, produce_gt)
            assert sides.jax_bcf([iv], produce_gt=produce_gt) == got, \
                (iv, produce_gt)
    assert any(e[1] is not None
               for e in sides.store._serving_idx_cache.values())


def test_index_builds_after_repeat(cohorts):
    """The index builds on the second query of one signature, is cached
    on the store, and serves the engine's bytes."""
    sides = _Sides(cohorts[(0, True)])
    iv = [(0, 10_000)]
    b1 = sides.port_bcf(iv)
    assert all(e[1] is None for e in sides.store._serving_idx_cache.values())
    assert sides.port_bcf(iv) == b1
    assert any(e[1] is not None
               for e in sides.store._serving_idx_cache.values())
    assert sides.port_bcf(iv) == b1


def test_text_path_with_reference_equals_engine(cohorts, build_now,
                                                engine_only):
    """driver.run_vcf_query_block serves from the index (text path, the
    cohort's FASTA as reference), byte-identical to the port's engine
    and to the JAX driver."""
    sides = _Sides(cohorts[(1, True)])
    ref = sides.c.fasta
    r = random.Random(3)
    span = int(sides.store.eff_end.max()) + 10
    ivs = [(0, span)] + [(lo, lo + r.choice([0, 2, 25, 120, 900]))
                         for lo in (r.randint(0, span) for _ in range(10))]
    for iv in ivs:
        with engine_only():
            want = sides.port_text([iv], ref=ref)
        assert sides.port_text([iv], ref=ref) == want, iv
        assert sides.jax_text([iv], ref=ref) == want, iv


def test_multi_interval_and_row_subsets(cohorts, build_now, engine_only):
    """Multi-interval queries serve per interval; row subsets key their
    own index; bytes equal the engine and the JAX stream."""
    sides = _Sides(cohorts[(0, True)])
    span = int(sides.store.eff_end.max()) + 10
    ivs = [(0, span // 3), (span // 2, span // 2 + 40), (span - 50, span)]
    for row_hi in (5, 2):
        with engine_only():
            want = sides.port_bcf(ivs, row_hi=row_hi)
        assert sides.port_bcf(ivs, row_hi=row_hi) == want, row_hi
        assert sides.jax_bcf(ivs, row_hi=row_hi) == want, row_hi
    assert len(sides.store._serving_idx_cache) == 2


def test_index_respects_cell_cap(cohorts, monkeypatch):
    monkeypatch.setenv("GENOMICSDB_TPU_SERVING_CACHE_CELLS", "1")
    sides = _Sides(cohorts[(1, False)])
    for _ in range(3):
        sides.port_bcf([(0, 10_000)])
    assert not getattr(sides.store, "_serving_idx_cache", None)


def test_index_built_with_the_pack_on(cohorts, build_now, engine_only):
    """The index build and block-engine edges with the fetch pack forced
    on (narrow outputs, packed variant-row fetch) serve the same bytes;
    no kernel launches on the CPU."""
    sides = _Sides(cohorts[(0, True)])
    launches = FC.fused_gather_remap.launches
    span = int(sides.store.eff_end.max())
    ivs = [(0, span), (span // 3, span // 3 + 300), (17, 17)]
    wants = []
    with engine_only():
        for iv in ivs:
            wants.append((sides.port_bcf([iv]), sides.port_text([iv])))
    for iv, (bcf, text) in zip(ivs, wants):
        assert sides.port_bcf([iv], pack=True) == bcf, iv
        assert sides.port_text([iv], pack=True) == text, iv
    assert FC.fused_gather_remap.launches == launches


def _ref_block_spans(store, min_len):
    return sorted({(int(c), int(e)) for c, e in zip(store.col,
                                                    store.eff_end)
                   if e - c > min_len})


def test_patched_head_edges_use_the_reference(cohorts, build_now,
                                              engine_only, monkeypatch):
    """Head-clipped pure-<NON_REF> records are served by patching the
    index text (POS shift, REF from the cohort's FASTA), never through
    the engine; byte-equal to the engine with the same reference."""
    sides = _Sides(cohorts[(1, False)])
    ref = sides.c.fasta
    hits = {"patched": 0, "ref": 0, "engine": 0}
    orig_patch = si.ServingIndex._patched_line
    orig_engine = si.engine_record_lines

    def spy_patch(self, i, nl, nh, ref_base):
        out = orig_patch(self, i, nl, nh, ref_base)
        if out is not None:
            hits["patched"] += 1
            if nl is not None and ref_base is not None:
                hits["ref"] += 1
        return out

    def spy_engine(*a, **kw):
        hits["engine"] += 1
        return orig_engine(*a, **kw)

    monkeypatch.setattr(si.ServingIndex, "_patched_line", spy_patch)
    monkeypatch.setattr(si, "engine_record_lines", spy_engine)
    spans = _ref_block_spans(sides.store, 4)
    assert len(spans) >= 3
    for c, e in spans[::max(1, len(spans) // 4)][:4]:
        iv = (c + 2, c + 2 + 300)
        with engine_only():
            want = sides.port_text([iv], ref=ref)
        hits_before = hits["engine"]
        assert sides.port_text([iv], ref=ref) == want, iv
        assert sides.jax_text([iv], ref=ref) == want, iv
        assert hits["engine"] == hits_before
    assert hits["patched"] >= 1 and hits["ref"] >= 1


def test_patched_tail_and_1bp_collapse(cohorts, build_now, engine_only):
    """A tail clip rewrites INFO END; a clip collapsing a block to one
    position drops END (rendered only when end > start)."""
    sides = _Sides(cohorts[(0, False)])
    c, e = _ref_block_spans(sides.store, 10)[0]
    mid = (c + e) // 2
    for iv in ((max(0, c - 5), mid), (mid, mid)):
        with engine_only():
            want = sides.port_text([iv])
        assert sides.port_text([iv]) == want, iv
        assert sides.jax_text([iv]) == want, iv
    rec = [ln for ln in want.splitlines() if ln and not ln.startswith("#")]
    assert rec and "END=" not in rec[0].split("\t")[7]


class _FakeStore:
    num_cells = 10


def test_lookup_builds_once_under_concurrent_queries():
    """Threads querying one signature together: one build, every later
    lookup returns the built index (the counter and the building flag
    change under the cache lock)."""
    store = _FakeStore()
    builds = []

    def build():
        builds.append(threading.get_ident())
        time.sleep(0.01)
        return "index"

    got, errors = [], []

    def worker():
        try:
            for _ in range(200):
                got.append(si.lookup(store, ("sig",), build))
        except Exception as e:          # surfaced after join
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(builds) == 1
    assert set(got) == {None, "index"} and got[-1] == "index"
    assert si.lookup(store, ("sig",), build) == "index"


def test_index_slices_stay_sorted(cohorts):
    """The index's record starts parse from its own text and sort."""
    sides = _Sides(cohorts[(1, True)])
    qp = QueryParams()
    qc = driver.make_query_config(qp, sides.vid)
    idx = si.build_index(sides.store, qc, qp, sides.vid, CPU, None)
    assert idx is not None and len(idx.starts) > 100
    assert np.all(np.diff(idx.starts) >= 0)
    assert idx.nbytes() > len(idx.text_blob)


def test_genome_bench_on_the_cpu(capsys, monkeypatch):
    """The port's genome bench at a tiny size on `--device cpu` (its
    inline vid; the served lane's texts checked against the engine
    lane's), and its refusal of `cuda` without a card."""
    import json

    from genomicsdb_tpu_torch.tools import genome_bench
    genome_bench.main(["--samples", "3", "--records", "500", "--device",
                       "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["lines"] > 400
    assert out["interval_10kb_p50_ms"] > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        genome_bench.main(["--device", "cuda"])
