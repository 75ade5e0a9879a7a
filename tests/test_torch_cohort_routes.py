"""The port's block engine on the cohorts users run beyond diploid
bi-allelic calls, end to end on the CPU against the JAX package.

Each case is a seeded cohort from `genomicsdb_tpu_torch.testing.
write_cohort` whose data sends the engine's blocks down one of its
device routes (`fused_combine.combine_block`):

  a  haploid stretch + triploid samples + phased calls: the kernel's
     mixed-ploidy instantiation (`combine_block.mixed_blocks`)
  b  hotspots merging past 16 alleles: the general combine step
     (`combine_block.general_path_blocks`)
  c  PL past int16: the wide kernel while packing
     (`combine_block.wide_blocks_when_packing`)
  d  all of a and b together
  e  haploid stretch + phased calls + hotspots without triploid
     samples (the options of chip_smoke.py's route cohort): diploid
     blocks in the first third, mixed ones in the middle third, general
     ones in the last
  f  every sample tetraploid (an autotetraploid crop's cohort): the
     kernel's non-mixed ploidy-4 launches (its polyploid family on the
     card)
  g  every sample triploid, with a share of phased calls: non-mixed
     ploidy-3 launches of phased GT storage

The files are written twice, into one directory per package, and each
package imports its copy with its own vcf2gdb.  The port's gdb_query on
the CPU device, with the fetch pack off and on, must give the JAX
tool's `--engine block` text under GENOMICSDB_TPU_FUSED=1
GENOMICSDB_TPU_PACK=1 (its Pallas kernel in interpret mode) byte for
byte.  That engine is the port's oracle; on every case here it also
equals the JAX sequential engine, which is asserted too.
"""

import contextlib
import hashlib
import io
import json
import os
import signal
import subprocess
import sys

import pytest
import torch

from genomicsdb_tpu.tools import gdb_query as jax_gdb_query
from genomicsdb_tpu.tools import vcf2gdb as jax_vcf2gdb
from genomicsdb_tpu_torch.core.config import QueryParams
from genomicsdb_tpu_torch.core.vid import VidMapper
from genomicsdb_tpu_torch.ops import fused_combine as FC
from genomicsdb_tpu_torch.query import block_writer as BW
from genomicsdb_tpu_torch.query import driver
from genomicsdb_tpu_torch.query import serving_index as si
from genomicsdb_tpu_torch.store import workspace as ws
from genomicsdb_tpu_torch.testing import write_cohort
from genomicsdb_tpu_torch.tools import gdb_query as torch_gdb_query
from genomicsdb_tpu_torch.tools import vcf2gdb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TIMEOUT_S = 180

CASES = {
    "a": dict(haploid_stretch=True, triploid_every=5, phased_share=0.3),
    "b": dict(hotspots=6),
    "c": dict(high_pl=0.02),
    "d": dict(haploid_stretch=True, triploid_every=5, phased_share=0.3,
              hotspots=6),
    "e": dict(haploid_stretch=True, phased_share=0.3, hotspots=6),
    "f": dict(ploidy=4),
    "g": dict(ploidy=3, phased_share=0.3),
}
SIZE = dict(n_samples=24, n_records=150, seed=11, n_groups=4)
COUNTERS = ("blocks", "mixed_blocks", "general_path_blocks",
            "wide_blocks_when_packing")


def _run(main, argv, **kw) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv, **kw)
    return buf.getvalue()


def _counts():
    return {k: getattr(FC.combine_block, k) for k in COUNTERS}


def _since(before):
    now = _counts()
    return {k: now[k] - before[k] for k in COUNTERS}


class _Routes:
    """The cases' cohorts and texts, each made once per module: the
    same files written twice, each copy imported by its own package's
    vcf2gdb."""

    def __init__(self, tmp_path_factory):
        self._tmp = tmp_path_factory
        self._cohorts, self._oracle, self.unsharded = {}, {}, {}

    def cohort(self, case):
        """(the port's cohort, the JAX package's cohort)."""
        if case not in self._cohorts:
            base = self._tmp.mktemp(f"route_{case}")
            port = write_cohort(str(base / "port"), **SIZE, **CASES[case])
            jax = write_cohort(str(base / "jax"), **SIZE, **CASES[case])
            vcf2gdb.main([port.loader])
            jax_vcf2gdb.main([jax.loader])
            self._cohorts[case] = (port, jax)
        return self._cohorts[case]

    def oracle(self, case) -> str:
        """The JAX tool's `--engine block` text, with its fused kernel
        and the pack."""
        if case not in self._oracle:
            argv = ["-j", self.cohort(case)[1].query,
                    "--produce-Broad-GVCF", "--engine", "block"]
            with pytest.MonkeyPatch.context() as m:
                m.setenv("GENOMICSDB_TPU_FUSED", "1")
                m.setenv("GENOMICSDB_TPU_PACK", "1")
                self._oracle[case] = _run(jax_gdb_query.main, argv)
        return self._oracle[case]


@pytest.fixture(scope="module")
def routes(tmp_path_factory):
    return _Routes(tmp_path_factory)


def _assert_routes(case, got, packed):
    """The case's routes ran, by the counters of one query over chunks
    of 40 records."""
    assert got["blocks"] > 10
    if case in ("a", "d", "e"):
        assert got["mixed_blocks"] > 0, got
    else:
        assert got["mixed_blocks"] == 0, got
    if case in ("b", "d", "e"):
        assert got["general_path_blocks"] > 0, got
    else:
        assert got["general_path_blocks"] == 0, got
    if case == "c" and packed:
        assert got["wide_blocks_when_packing"] == got["blocks"], got
    else:
        assert got["wide_blocks_when_packing"] == 0, got
    if case == "e":             # diploid blocks as well as mixed ones
        assert got["mixed_blocks"] + got["general_path_blocks"] \
            < got["blocks"], got


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_equals_jax_block_engine(case, routes, monkeypatch):
    """gdb_query --device cpu, pack off and on, against the JAX tool's
    fused, packed block engine (and its sequential engine)."""
    port_c, jax_c = routes.cohort(case)
    monkeypatch.setenv("GENOMICSDB_TPU_SERVING_INDEX", "0")
    argv = ["-j", port_c.query, "--produce-Broad-GVCF", "--device", "cpu"]
    before = _counts()
    plain = routes.unsharded[case] = _run(torch_gdb_query.main, argv,
                                          pack=False)
    packed = _run(torch_gdb_query.main, argv, pack=True)
    got = _since(before)
    # one chunk: the route of its widest data (a uniform-ploidy cohort's
    # is the kernel's non-mixed form, counted by none of the three)
    if case in ("f", "g"):
        assert got["blocks"] == 2 and sum(got.values()) == 2, got
    else:
        route = {"a": "mixed_blocks", "c": "wide_blocks_when_packing"}.get(
            case, "general_path_blocks")
        assert got[route] == got["blocks"] // (2 if case == "c" else 1) > 0
    jax_block = routes.oracle(case)
    jax_seq = _run(jax_gdb_query.main, ["-j", jax_c.query,
                                        "--produce-Broad-GVCF",
                                        "--engine", "sequential"])
    lines = plain.splitlines()
    assert len(lines) > 500
    samples = [ln.split("\t")[9:] for ln in lines if not ln.startswith("#")]
    gts = {cell.split(":", 1)[0] for row in samples for cell in row}
    # GT is not produced: its rendered width shows each call's ploidy
    # and phase
    if CASES[case].get("haploid_stretch"):
        assert "." in gts
    if CASES[case].get("triploid_every"):
        assert "././." in gts
    if "ploidy" in CASES[case]:           # every call of that ploidy
        p = CASES[case]["ploidy"]            # ("." : a sample with no call)
        assert {g.replace("|", "/") for g in gts} - {"."} \
            == {"/".join("." * p)}
    if CASES[case].get("phased_share"):   # the first separator phased
        assert ".|." + "/." * (CASES[case].get("ploidy", 2) - 2) in gts
    if CASES[case].get("hotspots"):       # more than 16 merged alleles
        assert max(ln.split("\t")[4].count(",") for ln in lines
                   if not ln.startswith("#")) >= 15
    assert packed == jax_block
    assert plain == jax_block
    assert jax_seq == jax_block


def _gt_query(c) -> str:
    """A copy of the cohort's query JSON with produce_GT_field on."""
    with open(c.query) as f:
        doc = json.load(f)
    doc["produce_GT_field"] = True
    path = os.path.join(c.dir, "query_gt.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


@pytest.mark.parametrize("case", ["a", "e"])
def test_produced_gt_equals_jax_block_engine(case, routes, monkeypatch):
    """With GT produced, the remapped alleles and phase slots of haploid,
    triploid and phased calls come through the kernel's mixed form, the
    narrow int16 GT and the pack's widen: the port's text, pack off and
    on, equals the JAX tool's fused, packed block engine (and its
    sequential engine)."""
    port_c, jax_c = routes.cohort(case)
    monkeypatch.setenv("GENOMICSDB_TPU_SERVING_INDEX", "0")
    argv = ["-j", _gt_query(port_c), "--produce-Broad-GVCF", "--device",
            "cpu"]
    before = _counts()
    plain = _run(torch_gdb_query.main, argv, pack=False)
    packed = _run(torch_gdb_query.main, argv, pack=True)
    if case == "a":             # one chunk each: the kernel's mixed form
        assert _since(before)["mixed_blocks"] == 2
    jax_argv = ["-j", _gt_query(jax_c), "--produce-Broad-GVCF"]
    with monkeypatch.context() as m:
        m.setenv("GENOMICSDB_TPU_FUSED", "1")
        m.setenv("GENOMICSDB_TPU_PACK", "1")
        jax_block = _run(jax_gdb_query.main, jax_argv + ["--engine",
                                                          "block"])
    jax_seq = _run(jax_gdb_query.main, jax_argv + ["--engine",
                                                   "sequential"])
    gts = {cell.split(":", 1)[0] for ln in plain.splitlines()
           if not ln.startswith("#") for cell in ln.split("\t")[9:]}
    assert {"0", "1"} <= gts                         # haploid calls
    assert any("|" in g and "." not in g for g in gts)
    if case == "a":
        assert any(g.count("/") == 2 for g in gts)   # triploid calls
    assert packed == plain == jax_block == jax_seq


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_over_small_chunks(case, routes, monkeypatch):
    """Chunks of 40 records: chunks that straddle the haploid stretch's
    edges and the hotspots, each with its own mixed-ploidy flag, route
    and (pack on) variant-row split, give the JAX block engine's
    one-chunk text."""
    port_c, _ = routes.cohort(case)
    monkeypatch.setenv("GENOMICSDB_TPU_SERVING_INDEX", "0")
    qp = QueryParams.from_file(port_c.query, 0)
    vid = VidMapper.from_files(port_c.vid, port_c.callsets)
    store = ws.open_array(port_c.workspace, port_c.array)

    def query(**kw):
        qc = driver.make_query_config(qp, vid)
        return driver.run_vcf_query_block(store, qc, qp, vid, CPU, **kw)

    whole = routes.oracle(case)
    for pack in (False, True):
        before = _counts()
        split0 = BW.render_block_vcf_pipelined.split_blocks
        chunked = query(pack=pack, max_records_per_block=40)
        _assert_routes(case, _since(before), packed=pack)
        if pack:
            assert BW.render_block_vcf_pipelined.split_blocks > split0
        assert chunked == whole


def _run_tool(argv):
    """stdout of `python -m genomicsdb_tpu_torch.tools.gdb_query argv`
    in a session of its own; on timeout the tool and every rank it
    spawned are killed."""
    p = subprocess.Popen([sys.executable, "-m",
                          "genomicsdb_tpu_torch.tools.gdb_query", *argv],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, cwd=ROOT, start_new_session=True)
    try:
        out, err = p.communicate(timeout=TIMEOUT_S)
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    assert p.returncode == 0, err[-3000:]
    return out


def test_mesh_2x2_equals_unsharded(routes):
    """Cohort d on `gdb_query --mesh 2x2 --device cpu` (four gloo
    ranks): per-call GT lengths and phase slots go through the row
    scatter and the row all-gather, and the text is the unsharded
    port's."""
    port_c, _ = routes.cohort("d")
    argv = ["-j", port_c.query, "--produce-Broad-GVCF", "--device", "cpu"]
    if "d" not in routes.unsharded:
        routes.unsharded["d"] = _run(torch_gdb_query.main, argv)
    assert _run_tool(argv + ["--mesh", "2x2"]) == routes.unsharded["d"]


def test_serving_index_edges_in_the_haploid_stretch(routes, monkeypatch):
    """Cohort a with the serving index on: three intervals whose edges
    fall inside the haploid stretch are served byte-equal to the engine
    lane (the index patches each interval's edge records)."""
    port_c, _ = routes.cohort("a")
    monkeypatch.setattr(si, "BUILD_AFTER_QUERIES", 1)
    vid = VidMapper.from_files(port_c.vid, port_c.callsets)
    store = ws.open_array(port_c.workspace, port_c.array)
    r = port_c.region
    lo, hi = r // 3, 2 * r // 3
    step = (hi - lo) // 8
    intervals = [(lo + step + 1, lo + 3 * step), (lo + 4 * step - 7,
                 lo + 4 * step + 5), (lo + 5 * step + 3, hi - step)]

    def text(iv):
        qp = QueryParams()
        qp.column_ranges = [[iv]]
        qc = driver.make_query_config(qp, vid)
        return driver.run_vcf_query_block(store, qc, qp, vid, CPU)

    monkeypatch.setenv("GENOMICSDB_TPU_SERVING_INDEX", "0")
    engine = [text(iv) for iv in intervals]
    monkeypatch.delenv("GENOMICSDB_TPU_SERVING_INDEX")
    text(intervals[0])          # the signature's first query: no index
    served = [text(iv) for iv in intervals]
    assert [e[1] is not None for e in store._serving_idx_cache.values()] \
        == [True]
    assert served == engine
    assert all(engine)


def _digest(d: str) -> str:
    h = hashlib.sha256()
    for name in sorted(os.listdir(d)):
        p = os.path.join(d, name)
        if os.path.isfile(p):
            with open(p, "rb") as f:
                h.update(name.encode() + b"\0"
                         + f.read().replace(d.encode(), b"@"))
    return h.hexdigest()


def test_default_options_write_the_former_files(tmp_path):
    """With every option at its default, write_cohort(dir, 1000, 4000,
    seed=0) writes the files it wrote before the options existed (their
    digest, the directory's path taken out of the JSON files)."""
    write_cohort(str(tmp_path), 1000, 4000, seed=0)
    assert _digest(str(tmp_path)) == \
        "d11f4a2da2bfd9dd115c4366ec7ce229992c9e31883f0e0666c74d502880a40d"
