"""The column window of a command-line combine, on the CPU.

`gdb_query --produce-Broad-GVCF` (the block engine) derives its tables
from the cells of the opened store that can intersect the query's
column ranges (`gdb_query.window_store` through
`fragment_v2.column_window`), not from the whole store.  Its text must
equal, byte for byte, the same query on the whole store (the cut
switched off by patching `gdb_query.column_window`) and the JAX tool's
on the same files, on four cohorts and five kinds of interval edge.
Every other query mode, the out-of-core store and a store kept open
across queries (the stream server's) keep the whole store.  The window
itself is a slice of the store's columns that keeps their global
eff_end values.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from genomicsdb_tpu.tools import gdb_query as jax_gdb_query
from genomicsdb_tpu_torch.core import profile
from genomicsdb_tpu_torch.core.config import QueryParams
from genomicsdb_tpu_torch.core.vid import VidMapper
from genomicsdb_tpu_torch.query import driver
from genomicsdb_tpu_torch.store import workspace as ws
from genomicsdb_tpu_torch.store.columnar import build_store, store_take
from genomicsdb_tpu_torch.store.fragment_v2 import (OocArray, column_window,
                                                    window_bounds)
from genomicsdb_tpu_torch.testing import write_cohort
from genomicsdb_tpu_torch.tools import gdb_query, vcf2gdb

SIZE = dict(n_samples=24, n_records=150, seed=11, n_groups=4)
COHORTS = {
    "diploid": {},                        # 3-base deletions
    "tetraploid": dict(ploidy=4),
    "routes": dict(haploid_stretch=True, phased_share=0.3, hotspots=6),
    "high_pl_triploid": dict(high_pl=0.02, triploid_every=5),
}
EDGES = ("in_ref_block", "in_deletion", "at_cell_start", "two_ranges",
         "beyond_data")
BLOCK = ["--produce-Broad-GVCF", "--device", "cpu"]


def _run(main, argv, **kw) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv, **kw)
    return buf.getvalue()


def _cells():
    return profile.COUNTS.store_cells, profile.COUNTS.window_cells


def _counted(main, argv, **kw):
    """(text, store cells, window cells) of one call."""
    s0, w0 = _cells()
    text = _run(main, argv, **kw)
    s1, w1 = _cells()
    return text, s1 - s0, w1 - w0


class _Cohorts:
    def __init__(self, tmp_path_factory):
        self._tmp = tmp_path_factory
        self._made = {}

    def get(self, name):
        """(cohort, its store opened by the port)."""
        if name not in self._made:
            c = write_cohort(str(self._tmp.mktemp(f"window_{name}")),
                             **SIZE, **COHORTS[name])
            vcf2gdb.main([c.loader])
            self._made[name] = (c, ws.open_array(c.workspace, c.array))
        return self._made[name]


@pytest.fixture(scope="module")
def cohorts(tmp_path_factory):
    return _Cohorts(tmp_path_factory)


def _query(cohort, name, ranges) -> str:
    """A query file of `cohort`'s store over `ranges` (None: no column
    ranges, the whole store)."""
    with open(cohort.query) as f:
        doc = json.load(f)
    if ranges is None:
        del doc["query_column_ranges"]
    else:
        doc["query_column_ranges"] = [{"range_list": [
            {"low": int(lo), "high": int(hi)} for lo, hi in ranges]}]
    path = f"{cohort.dir}/{name}.json"
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def _first(store, frac: float, ok) -> int:
    """The column of the first cell at or past `frac` of the store's
    columns for which ok(cell index) holds."""
    col = store.col
    i = int(np.searchsorted(col, int(col[-1] * frac)))
    while not ok(i):
        i += 1
    return int(col[i])


def _ranges(store, region: int, edge: str):
    span = store.end - store.col
    ref_len = store.fields["REF"].lens()
    if edge == "in_ref_block":        # two positions into a long block
        block = lambda i: span[i] >= 5                       # noqa: E731
        return [(_first(store, 0.2, block) + 2,
                 _first(store, 0.75, block) + 2)]
    if edge == "in_deletion":         # one base into a 3-base deletion
        dele = lambda i: ref_len[i] == 3                      # noqa: E731
        return [(_first(store, 0.45, dele) + 1,
                 _first(store, 0.85, dele) + 1)]
    if edge == "at_cell_start":
        anycell = lambda i: True                              # noqa: E731
        return [(_first(store, 0.7, anycell),
                 _first(store, 0.95, anycell))]
    if edge == "two_ranges":
        return [(region // 8, region // 4),
                (5 * region // 8, 7 * region // 8)]
    return [(region + 100, region + 400)]       # beyond the data


@pytest.mark.parametrize("edge", EDGES)
@pytest.mark.parametrize("name", sorted(COHORTS))
def test_window_equals_whole_store_and_the_jax_tool(cohorts, name, edge,
                                                    monkeypatch):
    cohort, store = cohorts.get(name)
    query = _query(cohort, edge, _ranges(store, cohort.region, edge))
    cut, opened, window = _counted(gdb_query.main, ["-j", query] + BLOCK)
    assert opened == store.num_cells
    assert window < opened
    if edge != "beyond_data":
        assert window > 0
        assert len(cut.splitlines()) > 5
    else:
        assert cut == ""
    with monkeypatch.context() as m:
        m.setattr(gdb_query, "column_window", lambda s, lo, hi: s)
        whole, opened, window = _counted(gdb_query.main,
                                         ["-j", query] + BLOCK)
    assert window == opened == store.num_cells
    assert cut == whole
    assert cut == _run(jax_gdb_query.main,
                       ["-j", query, "--produce-Broad-GVCF"])


@pytest.mark.parametrize("ranges", ["none", "region"])
def test_a_whole_store_query_is_not_cut(cohorts, ranges):
    cohort, store = cohorts.get("diploid")
    query = _query(cohort, f"whole_{ranges}",
                   None if ranges == "none" else [(0, cohort.region)])
    text, opened, window = _counted(gdb_query.main, ["-j", query] + BLOCK)
    assert window == opened == store.num_cells
    assert text == _run(jax_gdb_query.main,
                        ["-j", query, "--produce-Broad-GVCF"])


@pytest.mark.parametrize("mode", ["ooc", "paged", "print_calls"])
def test_other_modes_open_the_whole_store(cohorts, mode, monkeypatch):
    """--ooc streams windows of its own, -p and --print-calls run on the
    store as opened: none of them is cut."""
    cohort, store = cohorts.get("diploid")
    query = _query(cohort, "scatter", [(cohort.region // 4,
                                        cohort.region // 2)])
    extra = {"ooc": BLOCK + ["--ooc", "-s", "16384"],
             "paged": BLOCK + ["-p", "4096"],
             "print_calls": ["--print-calls", "--device", "cpu"]}[mode]
    seen = []
    load = gdb_query.load_context

    def spy(args, rank):
        got = load(args, rank)
        seen.append(got[3])
        return got

    monkeypatch.setattr(gdb_query, "load_context", spy)
    text, opened, window = _counted(gdb_query.main, ["-j", query] + extra)
    (got,) = seen
    if mode == "ooc":
        assert isinstance(got, OocArray)
        got = got.store
    assert got.num_cells == window == opened == store.num_cells
    jax_argv = ["-j", query] + [a for a in extra
                                if a not in ("--device", "cpu")]
    assert text == _run(jax_gdb_query.main, jax_argv)
    if mode != "print_calls":
        assert text == _run(gdb_query.main, ["-j", query] + BLOCK)


def test_a_kept_open_store_keeps_its_store_wide_tables(cohorts,
                                                       monkeypatch):
    """The stream server's path: queries of one open store through
    iter_vcf_query_block derive the tables over the whole store once,
    and a second query rebuilds none."""
    monkeypatch.setenv("GENOMICSDB_TPU_SERVING_INDEX", "0")
    cohort, _ = cohorts.get("diploid")
    store = ws.open_array(cohort.workspace, cohort.array)
    vid = VidMapper.from_files(cohort.vid, cohort.callsets)
    texts = []
    for k, (lo, hi) in enumerate([(cohort.region // 4, cohort.region // 2),
                                  (cohort.region // 2, cohort.region)]):
        query = _query(cohort, f"kept_{k}", [(lo, hi)])
        qp = QueryParams.from_file(query)
        qc = driver.make_query_config(qp, vid)
        rebuilds = profile.COUNTS.store_rebuilds
        lines = list(driver.iter_vcf_query_block(store, qc, qp, vid,
                                                 torch.device("cpu")))
        if k:
            assert profile.COUNTS.store_rebuilds == rebuilds
        texts.append("".join(ln + "\n" for ln in lines))
        assert texts[-1] == _run(gdb_query.main, ["-j", query] + BLOCK)
    held = store.tables.held
    assert len(held["row_layout"][1][0]) == store.num_cells
    assert held["dense_layout"][1] is not None


def _hand_store():
    """Two rows: row 0's cell at 10 (END 30) is truncated to 19 by its
    next cell at 20; a ragged, a string, a 2-D ragged and a fixed
    field."""
    cells = [
        dict(row=0, col=10, end=30, PL=[1, 2, 3], REF="A", F=[[1], [2, 3]],
             DP=[7]),
        dict(row=1, col=12, end=14, PL=[4], REF="CGT", F=[[4, 5]]),
        dict(row=1, col=15, end=40, REF="G", DP=[9]),
        dict(row=0, col=20, end=25, PL=[5, 6], REF="T", F=[[6]], DP=[1]),
        dict(row=1, col=41, end=41, PL=[7, 8, 9], REF="AC"),
    ]
    cells.sort(key=lambda c: (c["col"], c["row"]))
    specs = {"PL": ("ragged", "int32", 0), "REF": ("str", "bytes", 0),
             "F": ("ragged2d", "int32", 0), "DP": ("fixed", "int32", 1)}
    return build_store(cells, list(specs), specs, num_rows=2)


def _assert_fields_equal(got, want):
    for name, fd in want.fields.items():
        w = got.fields[name]
        np.testing.assert_array_equal(w.valid, fd.valid)
        np.testing.assert_array_equal(w.values, fd.values)
        for part in ("offsets", "outer_offsets"):
            if getattr(fd, part) is not None:
                np.testing.assert_array_equal(getattr(w, part),
                                              getattr(fd, part))


@pytest.mark.parametrize("store_of", ["hand", "cohort"])
def test_window_columns_are_a_slice_with_global_eff_end(cohorts, store_of):
    if store_of == "hand":
        store = _hand_store()
        lo, hi = 10, 15
        assert store.eff_end[0] == 19          # truncated by the cell at 20
    else:
        cohort, store = cohorts.get("routes")
        lo, hi = cohort.region // 3, cohort.region // 2
    win = column_window(store, lo, hi)
    i0, i1 = window_bounds(store.col, int((store.end - store.col).max()),
                           lo, hi)
    assert 0 < i1 - i0 < store.num_cells and win.num_cells == i1 - i0
    take = store_take(store, np.arange(i0, i1))
    for name in ("row", "col", "end"):
        np.testing.assert_array_equal(getattr(win, name),
                                      getattr(take, name))
    np.testing.assert_array_equal(win.eff_end, store.eff_end[i0:i1])
    _assert_fields_equal(win, take)
    if store_of == "hand":
        # the cell at 20 is past hi: the window keeps the stored value,
        # where store_take's recomputation loses the truncation
        assert win.col.tolist() == [10, 12, 15] and win.eff_end[0] == 19
        assert take.eff_end[0] == 30
    else:
        # the memory-mapped columns are views, not copies
        assert np.shares_memory(win.col, store.col)
        assert np.shares_memory(win.fields["PL"].values,
                                store.fields["PL"].values)
    # a window holding every cell is the store itself
    assert column_window(store, int(store.col[0]) - 1,
                         int(store.col[-1])) is store
