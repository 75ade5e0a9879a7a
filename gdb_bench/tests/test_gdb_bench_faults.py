"""A run whose timed path is broken underneath comes out not correct:
everything of a run but the look for a card, on the CPU at a small
size, once for each fault the cells can have (one card: no exchange
between cards to leave out).

The lookup kind is held to it too, though no cell of BENCHMARK.json
runs it now: its answers carry RAW_MQ rounded through six-digit text,
not the float32 sum (PERF.md §7, `test_gdb_bench_reference.py`), so
here its check renders floats as text, to test the sampling and the
comparison apart from that fault."""

import time

import pytest

pytest.importorskip("torch")

from gdb_bench import manifest  # noqa: E402
from gdb_bench.run import run_cell  # noqa: E402

BENCH = manifest.load()
LOOKUP_CELL = {"name": "human1000.interval_engine", "config": "human_1000",
               "traffic": "lookup10kb_engine", "chips": 1}


def _run(cell, fault, n_records=120):
    if isinstance(cell, str):
        cell = manifest.workload(BENCH, cell)
    cfg = manifest.config(BENCH, cell["config"])
    cfg["generator"] = dict(cfg["generator"], n_samples=16,
                            n_records=n_records)
    return run_cell(BENCH, cell, 2 ** 31 + 3, 2.0, False, "cpu",
                    time.perf_counter(), cfg=cfg, fault=fault)


def _scatter_fault(kind, monkeypatch):
    from genomicsdb_tpu_torch.query import block_writer
    from genomicsdb_tpu_torch.tools import gdb_query

    def install(driver):
        if kind == "altered":
            inner = block_writer.combine_block

            def combine_block(blk, device, **kw):
                out = inner(blk, device, **kw)
                out["pl"][0, 0, 0] += 1
                return out
            monkeypatch.setattr(block_writer, "combine_block",
                                combine_block)
            return
        inner = gdb_query.run_rank
        first = []

        def run_rank(*a, **k):
            text = inner(*a, **k)
            if kind == "unchanged":          # the first answer, again
                first.append(text)
                return first[0]
            lines = text.splitlines(True)    # half of the records
            return "".join(lines[::2])
        monkeypatch.setattr(gdb_query, "run_rank", run_rank)
    return install


def _lookup_fault(kind, monkeypatch):
    from genomicsdb_tpu_torch.query import driver as qdriver

    def install(driver):
        if kind == "altered":
            _scatter_fault("altered", monkeypatch)(driver)
            return
        inner = qdriver.iter_vcf_query_block
        first = []

        def iter_vcf_query_block(store, qc, qp, *a, **k):
            first.append((qc, qp))
            if kind == "unchanged":          # the first answer, again
                qc, qp = first[0]
                yield from inner(store, qc, qp, *a, **k)
                return
            if kind == "late" and len(first) < 3:
                # sound for the warm-up and the window's first lookup
                yield from inner(store, qc, qp, *a, **k)
                return
            for chunk in inner(store, qc, qp, *a, **k):
                lines = chunk.split("\n")     # half of the records
                yield "\n".join(lines[::2])
        monkeypatch.setattr(qdriver, "iter_vcf_query_block",
                            iter_vcf_query_block)
    return install


@pytest.mark.parametrize("cell", ["human1000.scatter_combine",
                                  "autotetraploid1000.scatter_combine"])
@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_scatter_fault_is_not_correct(monkeypatch, cell, kind):
    res = _run(cell, _scatter_fault(kind, monkeypatch))
    assert res["attempted"] > 1
    assert res["correct"] is False
    assert res["checks"]["records_wrong"]["value"] > 0


@pytest.fixture
def text_floats(monkeypatch):
    """The lookup kind, as the run loads it, with text floats."""
    from gdb_bench.reference import format_float
    real = manifest.kind_module

    def kind_module(kind):
        mod = real(kind)
        if kind == "interval_lookup":
            mod.FLOATS = format_float
        return mod
    monkeypatch.setattr(manifest, "kind_module", kind_module)


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered", "late"])
def test_lookup_fault_is_not_correct(monkeypatch, text_floats, kind):
    res = _run(LOOKUP_CELL, _lookup_fault(kind, monkeypatch), n_records=400)
    assert res["correct"] is False
    assert res["checks"]["records_wrong"]["value"] > 0


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_sound_run_is_correct(cell):
    res = _run(cell, None)
    assert res["correct"] is True, res
    assert res["checks"]["records_wrong"]["value"] == 0


def test_sound_lookup_run_is_correct(text_floats):
    res = _run(LOOKUP_CELL, None, n_records=400)
    assert res["correct"] is True, res
    assert res["checks"]["records_wrong"]["value"] == 0
    # the sample holds each client's last lookup of the window
    assert res["attempted"] >= 2
