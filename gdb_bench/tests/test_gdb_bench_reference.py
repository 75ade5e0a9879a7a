"""The plain reference equals the program's CPU output, record for
record, and its lower-precision control does not."""

import contextlib
import io
import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")

from gdb_bench import manifest, traffic  # noqa: E402
from gdb_bench.bcf import _float_text, bcf_lines  # noqa: E402
from gdb_bench.cohort import write_cohort  # noqa: E402
from gdb_bench.drivers import lines_wrong  # noqa: E402
from gdb_bench.reference import (Cohort, float_bits,  # noqa: E402
                                 format_float, reference_lines)

BENCH = manifest.load()


def _cohort(tmp_path, config, n_records, seed):
    from genomicsdb_tpu_torch.tools import vcf2gdb
    gen = dict(manifest.config(BENCH, config)["generator"], n_samples=24,
               n_records=n_records)
    c = write_cohort(str(tmp_path), seed=seed, **gen)
    with contextlib.redirect_stdout(io.StringIO()):
        vcf2gdb.main([c.loader])
    return c


def _doc(c, lo, hi):
    with open(c.query) as f:
        q = json.load(f)
    q["query_column_ranges"] = [{"range_list": [{"low": lo, "high": hi}]}]
    return q


@pytest.mark.parametrize("config,n_records,intervals", [
    ("human_1000", 300, 8), ("autotetraploid_1000", 150, 4)])
def test_reference_equals_program_scatter(tmp_path, config, n_records,
                                          intervals):
    from genomicsdb_tpu_torch.tools import gdb_query
    c = _cohort(tmp_path, config, n_records, seed=2 ** 31 + 11)
    co = Cohort(c.vcfs, c.vid)
    for i, (lo, hi) in enumerate(traffic.scatter_intervals(c.region,
                                                           intervals)):
        path = tmp_path / f"q{i}.json"
        path.write_text(json.dumps(_doc(c, lo, hi)))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            gdb_query.main(["-j", str(path), "--produce-Broad-GVCF",
                            "--engine", "block", "--device", "cpu"])
        out = buf.getvalue().splitlines()
        ref = reference_lines(co, lo, hi)
        assert len(ref) > 10
        assert lines_wrong(out, ref) == 0
        # the control: floats in bfloat16, the DP sum in int16
        assert lines_wrong(reference_lines(co, lo, hi, "low"), ref) > 0


def test_served_lookups_round_floats_through_text(tmp_path):
    """The served answers equal the reference in every record at
    htslib's six-digit text; their float32 words do not: the program
    encodes BCF2 from its rendered text, so RAW_MQ arrives rounded to
    six digits, while the sum it computed has the reference's bits (its
    own text path, the block writer's `info_fsum`, is the witness).
    This fault keeps the lookup cell out of BENCHMARK.json (PERF.md
    §7): once the answers carry the float32 sum, this test fails and
    the cell can come back."""
    from genomicsdb_tpu_torch.ops import combine_step
    from genomicsdb_tpu_torch.query.stream_server import (
        QueryStreamClient, QueryStreamServer)
    c = _cohort(tmp_path, "human_1000", 400, seed=5)
    co = Cohort(c.vcfs, c.vid)
    sums = []
    inner = combine_step.masked_seq_sum_float

    def seq_sum(vals, ok):
        out = inner(vals, ok)
        sums.extend(float_bits(v) for v, k in zip(out[0].reshape(-1).numpy(),
                                                  out[1].reshape(-1).numpy())
                    if k)
        return out
    srv = QueryStreamServer("127.0.0.1", 0, device="cpu")
    srv.start_background()
    rounded = 0
    try:
        stream = traffic.lookup_stream(c.region, 2000, 5, 0)
        with QueryStreamClient(*srv.address) as cl:
            for k in range(6):      # the index builds on the second
                lo, hi = next(stream)
                if k == 5:          # an engine-lane lookup, sums seen
                    os.environ["GENOMICSDB_TPU_SERVING_INDEX"] = "0"
                    combine_step.masked_seq_sum_float = seq_sum
                try:
                    data = cl.query(_doc(c, lo, hi))
                finally:
                    combine_step.masked_seq_sum_float = inner
                    os.environ.pop("GENOMICSDB_TPU_SERVING_INDEX", None)
                ref = reference_lines(co, lo, hi)
                assert ref and lines_wrong(bcf_lines(data), ref) == 0
                bits = reference_lines(co, lo, hi, floats=float_bits)
                out = bcf_lines(data, float_bits)
                rounded += lines_wrong(out, bits)
                for a, b in zip(out, bits):
                    if a == b:
                        continue
                    raw = [t for t in b.split("\t")[7].split(";")
                           if t.startswith("RAW_MQ=")][0][7:]
                    x = np.uint32(int(raw, 16)).view(np.float32)
                    six = float_bits(np.float32(format_float(x)))
                    assert f"RAW_MQ={six}" in a.split("\t")[7]
    finally:
        srv.shutdown()
    assert rounded > 0
    # the program's own sum, before the text, has the reference's bits
    ref_sums = {t[7:] for line in bits for t in line.split("\t")[7].split(";")
                if t.startswith("RAW_MQ=")}
    assert ref_sums and ref_sums <= set(sums)


def test_lookup_floats_compare_as_float32_bits():
    x = np.float32(1234.5677)
    y = np.nextafter(x, np.float32(np.inf))
    assert format_float(x) == format_float(y)       # six digits hide it
    assert float_bits(x) != float_bits(y)
    raw = np.array([x, y], np.float32).tobytes()
    assert _float_text(raw, float_bits) == f"{float_bits(x)},{float_bits(y)}"


LOOKUP_CELL = {"name": "human1000.interval_engine", "config": "human_1000",
               "traffic": "lookup10kb_engine", "chips": 1}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]]
                         + [LOOKUP_CELL["name"]])
def test_control_fails_the_comparison(cell):
    from gdb_bench.control import control_reading
    w = LOOKUP_CELL if cell == LOOKUP_CELL["name"] \
        else manifest.workload(BENCH, cell)
    cfg = manifest.config(BENCH, w["config"])
    cfg["generator"] = dict(cfg["generator"], n_samples=24, n_records=200)
    got = control_reading(BENCH, w, 2 ** 31 + 9, cfg)
    assert got["records"] > 0
    assert got["records_wrong_exact"] == 0
    assert got["records_wrong_control"] > 0
