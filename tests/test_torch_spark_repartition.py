"""The port's Spark split layer and repartitioning on a
`testing.write_cohort` fixture: `get_splits` equals the JAX package's;
`build_rdd` on the process-isolated `LocalSparkContext` equals the
in-process per-rank split reads and the JAX package's; the per-split
combined VCF (block engine on the CPU) concatenates to the whole query;
`repartition` equals a partitioned import (the port's and the JAX
package's) from one store and from several."""

import contextlib
import io
import json
import os

import numpy as np
import pytest

from genomicsdb_tpu.core.config import ImportParams as JImportParams
from genomicsdb_tpu.core.config import QueryParams as JQueryParams
from genomicsdb_tpu.core.vid import VidMapper as JVidMapper
from genomicsdb_tpu.parallel import spark_api as jspark
from genomicsdb_tpu.store.import_pipeline import \
    import_callsets as j_import_callsets
from genomicsdb_tpu_torch.core.config import ImportParams, QueryParams
from genomicsdb_tpu_torch.core.vid import VidMapper
from genomicsdb_tpu_torch.parallel import spark_api
from genomicsdb_tpu_torch.parallel.local_spark import LocalSparkContext
from genomicsdb_tpu_torch.parallel.repartition import repartition
from genomicsdb_tpu_torch.query import driver
from genomicsdb_tpu_torch.store.import_pipeline import import_callsets
from genomicsdb_tpu_torch.testing import write_cohort
from genomicsdb_tpu_torch.tools import gdb_query


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    return write_cohort(str(tmp_path_factory.mktemp("spark")), 6, 120,
                        seed=14, n_groups=2)


def _begins(c, n):
    return np.linspace(0, c.region, n + 1).astype(int)[:-1].tolist()


def _loader(c, n):
    path = os.path.join(c.dir, f"spark_loader{n}.json")
    with open(path, "w") as f:
        json.dump({"column_partitions": [
            {"begin": b, "workspace": os.path.join(c.dir, f"sws{n}"),
             "array_name": f"p{i}"} for i, b in enumerate(_begins(c, n))],
            "callset_mapping_file": c.callsets, "vid_mapping_file": c.vid,
            "treat_deletions_as_intervals": True}, f)
    return path


def _qp(cls, lo, hi):
    qp = cls()
    qp.column_ranges = [[(lo, hi)]]
    qp.attributes = []
    return qp


@pytest.mark.parametrize("block", [0, 5000])
def test_splits_match_jax(cohort, block):
    loader = _loader(cohort, 3)
    got = spark_api.get_splits(ImportParams.from_file(loader, 0),
                               _qp(QueryParams, 0, cohort.region), block)
    want = jspark.get_splits(JImportParams.from_file(loader, 0),
                             _qp(JQueryParams, 0, cohort.region), block)
    assert len(got) >= 3
    assert [tuple(vars(s).values()) for s in got] \
        == [tuple(vars(s).values()) for s in want]


def test_build_rdd_on_local_context_matches_split_reads(cohort):
    """build_rdd EXECUTES on a local[2] context: the task closure ships
    by pickle to fresh interpreters, each re-imports its split's
    partition from the loader; the partition-ordered collect equals the
    in-process split reads and the JAX package's."""
    loader = _loader(cohort, 2)
    ip = ImportParams.from_file(loader, 0)
    vid = VidMapper.from_files(cohort.vid, cohort.callsets)
    qp = _qp(QueryParams, 0, cohort.region)
    rdd = spark_api.build_rdd(LocalSparkContext(parallelism=2), ip, qp, vid,
                              query_block_size=20000)
    got = [(c, p) for c, p, _ in rdd.collect()]
    want = []
    for s in spark_api.get_splits(ip, qp, 20000):
        store = driver.build_store_from_loader(ip, vid, s.rank)
        want.extend((c, p) for c, p, _ in
                    spark_api.read_split(s, qp, vid, store=store))
    assert got == want and len(got) > 50
    jip = JImportParams.from_file(loader, 0)
    jvid = JVidMapper.from_files(cohort.vid, cohort.callsets)
    jqp = _qp(JQueryParams, 0, cohort.region)
    jwant = [(c, p) for s in jspark.get_splits(jip, jqp, 20000)
             for c, p, _ in jspark.read_split(s, jqp, jvid, ip=jip)]
    assert got == jwant


def test_split_vcf_concatenates_to_the_whole_query(cohort):
    """render_split_vcf (block engine on the CPU) over one partition's
    query blocks, in split order, gives the whole query's records."""
    path = os.path.join(cohort.dir, "spark_loader1.json")
    with open(path, "w") as f:
        json.dump({"column_partitions": [{"begin": 0}],
                   "callset_mapping_file": cohort.callsets,
                   "vid_mapping_file": cohort.vid,
                   "treat_deletions_as_intervals": True}, f)
    ip = ImportParams.from_file(path, 0)
    vid = VidMapper.from_files(cohort.vid, cohort.callsets)
    qp = _qp(QueryParams, 0, cohort.region)
    lines = []
    for s in spark_api.get_splits(ip, qp):
        lines += spark_api.render_split_vcf(s, qp, vid, ip, device="cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        gdb_query.main(["-j", cohort.query, "--produce-Broad-GVCF",
                        "--device", "cpu"])
    want = [ln for ln in buf.getvalue().split("\n")
            if ln and not ln.startswith("#")]
    starts = {ln.split("\t")[1] for ln in lines}
    assert len(lines) == len(want) > 50 and len(starts) == len(lines)
    assert lines == want


def _same_store(a, b, label):
    assert np.array_equal(a.col, b.col), label
    assert np.array_equal(a.row, b.row), label
    assert np.array_equal(a.end, b.end), label
    assert sorted(a.fields) == sorted(b.fields), label
    for name in a.fields:
        assert np.array_equal(a.fields[name].valid, b.fields[name].valid), \
            f"{label} {name}"


@pytest.mark.parametrize("shards", [1, 2])
def test_repartition_matches_partitioned_import(cohort, shards):
    """Re-sharding one whole store, or two partition stores, onto three
    new begins equals importing with those partitions, by the port and
    by the JAX package."""
    vid = VidMapper.from_files(cohort.vid, cohort.callsets)
    mid = cohort.region // 2
    sources = [import_callsets(vid)] if shards == 1 else [
        import_callsets(vid, column_partition=(0, mid - 1)),
        import_callsets(vid, column_partition=(mid, None))]
    begins = _begins(cohort, 3)
    parts = repartition(sources, begins)
    assert len(parts) == 3
    jvid = JVidMapper.from_files(cohort.vid, cohort.callsets)
    for i, b in enumerate(begins):
        e = begins[i + 1] - 1 if i + 1 < len(begins) else None
        _same_store(parts[i], import_callsets(vid, column_partition=(b, e)),
                    f"part {i} vs the port's import")
        _same_store(parts[i], j_import_callsets(jvid,
                                                column_partition=(b, e)),
                    f"part {i} vs the JAX import")
