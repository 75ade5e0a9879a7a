"""The port's multi-host driver (`genomicsdb_tpu_torch.parallel.multihost`)
in 2 and 3 gloo CPU processes: gatherv semantics (blob lengths that
include 0, GATHER_CHUNK lowered to force several rounds), and a
partitioned variants query whose gathered blob equals the JAX package's
`serialize_variants` of the same partitions, byte for byte.  Each run
has its own timeout and kills its processes on failure.
"""

import os

import numpy as np
import pytest

from genomicsdb_tpu.core.config import QueryParams as JQueryParams
from genomicsdb_tpu.core.vid import VidMapper as JVidMapper
from genomicsdb_tpu.query import driver as jdriver
from genomicsdb_tpu.query import serialize as jserialize
from genomicsdb_tpu.query.variants_path import \
    gt_get_column_interval as j_interval
from genomicsdb_tpu.store import workspace as jws
from genomicsdb_tpu_torch.core.config import QueryParams
from genomicsdb_tpu_torch.core.vid import VidMapper
from genomicsdb_tpu_torch.parallel import multihost
from genomicsdb_tpu_torch.query import driver, serialize
from genomicsdb_tpu_torch.query.variants_path import gt_get_column_interval
from genomicsdb_tpu_torch.store import workspace as ws
from genomicsdb_tpu_torch.testing import write_cohort
from genomicsdb_tpu_torch.tools import vcf2gdb

from test_torch_sharded import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PARTS = 4

WORKER = r"""
import os, sys
sys.path.insert(0, %(root)r)
import numpy as np
from genomicsdb_tpu_torch.core.config import QueryParams
from genomicsdb_tpu_torch.core.vid import VidMapper
from genomicsdb_tpu_torch.parallel import multihost
from genomicsdb_tpu_torch.query import driver, serialize
from genomicsdb_tpu_torch.query.variants_path import gt_get_column_interval
from genomicsdb_tpu_torch.store import workspace as ws
workspace, array, vid_f, cs_f, bounds, out = sys.argv[1:7]
multihost.GATHER_CHUNK = 7
multihost.initialize(coordinator=os.environ["MASTER_ADDR"] + ":"
                     + os.environ["MASTER_PORT"],
                     num_processes=int(os.environ["WORLD_SIZE"]),
                     process_id=int(os.environ["RANK"]))
pid = int(os.environ["RANK"])
n = int(os.environ["WORLD_SIZE"])
# raw gatherv: lengths 0, 14, 28 (several 7-byte rounds)
blob = bytes(np.random.default_rng(pid).integers(0, 256, (pid * 14) %% 30,
                                                 dtype=np.uint8))
got = multihost.gather_blobs_to_root(blob)
vid = VidMapper.from_files(vid_f, cs_f)
store = ws.open_array(workspace, array)
bounds = [int(x) for x in bounds.split(",")]

def run_rank(p):
    qp = QueryParams()
    qp.column_ranges = [[(bounds[p], bounds[p + 1] - 1)]]
    qp.attributes = []
    qc = driver.make_query_config(qp, vid)
    return serialize.serialize_variants(
        gt_get_column_interval(store, qc, qc.column_intervals[0]), qc)

parts = multihost.my_partitions(%(n_parts)d)
text = multihost.run_partitioned_query(run_rank, parts)
if pid == 0:
    want = [bytes(np.random.default_rng(i).integers(
        0, 256, (i * 14) %% 30, dtype=np.uint8)) for i in range(n)]
    assert got == want, [len(g) for g in got]
    with open(out, "wb") as f:
        f.write(text)
else:
    assert got is None and text is None
print("RANK_OK", pid, parts)
"""


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    c = write_cohort(str(tmp_path_factory.mktemp("mh")), 6, 120, seed=12,
                     n_groups=2)
    vcf2gdb.main([c.loader])
    return c


def _bounds(c):
    """N_PARTS + 1 column bounds over the cohort; the last partition
    lies past its region (an empty blob)."""
    b = np.linspace(0, c.region + 1, N_PARTS).astype(int).tolist()
    return b + [b[-1] + 1000]


@pytest.mark.parametrize("n_procs", [2, 3])
def test_partitioned_gather_equals_the_jax_serialization(tmp_path, cohort,
                                                         n_procs):
    script = tmp_path / "worker.py"
    script.write_text(WORKER % {"root": ROOT, "n_parts": N_PARTS})
    bounds = _bounds(cohort)
    out = tmp_path / "gathered.bin"
    outs = run_ranks(script, [cohort.workspace, cohort.array, cohort.vid,
                              cohort.callsets, ",".join(map(str, bounds)),
                              str(out)], n_procs)
    assert all("RANK_OK" in o for o in outs)
    vid = JVidMapper.from_files(cohort.vid, cohort.callsets)
    store = jws.open_array(cohort.workspace, cohort.array)
    want = b""
    for p in range(N_PARTS):
        qp = JQueryParams()
        qp.column_ranges = [[(bounds[p], bounds[p + 1] - 1)]]
        qp.attributes = []
        qc = jdriver.make_query_config(qp, vid)
        want += jserialize.serialize_variants(
            j_interval(store, qc, qc.column_intervals[0]), qc)
    got = out.read_bytes()
    assert len(got) > 1000
    assert got == want


def test_single_process_is_a_no_op(cohort):
    """Without a process group: initialize does nothing, this process
    owns every partition and the gather returns its own blob."""
    multihost.initialize(num_processes=1)
    assert multihost.my_partitions(5) == [0, 1, 2, 3, 4]
    assert multihost.gather_blobs_to_root(b"abc") == [b"abc"]
    assert multihost.run_partitioned_query(
        lambda p: bytes([p]), [0, 1, 2]) == b"\x00\x01\x02"


def test_serialize_round_trip_matches_jax(cohort):
    """The port's serialize_variants gives the JAX package's bytes for
    the whole store, and its deserialize gives them back."""
    vid = VidMapper.from_files(cohort.vid, cohort.callsets)
    store = ws.open_array(cohort.workspace, cohort.array)
    qp = QueryParams()
    qp.column_ranges = [[(0, cohort.region)]]
    qp.attributes = []
    qc = driver.make_query_config(qp, vid)
    variants = gt_get_column_interval(store, qc, qc.column_intervals[0])
    blob = serialize.serialize_variants(variants, qc)
    jvid = JVidMapper.from_files(cohort.vid, cohort.callsets)
    jqp = JQueryParams()
    jqp.column_ranges = [[(0, cohort.region)]]
    jqp.attributes = []
    jqc = jdriver.make_query_config(jqp, jvid)
    assert blob == jserialize.serialize_variants(
        j_interval(jws.open_array(cohort.workspace, cohort.array), jqc,
                   jqc.column_intervals[0]), jqc)
    back = serialize.deserialize_variants(blob, qc, store)
    assert serialize.serialize_variants(back, qc) == blob
