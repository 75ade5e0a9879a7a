"""The port's protobuf planes (`core/pb_config.py`: QuerySpec /
ImportSpec / VidSpec / CallsetMap; `core/pb_compat.py`: the reference's
wire-compatible ExportConfiguration / ImportConfiguration) against the
JAX package's, on a seeded cohort's configuration files; and the
bindings each plane loads.

Each side parses the same JSON files with its own loaders and builds its
messages with its own bindings; the serialized messages must be equal
bytes and the engine objects they convert into (VidMapper, QueryParams,
ImportParams) equal field by field.  protobuf's default pool gives both
packages one message class per descriptor, so messages are shared data;
the modules that run must be the port's own (`protos.bindings`), with
the JAX package's bindings loaded first or second.
"""

import contextlib
import dataclasses
import io
import os
import subprocess
import sys

import numpy as np
import pytest

from genomicsdb_tpu.core import pb_compat as jpb_compat
from genomicsdb_tpu.core import pb_config as jpb_config
from genomicsdb_tpu.core.vid import VidMapper as JVidMapper
from genomicsdb_tpu.tools import gdb_query as jax_gdb_query
from genomicsdb_tpu_torch.core import pb_compat, pb_config
from genomicsdb_tpu_torch.core.vid import VidMapper
from genomicsdb_tpu_torch.testing import write_cohort
from genomicsdb_tpu_torch.tools import gdb_query, vcf2gdb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "genomicsdb_tpu_torch")


def _plain(x):
    """An engine object as plain data (class names kept, module paths
    dropped), so the two packages' objects compare by value."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: _plain(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if hasattr(x, "__dict__") and not callable(x):
        return (type(x).__name__, _plain(vars(x)))
    return x


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    c = write_cohort(str(tmp_path_factory.mktemp("cohort")), 8, 80, seed=9,
                     n_groups=2)
    vcf2gdb.main([c.loader])
    return c


def _callset_map(mod, vid, stream_names=False):
    cs = mod.CallsetMap()
    for name, c in vid.callsets.items():
        cs.callsets.add(sample_name=name, row=c.row_idx,
                        index_in_file=c.idx_in_file,
                        **({"stream_name": f"stream_{c.row_idx % 2}"}
                           if stream_names else {"filename": c.filename}))
    return cs


@pytest.mark.parametrize("stream_names", [False, True],
                         ids=["filenames", "stream_names"])
def test_vid_spec_and_callset_map_round_trip(cohort, stream_names):
    vid = VidMapper.from_files(cohort.vid, cohort.callsets)
    jvid = JVidMapper.from_files(cohort.vid, cohort.callsets)
    blob = pb_config.vid_to_pb(vid).SerializeToString()
    assert blob == jpb_config.vid_to_pb(jvid).SerializeToString()
    assert len(blob) > 100
    spec = pb_config.pb2().VidSpec()
    spec.ParseFromString(blob)
    jspec = jpb_config.pb2().VidSpec()
    jspec.ParseFromString(blob)
    cs = _callset_map(pb_config.pb2(), vid, stream_names)
    jcs = _callset_map(jpb_config.pb2(), jvid, stream_names)
    assert cs.SerializeToString() == jcs.SerializeToString()
    got = pb_config.vid_from_pb(spec, cs)
    want = jpb_config.vid_from_pb(jspec, jcs)
    assert _plain(got) == _plain(want)
    assert sorted(got.fields) == sorted(vid.fields)
    assert got.callsets["S0"].stream_name == (
        "stream_0" if stream_names else None)


def test_query_spec_to_query_params(cohort):
    vid = VidMapper.from_files(cohort.vid, cohort.callsets)
    jvid = JVidMapper.from_files(cohort.vid, cohort.callsets)
    specs = []
    for mod in (pb_config.pb2(), jpb_config.pb2()):
        q = mod.QuerySpec(workspace=cohort.workspace,
                          array_name=cohort.array,
                          attributes=["PL", "AD", "DP"],
                          produce_GT_field=True, segment_size=4096,
                          max_diploid_alt_alleles_that_can_be_genotyped=6)
        q.column_intervals.add(begin=0, end=500)
        q.contig_intervals.add(contig="1", begin=1001, end=2000)
        q.contig_intervals.add(contig="1")
        q.row_ranges.add(low=0, high=5)
        specs.append(q)
    blob = specs[0].SerializeToString()
    assert blob == specs[1].SerializeToString()
    got = pb_config.query_params_from_pb(specs[0], vid)
    want = jpb_config.query_params_from_pb(specs[1], jvid)
    assert _plain(got) == _plain(want)
    assert got.column_ranges == [[(0, 500), (1000, 1999),
                                  (0, vid.contigs["1"].length - 1)]]
    assert _plain(pb_config.query_params_from_pb(specs[0])) == \
        _plain(jpb_config.query_params_from_pb(specs[1]))


def test_import_spec_and_import_configuration(cohort):
    """ImportSpec messages built by each package serialize alike; the
    reference's ImportConfiguration converts to equal ImportParams and
    VidMapper."""
    vid = VidMapper.from_files(cohort.vid, cohort.callsets)
    jvid = JVidMapper.from_files(cohort.vid, cohort.callsets)
    blobs = []
    for cfg, v in ((pb_config, vid), (jpb_config, jvid)):
        spec = cfg.pb2().ImportSpec(treat_deletions_as_intervals=True,
                                    produce_array=True, segment_size=1024)
        spec.vid.CopyFrom(cfg.vid_to_pb(v))
        spec.callsets.CopyFrom(_callset_map(cfg.pb2(), v))
        spec.column_partitions.add(begin=0, end=999,
                                   workspace=cohort.workspace,
                                   array_name=cohort.array)
        blobs.append(spec.SerializeToString())
    assert blobs[0] == blobs[1]
    parsed = pb_config.pb2().ImportSpec()
    parsed.ParseFromString(blobs[0])
    assert _plain(pb_config.vid_from_pb(parsed.vid, parsed.callsets)) == \
        _plain(jpb_config.vid_from_pb(parsed.vid, parsed.callsets))

    msgs = []
    for compat in (pb_compat, jpb_compat):
        mods = compat.compat_pb2()
        imp = mods["genomicsdb_import_config"].ImportConfiguration()
        imp.size_per_column_partition = 16384
        imp.treat_deletions_as_intervals = True
        imp.vid_mapping_file = cohort.vid
        imp.callset_mapping_file = cohort.callsets
        p = imp.column_partitions.add()
        p.begin.tiledb_column = 0
        p.workspace = cohort.workspace
        p.array_name = cohort.array
        p2 = imp.column_partitions.add()
        p2.begin.tiledb_column = cohort.region // 2
        p2.workspace = cohort.workspace
        p2.array_name = "second"
        msgs.append(imp.SerializeToString())
    assert msgs[0] == msgs[1]
    ip, v = pb_compat.import_config_to_import(msgs[0])
    jip, jv = jpb_compat.import_config_to_import(msgs[0])
    assert v is None and jv is None
    assert _plain(ip) == _plain(jip)
    assert ip.partition_bounds(0) == jip.partition_bounds(0) == \
        (0, cohort.region // 2 - 1)


def _export_config(mods, cohort):
    exp = mods["genomicsdb_export_config"].ExportConfiguration()
    exp.workspace = cohort.workspace
    exp.array_name = cohort.array
    exp.reference_genome = ""
    rl = exp.query_column_ranges.add()
    coi = rl.column_or_interval_list.add()
    coi.column_interval.column_interval.begin = 0
    coi.column_interval.column_interval.end = cohort.region
    exp.vid_mapping_file = cohort.vid
    exp.callset_mapping_file = cohort.callsets
    return exp


def test_export_configuration_to_query_params(cohort):
    blob = _export_config(pb_compat.compat_pb2(), cohort).SerializeToString()
    assert blob == _export_config(jpb_compat.compat_pb2(),
                                  cohort).SerializeToString()
    qp, vid = pb_compat.export_config_to_query(blob)
    jqp, jvid = jpb_compat.export_config_to_query(blob)
    assert vid is None and jvid is None
    assert _plain(qp) == _plain(jqp)
    assert qp.column_ranges == [[(0, cohort.region)]]


def _run(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def test_gdb_query_with_a_protobuf_export_config(cohort, tmp_path):
    """`gdb_query --query-pb`: the port (block engine, --device cpu)
    gives the JAX tool's text on the same binary ExportConfiguration."""
    path = str(tmp_path / "export.pb")
    with open(path, "wb") as f:
        f.write(_export_config(pb_compat.compat_pb2(),
                               cohort).SerializeToString())
    argv = ["--query-pb", path, "--produce-Broad-GVCF"]
    port = _run(gdb_query.main, argv + ["--device", "cpu"])
    assert port.count("\n") > 100
    assert port == _run(jax_gdb_query.main, argv)
    assert port == _run(gdb_query.main, ["-j", cohort.query,
                                         "--produce-Broad-GVCF",
                                         "--device", "cpu"])


BINDINGS = r"""
import sys
sys.path.insert(0, %(root)r)
order = sys.argv[1]
def jax():
    from genomicsdb_tpu.core import pb_compat, pb_config
    pb_config.pb2()
    pb_compat.compat_pb2()
def port():
    from genomicsdb_tpu_torch.core import pb_compat, pb_config
    path = list(sys.path)
    mods = [pb_config.pb2(), *pb_compat.compat_pb2().values()]
    assert sys.path == path, "the port's bindings changed sys.path"
    return mods
if order == "jax-first":
    jax()
    mods = port()
else:
    mods = port()
    jax()
for m in mods:
    print(m.__name__, m.__file__)
"""


@pytest.mark.parametrize("order", ["jax-first", "port-first"])
def test_port_loads_only_its_own_bindings(order):
    """With the JAX package's pb_config and pb_compat bindings imported
    first (under their bare module names) or afterwards, every module
    the port's planes return lies under the port and has its qualified
    name, and the port's calls leave sys.path as they found it."""
    res = subprocess.run([sys.executable, "-c",
                          BINDINGS % {"root": ROOT}, order],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.split("\n")[:-1]
    assert len(lines) == 6
    for line in lines:
        name, path = line.split(" ")
        assert name.startswith("genomicsdb_tpu_torch.protos."), line
        assert os.path.commonpath([path, PORT]) == PORT, line


def test_bindings_regenerate_package_relative_imports(tmp_path):
    """A stale generated module (protoc's top-level imports, as an older
    layout wrote them) is regenerated with package-relative imports."""
    from genomicsdb_tpu_torch import protos
    mods = pb_compat.compat_pb2()
    path = mods["genomicsdb_export_config"].__file__
    with open(path) as f:
        text = f.read()
    assert "\nimport genomicsdb_" not in text
    assert "from . import genomicsdb_coordinates_pb2" in text
    assert protos._stale(path.replace("generated" + os.sep, "")
                         .replace("_pb2.py", ".proto"), path) is False
    stale = tmp_path / "stale_pb2.py"
    stale.write_text("import genomicsdb_coordinates_pb2 as x\n")
    assert protos._stale(path.replace("generated" + os.sep, "")
                         .replace("_pb2.py", ".proto"), str(stale))
