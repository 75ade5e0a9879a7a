"""The port's buffer-stream import (`genomicsdb_tpu_torch.store.
streaming_import`) against the JAX package's `StreamingImporter` and
the port's file import, on seeded cohorts written to disk.

Each side builds its vid, importer and store from the same files with
its own loaders; stores are compared as the files each package's
`write_fragment` writes, byte for byte (the fragment directory's
time-stamped name masked).  Streams are pushed in 997-byte writes
(headers and records split across writes), `import_batch()` after every
write, and the booleans it returns must be the JAX importer's.

BCF2 streams: the JAX importer decodes each record to VCF text with
htslib's 6-significant-digit floats, so a float32 with more digits (the
cohort's RAW_MQ) is stored rounded.  The port decodes floats exactly
and stores what a text or file import of the same records stores; its
BCF2-streamed store differs from the JAX one in those float fields and
nowhere else.
"""

import os
import re

import numpy as np
import pytest
import torch

from genomicsdb_tpu.core.config import QueryParams as JQueryParams
from genomicsdb_tpu.core.vid import VidMapper as JVidMapper
from genomicsdb_tpu.query import driver as jdriver
from genomicsdb_tpu.store import workspace as jws
from genomicsdb_tpu.store.streaming_import import \
    StreamingImporter as JStreamingImporter
from genomicsdb_tpu.vcf.bcf import text_to_bcf as jtext_to_bcf
from genomicsdb_tpu_torch.core.config import QueryParams
from genomicsdb_tpu_torch.core.formats import format_float_vcf
from genomicsdb_tpu_torch.core.vid import VidMapper
from genomicsdb_tpu_torch.query import driver
from genomicsdb_tpu_torch.store import workspace as ws
from genomicsdb_tpu_torch.store.import_pipeline import import_callsets
from genomicsdb_tpu_torch.store.streaming_import import (BCF_MAGIC,
                                                         StreamingImporter)
from genomicsdb_tpu_torch.testing import write_cohort
from genomicsdb_tpu_torch.vcf.bcf import text_to_bcf

from test_torch_remap_rows import write_many_allele_cohort
from test_torch_standalone import _store_files

WRITE = 997


def _texts(files) -> dict:
    out = {}
    for path in files:
        with open(path) as f:
            out[path] = f.read()
    return out


def _stream(importer_cls, to_bcf, vid, texts, mode, write=WRITE):
    """(finalized store, import_batch booleans): one stream per file,
    named by its path, each file's text (or its BCF2 encoding) pushed in
    `write`-byte writes; `texts` maps the paths to the texts."""
    imp = importer_cls(vid)
    for path in texts:
        imp.add_buffer_stream(path)
    flags = []
    for path, text in texts.items():
        data = to_bcf(text) if mode == "bcf" else text.encode()
        for off in range(0, len(data), write):
            imp.write(path, data[off:off + write])
            flags.append(imp.import_batch())
    flags.append(imp.import_batch())
    return imp.finalize(), flags


def _written(ws_mod, store, d) -> dict:
    ws_mod.create_workspace(d)
    ws_mod.write_fragment(d, "a", store)
    return _store_files(d)


def _cohort_files(kind, d):
    """(vid.json, callsets.json, the VCF paths) of a seeded cohort:
    `write_cohort(24, 60)` or the 17-allele cohort."""
    if kind == "cohort":
        c = write_cohort(d, 24, 60, seed=8, n_groups=3)
        return c.vid, c.callsets, c.vcfs
    write_many_allele_cohort(d)
    vcfs = sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.endswith(".g.vcf"))
    return os.path.join(d, "vid.json"), os.path.join(d, "callsets.json"), \
        vcfs


@pytest.fixture(scope="module", params=["cohort", "many_alleles"])
def cohort(request, tmp_path_factory):
    d = str(tmp_path_factory.mktemp(request.param))
    return (request.param, d) + _cohort_files(request.param, d)


@pytest.mark.parametrize("mode", ["text", "bcf"])
def test_streamed_store_equals_jax_and_file_import(cohort, mode):
    kind, d, vid_path, cs_path, vcfs = cohort
    vid = VidMapper.from_files(vid_path, cs_path)
    jvid = JVidMapper.from_files(vid_path, cs_path)
    got, flags = _stream(StreamingImporter, text_to_bcf, vid, _texts(vcfs),
                         mode)
    ref, jflags = _stream(JStreamingImporter, jtext_to_bcf, jvid,
                          _texts(vcfs), mode)
    assert flags == jflags
    assert flags[-1]
    port = _written(ws, got, os.path.join(d, f"ws_port_{mode}"))
    jax = _written(jws, ref, os.path.join(d, f"ws_jax_{mode}"))
    files = _written(ws, import_callsets(vid),
                     os.path.join(d, f"ws_file_{mode}"))
    assert len(port) > 20 and sorted(port) == sorted(jax) == sorted(files)
    assert all(port[k] == files[k] for k in files)
    differ = sorted(k for k in port if port[k] != jax[k])
    if mode == "text":
        assert not differ
        return
    # BCF2: only the float fields that 6 significant digits round
    floats = {name for name, info in vid.fields.items()
              if "float" in info.element_types}
    assert all(any(f in k for f in floats) for k in differ), differ
    if kind == "cohort":
        assert differ   # RAW_MQ carries 7 significant digits


def test_bcf_stream_floats_are_exact_where_the_jax_importer_rounds(
        tmp_path):
    """The cohort's RAW_MQ through BCF2 streams: the port stores the
    float32 a file import stores; the JAX importer stores what a text
    import of the same files with every RAW_MQ rendered to 6 significant
    digits (`format_float_vcf`) stores."""
    c = write_cohort(str(tmp_path), 24, 60, seed=8, n_groups=3)
    vid = VidMapper.from_files(c.vid, c.callsets)
    jvid = JVidMapper.from_files(c.vid, c.callsets)
    texts = _texts(c.vcfs)
    got, _ = _stream(StreamingImporter, text_to_bcf, vid, texts, "bcf")
    ref, _ = _stream(JStreamingImporter, jtext_to_bcf, jvid, texts, "bcf")
    six = {p: re.sub(r"RAW_MQ=([0-9.]+)",
                     lambda m: "RAW_MQ=" + format_float_vcf(m.group(1)), t)
           for p, t in texts.items()}
    assert six != texts
    rounded, _ = _stream(JStreamingImporter, jtext_to_bcf, jvid, six,
                         "text")
    want = import_callsets(vid).fields["RAW_MQ"]
    f, jf, rf = (s.fields["RAW_MQ"] for s in (got, ref, rounded))
    assert f.valid.sum() > 20
    for a in (want, jf, rf):
        assert np.array_equal(f.valid, a.valid)
    bits = {k: np.asarray(a.values).view(np.int32)
            for k, a in (("port", f), ("file", want), ("jax", jf),
                         ("six", rf))}
    assert np.array_equal(bits["port"], bits["file"])
    assert not np.array_equal(bits["port"], bits["jax"])
    assert np.array_equal(bits["jax"], bits["six"])


def test_block_engine_on_the_streamed_store_equals_jax(cohort):
    """The combined text of the text-streamed store: the port's block
    engine on the CPU == the JAX block engine on the JAX-streamed store
    == the port's sequential engine."""
    kind, d, vid_path, cs_path, vcfs = cohort
    vid = VidMapper.from_files(vid_path, cs_path)
    jvid = JVidMapper.from_files(vid_path, cs_path)
    got, _ = _stream(StreamingImporter, text_to_bcf, vid, _texts(vcfs),
                     "bcf")
    ref, _ = _stream(JStreamingImporter, jtext_to_bcf, jvid, _texts(vcfs),
                     "text")
    qp, jqp = QueryParams(), JQueryParams()
    for q in (qp, jqp):
        q.scan_full = True
        q.attributes = []
    qc = driver.make_query_config(qp, vid)
    text = driver.run_vcf_query_block(got, qc, qp, vid, torch.device("cpu"))
    jtext = jdriver.run_vcf_query_block(
        ref, jdriver.make_query_config(jqp, jvid), jqp, jvid)
    assert text.count("\n") > 50
    assert text == jtext
    assert text == driver.run_vcf_query(got, qc, qp, vid)


def test_stream_names_map_to_rows(tmp_path):
    """Callsets keyed by stream_name (the GATK4 buffer mapping): streams
    named s0..s2 whose samples take rows in reverse order; both packages
    give one store."""
    import json
    c = write_cohort(str(tmp_path), 9, 40, seed=3, n_groups=3)
    with open(c.callsets) as f:
        callsets = json.load(f)["callsets"]
    files = sorted({cs["filename"] for cs in callsets.values()})
    n = len(callsets)
    mapped = {name: {"row_idx": n - 1 - cs["row_idx"],
                     "idx_in_file": cs["idx_in_file"],
                     "stream_name": f"s{files.index(cs['filename'])}"}
              for name, cs in callsets.items()}
    path = str(tmp_path / "streams.json")
    with open(path, "w") as f:
        json.dump({"callsets": mapped}, f)
    stores = []
    for vid_cls, imp_cls, ws_mod in ((VidMapper, StreamingImporter, ws),
                                     (JVidMapper, JStreamingImporter, jws)):
        vid = vid_cls.from_files(c.vid, path)
        imp = imp_cls(vid)
        for i in range(len(files)):
            imp.add_buffer_stream(f"s{i}")
        for i, p in enumerate(files):
            with open(p, "rb") as f:
                data = f.read()
            for off in range(0, len(data), WRITE):
                imp.write(f"s{i}", data[off:off + WRITE])
                imp.import_batch()
        store = imp.finalize()
        stores.append(_written(ws_mod, store,
                               str(tmp_path / f"ws_{len(stores)}")))
        rows = np.unique(np.asarray(store.row))
        assert rows.tolist() == list(range(n))
    assert stores[0] == stores[1]
    # sample S0 (row 0 in the file layout) now sits in the last row
    vid = VidMapper.from_files(c.vid, path)
    assert vid.callsets["S0"].row_idx == n - 1


@pytest.mark.parametrize("importer_cls", [StreamingImporter,
                                          JStreamingImporter],
                         ids=["port", "jax"])
def test_records_before_the_header_raise(importer_cls, tmp_path):
    c = write_cohort(str(tmp_path), 4, 10, seed=1, n_groups=2)
    vid_cls = VidMapper if importer_cls is StreamingImporter else JVidMapper
    imp = importer_cls(vid_cls.from_files(c.vid, c.callsets))
    imp.add_buffer_stream(c.vcfs[0])
    with open(c.vcfs[0]) as f:
        records = [ln for ln in f if not ln.startswith("#")]
    imp.write(c.vcfs[0], "".join(records[:3]).encode())
    with pytest.raises(ValueError, match="records before header"):
        imp.import_batch()


def test_streams_are_sniffed_by_the_bcf_magic(tmp_path):
    """A stream is BCF2 when its first 5 bytes are the magic and text
    otherwise; fewer than 5 bytes leave it undetermined (and pending)."""
    c = write_cohort(str(tmp_path), 4, 10, seed=1, n_groups=2)
    vid = VidMapper.from_files(c.vid, c.callsets)
    with open(c.vcfs[0]) as f:
        text = f.read()
    for data, mode in ((text_to_bcf(text), "bcf"), (text.encode(), "text")):
        imp = StreamingImporter(vid)
        imp.add_buffer_stream("x")
        imp.write("x", data[:4])
        assert imp.import_batch() is False
        assert imp.streams["x"].mode is None
        imp.write("x", data[4:])
        imp.import_batch()
        assert imp.streams["x"].mode == mode
        assert (data[:5] == BCF_MAGIC) == (mode == "bcf")
