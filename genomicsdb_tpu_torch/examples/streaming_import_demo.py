"""Buffer-stream import demo (reference
example/src/test_genomicsdb_importer.cc): feed a seeded cohort's VCF
bytes through StreamingImporter in small chunks with import_batch
back-pressure, then query the finalized store with the sequential
engine.

    python -m genomicsdb_tpu_torch.examples.streaming_import_demo
"""

from __future__ import annotations

import argparse
import tempfile

from ..core.config import QueryParams
from ..core.vid import VidMapper
from ..query import driver
from ..store.streaming_import import StreamingImporter
from ..testing import write_cohort

SAMPLES, RECORDS, SEED = 16, 100, 3
CHUNK = 4096


def stream_import(vid: VidMapper, chunk: int = CHUNK):
    """One named stream per input file (jniAddBufferStream); each file's
    bytes pushed in `chunk`-byte writes (jniWriteDataToBufferStream),
    pumping import_batch after every write; the finalized store."""
    imp = StreamingImporter(vid)
    for cs in vid.callsets.values():
        if cs.filename not in imp.streams:
            imp.add_buffer_stream(cs.filename)
    for name in list(imp.streams):
        with open(name, "rb") as f:
            data = f.read()
        for i in range(0, len(data), chunk):
            imp.write(name, data[i:i + chunk])
            imp.import_batch()
    return imp.finalize()


def main(argv=None):
    argparse.ArgumentParser(
        description="Buffer-stream import of a seeded cohort, then the "
                    "sequential combined-gVCF query.").parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        c = write_cohort(d, SAMPLES, RECORDS, seed=SEED)
        vid = VidMapper.from_files(c.vid, c.callsets)
        store = stream_import(vid)
        print(f"imported {store.num_cells} cells, "
              f"{len(store.fields)} fields")
        qp = QueryParams()
        qp.scan_full = True
        qp.attributes = []
        qc = driver.make_query_config(qp, vid)
        text = driver.run_vcf_query(store, qc, qp, vid)
    print("first combined records:")
    for line in text.splitlines()[:5]:
        print(" ", line[:100])


if __name__ == "__main__":
    main()
