"""Paged query-stream demo (reference
example/src/test_genomicsdb_bcf_generator.cc + Java
GenomicsDBFeatureReader): lazy byte pages from CombinedRecordStream,
whose block engine runs on `--device`, and interval queries through
FeatureReader (a host scan).

    python -m genomicsdb_tpu_torch.examples.query_stream_demo [--device cuda]
"""

from __future__ import annotations

import argparse
import tempfile

from ..core.config import QueryParams
from ..core.vid import VidMapper
from ..device import resolve_device
from ..query import driver
from ..query.stream import CombinedRecordStream, FeatureReader
from ..store.import_pipeline import import_callsets
from ..testing import write_cohort

SAMPLES, RECORDS, SEED = 16, 600, 2
PAGE = 512


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Byte pages of a seeded cohort's combined gVCF and an "
                    "interval query.")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the block engine ('cuda' "
                         "default, or 'cpu')")
    device = resolve_device(ap.parse_args(argv).device)
    with tempfile.TemporaryDirectory() as d:
        c = write_cohort(d, SAMPLES, RECORDS, seed=SEED)
        vid = VidMapper.from_files(c.vid, c.callsets)
        store = import_callsets(vid)
    qp = QueryParams()
    qp.scan_full = True
    qp.attributes = []
    qc = driver.make_query_config(qp, vid)
    # read_and_advance-style byte pages (GenomicsDBQueryStream analog)
    stream = CombinedRecordStream(store, qc, qp, vid, device)
    total = 0
    n_pages = 0
    for page in stream.pages(page_size=PAGE):
        total += len(page)
        n_pages += 1
    print(f"streamed {total} bytes in {n_pages} pages of <={PAGE}b on "
          f"{device}")
    # htsjdk FeatureReader.query(contig, begin, end) analog
    qc2 = driver.make_query_config(qp, vid)
    reader = FeatureReader(store, qc2, vid)
    records = list(reader.query("1", 12000, 13000))
    print(f"interval 1:12000-13000 -> {len(records)} records")
    for r in records[:3]:
        print(" ", str(r)[:100])


if __name__ == "__main__":
    main()
