"""Block engine demo: a seeded 100-sample gVCF cohort -> import ->
store->block -> the device combine (the CUDA kernel on a card) -> native
text rendering.  The scaled production path behind `gdb_query
--produce-Broad-GVCF --engine block`.

    python -m genomicsdb_tpu_torch.examples.block_engine_demo [--device cuda]
"""

from __future__ import annotations

import argparse
import tempfile
import time

from ..core.config import QueryParams
from ..core.vid import VidMapper
from ..device import resolve_device
from ..query import driver
from ..store.import_pipeline import import_callsets
from ..testing import write_cohort

SAMPLES, RECORDS, SEED = 100, 500, 0


def block_query(cohort, device, timings=None) -> str:
    """Import the cohort written by `testing.write_cohort` (its vid and
    callsets) and return the block engine's combined gVCF text on
    `device`; `timings`, if given, gets the import and query seconds."""
    vid = VidMapper.from_files(cohort.vid, cohort.callsets)
    t0 = time.perf_counter()
    store = import_callsets(vid)
    t1 = time.perf_counter()
    qp = QueryParams()
    qp.scan_full = True
    qp.attributes = []
    qc = driver.make_query_config(qp, vid)
    text = driver.run_vcf_query_block(store, qc, qp, vid, device)
    if timings is not None:
        timings.update(cells=store.num_cells, import_s=t1 - t0,
                       query_s=time.perf_counter() - t1)
    return text


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Import a seeded 100-sample cohort and combine it "
                    "with the block engine.")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the combine ('cuda' default, or "
                         "'cpu')")
    device = resolve_device(ap.parse_args(argv).device)
    t = {}
    with tempfile.TemporaryDirectory() as d:
        text = block_query(write_cohort(d, SAMPLES, RECORDS, seed=SEED),
                           device, t)
    print(f"import: {t['cells']} cells in {t['import_s']:.2f}s")
    print(f"block engine: {text.count(chr(10))} combined records in "
          f"{t['query_s']:.2f}s on {device} (includes the first launch)")
    print("sample record:")
    print(" ", text.splitlines()[1][:120])


if __name__ == "__main__":
    main()
