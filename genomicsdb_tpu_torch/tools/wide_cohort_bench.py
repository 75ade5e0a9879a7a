"""1000-sample x chromosome-scale validation + bench lane on the port
(counterpart of `genomicsdb_tpu.tools.wide_cohort_bench`).

A 1000-sample chromosome-scale gVCF cohort (shared record grid, 1-in-7
variant records; the JAX tool's bytes) is written with its vid inline,
imported, and on one torch device

  * the block engine's full-chromosome combine is timed (positions/sec,
    cells/sec) and checksummed,
  * the same query re-run at a different record chunking must produce a
    byte-identical stream (chunk-invariance checksum),
  * sampled windows are verified byte-exact against the sequential
    reference-semantics engine,
  * 10 kb interval latency (p50/p90) is measured at this width, with
    the serving index off (the engine) and on (served).

Usage: python -m genomicsdb_tpu_torch.tools.wide_cohort_bench
           [--samples 1000] [--records 2000] [--windows 4] [--skip-seq]
           [--device cuda|cpu]
Prints one JSON line, under the JAX tool's keys.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import shutil
import tempfile
import time


def make_wide_cohort(path: str, n_samples: int, n_records: int) -> int:
    """One multi-sample gVCF: all samples share the record grid (the
    joint-genotyping shape after GenomicsDBImport).  The JAX tool's
    bytes; returns the first position after the last record."""
    rng = random.Random(11)
    samples = [f"W{i}" for i in range(n_samples)]
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.1\n")
        for line in [
            '##ALT=<ID=NON_REF,Description="n">',
            '##FORMAT=<ID=GT,Number=1,Type=String,Description="g">',
            '##FORMAT=<ID=AD,Number=.,Type=Integer,Description="a">',
            '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="d">',
            '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="q">',
            '##FORMAT=<ID=MIN_DP,Number=1,Type=Integer,Description="m">',
            '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="p">',
            '##INFO=<ID=END,Number=1,Type=Integer,Description="e">',
            '##INFO=<ID=MQ0,Number=1,Type=Integer,Description="z">',
            '##contig=<ID=1,length=2000000000>',
        ]:
            f.write(line + "\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(samples) + "\n")
        pos = 1
        for i in range(n_records):
            if i % 7 == 6:
                alt = rng.choice(["A", "T", "G"])
                cells = "\t".join(
                    f"0/{rng.randint(0, 1)}:{rng.randint(1, 40)},"
                    f"{rng.randint(1, 40)},0:{rng.randint(10, 99)}:"
                    f"{rng.randint(10, 99)}:.:{rng.randint(0, 500)},0,"
                    f"{rng.randint(0, 500)},{rng.randint(0, 500)},"
                    f"{rng.randint(0, 500)},{rng.randint(0, 500)}"
                    for _ in range(n_samples))
                f.write(f"1\t{pos}\t.\tC\t{alt},<NON_REF>\t.\t.\t"
                        f"MQ0={rng.randint(0, 9)}\t"
                        f"GT:AD:DP:GQ:MIN_DP:PL\t{cells}\n")
                pos += 1
            else:
                end = pos + rng.randint(50, 400)
                cells = "\t".join(
                    f"0/0:.:{rng.randint(1, 60)}:0:0:0,0,0"
                    for _ in range(n_samples))
                f.write(f"1\t{pos}\t.\tC\t<NON_REF>\t.\t.\tEND={end}\t"
                        f"GT:AD:DP:GQ:MIN_DP:PL\t{cells}\n")
                pos = end + 1
    return pos


def run(device, n_samples=1000, n_records=2000, n_windows=4,
        skip_seq=False):
    """The lanes on `device` (a torch.device); returns the JSON dict.
    Restores GENOMICSDB_TPU_SERVING_INDEX as it found it."""
    from ..core.config import QueryParams
    from ..core.vid import VidMapper
    from ..query import driver
    from ..store.import_pipeline import import_callsets
    from .genome_bench import write_vid

    td = tempfile.mkdtemp(prefix="wide_cohort_")
    prev = os.environ.get("GENOMICSDB_TPU_SERVING_INDEX")
    try:
        path = os.path.join(td, "wide.vcf")
        t0 = time.perf_counter()
        region = make_wide_cohort(path, n_samples, n_records)
        gen_s = time.perf_counter() - t0
        vid_file = os.path.join(td, "vid.json")
        write_vid(vid_file, extra=("MQ0",))
        vid = VidMapper.from_files(vid_file)
        vid.parse_callsets({"callsets": {
            f"W{i}": {"row_idx": i, "idx_in_file": i, "filename": path}
            for i in range(n_samples)}})
        t0 = time.perf_counter()
        store = import_callsets(vid)
        import_s = time.perf_counter() - t0

        def full_query(max_records_per_block=65536):
            qp = QueryParams()
            qp.scan_full = True
            qp.attributes = []
            qc = driver.make_query_config(qp, vid)
            return driver.run_vcf_query_block(
                store, qc, qp, vid, device,
                max_records_per_block=max_records_per_block)

        # throughput + equivalence lanes measure the ENGINE: the serving
        # index would otherwise materialize on the warm repeat and serve
        # a slice of itself; it gets its own lane
        os.environ["GENOMICSDB_TPU_SERVING_INDEX"] = "0"
        t0 = time.perf_counter()
        text = full_query()
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        text2 = full_query()
        warm_s = time.perf_counter() - t0
        if text2 != text:
            raise SystemExit("wide_cohort_bench: warm text differs from "
                             "cold")
        checksum = hashlib.sha256(text.encode()).hexdigest()[:16]
        # chunk invariance: a different record chunking must stream the
        # byte-identical result
        rechunked = full_query(max_records_per_block=512)
        if hashlib.sha256(rechunked.encode()).hexdigest()[:16] != checksum:
            raise SystemExit("wide_cohort_bench: chunking changed the "
                             "output")

        # sampled-window equivalence vs the sequential reference engine
        rng = random.Random(3)
        windows_ok = 0
        if not skip_seq:
            for _ in range(n_windows):
                lo = rng.randint(1, max(region - 4000, 2))
                qp_w = QueryParams()
                qp_w.column_ranges = [[(lo, lo + 3000)]]
                qp_w.attributes = []
                qc_w = driver.make_query_config(qp_w, vid)
                seq = driver.run_vcf_query(store, qc_w, qp_w, vid)
                qc_w2 = driver.make_query_config(qp_w, vid)
                blk = driver.run_vcf_query_block(store, qc_w2, qp_w, vid,
                                                 device)
                if blk != seq:
                    raise SystemExit(f"wide_cohort_bench: window ({lo}) "
                                     "mismatch")
                windows_ok += 1

        # interval latency at this width, after warm-up queries (the
        # store layout and device slabs are built once per process, as
        # in a long-lived server); engine (index off), then served
        def interval_lats(n=20, warm=8):
            xs = []
            for i in range(n):
                lo = rng.randint(1, max(region - 20000, 2))
                qp_i = QueryParams()
                qp_i.column_ranges = [[(lo, lo + 10000)]]
                qp_i.attributes = []
                qc_i = driver.make_query_config(qp_i, vid)
                t0 = time.perf_counter()
                driver.run_vcf_query_block(store, qc_i, qp_i, vid, device)
                if i >= warm:
                    xs.append(time.perf_counter() - t0)
            return sorted(xs)

        lats_engine = interval_lats()
        os.environ["GENOMICSDB_TPU_SERVING_INDEX"] = "1"
        lats = interval_lats()
    finally:
        if prev is None:
            os.environ.pop("GENOMICSDB_TPU_SERVING_INDEX", None)
        else:
            os.environ["GENOMICSDB_TPU_SERVING_INDEX"] = prev
        shutil.rmtree(td, ignore_errors=True)
    return {
        "samples": n_samples,
        "records": n_records,
        "cells": int(store.num_cells),
        "genome_positions": region,
        "gen_s": gen_s,
        "import_s": import_s,
        "query_cold_s": cold_s,
        "query_warm_s": warm_s,
        "positions_per_sec": region / warm_s,
        "cells_per_sec": store.num_cells / warm_s,
        "cell_records_per_sec": n_records * n_samples / warm_s,
        "interval_10kb_p50_ms": lats[len(lats) // 2] * 1000,
        "interval_10kb_p90_ms": lats[(len(lats) * 9) // 10] * 1000,
        "interval_10kb_engine_p50_ms":
            lats_engine[len(lats_engine) // 2] * 1000,
        "interval_10kb_engine_p90_ms":
            lats_engine[(len(lats_engine) * 9) // 10] * 1000,
        "seq_windows_verified": windows_ok,
        "checksum": checksum,
        "lines": text.count("\n"),
    }


def main(argv=None):
    p = argparse.ArgumentParser(prog="wide_cohort_bench")
    p.add_argument("--samples", type=int, default=1000)
    p.add_argument("--records", type=int, default=2000)
    p.add_argument("--windows", type=int, default=4)
    p.add_argument("--skip-seq", action="store_true",
                   help="skip the sequential-engine window checks "
                        "(bench-only mode)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the block engine ('cuda' "
                        "default, or 'cpu'); 'cuda' without a card is an "
                        "error")
    args = p.parse_args(argv)
    from ..device import resolve_device
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"wide_cohort_bench: {e}")
    out = run(device, args.samples, args.records, args.windows,
              args.skip_seq)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
