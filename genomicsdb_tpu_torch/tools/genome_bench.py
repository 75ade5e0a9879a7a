"""Genome-scale text-edge benchmark on the port (counterpart of
`genomicsdb_tpu.tools.genome_bench`): millions of positions through the
record-aligned chunked block engine on one torch device.

Generates an 8-sample gVCF spanning ~6M positions (~200k records) with
its vid written inline, runs the block engine twice (cold, then warm),
then 20 seeded 10 kb interval queries with the serving index off (the
engine lane) and on (the served lane), and prints one JSON line.

Usage: python -m genomicsdb_tpu_torch.tools.genome_bench [--records N]
           [--samples N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import sys
import tempfile
import time

#: the vid of make_cohort's fields (no reference checkout needed)
VID = {
    "fields": {
        "PASS": {"vcf_field_class": ["FILTER"], "type": "int"},
        "GT": {"vcf_field_class": ["FORMAT"], "type": "int", "length": "P"},
        "AD": {"vcf_field_class": ["FORMAT"], "type": "int", "length": "R"},
        "DP": {"vcf_field_class": ["FORMAT", "INFO"], "type": "int"},
        "GQ": {"vcf_field_class": ["FORMAT"], "type": "int"},
        "MIN_DP": {"vcf_field_class": ["FORMAT"], "type": "int"},
        "PL": {"vcf_field_class": ["FORMAT"], "type": "int", "length": "G"},
        "END": {"vcf_field_class": ["INFO"], "type": "int"},
    },
    "contigs": {"1": {"length": 249250621, "tiledb_column_offset": 0}},
}
#: INFO fields the other bench cohorts carry, for `write_vid`'s `extra`:
#: MQ0 (int median), BaseQRankSum (float median), and the allele-specific
#: 2-D annotations of the import lane, text-serialized per allele ("|")
#: then per element (","): AS_RAW_MQ element-wise summed, AS_RAW_MQRankSum
#: a (value, count) histogram
EXTRA_FIELDS = {
    "MQ0": {"vcf_field_class": ["INFO"], "type": "int"},
    "BaseQRankSum": {"vcf_field_class": ["INFO"], "type": "float"},
    "AS_RAW_MQ": {"vcf_field_class": ["INFO"], "type": "float",
                  "length": ["R", "VAR"], "vcf_delimiter": ["|", ","],
                  "vcf_type": "string",
                  "VCF_field_combine_operation": "element_wise_sum"},
    "AS_RAW_MQRankSum": {"vcf_field_class": ["INFO"],
                         "type": ["float", "int"], "length": ["R", "VAR"],
                         "vcf_delimiter": ["|", ","], "vcf_type": "string",
                         "VCF_field_combine_operation": "histogram_sum"},
}


def make_cohort(path: str, n_samples: int, n_records: int) -> int:
    """Write the seeded single-file cohort; returns the first position
    after its last record."""
    random.seed(7)
    samples = [f"S{i}" for i in range(n_samples)]
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
            '##contig=<ID=1,length=249250621>',
        ]:
            f.write(line + "\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(samples) + "\n")
        pos = 1
        for i in range(n_records):
            if i % 9 == 8:
                cells = "\t".join(
                    f"0/1:{random.randint(1, 40)},{random.randint(1, 40)}"
                    f",0:{random.randint(10, 99)}:{random.randint(10, 99)}"
                    f":.:{random.randint(0, 500)},0,{random.randint(0, 500)}"
                    f",{random.randint(0, 500)},{random.randint(0, 500)},"
                    f"{random.randint(0, 500)}"
                    for _ in range(n_samples))
                f.write(f"1\t{pos}\t.\tC\tA,<NON_REF>\t.\t.\t.\t"
                        f"GT:AD:DP:GQ:MIN_DP:PL\t{cells}\n")
                pos += 1
            else:
                end = pos + random.randint(10, 50)
                cells = "\t".join(
                    f"0/0:.:{random.randint(1, 60)}:0:0:0,0,0"
                    for _ in range(n_samples))
                f.write(f"1\t{pos}\t.\tC\t<NON_REF>\t.\t.\tEND={end}\t"
                        f"GT:AD:DP:GQ:MIN_DP:PL\t{cells}\n")
                pos = end + 1
    return pos


def write_vid(path: str, extra=()) -> None:
    """Write VID, plus the `EXTRA_FIELDS` named in `extra`, to `path`."""
    doc = dict(VID, fields=dict(VID["fields"],
                                **{k: EXTRA_FIELDS[k] for k in extra}))
    with open(path, "w") as f:
        json.dump(doc, f)


def device_name(device) -> str:
    import torch
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=8)
    ap.add_argument("--records", type=int, default=200_000)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the block engine ('cuda' "
                         "default, or 'cpu'); 'cuda' without a card is an "
                         "error")
    args = ap.parse_args(argv)
    from ..device import resolve_device
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"genome_bench: {e}")
    from ..core.config import QueryParams
    from ..core.vid import VidMapper
    from ..query import driver
    from ..store.import_pipeline import import_callsets

    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, "genome_cohort.vcf")
    region = make_cohort(path, args.samples, args.records)
    vid_file = os.path.join(tmp, "vid.json")
    write_vid(vid_file)
    vid = VidMapper.from_files(vid_file)
    vid.parse_callsets({"callsets": {
        f"S{i}": {"row_idx": i, "idx_in_file": i, "filename": path}
        for i in range(args.samples)}})
    t0 = time.perf_counter()
    store = import_callsets(vid)
    t_import = time.perf_counter() - t0
    qp = QueryParams()
    qp.scan_full = True
    qp.attributes = []
    # engine lanes: the serving index would materialize on the warm
    # repeat and serve a slice of itself — it gets its own lane below
    prev = os.environ.get("GENOMICSDB_TPU_SERVING_INDEX")
    os.environ["GENOMICSDB_TPU_SERVING_INDEX"] = "0"
    try:
        qc = driver.make_query_config(qp, vid)
        t0 = time.perf_counter()
        text = driver.run_vcf_query_block(store, qc, qp, vid, device)
        t_cold = time.perf_counter() - t0
        qc2 = driver.make_query_config(qp, vid)
        t0 = time.perf_counter()
        text2 = driver.run_vcf_query_block(store, qc2, qp, vid, device)
        t_warm = time.perf_counter() - t0
        if text2 != text:
            raise SystemExit("genome_bench: warm text differs from cold")
        rng = random.Random(2)
        los = [rng.randint(1, max(region - 20000, 2)) for _ in range(20)]

        def interval_lane():
            lat, texts = [], []
            for lo in los:
                qp_i = QueryParams()
                qp_i.column_ranges = [[(lo, lo + 10000)]]
                qp_i.attributes = []
                qc_i = driver.make_query_config(qp_i, vid)
                t0 = time.perf_counter()
                texts.append(driver.run_vcf_query_block(store, qc_i, qp_i,
                                                        vid, device))
                lat.append(time.perf_counter() - t0)
            return sorted(lat), texts

        lat, eng_texts = interval_lane()
        os.environ["GENOMICSDB_TPU_SERVING_INDEX"] = "1"
        lat_srv, srv_texts = interval_lane()  # production: served
    finally:
        if prev is None:
            os.environ.pop("GENOMICSDB_TPU_SERVING_INDEX", None)
        else:
            os.environ["GENOMICSDB_TPU_SERVING_INDEX"] = prev
    if srv_texts != eng_texts:
        raise SystemExit("genome_bench: served text differs from the "
                         "engine's")
    print(json.dumps({
        "device": str(device), "device_name": device_name(device),
        "samples": args.samples, "records": args.records,
        "cells": int(store.num_cells), "positions": region,
        "import_s": t_import, "query_cold_s": t_cold,
        "query_warm_s": t_warm,
        "warm_positions_per_sec": region / t_warm,
        "interval_10kb_p50_ms": lat_srv[10] * 1000,
        "interval_10kb_p90_ms": lat_srv[18] * 1000,
        "interval_10kb_engine_p50_ms": lat[10] * 1000,
        "interval_10kb_engine_p90_ms": lat[18] * 1000,
        "lines": text.count("\n")}))
    shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
