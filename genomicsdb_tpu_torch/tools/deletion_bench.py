"""Deletion-heavy worst case on the port (counterpart of
`genomicsdb_tpu.tools.deletion_bench`): block engine vs sequential
engine.

Generates a cohort where ~9% of records are spanning deletions (the
reference's handle_deletions path, broad_combined_gvcf.cc:912-1078) with
its vid written inline, runs both engines on the full range (the block
engine on one torch device), checks that their outputs are
byte-identical and prints one JSON line with the speedup, under the JAX
tool's keys.

Usage: python -m genomicsdb_tpu_torch.tools.deletion_bench [--samples N]
           [--records N] [--device cuda|cpu]
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


def make_cohort(path: str, n_samples: int, n_records: int,
                del_every: int = 11) -> int:
    """Write the JAX tool's seeded cohort, byte for byte; returns the
    first position after its last record."""
    random.seed(3)
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
            if i % del_every == del_every - 1:
                # multi-base REF -> spanning-deletion rewrite at every
                # position the record covers past its start
                cells = "\t".join(
                    f"0/1:{random.randint(1, 40)},{random.randint(1, 40)}"
                    f",0:{random.randint(10, 99)}:{random.randint(10, 99)}"
                    f":.:{random.randint(0, 500)},0,{random.randint(0, 500)}"
                    f",{random.randint(0, 500)},{random.randint(0, 500)},"
                    f"{random.randint(0, 500)}"
                    for _ in range(n_samples))
                f.write(f"1\t{pos}\t.\tCATAT\tC,<NON_REF>\t.\t.\t.\t"
                        f"GT:AD:DP:GQ:MIN_DP:PL\t{cells}\n")
                pos += 5
            else:
                end = pos + random.randint(10, 60)
                cells = "\t".join(
                    f"0/0:.:{random.randint(1, 60)}:0:0:0,0,0"
                    for _ in range(n_samples))
                f.write(f"1\t{pos}\t.\tC\t<NON_REF>\t.\t.\tEND={end}\t"
                        f"GT:AD:DP:GQ:MIN_DP:PL\t{cells}\n")
                pos = end + 1
    return pos


def main(argv=None):
    ap = argparse.ArgumentParser(prog="deletion_bench")
    ap.add_argument("--samples", type=int, default=100)
    ap.add_argument("--records", type=int, default=1000)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the block engine ('cuda' "
                         "default, or 'cpu'); 'cuda' without a card is an "
                         "error")
    args = ap.parse_args(argv)
    from ..device import resolve_device
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"deletion_bench: {e}")
    from ..core.config import QueryParams
    from ..core.vid import VidMapper
    from ..query import driver
    from ..store.import_pipeline import import_callsets
    from .genome_bench import write_vid

    tmp = tempfile.mkdtemp(prefix="deletion_bench_")
    try:
        path = os.path.join(tmp, "del_cohort.vcf")
        region = make_cohort(path, args.samples, args.records)
        vid_file = os.path.join(tmp, "vid.json")
        write_vid(vid_file)
        vid = VidMapper.from_files(vid_file)
        vid.parse_callsets({"callsets": {
            f"S{i}": {"row_idx": i, "idx_in_file": i, "filename": path}
            for i in range(args.samples)}})
        store = import_callsets(vid)
        qp = QueryParams()
        qp.scan_full = True
        qp.attributes = []
        qc = driver.make_query_config(qp, vid)
        t0 = time.perf_counter()
        seq = driver.run_vcf_query(store, qc, qp, vid)
        t_seq = time.perf_counter() - t0
        qc2 = driver.make_query_config(qp, vid)
        t_blk = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            blk = driver.run_vcf_query_block(store, qc2, qp, vid, device)
            t_blk = min(t_blk, time.perf_counter() - t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if blk.splitlines() != seq.splitlines():
        raise SystemExit("deletion_bench: engine mismatch")
    out = {
        "samples": args.samples, "records_in": args.records,
        "records_out": blk.count("\n"), "positions": region,
        "sequential_s": t_seq, "block_s": t_blk,
        "block_positions_per_sec": region / t_blk,
        "speedup": t_seq / t_blk}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
