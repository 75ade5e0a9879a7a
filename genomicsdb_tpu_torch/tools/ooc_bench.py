"""Out-of-core serving benchmark on the port (counterpart of
`genomicsdb_tpu.tools.ooc_bench`): peak-memory-bounded combine queries
over a partition far larger than the allowed working set.

The reference serves arrays >> RAM by reading TileDB attribute segments
at segment_size granularity (variant_storage_manager.cc:478-513); this
tool builds a multi-GB single-fragment v2 partition by TILING an
imported cohort (its vid written inline) along the column axis at
streaming-write memory cost, then serves a whole-partition block-engine
combine query on one torch device in segment_size windows, and reports
wall time, throughput, on-disk partition bytes, the process's peak RSS
(VmHWM) and, on a CUDA device, the device-memory high-water mark
(`torch.cuda.max_memory_allocated`): the windows are what the device
holds.

Run in a FRESH process so peak RSS reflects only this workload:

    python -m genomicsdb_tpu_torch.tools.ooc_bench --target-bytes 2e9 \
        [--workspace DIR] [--segment-size 10485760] [--device cuda|cpu]

Prints one JSON line, under the JAX tool's keys (plus
`cuda_max_memory_allocated_bytes` on a CUDA device).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np


def _peak_rss():
    """Peak resident set (bytes) of THIS process image: VmHWM from
    /proc/self/status, or None where the kernel does not report it (not
    measured).  (ru_maxrss is wrong here: it survives execve, so a
    child forked from a large parent, e.g. a test harness, inherits the
    parent's high-water mark.)"""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM:"):
                return int(line.split()[1]) * 1024
    return None


def write_template_vcf(path: str, n_samples: int = 16,
                       n_records: int = 2000) -> int:
    """The JAX tool's template cohort, byte for byte (1-in-7 variant
    records, the rest gVCF reference blocks); returns the first position
    after its last record."""
    import random
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
            '##INFO=<ID=MQ0,Number=1,Type=Integer,Description="z">',
            '##contig=<ID=1,length=2000000000>',
        ]:
            f.write(line + "\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(samples) + "\n")
        pos = 1
        for i in range(n_records):
            if i % 7 == 6:
                cells = "\t".join(
                    f"0/1:{random.randint(1, 40)},{random.randint(1, 40)},"
                    f"0:{random.randint(10, 99)}:{random.randint(10, 99)}"
                    f":.:{random.randint(0, 500)},0,"
                    f"{random.randint(0, 500)},{random.randint(0, 500)},"
                    f"{random.randint(0, 500)},{random.randint(0, 500)}"
                    for _ in range(n_samples))
                f.write(f"1\t{pos}\t.\tC\tA,<NON_REF>\t.\t.\t"
                        f"MQ0={random.randint(0, 9)}\t"
                        f"GT:AD:DP:GQ:MIN_DP:PL\t{cells}\n")
                pos += 1
            else:
                end = pos + random.randint(20, 200)
                cells = "\t".join(
                    f"0/0:.:{random.randint(1, 60)}:0:0:0,0,0"
                    for _ in range(n_samples))
                f.write(f"1\t{pos}\t.\tC\t<NON_REF>\t.\t.\tEND={end}\t"
                        f"GT:AD:DP:GQ:MIN_DP:PL\t{cells}\n")
                pos = end + 1
    return pos


def _template_cohort(tmpdir: str, n_samples: int = 16,
                     n_records: int = 2000):
    """The template cohort imported: (store, vid, region)."""
    from ..core.vid import VidMapper
    from ..store.import_pipeline import import_callsets
    from .genome_bench import write_vid
    path = os.path.join(tmpdir, "template.vcf")
    pos = write_template_vcf(path, n_samples, n_records)
    vid_file = os.path.join(tmpdir, "vid.json")
    write_vid(vid_file, extra=("MQ0",))
    vid = VidMapper.from_files(vid_file)
    vid.parse_callsets({"callsets": {
        f"S{i}": {"row_idx": i, "idx_in_file": i, "filename": path}
        for i in range(n_samples)}})
    return import_callsets(vid), vid, pos


def _shifted(store, offset: int):
    """A view of `store` with all columns shifted by `offset`: field
    arrays are SHARED (zero copy), so tiling writes at O(template) RAM."""
    from ..store.columnar import ColumnarStore
    out = ColumnarStore(num_rows=store.num_rows, lb_row=store.lb_row)
    out.attribute_order = list(store.attribute_order)
    out.row = store.row
    out.col = store.col + offset
    out.end = store.end + offset
    out.eff_end = store.eff_end + offset
    out.fields = store.fields
    return out


def build_tiled_workspace(workspace: str, array: str, target_bytes: int,
                          n_samples: int = 16, n_records: int = 2000):
    """Stream-write a single v2 fragment of ~target_bytes by tiling the
    template cohort along the column axis.  Returns (vid, tiles,
    region_span, fragment path)."""
    from ..store import workspace as ws
    with tempfile.TemporaryDirectory() as td:
        template, vid, region = _template_cohort(td, n_samples,
                                                 n_records)
    ws.create_workspace(workspace, overwrite=True)
    field_meta = {n: {"kind": fd.kind, "dtype": fd.dtype}
                  for n, fd in template.fields.items()}
    w = ws.create_fragment_writer(workspace, array,
                                  template.attribute_order, field_meta,
                                  template.num_rows, template.lb_row)
    # estimate bytes per tile from the template's array sizes
    tile_bytes = sum(
        a.nbytes for a in (template.row, template.col, template.end,
                           template.eff_end))
    for fd in template.fields.values():
        tile_bytes += fd.valid.nbytes + np.asarray(fd.values).nbytes
        if fd.offsets is not None:
            tile_bytes += fd.offsets.nbytes
    tiles = max(int(target_bytes // tile_bytes), 1)
    stride = int(template.end.max()) + 100
    for i in range(tiles):
        w.append(_shifted(template, i * stride))
    frag = w.close()
    return vid, tiles, tiles * stride, frag


def main(argv=None):
    p = argparse.ArgumentParser(prog="ooc_bench")
    p.add_argument("--target-bytes", type=float, default=2e9)
    p.add_argument("--workspace", default=None)
    p.add_argument("--array", default="ooc_bench_array")
    p.add_argument("--segment-size", type=int, default=10 << 20)
    p.add_argument("--n-samples", type=int, default=16)
    p.add_argument("--keep", action="store_true",
                   help="keep the workspace for re-runs")
    p.add_argument("--device", default="cuda",
                   help="torch device of the block engine ('cuda' "
                        "default, or 'cpu'); 'cuda' without a card is an "
                        "error")
    args = p.parse_args(argv)
    from ..device import resolve_device
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"ooc_bench: {e}")

    from ..core.config import QueryParams
    from ..query import driver
    from ..store import workspace as ws

    workspace = args.workspace or tempfile.mkdtemp(prefix="ooc_ws_")
    t0 = time.perf_counter()
    vid, tiles, span, frag = build_tiled_workspace(
        workspace, args.array, int(args.target_bytes),
        n_samples=args.n_samples)
    build_s = time.perf_counter() - t0
    part_bytes = sum(
        os.path.getsize(os.path.join(frag, f)) for f in os.listdir(frag))
    rss_after_build = _peak_rss()

    ooc = ws.open_array_ooc(workspace, args.array,
                            segment_size=args.segment_size)
    qp = QueryParams()
    qp.scan_full = True
    qp.attributes = []
    qc = driver.make_query_config(qp, vid)
    if device.type == "cuda":
        import torch
        torch.cuda.reset_peak_memory_stats(device)
    windows0 = driver.iter_vcf_query_block.ooc_windows
    t0 = time.perf_counter()
    n_lines = 0
    for _line in driver.iter_vcf_query_block(ooc, qc, qp, vid, device):
        n_lines += 1
    query_s = time.perf_counter() - t0
    peak_rss = _peak_rss()
    out = {
        "partition_bytes": part_bytes,
        "build_seconds": build_s,
        "tiles": tiles,
        "records": n_lines,
        "genome_positions": span,
        "query_seconds": query_s,
        "positions_per_sec": span / query_s,
        "records_per_sec": n_lines / query_s,
        "windows": driver.iter_vcf_query_block.ooc_windows - windows0,
        "segment_size": args.segment_size,
        "peak_rss_bytes": peak_rss,
        "peak_rss_after_build": rss_after_build,
        "rss_over_partition": peak_rss / part_bytes
        if peak_rss is not None else None,
    }
    if device.type == "cuda":
        out["cuda_max_memory_allocated_bytes"] = \
            torch.cuda.max_memory_allocated(device)
    print(json.dumps(out))
    if not args.keep and args.workspace is None:
        shutil.rmtree(workspace, ignore_errors=True)
    return out


if __name__ == "__main__":
    main()
