"""The repository's combine benchmark lanes on the port (counterpart of
the JAX package's `bench.py` at the repository root).

    python -m genomicsdb_tpu_torch.bench [--device cuda] [--lanes a,b,...]
                                         [--out PATH]

Each lane runs on one torch device (`cuda` by default; `cpu` when asked)
and reports under the JAX lane's metric and key names:

  device            the general `combine_step` over 8192-record chunks of
                    synthesize_cohort(128, 2048, 262144, seed=0)
  device_fused      the CUDA kernel (`fused_combine.fused_gather_remap`,
                    its twin on the CPU) then `_fused_post` per chunk,
                    wide and narrow (int16 outputs); the narrow checksum,
                    taken on widened values, must equal the wide one
  device_fused_wide_1024_samples  the same at 1024 x 256 x 32,768
  device_dense      `combine_step_dense` on one host-gathered chunk
  oracle            the sequential Python scan (host)
  cpp_sequential_baseline  the native sequential combine (host; the
                    vs_baseline anchor), one thread and all cores
  import            native import against the Python converter, plus
                    the allele-specific 2-D INFO cohort (host)
  cohort100_end_to_end  a 100-sample cohort imported, built into a
                    block, combined and rendered on the device
  out_of_core, wide_cohort_1000, process_scaling, stream_latency
                    the port's tools/ooc_bench, wide_cohort_bench
                    --skip-seq, scaling_bench and stream_latency_bench,
                    each in a process of its own with --device
  chip_lane         `pytest -m gpu tests/test_torch_gpu_lane.py` (cuda
                    only; needs the repository's tests/)

Device times are host clocks around work that ends in a device
synchronisation, best of `reps`; every device lane checks that its
repeats give one checksum (an int32-wraparound sum of PL, AD and the
INFO DP sum over the block's records).  There is no fallback: a lane
that fails, or `cuda` without a card, fails the run.

The full result line (`metric`, `value`, `unit`, `vs_baseline`,
`vs_baseline_mt`, `detail`, plus the card) is written to `--out`
(default build/genomicsdb_tpu_torch/bench.json), and its table
(`tools/perf_table`) to `perf_table.md` beside it; stdout gets the JAX
bench's compact line.  The repository's BENCH.json stays the TPU rounds'
file.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import random
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "build", "genomicsdb_tpu_torch",
                           "bench.json")
CHUNK = 8192


def _best_of(fn, reps: int):
    """(best seconds of `reps` timed calls, the result) after one
    untimed call; every call must return the first call's result."""
    want = fn()
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        got = fn()
        dt = time.perf_counter() - t0
        if got != want:
            raise RuntimeError(f"checksum changed between repeats: {got} "
                               f"!= {want}")
        best = dt if best is None else min(best, dt)
    return best, want


def _chk(x: torch.Tensor) -> torch.Tensor:
    """The sum of x's values as int32 words (int16 kernel outputs widened
    with their BCF16 sentinels first), as an int64 device scalar."""
    from .ops.fused_combine import widen16
    if x.dtype == torch.int16:
        x = widen16(x)
    return x.to(torch.int32).sum(dtype=torch.int64)


def _wrap32(v: int) -> int:
    """An integer folded into int32 (wraparound), as the JAX lanes'
    int32 sums are."""
    return (int(v) + 2 ** 31) % 2 ** 32 - 2 ** 31


def checksum(out) -> torch.Tensor:
    """The JAX lanes' checksum terms of a combine output: PL + AD + the
    INFO DP sum (an int64 device scalar; reading it synchronises)."""
    return _chk(out["pl"]) + _chk(out["ad"]) + _chk(out["dp_info_sum"])


def _cohort_tensors(blk, device):
    """The block's 12 cell slabs and its per-record LUT tensors (live,
    inv_bs, nr_bs, rec_num_merged, rec_has_nr) on `device`."""
    from .ops.combine_step import block_to_tensors
    t = block_to_tensors(blk, device)
    return t[:12], (t[16], t[12], t[13], t[14], t[15])


def _chunks(nb: int, chunk: int):
    return [(lo, min(lo + chunk, nb)) for lo in range(0, nb, chunk)]


def bench_device(device, num_samples=128, cells_per_sample=2048,
                 region_len=262144, chunk=CHUNK, reps=5):
    """The general combine_step over `chunk`-record chunks (the last one
    shorter: torch needs no padding to a fixed shape)."""
    from .ops.cell_block import synthesize_cohort
    from .ops.combine_step import combine_step
    blk = synthesize_cohort(num_samples, cells_per_sample, region_len,
                            seed=0)
    slabs, (live, inv, nr, recnm, recnr) = _cohort_tensors(blk, device)
    nb = len(blk.starts)

    def run():
        acc = torch.zeros((), dtype=torch.int64, device=device)
        for lo, hi in _chunks(nb, chunk):
            out = combine_step(*slabs, inv[lo:hi], nr[lo:hi], recnm[lo:hi],
                               recnr[lo:hi], live[lo:hi], max_merged=4,
                               ploidy=2)
            acc += checksum(out)
        return _wrap32(acc.item())

    best, chk = _best_of(run, reps)
    return {"positions_per_sec": region_len / best,
            "records_per_sec": nb / best, "records": nb,
            "samples": num_samples, "seconds": best, "checksum": chk}


def _fused_run(device, blk, chunk, narrow):
    """The kernel lane's chunk loop: a callable returning the checksum."""
    from .ops import fused_combine as FC
    slabs, (live, inv, nr, recnm, recnr) = _cohort_tensors(blk, device)
    live = live.to(torch.int32)
    del_rw = torch.zeros(live.shape, dtype=torch.bool, device=device)
    scalars = narrow and FC._narrow_scalars_ok(blk)
    if narrow and not FC._narrow_inputs_ok(blk):
        raise RuntimeError("the cohort's values do not fit the narrow form")
    nb = live.shape[0]

    def run():
        acc = torch.zeros((), dtype=torch.int64, device=device)
        for lo, hi in _chunks(nb, chunk):
            lv = live[lo:hi]
            k = FC.fused_gather_remap(
                *slabs, lv, inv[lo:hi], nr[lo:hi], recnm[lo:hi],
                recnr[lo:hi], max_merged=4, ploidy=2, narrow=narrow,
                narrow_scalars=scalars)
            acc += checksum(FC._fused_post(k, del_rw[lo:hi], lv))
        return _wrap32(acc.item())

    return run


def bench_device_fused(device, num_samples=128, cells_per_sample=2048,
                       region_len=262144, chunk=CHUNK, reps=5):
    """The kernel path per chunk, wide (top-level keys) and narrow
    (`narrow`: int16 PL/AD/GT, and GQ/DP/MIN_DP where they fit, the
    card's production form); the two checksums must be equal.  The
    JAX lane's VMEM window planning and its R-pass dispatch
    amortisation have no counterpart here."""
    from .ops.cell_block import synthesize_cohort
    blk = synthesize_cohort(num_samples, cells_per_sample, region_len,
                            seed=0)
    nb = len(blk.starts)
    res = {}
    for form in ("wide", "narrow"):
        best, chk = _best_of(_fused_run(device, blk, chunk,
                                        form == "narrow"), reps)
        res[form] = {"positions_per_sec": region_len / best,
                     "records_per_sec": nb / best, "seconds": best,
                     "checksum": chk}
    if res["narrow"]["checksum"] != res["wide"]["checksum"]:
        raise RuntimeError(f"narrow checksum {res['narrow']['checksum']} "
                           f"!= wide {res['wide']['checksum']}")
    out = dict(res["wide"], records=nb, samples=num_samples)
    out["narrow"] = res["narrow"]
    return out


def bench_device_fused_wide_1024(device, reps=3, **kw):
    """bench_device_fused at the production cohort width (1024 samples x
    256 cells x 32,768 positions), with cells/sec."""
    shape = dict(num_samples=1024, cells_per_sample=256, region_len=32768)
    shape.update(kw)
    out = bench_device_fused(device, reps=reps, **shape)
    out["cells_per_sec"] = out["records_per_sec"] * out["samples"]
    return out


def bench_device_dense(device, num_samples=128, cells_per_sample=2048,
                       region_len=262144, chunk=CHUNK, reps=5):
    """combine_step_dense on the first `chunk` records, gathered on the
    host (gather_block_host) and uploaded once: the device math alone."""
    from .ops.cell_block import synthesize_cohort
    from .ops.combine_step import (combine_step_dense, dense_tensors,
                                   gather_block_host, to_tensor)
    blk = synthesize_cohort(num_samples, cells_per_sample, region_len,
                            seed=0)
    nb = len(blk.starts)
    sub = copy.copy(blk)
    sub.inv_bs = blk.inv_bs[:chunk]
    sub.nr_bs = blk.nr_bs[:chunk]
    args = dense_tensors(gather_block_host(sub, blk.live[:chunk]), device)
    recnm = to_tensor(blk.rec_num_merged[:chunk], device)
    n = recnm.shape[0]

    def run():
        out = combine_step_dense(*args, recnm, max_merged=4, ploidy=2)
        return _wrap32(checksum(out).item())

    best, chk = _best_of(run, reps)
    return {"records_per_sec": n / best,
            "positions_per_sec": region_len * (n / nb) / best,
            "records": n, "seconds": best, "checksum": chk}


def bench_oracle(num_samples=128, cells_per_sample=32, region_len=4096):
    """The sequential semantics oracle (a per-interval Python scan with
    the PL remap) on a smaller slice: positions/sec on the host."""
    from .core import formats
    from .ops import merge as M
    rng = np.random.default_rng(0)
    S, C = num_samples, cells_per_sample
    bounds = np.sort(rng.integers(0, region_len, size=(S, C - 1)), axis=1)
    col = np.concatenate([np.zeros((S, 1), np.int64), bounds], axis=1)
    end = np.concatenate([bounds - 1,
                          np.full((S, 1), region_len - 1, np.int64)], axis=1)
    end = np.where(end < col, col, end)
    pl = rng.integers(0, 2000, size=(S, C, 10)).astype(np.int32)
    t0 = time.perf_counter()
    events = np.unique(np.concatenate([col.ravel(), end.ravel() + 1]))
    starts = events[events < region_len]
    n_rec = 0
    ptr = np.zeros(S, dtype=np.int64)
    for st in starts:
        lut = np.array([0, 1, 2, 3], dtype=np.int32)
        for s in range(S):
            while ptr[s] + 1 < C and col[s, ptr[s] + 1] <= st:
                ptr[s] += 1
            if col[s, ptr[s]] <= st <= end[s, ptr[s]]:
                M.remap_by_genotype(pl[s, ptr[s]], lut, 4, True, 2,
                                    formats.INT_MISSING)
        n_rec += 1
    dt = time.perf_counter() - t0
    return {"positions_per_sec": region_len / dt, "records": n_rec,
            "seconds": dt}


def bench_cpp_baseline(num_samples=128, cells_per_sample=2048,
                       region_len=262144):
    """The native sequential combine (runtime/native/seq_bench.cpp) on
    the device lanes' cohort: the reference's per-record per-call loop
    at compiled speed, one thread, then records partitioned over every
    core (the checksums must agree)."""
    import ctypes

    from .ops.cell_block import synthesize_cohort
    from .runtime import native_loader
    lib = native_loader.get_lib()
    if lib is None:
        raise RuntimeError("the native library did not build")
    blk = synthesize_cohort(num_samples, cells_per_sample, region_len,
                            seed=0)
    i64 = ctypes.c_int64
    ptr32 = np.ctypeslib.ndpointer(np.int32)
    ptr64 = np.ctypeslib.ndpointer(np.int64)
    fn = lib.gdb_seq_combine_bench
    fn.restype = ctypes.c_int32
    fn.argtypes = [ptr64, ptr64, i64, i64, ptr32, i64, ptr32, ptr32, i64,
                   ptr32, ptr32, ptr32, i64, ptr32, ptr32, ptr32, ptr64,
                   ptr32, i64]
    S, C = blk.col.shape
    B = len(blk.starts)
    c = np.ascontiguousarray
    args = (c(blk.col), c(blk.end), S, C, c(blk.pl), blk.pl.shape[2],
            c(blk.pl_len), c(blk.ad), blk.ad.shape[2], c(blk.ad_len),
            c(blk.inv_bs), c(blk.nr_bs), blk.inv_bs.shape[2],
            c(blk.dp_info), c(blk.dp), c(blk.min_dp), c(blk.starts),
            c(blk.rec_num_merged), B)
    chk = fn(*args)          # warm
    t0 = time.perf_counter()
    chk2 = fn(*args)
    dt = time.perf_counter() - t0
    n_threads = os.cpu_count() or 1
    fn_mt = lib.gdb_seq_combine_bench_mt
    fn_mt.restype = ctypes.c_int32
    fn_mt.argtypes = fn.argtypes + [i64]
    chk_mt = fn_mt(*args, n_threads)   # warm
    t0 = time.perf_counter()
    chk_mt2 = fn_mt(*args, n_threads)
    dt_mt = time.perf_counter() - t0
    if not chk == chk2 == chk_mt == chk_mt2:
        raise RuntimeError(f"sequential checksums differ: {chk}, {chk2}, "
                           f"{chk_mt}, {chk_mt2}")
    return {"positions_per_sec": region_len / dt, "records_per_sec": B / dt,
            "records": int(B), "seconds": dt, "checksum": int(chk),
            "mt_threads": n_threads,
            "mt_positions_per_sec": region_len / dt_mt,
            "mt_seconds": dt_mt}


_IMPORT_HEADER = [
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="g">',
    '##FORMAT=<ID=DP,Number=1,Type=Integer,Description="d">',
    '##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="q">',
    '##FORMAT=<ID=MIN_DP,Number=1,Type=Integer,Description="m">',
    '##FORMAT=<ID=PL,Number=G,Type=Integer,Description="p">',
    '##INFO=<ID=END,Number=1,Type=Integer,Description="e">',
]


def _vid(tmpdir, extra=()):
    from .core.vid import VidMapper
    from .tools.genome_bench import write_vid
    path = os.path.join(tmpdir, "vid.json")
    write_vid(path, extra)
    return VidMapper.from_files(path)


def bench_import(n_records=20000, n_samples=8):
    """Import throughput, cells/sec: the native columnar-direct loader
    against the Python converter on one seeded ref-block cohort; `asa`:
    the native loader on a cohort whose every record carries the
    allele-specific 2-D INFO annotations."""
    from .store.fast_import import fast_import_file
    from .store.import_pipeline import VCFCellConverter
    from .vcf.reader import VCFFile
    random.seed(0)
    tmp = tempfile.mkdtemp(prefix="bench_import_")
    try:
        path = os.path.join(tmp, "bench_cohort.vcf")
        samples = [f"S{i}" for i in range(n_samples)]
        with open(path, "w") as f:
            f.write("##fileformat=VCFv4.1\n")
            for line in _IMPORT_HEADER + ['##contig=<ID=1,length=249250621>']:
                f.write(line + "\n")
            f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                    + "\t".join(samples) + "\n")
            pos = 1
            for i in range(n_records):
                end = pos + random.randint(10, 200)
                cells = "\t".join(
                    f"0/0:{random.randint(1, 60)}:0:0:0,0,0"
                    for _ in range(n_samples))
                f.write(f"1\t{pos}\t.\tC\t<NON_REF>\t.\t.\tEND={end}\t"
                        f"GT:DP:GQ:MIN_DP:PL\t{cells}\n")
                pos = end + 1
        vid = _vid(tmp)
        idx_to_row = {i: i for i in range(n_samples)}
        t0 = time.perf_counter()
        st = fast_import_file(path, vid, idx_to_row)
        t_fast = time.perf_counter() - t0
        if st is None:
            raise RuntimeError("the native import declined the cohort")
        t0 = time.perf_counter()
        cells = VCFCellConverter(VCFFile(path), vid, idx_to_row).convert()
        t_py = time.perf_counter() - t0
        asa = _bench_import_asa(tmp, n_records, n_samples)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"cells": st.num_cells,
            "native_cells_per_sec": st.num_cells / t_fast,
            "python_cells_per_sec": len(cells) / t_py,
            "speedup": t_py / t_fast, "asa": asa}


def _bench_import_asa(tmp, n_records, n_samples):
    """Native import of a cohort whose every record carries AS_RAW_MQ
    (element-wise sum) and AS_RAW_MQRankSum (histogram tuple), the
    GATK annotation shape, best of 3 after a warm read."""
    from .store.fast_import import fast_import_file
    random.seed(3)
    path = os.path.join(tmp, "bench_cohort_asa.vcf")
    samples = [f"S{i}" for i in range(n_samples)]
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.1\n")
        for line in _IMPORT_HEADER + [
                '##INFO=<ID=AS_RAW_MQ,Number=1,Type=String,Description="a">',
                '##INFO=<ID=AS_RAW_MQRankSum,Number=1,Type=String,'
                'Description="h">',
                '##contig=<ID=1,length=249250621>']:
            f.write(line + "\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(samples) + "\n")
        pos = 1
        for i in range(n_records):
            end = pos + random.randint(10, 200)
            mq = (f"{random.random()*40:.2f},{random.random()*40:.2f}"
                  f"|{random.random()*40:.2f}")
            rs = (f"|{random.random():.1f},{random.randint(1, 9)},"
                  f"{random.random():.1f},{random.randint(1, 9)}")
            cells = "\t".join(
                f"0/0:{random.randint(1, 60)}:0:0:0,0,0"
                for _ in range(n_samples))
            f.write(f"1\t{pos}\t.\tC\t<NON_REF>\t.\t.\tEND={end};"
                    f"AS_RAW_MQ={mq};AS_RAW_MQRankSum={rs}\t"
                    f"GT:DP:GQ:MIN_DP:PL\t{cells}\n")
            pos = end + 1
    vid = _vid(tmp, extra=("AS_RAW_MQ", "AS_RAW_MQRankSum"))
    idx_to_row = {i: i for i in range(n_samples)}
    st = fast_import_file(path, vid, idx_to_row)   # warm (page cache)
    if st is None:
        raise RuntimeError("the native import declined the ASA cohort")
    t_fast = None
    for _ in range(3):
        t0 = time.perf_counter()
        st = fast_import_file(path, vid, idx_to_row)
        dt = time.perf_counter() - t0
        t_fast = dt if t_fast is None else min(t_fast, dt)
    return {"cells": int(st.num_cells),
            "native_cells_per_sec": st.num_cells / t_fast}


def write_cohort100(path, n_samples=100, n_records=4000) -> int:
    """The JAX end-to-end lane's seeded cohort, byte for byte: reference
    blocks with a bi-allelic SNV every 20th record.  Returns the first
    position after the last record."""
    random.seed(1)
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
            '##INFO=<ID=BaseQRankSum,Number=1,Type=Float,Description="b">',
            '##contig=<ID=1,length=249250621>',
        ]:
            f.write(line + "\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(samples) + "\n")
        pos = 1
        for i in range(n_records):
            if i % 20 == 19:  # variant site
                cells = "\t".join(
                    f"0/1:{random.randint(1,40)},{random.randint(1,40)},0:"
                    f"{random.randint(10,99)}:{random.randint(10,99)}:.:"
                    f"{random.randint(0,500)},0,{random.randint(0,500)},"
                    f"{random.randint(0,500)},{random.randint(0,500)},"
                    f"{random.randint(0,500)}"
                    for _ in range(n_samples))
                f.write(f"1\t{pos}\t.\tC\tA,<NON_REF>\t50\t.\t"
                        f"BaseQRankSum={random.random():.3f}\t"
                        f"GT:AD:DP:GQ:MIN_DP:PL\t{cells}\n")
                pos += 1
            else:
                end = pos + random.randint(50, 400)
                cells = "\t".join(
                    f"0/0:.:{random.randint(1,60)}:0:0:0,0,0"
                    for _ in range(n_samples))
                f.write(f"1\t{pos}\t.\tC\t<NON_REF>\t.\t.\tEND={end}\t"
                        f"GT:AD:DP:GQ:MIN_DP:PL\t{cells}\n")
                pos = end + 1
    return pos


def bench_cohort_end_to_end(device, n_samples=100, n_records=4000):
    """The full pipeline on a 100-sample cohort: VCF text -> native
    import -> store->block -> device combine, then the combined VCF
    text through the block engine on the same device (the serving
    index off: this lane measures the engine).  Per-stage seconds and
    end-to-end positions/sec."""
    from .core.config import QueryParams
    from .ops.combine_step import block_to_tensors, combine_step
    from .ops.store_block import store_to_block
    from .query import driver
    from .store.import_pipeline import import_callsets
    tmp = tempfile.mkdtemp(prefix="bench_cohort100_")
    prev = os.environ.get("GENOMICSDB_TPU_SERVING_INDEX")
    try:
        path = os.path.join(tmp, "bench_cohort100.vcf")
        region_len = write_cohort100(path, n_samples, n_records)
        vid = _vid(tmp, extra=("BaseQRankSum",))
        vid.parse_callsets({"callsets": {
            f"S{i}": {"row_idx": i, "idx_in_file": i, "filename": path}
            for i in range(n_samples)}})
        t0 = time.perf_counter()
        store = import_callsets(vid)
        t_import = time.perf_counter() - t0
        qp = QueryParams()
        qp.scan_full = True
        qp.attributes = []
        qc = driver.make_query_config(qp, vid)
        t0 = time.perf_counter()
        blk = store_to_block(store, qc, interval=(0, region_len),
                             max_merged=4, ploidy=2)
        t_block = time.perf_counter() - t0

        def run_device():
            out = combine_step(*block_to_tensors(blk, device), max_merged=4,
                               ploidy=2)
            return _wrap32(checksum(out).item())

        t0 = time.perf_counter()
        chk = run_device()
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        if run_device() != chk:
            raise RuntimeError("device checksum changed between runs")
        t_device = time.perf_counter() - t0

        def run_text():
            qc2 = driver.make_query_config(qp, vid)
            return driver.run_vcf_query_block(store, qc2, qp, vid, device)

        os.environ["GENOMICSDB_TPU_SERVING_INDEX"] = "0"
        t0 = time.perf_counter()
        text = run_text()
        t_text_cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        text2 = run_text()
        t_text = time.perf_counter() - t0
    finally:
        if prev is None:
            os.environ.pop("GENOMICSDB_TPU_SERVING_INDEX", None)
        else:
            os.environ["GENOMICSDB_TPU_SERVING_INDEX"] = prev
        shutil.rmtree(tmp, ignore_errors=True)
    if text2 != text:
        raise RuntimeError("text phase not deterministic across runs")
    return {
        "samples": n_samples,
        "records": int(len(blk.starts)),
        "positions": int(region_len),
        "import_s": t_import,
        "block_build_s": t_block,
        "device_s": t_device,
        "compile_s": t_first - t_device,
        "end_to_end_positions_per_sec": region_len / t_text,
        "with_import_positions_per_sec": region_len / (t_import + t_text),
        "vcf_text_records": text.count("\n"),
        "vcf_text_cold_s": t_text_cold,
        "vcf_text_s": t_text,
        "vcf_text_positions_per_sec": region_len / t_text,
        "checksum": chk,
    }


def _tool_lane(module, args, device, timeout):
    """One of the port's tools in a fresh process with `--device`: its
    last stdout line as JSON.  A non-zero exit fails the lane."""
    from .tools.gdb_query import child_env
    r = subprocess.run(
        [sys.executable, "-m", f"genomicsdb_tpu_torch.tools.{module}",
         *args, "--device", str(device)],
        capture_output=True, text=True, timeout=timeout, env=child_env())
    if r.returncode != 0:
        raise RuntimeError(f"{module} exited {r.returncode}: "
                           f"{(r.stderr or '')[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def bench_out_of_core(device, target_bytes=2e9):
    """tools/ooc_bench: a ~2 GB single-fragment partition served whole
    in 10 MB windows, in a fresh process (its peak RSS is this
    workload's)."""
    return _tool_lane("ooc_bench", ["--target-bytes", str(target_bytes)],
                      device, 1200)


def bench_wide_cohort(device):
    """tools/wide_cohort_bench --skip-seq: the 1000-sample lane."""
    return _tool_lane("wide_cohort_bench", ["--skip-seq"], device, 1800)


def bench_process_scaling(device):
    """tools/scaling_bench --records 600000: 1/2/4 rank processes over
    an equally partitioned workspace, outputs byte-identical across K."""
    return _tool_lane("scaling_bench", ["--records", "600000"], device,
                      1200)


def bench_stream_latency(device):
    """tools/stream_latency_bench: 10 kb interval p50/p90 over the
    socket stream, engine, persistent and one-shot."""
    return _tool_lane("stream_latency_bench", [], device, 900)


def run_chip_lane(timeout=2400):
    """`pytest -m gpu tests/test_torch_gpu_lane.py`: {"passed",
    "failed", "skipped", "summary"}.  Fails unless every test passed."""
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu",
         "tests/test_torch_gpu_lane.py", "-v", "--no-header",
         "-p", "no:cacheprovider"],
        capture_output=True, text=True, timeout=timeout, cwd=ROOT)
    tail = (r.stdout or "").strip().splitlines()[-1:]
    out = {"passed": 0, "failed": 0, "skipped": 0}
    for key in out:
        m = re.search(rf"(\d+) {key}", tail[0] if tail else "")
        if m:
            out[key] = int(m.group(1))
    out["summary"] = tail[0] if tail else ""
    if r.returncode != 0:
        raise RuntimeError(f"the card's test lane failed: {out['summary']}"
                           f"\n{(r.stdout or '')[-3000:]}")
    return out


#: lane name -> (detail key of the JAX bench, runner(device, **sizes))
LANES = {
    "device": ("device", bench_device),
    "device_fused": ("device_fused_pallas", bench_device_fused),
    "device_fused_wide_1024_samples": ("device_fused_wide_1024_samples",
                                       bench_device_fused_wide_1024),
    "device_dense": ("device_dense_pregathered", bench_device_dense),
    "oracle": ("oracle", lambda device, **kw: bench_oracle(**kw)),
    "cpp_sequential_baseline": ("cpp_sequential_baseline",
                                lambda device, **kw:
                                bench_cpp_baseline(**kw)),
    "import": ("import", lambda device, **kw: bench_import(**kw)),
    "cohort100_end_to_end": ("cohort100_end_to_end",
                             bench_cohort_end_to_end),
    "out_of_core": ("out_of_core", bench_out_of_core),
    "wide_cohort_1000": ("wide_cohort_1000",
                         lambda device, **kw: bench_wide_cohort(device)),
    "process_scaling": ("process_scaling",
                        lambda device, **kw: bench_process_scaling(device)),
    "stream_latency": ("stream_latency",
                       lambda device, **kw: bench_stream_latency(device)),
    "chip_lane": ("chip_lane", lambda device, **kw: run_chip_lane()),
}


def run_lanes(device, lanes, sizes=None) -> dict:
    """{detail key: result} of the named lanes on `device`, in LANES
    order; `sizes` maps a lane to keyword arguments (its shape)."""
    device = torch.device(device)
    sizes = sizes or {}
    unknown = set(lanes) - set(LANES)
    if unknown:
        raise ValueError(f"unknown lanes {sorted(unknown)}; lanes: "
                         f"{', '.join(LANES)}")
    detail = {}
    for name, (key, fn) in LANES.items():
        if name in lanes:
            detail[key] = fn(device, **sizes.get(name, {}))
    return detail


def card(device) -> str:
    """The device as the results name it: the card's name and power
    limit (nvidia-smi's words) on CUDA, else "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def result_line(detail: dict, card_name: str) -> dict:
    """The JAX bench's full line: the headline metric (the best device
    lane's positions/sec) against the native sequential baseline (the
    Python oracle where that lane did not run), over `detail`.  Keys
    whose lanes did not run are None."""
    rates = [detail[k]["positions_per_sec"]
             for k in ("device", "device_fused_pallas") if k in detail]
    value = max(rates) if rates else None
    cpp = detail.get("cpp_sequential_baseline")
    oracle = detail.get("oracle")
    base = cpp["positions_per_sec"] if cpp else \
        oracle["positions_per_sec"] if oracle else None
    line = {
        "metric": "combine_positions_per_sec_per_chip",
        "value": value,
        "unit": "positions/sec",
        "vs_baseline": value / base if value and base else None,
        "vs_baseline_mt": value / cpp["mt_positions_per_sec"]
        if value and cpp else None,
        "card": card_name,
        "detail": dict(detail),
    }
    if oracle:
        d = line["detail"]
        d["oracle_positions_per_sec"] = d.pop("oracle")["positions_per_sec"]
        if value:
            d["vs_python_oracle"] = value / oracle["positions_per_sec"]
    return line


def compact_line(full: dict, detail_file: str) -> dict:
    """The JAX bench's compact stdout line (its `_emit` keys) of a full
    line."""
    d = full["detail"]

    def pick(*keys):
        cur = d
        for k in keys:
            if not isinstance(cur, dict) or k not in cur:
                return None
            cur = cur[k]
        return cur

    return {
        "metric": full["metric"],
        "value": full["value"],
        "unit": full["unit"],
        "vs_baseline": full["vs_baseline"],
        "vs_baseline_mt": full["vs_baseline_mt"],
        "fused_positions_per_sec":
            pick("device_fused_pallas", "positions_per_sec"),
        "wide1024_cells_per_sec":
            pick("device_fused_wide_1024_samples", "cells_per_sec"),
        "import_cells_per_sec": pick("import", "native_cells_per_sec"),
        "e2e_positions_per_sec":
            pick("cohort100_end_to_end", "end_to_end_positions_per_sec"),
        "wide_cohort_1000":
            {k: v for k, v in (pick("wide_cohort_1000") or {}).items()
             if k in ("cells_per_sec", "query_warm_s",
                      "interval_10kb_p50_ms", "import_s")},
        "process_scaling": {
            k: {"eff_pct": v.get("efficiency_pct"),
                "eff_spawn_pct": v.get("efficiency_spawn_pct"),
                "eff_compute_pct": v.get("efficiency_compute_pct")}
            for k, v in ((pick("process_scaling") or {})
                         .get("ranks", {})).items()},
        "stream_latency": {
            k: v for k, v in (pick("stream_latency") or {}).items()
            if k in ("socket_p50_ms", "socket_p90_ms",
                     "persistent_p50_ms", "persistent_p90_ms",
                     "engine_persistent_p50_ms", "socket_min_ms")},
        "chip_lane": {k: v for k, v in (pick("chip_lane") or {}).items()
                      if k != "summary"},
        "platform_note": None,
        "card": full["card"],
        "detail_file": detail_file,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="genomicsdb_tpu_torch.bench",
        description="The combine benchmark lanes on one torch device.")
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cuda' default, or 'cpu'); 'cuda' "
                         "without a card is an error")
    ap.add_argument("--lanes", default=None,
                    help="comma-separated lanes (default: all; chip_lane "
                         f"only on cuda): {', '.join(LANES)}")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="where the full result line goes (default "
                         "build/genomicsdb_tpu_torch/bench.json)")
    args = ap.parse_args(argv)
    from .device import resolve_device
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"bench: {e}")
    if args.lanes:
        lanes = [x for x in args.lanes.split(",") if x]
    else:
        lanes = [n for n in LANES
                 if n != "chip_lane" or device.type == "cuda"]
    full = result_line(run_lanes(device, lanes), card(device))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(full, f, indent=1)
        f.write("\n")
    # the headline table beside the JSON, from this very file; a failure
    # here fails the run
    from .tools.perf_table import write_table
    write_table(args.out)
    compact = compact_line(full, args.out)
    print(json.dumps(compact))
    return compact


if __name__ == "__main__":
    main()
