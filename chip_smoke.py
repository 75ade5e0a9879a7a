#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`genomicsdb_tpu_torch`) on one
NVIDIA card.

    python3 chip_smoke.py                 # from the root of a checkout
    python3 chip_smoke.py --profile DIR   # also torch.profiler tables of
                                          # one warm query per fetch mode,
                                          # written to DIR

Every phase passes or the script exits non-zero:

  1. Environment: the card, its power limit, the CUDA, torch and nvcc
     versions; builds the CUDA kernel library from csrc/ (build time and
     the ptxas report) and the native text library.
  2. The CUDA kernel in both forms (wide: int32 outputs; narrow: int16
     PL/AD/GT/GQ/DP/MIN_DP with the BCF16 sentinels) against its plain
     torch twin on the card, bit-exact over every output (cells with no
     live call included), at the synthetic shapes 128 samples x 2048
     cells x 262,144 positions (m 4, diploid), 1024 x 256 x 32,768, and
     a mixed-ploidy phased block with 16 merged alleles; times from CUDA
     events, in the order twin wide, twin narrow, kernel wide, kernel
     narrow, then the same backwards.
  3. End to end through the entry points: a seeded 1,000-sample gVCF
     cohort is written, imported with `genomicsdb_tpu.tools.vcf2gdb`
     (its `main`, in this process: jax is blocked for the whole run),
     and queried with the port's `gdb_query --produce-Broad-GVCF`
     (block engine) on `--device cuda` with the fetch pack on (the
     card's default: narrow kernel, packed variant-row fetch; cold, then
     warm), off (warm), off and on again, and on `--device cpu`.  The
     texts must be byte-identical; with the pack on every block must
     have launched the narrow kernel and the variant-row split must have
     engaged, with it off every block the wide kernel; the block output
     over the cohort's first records must equal the sequential
     engine's.  The bytes each fetch mode copied to the host are
     printed.

The last lines are the kernel JSON, the card's name and power limit,
and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "genomicsdb_tpu_torch/csrc/fused_gather_remap.cu"
# the TPU kernels the CUDA kernel replaces: _make_kernel_rt wide, its
# narrow form, and _make_kernel (the wide, non-mixed function)
PALLAS = "genomicsdb_tpu/ops/pallas_combine.py"
E2E_SAMPLES, E2E_RECORDS = 1000, 4000


def _run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def phase_environment(torch):
    from genomicsdb_tpu.runtime import native_loader
    from genomicsdb_tpu_torch.ops._kernel_build import load_library, _nvcc
    card = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"])
    print(f"card: {card}")
    print(f"torch {torch.__version__}, torch.version.cuda "
          f"{torch.version.cuda}, devices {torch.cuda.device_count()}, "
          f"device 0 {torch.cuda.get_device_name(0)}")
    print(_run([_nvcc(), "--version"]).splitlines()[-1])
    kl = load_library()
    print(f"kernel library {os.path.relpath(kl.path, ROOT)}: built in "
          f"{kl.build_seconds:.2f} s")
    for line in kl.ptxas_log.splitlines():
        if "ptxas" in line:
            print("  " + line.strip())
    t0 = time.perf_counter()
    if native_loader.get_lib() is None:
        raise RuntimeError("native text library did not build")
    print(f"native text library ready in {time.perf_counter() - t0:.2f} s")
    return card.splitlines()[0]


def _kernel_inputs(blk, dev, mixed):
    from genomicsdb_tpu_torch.ops.combine_step import block_to_tensors
    t = block_to_tensors(blk, dev)
    return (*t[:12], t[16], t[12], t[13], t[14], t[15],
            t[18] if mixed else None)


def _time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _bits(torch, x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _check_against_twin(torch, label, got, twin) -> int:
    """Bit-exact comparison of every output; returns the max abs error
    over the integer outputs (0 when they agree)."""
    err = 0
    for key, ref in twin.items():
        out = got[key]
        if out.shape != ref.shape or out.dtype != ref.dtype:
            raise AssertionError(f"{label}: {key} {out.dtype}"
                                 f"{tuple(out.shape)} vs twin "
                                 f"{ref.dtype}{tuple(ref.shape)}")
        if not torch.equal(_bits(torch, out), _bits(torch, ref)):
            n = int((_bits(torch, out) != _bits(torch, ref)).sum())
            raise AssertionError(f"{label}: {key} differs from the "
                                 f"twin at {n} elements")
        if ref.dtype != torch.float32 and ref.numel():
            d = (out.long() - ref.long()).abs().max()
            err = max(err, int(d))
    return err


def phase_kernel_vs_twin(torch, np, dev):
    """Returns {mode: (max_abs_err, kernel_ms, twin_ms)} of the
    production-shape case for the wide and the narrow form, after
    checking every case bit for bit in both."""
    from genomicsdb_tpu_torch.ops import fused_combine as FC
    from genomicsdb_tpu_torch.ops.cell_block import synthesize_cohort
    cases = [
        # (label, samples, cells, region, max_merged, ploidy, mixed)
        ("bench 128x2048x262144 m4 p2", 128, 2048, 262144, 4, 2, False),
        ("wide 1024x256x32768 m4 p2", 1024, 256, 32768, 4, 2, False),
        ("mixed phased 32x128x8192 m16 pmax3", 32, 128, 8192, 16, 3,
         True),
    ]
    first = None
    for label, S, C, R, m, p, mixed in cases:
        blk = synthesize_cohort(S, C, R, seed=0, max_merged=m, ploidy=p)
        rng = np.random.default_rng(1)
        B, S = blk.live.shape
        C = blk.col.shape[1]
        # cells with no live call (LUTs -1, as the store path writes them)
        drop = rng.random((B, S)) < 0.05
        blk.live = np.where(drop, -1, blk.live).astype(np.int32)
        blk.inv_bs = np.where(drop[..., None], -1, blk.inv_bs
                              ).astype(np.int32)
        blk.nr_bs = np.where(drop, -1, blk.nr_bs).astype(np.int32)
        if mixed:
            # phased storage: allele, phase, allele, phase, allele
            gt = np.zeros((S, C, 2 * p - 1), np.int32)
            gt[..., 0::2] = blk.gt
            gt[..., 1::2] = rng.integers(0, 2, (S, C, p - 1))
            blk.gt = gt
            blk.gt_len_bs = np.where(
                drop, 0, rng.integers(0, 2 * p, (B, S))).astype(np.int32)
        if not (FC._narrow_inputs_ok(blk) and FC._narrow_scalars_ok(blk)):
            raise AssertionError(f"{label}: the synthetic block does not "
                                 "fit the narrow form")
        args = _kernel_inputs(blk, dev, mixed)
        base = dict(max_merged=m, ploidy=p, gt_phase=mixed, mixed=mixed)
        modes = {"wide": base,
                 "narrow": dict(base, narrow=True, narrow_scalars=True)}
        errs = {}
        for mode, kw in modes.items():
            twin = FC.fused_gather_remap_ref(*args, **kw)
            got = FC.fused_gather_remap(*args, **kw)
            torch.cuda.synchronize()
            errs[mode] = _check_against_twin(torch, f"{label} {mode}", got,
                                             twin)
            del twin, got
        reps_k, reps_t = 20, 3

        def kern(mode):
            return _time_ms(torch, lambda: FC.fused_gather_remap(
                *args, **modes[mode]), reps_k)

        def plain(mode):
            return _time_ms(torch, lambda: FC.fused_gather_remap_ref(
                *args, **modes[mode]), reps_t)

        t = {"twin wide": [plain("wide")], "twin narrow": [plain("narrow")],
             "wide": [kern("wide")], "narrow": [kern("narrow")]}
        t["narrow"].append(kern("narrow"))
        t["wide"].append(kern("wide"))
        t["twin narrow"].append(plain("narrow"))
        t["twin wide"].append(plain("wide"))
        res = {}
        for mode in modes:
            k_ms = sum(t[mode]) / 2
            twin_ms = sum(t["twin " + mode]) / 2
            res[mode] = (errs[mode], k_ms, twin_ms)
            print(f"kernel vs twin [{label}, {mode}]: B={B} S={S} "
                  f"bit-exact (tolerance 0: every integer word and "
                  f"float32 bit pattern equal, max abs err {errs[mode]}); "
                  f"kernel {t[mode][0]:.4f}/{t[mode][1]:.4f} ms, twin "
                  f"{t['twin ' + mode][0]:.4f}/{t['twin ' + mode][1]:.4f} "
                  f"ms (mean kernel {k_ms:.4f}, twin {twin_ms:.4f})")
        if first is None:
            first = res
        del args
        torch.cuda.empty_cache()
    return first


def _query(argv, pack=None) -> str:
    from genomicsdb_tpu_torch.tools import gdb_query
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        gdb_query.main(argv, pack=pack)
    return buf.getvalue()


def _counters():
    from genomicsdb_tpu_torch.ops import combine_step as TC
    from genomicsdb_tpu_torch.ops import fused_combine as FC
    from genomicsdb_tpu_torch.query import block_writer as BW
    return ((FC.fused_gather_remap, "launches"),
            (FC.fused_gather_remap, "narrow_launches"),
            (FC.combine_block, "blocks"),
            (FC.combine_block, "general_path_blocks"),
            (FC.combine_block, "wide_blocks_when_packing"),
            (BW.render_block_vcf_pipelined, "split_blocks"),
            (TC.fetch_outputs, "fetched_bytes"))


def _counted_query(torch, argv, pack=None):
    """(text, seconds, counts) of one query, every count set to 0 just
    before it and read just after."""
    for obj, name in _counters():
        setattr(obj, name, 0)
    t0 = time.perf_counter()
    text = _query(argv, pack=pack)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return text, dt, {name: getattr(obj, name) for obj, name in _counters()}


def phase_end_to_end(torch, card):
    """Returns (counts of the warm pack-on query, of the warm pack-off
    query, the cohort)."""
    from genomicsdb_tpu_torch.testing import write_cohort
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=build)
    t0 = time.perf_counter()
    c = write_cohort(work, E2E_SAMPLES, E2E_RECORDS, seed=0)
    print(f"cohort: {E2E_SAMPLES} samples x {E2E_RECORDS} records per "
          f"file, {len(c.vcfs)} files, columns 0..{c.region}, written in "
          f"{time.perf_counter() - t0:.2f} s")
    from genomicsdb_tpu.tools import vcf2gdb
    t0 = time.perf_counter()
    vcf2gdb.main([c.loader])
    print(f"import (vcf2gdb): {time.perf_counter() - t0:.2f} s")
    base = ["-j", c.query, "--produce-Broad-GVCF", "--engine", "block"]
    cuda = base + ["--device", "cuda"]
    # the card's default (pack on) cold, then warm on / off / off / on
    cold, t_cold, _ = _counted_query(torch, cuda)
    on1, t_on1, c_on = _counted_query(torch, cuda)
    off1, t_off1, c_off = _counted_query(torch, cuda, pack=False)
    off2, t_off2, _ = _counted_query(torch, cuda, pack=False)
    on2, t_on2, _ = _counted_query(torch, cuda)
    t0 = time.perf_counter()
    on_cpu = _query(base + ["--device", "cpu"])
    t_cpu = time.perf_counter() - t0
    records = len(on1.splitlines())
    positions = c.region + 1
    t_on, t_off = (t_on1 + t_on2) / 2, (t_off1 + t_off2) / 2
    print(f"block query: {records} records; cuda pack on: cold "
          f"{t_cold:.3f} s, warm {t_on1:.3f} / {t_on2:.3f} s; cuda pack "
          f"off: warm {t_off1:.3f} / {t_off2:.3f} s; cpu device "
          f"{t_cpu:.3f} s [{card}]")
    print(f"warm pack on: {positions / t_on:.1f} positions/s, "
          f"{records / t_on:.1f} records/s; pack off: "
          f"{positions / t_off:.1f} positions/s, {records / t_off:.1f} "
          f"records/s over {positions} positions [{card}]")
    cells = records * E2E_SAMPLES
    print(f"fetched to the host per query: pack on "
          f"{c_on['fetched_bytes']} bytes "
          f"({c_on['fetched_bytes'] / cells:.2f} per emitted (record, "
          f"sample)), pack off {c_off['fetched_bytes']} bytes "
          f"({c_off['fetched_bytes'] / cells:.2f})")
    print(f"pack on: {c_on}")
    print(f"pack off: {c_off}")
    if records == 0:
        raise AssertionError("the block query produced no records")
    if not (cold == on1 == off1 == off2 == on2 == on_cpu):
        raise AssertionError("pack on / pack off / --device cpu texts "
                             "differ")
    if not (c_on["narrow_launches"] == c_on["launches"] == c_on["blocks"]
            > 0 and c_on["general_path_blocks"] == 0
            and c_on["wide_blocks_when_packing"] == 0):
        raise AssertionError(f"pack on: expected one narrow kernel launch "
                             f"per block: {c_on}")
    if c_on["split_blocks"] == 0:
        raise AssertionError("pack on: the variant-row split never engaged")
    if not (c_off["launches"] == c_off["blocks"] > 0
            and c_off["narrow_launches"] == 0
            and c_off["general_path_blocks"] == 0):
        raise AssertionError(f"pack off: expected one wide kernel launch "
                             f"per block: {c_off}")
    head = ["-j", c.query_head, "--produce-Broad-GVCF"]
    blk_head = _query(head + ["--engine", "block", "--device", "cuda"])
    seq_head = _query(head + ["--engine", "sequential", "--device",
                              "cuda"])
    n_head = len(seq_head.splitlines())
    if blk_head != seq_head or n_head == 0:
        raise AssertionError("block engine differs from the sequential "
                             "engine over the head interval")
    print(f"block == sequential over columns {c.head_interval} "
          f"({n_head} records)")
    return c_on, c_off, c


def phase_profile(torch, c, card, out_dir):
    """torch.profiler over one warm query per fetch mode: device time
    by kind (copies each way, kernels) against the wall time; tables
    go to `out_dir`."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(out_dir, exist_ok=True)
    argv = ["-j", c.query, "--produce-Broad-GVCF", "--device", "cuda"]
    for label, pack in (("pack_on", True), ("pack_off", False)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _query(argv, pack=pack)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        sums, counts, total = {}, {}, 0.0
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            if e.self_cpu_time_total == 0:
                # device activities only: the op that launched one
                # carries the same device time again
                total += us
            kind = ("DtoH" if e.key.startswith("Memcpy DtoH") else
                    "HtoD" if e.key.startswith("Memcpy HtoD") else
                    "kernel" if "fused_gather_remap_kernel" in e.key
                    else None)
            if kind:
                sums[kind] = sums.get(kind, 0.0) + us
                counts[kind] = counts.get(kind, 0) + e.count
        table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=40)
        with open(os.path.join(out_dir, f"profile_{label}.txt"), "w") as f:
            f.write(table)
        print(f"profile [{label}]: wall {wall:.3f} s under the profiler, "
              f"device time {total / 1e3:.3f} ms "
              f"({100 * total / 1e6 / wall:.2f}% of the wall); "
              + ", ".join(f"{k} {sums[k] / 1e3:.3f} ms over {counts[k]}"
                          for k in sorted(sums)) + f" [{card}]")


def main() -> int:
    ap = argparse.ArgumentParser(
        description="Smoke run of the PyTorch/CUDA port on one NVIDIA card.")
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one warm query per fetch mode and "
                         "write the tables to DIR")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(ROOT, "genomicsdb_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(genomicsdb_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    # the port runs without jax: block it, so that no module on the path
    # (the shared host modules of genomicsdb_tpu included) can load it
    sys.modules["jax"] = None
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch.cuda is not available: this smoke run needs a CUDA "
              "card", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    card = phase_environment(torch)
    kern = phase_kernel_vs_twin(torch, np, dev)
    c_on, c_off, cohort = phase_end_to_end(torch, card)
    if args.profile:
        phase_profile(torch, cohort, card, os.path.abspath(args.profile))

    def entry(name, replaces, mode, launches):
        err, ms, plain_ms = kern[mode]
        return {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}

    print(json.dumps({"kernels": [
        entry("fused_gather_remap (wide)", f"{PALLAS}:875", "wide",
              c_off["launches"]),
        entry("fused_gather_remap (narrow int16 outputs)",
              f"{PALLAS}:1070", "narrow", c_on["narrow_launches"]),
        entry("fused_gather_remap (wide, non-mixed: the per-sample "
              "_make_kernel function)", f"{PALLAS}:264", "wide",
              c_off["launches"]),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
