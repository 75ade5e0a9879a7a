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
  2. The CUDA kernel in its three forms (wide: int32 outputs; narrow:
     int16 PL/AD/GT; narrow+scalars: GQ/DP/MIN_DP int16 too, with the
     BCF16 sentinels) against its plain torch twin on the card,
     bit-exact over every output (cells with no live call included), at
     the synthetic shapes 128 samples x 2048 cells x 262,144 positions
     (m 4, diploid), 1024 x 256 x 32,768, a mixed-ploidy phased block
     with 16 merged alleles, a block whose records and samples are not
     multiples of the kernel's tile, and a mixed block at 16 merged
     alleles and ploidy up to 6 (54,264 genotypes: PL in chunks); times
     twins then kernels, then the same backwards, with each launch's
     bytes and byte bound.
  3. End to end through the entry points: a seeded 1,000-sample gVCF
     cohort is written, imported with the port's
     `genomicsdb_tpu_torch.tools.vcf2gdb` (its `main`, in this process:
     jax and genomicsdb_tpu are blocked for the whole run),
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
  4. The main path's kernel launches: one more warm query records the
     shape (B, S, C, G_in, A_in, M, G_out, gt_w, F, Fi, Fs, form), bytes
     and byte bound of every launch; the largest launch's inputs (the
     store-wide slabs) are held against the twin in all three forms and
     timed.
  5. Serving: the port's `QueryStreamServer` in this process on cuda:0
     answers 24 seeded 10 kb intervals of the same cohort in three
     lanes, each behind warm-up queries: a persistent client with the
     serving index off (the engine lane: every block must launch the
     narrow kernel; the host-to-device bytes of its first and second
     warm-up query are printed), a persistent client with the index on
     (its build timed on its own; no block may reach the device
     combine) and one-shot connections.  Every response must be
     byte-identical across lanes, the engine after the build, a
     cpu-device server (3 intervals) and four concurrent persistent
     clients (on a cold server with the index off, then served).  Prints
     p50/p90 per lane, the mean response bytes, the engine lane's
     launches (padded against real records) and holds its most frequent
     launch against the twin in all three forms.  Then `gdb_query -p
     65536` on cuda must give phase 3's text, and `gdb_query --ooc -s
     <a quarter of the store>` must too, over more than one window and
     with a lower device-memory high-water mark than the in-RAM query.
  6. Distribution: `gdb_query --mesh 1x1 --device cuda` (one rank
     process, NCCL) and `--mesh 2x2` (four rank processes sharing
     cuda:0 on gloo) must give phase 3's text byte for byte; every rank
     must have launched the CUDA kernel once per block (printed per
     rank).  The 2x2 mesh's largest shard launch (the first rank's shard
     of the main path's largest block) is held against the twin and
     timed.  The cohort's store is cut into 4 column partitions
     (`parallel.repartition`); `--parallel-ranks --num-ranks 4` on cuda
     must equal the in-process `--num-ranks 4` text.  Two processes run
     a `multihost.gather_blobs_to_root` round (lengths 0 and 3 MB, 1 MB
     rounds).  Wall times beside the unsharded query's in this call.
  7. The remaining paths: the port's bench lanes (`genomicsdb_tpu_torch.
     bench`) in this process at the JAX bench's shapes, each printed
     as JSON with the card: `device`, `device_fused` and
     `device_fused_wide_1024_samples` (wide and narrow: the narrow
     checksum must equal the wide one), `device_dense` (its checksum
     must equal the general combine_step's on the same 8192-record
     chunk), `cpp_sequential_baseline`, `cohort100_end_to_end` and
     `import`; each fused lane's pass split into the kernel's time and
     the rest; a 17-allele block (the general path) restricted by
     `remap_rows` must equal the unrestricted step's rows;
     `tools.deletion_bench` (100 x 500) and `tools.wide_cohort_bench
     --samples 1000 --records 1000 --windows 2` in this process and
     `tools.ooc_bench --target-bytes 1e8` in its own (more than one
     window), each with its own checks; the graft entry's
     step on cuda must equal it on cpu, and `dryrun_multichip(4)` (four
     ranks on cuda:0, gloo) must pass.  The lanes' and tools' kernel
     launches join the main path's in the kernel JSON.
  8. Streaming import and the demos: a seeded cohort at the full width
     (1,000 samples in 8 files) but 400 records per file, a tenth of
     phase 3's depth, because the streaming importer converts each cell
     in Python; each file's BCF2 encoding (GATK4's wire format) is
     pushed through the port's `StreamingImporter` in 64 KiB writes
     with `import_batch()` after each, then `finalize()`.  The streamed
     store must equal the one `vcf2gdb` writes from the same files, file
     by file and byte for byte (the fragment's time-stamped name
     masked); its block query on cuda:0 (pack on) must equal, byte for
     byte, the `vcf2gdb` store's `gdb_query` on cuda and its own query
     on the cpu device, and every block must launch the narrow kernel
     (each launch's shape and bytes printed); over the head interval it
     must equal the sequential engine.  Prints the streamed cells/s, the
     finalize and query seconds.  Then the demos on cuda:0: the block
     engine and query stream demos in this process (each must launch
     the narrow kernel), the sharded demo as its 8 rank processes on
     the card (gloo), whose gathered block must equal the unsharded
     `combine_step` on cuda:0.  Their launches join the kernel JSON.

Times are CUDA events around back-to-back calls after a warm-up.  A
kernel's time is that of launches bound once (only a ctypes call between
two launches); the wrapper's call time (checks, plan and allocations
included) is printed beside it; the twin's is that of its calls.

The last lines are each phase's wall time, the kernel JSON, the card's
name and power limit, and `{"ok": true, "device": {...}}`.
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
SERVING_QUERIES, SERVING_BP = 24, 10_000
# phase 8: the full width at a tenth of phase 3's depth (the streaming
# importer converts cells in Python, per cell), in 64 KiB writes
STREAM_SAMPLES, STREAM_RECORDS, STREAM_WRITE = 1000, 400, 64 * 1024
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
# the kernel's forms: (narrow, narrow_scalars)
FORMS = {"wide": (False, False), "narrow": (True, False),
         "narrow+scalars": (True, True)}


def _run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def phase_environment(torch):
    from genomicsdb_tpu_torch.runtime import native_loader
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
    for line in _ptxas_summary(kl.ptxas_log):
        print("  " + line)
    t0 = time.perf_counter()
    if native_loader.get_lib() is None:
        raise RuntimeError("native text library did not build")
    print(f"native text library ready in {time.perf_counter() - t0:.2f} s")
    return card.splitlines()[0]


def _ptxas_summary(log):
    """One line per kernel instantiation of nvcc's -Xptxas -v report:
    its output widths and path, registers, stack frame and spills."""
    import re
    width = {"i": "int32", "s": "int16"}
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*fused_gather_remap_kernelI"
                      r"([is])([is])Li(\d+)E", line)
        if m:
            vt, st, dm = m.groups()
            path = f"diploid, M <= {dm}" if dm != "0" else "general"
            name = (f"PL/AD/GT {width[vt]}, GQ/DP/MIN_DP {width[st]}, "
                    f"{path}")
            frame = "stack frame not reported"
        elif name and "stack frame" in line:
            frame = line.strip()
        elif name and "Used" in line:
            out.append(f"ptxas [{name}]: {line.split(':', 1)[1].strip()}; "
                       f"{frame}")
            name = None
    return out


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


def _kernel_ms(torch, args, kw, reps):
    """The kernel's time per launch: CUDA events around `reps` launches
    bound once (`fused_combine._prepare`), after a warm-up, so that only
    a ctypes call stands between two launches.  Not counted."""
    from genomicsdb_tpu_torch.ops import fused_combine as FC
    _, launch = FC._prepare(*args, **kw)
    return _time_ms(torch, launch, reps)


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


def _launch_bytes(torch, args, kw):
    """(bytes, distinct live cells) of one launch: each distinct live
    cell's fields read once (of its PL and AD rows only the entries
    below its PL and AD lengths, all that the kernel reads), the
    per-(record, sample) LUT rows and the per-record counts read once,
    every output written once."""
    from genomicsdb_tpu_torch.ops.cell_block import genotype_combo_table
    pl, pl_len, ad, ad_len, gt = args[:5]
    info_f, info_i, info_fs, live = args[9:13]
    S, C, G_in = pl.shape
    B = live.shape[0]
    M, mixed = kw["max_merged"], kw.get("mixed", False)
    nf = info_f.shape[0] + info_i.shape[0] + info_fs.shape[0]
    s_idx = torch.arange(S, device=live.device, dtype=torch.int64)[None]
    key = torch.unique((s_idx * C + live.long())[live >= 0])
    cells = int(key.numel())
    rows = int(pl_len.reshape(-1)[key].clamp(0, G_in).sum()
               + ad_len.reshape(-1)[key].clamp(0, ad.shape[2]).sum())
    cell_bytes = 4 * rows + cells * 4 * (gt.shape[2] + 6 + nf)
    lut = B * S * 4 * (2 + M + (1 if mixed else 0)) + 8 * B
    G_out = len(genotype_combo_table(M, kw["ploidy"]))
    ev = 2 if kw.get("narrow") else 4
    es = 2 if kw.get("narrow_scalars") else 4
    out = B * S * ((G_out + M + gt.shape[2]) * ev + 3 * es + 4 + 4 * nf)
    return cell_bytes + lut + out, cells


def _bound_ms(nbytes):
    return nbytes / HBM_BYTES_PER_S * 1e3


def _synthetic_block(np, label, S, C, R, m, p, mixed, keep_b=None):
    """A synthetic cohort block with 5% of (record, sample) cells
    without a live call (LUTs -1, as the store path writes them),
    optionally cut to its first `keep_b` records; mixed blocks carry a
    phased GT layout and per-call GT lengths."""
    from genomicsdb_tpu_torch.ops import fused_combine as FC
    from genomicsdb_tpu_torch.ops.cell_block import synthesize_cohort
    blk = synthesize_cohort(S, C, R, seed=0, max_merged=m, ploidy=p)
    if keep_b is not None:
        for name in ("inv_bs", "nr_bs", "starts", "rec_num_merged",
                     "rec_has_nr", "live", "del_rw", "gt_len_bs"):
            if getattr(blk, name) is not None:
                setattr(blk, name, getattr(blk, name)[:keep_b])
    rng = np.random.default_rng(1)
    B, S = blk.live.shape
    C = blk.col.shape[1]
    drop = rng.random((B, S)) < 0.05
    blk.live = np.where(drop, -1, blk.live).astype(np.int32)
    blk.inv_bs = np.where(drop[..., None], -1, blk.inv_bs).astype(np.int32)
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
    return blk


def _forms_vs_twin(torch, label, args, base, reps_k, reps_t, forms=FORMS):
    """Holds the kernel against the twin in each of `forms`, bit for bit,
    then times both with CUDA events (twins, kernels, kernels, twins).
    Returns {form: (max_abs_err, kernel_ms, twin_ms, bytes)}."""
    from genomicsdb_tpu_torch.ops import fused_combine as FC
    modes = {f: dict(base, narrow=n, narrow_scalars=ns)
             for f, (n, ns) in forms.items()}
    errs = {}
    for mode, kw in modes.items():
        twin = FC.fused_gather_remap_ref(*args, **kw)
        got = FC.fused_gather_remap(*args, **kw)
        torch.cuda.synchronize()
        errs[mode] = _check_against_twin(torch, f"{label} {mode}", got,
                                         twin)
        del twin, got

    def kern(mode):
        return _kernel_ms(torch, args, modes[mode], reps_k)

    def plain(mode):
        return _time_ms(torch, lambda: FC.fused_gather_remap_ref(
            *args, **modes[mode]), reps_t)

    t = {}
    for fn, prefix in ((plain, "twin "), (kern, "")):
        for mode in modes:
            t[prefix + mode] = [fn(mode)]
    for fn, prefix in ((kern, ""), (plain, "twin ")):
        for mode in reversed(list(modes)):
            t[prefix + mode].append(fn(mode))
    res = {}
    B, S = args[12].shape
    for mode, kw in modes.items():
        nbytes, cells = _launch_bytes(torch, args, kw)
        k_ms = sum(t[mode]) / 2
        twin_ms = sum(t["twin " + mode]) / 2
        call_ms = _time_ms(torch, lambda: FC.fused_gather_remap(
            *args, **kw), reps_k)
        res[mode] = (errs[mode], k_ms, twin_ms, nbytes)
        bound = _bound_ms(nbytes)
        print(f"kernel vs twin [{label}, {mode}]: B={B} S={S} "
              f"bit-exact (tolerance 0: every integer word and "
              f"float32 bit pattern equal, max abs err {errs[mode]}); "
              f"kernel {t[mode][0]:.4f}/{t[mode][1]:.4f} ms, "
              f"twin {t['twin ' + mode][0]:.4f}/"
              f"{t['twin ' + mode][1]:.4f} ms (mean kernel {k_ms:.4f}, "
              f"twin {twin_ms:.4f}; wrapper call, host included, "
              f"{call_ms:.4f}); {nbytes} bytes ({cells} distinct live "
              f"cells), bound {bound:.4f} ms, {100 * bound / k_ms:.1f}% "
              f"of it")
    return res


def phase_kernel_vs_twin(torch, np, dev):
    """Checks every synthetic case bit for bit in every form, and times
    it."""
    from genomicsdb_tpu_torch.ops import fused_combine as FC
    from genomicsdb_tpu_torch.ops.cell_block import genotype_combo_table
    cases = [
        # (label, samples, cells, region, max_merged, ploidy, mixed,
        #  records kept)
        ("bench 128x2048x262144 m4 p2", 128, 2048, 262144, 4, 2, False,
         None),
        ("wide 1024x256x32768 m4 p2", 1024, 256, 32768, 4, 2, False,
         None),
        ("mixed phased 32x128x8192 m16 pmax3", 32, 128, 8192, 16, 3,
         True, None),
        ("ragged 999x128x16384 m4 p2, B 1001", 999, 128, 16384, 4, 2,
         False, 1001),
        ("mixed phased 4x16x512 m16 pmax6", 4, 16, 512, 16, 6, True, 120),
    ]
    for label, S, C, R, m, p, mixed, keep_b in cases:
        blk = _synthetic_block(np, label, S, C, R, m, p, mixed, keep_b)
        args = _kernel_inputs(blk, dev, mixed)
        B, S = blk.live.shape
        base = dict(max_merged=m, ploidy=p, gt_phase=mixed, mixed=mixed)
        for form, (n, ns) in FORMS.items():
            plan = FC.tile_plan(
                B, S, m, len(genotype_combo_table(m, p)), blk.gt.shape[2],
                blk.info_f.shape[0], blk.info_i.shape[0],
                blk.info_fs.shape[0], mixed=mixed, narrow=n,
                narrow_scalars=ns, n_sm=FC._sm_count(dev))
            print(f"  tile plan [{label}, {form}]: {plan.tb} records x "
                  f"{plan.ts} samples, {plan.n_tiles} tiles on "
                  f"{plan.grid} blocks, {plan.n_chunks} PL pass(es) of "
                  f"{plan.gc} genotypes, {plan.smem} bytes of shared "
                  f"memory")
        if label.startswith("ragged") and not (B % plan.tb
                                                and S % plan.ts):
            raise AssertionError(f"{label}: B and S must not be multiples "
                                 "of the tile")
        big = m == 16 and p == 6
        _forms_vs_twin(torch, label, args, base, reps_k=3 if big else 20,
                       reps_t=1 if big else 3)
        del args
        torch.cuda.empty_cache()


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
    from genomicsdb_tpu_torch.tools import vcf2gdb
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
    return c_on, c_off, c, on1


def _launch_key(args, kw):
    pl, live = args[0], args[12]
    form = "narrow+scalars" if kw["narrow_scalars"] else \
        "narrow" if kw["narrow"] else "wide"
    return (tuple(live.shape), pl.shape[1], pl.shape[2], args[2].shape[2],
            kw["max_merged"], kw["ploidy"], args[4].shape[2],
            args[9].shape[0], args[10].shape[0], args[11].shape[0], form)


def phase_main_path(torch, c, card):
    """Records every kernel launch of one more warm pack-on query (not
    counted), then holds the largest launch's inputs against the twin in
    every form and times them.  Returns ({form: (max_abs_err, kernel_ms,
    twin_ms, bytes)} at that launch, that launch's (args, keywords))."""
    from genomicsdb_tpu_torch.ops import fused_combine as FC
    argv = ["-j", c.query, "--produce-Broad-GVCF", "--device", "cuda"]
    seen = []
    launch = FC._launch

    def recorder(*args, **kw):
        seen.append((args, kw))
        return launch(*args, **kw)

    FC._launch = recorder
    try:
        _query(argv)
    finally:
        FC._launch = launch
    shapes = {}
    total = 0
    for args, kw in seen:
        nbytes, cells = _launch_bytes(torch, args, kw)
        total += nbytes
        shapes.setdefault(_launch_key(args, kw), []).append((nbytes, cells))
    print(f"main path: {len(seen)} kernel launches, {total} bytes, "
          f"bound {_bound_ms(total):.4f} ms in all [{card}]")
    for (bs, C, G_in, A_in, M, p, gt_w, F, Fi, Fs, form), v in sorted(
            shapes.items()):
        print(f"  {len(v)} x B={bs[0]} S={bs[1]} C={C} G_in={G_in} "
              f"A_in={A_in} M={M} ploidy={p} gt_w={gt_w} F={F} Fi={Fi} "
              f"Fs={Fs} {form}: bytes "
              f"{min(x[0] for x in v)}..{max(x[0] for x in v)}, distinct "
              f"live cells {min(x[1] for x in v)}..{max(x[1] for x in v)}")
    args, kw = max(seen, key=lambda a: a[0][12].numel())
    base = {k: kw[k] for k in ("max_merged", "ploidy", "gt_phase",
                               "mixed")}
    B, S = args[12].shape
    label = f"main-path launch B={B} S={S} C={args[0].shape[1]}"
    return _forms_vs_twin(torch, label, args, base, reps_k=50,
                          reps_t=3), (args, base)


def _set_serving_index(on: bool) -> None:
    if on:
        os.environ.pop("GENOMICSDB_TPU_SERVING_INDEX", None)
    else:
        os.environ["GENOMICSDB_TPU_SERVING_INDEX"] = "0"


def _timed_lane(torch, query, docs):
    """(sorted latencies in s, responses) of one query per document."""
    lats, outs = [], []
    for d in docs:
        t0 = time.perf_counter()
        outs.append(query(d))
        torch.cuda.synchronize()
        lats.append(time.perf_counter() - t0)
    return sorted(lats), outs


def _pct_ms(lats, q):
    return 1e3 * lats[min(len(lats) - 1, int(q * len(lats)))]


def _concurrent(SS, addr, docs, want, n_clients=4, per_client=6):
    """n_clients persistent clients in threads, each cycling through the
    documents; returns the mismatches and errors."""
    import threading
    errors = []

    def client(tid):
        try:
            with SS.QueryStreamClient(*addr, timeout=600) as cli:
                for k in range(per_client):
                    i = (tid + k) % len(docs)
                    if cli.query(docs[i]) != want[i]:
                        errors.append(f"client {tid}: query {k} (doc {i}) "
                                      "differs")
        except Exception as e:          # reported by the caller
            errors.append(f"client {tid}: {e!r}")

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if any(t.is_alive() for t in threads):
        errors.append("a client thread did not finish")
    return errors, time.perf_counter() - t0


def _device_peak(torch, argv):
    """(text, bytes, s): a query's device-memory high-water mark above
    what was allocated before it."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    text = _query(argv)
    torch.cuda.synchronize()
    return text, torch.cuda.max_memory_allocated() - base, \
        time.perf_counter() - t0


def phase_serving(torch, np, c, card, main_text):
    """The interval-serving path on the card: the port's
    QueryStreamServer in this process on cuda:0, seeded 10 kb intervals
    in three lanes (engine, served from the index, one-shot), four
    concurrent clients, the CPU device, the paged stream and the
    out-of-core windows; holds the engine lane's most frequent launch
    against the twin in every form."""
    from genomicsdb_tpu_torch.ops import fused_combine as FC
    from genomicsdb_tpu_torch.ops.combine_step import to_tensor
    from genomicsdb_tpu_torch.query import driver as D
    from genomicsdb_tpu_torch.query import serving_index as si
    from genomicsdb_tpu_torch.query import stream_server as SS
    from genomicsdb_tpu_torch.store import workspace as ws
    from genomicsdb_tpu_torch.store.fragment_v2 import read_manifest
    rng = np.random.default_rng(4)
    span = c.region - SERVING_BP
    warm_los = [int(x) for x in rng.integers(0, span, 2)]
    los = [int(x) for x in rng.integers(0, span, SERVING_QUERIES)]

    def doc(lo):
        return {"workspace": c.workspace, "array_name": c.array,
                "vid_mapping_file": c.vid,
                "callset_mapping_file": c.callsets, "attributes": [],
                "query_column_ranges": [{"range_list": [
                    {"low": lo, "high": lo + SERVING_BP - 1}]}]}

    docs = [doc(lo) for lo in los]
    srv = SS.QueryStreamServer(port=0, device="cuda:0")
    srv.start_background()
    addr = srv.address
    seen, build = [], {}
    try:
        # lane 1, the engine (index off): two warm-up queries, the first
        # of which builds the store layout and uploads its slabs
        _set_serving_index(False)
        with SS.QueryStreamClient(*addr, timeout=600) as cli:
            h2d = []
            for lo in warm_los:
                to_tensor.h2d_bytes = 0
                t0 = time.perf_counter()
                cli.query(doc(lo))
                h2d.append((to_tensor.h2d_bytes, time.perf_counter() - t0))
            launch = FC._launch

            def recorder(*args, **kw):
                seen.append((args, kw))
                return launch(*args, **kw)

            FC._launch = recorder
            try:
                for obj, name in _counters():
                    setattr(obj, name, 0)
                lat_e, out_e = _timed_lane(torch, cli.query, docs)
                c_eng = {name: getattr(obj, name)
                         for obj, name in _counters()}
            finally:
                FC._launch = launch
        print(f"serving: {SERVING_QUERIES} seeded {SERVING_BP}-bp "
              f"intervals over columns 0..{c.region} of the "
              f"{E2E_SAMPLES}-sample cohort, socket server on cuda:0 "
              f"[{card}]")
        print(f"serving warm-up, engine lane: first query {h2d[0][0]} "
              f"bytes host-to-device in {h2d[0][1]:.3f} s (store layout, "
              f"device slabs, int16 range check), second {h2d[1][0]} bytes "
              f"in {h2d[1][1]:.3f} s")
        print(f"serving engine lane counts: {c_eng}")
        if not (c_eng["narrow_launches"] == c_eng["launches"]
                == c_eng["blocks"] >= SERVING_QUERIES
                and c_eng["general_path_blocks"] == 0
                and c_eng["wide_blocks_when_packing"] == 0):
            raise AssertionError("serving engine lane: expected one narrow "
                                 f"kernel launch per block: {c_eng}")

        # lane 2, served from the index: the second warm-up query builds
        # it (timed on its own, BCF2 encoding apart)
        orig_build, orig_enc = si.build_index, si.ServingIndex.ensure_bcf

        def timed_build(*a, **kw):
            t0 = time.perf_counter()
            idx = orig_build(*a, **kw)
            build["build_s"] = time.perf_counter() - t0
            if idx is not None:
                build["records"] = len(idx.starts)
                build["text_bytes"] = len(idx.text_blob)
            return idx

        def timed_enc(self, *a, **kw):
            t0 = time.perf_counter()
            fresh = self.bcf_blob is None
            ok = orig_enc(self, *a, **kw)
            if fresh:
                build["encode_s"] = time.perf_counter() - t0
                build["bcf_bytes"] = len(self.bcf_blob)
            return ok

        _set_serving_index(True)
        si.build_index, si.ServingIndex.ensure_bcf = timed_build, timed_enc
        try:
            with SS.QueryStreamClient(*addr, timeout=600) as cli:
                for lo in warm_los:
                    cli.query(doc(lo))
                for obj, name in _counters():
                    setattr(obj, name, 0)
                lat_s, out_s = _timed_lane(torch, cli.query, docs)
                c_srv = {name: getattr(obj, name)
                         for obj, name in _counters()}
        finally:
            si.build_index, si.ServingIndex.ensure_bcf = orig_build, \
                orig_enc
        if "records" not in build:
            raise AssertionError("serving: the index was never built")
        print(f"serving index build: {build['build_s']:.3f} s for "
              f"{build['records']} records ({build['text_bytes']} text "
              f"bytes), BCF2 encoding {build['encode_s']:.3f} s "
              f"({build['bcf_bytes']} bytes) [{card}]")
        if c_srv["launches"] or c_srv["blocks"]:
            raise AssertionError("serving: the served lane reached the "
                                 f"device combine: {c_srv}")

        # lane 3, one-shot connections
        SS.read_query_stream(*addr, doc(warm_los[0]), timeout=600)
        lat_o, out_o = _timed_lane(
            torch, lambda d: SS.read_query_stream(*addr, d, timeout=600),
            docs)
        if not (out_e == out_s == out_o):
            raise AssertionError("serving: the engine, served and one-shot "
                                 "lanes differ")
        mean_bytes = sum(len(x) for x in out_e) / len(out_e)
        for label, lats in (("engine (persistent, index off)", lat_e),
                            ("served (persistent, index on)", lat_s),
                            ("one-shot (index on)", lat_o)):
            print(f"serving lane {label}: p50 {_pct_ms(lats, 0.5):.3f} ms, "
                  f"p90 {_pct_ms(lats, 0.9):.3f} ms, min "
                  f"{1e3 * lats[0]:.3f} ms, max {1e3 * lats[-1]:.3f} ms "
                  f"[{card}]")
        print(f"serving: mean response {mean_bytes:.1f} bytes; every lane "
              "byte-identical")

        # no stale device state after the index build: the engine again
        _set_serving_index(False)
        with SS.QueryStreamClient(*addr, timeout=600) as cli:
            again = [cli.query(d) for d in docs[:3]]
        if again != out_e[:3]:
            raise AssertionError("serving: the engine after the index "
                                 "build differs")
        cpu = SS.QueryStreamServer(port=0, device="cpu")
        cpu.start_background()
        try:
            on_cpu = [SS.read_query_stream(*cpu.address, d, timeout=900)
                      for d in docs[:3]]
        finally:
            cpu.shutdown()
        if on_cpu != out_e[:3]:
            raise AssertionError("serving: the cuda engine lane differs "
                                 "from a cpu-device server")
        print("serving: engine lane == cpu-device server over 3 intervals; "
              "engine after the build == before")

        # four concurrent persistent clients: the engine on a fresh
        # server (its layout, slabs and range check built under them),
        # then the index on the first server
        fresh = SS.QueryStreamServer(port=0, device="cuda:0")
        fresh.start_background()
        try:
            errs, dt = _concurrent(SS, fresh.address, docs, out_e)
        finally:
            fresh.shutdown()
        _set_serving_index(True)
        errs2, dt2 = _concurrent(SS, addr, docs, out_e)
        if errs or errs2:
            raise AssertionError("serving, concurrent clients: "
                                 + "; ".join(errs + errs2))
        print(f"serving: 4 concurrent persistent clients x 6 queries each "
              f"== single-client bytes: engine on a cold server {dt:.3f} s, "
              f"served {dt2:.3f} s [{card}]")
    finally:
        _set_serving_index(True)
        srv.shutdown()
    del srv

    # the serving lane's kernel launches, as the main path's
    shapes = {}
    for args, kw in seen:
        live = args[12]
        real = int((live >= 0).any(dim=1).sum())
        shapes.setdefault(_launch_key(args, kw), []).append(
            (real, _launch_bytes(torch, args, kw)[0], args, kw))
    print(f"serving engine lane: {len(seen)} kernel launches [{card}]")
    for key, v in sorted(shapes.items(), key=lambda kv: -len(kv[1])):
        (bs, C, G_in, A_in, M, p, gt_w, F, Fi, Fs, form) = key
        reals = [x[0] for x in v]
        print(f"  {len(v)} x B={bs[0]} (padded; real records "
              f"{min(reals)}..{max(reals)}, mean "
              f"{sum(reals) / len(reals):.1f}) S={bs[1]} C={C} "
              f"G_in={G_in} A_in={A_in} M={M} ploidy={p} gt_w={gt_w} "
              f"F={F} Fi={Fi} Fs={Fs} {form}: bytes "
              f"{min(x[1] for x in v)}..{max(x[1] for x in v)}")
    key, v = max(shapes.items(), key=lambda kv: len(kv[1]))
    _, _, args, kw = v[0]
    base = {k: kw[k] for k in ("max_merged", "ploidy", "gt_phase",
                               "mixed")}
    B, S = args[12].shape
    _forms_vs_twin(torch, f"serving launch B={B} S={S} "
                   f"C={args[0].shape[1]}", args, base, reps_k=50, reps_t=3)
    del seen, shapes, args, v

    # the paged stream and the out-of-core windows through gdb_query
    paged = _query(["-j", c.query, "--produce-Broad-GVCF", "--device",
                    "cuda", "-p", "65536"])
    if paged != main_text:
        raise AssertionError("gdb_query -p 65536 differs from the "
                             "one-shot text")
    frags = ws._fragment_paths(c.workspace, c.array)
    seg = read_manifest(frags[0])["total_bytes"] // 4
    base_argv = ["-j", c.query, "--produce-Broad-GVCF", "--device", "cuda"]
    in_ram, peak_ram, t_ram = _device_peak(torch, base_argv)
    D.iter_vcf_query_block.ooc_windows = 0
    ooc, peak_ooc, t_ooc = _device_peak(
        torch, base_argv + ["--ooc", "-s", str(seg)])
    windows = D.iter_vcf_query_block.ooc_windows
    print(f"gdb_query -p 65536 on cuda == the one-shot text; --ooc -s {seg}: "
          f"{windows} windows in {t_ooc:.3f} s, device memory high-water "
          f"{peak_ooc} bytes against {peak_ram} bytes in RAM "
          f"({t_ram:.3f} s) [{card}]")
    if not (ooc == in_ram == main_text and windows > 1):
        raise AssertionError(f"--ooc: {windows} windows, text equal: "
                             f"{ooc == main_text}")
    if not peak_ooc < peak_ram:
        raise AssertionError("--ooc: the out-of-core device-memory mark "
                             "is not below the in-RAM query's")

GATHER_ROUND = r"""
import os, sys
sys.modules["jax"] = None
sys.modules["genomicsdb_tpu"] = None
sys.path.insert(0, sys.argv[1])
import numpy as np
from genomicsdb_tpu_torch.parallel import multihost
pid = int(sys.argv[2])
multihost.GATHER_CHUNK = 1 << 20
multihost.initialize("localhost:" + sys.argv[3], 2, pid)
blob = bytes(np.random.default_rng(pid).integers(0, 256, pid * 3 << 20,
                                                 dtype=np.uint8))
got = multihost.gather_blobs_to_root(blob)
if pid == 0:
    want = [bytes(np.random.default_rng(i).integers(0, 256, i * 3 << 20,
                                                    dtype=np.uint8))
            for i in range(2)]
    assert got == want, [len(g) for g in got]
    print("GATHER_OK", [len(g) for g in got])
else:
    assert got is None
"""


def _gather_round():
    """Two processes on this host run one gather_blobs_to_root round;
    returns (seconds, rank 0's stdout)."""
    from genomicsdb_tpu_torch.tools.gdb_query import free_port
    port = str(free_port())
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", GATHER_ROUND, ROOT,
                               str(i), port], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"gather round, process {i}: {err[-2000:]}")
    return time.perf_counter() - t0, outs[0][0]


def _four_partitions(np, c):
    """The cohort's store cut into 4 column partitions (written as
    arrays p0..p3 of a new workspace) and a loader and query over them."""
    from genomicsdb_tpu_torch.parallel.repartition import repartition
    from genomicsdb_tpu_torch.store import workspace as ws
    begins = [int(x) for x in np.linspace(0, c.region, 5)[:-1]]
    ws4 = os.path.join(c.dir, "ws4")
    ws.create_workspace(ws4)
    parts = repartition([ws.open_array(c.workspace, c.array)], begins)
    for i, part in enumerate(parts):
        ws.write_fragment(ws4, f"p{i}", part)
    loader = os.path.join(c.dir, "loader4.json")
    with open(loader, "w") as f:
        json.dump({"column_partitions": [
            {"begin": b, "workspace": ws4, "array_name": f"p{i}"}
            for i, b in enumerate(begins)],
            "callset_mapping_file": c.callsets, "vid_mapping_file": c.vid,
            "treat_deletions_as_intervals": True}, f)
    query = os.path.join(c.dir, "query4.json")
    with open(query, "w") as f:
        json.dump({"workspace": "", "array_name": "",
                   "query_column_ranges": [{"range_list": [
                       {"low": 0, "high": c.region}]}],
                   "vid_mapping_file": c.vid,
                   "callset_mapping_file": c.callsets, "attributes": []}, f)
    return loader, query


def phase_distribution(torch, np, c, card, main_text, largest):
    """The mesh (1x1 on NCCL, 2x2 on gloo sharing the card), the largest
    2x2 shard launch against the twin, --parallel-ranks against
    --num-ranks on 4 partitions, and a 2-process blob gather.  Returns
    the kernel launches of the mesh ranks."""
    from genomicsdb_tpu_torch.ops.combine_step import to_tensor
    from genomicsdb_tpu_torch.parallel import comm
    from genomicsdb_tpu_torch.parallel import sharded as TS
    from genomicsdb_tpu_torch.tools import gdb_query
    print(f"distribution: collectives by {comm.ALL_GATHER} (all-gather) "
          f"and torch.distributed.gather; torch {torch.__version__}")
    base = ["-j", c.query, "--produce-Broad-GVCF", "--device", "cuda"]
    # every query of this phase runs the engine (the mesh never consults
    # the serving index; the unsharded query would be served from it)
    _set_serving_index(False)
    t0 = time.perf_counter()
    unsharded = _query(base)
    torch.cuda.synchronize()
    t_unsharded = time.perf_counter() - t0
    if unsharded != main_text:
        raise AssertionError("the unsharded query differs from phase 3's")
    launches = 0
    walls = {}
    for shape in ("1x1", "2x2"):
        n_pos, n_row = (int(x) for x in shape.split("x"))
        world = n_pos * n_row
        want = "nccl" if world <= torch.cuda.device_count() else "gloo"
        t0 = time.perf_counter()
        text = _query(base + ["--mesh", shape])
        walls[shape] = time.perf_counter() - t0
        reports = gdb_query.spawn_mesh.rank_reports
        for r in reports:
            print(f"  mesh {shape} rank {r['rank']} (pos {r['pos']}, row "
                  f"{r['row']}) on {r['device']} [{r['backend']}]: "
                  f"{r['blocks']} blocks, {r['launches']} kernel launches, "
                  f"{r['general_path_blocks']} general-path blocks, "
                  f"{r['all_gathers']} row gathers of "
                  f"{r['all_gather_bytes']} bytes; joined the mesh in "
                  f"{r['mesh_s']:.3f} s, query {r['query_s']:.3f} s")
        if text != main_text:
            raise AssertionError(f"--mesh {shape} differs from the "
                                 "unsharded text")
        if [r["rank"] for r in reports] != list(range(world)) or not all(
                r["backend"] == want and r["launches"] == r["blocks"] > 0
                and r["general_path_blocks"] == 0 for r in reports):
            raise AssertionError(f"--mesh {shape}: expected one {want} "
                                 "rank per position, each launching the "
                                 f"kernel once per block: {reports}")
        launches += sum(r["launches"] for r in reports)
    print(f"mesh query walls: unsharded {t_unsharded:.3f} s, --mesh 1x1 "
          f"(nccl) {walls['1x1']:.3f} s, --mesh 2x2 (gloo, 4 ranks on "
          f"cuda:0) {walls['2x2']:.3f} s; texts byte-identical [{card}]")

    # the largest 2x2 shard launch: the first rank's shard of the main
    # path's largest block
    args, kw = largest
    live = args[12]
    B, S = live.shape
    gtl = args[17] if args[17] is not None else torch.full_like(
        live, args[4].shape[2])
    tensors = (*args[:12], args[13], args[14], args[15], args[16], live,
               torch.zeros_like(live, dtype=torch.bool), gtl)
    local = TS.shard_tensors(TS.Mesh(2, 2, 0, 0, live.device), tensors, B, S)
    shard = (*local[:12], local[16], local[12], local[13], local[14],
             local[15], local[18] if kw["mixed"] else None)
    b_loc, s_loc = local[16].shape
    _forms_vs_twin(torch, f"2x2 shard launch B={b_loc} S={s_loc} "
                   f"C={args[0].shape[1]}", shard, kw, reps_k=50, reps_t=3,
                   forms={"wide": FORMS["wide"]})

    loader, query = _four_partitions(np, c)
    part = ["-j", query, "-l", loader, "--produce-Broad-GVCF", "--device",
            "cuda", "--num-ranks", "4"]
    to_tensor.h2d_bytes = 0
    t0 = time.perf_counter()
    spawned = _query(part + ["--parallel-ranks"])
    t_spawned = time.perf_counter() - t0
    t0 = time.perf_counter()
    in_process = _query(part)
    torch.cuda.synchronize()
    t_in = time.perf_counter() - t0
    if spawned != in_process or spawned.count("\n") < E2E_RECORDS:
        raise AssertionError(f"--parallel-ranks ({spawned.count(chr(10))} "
                             "lines) differs from --num-ranks 4 "
                             f"({in_process.count(chr(10))} lines)")
    print(f"4 partitions: --parallel-ranks (4 rank processes on cuda:0) "
          f"{t_spawned:.3f} s, in-process --num-ranks 4 {t_in:.3f} s; texts "
          f"byte-identical, {spawned.count(chr(10))} lines [{card}]")
    t_gather, out = _gather_round()
    if "GATHER_OK" not in out:
        raise AssertionError(f"gather round: {out}")
    print(f"multihost gather_blobs_to_root, 2 processes (lengths 0 and "
          f"3 MiB, 1 MiB rounds): {t_gather:.3f} s with start-up; "
          f"{out.strip()}")
    _set_serving_index(True)
    return launches


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


def _counted(torch, fn):
    """(fn(), its wide kernel launches, its narrow ones), every count set
    to 0 just before the call and read just after."""
    from genomicsdb_tpu_torch.ops import fused_combine as FC
    for obj, name in _counters():
        setattr(obj, name, 0)
    res = fn()
    torch.cuda.synchronize()
    n, nn = FC.fused_gather_remap.launches, \
        FC.fused_gather_remap.narrow_launches
    return res, n - nn, nn


def _stdout(fn) -> str:
    """What fn() prints."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue()


def _printed_json(fn) -> str:
    """The JSON line a tool's main prints."""
    return _stdout(fn).strip().splitlines()[-1]


def _fused_lane_split(torch, TB, dev, shape, card):
    """The fused lane's pass split into the kernel and the rest: per
    form, the kernel's time summed over the pass's chunks (each chunk's
    launch timed alone, `_kernel_ms`) against one pass of the lane's
    chunk loop (`bench._fused_run`: the wrapper, `_fused_post`'s
    reductions and the checksum), both CUDA events.  Not counted."""
    from genomicsdb_tpu_torch.ops import fused_combine as FC
    from genomicsdb_tpu_torch.ops.cell_block import synthesize_cohort
    blk = synthesize_cohort(*shape, seed=0)
    slabs, (live, inv, nr, recnm, recnr) = TB._cohort_tensors(blk, dev)
    live = live.to(torch.int32)
    chunks = TB._chunks(live.shape[0], TB.CHUNK)
    parts = []
    for narrow in (False, True):
        kw = dict(max_merged=4, ploidy=2, gt_phase=False, mixed=False,
                  narrow=narrow,
                  narrow_scalars=narrow and FC._narrow_scalars_ok(blk))
        kern = sum(_kernel_ms(torch, (*slabs, live[lo:hi], inv[lo:hi],
                                      nr[lo:hi], recnm[lo:hi],
                                      recnr[lo:hi], None), kw, 5)
                   for lo, hi in chunks)
        whole = _time_ms(torch, TB._fused_run(dev, blk, TB.CHUNK, narrow),
                         3)
        parts.append(f"{'narrow' if narrow else 'wide'} kernel "
                     f"{kern:.4f} ms of a {whole:.4f} ms pass "
                     f"({100 * kern / whole:.1f}%)")
    print(f"fused lane {'x'.join(map(str, shape))}, {len(chunks)} chunks "
          f"of {TB.CHUNK} records: " + "; ".join(parts) + f" [{card}]")


def phase_remaining(torch, np, card):
    """The bench lanes in this process at the JAX bench's shapes (with
    the fused lanes' kernel share), the remap_rows restriction, the
    three bench tools and the graft entry, all on cuda:0.  Returns the
    (wide, narrow) kernel launches of the lanes and in-process tools."""
    from genomicsdb_tpu_torch import bench as TB
    from genomicsdb_tpu_torch import graft_entry as GE
    from genomicsdb_tpu_torch.ops import combine_step as TC
    from genomicsdb_tpu_torch.ops import fused_combine as FC
    from genomicsdb_tpu_torch.ops.cell_block import synthesize_cohort
    from genomicsdb_tpu_torch.tools import deletion_bench, wide_cohort_bench
    from genomicsdb_tpu_torch.tools.gdb_query import child_env
    dev = torch.device("cuda:0")
    wide = narrow = 0
    lanes = {}
    for name, fn in (
            ("device", lambda: TB.bench_device(dev)),
            ("device_fused", lambda: TB.bench_device_fused(dev)),
            ("device_fused_wide_1024_samples",
             lambda: TB.bench_device_fused_wide_1024(dev)),
            ("device_dense", lambda: TB.bench_device_dense(dev)),
            ("cpp_sequential_baseline", TB.bench_cpp_baseline),
            ("cohort100_end_to_end",
             lambda: TB.bench_cohort_end_to_end(dev)),
            ("import", TB.bench_import)):
        t0 = time.perf_counter()
        lanes[name], w, nn = _counted(torch, fn)
        wide, narrow = wide + w, narrow + nn
        print(f"bench lane {name} [{card}]: {time.perf_counter() - t0:.1f} "
              f"s in all, {w} wide and {nn} narrow kernel launches; "
              f"{json.dumps(lanes[name])}")
    # the fused lanes raise unless narrow == wide; all the device lanes
    # over the whole block must agree, and the dense lane's chunk with
    # the general step on the same chunk
    if lanes["device"]["checksum"] != lanes["device_fused"]["checksum"]:
        raise AssertionError("bench lanes: general and kernel checksums "
                             "differ")
    blk = synthesize_cohort(128, 2048, 262144, seed=0)
    t = TC.block_to_tensors(blk, dev)
    n = TB.CHUNK
    out = TC.combine_step(*t[:12], *(x[:n] for x in t[12:17]),
                          max_merged=4, ploidy=2)
    chk = TB._wrap32(TB.checksum(out).item())
    if chk != lanes["device_dense"]["checksum"]:
        raise AssertionError(f"device_dense checksum "
                             f"{lanes['device_dense']['checksum']} != the "
                             f"general step's {chk} on the same chunk")
    print(f"bench lanes: narrow == wide checksums at both shapes; "
          f"device_dense == combine_step on the first {n} records ({chk})")
    del t, out, blk
    for shape in ((128, 2048, 262144), (1024, 256, 32768)):
        _fused_lane_split(torch, TB, dev, shape, card)

    # one general-path block (17 merged alleles), restricted and not
    gblk = _synthetic_block(np, "general m17", 256, 256, 16384, 17, 2,
                            False, keep_b=1024)
    if FC.kernel_takes(gblk, 17, 2, False):
        raise AssertionError("the 17-allele block passed the kernel's gates")
    B = gblk.live.shape[0]
    # every third record, padded with row 0 to a power-of-two bucket
    var = np.arange(0, B, 3)
    rows = np.zeros(1 << max(4, (len(var) - 1).bit_length()), np.int32)
    rows[:len(var)] = var
    t = TC.block_to_tensors(gblk, dev)
    full = TC.combine_step(*t, max_merged=17, ploidy=2)
    restricted = TC.combine_step(*t, remap_rows=rows, max_merged=17,
                                 ploidy=2)
    idx = torch.as_tensor(rows, device=dev).long()
    part = ("pl", "ad", "gt", "gq", "dp_format", "min_dp")
    err = _check_against_twin(
        torch, "remap_rows", restricted,
        {k: v[idx] if k in part else v for k, v in full.items()})
    print(f"combine_step remap_rows on cuda: B={B} S={gblk.live.shape[1]} "
          f"m 17, {len(rows)} restricted rows == the unrestricted step's, "
          f"bit for bit (max abs err {err})")
    del t, full, restricted

    # the three bench tools, at cut sizes (records, not samples) to keep
    # the call inside its time limit
    tools = {
        "deletion_bench": lambda: deletion_bench.main(
            ["--samples", "100", "--records", "500", "--device", "cuda"]),
        "wide_cohort_bench": lambda: wide_cohort_bench.main(
            ["--samples", "1000", "--records", "1000", "--windows", "2",
             "--device", "cuda"]),
    }
    for name, fn in tools.items():
        t0 = time.perf_counter()
        line, w, nn = _counted(torch, lambda: _printed_json(fn))
        wide, narrow = wide + w, narrow + nn
        print(f"{name} [{card}]: {time.perf_counter() - t0:.1f} s, {w} wide "
              f"and {nn} narrow kernel launches; {line}")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m",
                        "genomicsdb_tpu_torch.tools.ooc_bench",
                        "--target-bytes", "1e8", "--device", "cuda"],
                       capture_output=True, text=True, timeout=600,
                       env=child_env())
    if r.returncode != 0:
        raise AssertionError(f"ooc_bench: {r.stderr[-3000:]}")
    ooc = json.loads(r.stdout.strip().splitlines()[-1])
    if ooc["windows"] <= 1:
        raise AssertionError(f"ooc_bench: {ooc['windows']} window(s)")
    print(f"ooc_bench (own process) [{card}]: {time.perf_counter() - t0:.1f} "
          f"s; {json.dumps(ooc)}")

    # the graft entry: one step on cuda == on cpu; the 4-rank dryrun
    fn, args = GE.entry()
    got = fn(*args)
    fn_c, args_c = GE.entry("cpu")
    want = fn_c(*args_c)
    err = _check_against_twin(torch, "graft entry", got,
                              {k: v.to(dev) for k, v in want.items()})
    t0 = time.perf_counter()
    rep = GE.dryrun_multichip(4)
    print(f"graft entry: fn(*args) on cuda == on cpu (max abs err {err}); "
          f"dryrun_multichip(4): mesh {rep['mesh']} on {rep['device']} "
          f"[{rep['backend']}], text == the sequential engine's "
          f"({rep['text'].count(chr(10))} records), "
          f"{time.perf_counter() - t0:.1f} s with start-up [{card}]")
    return wide, narrow


def _store_files(workspace):
    """{path under the workspace, the fragment directory's time-stamped
    name masked: bytes} (the masking of tests/test_torch_standalone.py)."""
    import re
    out = {}
    for d, _, files in os.walk(workspace):
        for f in files:
            path = os.path.join(d, f)
            rel = re.sub(r"fragment_\d+", "fragment_<time_ns>",
                         os.path.relpath(path, workspace))
            with open(path, "rb") as fh:
                out[rel] = fh.read()
    return out


def _stream_import(vid, vcfs):
    """Each file's BCF2 encoding pushed through the port's
    StreamingImporter in STREAM_WRITE-byte writes, import_batch() after
    every write.  Returns (the finalized store, encode s, stream s,
    finalize s)."""
    from genomicsdb_tpu_torch.store.streaming_import import \
        StreamingImporter
    from genomicsdb_tpu_torch.vcf.bcf import text_to_bcf
    t0 = time.perf_counter()
    streams = {}
    for path in vcfs:
        with open(path) as f:
            streams[path] = text_to_bcf(f.read())
    t_encode = time.perf_counter() - t0
    imp = StreamingImporter(vid)
    for name in streams:
        imp.add_buffer_stream(name)
    t0 = time.perf_counter()
    for name, data in streams.items():
        for off in range(0, len(data), STREAM_WRITE):
            imp.write(name, data[off:off + STREAM_WRITE])
            imp.import_batch()
    if not imp.import_batch():
        raise AssertionError("the streaming importer is not idle after "
                             "every stream was consumed")
    t_stream = time.perf_counter() - t0
    t0 = time.perf_counter()
    store = imp.finalize()
    return store, t_encode, t_stream, time.perf_counter() - t0


def phase_streaming_and_demos(torch, card):
    """Phase 8.  Returns the narrow kernel launches of its counted runs
    (the streamed store's query and the two in-process demos) and the
    wide ones of the sharded demo's ranks."""
    from genomicsdb_tpu_torch.core.config import QueryParams
    from genomicsdb_tpu_torch.core.vid import VidMapper
    from genomicsdb_tpu_torch.examples import (block_engine_demo,
                                               query_stream_demo,
                                               sharded_combine_demo)
    from genomicsdb_tpu_torch.ops import fused_combine as FC
    from genomicsdb_tpu_torch.query import driver
    from genomicsdb_tpu_torch.store import workspace as ws
    from genomicsdb_tpu_torch.testing import write_cohort
    from genomicsdb_tpu_torch.tools import gdb_query, vcf2gdb
    _set_serving_index(False)
    work = tempfile.mkdtemp(prefix="chip_smoke_stream_",
                            dir=os.path.join(ROOT, "build"))
    c = write_cohort(work, STREAM_SAMPLES, STREAM_RECORDS, seed=1)
    vcf2gdb.main([c.loader])
    vid = VidMapper.from_files(c.vid, c.callsets)
    store, t_encode, t_stream, t_final = _stream_import(vid, c.vcfs)
    cells = store.num_cells
    print(f"streaming import: {STREAM_SAMPLES} samples x {STREAM_RECORDS} "
          f"records per file, {len(c.vcfs)} BCF2 streams ({t_encode:.2f} s "
          f"to encode) in {STREAM_WRITE}-byte writes: {cells} cells "
          f"streamed in {t_stream:.2f} s ({cells / t_stream:.1f} cells/s), "
          f"finalize {t_final:.2f} s")
    ws2 = os.path.join(work, "ws_streamed")
    ws.create_workspace(ws2)
    ws.write_fragment(ws2, c.array, store)
    want, got = _store_files(c.workspace), _store_files(ws2)
    if sorted(want) != sorted(got) or any(want[k] != got[k] for k in want):
        raise AssertionError("the streamed store differs from vcf2gdb's")
    print(f"streamed store == vcf2gdb's store: {len(want)} files, byte "
          "for byte (fragment name masked)")

    qp = QueryParams.from_file(c.query, 0)
    qc = driver.make_query_config(qp, vid)
    dev = torch.device("cuda:0")
    seen = []
    launch = FC._launch

    def recorder(*args, **kw):
        seen.append((_launch_key(args, kw), _launch_bytes(torch, args,
                                                          kw)[0]))
        return launch(*args, **kw)

    for obj, name in _counters():
        setattr(obj, name, 0)
    FC._launch = recorder
    t0 = time.perf_counter()
    try:
        text = driver.run_vcf_query_block(store, qc, qp, vid, dev)
        torch.cuda.synchronize()
    finally:
        FC._launch = launch
    t_query = time.perf_counter() - t0
    counts = {name: getattr(obj, name) for obj, name in _counters()}
    stored = _query(["-j", c.query, "--produce-Broad-GVCF", "--device",
                     "cuda"])
    t0 = time.perf_counter()
    on_cpu = driver.run_vcf_query_block(store, qc, qp, vid,
                                          torch.device("cpu"))
    t_cpu = time.perf_counter() - t0
    records = text.count("\n")
    print(f"streamed store's block query on cuda:0 (pack on): {records} "
          f"records in {t_query:.3f} s; --device cpu {t_cpu:.3f} s "
          f"[{card}]; {counts}")
    for (bs, C, G_in, A_in, M, p, gt_w, F, Fi, Fs, form), nbytes in seen:
        print(f"  launch B={bs[0]} S={bs[1]} C={C} G_in={G_in} A_in={A_in} "
              f"M={M} ploidy={p} gt_w={gt_w} F={F} Fi={Fi} Fs={Fs} {form}: "
              f"{nbytes} bytes, bound {_bound_ms(nbytes):.4f} ms")
    if records == 0 or not (text == stored == on_cpu):
        raise AssertionError("the streamed store's cuda text, the vcf2gdb "
                             "store's and --device cpu differ")
    if not (counts["narrow_launches"] == counts["launches"]
            == counts["blocks"] == len(seen) > 0
            and counts["general_path_blocks"] == 0
            and counts["wide_blocks_when_packing"] == 0):
        raise AssertionError(f"streamed store: expected one narrow kernel "
                             f"launch per block: {counts}")
    narrow = counts["narrow_launches"]
    qp_head = QueryParams.from_file(c.query_head, 0)
    qc_head = driver.make_query_config(qp_head, vid)
    blk_head = driver.run_vcf_query_block(store, qc_head, qp_head, vid, dev)
    seq_head = driver.run_vcf_query(store, qc_head, qp_head, vid)
    if blk_head != seq_head or not seq_head:
        raise AssertionError("streamed store: block engine differs from "
                             "the sequential engine over the head interval")
    print(f"streamed store: cuda text == vcf2gdb store's on cuda == --device "
          f"cpu, byte for byte; block == sequential over columns "
          f"{c.head_interval} ({seq_head.count(chr(10))} records)")

    # the demos on cuda:0: two in this process, the sharded one as its
    # 8 rank processes sharing the card (gloo)
    for mod, needle in ((block_engine_demo, "block engine"),
                        (query_stream_demo, "interval 1:12000-13000")):
        name = mod.__name__.rsplit(".", 1)[1]
        t0 = time.perf_counter()
        out, w, nn = _counted(torch, lambda: _stdout(
            lambda: mod.main(["--device", "cuda"])))
        if needle not in out or w or not nn:
            raise AssertionError(f"{name}: {w} wide / {nn} narrow launches, "
                                 f"output:\n{out}")
        narrow += nn
        print(f"{name} on cuda:0: {time.perf_counter() - t0:.1f} s, {nn} "
              f"narrow kernel launches; " + out.strip().replace("\n", " | "))
    t0 = time.perf_counter()
    out = _stdout(lambda: sharded_combine_demo.main(["--device", "cuda"]))
    reports = gdb_query.spawn_mesh.rank_reports
    world = sharded_combine_demo.N_POS * sharded_combine_demo.N_ROW
    if "mesh=(4 pos x 2 row) on cuda:0 [gloo]" not in out or \
            [r["rank"] for r in reports] != list(range(world)) or not all(
                r["launches"] == r["blocks"] > 0 for r in reports):
        raise AssertionError(f"sharded demo: {out}\n{reports}")
    blk = sharded_combine_demo.demo_block()
    from genomicsdb_tpu_torch.ops.combine_step import (block_to_tensors,
                                                       combine_step)
    ref = combine_step(*block_to_tensors(blk, dev), max_merged=4, ploidy=2)
    want = sharded_combine_demo.digest(
        {k: v.cpu().numpy() for k, v in ref.items()})
    if f"outputs sha256 {want}" not in out:
        raise AssertionError("sharded demo: the gathered block differs from "
                             "the unsharded combine_step on cuda:0")
    mesh_wide = sum(r["launches"] for r in reports)
    print(f"sharded_combine_demo: {world} rank processes on cuda:0, "
          f"{time.perf_counter() - t0:.1f} s with start-up, {mesh_wide} wide "
          f"kernel launches; gathered block == unsharded combine_step; "
          + out.strip().replace("\n", " | "))
    _set_serving_index(True)
    return narrow, mesh_wide


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
    # the port stands alone: block jax and the JAX package, so that no
    # module on any path can load either
    sys.modules["jax"] = None
    sys.modules["genomicsdb_tpu"] = None
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch.cuda is not available: this smoke run needs a CUDA "
              "card", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    walls = []
    t0 = time.perf_counter()

    def lap(phase):
        nonlocal t0
        walls.append(f"{phase} {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()

    card = phase_environment(torch)
    lap("1")
    phase_kernel_vs_twin(torch, np, dev)
    lap("2")
    c_on, c_off, cohort, main_text = phase_end_to_end(torch, card)
    lap("3")
    main, largest = phase_main_path(torch, cohort, card)
    lap("4")
    phase_serving(torch, np, cohort, card, main_text)
    lap("5")
    mesh_launches = phase_distribution(torch, np, cohort, card, main_text,
                                       largest)
    lap("6")
    lane_wide, lane_narrow = phase_remaining(torch, np, card)
    lap("7")
    stream_narrow, demo_wide = phase_streaming_and_demos(torch, card)
    lap("8")
    if args.profile:
        phase_profile(torch, cohort, card, os.path.abspath(args.profile))
    print("phase walls: " + ", ".join(walls))

    def entry(name, replaces, form, launches):
        # times and bound at the main path's largest launch
        err, ms, plain_ms, nbytes = main[form]
        return {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": _bound_ms(nbytes), "bound_by": "bytes",
                "library_ms": None}

    print(json.dumps({"kernels": [
        entry("fused_gather_remap (wide)", f"{PALLAS}:875", "wide",
              c_off["launches"] + mesh_launches + lane_wide + demo_wide),
        entry("fused_gather_remap (narrow int16 outputs)",
              f"{PALLAS}:1070", "narrow+scalars",
              c_on["narrow_launches"] + lane_narrow + stream_narrow),
        entry("fused_gather_remap (wide, non-mixed: the per-sample "
              "_make_kernel function)", f"{PALLAS}:264", "wide",
              c_off["launches"] + mesh_launches + lane_wide + demo_wide),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
