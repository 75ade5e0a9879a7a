"""The benchmark of genomicsdb_tpu_torch: one run of one cell.

    python3 -m gdb_bench.run --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

Set-up makes the cell's cohort from the seed, imports it with the
program's `vcf2gdb`, and warms up the cell's traffic; the window then
drives the traffic for `--seconds`; after it the answers are judged
against the plain reference.  The last line of standard output is one
JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer metrics),
`device`, with `--trace 1` `breakdown`, and last `checks`, each number
compared beside its limit (also the last lines of standard error).

It runs on a CUDA card only: without one, or with fewer than the cell
asks for, it exits 2 and prints no result.  A run after which `jax`,
`jaxlib`, `flax` or `genomicsdb_tpu` is loaded exits 3 and prints no
result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from . import manifest  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "genomicsdb_tpu")


def forbidden_modules():
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _cache_dirs() -> None:
    """Every kernel cache of the run at a fixed path in the checkout
    (the program builds its own library into build/ there too)."""
    base = os.path.join(manifest.ROOT, "build", "gdb_bench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


class Tracer:
    """The spans, counters and device trace that the cell's per-layer
    metrics declare, over the window."""

    def __init__(self, metric_defs, device: str):
        from .trace import Spans, read_counter
        self._read_counter = read_counter
        self.mods = {m["name"]: manifest.metric_module(m["name"])
                     for m in metric_defs}
        self.spans = Spans()
        self.stores = {}
        wraps = {}
        self.counters = {}
        for name, mod in self.mods.items():
            on_call = getattr(mod, "on_call", None)
            for span, target in getattr(mod, "SPANS", {}).items():
                cbs = wraps.setdefault((span, target), [])
                if on_call is not None:
                    cbs.append((on_call, self.stores.setdefault(name, {})))
            self.counters.update(getattr(mod, "COUNTERS", {}))
        for (span, target), cbs in wraps.items():
            self.spans.wrap(span, target, self._calls(cbs) if cbs else None)
        self.before = {k: read_counter(t) for k, t in self.counters.items()}
        self.prof = None
        self.marker_t = None
        if device.startswith("cuda"):
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()

    @staticmethod
    def _calls(cbs):
        def call(span, args, kwargs, result):
            for fn, store in cbs:
                fn(span, args, kwargs, result, store)
        return call

    @contextlib.contextmanager
    def marker(self):
        if self.prof is None:
            yield
            return
        from torch.profiler import record_function

        from .trace import MARKER
        with record_function(MARKER):
            self.marker_t = time.perf_counter()
            yield

    def finish(self, window, counts):
        from .trace import DeviceTrace, TraceView
        device = None
        if self.prof is not None:
            import torch
            torch.cuda.synchronize()
            self.prof.__exit__(None, None, None)
            device = DeviceTrace(self.prof, self.marker_t, window)
            self.prof = None
        self.spans.unwrap()
        deltas = {k: self._read_counter(t) - self.before[k]
                  for k, t in self.counters.items()}
        view = TraceView(self.spans, deltas, device, counts, self.stores)
        values = {}
        for name, mod in self.mods.items():
            v = mod.read(view)
            if v is not None:
                values[name] = float(v)
        return values, device


def _power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20).stdout.strip()
        return float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def run_cell(bench: dict, cell: dict, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             cfg: dict = None, fault=None) -> dict:
    """One run of `cell` on `device`: set-up, the window, the checks.
    `cfg` replaces the cell's configuration (the tests' small sizes);
    `fault(driver)` is called after set-up (the tests' broken runs)."""
    from .drivers import HostProbe, log
    cfg = cfg or manifest.config(bench, cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    e2e_defs, layer_defs = manifest.cell_metrics(bench, cell["name"])
    units = manifest.units(bench)
    cuda = device.startswith("cuda")
    if cuda:
        import torch
    work = tempfile.mkdtemp(prefix="gdb_bench.")
    driver = manifest.kind_module(traffic["kind"]).Driver(
        cfg, traffic, seed, device, work)
    try:
        driver.setup()
        log(f"set-up: {time.perf_counter() - t_start:.3f} s since the "
            f"process started")
        if fault is not None:
            fault(driver)
        tracer = Tracer(layer_defs, device) if trace else None
        setup_s = time.perf_counter() - t_start
        probe = HostProbe()
        host0 = probe.read()
        win = driver.window(seconds, tracer.spans if tracer else None,
                            tracer.marker if tracer else None)
        log(f"window: {HostProbe.between(host0, probe.read())}")
        probe.close()
        counts = dict(win["counts"])
        kind = torch.cuda.get_device_name(0) if cuda else "cpu"
        counts["card"] = kind
        layer, dev_trace = tracer.finish(win["window"], counts) \
            if tracer else ({}, None)
        peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
        driver.release()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        checks = driver.check()
        log(f"check: {time.perf_counter() - t0:.3f} s")
    finally:
        driver.release()
        shutil.rmtree(work, ignore_errors=True)
    if trace:
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in layer.items()}
    else:
        vals = dict(win["e2e"], setup_s=setup_s)
        metrics = {m["name"]: {"value": vals[m["name"]], "unit": m["unit"]}
                   for m in e2e_defs if m["name"] in vals}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": cell["chips"], "memory_peak_bytes": peak}
    if cuda:
        dev["power_limit_w"] = _power_limit_w()
    if dev_trace is not None:
        dev["busy_s"] = dev_trace.busy_s()
        dev["window_s"] = dev_trace.window_s
    compared = [c for c in checks if c["limit"] is not None]
    correct = (win["attempted"] > 0 and win["failed"] == 0
               and all(c["value"] <= c["limit"] for c in compared))
    out = {"correct": correct, "attempted": win["attempted"],
           "failed": win["failed"], "metrics": metrics, "device": dev}
    if dev_trace is not None:
        out["breakdown"] = {
            "device_ops": dev_trace.top_ops(10),
            "idle_gaps": dev_trace.idle_gaps(tracer.spans, 10)}
    if win["errors"]:
        out["errors"] = win["errors"]
    out["counted"] = {c["name"]: c["value"] for c in checks
                      if c["limit"] is None}
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in compared}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gdb_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = manifest.load()
    cell = manifest.workload(bench, args.workload)
    _cache_dirs()
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"gdb_bench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    res = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                   "cuda:0", T_START)
    found = forbidden_modules()
    if found:
        print(f"gdb_bench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
