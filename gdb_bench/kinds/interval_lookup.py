"""Traffic kind `interval_lookup`: the program's `QueryStreamServer` on
the device in this process, and persistent socket clients in a child
process of their own (`gdb_bench.clients`), each a closed loop of
interval lookups with starts drawn uniformly over the region.

Mix keys: `clients`, `interval_columns` (each lookup's length) and
`env` (the program's settings the deployment runs with).  The clients
keep every answer; after the window a sample drawn from the seed over
all the lookups the window completed, the last of each client among
them, is decoded from its BCF2 bytes and compared with the reference,
float fields as their float32 bits.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from typing import List

import numpy as np

from gdb_bench import traffic as T
from gdb_bench.drivers import lines_wrong, log, make_cohort, query_doc
from gdb_bench.manifest import ROOT
from gdb_bench.reference import Cohort, float_bits, reference_lines

# how the check renders a float field: its float32 bits
FLOATS = float_bits
# one lookup before the window: the server's first lookup opens the
# store and loads the kernel library
WARMUP_LOOKUPS = 1
# answers judged per run: the reference takes about 3.5 s for each
CHECKED = 6
# the completed lookups the control draws its sample from: about what
# a run completes (34-42 in a 50 s window, PERF.md §5)
CONTROL_COMPLETED = 38


def control_intervals(cohort, traffic: dict, seed: int):
    n = traffic["clients"]
    streams = [T.lookup_stream(cohort.region, traffic["interval_columns"],
                               seed, c) for c in range(n)]
    first = [[next(s) for _ in range(CONTROL_COMPLETED)] for s in streams]
    return [first[c][i] for c, i in
            T.checked_sample(seed, [CONTROL_COMPLETED] * n, CHECKED)]


class Driver:
    def __init__(self, cfg, traffic, seed, device, work):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.work = device, work
        self.server = self.proc = None
        self.lookups: List[dict] = []
        self.keep: List = []
        self.saved: dict = {}

    def setup(self) -> None:
        from genomicsdb_tpu_torch.query.stream_server import \
            QueryStreamServer
        # the program's settings that the mix names (a deployment's)
        self._env = {k: os.environ.get(k)
                     for k in self.traffic.get("env", {})}
        os.environ.update(self.traffic.get("env", {}))
        env = dict(os.environ)
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        # the clients import while the cohort is made
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "gdb_bench.clients"], cwd=ROOT, env=env,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.cohort = make_cohort(self.cfg, self.seed, self.work)
        t0 = time.perf_counter()
        self.server = QueryStreamServer("127.0.0.1", 0, device=self.device)
        self.server.start_background()
        tr = self.traffic
        q = query_doc(self.cohort, 0, 0)
        q.pop("query_column_ranges")
        self._send({"address": list(self.server.address), "query": q,
                    "region": self.cohort.region,
                    "length": tr["interval_columns"], "seed": self.seed,
                    "clients": tr["clients"], "warmup": WARMUP_LOOKUPS,
                    "out_dir": self.work})
        got = self._recv()                      # warm-up done
        log(f"set-up: server up and {WARMUP_LOOKUPS} warm-up lookup(s) in "
            f"{time.perf_counter() - t0:.3f} s (the lookups "
            f"{got['ready']:.3f} s)")

    def _send(self, obj) -> None:
        self.proc.stdin.write(json.dumps(obj) + "\n")
        self.proc.stdin.flush()

    def _recv(self) -> dict:
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"lookup clients ended (exit "
                               f"{self.proc.wait()})")
        return json.loads(line)

    def window(self, seconds: float, spans=None, marker=None) -> dict:
        marker = marker or contextlib.nullcontext
        with marker():
            self._send({"seconds": seconds})
            got = self._recv()
        self.lookups = got["lookups"]
        ok = [x for x in self.lookups if x["error"] is None]
        # the answers to judge, drawn now that the window's count is
        # known; the clients save them and end
        done = [sum(1 for x in ok if x["client"] == c)
                for c in range(self.traffic["clients"])]
        self.keep = T.checked_sample(self.seed, done, CHECKED)
        self._send({"save": self.keep})
        self.saved = {tuple(k): v for k, v in self._recv()["saved"]}
        self.proc.wait(timeout=60)
        lat = np.array([1e3 * (x["t1"] - x["t0"]) for x in ok])
        t1 = max(x["t1"] for x in self.lookups)
        log("window: lookups in ms " + " ".join(f"{v:.1f}" for v in lat))
        e2e = {}
        if len(lat):        # a cell lists the ones its window supports
            e2e = {"lookup_p50_ms": float(np.percentile(lat, 50)),
                   "lookup_p95_ms": float(np.percentile(lat, 95))}
        return {"window": (got["go"], t1),
                "attempted": len(self.lookups),
                "failed": len(self.lookups) - len(ok),
                "errors": [x["error"] for x in self.lookups
                           if x["error"]][:3],
                "e2e": e2e,
                "counts": {"lookups": len(ok)}}

    def release(self) -> None:
        for k, v in getattr(self, "_env", {}).items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        self._env = {}
        if self.server is not None:
            self.server.shutdown()
            self.server = None
        if self.proc is not None:
            if self.proc.poll() is None:
                self.proc.kill()
            self.proc.wait()
            self.proc.stdin.close()
            self.proc.stdout.close()
            self.proc = None

    def check(self) -> List[dict]:
        """Every record of each sampled answer (decoded from its BCF2
        bytes, floats as their float32 bits) against the reference; a
        sampled answer that was never saved counts as failed."""
        from gdb_bench.bcf import bcf_lines
        co = Cohort(self.cohort.vcfs, self.cohort.vid)
        wrong = compared = missing = 0
        by = {(x["client"], x["i"]): x for x in self.lookups}
        for key in map(tuple, self.keep):
            x, path = by.get(key), self.saved.get(key)
            if x is None or path is None:
                missing += 1
                continue
            ref = reference_lines(co, x["lo"], x["hi"], floats=FLOATS)
            with open(path, "rb") as f:
                wrong += lines_wrong(bcf_lines(f.read(), FLOATS), ref)
            compared += len(ref)
        failed = sum(x["error"] is not None for x in self.lookups)
        return [{"name": "records_compared", "value": compared,
                 "limit": None},
                {"name": "lookups_failed", "value": failed + missing,
                 "limit": 0},
                {"name": "records_wrong", "value": wrong, "limit": 0}]
