"""Traffic kind `mesh_combine`: the scatter of `scatter_combine`, each
query run by a world of P x R rank processes (`gdb_query --mesh PxR`)
that stays up for the whole run, as a launched world (torchrun, mpirun)
serving a scatter would.

Rank 0 is this process, on the run's device, so the harness's clock,
tracer and device trace see a card's share of every query; ranks
1..P*R-1 are helper processes (`gdb_bench/mesh_rank.py`), rank r on
cuda:r (the launcher's variables of `gdb_query.rank_env` in every rank's
environment, this process's for the run).  Set-up writes the cohort and
the interval files as `scatter_combine` does, starts the world with the
first query and runs one warm-up query.  Before each query rank 0 sends
the helpers the interval's index; every rank then calls
`gdb_query.main(["-j", <interval>] + args + ["--device", <device>])`
in-process, and rank 0's standard output is the query's text.  The
window, the rate and `check` are `scatter_combine`'s; at the window's
end every rank logs its CPU seconds and context switches over it
(`mesh_rank.usage`).

Mix keys: those of `scatter_combine`; `args` holds `--mesh PxR`.

A world that loses a rank serves no more: a helper that exits, or a
query that fails on rank 0, ends the window and every helper at once.
Where rank 0 cannot return from a collective (NCCL waits on a lost peer
until its timeout), the process exits 1 a few seconds later, so no run
waits for the collectives' timeout.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import threading
import time
from typing import List

from gdb_bench import manifest
from gdb_bench import mesh_rank
from gdb_bench.drivers import HostProbe, log

_scatter = manifest.kind_module("scatter_combine")
FLOATS = _scatter.FLOATS
control_intervals = _scatter.control_intervals

#: the launcher's variables this process takes as rank 0
LAUNCHER = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
            "MASTER_ADDR", "MASTER_PORT")
#: seconds rank 0 may stay inside a collective after its world broke,
#: on gloo (whose collectives raise once a peer is gone), and on NCCL
#: (whose do not)
GRACE_S = {"gloo": 30.0, "nccl": 2.0}
#: seconds a helper has to leave the world after "stop"
STOP_S = 60.0


def mesh_world(args: List[str]) -> int:
    """P * R of the `--mesh PxR` among gdb_query arguments."""
    p, r = args[args.index("--mesh") + 1].lower().split("x")
    return int(p) * int(r)


class Driver(_scatter.Driver):
    def __init__(self, cfg, traffic, seed, device, work):
        super().__init__(cfg, traffic, seed, device, work)
        self.procs: List[subprocess.Popen] = []
        self.backend = None
        # why the world can serve no more queries (None while it can)
        self.broken = None
        self._lock = threading.Lock()
        self._busy = False      # rank 0 inside the world's collectives
        self._stopping = False
        self._saved = None

    # -- the world --------------------------------------------------
    def _start_world(self) -> None:
        import torch
        from genomicsdb_tpu_torch.tools import gdb_query
        world = mesh_world(self.traffic["args"])
        port = gdb_query.free_port()
        envs = [gdb_query.rank_env(r, world, port) for r in range(world)]
        self._saved = ({k: os.environ.get(k) for k in LAUNCHER},
                       torch.get_num_threads())
        os.environ.update({k: envs[0][k] for k in LAUNCHER})
        torch.set_num_threads(int(envs[0]["OMP_NUM_THREADS"]))
        first = json.dumps({"device": self.device,
                            "args": list(self.traffic["args"]),
                            "queries": self.query_files}) + "\n"
        t0 = time.perf_counter()
        for r in range(1, world):
            p = subprocess.Popen(
                [sys.executable, "-m", "gdb_bench.mesh_rank"],
                stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
                env=envs[r], cwd=manifest.ROOT, text=True)
            self.procs.append(p)
            p.stdin.write(first)
            p.stdin.flush()
        threading.Thread(target=self._watch, daemon=True).start()
        self._busy = True
        try:
            self.backend = mesh_rank.join_world(self.device)
        finally:
            self._busy = False
        log(f"set-up: a world of {world} ranks on {self.backend} joined in "
            f"{time.perf_counter() - t0:.3f} s")

    def _watch(self) -> None:
        """Rank 0's watch on its helpers: one that exits breaks the
        world."""
        while not self._stopping and self.broken is None:
            for r, p in enumerate(self.procs, 1):
                code = p.poll()
                if code is not None and not self._stopping:
                    self._fail(f"mesh rank {r} exited {code}")
                    return
            time.sleep(0.2)

    def _fail(self, why: str) -> None:
        """Break the world: end every helper now, and this process too
        where it stays inside a collective past its grace."""
        with self._lock:
            if self.broken is not None:
                return
            self.broken = why
        log(f"mesh: {why}; ending the world")
        self._kill()
        grace = GRACE_S.get(self.backend, GRACE_S["gloo"])

        def deadline():
            time.sleep(grace)
            if self._busy or self.backend == "nccl":
                log(f"mesh: rank 0 cannot leave the broken world "
                    f"({why}); exiting")
                sys.stderr.flush()
                os._exit(1)
        threading.Thread(target=deadline, daemon=True).start()

    def _kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def _send(self, msg: dict) -> None:
        line = json.dumps(msg) + "\n"
        for r, p in enumerate(self.procs, 1):
            try:
                p.stdin.write(line)
                p.stdin.flush()
            except OSError as e:
                self._fail(f"mesh rank {r} cannot be reached: {e}")
                raise RuntimeError(self.broken) from e

    def call_on(self, rank: int, path: str, name: str) -> None:
        """Have helper `rank` call `name` of the Python file `path` before
        its next query (the tests' faults)."""
        p = self.procs[rank - 1]
        p.stdin.write(json.dumps({"call": [path, name]}) + "\n")
        p.stdin.flush()

    # -- the traffic ------------------------------------------------
    def setup(self) -> None:
        super().setup()
        log(f"set-up: {self._memory()}")

    def _memory(self) -> str:
        """Rank 0's card: the allocator's peak and what the device holds
        in all (communicators included)."""
        if not self.device.startswith("cuda"):
            return "rank 0 on the host"
        import torch
        free, total = torch.cuda.mem_get_info(self.device)
        return (f"rank 0's card: allocator peak "
                f"{torch.cuda.max_memory_allocated(self.device)} B, "
                f"device in use {total - free} B")

    def _query(self, i: int) -> str:
        if self.broken is not None:
            raise RuntimeError(f"the mesh's world is broken: {self.broken}")
        try:
            if not self.procs:
                self._start_world()
            self._send({"query": i})
            self._busy = True
            return super()._query(i)
        except (Exception, SystemExit) as e:
            self._fail(f"rank 0's query failed: {type(e).__name__}: {e}")
            raise RuntimeError(f"{type(e).__name__}: {e}") from e
        finally:
            self._busy = False

    def window(self, seconds: float, spans=None, marker=None) -> dict:
        """`scatter_combine`'s window, ended by the first failed query: a
        world that lost a rank serves no more."""
        marker = marker or contextlib.nullcontext
        if self.procs and self.broken is None:
            with contextlib.suppress(RuntimeError):
                self._send({"mark": True})
        own = mesh_rank.usage()
        probe = HostProbe()
        host = [probe.read()]
        with marker():
            t0 = time.perf_counter()
            deadline = t0 + seconds
            while time.perf_counter() < deadline:
                i, _ = next(self.schedule)
                a = time.perf_counter()
                text, err = None, None
                try:
                    text = self._query(i)
                except Exception as e:      # a failed query is counted
                    err = f"{type(e).__name__}: {e}"
                b = time.perf_counter()
                if spans is not None:
                    spans.add("query", a, b)
                host.append(probe.read())
                self.done.append({"interval": i, "t0": a, "t1": b,
                                  "text": text, "error": err})
                if err is not None:
                    break
            t1 = time.perf_counter()
        probe.close()
        for q, h0, h1 in zip(self.done, host, host[1:]):
            log(f"window: query of interval {q['interval']} in "
                f"{HostProbe.between(h0, h1)}")
        log(f"window: {self._memory()}")
        log(f"window: rank 0: "
            f"{mesh_rank.usage_between(own, mesh_rank.usage())}")
        records = sum(q["text"].count("\n") for q in self.done
                      if q["text"] is not None)
        return {"window": (t0, t1),
                "attempted": len(self.done),
                "failed": sum(q["error"] is not None for q in self.done),
                "errors": [q["error"] for q in self.done if q["error"]][:3],
                "e2e": {"combine_records_per_s": records / (t1 - t0)},
                "counts": {"queries": len(self.done), "records": records}}

    def _stop(self) -> None:
        """Every rank leaves the world at once: NCCL ends a communicator
        only with all of its ranks, so rank 0 leaves beside its helpers
        (in a thread, so that a helper that never leaves costs STOP_S)."""
        try:
            self._send({"stop": True})
        except RuntimeError:
            return
        leaving = threading.Thread(target=mesh_rank.leave_world,
                                   daemon=True)
        leaving.start()
        end = time.monotonic() + STOP_S
        try:
            for p in self.procs:
                p.wait(timeout=max(end - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired as e:
            log(f"mesh: a helper did not stop: {e}")
        leaving.join(max(end - time.monotonic(), 0.1))
        if leaving.is_alive():
            log("mesh: rank 0 did not leave the world")

    def release(self) -> None:
        """Stop the helpers and leave the world (once; run_cell calls it
        twice), then give this process back its variables."""
        if self._saved is None:
            super().release()
            return
        self._stopping = True
        if self.broken is None:
            self._stop()
        if self.broken is not None and self.backend == "gloo":
            # a broken NCCL world is left to the process's exit
            mesh_rank.leave_world()
        self._kill()
        codes = [p.returncode for p in self.procs]
        log(f"release: mesh ranks 1..{len(codes)} exited {codes}")
        import torch
        env, threads = self._saved
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        torch.set_num_threads(threads)
        self._saved = None
        super().release()
