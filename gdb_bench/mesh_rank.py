"""A helper rank of a mesh cell's world (`kinds/mesh_combine.py`): rank
r > 0 of a world of P x R rank processes whose rank 0 is the harness's
own process.  It runs on its own card only (rank r on cuda:r).

    python3 -m gdb_bench.mesh_rank    (the launcher's variables of
                                       `gdb_query.rank_env` in its
                                       environment; JSON lines on stdin)

The first line gives the query files, the `gdb_query` arguments and the
run's device; the rank joins the world (`join_world`), then serves one
line at a time:

  {"query": i}             gdb_query.main(["-j", files[i]] + args
                           + ["--device", device]), in this process
  {"call": [path, name]}   calls `name` of the Python file `path` (the
                           tests' faults)
  {"mark": true}           the window starts: at the stop the rank logs
                           its CPU use since (`usage`)
  {"stop": true}           leaves the world and exits 0

Any failure exits 1 at once, without waiting on the world; so do the end
of stdin and the loss of the process that started this one (rank 0), so
that no rank waits on a collective that will not come.
"""

from __future__ import annotations

import contextlib
import datetime
import importlib.util
import json
import os
import resource
import sys
import threading
import time
import traceback

#: seconds a collective of the world waits for a rank that does not
#: arrive; the ranks' own watchers end a broken world sooner
TIMEOUT_S = 180


def join_world(device: str, timeout_s: float = TIMEOUT_S) -> str:
    """Join the world the launcher's variables describe (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), on the backend
    and card the program picks for its mesh (`sharded.choose_backend`,
    `sharded.rank_device`): NCCL with a card per rank, gloo on the CPU.
    Returns the backend."""
    import torch
    import torch.distributed as dist
    from genomicsdb_tpu_torch.parallel import sharded
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = torch.device(device)
    mine = sharded.rank_device(dev, int(os.environ["LOCAL_RANK"]))
    if mine.type == "cuda":
        torch.cuda.set_device(mine)
    backend = sharded.choose_backend(world, dev)
    dist.init_process_group(
        backend, init_method="env://", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    return backend


def leave_world() -> None:
    """Drop the program's kept meshes (where it keeps them), then the
    process group: a group that outlives destroy_process_group aborts
    the interpreter's exit on gloo."""
    import gc

    import torch.distributed as dist
    from genomicsdb_tpu_torch.parallel import sharded
    getattr(sharded, "drop_meshes", lambda: None)()
    gc.collect()
    if dist.is_initialized():
        dist.destroy_process_group()


def usage() -> dict:
    """This process's clock, CPU seconds and context switches (an
    involuntary one: the scheduler gave its core to another thread)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"t": time.perf_counter(), "cpu": ru.ru_utime + ru.ru_stime,
            "nvcsw": ru.ru_nvcsw, "nivcsw": ru.ru_nivcsw}


def usage_between(a: dict, b: dict) -> str:
    """The log line of this process's CPU use from `a` to `b`, with the
    cores it may run on and its threads (torch's and all of them)."""
    import torch
    try:
        threads = len(os.listdir("/proc/self/task"))
    except OSError:
        threads = -1
    return (f"{b['t'] - a['t']:.3f} s: cpu {b['cpu'] - a['cpu']:.3f} s, "
            f"switches voluntary {b['nvcsw'] - a['nvcsw']} involuntary "
            f"{b['nivcsw'] - a['nivcsw']}; cores {len(os.sched_getaffinity(0))}"
            f", torch threads {torch.get_num_threads()}, threads {threads}")


def _call(path: str, name: str) -> None:
    spec = importlib.util.spec_from_file_location("gdb_bench_mesh_call",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    getattr(mod, name)()


def _watch_parent(parent: int) -> None:
    def watch():
        while os.getppid() == parent:
            time.sleep(0.5)
        _log("the process that started this rank is gone")
        os._exit(1)
    threading.Thread(target=watch, daemon=True).start()


def _log(msg: str) -> None:
    print(f"gdb_bench.mesh_rank {os.environ.get('RANK')}: {msg}",
          file=sys.stderr, flush=True)


def serve() -> None:
    cfg = json.loads(sys.stdin.readline())
    from genomicsdb_tpu_torch.tools import gdb_query
    backend = join_world(cfg["device"])
    _log(f"joined the world of {os.environ['WORLD_SIZE']} on {backend}")
    mark = None
    for line in sys.stdin:
        msg = json.loads(line)
        if msg.get("stop"):
            if mark is not None:
                _log(f"window: {usage_between(mark, usage())}")
            leave_world()
            return
        if "call" in msg:
            _call(*msg["call"])
            continue
        if "mark" in msg:
            mark = usage()
            continue
        argv = (["-j", cfg["queries"][msg["query"]]] + list(cfg["args"])
                + ["--device", cfg["device"]])
        with contextlib.redirect_stdout(sys.stderr):
            gdb_query.main(argv)
    raise RuntimeError("stdin ended without a stop")


def main() -> int:
    _watch_parent(os.getppid())
    try:
        serve()
    except BaseException:           # noqa: BLE001 - any failure ends it
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
