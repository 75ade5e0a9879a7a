"""The lookup cells' clients, in a process of their own so that their
Python does not share the server's interpreter lock.  It touches no
CUDA.

    python3 -m gdb_bench.clients     (JSON lines of settings on stdin)

It connects `clients` persistent `QueryStreamClient`s, sends the
set-up's warm-up lookups on the first, prints {"ready": ...}, waits for
{"seconds": s} on stdin, then runs each client as a closed loop of
lookups for s seconds (a lookup in flight at the close completes),
keeping every answer, and prints one JSON line of every lookup's times.
It then waits for {"save": [[client, lookup], ...]}, writes those
answers to `out_dir`, prints {"saved": [[[client, lookup], path],
...]} and ends.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time


def main() -> int:
    from genomicsdb_tpu_torch.query.stream_server import QueryStreamClient

    from .traffic import lookup_stream

    cfg = json.loads(sys.stdin.readline())

    def doc(lo, hi):
        q = dict(cfg["query"])
        q["query_column_ranges"] = [{"range_list": [{"low": lo,
                                                     "high": hi}]}]
        return q

    region, length, seed = cfg["region"], cfg["length"], cfg["seed"]
    host, port = cfg["address"]
    clients = [QueryStreamClient(host, port, timeout=300.0)
               for _ in range(cfg["clients"])]
    warm = lookup_stream(region, length, seed, -1)
    t0 = time.perf_counter()
    for _ in range(cfg["warmup"]):
        clients[0].query(doc(*next(warm)))
    print(json.dumps({"ready": time.perf_counter() - t0}), flush=True)
    seconds = json.loads(sys.stdin.readline())["seconds"]
    go = time.perf_counter()
    deadline = go + seconds
    logs = [[] for _ in clients]
    answers = {}

    def loop(c: int) -> None:
        stream = lookup_stream(region, length, seed, c)
        i = 0
        while time.perf_counter() < deadline:
            lo, hi = next(stream)
            t_a = time.perf_counter()
            err, data = None, b""
            try:
                data = clients[c].query(doc(lo, hi))
            except Exception as e:     # a failed lookup is counted
                err = f"{type(e).__name__}: {e}"
            t_b = time.perf_counter()
            if err is None:
                answers[(c, i)] = data
            logs[c].append({"client": c, "i": i, "lo": lo, "hi": hi,
                            "t0": t_a, "t1": t_b, "bytes": len(data),
                            "error": err})
            i += 1
            if err is not None:
                break

    threads = [threading.Thread(target=loop, args=(c,))
               for c in range(len(clients))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for cl in clients:
        cl.close()
    print(json.dumps({"go": go, "lookups": [x for log in logs
                                            for x in log]}), flush=True)
    saved = []
    for c, i in json.loads(sys.stdin.readline())["save"]:
        data = answers.get((c, i))
        if data is None:
            continue
        path = os.path.join(cfg["out_dir"], f"lookup_{c}_{i}.bcf")
        with open(path, "wb") as f:
            f.write(data)
        saved.append([[c, i], path])
    print(json.dumps({"saved": saved}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
