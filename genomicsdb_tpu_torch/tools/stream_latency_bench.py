"""Socket-stream interval-serving latency benchmark on the port
(counterpart of `genomicsdb_tpu.tools.stream_latency_bench`; the
GATK/Spark split pattern, reference GenomicsDBInputFormat.java:65: one
small interval query per partition x query block, thousands per job).

Builds genome_bench's cohort, persists it as a workspace on disk,
starts the port's query-stream server in-process on one torch device,
and times repeated interval queries through the FULL external
attachment round trip: TCP connect + JSON query parse + store open
(cached) + block-engine combine + BCF2 encode + socket stream.  Three
lanes over the same seeded intervals: one-shot connections and a
persistent connection (both with the serving index on, the production
path) and a persistent connection with the index off (the engine
lane); every lane's bytes must equal the engine lane's.  Prints one
JSON line.

Usage: python -m genomicsdb_tpu_torch.tools.stream_latency_bench \
          [--records N] [--samples N] [--queries N] [--device cuda|cpu]
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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--samples", type=int, default=8)
    ap.add_argument("--records", type=int, default=200_000)
    ap.add_argument("--queries", type=int, default=40)
    ap.add_argument("--warmup", type=int, default=6)
    ap.add_argument("--interval", type=int, default=10_000)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the server's block engine "
                         "('cuda' default, or 'cpu'); 'cuda' without a "
                         "card is an error")
    args = ap.parse_args(argv)
    from ..device import resolve_device
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"stream_latency_bench: {e}")

    from ..core.vid import VidMapper
    from ..query.stream_server import (QueryStreamClient, QueryStreamServer,
                                       read_query_stream)
    from ..store import workspace as ws
    from ..store.import_pipeline import import_callsets
    from .genome_bench import device_name, make_cohort, write_vid

    tmp = tempfile.mkdtemp()
    vcf_path = os.path.join(tmp, "genome_cohort.vcf")
    region = make_cohort(vcf_path, args.samples, args.records)
    vid_file = os.path.join(tmp, "vid.json")
    write_vid(vid_file)
    callset_file = os.path.join(tmp, "callsets.json")
    with open(callset_file, "w") as f:
        json.dump({"callsets": {
            f"S{i}": {"row_idx": i, "idx_in_file": i,
                      "filename": vcf_path}
            for i in range(args.samples)}}, f)

    vid = VidMapper.from_files(vid_file, callset_file)
    t0 = time.perf_counter()
    store = import_callsets(vid)
    t_import = time.perf_counter() - t0
    wsp = os.path.join(tmp, "workspace")
    ws.create_workspace(wsp)
    ws.write_fragment(wsp, "genome", store)

    srv = QueryStreamServer(port=0, device=device)
    srv.start_background()
    host, port = srv.address

    def doc(lo: int) -> dict:
        return {
            "workspace": wsp, "array_name": "genome",
            "vid_mapping_file": vid_file,
            "callset_mapping_file": callset_file,
            "attributes": [],
            "query_column_ranges": [
                {"range_list": [{"low": lo, "high": lo + args.interval}]}],
        }

    rng = random.Random(2)
    span = max(region - 2 * args.interval, 2)
    warm = [rng.randint(1, span) for _ in range(args.warmup)]
    los = [rng.randint(1, span) for _ in range(args.queries)]

    def lane(query):
        for lo in warm:
            query(doc(lo))
        lats, outs = [], []
        for lo in los:
            t0 = time.perf_counter()
            outs.append(query(doc(lo)))
            lats.append(time.perf_counter() - t0)
        return sorted(lats), outs

    prev = os.environ.get("GENOMICSDB_TPU_SERVING_INDEX")
    try:
        # engine lane first: the per-query live combine, index off
        os.environ["GENOMICSDB_TPU_SERVING_INDEX"] = "0"
        with QueryStreamClient(host, port) as cli:
            elats, want = lane(cli.query)
        os.environ["GENOMICSDB_TPU_SERVING_INDEX"] = "1"
        # production: the index builds during the warm-up
        with QueryStreamClient(host, port) as cli:
            plats, pers = lane(cli.query)
        lats, one = lane(lambda d: read_query_stream(host, port, d))
    finally:
        if prev is None:
            os.environ.pop("GENOMICSDB_TPU_SERVING_INDEX", None)
        else:
            os.environ["GENOMICSDB_TPU_SERVING_INDEX"] = prev
        srv.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    if not (pers == want and one == want):
        raise SystemExit("stream_latency_bench: served bytes differ from "
                         "the engine lane's")
    if any(d[:5] != b"BCF\x02\x02" for d in want):
        raise SystemExit("stream_latency_bench: a response is not BCF2")
    n = len(los)
    print(json.dumps({
        "device": str(device), "device_name": device_name(device),
        "samples": args.samples, "records": args.records,
        "cells": int(store.num_cells), "positions": region,
        "import_s": t_import,
        "interval_bp": args.interval, "queries": n,
        "socket_p50_ms": lats[n // 2] * 1000,
        "socket_p90_ms": lats[(n * 9) // 10] * 1000,
        "socket_min_ms": lats[0] * 1000,
        "persistent_p50_ms": plats[n // 2] * 1000,
        "persistent_p90_ms": plats[(n * 9) // 10] * 1000,
        "engine_persistent_p50_ms": elats[n // 2] * 1000,
        "engine_persistent_p90_ms": elats[(n * 9) // 10] * 1000,
        "mean_stream_bytes": sum(len(d) for d in want) // n}))


if __name__ == "__main__":
    sys.exit(main())
