"""Query CLI on the port (gt_mpi_gather equivalent; counterpart of
`genomicsdb_tpu.tools.gdb_query`).

Usage:
  python -m genomicsdb_tpu_torch.tools.gdb_query -j query.json
      [-l loader.json]
      [--print-calls | --print-csv | --print-AC | --produce-Broad-GVCF
       | --produce-interesting-positions | --produce-histogram]
      [--engine block|sequential] [--device cuda|cpu] [-p page_size]
      [-s segment_size] [--ooc] [-r rank] [--num-ranks N]
      [--parallel-ranks] [--mesh POSxROW]

Takes the JAX tool's arguments plus `--device`, the counterpart of
`--platform` (which is refused).  `--produce-Broad-GVCF` with the block
engine (the default) runs the port's device combine on that device, and
so does the paged combined stream (`-p`); with `--ooc` (or past the
automatic size threshold) the block engine streams the store's column
windows.  Without `-p` or `--ooc`, the block engine derives its tables
from the cells of the opened store that can intersect the query's
column ranges (`window_store`).  Every other query mode, `--java-vcf`
and `--engine sequential` run on the host.  The fetch pack is on by
default on a CUDA device and off on the CPU; callers of `main` /
`run_rank` (tests, chip_smoke.py) force it with the `pack` keyword.

Distribution, as in the JAX tool:

  --parallel-ranks  one worker process per rank (column partition) of
                    `--num-ranks`, each `python -m
                    genomicsdb_tpu_torch.tools.gdb_query ... --device d`
                    (d = cuda:(i % cards) on a CUDA device), their
                    outputs gathered in rank order by this process (the
                    reference's MPI model)
  --mesh PxR        the block engine over a ("pos", "row") mesh of P*R
                    rank processes (`parallel.sharded`); this process
                    spawns them, or, started by a launcher (torchrun)
                    with a world of P*R ranks, is one of them.  Pos
                    group p takes span p of each chunk's records: its
                    row-0 rank alone builds the span's block, sends each
                    rank of the group its samples' rows, and renders the
                    span's text after the group's combine; the mesh's
                    first rank writes the pos groups' texts in order.
                    The backend follows the layout (NCCL with a card per
                    rank, gloo when ranks share a card or run on the
                    CPU).  The text equals the unsharded query's.

A rank that fails fails the whole query, with its stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

from ..core import profile
from ..core.config import INT64_MAX, ImportParams, QueryParams
from ..device import resolve_device
from ..query import driver as qdriver
from ..query import operators as ops
from ..query.scan import iterate_cells, scan_and_operate
from ..store import workspace as ws
from ..store.columnar import ColumnarStore
from ..store.fragment_v2 import OocArray, column_window


def load_context(args, rank: int):
    """(import params, query params, vid, store) of rank `rank`: the
    workspace opened anew and, for the block combine, cut to the
    query's column window (`window_store`); timed as the span
    `query.open`."""
    with profile.span("query.open"):
        return _load_context(args, rank)


def block_combine(args) -> bool:
    """Whether the query is the block engine's combined gVCF
    (`--produce-Broad-GVCF --engine block`, without `--java-vcf` or
    `-p`): the mode that streams an OocArray's windows, that a mesh
    shards, and whose store is cut to its column window."""
    return bool(args.produce_Broad_GVCF and args.engine == "block"
                and not args.java_vcf and args.page_size == 0)


def window_store(args, qp, store):
    """The store that the query's tables are derived over: for the block
    combine on a store opened for this call (in RAM or memory-mapped),
    its cells that can intersect the query's column ranges
    (`fragment_v2.column_window`: views of its columns, global eff_end
    values kept); the store itself for a whole-store query, an
    out-of-core store (which streams windows of its own) and every
    other query mode.  A store kept open across queries (the stream
    server, the serving engine) never comes through here, so it keeps
    its store-wide tables, and the serving index, which builds on a
    store's second query of one signature, never meets a window.
    Counts `store_cells` (the opened store's) and `window_cells`."""
    n = (store.store if isinstance(store, OocArray) else store).num_cells
    ranges = [] if qp.scan_full or not qp.column_ranges \
        else qp.column_ranges[0]
    if ranges and block_combine(args) and isinstance(store, ColumnarStore):
        store = column_window(store, min(int(a) for a, _ in ranges),
                              max(int(b) for _, b in ranges))
    profile.count("store_cells", n)
    profile.count("window_cells", n if isinstance(store, OocArray)
                  else store.num_cells)
    return store


def _load_context(args, rank: int):
    ip = ImportParams.from_file(args.loader) if args.loader else None
    if getattr(args, "query_pb", None):
        # binary ExportConfiguration (the reference's PB plane; wire-
        # compatible schemas in protos/compat/)
        from ..core import pb_compat
        with open(args.query_pb, "rb") as f:
            qp, pb_vid = pb_compat.export_config_to_query(f.read())
        vid = pb_vid if pb_vid is not None \
            else qdriver.load_vid_for_query(qp, ip)
    else:
        qp = QueryParams.from_file(args.query_json, rank)
        vid = qdriver.load_vid_for_query(qp, ip)
    if args.segment_size:
        qp.segment_size = args.segment_size
    if args.chromosome:
        # --chromosome/--begin/--end contig-interval query (TestGenomicsDB
        # java driver flags): translate to flattened columns via the vid
        lo = vid.flatten_position(args.chromosome, args.begin or 1)
        hi = vid.flatten_position(
            args.chromosome,
            args.end or vid.contigs[args.chromosome].length)
        qp.column_ranges = [[(lo, hi)]]
    workspace = qp.workspace or ""
    store = None
    if workspace and qp.array_name and ws.is_workspace(workspace):
        store = _open_store(args, qp, workspace)
    if store is None and ip is not None and ip.column_partitions:
        # inherit this rank's workspace/array from the loader JSON
        # (the reference's update_from_loader, gt_mpi_gather.cc:550-557)
        # — query the IMPORTED partition instead of re-importing
        parts = sorted(ip.column_partitions,
                       key=lambda p: int(p["begin"]))
        if rank < len(parts):
            part = parts[rank]
            w = ip.resolve(part.get("workspace", "")) \
                if part.get("workspace") else ""
            a = part.get("array_name") or part.get("array") or ""
            if w and a and ws.is_workspace(w) \
                    and ws.array_exists(w, a):
                qp.workspace, qp.array_name = w, a
                store = _open_store(args, qp, w)
    if store is None:
        if ip is not None:
            store = qdriver.build_store_from_loader(ip, vid, rank)
        elif vid.callsets:
            # inline callset mapping (PB plane): import directly
            from ..store.import_pipeline import import_callsets
            store = import_callsets(vid)
        else:
            raise SystemExit("no workspace array found and no loader JSON "
                             "given to import from")
    # subset query ranges against the rank's loader partition
    # (gt_mpi_gather.cc:556-557)
    if ip is not None and ip.column_partitions and qp.column_ranges:
        lo, hi = ip.partition_bounds(rank)
        subset = [(max(a, lo), min(b, hi))
                  for a, b in qp.column_ranges[0] if a <= hi and b >= lo]
        qp.column_ranges = [subset]
    return ip, qp, vid, window_store(args, qp, store)


def _open_store(args, qp, workspace):
    """Open the workspace array — out-of-core (memory-bounded column
    windows at segment_size granularity) with --ooc, or automatically
    when a single v2 fragment exceeds GENOMICSDB_TPU_OOC_THRESHOLD
    (default 4 GiB); in-RAM otherwise."""
    import os as _os
    use_ooc = getattr(args, "ooc", False)
    if not use_ooc and "://" not in workspace:
        from ..store.fragment_v2 import V2_SUFFIX, read_manifest
        frags = ws._fragment_paths(workspace, qp.array_name)
        if len(frags) == 1 and frags[0].endswith(V2_SUFFIX):
            thresh = int(_os.environ.get(
                "GENOMICSDB_TPU_OOC_THRESHOLD", 4 << 30))
            if read_manifest(frags[0])["total_bytes"] > thresh:
                use_ooc = True
    if use_ooc:
        return ws.open_array_ooc(workspace, qp.array_name,
                                 segment_size=qp.segment_size)
    return ws.open_array(workspace, qp.array_name)


def run_rank(args, rank: int, device, pack=None, mesh=None) -> str:
    """One rank's output text: the block-engine combined gVCF on
    `device` (`pack` and `mesh` as in driver.run_vcf_query_block), every
    other query mode on the host."""
    ip, qp, vid, store = load_context(args, rank)
    if isinstance(store, OocArray) and not block_combine(args):
        # only the block combine engine streams OocArray windows; the
        # other query types run on the memory-mapped store view (the OS
        # pages in what the query touches)
        store = store.store
    qc = qdriver.make_query_config(qp, vid)
    if args.print_calls:
        return qdriver.run_calls_query(store, qc)
    if args.print_csv:
        ivs = qc.column_intervals or None
        return ops.print_csv(store, qc, ivs)
    if args.print_AC:
        op = ops.AlleleCountOperator(qc)
        for iv in (qc.column_intervals or [None]):
            for call in iterate_cells(store, qc, iv):
                op.operate(call)
        return op.render()
    if args.produce_interesting_positions:
        op = ops.InterestingLocationsPrinter()
        for iv in (qc.column_intervals or [None]):
            scan_and_operate(store, qc, op.operate, iv)
        return op.render()
    if args.produce_histogram:
        op = ops.ColumnHistogramOperator(0, 4_000_000_000, args.bin_size)
        for iv in (qc.column_intervals or [None]):
            for call in iterate_cells(store, qc, iv):
                op.operate(call)
        return op.equi_partition_and_render(args.num_equi_bins)
    if args.produce_Broad_GVCF:
        template = qp.resolve(qp.vcf_header_filename) \
            if qp.vcf_header_filename else None
        if template is None and ip is not None and ip.vcf_header_filename:
            template = ip.resolve(ip.vcf_header_filename)
        refg = qp.resolve(qp.reference_genome) if qp.reference_genome \
            else (ip.resolve(ip.reference_genome) if ip else None)
        # header only on the first rank (partition outputs are concatenated)
        tmpl = template if rank == args.rank \
            and not args.no_vcf_header else None
        if args.page_size > 0 and not args.java_vcf:
            # resumable byte pages whose concatenation is byte-identical
            # to the one-shot query (gt_mpi_gather.cc -p page_size /
            # RWBuffer path), through the block engine on `device`
            pages = qdriver.run_vcf_query_paged(
                store, qc, qp, vid, device, args.page_size,
                template_path=tmpl, reference_path=refg, pack=pack)
            return b"".join(pages).decode()
        if args.java_vcf:
            return qdriver.run_java_vcf_query(
                store, qc, qp, vid, template_path=tmpl,
                reference_path=refg)
        if args.engine == "sequential":
            return qdriver.run_vcf_query(store, qc, qp, vid,
                                         template_path=tmpl,
                                         reference_path=refg)
        return qdriver.run_vcf_query_block(store, qc, qp, vid, device,
                                           template_path=tmpl,
                                           reference_path=refg, pack=pack,
                                           mesh=mesh)
    if args.output_format in ("Cotton-JSON", "Positions-JSON"):
        from ..query import json_output
        from ..query.variants_path import gt_get_column_interval
        per_interval = [(iv, gt_get_column_interval(store, qc, iv))
                        for iv in (qc.column_intervals
                                   or [(0, INT64_MAX - 1)])]
        if args.output_format == "Cotton-JSON":
            return json_output.print_cotton_json(
                [v for _, vs in per_interval for v in vs], qc)
        return json_output.print_positions_json(per_interval, qc)
    # default: variants JSON range query
    return qdriver.run_variants_query(store, qc)


def _build_parser():
    p = argparse.ArgumentParser(prog="gdb_query")
    p.add_argument("-j", "--query-json", dest="query_json", default=None)
    p.add_argument("--query-pb", dest="query_pb", default=None,
                   help="binary ExportConfiguration protobuf "
                        "(reference-schema wire format) instead of -j")
    p.add_argument("-l", "--loader", default=None)
    p.add_argument("-s", "--segment-size", type=int, default=0)
    p.add_argument("--ooc", action="store_true",
                   help="serve the query out-of-core: the block engine "
                        "streams memory-bounded column windows of "
                        "segment_size bytes (-s) instead of loading the "
                        "partition into RAM (v2 fragments; "
                        "auto-enabled past GENOMICSDB_TPU_OOC_THRESHOLD, "
                        "default 4 GiB); other query modes read the "
                        "memory-mapped store")
    p.add_argument("-p", "--page-size", type=int, default=0,
                   help="produce the combined gVCF as resumable pages "
                        "of about this many bytes (block engine on "
                        "--device)")
    p.add_argument("-r", "--rank", type=int, default=0)
    p.add_argument("--num-ranks", type=int, default=1,
                   help="gather outputs of ranks [rank, rank+num_ranks)")
    p.add_argument("--parallel-ranks", action="store_true",
                   help="run each rank in its OWN worker process and "
                        "gather stdout in rank order — the reference's "
                        "MPI rank-per-partition execution model "
                        "(vcf2tiledb.cc:44-52, gt_mpi_gather.cc:166-295) "
                        "with this process as the root gatherer")
    p.add_argument("--rank-piece", action="store_true",
                   help=argparse.SUPPRESS)   # internal: worker mode
    p.add_argument("--no-vcf-header", action="store_true",
                   help=argparse.SUPPRESS)   # internal: non-first rank
    p.add_argument("--print-calls", action="store_true")
    p.add_argument("--print-csv", action="store_true")
    p.add_argument("--print-AC", dest="print_AC", action="store_true")
    p.add_argument("--produce-Broad-GVCF", dest="produce_Broad_GVCF",
                   action="store_true")
    p.add_argument("--produce-interesting-positions",
                   action="store_true")
    p.add_argument("--produce-histogram", dest="produce_histogram",
                   action="store_true")
    p.add_argument("--bin-size", type=int, default=10000)
    p.add_argument("--num-equi-bins", type=int, default=10)
    p.add_argument("--chromosome", default=None)
    p.add_argument("--begin", type=int, default=None)
    p.add_argument("--end", type=int, default=None)
    p.add_argument("--java-vcf", dest="java_vcf", action="store_true",
                   help="htsjdk-style rendering for --produce-Broad-GVCF")
    p.add_argument("--mesh", default=None, metavar="POSxROW",
                   help="run the block-engine combine sharded over an "
                        "n_pos x n_row mesh of rank processes (e.g. 2x2): "
                        "position axis = records, row axis = samples; "
                        "output identical to the unsharded query")
    p.add_argument("--engine", choices=["sequential", "block"],
                   default="block",
                   help="combined-VCF engine (default: block — the "
                        "batched device engine; byte-identical to "
                        "'sequential', the per-record reference-"
                        "semantics oracle)")
    p.add_argument("-O", "--output-format", dest="output_format",
                   default="", choices=["", "Cotton-JSON",
                                        "Positions-JSON", "GA4GH"],
                   help="range-query output format (default GA4GH-like)")
    p.add_argument("--platform", default=None,
                   help="refused on the port, which takes --device")
    p.add_argument("--device", default="cuda",
                   help="torch device for the block engine's combine "
                        "('cuda' default, or 'cpu'); 'cuda' without a "
                        "visible card is an error, never a fallback")
    return p


def _refuse(args) -> None:
    if args.platform:
        raise SystemExit("gdb_query: --platform selects a jax platform; "
                         "the port takes --device")
    if args.mesh and not block_combine(args):
        raise SystemExit("gdb_query: --mesh shards the block engine's "
                         "combine: it takes --produce-Broad-GVCF with the "
                         "block engine, without -p or --java-vcf")
    if args.mesh and args.parallel_ranks:
        raise SystemExit("gdb_query: --mesh and --parallel-ranks are two "
                         "ways to distribute a query; give one")


def _mesh_shape(spec: str):
    try:
        n_pos, n_row = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise SystemExit(f"gdb_query: --mesh takes POSxROW, got {spec!r}")
    if n_pos < 1 or n_row < 1:
        raise SystemExit(f"gdb_query: --mesh {spec}: both sides must be >= 1")
    return n_pos, n_row


def _strip(raw_argv, with_value, flags):
    """raw_argv without the options in `with_value` (and their values,
    also in the --opt=value form) and the flags in `flags`."""
    out, skip = [], False
    for a in raw_argv:
        if skip:
            skip = False
        elif a in with_value:
            skip = True
        elif a in flags or a.split("=", 1)[0] in with_value:
            continue
        else:
            out.append(a)
    return out


def child_env(**extra) -> dict:
    """This process's environment for a worker process, with the
    directory holding this package first on PYTHONPATH (so `python -m
    genomicsdb_tpu_torch...` resolves from any working directory), plus
    `extra`."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=root + (os.pathsep + path
                                               if path else ""), **extra)


def rank_env(rank: int, world: int, port: int) -> dict:
    """child_env for rank `rank` of `world` rank processes on this host:
    the launcher's variables (RANK, WORLD_SIZE, LOCAL_RANK,
    LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) and, unless this
    process's environment sets it, OMP_NUM_THREADS = this host's cores /
    world, so the ranks' host threads share the cores instead of each
    spinning on all of them (torchrun sets it too)."""
    threads = os.environ.get("OMP_NUM_THREADS") or str(
        max(1, len(os.sched_getaffinity(0)) // world))
    return child_env(RANK=str(rank), WORLD_SIZE=str(world),
                     LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                     MASTER_ADDR="localhost", MASTER_PORT=str(port),
                     OMP_NUM_THREADS=threads)


def _drain(stream, sink: list) -> threading.Thread:
    t = threading.Thread(target=lambda: sink.append(stream.read()),
                         daemon=True)
    t.start()
    return t


def _parallel_rank_pieces(raw_argv, args, device):
    """Spawn one gdb_query worker PROCESS per rank and gather their
    stdout in rank order — the reference's MPI execution model
    (rank-per-partition processes, root MPI_Gatherv of the serialized
    results, gt_mpi_gather.cc:166-295).  Worker i runs on `device`:
    cuda:(i % cards) on a CUDA device, so every worker on a one-card
    machine uses cuda:0."""
    import torch
    base = _strip(raw_argv, ("-r", "--rank", "--num-ranks", "--device"),
                  ("--parallel-ranks",))
    ranks = range(args.rank, args.rank + args.num_ranks)
    procs = []
    for i, r in enumerate(ranks):
        dev = "cpu" if device.type == "cpu" else \
            f"cuda:{i % torch.cuda.device_count()}"
        cmd = [sys.executable, "-m", "genomicsdb_tpu_torch.tools.gdb_query",
               *base, "-r", str(r), "--num-ranks", "1", "--rank-piece",
               "--device", dev]
        if i > 0:
            cmd.append("--no-vcf-header")
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE,
                                      env=child_env()))
    pieces, errs = [], []
    for r, pr in zip(ranks, procs):
        out, err = pr.communicate()
        if pr.returncode != 0:
            errs.append(f"rank {r}: exit {pr.returncode}: "
                        f"{err.decode(errors='replace')[-2000:]}")
        pieces.append(out.decode())
    if errs:
        raise SystemExit("gdb_query --parallel-ranks failed:\n"
                         + "\n".join(errs))
    return pieces


#: the start of the line of counts each mesh rank prints on stderr
REPORT = "gdb_query mesh rank report: "


def free_port() -> int:
    """A TCP port that is free on this host now (for a rendezvous)."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_mesh(raw_argv, world: int,
               module: str = "genomicsdb_tpu_torch.tools.gdb_query") -> str:
    """Run `python -m <module> <raw_argv>` as `world` mesh rank processes
    on this host (the launcher's environment, `rank_env`) and return
    the first rank's stdout.  The ranks' stderr follows on this
    process's stderr; each rank's report line is also parsed into
    `spawn_mesh.rank_reports`.  A rank that exits non-zero ends the
    others and fails the run with its stderr.  The first rank writes its
    stdout to a temporary file, read once it has exited: through a pipe,
    the tail of a large text was seen to be lost with every rank
    exiting 0."""
    port = free_port()
    procs, errs, threads = [], [], []
    with tempfile.TemporaryFile() as out:
        try:
            for r in range(world):
                pr = subprocess.Popen(
                    [sys.executable, "-m", module, *raw_argv],
                    stdout=out if r == 0 else subprocess.DEVNULL,
                    stderr=subprocess.PIPE, env=rank_env(r, world, port))
                procs.append(pr)
                errs.append([])
                threads.append(_drain(pr.stderr, errs[-1]))
            failed = None
            while failed is None and any(p.poll() is None for p in procs):
                failed = next((r for r, p in enumerate(procs)
                               if p.poll() not in (None, 0)), None)
                time.sleep(0.05)
            if failed is None:
                failed = next((r for r, p in enumerate(procs)
                               if p.returncode != 0), None)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            for t in threads:
                t.join()
        out.seek(0)
        stdout = out.read().decode()
    text = [b"".join(e).decode(errors="replace") for e in errs]
    if failed is not None:
        raise SystemExit(f"{module}: mesh rank {failed} exited "
                         f"{procs[failed].returncode}:\n"
                         f"{text[failed][-4000:]}")
    reports = []
    for t in text:
        for line in t.splitlines():
            if line.startswith(REPORT):
                reports.append(json.loads(line[len(REPORT):]))
            print(line, file=sys.stderr)
    spawn_mesh.rank_reports = sorted(reports, key=lambda d: d["rank"])
    return stdout


spawn_mesh.rank_reports = []


def _mesh_pieces(args, device, n_pos: int, n_row: int):
    """This process as one rank of the mesh: its pieces of the output
    (the header alone off the first rank), whether it is the first rank,
    and a report line on stderr: its counts, the seconds it took to join
    the mesh (`mesh_s`) and to run its query (`query_s`).  The counts:
    blocks combined (`blocks`, `general_path_blocks`), kernel launches,
    row-group all-gathers and their bytes, the blocks and records this
    rank built (`blocks_built`, `records_built`, padding excluded; the
    spans' [lo, hi] columns in `built_spans`), the bytes it sent or
    received in the row group's block-row scatter (`lut_scatter_bytes`)
    and the bytes of the span text it rendered (`text_bytes`)."""
    import torch.distributed as dist
    from ..ops import fused_combine as FC
    from ..parallel import comm
    from ..parallel.sharded import make_mesh, mesh_combine, scatter_rows
    from ..query.block_writer import render_block_vcf_pipelined as RB
    owned = not dist.is_initialized()
    t0 = time.perf_counter()
    mesh = make_mesh(n_pos, n_row, device)
    t1 = time.perf_counter()
    try:
        pieces = [run_rank(args, r, mesh.device, mesh=mesh)
                  for r in range(args.rank, args.rank + args.num_ranks)]
        report = {
            "rank": mesh.rank, "pos": mesh.pos, "row": mesh.row,
            "device": str(mesh.device), "backend": mesh.backend,
            "mesh_s": t1 - t0, "query_s": time.perf_counter() - t1,
            "blocks": mesh_combine.blocks,
            "general_path_blocks": mesh_combine.general_path_blocks,
            "launches": FC.fused_gather_remap.launches,
            "all_gathers": comm.all_gather.calls,
            "all_gather_bytes": comm.all_gather.bytes,
            "blocks_built": RB.blocks_built,
            "records_built": RB.records_built,
            "built_spans": RB.built_spans,
            "lut_scatter_bytes": scatter_rows.bytes,
            "text_bytes": RB.text_bytes}
    finally:
        # the DeviceMesh's groups go before the process group: a group
        # that outlives destroy_process_group aborts the interpreter's
        # exit (gloo)
        del mesh
        if owned:
            dist.destroy_process_group()
    print(REPORT + json.dumps(report), file=sys.stderr)
    return pieces, report["rank"] == 0


def _in_launched_world() -> bool:
    import torch.distributed as dist
    return dist.is_initialized() or (
        "RANK" in os.environ and "WORLD_SIZE" in os.environ)


def rank_output(argv) -> str:
    """Parse a gdb_query argv (with its `--device`) and return the output
    text (the rank-pool worker entry, parallel/rank_pool.py — no stdout
    side effects, no file knobs)."""
    args = _build_parser().parse_args(argv)
    _refuse(args)
    device = resolve_device(args.device)
    return "".join(run_rank(args, r, device)
                   for r in range(args.rank, args.rank + args.num_ranks))


def main(argv=None, *, pack=None):
    """The tool: one request (the root span `query`) per call; with
    GENOMICSDB_TPU_PROFILE set, the tracer's report on stderr after
    it."""
    with profile.request("query"):
        _main(argv, pack)
    profile.maybe_report()


def _main(argv, pack):
    p = _build_parser()
    args = p.parse_args(argv)
    if not args.query_json and not args.query_pb:
        p.error("one of -j/--query-json or --query-pb is required")
    _refuse(args)
    device = resolve_device(args.device)
    raw = list(argv) if argv is not None else sys.argv[1:]
    try:
        if args.mesh:
            n_pos, n_row = _mesh_shape(args.mesh)
            if not _in_launched_world():
                # the first rank wrote the output (or the query's file)
                sys.stdout.write(spawn_mesh(raw, n_pos * n_row))
                return
            pieces, first = _mesh_pieces(args, device, n_pos, n_row)
            if not first:
                return
        elif args.parallel_ranks and args.num_ranks > 1:
            pieces = _parallel_rank_pieces(raw, args, device)
        else:
            pieces = [run_rank(args, r, device, pack)
                      for r in range(args.rank, args.rank + args.num_ranks)]
    except FileNotFoundError as e:
        raise SystemExit(f"gdb_query: file not found: {e.filename or e}")
    except json.JSONDecodeError as e:
        raise SystemExit(f"gdb_query: malformed JSON in "
                         f"{args.query_json}: {e}")
    except KeyError as e:
        raise SystemExit(f"gdb_query: unknown contig or field {e} "
                         "(check --chromosome / vid mapping)")
    with profile.span("query.write"):
        _write_output(args, pieces)


def _write_output(args, pieces) -> None:
    """The ranks' pieces joined, written to the query's output file or
    to stdout."""
    text = "".join(pieces)
    # vcf_output_filename / vcf_output_format knobs (VCFAdapter "z" mode)
    if args.query_pb:
        from ..core import pb_compat
        with open(args.query_pb, "rb") as f:
            qp0, _ = pb_compat.export_config_to_query(f.read())
    else:
        qp0 = QueryParams.from_file(args.query_json, args.rank)
    if args.rank_piece:
        sys.stdout.write(text)
        return
    if qp0.vcf_output_filename and qp0.vcf_output_filename != "-":
        from ..vcf.bgzf import open_output
        with open_output(qp0.resolve(qp0.vcf_output_filename),
                         qp0.vcf_output_format,
                         index=qp0.index_output_VCF) as f:
            f.write(text)
    else:
        sys.stdout.write(text)


if __name__ == "__main__":
    main()
