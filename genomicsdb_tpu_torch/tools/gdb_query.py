"""Query CLI on the port (counterpart of `genomicsdb_tpu.tools.gdb_query`).

Usage:
  python -m genomicsdb_tpu_torch.tools.gdb_query -j query.json
      [-l loader.json] --produce-Broad-GVCF [--device cuda|cpu] ...

Takes the JAX tool's arguments (its parser and context loading are
jax-free and reused) plus `--device`, the counterpart of `--platform`.
The fetch pack is on by default on a CUDA device and off on the CPU;
callers of `main` / `run_rank` (tests, chip_smoke.py) force it with the
`pack` keyword.
`--produce-Broad-GVCF` with the block engine (the default) runs the
port's driver on that device; the other query modes and
`--engine sequential` are host-only and run the JAX tool's own
branches.  `--mesh`, `--platform`, `--parallel-ranks` and the paged
combined stream (`-p/--page-size`) are refused.
"""

from __future__ import annotations

import sys

from genomicsdb_tpu.core.config import QueryParams
from genomicsdb_tpu.tools import gdb_query as jax_tool

from ..device import resolve_device
from ..query import driver as tdriver


def _build_parser():
    p = jax_tool._build_parser()
    p.add_argument("--device", default="cuda",
                   help="torch device for the block engine's combine "
                        "('cuda' default, or 'cpu'); 'cuda' without a "
                        "visible card is an error, never a fallback")
    return p


def _refuse(args) -> None:
    if args.mesh:
        raise SystemExit("gdb_query: --mesh is not supported on the port "
                         "(the sharded combine is not ported yet)")
    if args.platform:
        raise SystemExit("gdb_query: --platform selects a jax platform; "
                         "the port takes --device")
    if args.parallel_ranks:
        raise SystemExit("gdb_query: --parallel-ranks is not supported on "
                         "the port")
    if args.produce_Broad_GVCF and args.page_size > 0 \
            and not args.java_vcf:
        raise SystemExit("gdb_query: -p/--page-size (the paged combined "
                         "stream) is not supported on the port")


def run_rank(args, rank: int, device, pack=None) -> str:
    """One rank's output text: the block-engine combined gVCF on
    `device` (`pack` as in driver.run_vcf_query_block), or the JAX
    tool's host-only branches for everything else."""
    if not (args.produce_Broad_GVCF and args.engine == "block"
            and not args.java_vcf):
        return jax_tool.run_rank(args, rank)
    ip, qp, vid, store = jax_tool.load_context(args, rank)
    from genomicsdb_tpu.store.fragment_v2 import OocArray
    if isinstance(store, OocArray):
        # out-of-core windows are not ported: serve the memory-mapped
        # store view (the OS pages in what the query touches)
        store = store.store
    qc = tdriver.make_query_config(qp, vid)
    template = qp.resolve(qp.vcf_header_filename) \
        if qp.vcf_header_filename else None
    if template is None and ip is not None and ip.vcf_header_filename:
        template = ip.resolve(ip.vcf_header_filename)
    refg = qp.resolve(qp.reference_genome) if qp.reference_genome \
        else (ip.resolve(ip.reference_genome) if ip else None)
    # header only on the first rank (partition outputs are concatenated)
    tmpl = template if rank == args.rank \
        and not args.no_vcf_header else None
    return tdriver.run_vcf_query_block(store, qc, qp, vid, device,
                                       template_path=tmpl,
                                       reference_path=refg, pack=pack)


def main(argv=None, *, pack=None):
    p = _build_parser()
    args = p.parse_args(argv)
    if not args.query_json and not args.query_pb:
        p.error("one of -j/--query-json or --query-pb is required")
    _refuse(args)
    device = resolve_device(args.device)
    import json as _json
    try:
        pieces = [run_rank(args, r, device, pack)
                  for r in range(args.rank, args.rank + args.num_ranks)]
    except FileNotFoundError as e:
        raise SystemExit(f"gdb_query: file not found: {e.filename or e}")
    except _json.JSONDecodeError as e:
        raise SystemExit(f"gdb_query: malformed JSON in "
                         f"{args.query_json}: {e}")
    except KeyError as e:
        raise SystemExit(f"gdb_query: unknown contig or field {e} "
                         "(check --chromosome / vid mapping)")
    text = "".join(pieces)
    if args.query_pb:
        from genomicsdb_tpu.core import pb_compat
        with open(args.query_pb, "rb") as f:
            qp0, _ = pb_compat.export_config_to_query(f.read())
    else:
        qp0 = QueryParams.from_file(args.query_json, args.rank)
    if args.rank_piece:
        sys.stdout.write(text)
        return
    if qp0.vcf_output_filename and qp0.vcf_output_filename != "-":
        from genomicsdb_tpu.vcf.bgzf import open_output
        with open_output(qp0.resolve(qp0.vcf_output_filename),
                         qp0.vcf_output_format,
                         index=qp0.index_output_VCF) as f:
            f.write(text)
    else:
        sys.stdout.write(text)
    from genomicsdb_tpu.core import profile
    profile.maybe_report()


if __name__ == "__main__":
    main()
