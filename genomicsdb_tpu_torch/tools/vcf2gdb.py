"""Import CLI: loader-JSON-driven gVCF import (vcf2tiledb equivalent).

Usage: python -m genomicsdb_tpu_torch.tools.vcf2gdb <loader.json> [--rank R]

Mirrors tools/src/vcf2tiledb.cc: one invocation imports one column
partition (rank-selectable, reference vcf2tiledb.cc:80-82); with
produce_combined_vcf the combined gVCF goes to stdout (the loading golden).
"""

from __future__ import annotations

import argparse
import os
import sys

from ..core.config import ImportParams, QueryParams
from ..core.vid import VidMapper
from ..query import driver as qdriver
from ..store import workspace as ws
from ..store.import_pipeline import import_callsets


def run_import(loader_json: str, rank: int = 0, out=sys.stdout) -> None:
    ip = ImportParams.from_file(loader_json, rank)
    vid = VidMapper.from_files(ip.resolve(ip.vid_mapping_file),
                               ip.resolve(ip.callset_mapping_file))
    # incremental-import row bounds (lb/ub_callset_row_idx,
    # genomicsdb_config_base.h:60-61)
    if ip.lb_callset_row_idx > 0 or ip.ub_callset_row_idx < 2**63 - 2:
        vid.callsets = {k: v for k, v in vid.callsets.items()
                        if ip.lb_callset_row_idx <= v.row_idx
                        <= ip.ub_callset_row_idx}
        vid.rows = {r: v for r, v in vid.rows.items()
                    if ip.lb_callset_row_idx <= r
                    <= ip.ub_callset_row_idx}
    begin, end = (ip.partition_bounds(rank) if ip.column_partitions
                  else (0, None))
    store = import_callsets(
        vid, base_dir=ip.base_dir,
        column_partition=(begin, end),
        treat_deletions_as_intervals=ip.treat_deletions_as_intervals)
    if ip.produce_tiledb_array and ip.column_partitions:
        part = ip.column_partitions[rank] if rank < len(
            ip.column_partitions) else {}
        workspace = part.get("workspace", "")
        array_name = part.get("array_name", part.get("array", ""))
        if workspace and array_name:
            if not ws.is_workspace(workspace):
                ws.create_workspace(workspace)
            import os as _os
            exists = _os.path.isdir(_os.path.join(workspace, array_name))
            if exists and ip.fail_if_updating:
                raise RuntimeError(
                    f"Array {workspace}/{array_name} exists and "
                    "fail_if_updating is set (load_operators.cc:151-153)")
            if ip.delete_and_create_tiledb_array:
                ws.delete_array(workspace, array_name)
            ws.write_fragment(workspace, array_name, store)
            if ip.consolidate_after_load:
                ws.consolidate_array(workspace, array_name)
    if ip.produce_combined_vcf:
        from ..core.config import INT64_MAX
        qp = QueryParams()
        qp.base_dir = ip.base_dir
        qp.attributes = []
        # combine clamped to the partition interval
        # (load_operators.cc:398-408)
        hi = end if end is not None else INT64_MAX - 1
        qp.column_ranges = [[(begin, hi)]]
        qc = qdriver.make_query_config(qp, vid)
        text = qdriver.run_vcf_query(
            store, qc, qp, vid,
            template_path=ip.resolve(ip.vcf_header_filename)
            if ip.vcf_header_filename else None,
            reference_path=ip.resolve(ip.reference_genome)
            if ip.reference_genome else None)
        out.write(text)


def split_files(loader_json: str, output_dir: str) -> None:
    """--split-files: pre-split each input VCF into per-partition files
    (reference vcf2tiledb.cc:118-151) so each rank reads only its slice.

    Records intersecting a partition's column range (including spanning
    records, which the importer replays at partition begin) are written
    with the full header to <output_dir>/partition_<i>/<basename>."""
    from ..vcf.reader import open_text
    ip = ImportParams.from_file(loader_json, 0)
    vid = VidMapper.from_files(ip.resolve(ip.vid_mapping_file),
                               ip.resolve(ip.callset_mapping_file))
    parts = []
    for r in range(len(ip.column_partitions)):
        b, e = ip.partition_bounds(r)
        parts.append((b, e if e is not None else 2**63 - 2))
    from ..store.import_pipeline import _resolve_input
    files = sorted({cs.filename for cs in vid.callsets.values()})
    for fname in files:
        path = _resolve_input(fname, ip.base_dir, vid)
        outs = []
        for i, _ in enumerate(parts):
            d = os.path.join(output_dir, f"partition_{i}")
            os.makedirs(d, exist_ok=True)
            base = os.path.basename(fname)
            if base.endswith(".gz"):
                base = base[:-3]
            outs.append(open(os.path.join(d, base), "w"))
        fobj = open_text(path)
        try:
            for line in fobj:
                if line.startswith("#"):
                    for o in outs:
                        o.write(line if line.endswith("\n")
                                else line + "\n")
                    continue
                cols = line.split("\t", 8)
                contig, pos = cols[0], int(cols[1])
                col = vid.contig_offset(contig) + pos - 1
                end = col
                info = cols[7] if len(cols) > 7 else ""
                for kv in info.split(";"):
                    if kv.startswith("END="):
                        end = vid.contig_offset(contig) + int(kv[4:]) - 1
                        break
                ref = cols[3] if len(cols) > 3 else ""
                end = max(end, col + max(len(ref) - 1, 0))
                for (b, e), o in zip(parts, outs):
                    if col <= e and end >= b:
                        o.write(line if line.endswith("\n")
                                else line + "\n")
        finally:
            fobj.close()
            for o in outs:
                o.close()


def main(argv=None):
    p = argparse.ArgumentParser(prog="vcf2gdb")
    p.add_argument("loader_json")
    p.add_argument("--rank", "-r", type=int, default=0,
                   help="column partition index (MPI-rank equivalent)")
    p.add_argument("--split-files", dest="split_output_dir", default=None,
                   metavar="DIR",
                   help="split input VCFs per column partition into DIR "
                        "instead of importing (vcf2tiledb.cc:118-151)")
    args = p.parse_args(argv)
    import json as _json
    try:
        if args.split_output_dir:
            split_files(args.loader_json, args.split_output_dir)
            return
        run_import(args.loader_json, args.rank)
    except FileNotFoundError as e:
        raise SystemExit(f"vcf2gdb: file not found: {e.filename or e}")
    except _json.JSONDecodeError as e:
        raise SystemExit(f"vcf2gdb: malformed JSON in "
                         f"{args.loader_json}: {e}")
    from ..core import profile
    profile.maybe_report()  # GENOMICSDB_TPU_PROFILE=1 timer report


if __name__ == "__main__":
    main()
