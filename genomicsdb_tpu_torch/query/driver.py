"""Query driver on the port: ties configs + store + operators together.

The host query types (`run_calls_query`, `run_vcf_query`, the sequential
combined-gVCF oracle, `run_java_vcf_query`, `run_variants_query`) and
the config helpers are copies of those of `genomicsdb_tpu.query.driver`.
The combined-gVCF block engine (`run_vcf_query_block`,
`iter_vcf_query_block`, the paged `run_vcf_query_paged`) runs the
port's device combine, with an explicit torch `device` on every entry
point; it streams an out-of-core store in column windows and serves
repeated queries of a store from the materialized serving index, as
the JAX driver does.
"""

from __future__ import annotations

from typing import List, Optional

from ..core import profile
from ..core.config import ImportParams, INT64_MAX, QueryConfig, QueryParams
from ..core.vid import VidMapper
from ..ops.store_block import record_starts
from ..store.columnar import ColumnarStore
from ..store.import_pipeline import import_callsets
from ..vcf.fasta import ReferenceGenome
from ..vcf.header import (build_header_lines, chrom_line,
                          header_lines_cached, load_template)
from . import json_output
from . import serving_index as si
from .block_writer import render_block_vcf_pipelined
from .scan import scan_and_operate
from .vcf_writer import CombineToVCF


def load_vid_for_query(qp: QueryParams,
                       ip: Optional[ImportParams]) -> VidMapper:
    vid_file = qp.vid_mapping_file or (ip.vid_mapping_file if ip else "")
    callset_file = qp.callset_mapping_file or (
        ip.callset_mapping_file if ip else "")
    vid_path = (qp.resolve(vid_file) if qp.vid_mapping_file
                else ip.resolve(vid_file))
    cs_path = (qp.resolve(callset_file) if qp.callset_mapping_file
               else (ip.resolve(callset_file) if ip else callset_file))
    return VidMapper.from_files(vid_path, cs_path)


def build_store_from_loader(ip: ImportParams, vid: VidMapper,
                            rank: int = 0) -> ColumnarStore:
    begin, end = ip.partition_bounds(rank) if ip.column_partitions \
        else (0, None)
    return import_callsets(
        vid, base_dir=ip.base_dir,
        column_partition=(begin, end if ip.column_partitions else None),
        treat_deletions_as_intervals=ip.treat_deletions_as_intervals)


def make_query_config(qp: QueryParams, vid: VidMapper) -> QueryConfig:
    schema_attrs = vid.schema_attribute_names(import_id="ID" in vid.fields)
    return QueryConfig(vid, qp, schema_attrs)


def run_calls_query(store: ColumnarStore, qc: QueryConfig) -> str:
    return json_output.print_calls_json(store, qc)


def run_vcf_query(store: ColumnarStore, qc: QueryConfig, qp: QueryParams,
                  vid: VidMapper,
                  template_path: Optional[str] = None,
                  reference_path: Optional[str] = None) -> str:
    """--produce-Broad-GVCF through the sequential engine (the
    per-record oracle): header + combined records."""
    ref_genome = ReferenceGenome(reference_path) if reference_path else None
    sample_names = [vid.callset_name(r) for r in qc.rows_to_query]
    # any vid field can appear as a FILTER id (PASS/LowQual have no
    # vcf_field_class in the test vids); map every global field idx
    filter_names = {info.field_idx: name
                    for name, info in vid.fields.items()}
    op = CombineToVCF(qc, vid, ref_genome, sample_names,
                      filter_name_by_field_idx=filter_names)
    out_lines: List[str] = []
    if template_path:
        template = load_template(template_path)
        out_lines.extend(build_header_lines(template, vid, qc))
        out_lines.append(chrom_line(sample_names, qc.sites_only_query))
    intervals = qc.column_intervals if qc.column_intervals else [None]
    with profile.span("Combined-gVCF-production"):
        for iv in intervals:
            scan_and_operate(store, qc, op.operate, iv,
                             handle_spanning_deletions=True)
    out_lines.extend(op.lines)
    if not out_lines:
        return ""
    return "\n".join(out_lines) + "\n"


def run_java_vcf_query(store: ColumnarStore, qc: QueryConfig,
                       qp: QueryParams, vid: VidMapper,
                       template_path: Optional[str] = None,
                       reference_path: Optional[str] = None,
                       sort_samples: bool = False,
                       transform_header: bool = True) -> str:
    """java_vcf query type: htsjdk-rendered combined VCF
    (TestGenomicsDB --query path).  sort_samples reorders sample columns
    alphabetically (the Spark reader's behavior, spark_* goldens);
    transform_header=False keeps the htslib-style header (the spark
    harness pairs the C header with htsjdk records for some configs)."""
    from .java_writer import JavaCombineToVCF, transform_header_lines
    ref_genome = ReferenceGenome(reference_path) if reference_path else None
    sample_names = [vid.callset_name(r) for r in qc.rows_to_query]
    if sort_samples:
        order = sorted(range(len(sample_names)),
                       key=lambda i: sample_names[i])
        qc.rows_to_query = [qc.rows_to_query[i] for i in order]
        sample_names = [sample_names[i] for i in order]
    filter_names = {info.field_idx: name
                    for name, info in vid.fields.items()}
    op = JavaCombineToVCF(qc, vid, ref_genome, sample_names,
                          filter_name_by_field_idx=filter_names)
    out_lines: List[str] = []
    if template_path:
        template = load_template(template_path)
        hdr = build_header_lines(template, vid, qc)
        if transform_header:
            hdr = transform_header_lines(hdr)
        out_lines.extend(hdr)
        out_lines.append(chrom_line(sample_names, qc.sites_only_query))
    intervals = qc.column_intervals if qc.column_intervals else [None]
    for iv in intervals:
        scan_and_operate(store, qc, op.operate, iv,
                         handle_spanning_deletions=True)
    out_lines.extend(op.lines)
    if not out_lines:
        return ""
    return "\n".join(out_lines) + "\n"


def run_variants_query(store: ColumnarStore, qc: QueryConfig) -> str:
    """Range query (gt_get_column_interval + GA4GH merge), default JSON."""
    from .variants_path import gt_get_column_interval
    variants = []
    intervals = qc.column_intervals if qc.column_intervals \
        else [(0, INT64_MAX - 1)]
    for iv in intervals:
        variants.extend(gt_get_column_interval(store, qc, iv))
    return json_output.print_variants_json(variants, qc)


def run_vcf_query_block(store, qc: QueryConfig, qp: QueryParams,
                        vid: VidMapper, device, template_path=None,
                        reference_path=None, max_merged: int = 4,
                        max_records_per_block: int = 65536,
                        pack: Optional[bool] = None, mesh=None) -> str:
    """--produce-Broad-GVCF via the batched device pipeline on `device`.
    Byte-identical to the sequential `run_vcf_query`.  `pack` (None: on
    for a CUDA device) selects the narrow kernel and the packed fetch,
    `mesh` the sharded combine over a mesh of rank processes
    (block_writer.render_block_vcf_pipelined): then only the mesh's
    first rank gets the records, the others the header alone."""
    out_lines = list(iter_vcf_query_block(
        store, qc, qp, vid, device, template_path=template_path,
        reference_path=reference_path, max_merged=max_merged,
        max_records_per_block=max_records_per_block, coalesce=True,
        pack=pack, mesh=mesh))
    if not out_lines:
        return ""
    with profile.span("query.join"):
        return "\n".join(out_lines) + "\n"


def iter_vcf_query_block(store, qc: QueryConfig, qp: QueryParams,
                         vid: VidMapper, device, template_path=None,
                         reference_path=None, max_merged: int = 4,
                         max_records_per_block: int = 65536,
                         coalesce: bool = False,
                         pack: Optional[bool] = None, mesh=None):
    """Lazy form of run_vcf_query_block: yields header + record lines
    chunk by chunk (record-aligned blocks), so streaming consumers
    (CombinedRecordStream, the socket stream server) ride the block
    engine on `device` without materializing the whole result.

    `store` may be a ColumnarStore (in-RAM / memory-mapped) or an
    out-of-core fragment_v2.OocArray: then each interval is served in
    memory-bounded column windows (segment_size granularity) counted in
    `iter_vcf_query_block.ooc_windows`; each window is a store of its
    own, so its layout and device slabs go with it, and the pipelined
    chunks keep at most the previous window alive.  Window edges fall
    on cell-start columns, so the output is byte-identical to an in-RAM
    query.  A ColumnarStore consults the serving index first, unless
    the combine runs on a `mesh` (as in the JAX driver)."""
    from ..store.fragment_v2 import OocArray
    ref_genome = ReferenceGenome(reference_path) if reference_path else None
    sample_names = [vid.callset_name(r) for r in qc.rows_to_query]
    filter_names = {info.field_idx: name
                    for name, info in vid.fields.items()}
    if template_path:
        yield from header_lines_cached(template_path, vid, qc)
        yield chrom_line(sample_names, qc.sites_only_query)
    intervals = qc.column_intervals if qc.column_intervals \
        else [(0, INT64_MAX - 2)]
    if isinstance(store, OocArray):
        lo0, hi0 = store.column_bounds()
        for iv in intervals:
            # clip to the data's column bounds: no record can render
            # outside them, and windows must not walk empty space
            lo, hi = max(int(iv[0]), lo0), min(int(iv[1]), hi0)
            if lo > hi:
                continue
            for wlo, whi, wstore in store.windows((lo, hi)):
                iter_vcf_query_block.ooc_windows += 1
                yield from _iter_interval_blocks(
                    wstore, (wlo, whi), qc, qp, vid, device, ref_genome,
                    reference_path, filter_names, max_merged,
                    max_records_per_block, coalesce, pack, mesh)
        return
    # materialized serving: repeated queries of one signature against an
    # immutable store slice the full-store combined text instead of
    # recomputing (query/serving_index.py — the GATK/Spark split-serving
    # pattern); the build is non-reentrant, so the index's own
    # full-store build runs through the engine path below
    idx_srv = None
    if isinstance(store, ColumnarStore) and mesh is None:
        idx_srv = si.lookup_for_query(store, qc, qp, vid, device,
                                      template_path, reference_path,
                                      pack=pack)
    for iv in intervals:
        if idx_srv is not None:
            def edge_fn(lo, hi):
                return si.engine_record_lines(store, qc, qp, vid, device,
                                              reference_path, lo, hi,
                                              pack=pack)
            served = idx_srv.serve_text(int(iv[0]), int(iv[1]), edge_fn,
                                        si.make_ref_base(ref_genome))
            if coalesce:
                yield from served
            else:
                for chunk in served:
                    yield from (ln for ln in chunk.split("\n") if ln)
            continue
        yield from _iter_interval_blocks(
            store, iv, qc, qp, vid, device, ref_genome, reference_path,
            filter_names, max_merged, max_records_per_block, coalesce,
            pack, mesh)


iter_vcf_query_block.ooc_windows = 0


def _iter_interval_blocks(store, iv, qc, qp, vid, device, ref_genome,
                          reference_path, filter_names, max_merged,
                          max_records_per_block, coalesce, pack,
                          mesh=None):
    """Record lines of ONE interval on ONE (window) store — the chunked,
    pipelined block-engine body shared by in-RAM and out-of-core
    stores."""

    def make_seq_fn():
        def seq(lo, hi):
            sub_qp = QueryParams()
            sub_qp.__dict__.update(qp.__dict__)
            sub_qp.scan_full = False
            sub_qp.column_ranges = [[(lo, hi)]]
            sub_qc = make_query_config(sub_qp, vid)
            sub_qc.rows_to_query = list(qc.rows_to_query)
            text = run_vcf_query(store, sub_qc, sub_qp, vid,
                                 template_path=None,
                                 reference_path=reference_path)
            return [ln for ln in text.splitlines() if ln]
        return seq

    # genome-scale intervals: chunk at RECORD boundaries so block
    # tensors stay bounded; sub-interval [starts[i], starts[j]-1]
    # yields exactly records i..j-1 (chunk edges are event starts,
    # so no record is split)
    starts = record_starts(store, qc, iv)
    # width-aware chunk cap (~256k cells per chunk), the JAX package's
    # rule off the TPU, kept on both devices of the port for now
    S_w = len(qc.rows_to_query)
    if S_w:
        max_records_per_block = min(max_records_per_block,
                                    max(1024, (1 << 18) // S_w))
    if len(starts) <= max_records_per_block:
        chunks = [(iv, 0, len(starts))]
        # bucket-pad small blocks to power-of-two record counts (and
        # coarse cell counts), as the JAX driver does; padding leaves
        # the output unchanged
        pad_kw = {}
        if len(starts):
            bucket = 32 if S_w >= 512 else 64
            while bucket < len(starts):
                bucket *= 2
            pad_kw = {"pad_records": bucket, "pad_cells_to": 256}
    else:
        chunks = []
        for i in range(0, len(starts), max_records_per_block):
            lo = int(starts[i])
            j = i + max_records_per_block
            hi = int(starts[j]) - 1 if j < len(starts) else int(iv[1])
            chunks.append(((lo, hi), i, min(j, len(starts))))
        pad_kw = {"pad_records": max_records_per_block,
                  "pad_cells_to": 256}
    # software pipeline: launch chunk k+1's device combine before
    # rendering chunk k's text, so the device computes while the host
    # formats
    pending = None
    for civ, i, j in chunks:
        kw = pad_kw
        if mesh is not None:
            civ, kw = _mesh_span(mesh, starts, civ, i, j, pad_kw)
        g = render_block_vcf_pipelined(
            store, qc, vid, civ, device, ref_genome=ref_genome,
            max_merged=max_merged, sequential_fn=make_seq_fn(),
            filter_name_by_field_idx=filter_names, coalesce=coalesce,
            pack=pack, mesh=mesh, **kw)
        next(g)
        if pending is not None:
            yield from next(pending)
            _release(pending)
        pending = g
    if pending is not None:
        yield from next(pending)
        _release(pending)


def _release(chunk) -> None:
    """Close a rendered chunk's generator (timed as the span
    `block.release`): what only its frame still holds, such as the
    block and its host outputs, is freed here rather than wherever the
    last reference happens to drop."""
    with profile.span("block.release"):
        chunk.close()


def _mesh_span(mesh, starts, civ, i: int, j: int, pad_kw: dict):
    """(interval, padding) of this rank's pos span of the chunk `civ`,
    which holds records i..j-1 of `starts`: the pos group's span of
    those records (`sharded.pos_span`), as the sub-interval from
    its first record's start to the next span's start - 1 (the chunk's
    end for the last span), so it yields exactly its records, as a chunk
    does; None for a span without records.  Each span is padded to the
    chunk's padded record count / n_pos."""
    from ..parallel.sharded import pos_span
    lo, hi = pos_span(j - i, mesh)
    kw = dict(pad_kw)
    if "pad_records" in kw:
        kw["pad_records"] = -(-kw["pad_records"] // mesh.n_pos)
    if lo == hi:
        return None, kw
    end = int(starts[i + hi]) - 1 if i + hi < j else int(civ[1])
    return (int(starts[i + lo]), end), kw


def run_vcf_query_paged(store, qc: QueryConfig, qp: QueryParams,
                        vid: VidMapper, device, page_size: int,
                        template_path=None, reference_path=None,
                        pack: Optional[bool] = None):
    """Paged production of the combined VCF on `device` (the
    reference's resumable VariantQueryProcessorScanState + RWBuffer
    '-p page_size' mode, gt_mpi_gather.cc:349-362).  Yields byte pages
    lazily; their concatenation is byte-identical to
    run_vcf_query_block."""
    from .stream import CombinedRecordStream
    stream = CombinedRecordStream(store, qc, qp, vid, device,
                                  template_path, reference_path, pack=pack)
    yield from stream.pages(page_size)
