"""Block-engine query driver on the port (counterpart of the block-engine
part of `genomicsdb_tpu.query.driver`, lines 88-271).

Only the combined-gVCF block engine lives here, with an explicit torch
`device` on every entry point.  The sequential oracle (`run_vcf_query`),
`make_query_config` and the other query types are the JAX driver's
own, which are jax-free and imported unchanged.  The serving index and
out-of-core windows are not ported yet (the port's `gdb_query` serves an
out-of-core store from its memory-mapped view).
"""

from __future__ import annotations

from typing import Optional

from genomicsdb_tpu.core.config import INT64_MAX, QueryConfig, QueryParams
from genomicsdb_tpu.core.vid import VidMapper
from genomicsdb_tpu.query.driver import make_query_config, run_vcf_query
from genomicsdb_tpu.vcf.fasta import ReferenceGenome
from genomicsdb_tpu.vcf.header import chrom_line, header_lines_cached

from ..ops.store_block import record_starts
from .block_writer import render_block_vcf_pipelined


def run_vcf_query_block(store, qc: QueryConfig, qp: QueryParams,
                        vid: VidMapper, device, template_path=None,
                        reference_path=None, max_merged: int = 4,
                        max_records_per_block: int = 65536,
                        pack: Optional[bool] = None) -> str:
    """--produce-Broad-GVCF via the batched device pipeline on `device`.
    Byte-identical to the sequential `run_vcf_query`.  `pack` (None: on
    for a CUDA device) selects the narrow kernel and the packed fetch
    (block_writer.render_block_vcf_pipelined)."""
    out_lines = list(iter_vcf_query_block(
        store, qc, qp, vid, device, template_path=template_path,
        reference_path=reference_path, max_merged=max_merged,
        max_records_per_block=max_records_per_block, coalesce=True,
        pack=pack))
    if not out_lines:
        return ""
    return "\n".join(out_lines) + "\n"


def iter_vcf_query_block(store, qc: QueryConfig, qp: QueryParams,
                         vid: VidMapper, device, template_path=None,
                         reference_path=None, max_merged: int = 4,
                         max_records_per_block: int = 65536,
                         coalesce: bool = False,
                         pack: Optional[bool] = None):
    """Lazy form of run_vcf_query_block: yields header + record lines
    chunk by chunk (record-aligned blocks)."""
    ref_genome = ReferenceGenome(reference_path) if reference_path else None
    sample_names = [vid.callset_name(r) for r in qc.rows_to_query]
    filter_names = {info.field_idx: name
                    for name, info in vid.fields.items()}
    if template_path:
        yield from header_lines_cached(template_path, vid, qc)
        yield chrom_line(sample_names, qc.sites_only_query)
    intervals = qc.column_intervals if qc.column_intervals \
        else [(0, INT64_MAX - 2)]
    for iv in intervals:
        yield from _iter_interval_blocks(
            store, iv, qc, qp, vid, device, ref_genome, reference_path,
            filter_names, max_merged, max_records_per_block, coalesce,
            pack)


def _iter_interval_blocks(store, iv, qc, qp, vid, device, ref_genome,
                          reference_path, filter_names, max_merged,
                          max_records_per_block, coalesce, pack):
    """Record lines of ONE interval — the chunked, pipelined block-engine
    body."""

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
        chunks = [iv]
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
            chunks.append((lo, hi))
        pad_kw = {"pad_records": max_records_per_block,
                  "pad_cells_to": 256}
    # software pipeline: launch chunk k+1's device combine before
    # rendering chunk k's text, so the device computes while the host
    # formats
    pending = None
    for civ in chunks:
        g = render_block_vcf_pipelined(
            store, qc, vid, civ, device, ref_genome=ref_genome,
            max_merged=max_merged, sequential_fn=make_seq_fn(),
            filter_name_by_field_idx=filter_names, coalesce=coalesce,
            pack=pack, **pad_kw)
        next(g)
        if pending is not None:
            yield from next(pending)
        pending = g
    if pending is not None:
        yield from next(pending)
