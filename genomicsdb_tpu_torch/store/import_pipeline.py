"""gVCF -> columnar-store import pipeline.

Reimplements the reference's loader semantics (VCF2Binary field conversion,
column-major merge, overlap truncation) on the text-VCF edge:
  * per-callset cell production: src/main/cpp/src/vcf/vcf2binary.cc:991-1160
  * deletions-as-intervals END:  vcf2binary.cc:1046-1060
  * GT phase interleaving:       vcf2binary.cc (convert_field_to_tiledb,
                                 m_store_phase_information_for_GT)
  * INFO sum-op division among samples of multi-sample VCFs:
                                 vcf2binary.h:35-53
  * column-major k-way merge:    tiledb_loader.cc:845-964
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import formats
from ..core import known_fields as kf
from ..core.vid import VidMapper, FieldInfo
from ..vcf.reader import VCFFile, VCFRecord
from .columnar import ColumnarStore, build_store

NON_REF_REPR = "&"  # TILEDB_NON_REF_VARIANT_REPRESENTATION (gt_common.h:46)
ALT_SEPARATOR = "|"  # TILEDB_ALT_ALLELE_SEPARATOR


def _is_sum_like(op) -> bool:
    """is_VCF_field_combine_operation_sum (vid_mapper.cc:1189-1192):
    fields divided among samples of a multi-sample VCF at import."""
    return op in (kf.OP_SUM, kf.OP_DP, kf.OP_ELEMENT_WISE_SUM,
                  kf.OP_HISTOGRAM_SUM)


def is_symbolic_allele(allele: str) -> bool:
    """Reference: VariantUtils::is_symbolic_allele — symbolic/structural."""
    return (len(allele) > 0
            and (allele[0] == "<" or allele[-1] == ">"
                 or allele == "*"
                 or allele[0] == "[" or allele[-1] == "["
                 or allele[0] == "]" or allele[-1] == "]"))


def _parse_int_list(text: str) -> List[int]:
    out = []
    for tok in text.split(","):
        out.append(formats.INT_MISSING if tok in (".", "") else int(tok))
    return out


def _parse_float_list(text: str) -> List[float]:
    out = []
    for tok in text.split(","):
        out.append(formats.FLOAT_MISSING if tok in (".", "")
                   else np.float32(tok))
    return out


def _parse_gt(text: str, store_phase: bool) -> Optional[List[int]]:
    """GT string -> stored int vector (allele idxs, optionally interleaved
    with phase flags).  '.' alleles -> -1."""
    if text == "" or text is None:
        return None
    tokens: List[Tuple[int, int]] = []  # (allele, phased_wrt_previous)
    cur = []
    phased = 0
    vals: List[int] = []
    seps: List[int] = []
    buf = ""
    for ch in text:
        if ch in "/|":
            vals.append(-1 if buf in (".", "") else int(buf))
            seps.append(1 if ch == "|" else 0)
            buf = ""
        else:
            buf += ch
    vals.append(-1 if buf in (".", "") else int(buf))
    _ = (tokens, cur, phased)
    if store_phase:
        out = [vals[0]]
        for i in range(1, len(vals)):
            out.append(seps[i - 1])
            out.append(vals[i])
        return out
    return vals


def parse_multid_string(text: str, info: FieldInfo,
                        tuple_index: int) -> List[np.ndarray]:
    """Parse a 2-D field serialized as a delimited string.

    E.g. AS_RAW_MQ "8.000,10.000|28.000|31.000" with delimiters ["|", ","].
    For tuple types (histogram fields like AS_RAW_MQRankSum
    "0.600,6,0.800,2|..."), elements alternate between tuple members; select
    member `tuple_index`.
    Reference: genomicsdb_multid_vector_field.cc (parse_and_store_numeric).
    """
    d0 = info.length.delimiter(0)
    d1 = info.length.delimiter(1) if info.length.num_dimensions > 1 else ","
    etype = info.element_types[tuple_index]
    n_tuple = info.num_elements_in_tuple
    out: List[np.ndarray] = []
    for part in text.split(d0):
        if part == "":
            out.append(np.zeros(0, dtype=np.float32 if etype == "float"
                                else np.int32))
            continue
        toks = part.split(d1)
        sel = toks[tuple_index::n_tuple] if n_tuple > 1 else toks
        if etype == "float":
            out.append(np.asarray([np.float32(t) if t not in (".", "")
                                   else formats.FLOAT_MISSING for t in sel],
                                  dtype=np.float32))
        else:
            out.append(np.asarray([int(float(t)) if t not in (".", "")
                                   else formats.INT_MISSING for t in sel],
                                  dtype=np.int32))
    return out


class VCFCellConverter:
    """Converts one VCF file's records into per-callset cell dicts.

    Equivalent of VCF2Binary (vcf2binary.h:219)."""

    def __init__(self, vcf: VCFFile, vid: VidMapper,
                 idx_to_row: Dict[int, int],
                 treat_deletions_as_intervals: bool = True):
        self.vcf = vcf
        self.vid = vid
        # local sample index in file -> array row (callsets use idx_in_file,
        # NOT the sample name: reference vcf2binary.cc
        # m_local_callset_idx_to_tiledb_row_idx)
        self.idx_to_row = idx_to_row
        self.treat_deletions = treat_deletions_as_intervals
        self.import_id = "ID" in vid.fields
        # FILTER name -> global vid field idx
        self.filter_idx = {name: vid.fields[name].field_idx
                           for name in vid.fields}

    def _end_column(self, rec: VCFRecord, col: int) -> int:
        end_info = rec.info.get("END")
        if end_info is not None:
            return self.vid.contigs[rec.chrom].offset + int(end_info) - 1
        if self.treat_deletions:
            ref_len = len(rec.ref)
            for alt in rec.alts:
                # bcf_get_variant_type == VCF_INDEL && ref longer
                if (not is_symbolic_allele(alt) and len(alt) != ref_len
                        and ref_len > len(alt)):
                    return col + ref_len - 1
        return col

    def convert(self) -> List[dict]:
        cells: List[dict] = []
        hdr = self.vcf.header
        nsamples = len(hdr.samples)
        sample_rows = [self.idx_to_row.get(i) for i in range(nsamples)]
        for rec in self.vcf:
            col = self.vid.flatten_position(rec.chrom, rec.pos)
            end = self._end_column(rec, col)
            alt_serialized = ALT_SEPARATOR.join(
                NON_REF_REPR if a == "<NON_REF>" else a for a in rec.alts)
            for local_idx, row in enumerate(sample_rows):
                if row is None:
                    continue
                cell: dict = {"row": row, "col": col, "end": end}
                cell["REF"] = rec.ref
                cell["ALT"] = alt_serialized
                if self.import_id:
                    rid = rec.rec_id
                    if rid and rid != ".":
                        cell["ID"] = rid
                if rec.qual is not None:
                    cell["QUAL"] = [np.float32(rec.qual)]
                if rec.filters:
                    cell["FILTER"] = [self.filter_idx[f] for f in rec.filters
                                      if f in self.filter_idx]
                else:
                    cell["FILTER"] = []
                self._convert_fields(rec, cell, local_idx, nsamples)
                cells.append(cell)
        return cells

    def _convert_fields(self, rec: VCFRecord, cell: dict, local_idx: int,
                        nsamples: int):
        vid = self.vid
        for name in vid.field_order:
            info = vid.fields[name]
            if name == "END" or info.is_filter and not (info.is_info or
                                                        info.is_format):
                continue
            if info.is_composite():
                continue  # handled via flattened element fields
            if info.is_flattened:
                parent = vid.fields[info.parent_name]
                raw = rec.info.get(parent.vcf_name) if parent.is_info else None
                if raw is None:
                    continue
                vals = parse_multid_string(raw, parent, info.tuple_index)
                if _is_sum_like(parent.combine_op) and nsamples > 1:
                    divide_all = parent.combine_op != kf.OP_HISTOGRAM_SUM
                    if divide_all or info.tuple_index == 1:
                        vals = [self._divide(v, nsamples, local_idx)
                                for v in vals]
                cell[name] = vals
                continue
            if info.is_info:
                if info.vcf_name not in rec.info:
                    continue
                raw = rec.info[info.vcf_name]
                if info.type == "flag":
                    cell[name] = [1]
                    continue
                if info.vcf_type == "string" and info.length.num_dimensions > 1:
                    vals = parse_multid_string(raw, info, 0)
                    if _is_sum_like(info.combine_op) and nsamples > 1:
                        vals = [self._divide(v, nsamples, local_idx)
                                for v in vals]
                    cell[name] = vals
                    continue
                if info.type == "int":
                    v = np.asarray(_parse_int_list(raw), dtype=np.int32)
                elif info.type == "float":
                    v = np.asarray(_parse_float_list(raw), dtype=np.float32)
                else:  # char/string INFO
                    cell[name] = raw
                    continue
                if self._all_missing(v, info.type):
                    continue
                if _is_sum_like(info.combine_op) and nsamples > 1:
                    v = self._divide(v, nsamples, local_idx)
                cell[name] = v
            elif info.is_format:
                if info.vcf_name not in rec.fmt:
                    continue
                fi = rec.fmt.index(info.vcf_name)
                svals = rec.sample_values[local_idx]
                if fi >= len(svals):
                    continue
                raw = svals[fi]
                if info.vcf_name == "GT":
                    g = _parse_gt(raw, info.length.contains_phase())
                    if g is not None:
                        cell[name] = np.asarray(g, dtype=np.int32)
                    continue
                if raw == "" or raw == ".":
                    continue
                if info.type == "int":
                    v = np.asarray(_parse_int_list(raw), dtype=np.int32)
                    if self._all_missing(v, "int"):
                        continue
                    cell[name] = v
                elif info.type == "float":
                    v = np.asarray(_parse_float_list(raw), dtype=np.float32)
                    if self._all_missing(v, "float"):
                        continue
                    cell[name] = v
                else:  # char string FORMAT (PGT, PID)
                    cell[name] = raw

    @staticmethod
    def _divide(v: np.ndarray, nsamples: int, local_idx: int) -> np.ndarray:
        """divide_up_among_samples (vcf2binary.h:35-53)."""
        if v.dtype == np.int32:
            out = v // nsamples + (local_idx < (v % nsamples)).astype(np.int32)
            # preserve missing sentinels
            out = np.where(v == formats.INT_MISSING, v, out)
            return out.astype(np.int32)
        bits = v.view(np.uint32)
        miss = bits == formats.FLOAT_MISSING_BITS
        out = (v / np.float32(nsamples)).astype(np.float32)
        out[miss] = v[miss]
        return out

    @staticmethod
    def _all_missing(v: np.ndarray, etype: str) -> bool:
        """Whole-field-missing check: first element missing => invalid
        (reference convert_field_to_tiledb: num_values==1 && missing)."""
        if len(v) == 0:
            return True
        if len(v) == 1:
            if etype == "int":
                return v[0] == formats.INT_MISSING
            return v.view(np.uint32)[0] == formats.FLOAT_MISSING_BITS
        return False


def parse_csv_cells(path: str, vid: VidMapper) -> List[dict]:
    """Parse the reference's CSV cell format (tiledb_loader_text_file.cc):

    row,begin,end,REF,ALT('|'-joined,'&'),QUAL,FILTER_count[,ids...],then
    per vid-order field: fixed fields as k cells (empty=missing element),
    var-length numerics as count[,values...], strings as one raw cell.
    """
    cells: List[dict] = []
    field_seq = []
    for name in vid.field_order:
        info = vid.fields[name]
        if name in ("END", "REF", "ALT", "QUAL", "FILTER"):
            continue
        if not (info.is_info or info.is_format) or info.is_composite():
            continue
        field_seq.append((name, info))
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            toks = line.split(",")
            it = iter(toks)

            def nxt():
                return next(it)

            cell: dict = {"row": int(nxt()), "col": int(nxt()),
                          "end": int(nxt())}
            cell["REF"] = nxt()
            alt = nxt()
            cell["ALT"] = alt
            qual = nxt()
            if qual != "":
                cell["QUAL"] = [np.float32(qual)]
            n_flt = nxt()
            flt = []
            for _ in range(int(n_flt) if n_flt != "" else 0):
                flt.append(int(nxt()))
            cell["FILTER"] = flt
            for name, info in field_seq:
                is_float = info.type == "float"
                if info.type in ("char", "string"):
                    v = nxt()
                    if v != "":
                        cell[name] = v
                    continue
                if info.type == "flag":
                    v = nxt()
                    if v not in ("", "0"):
                        cell[name] = [1]
                    continue
                if info.length.is_fixed() and info.length.num_dimensions == 1:
                    k = info.length.fixed_len
                    vals = [nxt() for _ in range(k)]
                    if all(v == "" for v in vals):
                        continue
                    if is_float:
                        cell[name] = np.asarray(
                            [np.float32(v) if v != "" else
                             formats.FLOAT_MISSING for v in vals],
                            dtype=np.float32)
                    else:
                        cell[name] = np.asarray(
                            [int(v) if v != "" else formats.INT_MISSING
                             for v in vals], dtype=np.int32)
                    continue
                cnt_tok = nxt()
                cnt = int(cnt_tok) if cnt_tok != "" else 0
                vals = [nxt() for _ in range(cnt)]
                if cnt == 0:
                    continue
                if is_float:
                    cell[name] = np.asarray(
                        [np.float32(v) if v != "" else formats.FLOAT_MISSING
                         for v in vals], dtype=np.float32)
                else:
                    cell[name] = np.asarray(
                        [int(v) if v != "" else formats.INT_MISSING
                         for v in vals], dtype=np.int32)
            cells.append(cell)
    return cells


def field_specs_for_vid(vid: VidMapper, import_id: bool) -> Dict[str, tuple]:
    """Map each schema attribute to (kind, dtype, fixed_len)."""
    specs: Dict[str, tuple] = {
        "REF": ("str", "bytes", 1),
        "ALT": ("str", "bytes", 1),
        "QUAL": ("fixed", "float32", 1),
        "FILTER": ("ragged", "int32", 1),
    }
    if import_id:
        specs["ID"] = ("str", "bytes", 1)
    for name in vid.field_order:
        info = vid.fields[name]
        if name in specs or name == "END" or info.is_composite():
            continue
        if not (info.is_info or info.is_format):
            continue
        if info.length.num_dimensions > 1:
            specs[name] = ("ragged2d",
                           "float32" if info.type == "float" else "int32", 1)
        elif info.type in ("char", "string"):
            specs[name] = ("str", "bytes", 1)
        elif info.length.is_fixed():
            specs[name] = ("fixed",
                           "float32" if info.type == "float" else "int32",
                           info.length.fixed_len)
        else:
            specs[name] = ("ragged",
                           "float32" if info.type == "float" else "int32", 1)
    return specs


def _resolve_input(filename: str, base_dir: str, vid: VidMapper) -> str:
    """Resolve a callset filename: absolute, or relative to the loader
    JSON's directory, the CWD, or walk-ups from the callset JSON's
    directory (the reference resolves against the process CWD)."""
    import os
    if os.path.isabs(filename):
        return filename
    candidates = []
    if base_dir:
        candidates.append(os.path.join(base_dir, filename))
    candidates.append(filename)
    d = vid.callsets_dir
    for _ in range(3):
        if not d:
            break
        candidates.append(os.path.join(d, filename))
        d = os.path.dirname(d)
    for c in candidates:
        if os.path.isfile(c):
            return c
    return candidates[0] if candidates else filename


def import_callsets(vid: VidMapper, base_dir: str = "",
                    column_partition: Tuple[int, int] = (0, None),
                    treat_deletions_as_intervals: bool = True,
                    ) -> ColumnarStore:
    """Import all files referenced by the callset map into one store.

    Equivalent of VCF2TileDBLoader::read_all with a LoaderArrayWriter
    (tiledb_loader.cc:589-715): per-file conversion, global column-major
    merge, overlap truncation happens in build_store.
    """
    import os
    files: Dict[str, List[Tuple[int, int]]] = {}
    for cs in vid.callsets.values():
        files.setdefault(cs.filename, []).append((cs.idx_in_file,
                                                  cs.row_idx))
    from ..core import profile
    # native columnar-direct fast path (falls back per file)
    if os.environ.get("GENOMICSDB_TPU_NO_NATIVE", "") in ("", "0"):
        with profile.span("Fetch-from-VCF"):
            fast = _try_fast_import(files, vid, base_dir, column_partition,
                                    treat_deletions_as_intervals)
        if fast is not None:
            return fast
    all_cells: List[dict] = []
    for filename, samples in files.items():
        path = _resolve_input(filename, base_dir, vid)
        if path.endswith(".csv"):
            all_cells.extend(parse_csv_cells(path, vid))
            continue
        vcf = VCFFile(path)
        conv = VCFCellConverter(vcf, vid, dict(samples),
                                treat_deletions_as_intervals)
        all_cells.extend(conv.convert())
        vcf.close()
    return cells_to_store(all_cells, vid,
                          import_id="ID" in vid.fields,
                          column_partition=column_partition)


def _try_fast_import(files, vid: VidMapper, base_dir: str,
                     column_partition, treat_deletions):
    """Native columnar-direct import of all files; None on fallback."""
    from .fast_import import fast_import_file
    from .columnar import store_take
    from . import workspace as ws
    jobs = []
    for filename, samples in files.items():
        path = _resolve_input(filename, base_dir, vid)
        if path.endswith(".csv"):
            return None
        jobs.append((path, dict(samples)))
    if len(jobs) > 1:
        # parallel per-file conversion (the reference's OpenMP
        # num_parallel_vcf_files fetch, tiledb_loader.cc:363); the
        # native tokenizer/parsers release the GIL
        import concurrent.futures as cf
        import os
        workers = min(4, os.cpu_count() or 1, len(jobs))
        with cf.ThreadPoolExecutor(max_workers=workers) as ex:
            stores = list(ex.map(
                lambda j: fast_import_file(j[0], vid, j[1],
                                           treat_deletions), jobs))
    else:
        stores = [fast_import_file(p, vid, s, treat_deletions)
                  for p, s in jobs]
    if any(st is None for st in stores):
        return None
    if not stores:
        return None
    merged = ws.merge_stores(stores) if len(stores) > 1 else \
        ws.merge_stores([stores[0]])
    merged.num_rows = vid.max_callset_row_idx() + 1
    begin, part_end = column_partition
    if part_end is None:
        part_end = 2**63 - 2
    if begin == 0 and part_end >= 2**63 - 2:
        return merged
    # partition filtering + spanning replay (load_operators.cc:33-79)
    inside = np.nonzero((merged.col >= begin)
                        & (merged.col <= part_end))[0]
    before = np.nonzero(merged.col < begin)[0]
    spanning = []
    if len(before):
        rows_before = merged.row[before]
        for r in np.unique(rows_before):
            ridx = before[rows_before == r]
            last = ridx[-1]  # (col,row)-sorted => last is latest interval
            if merged.end[last] >= begin:
                spanning.append(last)
    spanning.sort(key=lambda i: (merged.col[i], merged.row[i]))
    take = np.concatenate([np.asarray(spanning, dtype=np.int64),
                           inside]).astype(np.int64)
    return store_take(merged, take)


def cells_to_store(all_cells: List[dict], vid: VidMapper,
                   import_id: bool,
                   column_partition: Tuple[int, int] = (0, None)
                   ) -> ColumnarStore:
    begin, part_end = column_partition
    if part_end is None:
        part_end = 2**63 - 2
    if begin > 0 or part_end < 2**63 - 2:
        # Keep cells that intersect the partition; for spanning cells the
        # reference replays them at partition begin (load_operators.cc:33-79):
        # only the LAST spanning interval per row survives.
        spanning: Dict[int, dict] = {}
        inside: List[dict] = []
        for c in sorted(all_cells, key=lambda c: (c["col"], c["row"])):
            if c["col"] > part_end:
                continue
            if c["col"] < begin:
                if c["end"] >= begin:
                    spanning[c["row"]] = c
                else:
                    spanning.pop(c["row"], None)
            else:
                inside.append(c)
        all_cells = sorted(spanning.values(),
                           key=lambda c: (c["col"], c["row"])) + inside
    else:
        all_cells = sorted(all_cells, key=lambda c: (c["col"], c["row"]))
    specs = field_specs_for_vid(vid, import_id)
    attrs = [a for a in vid.schema_attribute_names(import_id)
             if a != "END"]
    num_rows = vid.max_callset_row_idx() + 1
    return build_store(all_cells, attrs, specs, num_rows=num_rows)
