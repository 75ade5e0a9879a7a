"""Native-accelerated columnar-direct VCF import.

The production data loader: tokenizes the VCF record section with the C++
kernels (runtime/native/vcf_kernels.cpp), parses per-sample FORMAT fields
in batched native calls, and assembles `ColumnarStore` columns directly —
no per-cell Python objects.  Per-record work (INFO parsing, ALT strings)
stays in Python; per-(record x sample) work is native.

Falls back (returns None) for vids using 2-D fields or flag INFO fields,
or when the native library is unavailable; callers then use the reference
Python path (import_pipeline.VCFCellConverter).  Equality with the Python
path is asserted in tests/test_fast_import.py.
"""

from __future__ import annotations

import gzip
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import formats
from ..core.vid import VidMapper
from ..runtime import native_loader as nl
from .columnar import ColumnarStore, FieldData
from .import_pipeline import _is_sum_like, field_specs_for_vid

INT_MISSING = formats.INT_MISSING


def _supported(vid: VidMapper, nsamples: int) -> bool:
    for name in vid.field_order:
        info = vid.fields[name]
        if not (info.is_info or info.is_format):
            continue
        if info.is_composite():
            continue      # data imports via the flattened element fields
        if info.length.num_dimensions > 1:
            # text-serialized 2-D INFO fields (allele-specific AS_*
            # annotations, genomicsdb_multid_vector_field.h:87) parse
            # through the vectorized ragged2d path; 2-D FORMAT has no
            # fast path
            if not info.is_info or info.vcf_type != "string":
                return False
    return True


def fast_import_file(path: str, vid: VidMapper,
                     idx_to_row: Dict[int, int],
                     treat_deletions_as_intervals: bool = True
                     ) -> Optional[ColumnarStore]:
    if nl._prefix_lib() is None:
        return None
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\x1f\x8b":          # gzip/bgzf (by magic, not name)
        data = gzip.decompress(data)
    if data[:5] == b"BCF\x02\x02":       # BCF2 input (vcf2binary.cc parity)
        from ..vcf.bcf import bcf_to_text
        data = bcf_to_text(data).encode()
    # split header / records
    hdr_end = data.rfind(b"#CHROM")
    if hdr_end < 0:
        return None
    nl_idx = data.find(b"\n", hdr_end)
    chrom_line = data[hdr_end:nl_idx].decode()
    samples = chrom_line.rstrip("\n").split("\t")[9:]
    if not _supported(vid, len(samples)):
        return None
    records = data[nl_idx + 1:]
    toks = nl.tokenize_records(records, max_cols=10 + len(samples))
    if toks is None:
        return None
    offs, ncols = toks
    n = len(offs)
    if n == 0:
        return None
    mapped = [(k, idx_to_row[k]) for k in sorted(idx_to_row)
              if k < len(samples)]
    K_s = len(mapped)
    n_cells = n * K_s

    # ---- coordinates ----
    pos, _ = nl.parse_int_lists(records, offs[:, 1].copy(),
                                (offs[:, 2] - 1).copy())
    # contig offsets: intern CHROM spans, resolve one per distinct contig
    chrom_gids, chrom_uniq = nl.intern_spans(records, offs[:, 0].copy(),
                                             (offs[:, 1] - 1).copy())
    uniq_offsets = np.asarray(
        [vid.contigs[records[offs[i, 0]:offs[i, 1] - 1].decode()].offset
         for i in chrom_uniq], dtype=np.int64)
    chrom_off = uniq_offsets[chrom_gids] if n else np.zeros(0, np.int64)
    col = chrom_off + pos - 1

    # ---- REF / ALT / ID / QUAL / FILTER (native per-record kernels) ----
    ref_starts = offs[:, 3].copy()
    ref_ends = (offs[:, 4] - 1).copy()
    ref_blob, ref_offs = nl.extract_spans(records, ref_starts, ref_ends)
    # ALT serialized form ('|' joined, NON_REF -> '&') + deletion flags
    alt_blob, alt_offs, del_flag = nl.transform_alt(
        records, offs[:, 4].copy(), (offs[:, 5] - 1).copy(),
        ref_starts, ref_ends)
    quals, _ = nl.parse_float_lists(records, offs[:, 5].copy(),
                                    (offs[:, 6] - 1).copy())
    import_id = "ID" in vid.fields
    id_blob = id_offs = id_valid_rec = None
    if import_id:
        id_s = offs[:, 2].copy()
        id_e = (offs[:, 3] - 1).copy()
        rec_u8 = np.frombuffer(records, dtype=np.uint8)
        first = rec_u8[np.minimum(id_s, len(records) - 1)] \
            if len(records) else np.zeros(n, np.uint8)
        is_dot = ((id_e - id_s) == 1) & (first == ord("."))
        id_e = np.where(is_dot, id_s, id_e)
        id_blob, id_offs = nl.extract_spans(records, id_s, id_e)
        id_valid_rec = (id_e - id_s) > 0
    # FILTER: intern spans, resolve field-id lists once per distinct span
    f_s = offs[:, 6].copy()
    f_e = (offs[:, 7] - 1).copy()
    f_gids, f_uniq = nl.intern_spans(records, f_s, f_e)
    uniq_filters: List[List[int]] = []
    for i in f_uniq:
        txt = records[f_s[i]:f_e[i]].decode()
        uniq_filters.append(
            [] if txt == "." else
            [vid.fields[f].field_idx for f in txt.split(";")
             if f in vid.fields])
    fu_lens = np.asarray([len(x) for x in uniq_filters], dtype=np.int64)
    fu_vals = np.asarray([v for x in uniq_filters for v in x],
                         dtype=np.int32)
    fu_offs = np.zeros(len(uniq_filters) + 1, dtype=np.int64)
    np.cumsum(fu_lens, out=fu_offs[1:])
    filt_rec_lens = fu_lens[f_gids] if n else np.zeros(0, np.int64)
    filt_rec_offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(filt_rec_lens, out=filt_rec_offs[1:])
    if len(fu_vals):
        filt_rec_vals = np.empty(int(filt_rec_offs[-1]), dtype=np.int32)
        nl.copy_segments(fu_vals, fu_offs[:-1][f_gids], filt_rec_lens,
                         filt_rec_offs[:-1], filt_rec_vals)
    else:
        filt_rec_vals = np.zeros(0, np.int32)

    # ---- INFO key resolution (one native pass over the INFO column) ----
    specs = field_specs_for_vid(vid, import_id)
    attrs = [a for a in vid.schema_attribute_names(import_id)
             if a != "END"]
    base_fields = {"REF", "ALT", "ID", "QUAL", "FILTER"}
    info_attr = [(a, vid.fields[a]) for a in attrs
                 if a not in base_fields and vid.fields.get(a) is not None
                 and vid.fields[a].is_info]
    # dedupe keys: flattened tuple elements (AS_RAW_MQRankSum_f0/_f1)
    # share one parent INFO key — the native scan must see it ONCE
    info_keys = ["END"]
    key_col: Dict[str, int] = {"END": 0}
    attr_col = []
    for _, fi in info_attr:
        c = key_col.get(fi.vcf_name)
        if c is None:
            c = key_col[fi.vcf_name] = len(info_keys)
            info_keys.append(fi.vcf_name)
        attr_col.append(c)
    i_s = offs[:, 7].copy()
    i_e = (offs[:, 8] - 1).copy()
    vs, ve, pres = nl.info_values(records, i_s, i_e, info_keys)

    # ---- END column (INFO END= or deletion length) ----
    end = col.copy()
    end_pres = pres[0]
    if np.any(end_pres):
        ev, eo = nl.parse_int_lists(records, vs[0][end_pres].copy(),
                                    ve[0][end_pres].copy())
        end[end_pres] = (chrom_off[end_pres]
                         + ev[eo[:-1]].astype(np.int64) - 1)
    if treat_deletions_as_intervals:
        dmask = ~end_pres & del_flag.astype(bool)
        if np.any(dmask):
            rl = ref_ends - ref_starts
            end[dmask] = col[dmask] + rl[dmask] - 1

    # ---- build cell coordinate arrays (record-major x mapped sample) ----
    store = ColumnarStore(num_rows=vid.max_callset_row_idx() + 1)
    rows_per_rec = np.array([r for _, r in mapped], dtype=np.int64)
    cell_row = np.repeat(rows_per_rec[None, :], n, axis=0).ravel()
    cell_col = np.repeat(col, K_s)
    cell_end = np.repeat(end, K_s)

    fields: Dict[str, FieldData] = {}
    all_true = np.ones(n_cells, dtype=bool)

    # REF/ALT/ID strings: replicate per-record payloads to each cell
    vals, off = nl.replicate_ragged(np.frombuffer(ref_blob, np.uint8),
                                    ref_offs, K_s)
    fields["REF"] = FieldData("REF", "str", "bytes", all_true, vals, off)
    vals, off = nl.replicate_ragged(np.frombuffer(alt_blob, np.uint8),
                                    alt_offs, K_s)
    fields["ALT"] = FieldData("ALT", "str", "bytes", all_true.copy(),
                              vals, off)
    if import_id:
        vals, off = nl.replicate_ragged(np.frombuffer(id_blob, np.uint8),
                                        id_offs, K_s)
        fields["ID"] = FieldData("ID", "str", "bytes",
                                 np.repeat(id_valid_rec, K_s), vals, off)
    # QUAL fixed float
    qvals = np.repeat(quals, K_s).reshape(n_cells, 1).astype(np.float32)
    qvalid = np.repeat(
        quals.view(np.uint32) != formats.FLOAT_MISSING_BITS, K_s)
    fields["QUAL"] = FieldData("QUAL", "fixed", "float32", qvalid, qvals)
    # FILTER ragged int
    vals, off = nl.replicate_ragged(filt_rec_vals, filt_rec_offs, K_s)
    fields["FILTER"] = FieldData("FILTER", "ragged", "int32",
                                 all_true.copy(), vals, off)

    # ---- INFO fields (native value-span parse, replicated to cells) ----
    r2d_memo: dict = {}   # parent-name -> shared text segmentation
    for ai, (name, info) in enumerate(info_attr):
        j = attr_col[ai]
        if name in fields:
            continue
        kind, dtype, flen = specs[name]
        is_float = info.type == "float"
        p_mask = pres[j]
        if kind == "ragged2d":
            fields[name] = _import_ragged2d(
                name, info, vid, records, vs[j], ve[j], p_mask, n, K_s,
                mapped, len(samples), dtype, r2d_memo)
            continue
        if info.type == "flag":
            mat = np.full((n, flen), INT_MISSING, dtype=np.int32)
            mat[p_mask, 0] = 1
            fields[name] = FieldData(name, "fixed", dtype,
                                     np.repeat(p_mask, K_s),
                                     np.repeat(mat, K_s, axis=0))
            continue
        idx = np.nonzero(p_mask)[0]
        if is_float:
            pv, po = nl.parse_float_lists(records, vs[j][idx].copy(),
                                          ve[j][idx].copy())
        else:
            pv, po = nl.parse_int_lists(records, vs[j][idx].copy(),
                                        ve[j][idx].copy())
        seg_lens = np.diff(po)
        ok = seg_lens > 0
        if len(pv):
            seg0 = np.minimum(po[:-1], len(pv) - 1)
            if is_float:
                # all-missing vector -> field absent (import_pipeline
                # parse of float INFO values)
                nonmiss = pv.view(np.uint32) != formats.FLOAT_MISSING_BITS
                ok &= np.logical_or.reduceat(nonmiss, seg0) \
                    if len(idx) else ok
            else:
                # ints: only a single '.' token counts as absent
                ok &= ~((seg_lens == 1) & (pv[seg0] == INT_MISSING))
        valid_rec = np.zeros(n, dtype=bool)
        valid_rec[idx] = ok
        valid = np.repeat(valid_rec, K_s)
        divide = (_is_sum_like(info.combine_op) and len(samples) > 1)
        if kind == "fixed":
            fill = formats.FLOAT_MISSING if is_float else INT_MISSING
            mat = np.full((n, flen), fill,
                          dtype=np.float32 if is_float else np.int32)
            okidx = idx[ok]
            sl = np.minimum(seg_lens[ok], flen)
            src0 = po[:-1][ok]
            for e in range(flen):
                sel = sl > e
                mat[okidx[sel], e] = pv[src0[sel] + e]
            out = np.repeat(mat, K_s, axis=0)
            if divide:
                out = _divide_cells(out, valid, mapped, len(samples), K_s,
                                    is_float)
            fields[name] = FieldData(name, "fixed", dtype, valid, out)
        else:
            rec_lens = np.zeros(n, dtype=np.int64)
            rec_lens[idx[ok]] = seg_lens[ok]
            rec_offs = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(rec_lens, out=rec_offs[1:])
            rvals = np.empty(int(rec_offs[-1]), dtype=pv.dtype)
            nl.copy_segments(pv, po[:-1][ok], seg_lens[ok],
                             rec_offs[:-1][idx[ok]], rvals)
            vals, off = nl.replicate_ragged(rvals, rec_offs, K_s)
            if divide and len(vals):
                vals = _divide_ragged(vals, off, valid, mapped,
                                      len(samples), K_s, is_float)
            fields[name] = FieldData(name, kind, dtype, valid, vals, off)

    # ---- FORMAT fields (native, per sample) ----
    fmt_names = [a for a in attrs
                 if vid.fields.get(a) is not None
                 and vid.fields[a].is_format]
    # group records by FORMAT signature (interned FORMAT-column spans)
    groups: Dict[Tuple[str, ...], np.ndarray] = {}
    has = ncols > 8
    if np.any(has):
        hidx = np.nonzero(has)[0]
        g2, uniq2 = nl.intern_spans(records, offs[hidx, 8].copy(),
                                    (offs[hidx, 9] - 1).copy())
        for g, i in enumerate(uniq2):
            ri = hidx[i]
            sig = tuple(records[offs[ri, 8]:offs[ri, 9] - 1]
                        .decode().split(":"))
            groups[sig] = hidx[g2 == g]
    field_meta = {}
    for name in fmt_names:
        info = vid.fields[name]
        field_meta[name] = (info, info.vcf_name == "GT",
                            info.type == "float",
                            info.type in ("char", "string"))
    lens_by_field = {name: np.zeros(n_cells, dtype=np.int64)
                     for name in fmt_names}
    chunks_by_field: Dict[str, List[Tuple[np.ndarray, np.ndarray,
                                          np.ndarray, np.ndarray]]] = \
        {name: [] for name in fmt_names}
    per_cell_by_field: Dict[str, Optional[List[Optional[np.ndarray]]]] = {
        name: ([None] * n_cells if field_meta[name][3] else None)
        for name in fmt_names}

    # ---- cohort-wide two-pass native parse (numeric + GT fields) ----
    # One gdb_fmt_cohort call per signature group parses EVERY mapped
    # sample for every numeric field: pass 1 counts per-cell elements
    # into the final cell layout, pass 2 writes values at their final
    # offsets — no per-sample Python glue (the reference's
    # OpenMP-across-files fetch, tiledb_loader.cc:363, pushed down to
    # per-record parallelism).  Char/string fields (PGT/PID) keep the
    # per-sample job path below.
    cohort_done = set()
    if mapped and hasattr(nl.get_lib(), "gdb_fmt_cohort"):
        scols = np.asarray([9 + local_idx for local_idx, _row in mapped],
                           dtype=np.int64)
        num_names = [name for name in fmt_names
                     if not field_meta[name][3]]
        group_plans = []   # (recs, names, fidxs, kinds)
        for sig, recs in groups.items():
            present = []
            for name in num_names:
                vcfn = vid.fields[name].vcf_name
                if vcfn in sig:
                    present.append((name, sig.index(vcfn)))
            if not present:
                continue
            present.sort(key=lambda t: t[1])
            g_names = [nm for nm, _ in present]
            g_fidxs = np.asarray([fi for _, fi in present],
                                 dtype=np.int32)
            g_kinds = np.asarray(
                [(2 + int(vid.fields[nm].length.contains_phase()))
                 if field_meta[nm][1] else int(field_meta[nm][2])
                 for nm in g_names], dtype=np.int32)
            group_plans.append((recs.astype(np.int64), g_names,
                                g_fidxs, g_kinds))
        for recs64, g_names, g_fidxs, g_kinds in group_plans:
            nl.fmt_cohort(records, offs, recs64, scols, K_s, g_fidxs,
                          g_kinds, 0,
                          [lens_by_field[nm] for nm in g_names])
        # allocate destinations once counts are complete
        dest_vals: Dict[str, np.ndarray] = {}
        dest_offs: Dict[str, Optional[np.ndarray]] = {}
        dest_w: Dict[str, int] = {}
        for name in num_names:
            kind, dtype, flen = specs[name]
            is_float = field_meta[name][2]
            lens = lens_by_field[name]
            if kind == "fixed":
                fill = formats.FLOAT_MISSING if is_float else INT_MISSING
                dest_vals[name] = np.full(
                    (n_cells, flen), fill,
                    dtype=np.float32 if is_float else np.int32)
                dest_offs[name] = None
                dest_w[name] = flen
            else:
                off = np.zeros(n_cells + 1, dtype=np.int64)
                np.cumsum(lens, out=off[1:])
                dest_vals[name] = np.empty(
                    int(off[-1]),
                    dtype=np.float32 if is_float else np.int32)
                dest_offs[name] = off
                dest_w[name] = 0
        for recs64, g_names, g_fidxs, g_kinds in group_plans:
            nl.fmt_cohort(records, offs, recs64, scols, K_s, g_fidxs,
                          g_kinds, 1,
                          [lens_by_field[nm] for nm in g_names],
                          [dest_offs[nm] for nm in g_names],
                          [dest_vals[nm] for nm in g_names],
                          np.asarray([dest_w[nm] for nm in g_names],
                                     dtype=np.int32))
        for name in num_names:
            kind, dtype, flen = specs[name]
            lens = lens_by_field[name]
            valid = lens > 0
            if kind == "fixed":
                fields[name] = FieldData(name, "fixed", dtype, valid,
                                         dest_vals[name])
            else:
                fields[name] = FieldData(name, kind, dtype, valid,
                                         dest_vals[name],
                                         dest_offs[name])
            cohort_done.add(name)

    def parse_sample(recs, present, fidxs, k_pos, local_idx):
        scol = 9 + local_idx
        s_starts = offs[recs, scol].copy()
        s_ends = (offs[recs, scol + 1] - 1).copy()
        fs_all, fe_all = nl.split_fields_multi(records, s_starts, s_ends,
                                               b":", fidxs)
        out = []
        for (name, (info, is_gt, is_float, is_char)), fs, fe in zip(
                present, fs_all, fe_all):
            if is_char:
                # strings: python per record (rare fields)
                items = []
                for j, ri in enumerate(recs):
                    s = records[fs[j]:fe[j]].decode()
                    if s and s != ".":
                        items.append((int(ri), np.frombuffer(
                            s.encode(), dtype=np.uint8)))
                out.append((name, "char", k_pos, items))
                continue
            if is_gt:
                vals2, off2 = nl.parse_gt(
                    records, fs, fe, info.length.contains_phase())
            elif is_float:
                vals2, off2 = nl.parse_float_lists(records, fs, fe)
            else:
                vals2, off2 = nl.parse_int_lists(records, fs, fe)
            seg_lens = np.diff(off2)
            # a field is invalid only when it is a SINGLE missing value
            # (convert_field_to_tiledb: num_values == 1 && missing);
            # ".,." stays a valid 2-vector of missing elements
            if not is_gt and len(vals2):
                first = vals2[np.minimum(off2[:-1],
                                         max(len(vals2) - 1, 0))]
                if is_float:
                    first_miss = (first.view(np.uint32)
                                  == formats.FLOAT_MISSING_BITS)
                else:
                    first_miss = first == INT_MISSING
                seg_lens = np.where((seg_lens == 1) & first_miss, 0,
                                    seg_lens)
            out.append((name, "num", recs * K_s + k_pos, seg_lens, vals2,
                        off2[:-1]))
        return out

    jobs = []
    for sig, recs in groups.items():
        present = []
        for name in fmt_names:
            if name in cohort_done:
                continue
            vcfn = vid.fields[name].vcf_name
            if vcfn in sig:
                present.append(((name, field_meta[name]), sig.index(vcfn)))
        if not present:
            continue
        present.sort(key=lambda t: t[1])
        fidxs = np.asarray([fi for _, fi in present], dtype=np.int32)
        pres = [p for p, _ in present]
        for k_pos, (local_idx, _row) in enumerate(mapped):
            jobs.append((recs, pres, fidxs, k_pos, local_idx))

    if len(jobs) >= 4 and n_cells >= 4096:
        import concurrent.futures as cf
        import os as _os
        workers = min(8, _os.cpu_count() or 1, len(jobs))
        with cf.ThreadPoolExecutor(max_workers=workers) as ex:
            job_results = list(ex.map(lambda a: parse_sample(*a), jobs))
    else:
        job_results = [parse_sample(*a) for a in jobs]

    for items in job_results:
        for it in items:
            if it[1] == "char":
                name, _, k_pos, cell_items = it
                pcv = per_cell_by_field[name]
                lens = lens_by_field[name]
                for ri, arr in cell_items:
                    cid = ri * K_s + k_pos
                    pcv[cid] = arr
                    lens[cid] = len(arr)
            else:
                name, _, cids, seg_lens, vals2, src_off = it
                lens_by_field[name][cids] = seg_lens
                chunks_by_field[name].append((cids, seg_lens, vals2,
                                              src_off))

    for name in fmt_names:
        if name in cohort_done:
            continue
        info, is_gt, is_float, is_char = field_meta[name]
        kind, dtype, flen = specs[name]
        lens = lens_by_field[name]
        chunks = chunks_by_field[name]
        per_cell_vals = per_cell_by_field[name]
        valid = lens > 0
        if kind == "fixed":
            fill = formats.FLOAT_MISSING if is_float else INT_MISSING
            mat = np.full((n_cells, flen), fill,
                          dtype=np.float32 if is_float else np.int32)
            for cids, seg_lens, vals2, src_off in chunks:
                for e in range(flen):
                    sel = seg_lens > e
                    mat[cids[sel], e] = vals2[src_off[sel] + e]
            fields[name] = FieldData(name, "fixed", dtype, valid, mat)
        else:
            offsets = np.zeros(n_cells + 1, dtype=np.int64)
            np.cumsum(lens, out=offsets[1:])
            if is_char:
                empty = np.zeros(0, dtype=np.uint8)
                nz = [per_cell_vals[c] for c in np.nonzero(valid)[0]]
                values = np.concatenate(nz) if nz else empty
            else:
                np_dtype = np.float32 if is_float else np.int32
                values = np.empty(int(offsets[-1]), dtype=np_dtype)
                for cids, seg_lens, vals2, src_off in chunks:
                    sel = seg_lens > 0
                    if not np.any(sel):
                        continue
                    nl.copy_segments(vals2, src_off[sel], seg_lens[sel],
                                     offsets[cids[sel]], values)
            fields[name] = FieldData(name, kind, dtype, valid, values,
                                     offsets)

    store.attribute_order = attrs
    store.row = cell_row
    store.col = cell_col
    store.end = cell_end
    store.eff_end = cell_end.copy()  # recomputed by merge/sort below
    store.fields = fields
    return store


def _merge_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Union (with duplicates) of two sorted arrays, sorted — an O(n)
    vectorized merge replacing np.sort(np.concatenate([a, b]))."""
    out = np.empty(len(a) + len(b), a.dtype)
    pos_b = np.searchsorted(a, b, side="right") \
        + np.arange(len(b), dtype=np.int64)
    mask = np.zeros(len(out), dtype=bool)
    mask[pos_b] = True
    out[pos_b] = b
    out[~mask] = a
    return out


def _import_ragged2d(name, info, vid, records, vs_j, ve_j, p_mask,
                     n, K_s, mapped, nsamples, dtype,
                     memo=None) -> FieldData:
    """Vectorized parse of a text-serialized 2-D INFO field
    (allele-specific annotations like AS_RAW_MQ
    "8.0,10.0|28.0|31.0", genomicsdb_multid_vector_field.cc
    parse_and_store_numeric / vcf2binary.cc:991-1160): outer segments
    split on delimiter(0), inner tokens on delimiter(1); composite
    (tuple) parents interleave element values, the flattened element
    field selects tokens tuple_index::n_tuple.  Byte-equal to
    import_pipeline.parse_multid_string (tests/test_fast_import.py)."""
    from ..core import known_fields as kf
    parent = vid.fields[info.parent_name] if info.is_flattened else info
    n_tuple = parent.num_elements_in_tuple
    tuple_index = info.tuple_index
    etype = info.type
    is_float = etype == "float"
    np_dtype = np.float32 if is_float else np.int32
    idx = np.nonzero(p_mask)[0]
    n_p = len(idx)
    miss = formats.FLOAT_MISSING if is_float else INT_MISSING
    if n_p == 0:
        return FieldData(name, "ragged2d", dtype,
                         np.zeros(n * K_s, dtype=bool),
                         np.zeros(0, np_dtype),
                         np.zeros(1, np.int64),
                         outer_offsets=np.zeros(n * K_s + 1, np.int64))
    # the text segmentation depends only on the PARENT's INFO spans —
    # flattened tuple-element fields (AS_RAW_MQRankSum value + count)
    # share it, so memoize per parent within one import call
    mkey = parent.vcf_name if hasattr(parent, "vcf_name") \
        else info.parent_name or name
    seg = memo.get(mkey) if memo is not None else None
    if seg is None:
        blob, boffs = nl.extract_spans(records, vs_j[idx].copy(),
                                       ve_j[idx].copy())
        arr = np.frombuffer(blob, np.uint8)
        d0 = ord(parent.length.delimiter(0))
        d1 = ord(parent.length.delimiter(1))
        # int32 span arithmetic (blobs are far below 2 GiB): halves the
        # merge/searchsorted cost of the segmentation
        boffs = boffs.astype(np.int32)
        pipes = np.flatnonzero(arr == d0).astype(np.int32)
        # outer segments: one per record plus one per delimiter(0)
        seg_starts = _merge_sorted(boffs[:-1], pipes + 1)
        seg_ends = _merge_sorted(pipes, boffs[1:])
        cnt = np.searchsorted(pipes, boffs)
        outer_per_rec = (cnt[1:] - cnt[:-1]) + 1        # [n_p]
        n_segs = len(seg_starts)
        # inner tokens: one per segment plus one per delimiter(1);
        # tokens of EMPTY outer segments are dropped (an empty part is
        # a 0-length inner vector, parse_multid_string's `part == ""`
        # branch)
        commas = np.flatnonzero(arr == d1).astype(np.int32)
        tok_starts = _merge_sorted(seg_starts, commas + 1)
        tok_ends = _merge_sorted(commas, seg_ends)
        seg_of_tok = np.searchsorted(seg_starts, tok_starts,
                                     side="right") - 1
        first_tok_of_seg = np.searchsorted(tok_starts, seg_starts,
                                           side="left")
        local = np.arange(len(tok_starts)) \
            - first_tok_of_seg[seg_of_tok]
        nonempty = (seg_ends - seg_starts)[seg_of_tok] > 0
        seg = (blob, outer_per_rec, n_segs, tok_starts, tok_ends,
               seg_of_tok, local, nonempty)
        if memo is not None:
            memo[mkey] = seg
    (blob, outer_per_rec, n_segs, tok_starts, tok_ends, seg_of_tok,
     local, nonempty) = seg
    sel = nonempty & ((local % n_tuple) == tuple_index)
    ts, te = tok_starts[sel], tok_ends[sel]
    n_tok = len(ts)
    # parse each selected token (spans contain no delimiter; an empty
    # token ",," or "." is a MISSING element, matching int(float(t)) /
    # np.float32(t) with the "." / "" guards)
    vals = np.full(n_tok, miss, dtype=np_dtype)
    if n_tok:
        try:
            # the native parsers take int64 span arrays
            pv, po = (nl.parse_float_lists if is_float
                      else nl.parse_int_lists)(blob,
                                               ts.astype(np.int64),
                                               te.astype(np.int64))
            tc = np.diff(po)
            one = tc == 1
            vals[one] = pv[po[:-1][one]]
        except ValueError:
            # int element with float-formatted tokens: the python
            # semantics are int(float(t)) (parse_multid_string)
            for i in range(n_tok):
                t = blob[ts[i]:te[i]].decode()
                if t not in (".", ""):
                    vals[i] = np.int32(int(float(t)))
    inner_lens_rec = np.bincount(seg_of_tok[sel],
                                 minlength=n_segs).astype(np.int64)
    # ---- replicate per-record payloads to each mapped sample cell ----
    rec_outer_offs = np.zeros(n_p + 1, dtype=np.int64)
    np.cumsum(outer_per_rec, out=rec_outer_offs[1:])
    rec_tot = np.add.reduceat(inner_lens_rec, rec_outer_offs[:-1]) \
        if n_segs else np.zeros(n_p, np.int64)
    rec_tot_offs = np.zeros(n_p + 1, dtype=np.int64)
    np.cumsum(rec_tot, out=rec_tot_offs[1:])
    # expand present-record arrays to all records
    outer_full = np.zeros(n, dtype=np.int64)
    outer_full[idx] = outer_per_rec
    tot_full_offs = np.zeros(n + 1, dtype=np.int64)
    tot_full = np.zeros(n, dtype=np.int64)
    tot_full[idx] = rec_tot
    np.cumsum(tot_full, out=tot_full_offs[1:])
    vals_full = np.zeros(int(tot_full_offs[-1]), dtype=np_dtype)
    if len(vals):
        nl.copy_segments(vals, rec_tot_offs[:-1], rec_tot,
                         tot_full_offs[:-1][idx], vals_full)
    ilens_full_offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(outer_full, out=ilens_full_offs[1:])
    ilens_full = np.zeros(int(ilens_full_offs[-1]), dtype=np.int64)
    if n_segs:
        nl.copy_segments(inner_lens_rec, rec_outer_offs[:-1],
                         outer_per_rec, ilens_full_offs[:-1][idx],
                         ilens_full)
    cell_vals, cell_val_offs = nl.replicate_ragged(vals_full,
                                                   tot_full_offs, K_s)
    cell_ilens, _ = nl.replicate_ragged(ilens_full, ilens_full_offs,
                                        K_s)
    n_cells = n * K_s
    outer_offsets = np.zeros(n_cells + 1, dtype=np.int64)
    np.cumsum(np.repeat(outer_full, K_s), out=outer_offsets[1:])
    inner_offsets = np.zeros(len(cell_ilens) + 1, dtype=np.int64)
    np.cumsum(cell_ilens, out=inner_offsets[1:])
    valid = np.repeat(p_mask, K_s)
    # divide_up_among_samples (vcf2binary.h:35-53): sum-like combine ops
    # split INFO values among the file's samples; histogram_sum divides
    # only the count element (tuple_index 1)
    if _is_sum_like(parent.combine_op) and nsamples > 1 \
            and (parent.combine_op != kf.OP_HISTOGRAM_SUM
                 or tuple_index == 1):
        cell_vals = _divide_ragged(cell_vals, cell_val_offs, valid,
                                   mapped, nsamples, K_s, is_float)
    return FieldData(name, "ragged2d", dtype, valid, cell_vals,
                     inner_offsets, outer_offsets=outer_offsets)


def _divide_cells(out, valid, mapped, nsamples, K_s, is_float):
    """divide_up_among_samples (vcf2binary.h:35-53) on replicated per-cell
    fixed-field matrices [n_cells, flen]."""
    out = out.copy()
    for k_pos, (local_idx, _row) in enumerate(mapped):
        rows = np.arange(k_pos, len(out), K_s)
        block = out[rows]
        if is_float:
            miss = block.view(np.uint32) == formats.FLOAT_MISSING_BITS
            with np.errstate(invalid="ignore"):
                d = (block / np.float32(nsamples)).astype(np.float32)
            d[miss] = block[miss]
        else:
            miss = block == INT_MISSING
            d = block // nsamples + (local_idx < (block % nsamples))
            d = d.astype(np.int32)
            d[miss] = block[miss]
        out[rows] = d
    return out


def _divide_ragged(vals, off, valid, mapped, nsamples, K_s, is_float):
    """divide_up_among_samples on per-cell ragged values, vectorized:
    each element's divisor remainder share depends on its cell's callset
    idx-in-file (vcf2binary.h:35-53)."""
    lens = np.diff(off)
    if is_float:
        miss = vals.view(np.uint32) == formats.FLOAT_MISSING_BITS
        with np.errstate(invalid="ignore"):
            d = (vals / np.float32(nsamples)).astype(np.float32)
    else:
        local_per_k = np.asarray([li for li, _r in mapped], dtype=np.int64)
        cell_ids = np.repeat(np.arange(len(lens), dtype=np.int64), lens)
        local = local_per_k[cell_ids % K_s]
        miss = vals == INT_MISSING
        d = (vals // nsamples + (local < (vals % nsamples))).astype(
            np.int32)
    d[miss] = vals[miss]
    return d


