"""Byte-exact JSON printers for the calls / variants query paths.

calls:    gt_mpi_gather.cc:369-385 (print_calls) +
          GenomicsDBColumnarCell::print (variant_cell.cc:119-165) +
          GenomicsDBColumnarFieldPrintOperator (genomicsdb_columnar_field.cc)
variants: print_variants (variant.cc:942-1015) + Variant::print /
          VariantCall::print (variant.cc:225-476), std::fixed precision 6.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..core import formats
from ..core.config import QueryConfig, INT64_MAX
from ..store.columnar import ColumnarStore
from .cells import CallView
from .scan import iterate_cells

INDENT = "    "


def _calls_scalar(val, dtype) -> str:
    if dtype == "float32":
        return formats.format_float_calls_json(val)
    return str(int(val))


def _print_as_list(fd_kind: str, fixed_len: int) -> bool:
    """Columnar-field print mode: list unless fixed length 1."""
    return not (fd_kind == "fixed" and fixed_len == 1)


def _calls_field_value(call: CallView, name: str, qc: QueryConfig) -> Optional[str]:
    """Render one field for the calls JSON; None if invalid."""
    val = call.field(name)
    if val is None:
        return None
    store = call.store
    fd = store.fields.get(name)
    if name == "ALT":
        alts = val.split("|")
        parts = []
        for a in alts:
            parts.append('"<NON_REF>"' if a == "&" else f'"{a}"')
        return "[ " + ", ".join(parts) + " ]"
    if fd is None:
        return None
    if fd.kind == "str":
        return f'"{val}"'
    dtype = fd.dtype
    if fd.kind == "fixed" and fd.values.shape[1] == 1:
        return _calls_scalar(val[0], dtype)
    if fd.kind == "ragged2d":
        # flattened multi-D fields print as raw byte vectors in the
        # reference; represent as nested lists (not golden-covered for calls)
        return "[ " + ", ".join(
            "[ " + ", ".join(_calls_scalar(x, dtype) for x in sub) + " ]"
            for sub in val) + " ]"
    vals = val if fd.kind != "fixed" else val
    return "[ " + ", ".join(_calls_scalar(x, dtype) for x in np.asarray(vals)
                            ) + " ]"


def _genomic_interval_line(qc: QueryConfig, col: int, end: int,
                           indent: str) -> Optional[str]:
    loc = qc.vid.get_contig_location(col)
    if loc is None:
        return None
    contig, cpos = loc
    return (f'{indent}"genomic_interval": {{ "{contig}" : '
            f'[ {cpos + 1}, {cpos + 1 + (end - col)} ] }},\n')


def print_call_cell(call: CallView, qc: QueryConfig, indent_prefix: str
                    ) -> str:
    """GenomicsDBColumnarCell::print (variant_cell.cc:119-165)."""
    ind = indent_prefix + INDENT
    out = [f"{indent_prefix}{{\n"]
    out.append(f'{ind}"row": {call.row},\n')
    out.append(f'{ind}"interval": [ {call.col}, {call.end} ],\n')
    gi = _genomic_interval_line(qc, call.col, call.end, ind)
    if gi:
        out.append(gi)
    out.append(f'{ind}"fields": {{\n')
    find = ind + INDENT
    parts = []
    for name in qc.attributes:
        if name == "END":
            continue
        rendered = _calls_field_value(call, name, qc)
        if rendered is not None:
            parts.append(f'{find}"{name}": {rendered}')
    out.append(",\n".join(parts))
    out.append(f"\n{ind}}}\n{indent_prefix}}}")
    return "".join(out)


def print_calls_json(store: ColumnarStore, qc: QueryConfig) -> str:
    """Whole --print-calls output (gt_mpi_gather.cc:369-385)."""
    prefix = INDENT
    out = ["{\n", f'{prefix}"variant_calls": [\n']
    intervals: List[Optional[Tuple[int, int]]]
    if qc.column_intervals:
        intervals = list(qc.column_intervals)
    else:
        intervals = [None]
    blocks = []
    for iv in intervals:
        begin = iv[0] if iv else 0
        end = iv[1] if iv else INT64_MAX - 1
        p1 = prefix + INDENT
        p2 = p1 + INDENT + INDENT
        cell_strs = [print_call_cell(c, qc, p2)
                     for c in iterate_cells(store, qc, iv)]
        if not cell_strs:
            # intervals without cells produce no block (the columnar
            # operator only opens one on the first cell)
            continue
        block = (f"{p1}{{\n"
                 f'{p1 + INDENT}"query_interval": [ {begin}, {end} ],\n'
                 f'{p1 + INDENT}"variant_calls": [\n'
                 + ",\n".join(cell_strs)
                 + f"\n{p1 + INDENT}]\n{p1}}}")
        blocks.append(block)
    out.append(",\n".join(blocks))
    out.append(f"\n{prefix}]\n}}\n")
    return "".join(out)


# ---------------- variants path ----------------

def _variants_field_value(call: CallView, name: str, qc: QueryConfig
                          ) -> Optional[str]:
    """Field rendering for Variant/VariantCall::print (field->print())."""
    val = call.field(name)
    if val is None:
        return None
    store = call.store
    fd = store.fields.get(name)
    if name == "ALT":
        alts = val.split("|") if isinstance(val, str) else val
        parts = ['"<NON_REF>"' if a == "&" else f'"{a}"' for a in alts]
        return "[ " + ",".join(parts) + " ]"
    if fd is None or fd.kind == "str":
        return f'"{val}"'
    dtype = fd.dtype
    if dtype == "float32":
        fmt = formats.format_float_variants_json
    else:
        fmt = lambda x: str(int(x))  # noqa: E731
    arr = np.atleast_1d(np.asarray(val))
    return "[ " + ",".join(fmt(x) for x in arr) + " ]"


def _variants_override_value(value, name: str, qc: QueryConfig
                             ) -> Optional[str]:
    """Render an overridden (remapped) field value."""
    if value is None:
        return None
    info = qc.field_info(name)
    if name == "ALT" or isinstance(value, list) and all(
            isinstance(x, str) for x in value):
        parts = ['"<NON_REF>"' if a in ("&", "<NON_REF>") else f'"{a}"'
                 for a in value]
        return "[ " + ",".join(parts) + " ]"
    if isinstance(value, str):
        return f'"{value}"'
    if info is not None and info.type == "float":
        fmt = formats.format_float_variants_json
    else:
        fmt = lambda x: str(int(x))  # noqa: E731
    arr = np.atleast_1d(np.asarray(value))
    return "[ " + ",".join(fmt(x) for x in arr) + " ]"


def print_variant_call(call: CallView, qc: QueryConfig, indent_prefix: str
                       ) -> str:
    """VariantCall::print (variant.cc:225-265)."""
    ind = indent_prefix + INDENT
    out = [f"{indent_prefix}{{\n"]
    out.append(f'{ind}"row": {call.row},\n')
    out.append(f'{ind}"interval": [ {call.col}, {call.end} ],\n')
    gi = _genomic_interval_line(qc, call.col, call.end, ind)
    if gi:
        out.append(gi)
    out.append(f'{ind}"fields": {{\n')
    find = ind + INDENT
    parts = []
    for name in qc.attributes:
        if name == "END":
            continue
        if name in call._overrides:
            rendered = _variants_override_value(call._overrides[name], name,
                                                qc)
        else:
            rendered = _variants_field_value(call, name, qc)
        if rendered is not None:
            parts.append(f'{find}"{name}": {rendered}')
    out.append(",\n".join(parts))
    out.append(f"\n{ind}}}\n{indent_prefix}}}")
    return "".join(out)


def _cotton_value(call, name: str, qc: QueryConfig) -> str:
    """print_Cotton_JSON field rendering (variant_field_data.h:452-460):
    lists for variable-length/multi-element fields, scalars otherwise,
    'null' for invalid; std::fixed precision 6 floats."""
    if hasattr(call, "_overrides") and name in call._overrides:
        val = call._overrides[name]
    else:
        val = call.field(name)
    if val is None:
        return "null"
    fd = call.store.fields.get(name)
    if name == "ALT":
        alts = val.split("|") if isinstance(val, str) else val
        return "[ " + ",".join(
            '"<NON_REF>"' if a in ("&", "<NON_REF>") else f'"{a}"'
            for a in alts) + " ]"
    if fd is None or fd.kind == "str" or isinstance(val, str):
        return f'"{val}"'
    is_float = fd.dtype == "float32"
    fmt = (formats.format_float_variants_json if is_float
           else (lambda x: str(int(x))))
    arr = np.atleast_1d(np.asarray(val))
    if fd.kind == "fixed" and arr.shape[-1] == 1 and fd.values.shape[1] == 1:
        return fmt(arr[0])
    return "[ " + ",".join(fmt(x) for x in arr) + " ]"


def print_cotton_json(variants, qc: QueryConfig) -> str:
    """--output-format Cotton-JSON (variant.cc:479-583): per-attribute
    arrays across all calls of all variants."""
    calls = [c for (_s, _e, _cm, group) in variants for c in group]
    out = ["{\n"]
    ind = INDENT
    out.append(f'{ind}"indices" : [ '
               + ",".join(str(c.row) for c in calls) + " ],\n")

    def contig_pos(col):
        loc = qc.vid.get_contig_location(col)
        return str(loc[1] + 1) if loc else str(col)

    out.append(f'{ind}"POSITION" : [ '
               + ",".join(contig_pos(c.col) for c in calls) + " ],\n")
    out.append(f'{ind}"END" : [ '
               + ",".join(contig_pos(c.end) for c in calls) + " ],\n")
    attrs = [a for a in qc.attributes if a != "END"]
    for i, name in enumerate(attrs):
        vals = ",".join(_cotton_value(c, name, qc) for c in calls)
        sep = "\n" if i + 1 >= len(attrs) else ",\n"
        out.append(f'{ind}"{name}" : [ {vals} ]{sep}')
    out.append("}\n")
    return "".join(out)


def print_positions_json(per_interval, qc: QueryConfig) -> str:
    """--output-format Positions-JSON split by column
    (variant.cc:633-700): per queried interval, a "start[_end]" keyed
    object of Cotton-style field arrays."""
    out = ["{\n"]
    blocks = []
    for (begin, end), variants in per_interval:
        loc = qc.vid.get_contig_location(begin)
        loce = qc.vid.get_contig_location(end)
        sp = loc[1] + 1 if loc else begin
        ep = loce[1] + 1 if loce else end
        key = f"{sp}" if sp == ep else f"{sp}_{ep}"
        body = print_cotton_json(variants, qc)
        body = body[2:-2]  # strip outer braces/newlines
        blocks.append(f'"{key}" : {{\n{body}}}')
    out.append(",\n".join(blocks))
    out.append("\n}\n")
    return "".join(out)


def print_variants_json(variants, qc: QueryConfig) -> str:
    """Default ("GA4GH-like") output of run_range_query
    (variant.cc:984-999).  `variants` is a list of
    (start, end, common_fields_or_None, [CallView,...])."""
    out = ["{\n", f'{INDENT}"variants": [\n']
    vstrs = []
    prefix = INDENT + INDENT
    ind = prefix + INDENT
    for (start, end, common, calls) in variants:
        v = [f"{prefix}{{\n"]
        v.append(f'{ind}"interval": [ {start}, {end} ],\n')
        gi = _genomic_interval_line(qc, start, end, ind)
        if gi:
            v.append(gi)
        v.append(f'{ind} "common_fields" : {{\n')
        if common:
            cparts = []
            ref, alts = common
            cind = ind + INDENT
            cparts.append(f'{cind}"REF": "{ref}"')
            alt_txt = "[ " + ",".join(
                '"<NON_REF>"' if a in ("&", "<NON_REF>") else f'"{a}"'
                for a in alts) + " ]"
            cparts.append(f'{cind}"ALT": {alt_txt}')
            v.append(",\n".join(cparts))
            v.append(f"\n{ind}}},\n")
        else:
            v.append(f"\n{ind}}},\n")
        v.append(f'{ind}"variant_calls": [\n')
        v.append(",\n".join(print_variant_call(c, qc, ind + INDENT)
                            for c in calls))
        v.append(f"\n{ind}]\n")
        v.append(f"{prefix}}}")
        vstrs.append("".join(v))
    out.append(",\n".join(vstrs))
    out.append(f"\n{INDENT}]\n}}\n")
    return "".join(out)
