"""Combined-VCF header construction.

Mirrors BroadCombinedGVCFOperator's header assembly
(broad_combined_gvcf.cc:150-330): template header + missing field lines +
missing contig lines (vid order) + sample names.
"""

from __future__ import annotations

from typing import List

from ..core.config import QueryConfig
from ..core.vid import VidMapper
from .reader import VCFHeader, read_header


_TYPE_MAP = {"int": "Integer", "float": "Float", "char": "String",
             "flag": "Flag"}


def _number_for(info) -> str:
    code = info.length.code
    if code == "A":
        return "A"
    if code == "R":
        return "R"
    if code == "G":
        return "G"
    if code in ("VAR", "P", "PP"):
        return "."
    n = info.length.fixed_len
    return str(n)


def load_template(path: str) -> VCFHeader:
    from .reader import open_text
    with open_text(path) as f:
        return read_header(f)


# rendered header lines recur across queries of one serving process
# (the GATK split pattern issues thousands of interval queries against
# one store with the same template/vid/attribute set) — parsing the
# template per query costs several ms.  Keyed by template path + the
# header-relevant query facts; values pin the vid so id() stays valid.
_HEADER_LINES_CACHE: dict = {}


def header_lines_cached(template_path: str, vid: VidMapper,
                        qc: QueryConfig) -> List[str]:
    key = (template_path, id(vid), tuple(qc.attributes or ()),
           bool(qc.is_queried("FILTER")))
    got = _HEADER_LINES_CACHE.get(key)
    if got is None:
        template = load_template(template_path)
        got = (vid, build_header_lines(template, vid, qc))
        if len(_HEADER_LINES_CACHE) > 32:
            _HEADER_LINES_CACHE.clear()
        _HEADER_LINES_CACHE[key] = got
    return got[1]


def build_header_lines(template: VCFHeader, vid: VidMapper, qc: QueryConfig
                       ) -> List[str]:
    lines = list(template.lines)
    # queried INFO/FORMAT fields missing from the template get appended
    # (add_field_to_hdr_if_missing, vcf_adapter.cc)
    op = qc  # alias
    for name in op.attributes:
        info = vid.get_field_info(name)
        if info is None or name == "END":
            continue
        from ..core import known_fields as kf
        is_info_out = (info.is_info
                       and info.combine_op != kf.OP_MOVE_TO_FORMAT
                       and not (name == "DP" and info.combine_op == kf.OP_DP))
        is_format_out = (info.is_format
                         or info.combine_op == kf.OP_MOVE_TO_FORMAT)
        dp_info_as_format = (name == "DP" and info.is_info
                             and info.combine_op == kf.OP_DP)
        vcf_name = info.vcf_name
        if is_info_out and vcf_name not in template.infos:
            num = _number_for(info)
            ftype = _TYPE_MAP.get(info.type, "String")
            if info.vcf_type == "string":
                ftype = "String"
                num = "1"
            lines.append(
                f'##INFO=<ID={vcf_name},Number={num},Type={ftype},'
                f'Description="{vcf_name}">')
            template.infos[vcf_name] = None  # type: ignore
        if is_format_out and vcf_name not in template.formats:
            num = _number_for(info)
            ftype = _TYPE_MAP.get(info.type, "String")
            lines.append(
                f'##FORMAT=<ID={vcf_name},Number={num},Type={ftype},'
                f'Description="{vcf_name}">')
            template.formats[vcf_name] = None  # type: ignore
        if dp_info_as_format and "DP" not in template.infos:
            lines.append('##INFO=<ID=DP,Number=1,Type=Integer,'
                         'Description="DP">')
            template.infos["DP"] = None  # type: ignore
    # FILTER fields from vid when FILTER queried
    if op.is_queried("FILTER"):
        for name in vid.field_order:
            info = vid.fields[name]
            if info.is_filter and name not in template.filters:
                lines.append(f'##FILTER=<ID={name},Description="{name}">')
                template.filters[name] = None  # type: ignore
    # contigs (vid parse order)
    for cname, cinfo in vid.contigs.items():
        if cname not in template.contigs:
            lines.append(f"##contig=<ID={cname},length={cinfo.length}>")
    return lines


def chrom_line(sample_names: List[str], sites_only: bool) -> str:
    cols = ["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO"]
    if not sites_only and sample_names:
        cols.append("FORMAT")
        cols.extend(sample_names)
    return "\t".join(cols)
