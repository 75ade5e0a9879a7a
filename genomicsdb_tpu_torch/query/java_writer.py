"""htsjdk-style VCF rendering (the reference's Java query path).

The reference streams BCF2 bytes through JNI into htsjdk, whose
VariantContextWriter re-renders records (reader/GenomicsDBQueryStream.java +
htsjdk VCFEncoder): VCFv4.2 header with sorted metadata lines, INFO keys
sorted, FORMAT keys sorted (GT first), htsjdk float formatting
(%.2f / %.3f / %.3e by magnitude), and fully-missing samples collapsed to
".".  Byte-compatible with the java_* golden outputs.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..core import formats
from .vcf_writer import CombineToVCF, _valid_float, _valid_int


def format_java_double(x) -> str:
    """htsjdk VCFEncoder.formatVCFDouble."""
    d = float(np.float32(x))
    if d < 1:
        if d < 0.01:
            if abs(d) >= 1e-20:
                return "%.3e" % d
            return "%.1f" % d  # quasi-zero
        return "%.3f" % d
    return "%.2f" % d


def transform_header_lines(lines: List[str]) -> List[str]:
    """C++ header -> htsjdk header: v4.2 + sorted metadata, contigs in
    index order, then remaining lowercase-key lines."""
    meta = []
    contigs = []
    others = []
    for line in lines:
        if line.startswith("##fileformat"):
            continue
        if line.startswith("##contig"):
            contigs.append(line)
        elif line.startswith("##reference"):
            others.append(line)
        else:
            meta.append(line)
    return (["##fileformat=VCFv4.2"] + sorted(meta) + contigs
            + sorted(others))


class JavaCombineToVCF(CombineToVCF):
    """Combine operator with htsjdk-style record rendering."""

    def _render_info_typed(self, kind: str, value) -> str:
        if kind == "i":
            return str(int(value))
        if kind == "f":
            return format_java_double(value)
        if kind == "s":
            return str(value)
        is_float = kind == "fl"
        parts = []
        for x in value:
            if is_float:
                parts.append(format_java_double(x) if _valid_float(x)
                             else ".")
            else:
                parts.append(str(int(x)) if _valid_int(int(x)) else ".")
        return ",".join(parts)

    def _render_qual(self, res) -> str:
        return format_java_double(res)

    def _encode_gt(self, per_sample, max_ploidy_elems):
        """htsjdk genotype rendering: a genotype is phased only if EVERY
        inter-allele separator is phased; the separator is then uniform
        ('|' everywhere or '/' everywhere)."""
        INT_VECTOR_END = formats.INT_VECTOR_END
        out = []
        phase_in = self.gt_phase
        produce = self.produce_GT
        for vec in per_sample:
            elems = []
            n = len(vec)
            if phase_in:
                if n > 0:
                    elems.append((int(vec[0]), False))
                k = 2
                while k < n:
                    elems.append((int(vec[k]), int(vec[k - 1]) > 0))
                    k += 2
            else:
                for k in range(n):
                    elems.append((int(vec[k]), False))
            alleles = []
            phases = []
            for i, (v, phased) in enumerate(elems):
                if v == INT_VECTOR_END:
                    break
                if produce and _valid_int(v) and v >= 0:
                    alleles.append(str(v))
                else:
                    alleles.append(".")
                if i > 0:
                    phases.append(phased if phase_in else False)
            if not alleles:
                out.append(".")
                continue
            sep = "|" if (phases and all(phases)) else "/"
            out.append(sep.join(alleles))
        return out

    def _assemble_line(self, contig, cpos, id_txt, ref_out, alt_out,
                       qual_txt, filter_txt, info_parts, fmt_names,
                       fmt_values, ncalls) -> str:
        info_parts = sorted(info_parts, key=lambda p: p.split("=", 1)[0])
        info_txt = ";".join(info_parts) if info_parts else "."
        cols = [contig, str(cpos + 1), id_txt, ref_out, alt_out, qual_txt,
                filter_txt, info_txt]
        if not self.sites_only and self.sample_names:
            if fmt_names:
                order = list(range(len(fmt_names)))
                order.sort(key=lambda i: ("" if fmt_names[i] == "GT"
                                          else fmt_names[i]))
                cols.append(":".join(fmt_names[i] for i in order))
                for s in range(ncalls):
                    vals = [fmt_values[i][s] for i in order]
                    if all(v == "." for v in vals):
                        cols.append(".")
                    else:
                        # htsjdk VCFEncoder drops trailing missing fields
                        while len(vals) > 1 and vals[-1] == ".":
                            vals.pop()
                        cols.append(":".join(vals))
            else:
                cols.append(".")
                cols.extend("." for _ in range(ncalls))
        return "\t".join(cols)
