"""Generate vid/callset mappings from VCF headers.

Equivalent of the Java importer's config generation
(GenomicsDBImporter.generateSortedCallSetMap /
generateVidMapFromMergedHeader, importer/GenomicsDBImporter.java:157-180):
merge the INFO/FORMAT/FILTER/contig declarations of the input VCF headers
into a vid mapping, and assign callset rows in sample order.

Usage:
  python -m genomicsdb_tpu_torch.tools.generate_config out_vid.json \
      out_callsets.json in1.vcf.gz in2.vcf.gz ...
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List

from ..vcf.reader import VCFFile


_TYPE_MAP = {"Integer": "int", "Float": "float", "String": "char",
             "Character": "char", "Flag": "flag"}


def _length_for(number: str):
    if number in ("A", "R", "G"):
        return number
    if number == ".":
        return "VAR"
    try:
        return int(number)
    except ValueError:
        return "VAR"


def generate_vid(headers) -> dict:
    """Merged vid dict from VCFHeader objects (first declaration wins;
    conflicting types fall back to the wider type)."""
    fields: Dict[str, dict] = {}
    contigs: Dict[str, dict] = {}
    next_offset = 0
    for hdr in headers:
        for fid, hf in hdr.filters.items():
            fields.setdefault(fid, {"type": "int"})
        for fid, hf in hdr.infos.items():
            spec = fields.setdefault(fid, {"vcf_field_class": [],
                                           "type": _TYPE_MAP.get(hf.ftype,
                                                                 "char")})
            cls = spec.setdefault("vcf_field_class", [])
            if "INFO" not in cls:
                cls.append("INFO")
            if ("length" not in spec and fid != "END"
                    and hf.ftype != "Flag"):
                ln = _length_for(hf.number)
                if ln != 1:
                    spec["length"] = ln
        for fid, hf in hdr.formats.items():
            spec = fields.setdefault(fid, {"vcf_field_class": [],
                                           "type": _TYPE_MAP.get(hf.ftype,
                                                                 "char")})
            cls = spec.setdefault("vcf_field_class", [])
            if "FORMAT" not in cls:
                cls.append("FORMAT")
            if fid == "GT":
                spec["type"] = "int"
                spec["length"] = "PP"
            elif "length" not in spec:
                ln = _length_for(hf.number)
                if ln != 1:
                    spec["length"] = ln
        for cname, clen in hdr.contigs.items():
            if cname not in contigs:
                contigs[cname] = {"length": clen,
                                  "tiledb_column_offset": next_offset}
                next_offset += clen
    return {"fields": fields, "contigs": contigs}


def generate_callsets(paths: List[str]) -> dict:
    """Row per sample, in (file, sample) order."""
    callsets: Dict[str, dict] = {}
    row = 0
    for path in paths:
        vcf = VCFFile(path)
        for idx, name in enumerate(vcf.header.samples):
            if name in callsets:
                raise ValueError(f"duplicate sample {name}")
            callsets[name] = {"row_idx": row, "idx_in_file": idx,
                              "filename": path}
            row += 1
        vcf.close()
    return {"callsets": callsets}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if argv[:1] in (["-h"], ["--help"]):
        print(__doc__)
        return 0
    if len(argv) < 3:
        sys.stderr.write(__doc__)
        return 2
    out_vid, out_callsets, *paths = argv
    headers = []
    for p in paths:
        vcf = VCFFile(p)
        headers.append(vcf.header)
        vcf.close()
    with open(out_vid, "w") as f:
        json.dump(generate_vid(headers), f, indent=2)
    with open(out_callsets, "w") as f:
        json.dump(generate_callsets(paths), f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
