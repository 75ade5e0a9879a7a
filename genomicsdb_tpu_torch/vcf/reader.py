"""VCF text reader.

Plain-Python parser for VCF / bgzip-VCF used by the offline import edge
(replaces the reference's htslib decode at
src/main/cpp/src/vcf/vcf2binary.cc).  bgzf is gzip-compatible, so `gzip`
handles .vcf.gz.
"""

from __future__ import annotations

import gzip
import re
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional


_STRUCT_RE = re.compile(r"##(\w+)=<(.*)>\s*$")


def _parse_structured(body: str) -> Dict[str, str]:
    """Parse `ID=x,Number=y,...` with quoted values."""
    out = {}
    key = []
    val = []
    in_val = False
    in_quotes = False
    i = 0
    while i < len(body):
        c = body[i]
        if not in_val:
            if c == "=":
                in_val = True
            elif c == ",":
                key = []
            else:
                key.append(c)
        else:
            if in_quotes:
                if c == '"':
                    in_quotes = False
                val.append(c)
            elif c == '"':
                in_quotes = True
                val.append(c)
            elif c == ",":
                out["".join(key)] = "".join(val)
                key, val, in_val = [], [], False
            else:
                val.append(c)
        i += 1
    if key:
        out["".join(key)] = "".join(val)
    return out


@dataclass
class HeaderField:
    field_id: str
    number: str = "1"
    ftype: str = "String"
    line: str = ""


@dataclass
class VCFHeader:
    lines: List[str] = dc_field(default_factory=list)  # all ## lines in order
    samples: List[str] = dc_field(default_factory=list)
    infos: Dict[str, HeaderField] = dc_field(default_factory=dict)
    formats: Dict[str, HeaderField] = dc_field(default_factory=dict)
    filters: Dict[str, HeaderField] = dc_field(default_factory=dict)
    contigs: Dict[str, int] = dc_field(default_factory=dict)  # name -> length

    def add_line(self, line: str):
        line = line.rstrip("\n")
        self.lines.append(line)
        m = _STRUCT_RE.match(line)
        if not m:
            return
        kind, body = m.group(1), m.group(2)
        fields = _parse_structured(body)
        fid = fields.get("ID", "")
        hf = HeaderField(field_id=fid, number=fields.get("Number", "1"),
                         ftype=fields.get("Type", "String"), line=line)
        if kind == "INFO":
            self.infos[fid] = hf
        elif kind == "FORMAT":
            self.formats[fid] = hf
        elif kind == "FILTER":
            self.filters[fid] = hf
        elif kind == "contig":
            self.contigs[fid] = int(fields.get("length", "0"))

    def filter_ids_in_order(self) -> List[str]:
        """FILTER ids in htslib dictionary order: PASS implicitly first,
        then header-line order."""
        ids = ["PASS"]
        for line in self.lines:
            m = _STRUCT_RE.match(line)
            if m and m.group(1) == "FILTER":
                fid = _parse_structured(m.group(2)).get("ID")
                if fid and fid not in ids:
                    ids.append(fid)
        return ids


@dataclass
class VCFRecord:
    chrom: str
    pos: int          # 1-based
    rec_id: str
    ref: str
    alts: List[str]   # raw ALT strings (may be symbolic like <NON_REF>)
    qual: Optional[float]
    filters: List[str]  # [] means "."
    info: Dict[str, Optional[str]]  # flag -> None
    fmt: List[str]
    sample_values: List[List[str]]  # per sample, split by ':'


def open_text(path: str):
    """Text handle for a VCF input: plain, bgzip (.vcf.gz), or BCF2
    (.bcf — htslib-importable in the reference via vcf2binary.cc; here
    decoded by the from-spec vcf/bcf.py reader).  Detection is by
    content magic, not extension."""
    with open(path, "rb") as f:
        head = f.read(5)
    if head[:2] == b"\x1f\x8b":
        with gzip.open(path, "rb") as f:
            magic = f.read(5)
        if magic == b"BCF\x02\x02":
            import io

            from .bcf import bcf_to_text
            with gzip.open(path, "rb") as f:
                return io.StringIO(bcf_to_text(f.read()))
        return gzip.open(path, "rt")
    if head == b"BCF\x02\x02":
        import io

        from .bcf import bcf_to_text
        with open(path, "rb") as f:
            return io.StringIO(bcf_to_text(f.read()))
    return open(path, "rt")


def read_header(fobj) -> VCFHeader:
    hdr = VCFHeader()
    for line in fobj:
        if line.startswith("##"):
            hdr.add_line(line)
        elif line.startswith("#CHROM"):
            cols = line.rstrip("\n").split("\t")
            hdr.samples = cols[9:] if len(cols) > 9 else []
            break
        else:
            break
    return hdr


def parse_record(line: str) -> VCFRecord:
    cols = line.rstrip("\n").split("\t")
    chrom, pos, rec_id, ref, alt, qual, filt, info = cols[:8]
    alts = [] if alt == "." else alt.split(",")
    qual_v = None if qual == "." else float(qual)
    filters = [] if filt == "." else filt.split(";")
    info_d: Dict[str, Optional[str]] = {}
    if info != ".":
        for item in info.split(";"):
            if not item:
                continue
            if "=" in item:
                k, v = item.split("=", 1)
                info_d[k] = v
            else:
                info_d[item] = None
    fmt = cols[8].split(":") if len(cols) > 8 and cols[8] != "." else []
    sample_values = [c.split(":") for c in cols[9:]]
    return VCFRecord(chrom=chrom, pos=int(pos), rec_id=rec_id, ref=ref,
                     alts=alts, qual=qual_v, filters=filters, info=info_d,
                     fmt=fmt, sample_values=sample_values)


class VCFFile:
    """Header + record iteration for one VCF file."""

    def __init__(self, path: str):
        self.path = path
        self._fobj = open_text(path)
        self.header = read_header(self._fobj)

    def __iter__(self):
        for line in self._fobj:
            if not line.strip() or line.startswith("#"):
                continue
            yield parse_record(line)

    def close(self):
        self._fobj.close()
