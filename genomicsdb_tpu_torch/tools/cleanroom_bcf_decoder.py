"""Cleanroom BCF2.2 decoder — an INDEPENDENT check of the query-stream
byte contract.

Written from the VCFv4.2/BCF2 specification tables alone (the same
tables htsjdk's BCF2Codec implements against,
reader/GenomicsDBQueryStream.java:38): it imports NOTHING from
the package (stdlib only) and shares no code with vcf/bcf.py, so a
record-by-record match between this decoder's text and the golden VCF
proves the stream's bytes are spec-valid for a foreign consumer — the
strongest check available in an environment with no pysam/bcftools/JVM.

Spec facts used (section numbers from the VCFv4.2 spec, BCF2.2 layout):
  * magic "BCF\\2\\2"; uint32 l_text; header text block
  * per record: uint32 l_shared, l_indiv; int32 CHROM idx, POS(0-based),
    rlen; float32 QUAL (missing 0x7F800001);
    uint32 n_allele<<16|n_info; uint32 n_fmt<<24|n_sample;
    typed ID string, n_allele typed allele strings, typed FILTER int
    vector, n_info (typed int key, typed value) pairs; then n_fmt
    (typed int key, typed per-sample vector) blocks
  * typed descriptor byte: low nibble = type (1 int8, 2 int16, 3 int32,
    5 float32, 7 char, 0 MISSING/flag), high nibble = length, 15 =
    length follows as a typed int
  * int missing/END_OF_VECTOR sentinels: 0x80/0x81 (int8),
    0x8000/0x8001 (int16), 0x80000000/0x80000001 (int32); float
    0x7F800001 / 0x7F800002
  * string dictionary: ##FILTER/##INFO/##FORMAT header lines by IDX=
    (else order of first appearance), "PASS" implicitly index 0;
    contig dictionary from ##contig lines
  * GT int encoding: value = (allele + 1) << 1 | phased; 0 = "."
"""

from __future__ import annotations

import math
import re
import struct
from typing import List, Optional, Tuple

INT8_MISSING = -128
INT8_EOV = -127
INT16_MISSING = -32768
INT16_EOV = -32767
INT32_MISSING = -2147483648
INT32_EOV = -2147483647
FLOAT_MISSING_BITS = 0x7F800001
FLOAT_EOV_BITS = 0x7F800002


class Reader:
    def __init__(self, data: bytes, pos: int = 0):
        self.d = data
        self.p = pos

    def take(self, n: int) -> bytes:
        b = self.d[self.p:self.p + n]
        if len(b) != n:
            raise ValueError("truncated stream")
        self.p += n
        return b

    def u8(self):
        return self.take(1)[0]

    def u32(self):
        return struct.unpack("<I", self.take(4))[0]

    def i32(self):
        return struct.unpack("<i", self.take(4))[0]

    def f32_bits(self):
        return struct.unpack("<I", self.take(4))[0]


def _typed_descriptor(r: Reader) -> Tuple[int, int]:
    """(type, length) of the next typed value."""
    b = r.u8()
    t = b & 0x0F
    ln = b >> 4
    if ln == 15:
        t2, n2 = _typed_descriptor(r)
        vals = _read_typed_body(r, t2, n2)
        ln = int(vals[0])
    return t, ln


def _read_typed_body(r: Reader, t: int, n: int) -> list:
    if t == 0:
        return []
    if t == 1:
        return list(struct.unpack(f"<{n}b", r.take(n)))
    if t == 2:
        return list(struct.unpack(f"<{n}h", r.take(2 * n)))
    if t == 3:
        return list(struct.unpack(f"<{n}i", r.take(4 * n)))
    if t == 5:
        return list(struct.unpack(f"<{n}I", r.take(4 * n)))  # raw bits
    if t == 7:
        return [r.take(n)]          # char vector = one byte string
    raise ValueError(f"unknown BCF2 type {t}")


def read_typed(r: Reader):
    t, n = _typed_descriptor(r)
    return t, _read_typed_body(r, t, n)


def _int_sentinels(t: int) -> Tuple[int, int]:
    return {1: (INT8_MISSING, INT8_EOV), 2: (INT16_MISSING, INT16_EOV),
            3: (INT32_MISSING, INT32_EOV)}[t]


def kputd(bits_or_float) -> str:
    """htslib's kputd float rendering (what VCF text files carry):
    %g outside [1e-4, 1e6); else fixed point at 6 significant digits,
    trailing zeros trimmed, at least one decimal digit kept."""
    if isinstance(bits_or_float, int):
        d = struct.unpack("<f", struct.pack("<I", bits_or_float))[0]
    else:
        d = float(bits_or_float)
    if d == 0:
        return "-0" if math.copysign(1.0, d) < 0 else "0"
    sign = "-" if d < 0 else ""
    d = abs(d)
    if d < 0.0001 or d > 999999:
        return sign + ("%g" % d)
    decimals = 6 - (int(math.floor(math.log10(d))) + 1)
    if decimals < 0:
        decimals = 0
    s = f"%.{decimals}f" % d
    if "." in s:
        s = s.rstrip("0")
        if s.endswith("."):
            s += "0"
    else:
        s += ".0"
    return sign + s


class HeaderDict:
    """String + contig dictionaries from the embedded header text."""

    def __init__(self, text: str):
        self.lines = [ln for ln in text.split("\n") if ln]
        self.strings: List[str] = []
        self.contigs: List[str] = []
        self.info_type: dict = {}     # name -> (Type, Number)
        self.fmt_type: dict = {}
        seen = {}
        explicit_idx = {}
        for ln in self.lines:
            m = re.match(r"##(FILTER|INFO|FORMAT)=<(.*)>$", ln)
            if m:
                kind, body = m.group(1), m.group(2)
                fid = re.search(r"ID=([^,>]+)", body).group(1)
                mi = re.search(r"IDX=(\d+)", body)
                if mi:
                    explicit_idx[fid] = int(mi.group(1))
                if fid not in seen:
                    seen[fid] = True
                    self.strings.append(fid)
                ty = re.search(r"Type=([^,>]+)", body)
                num = re.search(r"Number=([^,>]+)", body)
                ty = ty.group(1) if ty else None
                num = num.group(1) if num else None
                if kind == "INFO":
                    self.info_type[fid] = (ty, num)
                elif kind == "FORMAT":
                    self.fmt_type[fid] = (ty, num)
                continue
            m = re.match(r"##contig=<(.*)>$", ln)
            if m:
                cid = re.search(r"ID=([^,>]+)", m.group(1)).group(1)
                self.contigs.append(cid)
        if "PASS" not in seen:
            self.strings.insert(0, "PASS")
        if explicit_idx:
            # IDX= entries fix dictionary positions explicitly
            size = max(explicit_idx.values()) + 1
            arr: List[Optional[str]] = [None] * max(size,
                                                    len(self.strings))
            rest = [s for s in self.strings if s not in explicit_idx]
            for fid, i in explicit_idx.items():
                while i >= len(arr):
                    arr.append(None)
                arr[i] = fid
            it = iter(rest)
            for i, v in enumerate(arr):
                if v is None:
                    try:
                        arr[i] = next(it)
                    except StopIteration:
                        break
            self.strings = [s for s in arr if s is not None]

    @property
    def n_samples(self) -> int:
        cols = self.lines[-1].split("\t")
        return max(0, len(cols) - 9)


def _render_int(v: int, t: int) -> Optional[str]:
    miss, eov = _int_sentinels(t)
    if v == eov:
        return None                  # end of vector
    if v == miss:
        return "."
    return str(v)


def _render_float_bits(bits: int) -> Optional[str]:
    if bits == FLOAT_EOV_BITS:
        return None
    if bits == FLOAT_MISSING_BITS:
        return "."
    return kputd(bits)


def _vector_to_text(t: int, vals: list) -> str:
    """Comma-joined vector with missing '.' and end-of-vector
    truncation (INFO values and non-GT FORMAT values)."""
    out = []
    if t == 7:
        s = vals[0].split(b"\0")[0] if vals else b""
        return s.decode() if s else "."
    for v in vals:
        if t == 5:
            s = _render_float_bits(v)
        else:
            s = _render_int(v, t)
        if s is None:
            break
        out.append(s)
    return ",".join(out) if out else "."


def _gt_to_text(t: int, vals: list) -> str:
    out = []
    miss, eov = _int_sentinels(t)
    for i, v in enumerate(vals):
        if v == eov:
            break
        if v == miss or v == 0:
            a = "."
            phased = False
        else:
            a = str((v >> 1) - 1)
            phased = bool(v & 1)
        if i:
            out.append("|" if phased else "/")
        out.append(a)
    return "".join(out) if out else "."


def decode(data: bytes) -> List[str]:
    """BCF2.2 bytes -> VCF text lines (header lines + record lines)."""
    if data[:5] != b"BCF\x02\x02":
        raise ValueError("not BCF2.2")
    r = Reader(data, 5)
    l_text = r.u32()
    text = r.take(l_text).split(b"\0")[0].decode()
    hd = HeaderDict(text)
    lines = list(hd.lines)
    n_sample_hdr = hd.n_samples
    while r.p < len(r.d):
        l_shared = r.u32()
        l_indiv = r.u32()
        body_end = r.p + l_shared + l_indiv
        chrom_i = r.i32()
        pos0 = r.i32()
        r.i32()                      # rlen
        qual_bits = r.f32_bits()
        x = r.u32()
        n_info, n_allele = x & 0xFFFF, x >> 16
        y = r.u32()
        n_sample, n_fmt = y & 0xFFFFFF, y >> 24
        assert n_sample == n_sample_hdr, (n_sample, n_sample_hdr)
        _, idv = read_typed(r)
        rid = (idv[0].split(b"\0")[0].decode() if idv and idv[0]
               else ".") or "."
        alleles = []
        for _ in range(n_allele):
            _, av = read_typed(r)
            alleles.append(av[0].decode() if av else "")
        tf, fv = read_typed(r)
        if fv:
            filt = ";".join(hd.strings[int(v)] for v in fv)
        else:
            filt = "."
        info_parts = []
        for _ in range(n_info):
            _, kv = read_typed(r)
            key = hd.strings[int(kv[0])]
            vt, vv = read_typed(r)
            if vt == 0:
                info_parts.append(key)      # flag
            else:
                info_parts.append(f"{key}={_vector_to_text(vt, vv)}")
        r.p = r.p  # shared block fully consumed
        fmt_keys = []
        sample_cols = [[] for _ in range(n_sample)]
        for _ in range(n_fmt):
            _, kv = read_typed(r)
            key = hd.strings[int(kv[0])]
            fmt_keys.append(key)
            vt, per = _typed_descriptor(r)
            for s in range(n_sample):
                vals = _read_typed_body(r, vt, per)
                if vt == 7:
                    raw = vals[0] if vals else b""
                    sval = raw.split(b"\0")[0].decode() or "."
                elif key == "GT":
                    sval = _gt_to_text(vt, vals)
                else:
                    sval = _vector_to_text(vt, vals)
                sample_cols[s].append(sval)
        if r.p != body_end:
            raise ValueError(f"record length mismatch: at {r.p}, "
                             f"expected {body_end}")
        cols = [hd.contigs[chrom_i], str(pos0 + 1), rid,
                alleles[0] if alleles else ".",
                ",".join(alleles[1:]) if len(alleles) > 1 else ".",
                _render_float_bits(qual_bits) or ".",
                filt,
                ";".join(info_parts) if info_parts else "."]
        if n_fmt:
            cols.append(":".join(fmt_keys))
            for s in range(n_sample):
                cols.append(":".join(sample_cols[s]))
        lines.append("\t".join(cols))
    return lines


def main(argv=None):
    """Print the VCF text of the BCF2 stream in the file argv[0]."""
    import sys
    argv = argv or sys.argv[1:]
    if len(argv) != 1 or argv[0] in ("-h", "--help"):
        print("usage: python -m genomicsdb_tpu_torch.tools."
              "cleanroom_bcf_decoder <stream.bcf>\n\n" + __doc__)
        return 0 if argv[:1] in (["-h"], ["--help"]) else 2
    path = argv[0]
    with open(path, "rb") as f:
        data = f.read()
    for ln in decode(data):
        print(ln)


if __name__ == "__main__":
    raise SystemExit(main())
