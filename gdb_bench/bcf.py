"""A BCF2 reader for the benchmark's side (numpy only): the served
response of a lookup back to VCF text lines, so that it is judged by
the same comparison as a combine's text.  Float fields are rendered by
the caller's `floats` (htslib's six-digit text, or `float_bits`: the
float32 word itself, as the answer carries it).

The format is the BCF2.2 specification's: "BCF\\2\\2", the header
text, then records of a shared part (CHROM, POS, rlen, QUAL, counts,
ID, alleles, FILTER, INFO) and a per-sample part (each FORMAT field as
one typed block over all samples).  Header IDs of FILTER, INFO and
FORMAT lines form the string dictionary in the order they first appear,
with PASS first; contigs the contig dictionary.
"""

from __future__ import annotations

import re
import struct
from typing import Dict, List, Tuple

import numpy as np

from .reference import format_float

_INT = {1: np.int8, 2: np.int16, 3: np.int32}
_FLOAT_MISSING, _FLOAT_END = 0x7F800001, 0x7F800002


class Header:
    def __init__(self, text: str):
        self.strings: List[str] = ["PASS"]
        self.contigs: List[str] = []
        self.samples: List[str] = []
        for line in text.rstrip("\0").splitlines():
            m = re.match(r"##(FILTER|INFO|FORMAT|contig)=<ID=([^,>]+)", line)
            if m:
                kind, ident = m.groups()
                if kind == "contig":
                    self.contigs.append(ident)
                elif ident not in self.strings:
                    self.strings.append(ident)
            elif line.startswith("#CHROM"):
                self.samples = line.split("\t")[9:]


def split_stream(data: bytes) -> Tuple[Header, List[Tuple[int, int]]]:
    """The header and the (offset, length) of every record."""
    if data[:5] != b"BCF\x02\x02":
        raise ValueError("not a BCF2.2 stream")
    (n,) = struct.unpack_from("<I", data, 5)
    hd = Header(data[9:9 + n].decode())
    recs, off = [], 9 + n
    while off < len(data):
        ls, li = struct.unpack_from("<II", data, off)
        recs.append((off, 8 + ls + li))
        off += 8 + ls + li
    if off != len(data):
        raise ValueError("truncated BCF2 record")
    return hd, recs


def record_pos(data: bytes, off: int) -> int:
    """1-based POS of the record at `off`."""
    return struct.unpack_from("<i", data, off + 12)[0] + 1


class _Reader:
    def __init__(self, data: bytes, off: int):
        self.d, self.o = data, off

    def typed(self):
        """(type code, count, raw bytes) of one typed value."""
        b = self.d[self.o]
        self.o += 1
        t, n = b & 0xF, b >> 4
        if n == 15:
            t2, n2, raw = self.typed()
            n = int(np.frombuffer(raw, _INT[t2])[0])
        size = 4 if t in (3, 5) else (2 if t == 2 else 1)
        raw = self.d[self.o:self.o + n * size]
        self.o += n * size
        return t, n, raw


def _ints(t: int, raw: bytes) -> np.ndarray:
    """Decoded ints: int64 with the BCF missing / vector-end values as
    the type's two lowest values."""
    a = np.frombuffer(raw, _INT[t]).astype(np.int64)
    lo = np.iinfo(_INT[t]).min
    return a, lo, lo + 1


def _int_text(vals, miss, end) -> str:
    out = []
    for x in vals:
        if x == end:
            break
        out.append("." if x == miss else str(int(x)))
    return ",".join(out) if out else "."


def _float_text(raw: bytes, floats) -> str:
    out = []
    for b in np.frombuffer(raw, np.uint32):
        if b == _FLOAT_END:
            break
        out.append("." if b == _FLOAT_MISSING else
                   floats(np.uint32(b).view(np.float32)))
    return ",".join(out) if out else "."


def _gt_text(vals, miss, end) -> str:
    out = []
    for k, x in enumerate(vals):
        if x == end:
            break
        allele = "." if x == miss or (x >> 1) == 0 else str((x >> 1) - 1)
        out.append(allele if k == 0 else ("|" if x & 1 else "/") + allele)
    return "".join(out) if out else "."


def _value_text(t: int, n: int, raw: bytes, floats) -> str:
    if t == 7:
        return raw.rstrip(b"\0").decode()
    if t == 5:
        return _float_text(raw, floats)
    a, miss, end = _ints(t, raw)
    return _int_text(a, miss, end)


def record_text(data: bytes, off: int, hd: Header, cache=None,
                floats=format_float) -> str:
    """The VCF line of the record at `off` (`cache`: rendered sample
    values, shared by the records of one stream)."""
    cache = {} if cache is None else cache
    chrom, pos, _rlen = struct.unpack_from("<iii", data, off + 8)
    (qual,) = struct.unpack_from("<I", data, off + 20)
    n_ai, n_fs = struct.unpack_from("<II", data, off + 24)
    n_info, n_allele = n_ai & 0xFFFF, n_ai >> 16
    n_sample, n_fmt = n_fs & 0xFFFFFF, n_fs >> 24
    r = _Reader(data, off + 32)
    ident = _value_text(*r.typed(), floats)
    alleles = [r.typed()[2].rstrip(b"\0").decode() for _ in range(n_allele)]
    t, n, raw = r.typed()
    filt = [hd.strings[int(i)] for i in _ints(t, raw)[0]] if n else []
    info = []
    for _ in range(n_info):
        t, _, raw = r.typed()
        key = hd.strings[int(_ints(t, raw)[0][0])]
        t, n, raw = r.typed()
        info.append(key if t == 0 else
                    f"{key}={_value_text(t, n, raw, floats)}")
    keys, cols = [], []
    for _ in range(n_fmt):
        t, _, raw = r.typed()
        key = hd.strings[int(_ints(t, raw)[0][0])]
        b = data[r.o]
        r.o += 1
        t, n = b & 0xF, b >> 4
        if n == 15:
            t2, _, raw = r.typed()
            n = int(np.frombuffer(raw, _INT[t2])[0])
        size = 4 if t in (3, 5) else (2 if t == 2 else 1)
        block = data[r.o:r.o + n_sample * n * size]
        r.o += n_sample * n * size
        keys.append(key)
        cols.append(_format_column(key, t, n, size, block, n_sample,
                                   cache, floats))
    samples = ["\t".join(map(":".join, zip(*cols)))] if n_fmt else []
    return "\t".join(
        [hd.contigs[chrom], str(pos + 1), ident or ".", alleles[0],
         ",".join(alleles[1:]) or ".",
         "." if qual == _FLOAT_MISSING else floats(
             np.uint32(qual).view(np.float32)),
         ";".join(filt) or ".", ";".join(info) or ".",
         ":".join(keys) or "."] + samples)


def _format_column(key, t, n, size, block, n_sample, cache,
                   floats) -> List[str]:
    """One FORMAT field's text for every sample: each distinct sample
    value (its bytes) is rendered once per stream."""
    if n == 0:
        return ["."] * n_sample
    seen = cache.setdefault((key == "GT", t), {})
    w = n * size
    out = []
    for j in range(0, n_sample * w, w):
        raw = block[j:j + w]
        text = seen.get(raw)
        if text is None:
            if t == 7:
                text = raw.rstrip(b"\0").decode() or "."
            elif t == 5:
                text = _float_text(raw, floats)
            else:
                a, miss, end = _ints(t, raw)
                text = _gt_text(a, miss, end) if key == "GT" \
                    else _int_text(a, miss, end)
            seen[raw] = text
        out.append(text)
    return out


def bcf_lines(data: bytes, floats=format_float) -> List[str]:
    """Every record of a BCF2 stream as a VCF line."""
    hd, recs = split_stream(data)
    cache: Dict = {}
    return [record_text(data, off, hd, cache, floats) for off, _ in recs]
