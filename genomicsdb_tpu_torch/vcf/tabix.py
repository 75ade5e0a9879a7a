"""Tabix (.tbi) / CSI (.csi) index emission + from-spec region readers.

The reference's VCFAdapter can produce a TBI/CSI index alongside
compressed VCF output (vcf_adapter.h:89-133, index_output_VCF knob in
genomicsdb_config_base.h:90).  This module implements both index
formats from the htslib specifications (tabix.pdf / CSIv1.pdf /
htslib tbx.c, hts.c):

  * UCSC R-tree binning of records (reg2bin; TBI = fixed 6 levels with
    14-bit leaves, CSI = parameterized (min_shift, depth))
  * BGZF virtual file offsets (coffset << 16 | uoffset)
  * the 16 kb linear index (TBI) / per-bin loffset (CSI)
  * "TBI\\1" / "CSI\\1" containers, themselves BGZF-compressed

`IndexedVCFWriter` wraps the streaming BGZF writer and builds the index
at close — TBI by default, CSI when requested or when a coordinate
exceeds TBI's 2^29-1 capacity (htslib refuses .tbi there; we auto-pick
a CSI depth that fits, like `bcftools index` with --min-shift).
`TabixReader` is an independent from-spec reader for both formats,
used as the conformance oracle (no htslib/pysam in this environment)
and as the random-access query path for .vcf.gz workspaces.
"""

from __future__ import annotations

import bisect
import gzip
import os
import struct
from typing import Dict, List, Tuple

from .bgzf import BGZFWriter, compress

TBI_MAGIC = b"TBI\x01"
CSI_MAGIC = b"CSI\x01"
FMT_VCF = 2


def reg2bin(beg: int, end: int) -> int:
    """UCSC binning: smallest bin containing [beg, end), zero-based."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg: int, end: int) -> List[int]:
    """All bins overlapping [beg, end), zero-based (htslib reg2bins)."""
    out = [0]
    end -= 1
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585),
                        (14, 4681)):
        out.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return out


def reg2bin_csi(beg: int, end: int, min_shift: int, depth: int) -> int:
    """CSI binning: smallest bin containing [beg, end) for the
    parameterized scheme (htslib hts.c hts_reg2bin).  CSI(14, 5) is
    TBI's binning."""
    end -= 1
    s = min_shift
    t = ((1 << depth * 3) - 1) // 7
    for level in range(depth, 0, -1):
        if beg >> s == end >> s:
            return t + (beg >> s)
        s += 3
        t -= 1 << (level - 1) * 3
    return 0


def reg2bins_csi(beg: int, end: int, min_shift: int,
                 depth: int) -> List[int]:
    """All CSI bins overlapping [beg, end) (htslib hts_itr_query)."""
    out = [0]
    end -= 1
    s = min_shift + depth * 3
    base = 0
    for level in range(1, depth + 1):
        s -= 3
        base = base * 8 + 1
        out.extend(range(base + (beg >> s), base + (end >> s) + 1))
    return out


class TabixIndex:
    """Accumulates per-record placements; serializes the .tbi payload."""

    def __init__(self):
        self.names: List[str] = []
        self.rid: Dict[str, int] = {}
        # rid -> bin -> list of (voff_beg, voff_end)
        self.bins: List[Dict[int, List[Tuple[int, int]]]] = []
        self.linear: List[Dict[int, int]] = []

    def add(self, contig: str, beg0: int, end0: int, voff_beg: int,
            voff_end: int):
        rid = self.rid.get(contig)
        if rid is None:
            rid = len(self.names)
            self.rid[contig] = rid
            self.names.append(contig)
            self.bins.append({})
            self.linear.append({})
        b = reg2bin(beg0, end0 + 1)
        chunks = self.bins[rid].setdefault(b, [])
        if chunks and chunks[-1][1] == voff_beg:
            chunks[-1] = (chunks[-1][0], voff_end)    # merge adjacent
        else:
            chunks.append((voff_beg, voff_end))
        lin = self.linear[rid]
        for w in range(beg0 >> 14, (end0 >> 14) + 1):
            if w not in lin:
                lin[w] = voff_beg
    def serialize(self) -> bytes:
        out = bytearray(TBI_MAGIC)
        out += struct.pack("<i", len(self.names))
        out += struct.pack("<6i", FMT_VCF, 1, 2, 0, ord("#"), 0)
        names_blob = b"".join(n.encode() + b"\x00" for n in self.names)
        out += struct.pack("<i", len(names_blob)) + names_blob
        for rid in range(len(self.names)):
            bins = self.bins[rid]
            out += struct.pack("<i", len(bins))
            for b in sorted(bins):
                chunks = bins[b]
                out += struct.pack("<Ii", b, len(chunks))
                for cb, ce in chunks:
                    out += struct.pack("<QQ", cb, ce)
            lin = self.linear[rid]
            n_intv = (max(lin) + 1) if lin else 0
            out += struct.pack("<i", n_intv)
            prev = 0
            for w in range(n_intv):
                prev = lin.get(w, prev)
                out += struct.pack("<Q", prev)
        return bytes(out)

    def write(self, path: str):
        with open(path, "wb") as f:
            f.write(compress(self.serialize()))


class CSIIndex:
    """CSI v1 index with parameterized (min_shift, depth) binning.

    CSI(14, 5) reproduces TBI's binning but lifts the 2^29-1 coordinate
    cap: capacity is 2^(min_shift + 3*depth) - 1.  The tabix header
    (format/columns/names) rides in the aux section, as htslib's
    tbx.c does for tabix-over-CSI."""

    def __init__(self, min_shift: int = 14, depth: int = 5,
                 tabix_aux: bool = True):
        self.min_shift = min_shift
        self.depth = depth
        # tabix_aux: carry the tabix header in the aux section (.csi
        # over .vcf.gz, htslib tbx.c).  False = empty aux, the form
        # htslib's bcf_index_build writes for .bcf.csi, where record
        # rids come from the BCF header (seed those via ensure_contig).
        self.tabix_aux = tabix_aux
        self.names: List[str] = []
        self.rid: Dict[str, int] = {}
        self.bins: List[Dict[int, List[Tuple[int, int]]]] = []
        self.linear: List[Dict[int, int]] = []

    def ensure_contig(self, contig: str) -> int:
        rid = self.rid.get(contig)
        if rid is None:
            rid = len(self.names)
            self.rid[contig] = rid
            self.names.append(contig)
            self.bins.append({})
            self.linear.append({})
        return rid

    def add(self, contig: str, beg0: int, end0: int, voff_beg: int,
            voff_end: int):
        rid = self.ensure_contig(contig)
        b = reg2bin_csi(beg0, end0 + 1, self.min_shift, self.depth)
        chunks = self.bins[rid].setdefault(b, [])
        if chunks and chunks[-1][1] == voff_beg:
            chunks[-1] = (chunks[-1][0], voff_end)    # merge adjacent
        else:
            chunks.append((voff_beg, voff_end))
        lin = self.linear[rid]
        for w in range(beg0 >> self.min_shift,
                       (end0 >> self.min_shift) + 1):
            if w not in lin:
                lin[w] = voff_beg

    def _bin_start(self, b: int) -> int:
        """First genome coordinate covered by bin `b`."""
        base = 0
        for level in range(self.depth + 1):
            nxt = base * 8 + 1
            if level == self.depth or b < nxt:
                return (b - base) << (
                    self.min_shift + 3 * (self.depth - level))
            base = nxt
        return 0

    def serialize(self) -> bytes:
        if self.tabix_aux:
            aux = struct.pack("<6i", FMT_VCF, 1, 2, 0, ord("#"), 0)
            names_blob = b"".join(n.encode() + b"\x00"
                                  for n in self.names)
            aux += struct.pack("<i", len(names_blob)) + names_blob
        else:
            aux = b""
        out = bytearray(CSI_MAGIC)
        out += struct.pack("<3i", self.min_shift, self.depth, len(aux))
        out += aux
        out += struct.pack("<i", len(self.names))
        for rid in range(len(self.names)):
            bins = self.bins[rid]
            lin = self.linear[rid]
            lin_ws = sorted(lin)
            out += struct.pack("<i", len(bins))
            for b in sorted(bins):
                w = self._bin_start(b) >> self.min_shift
                i = bisect.bisect_right(lin_ws, w) - 1
                loffset = lin[lin_ws[i]] if i >= 0 else 0
                chunks = bins[b]
                out += struct.pack("<IQi", b, loffset, len(chunks))
                for cb, ce in chunks:
                    out += struct.pack("<QQ", cb, ce)
        return bytes(out)

    def write(self, path: str):
        with open(path, "wb") as f:
            f.write(compress(self.serialize()))


TBI_MAX_COORD = 1 << 29                 # tabix can't index past 2^29-1


def _csi_depth_for(max_end0: int, min_shift: int = 14) -> int:
    """Smallest CSI depth whose capacity covers coordinate max_end0."""
    depth = 5
    while (max_end0 >> (min_shift + 3 * depth)) > 0:
        depth += 1
    return depth


class IndexedVCFWriter:
    """Streaming BGZF VCF text writer that emits an index on close.

    Tracks BGZF virtual offsets per record: voffset =
    (compressed_block_start << 16) | offset_in_uncompressed_block.
    `index_format`: "auto" (default) writes .tbi, upgrading to .csi
    when a record coordinate exceeds tabix's 2^29-1 cap; "tbi"/"csi"
    force the format ("tbi" raises past the cap, matching htslib)."""

    def __init__(self, path: str, index_format: str = "auto",
                 min_shift: int = 14, depth: int = 5):
        if index_format not in ("auto", "tbi", "csi"):
            raise ValueError(f"unknown index format {index_format!r}")
        self._path = path
        self._w = BGZFWriter(path)
        self._fmt = index_format
        self._min_shift = min_shift
        self._depth = depth
        # raw placements; binned into the chosen format at close
        self._recs: List[Tuple[str, int, int, int, int]] = []
        self._max_end0 = 0
        self._tail = ""

    def _virtual_offset(self) -> int:
        return (self._w.file_offset() << 16) | len(self._w._buf)

    def write(self, data) -> int:
        if isinstance(data, bytes):
            data = data.decode()
        n = len(data)
        data = self._tail + data
        lines = data.split("\n")
        self._tail = lines.pop()
        for ln in lines:
            self._write_line(ln)
        return n

    def _write_line(self, ln: str):
        if not ln:
            return
        voff = self._virtual_offset()
        self._w.write(ln + "\n")
        if ln.startswith("#"):
            return
        cols = ln.split("\t", 8)
        contig, pos = cols[0], int(cols[1])
        end = pos + len(cols[3]) - 1
        if len(cols) > 7 and cols[7] != ".":
            for kv in cols[7].split(";"):
                if kv.startswith("END="):
                    end = int(kv[4:])
                    break
        self._recs.append((contig, pos - 1, end - 1, voff,
                           self._virtual_offset()))
        if end > self._max_end0:
            self._max_end0 = end

    def _build_index(self):
        fmt = self._fmt
        if fmt == "auto":
            fmt = "tbi" if self._max_end0 < TBI_MAX_COORD else "csi"
        if fmt == "tbi":
            if self._max_end0 >= TBI_MAX_COORD:
                raise ValueError(
                    f"coordinate {self._max_end0 + 1} exceeds tabix's "
                    f"2^29-1 limit; use index_format='csi'")
            idx = TabixIndex()
        else:
            depth = max(self._depth,
                        _csi_depth_for(self._max_end0, self._min_shift))
            idx = CSIIndex(self._min_shift, depth)
        for rec in self._recs:
            idx.add(*rec)
        return fmt, idx

    def close(self):
        if self._path is None:
            return
        if self._tail:
            self._write_line(self._tail)
            self._tail = ""
        self._w.close()
        fmt, idx = self._build_index()
        idx.write(self._path + "." + fmt)
        self._path = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# From-spec reader (conformance oracle + random-access query path)
# ---------------------------------------------------------------------------

def _bgzf_block_at(f, coffset: int) -> Tuple[bytes, int]:
    """Decompress the BGZF member starting at `coffset`; returns
    (payload, compressed_size)."""
    f.seek(coffset)
    header = f.read(18)
    if len(header) < 18:
        return b"", 0
    bsize = struct.unpack_from("<H", header, 16)[0] + 1
    f.seek(coffset)
    member = f.read(bsize)
    import zlib
    payload = zlib.decompress(member[18:-8], -15)
    return payload, bsize


class TabixReader:
    """Minimal from-spec .tbi / .csi + .vcf.gz region reader."""

    def __init__(self, path: str):
        self.path = path
        idx_path = path + ".tbi"
        if not os.path.exists(idx_path):
            idx_path = path + ".csi"
        raw = gzip.decompress(open(idx_path, "rb").read())
        self.bins: List[Dict[int, List[Tuple[int, int]]]] = []
        self.linear: List[List[int]] = []
        self.loffsets: List[Dict[int, int]] = []
        if raw[:4] == CSI_MAGIC:
            self._parse_csi(raw)
        elif raw[:4] == TBI_MAGIC:
            self._parse_tbi(raw)
        else:
            raise ValueError(f"{idx_path}: not a TBI/CSI index")
        self.rid = {n: i for i, n in enumerate(self.names)}

    def _parse_tbi(self, raw: bytes):
        self.min_shift, self.depth = 14, 5
        o = 4
        n_ref, fmt, col_seq, col_beg, col_end, meta, skip = \
            struct.unpack_from("<7i", raw, o)
        o += 28
        (l_nm,) = struct.unpack_from("<i", raw, o)
        o += 4
        names = raw[o:o + l_nm].split(b"\x00")[:-1]
        o += l_nm
        self.names = [n.decode() for n in names]
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", raw, o)
            o += 4
            bd: Dict[int, List[Tuple[int, int]]] = {}
            for _ in range(n_bin):
                b, n_chunk = struct.unpack_from("<Ii", raw, o)
                o += 8
                cl = []
                for _ in range(n_chunk):
                    cb, ce = struct.unpack_from("<QQ", raw, o)
                    o += 16
                    cl.append((cb, ce))
                bd[b] = cl
            (n_intv,) = struct.unpack_from("<i", raw, o)
            o += 4
            lin = list(struct.unpack_from(f"<{n_intv}Q", raw, o))
            o += 8 * n_intv
            self.bins.append(bd)
            self.linear.append(lin)
            self.loffsets.append({})

    def _parse_csi(self, raw: bytes):
        o = 4
        self.min_shift, self.depth, l_aux = struct.unpack_from(
            "<3i", raw, o)
        o += 12
        aux = raw[o:o + l_aux]
        o += l_aux
        # tabix header rides in aux: 6 ints then nul-separated names
        (l_nm,) = struct.unpack_from("<i", aux, 24)
        names = aux[28:28 + l_nm].split(b"\x00")[:-1]
        self.names = [n.decode() for n in names]
        (n_ref,) = struct.unpack_from("<i", raw, o)
        o += 4
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", raw, o)
            o += 4
            bd: Dict[int, List[Tuple[int, int]]] = {}
            lo: Dict[int, int] = {}
            for _ in range(n_bin):
                b, loffset, n_chunk = struct.unpack_from("<IQi", raw, o)
                o += 16
                cl = []
                for _ in range(n_chunk):
                    cb, ce = struct.unpack_from("<QQ", raw, o)
                    o += 16
                    cl.append((cb, ce))
                bd[b] = cl
                lo[b] = loffset
            self.bins.append(bd)
            self.linear.append([])
            self.loffsets.append(lo)

    def _min_offset(self, rid: int, beg0: int) -> int:
        """Lower bound on the virtual offset of records reaching beg0:
        the TBI 16kb linear index, or for CSI the loffset of the
        nearest present ancestor of beg0's leaf bin (htslib
        hts_itr_query)."""
        lin = self.linear[rid]
        if lin:
            return lin[min(beg0 >> 14, len(lin) - 1)]
        lo = self.loffsets[rid]
        b = reg2bin_csi(beg0, beg0 + 1, self.min_shift, self.depth)
        while b:
            if b in lo:
                return lo[b]
            b = (b - 1) >> 3
        return lo.get(0, 0)

    def query(self, contig: str, beg1: int, end1: int) -> List[str]:
        """Records overlapping [beg1, end1] (1-based inclusive)."""
        rid = self.rid.get(contig)
        if rid is None:
            return []
        beg0, end0 = beg1 - 1, end1
        chunks = []
        for b in reg2bins_csi(beg0, end0, self.min_shift, self.depth):
            chunks.extend(self.bins[rid].get(b, []))
        if not chunks:
            return []
        min_off = self._min_offset(rid, beg0)
        chunks = sorted((cb, ce) for cb, ce in chunks if ce > min_off)
        out = []
        with open(self.path, "rb") as f:
            for cb, ce in chunks:
                for ln in self._lines_between(f, max(cb, min_off), ce):
                    cols = ln.split("\t", 8)
                    if cols[0] != contig:
                        continue
                    pos = int(cols[1])
                    rec_end = pos + len(cols[3]) - 1
                    if len(cols) > 7:
                        for kv in cols[7].split(";"):
                            if kv.startswith("END="):
                                rec_end = int(kv[4:])
                                break
                    if pos <= end1 and rec_end >= beg1:
                        out.append(ln)
        # chunks may overlap: dedupe, keep file order
        seen = set()
        uniq = []
        for ln in out:
            if ln not in seen:
                seen.add(ln)
                uniq.append(ln)
        return uniq

    def _lines_between(self, f, voff_beg: int, voff_end: int):
        coff, uoff = voff_beg >> 16, voff_beg & 0xFFFF
        text = bytearray()
        while True:
            payload, csize = _bgzf_block_at(f, coff)
            if not payload and csize == 0:
                break
            if coff == voff_beg >> 16:
                at_end = coff == (voff_end >> 16)
                hi = (voff_end & 0xFFFF) if at_end else len(payload)
                text += payload[uoff:hi]
            else:
                at_end = coff == (voff_end >> 16)
                hi = (voff_end & 0xFFFF) if at_end else len(payload)
                text += payload[:hi]
            if coff >= (voff_end >> 16):
                break
            coff += csize
        for ln in bytes(text).decode().split("\n"):
            if ln:
                yield ln
