"""BGZF writer: blocked gzip with the BC extra field + EOF marker.

The reference's VCFAdapter opens compressed VCF output with htslib mode
"z" (vcf_adapter.cc output-format handling); BGZF is the htslib framing:
a series of <=64 KiB gzip members, each carrying the compressed block
size in a BC extra subfield, terminated by a fixed 28-byte EOF block.
Readable by gzip, tabix-indexable by htslib.
"""

from __future__ import annotations

import struct
import zlib

MAX_BLOCK = 0xFF00  # uncompressed payload per block (htslib bgzf.c)

# htslib's magic EOF block (bgzf.c)
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def _block(payload: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = co.compress(payload) + co.flush()
    bsize = len(comp) + 25 + 1  # header(12)+xtra(6)+deflate+crc(4)+isize(4)
    header = struct.pack(
        "<4BI2BH2BH",
        0x1F, 0x8B, 8, 4,        # gzip magic, deflate, FEXTRA
        0,                       # mtime
        0, 0xFF,                 # XFL, OS=unknown
        6,                       # XLEN
        0x42, 0x43, 2) + struct.pack("<H", bsize - 1)
    tail = struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                       len(payload) & 0xFFFFFFFF)
    return header + comp + tail


def compress(data: bytes) -> bytes:
    """Whole-buffer BGZF compression (with EOF marker)."""
    out = bytearray()
    for i in range(0, len(data), MAX_BLOCK):
        out += _block(data[i:i + MAX_BLOCK])
    out += BGZF_EOF
    return bytes(out)


class BGZFWriter:
    """Streaming BGZF file writer.  Tracks the compressed file offset so
    wrappers can compute BGZF virtual offsets
    ((file_offset << 16) | position_in_uncompressed_block)."""

    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._buf = bytearray()
        self._foff = 0

    def file_offset(self) -> int:
        """Compressed-file offset of the block currently buffering."""
        return self._foff

    def write(self, data) -> int:
        if isinstance(data, str):
            data = data.encode()
        self._buf += data
        while len(self._buf) >= MAX_BLOCK:
            blk = _block(bytes(self._buf[:MAX_BLOCK]))
            self._f.write(blk)
            self._foff += len(blk)
            del self._buf[:MAX_BLOCK]
        return len(data)

    def close(self) -> None:
        if self._f is None:
            return
        if self._buf:
            blk = _block(bytes(self._buf))
            self._f.write(blk)
            self._foff += len(blk)
            self._buf.clear()
        self._f.write(BGZF_EOF)
        self._foff += len(BGZF_EOF)
        self._f.close()
        self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BCFFileWriter:
    """Streams VCF text to BGZF-compressed BCF2.2 (htslib output mode
    "b").  Incoming text is spooled to a temp file; close() streams it
    back through the record encoder one line at a time, so resident
    memory stays O(record), not O(genome) — only the header lines are
    held in RAM.  Output bytes are identical to
    bgzf.compress(bcf.text_to_bcf(text))."""

    def __init__(self, path: str, index: bool = False):
        self._path = path
        self._index = index
        self._spool_path = path + ".spool.tmp"
        self._spool = open(self._spool_path, "w")

    def write(self, data) -> int:
        if isinstance(data, bytes):
            data = data.decode()
        self._spool.write(data)
        return len(data)

    def close(self) -> None:
        if self._path is None:
            return
        import os
        from . import bcf
        self._spool.close()
        try:
            with open(self._spool_path) as f:
                header_lines, headerless_nsample = self._scan_header(f)
                if header_lines[-1].startswith("#CHROM"):
                    chrom_line = header_lines[-1]
                else:  # headerless record stream: minimal header
                    n = headerless_nsample
                    chrom_line = (
                        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"
                        + ("\tFORMAT" + "".join(f"\tSAMPLE{i}"
                                                for i in range(n))
                           if n else ""))
                    header_lines = ["##fileformat=VCFv4.1", chrom_line]
                hd = bcf._HeaderDict(header_lines)
                f.seek(0)
                extra = bcf._synthesize_declarations(
                    self._record_lines(f), hd)
                if extra:
                    header_lines = (header_lines[:-1] + extra
                                    + [header_lines[-1]])
                    hd = bcf._HeaderDict(header_lines)
                n_sample = len(chrom_line.split("\t")[9:])
                recs = []          # (contig, beg0, end0, voff0, voff1)
                with BGZFWriter(self._path) as out:
                    header_text = "\n".join(header_lines) + "\n\0"
                    out.write(b"BCF\x02\x02")
                    out.write(struct.pack("<I", len(header_text)))
                    out.write(header_text.encode())
                    f.seek(0)
                    for ln in self._record_lines(f):
                        if self._index:
                            v0 = (out.file_offset() << 16) | len(out._buf)
                        out.write(bcf._encode_record(ln, hd, n_sample))
                        if self._index:
                            cols = ln.split("\t", 8)
                            pos = int(cols[1])
                            end = pos + len(cols[3]) - 1
                            if len(cols) > 7 and cols[7] != ".":
                                for kv in cols[7].split(";"):
                                    if kv.startswith("END="):
                                        end = int(kv[4:])
                                        break
                            v1 = (out.file_offset() << 16) \
                                | len(out._buf)
                            recs.append((cols[0], pos - 1, end - 1,
                                         v0, v1))
                if self._index:
                    self._write_csi(hd, recs)
        finally:
            os.remove(self._spool_path)
        self._path = None

    def _write_csi(self, hd, recs):
        """`path`.csi in htslib's bcf_index_build form: empty aux,
        rids in BCF-header contig order (vcf_adapter.h:89-133 produces
        an index with compressed output when asked)."""
        from .tabix import CSIIndex, _csi_depth_for
        max_end0 = max((e for _, _, e, _, _ in recs), default=0)
        idx = CSIIndex(14, max(5, _csi_depth_for(max_end0, 14)),
                       tabix_aux=False)
        for name in sorted(hd.contig_idx, key=hd.contig_idx.get):
            idx.ensure_contig(name)
        for rec in recs:
            idx.add(*rec)
        idx.write(self._path + ".csi")

    @staticmethod
    def _scan_header(f):
        """Header lines (up to and incl. #CHROM) + max sample count of a
        headerless stream.  Leaves `f` positioned arbitrarily."""
        header: list = []
        max_cols = 0
        for ln in f:
            ln = ln.rstrip("\n")
            if not ln:
                continue
            if ln.startswith("#CHROM"):
                header.append(ln)
                return header, 0
            if ln.startswith("#"):
                header.append(ln)
            else:
                max_cols = max(max_cols, len(ln.split("\t")) - 9)
        return (header or ["##fileformat=VCFv4.1"]), max(max_cols, 0)

    @staticmethod
    def _record_lines(f):
        in_header = True
        for ln in f:
            ln = ln.rstrip("\n")
            if not ln:
                continue
            if in_header and ln.startswith("#"):
                if ln.startswith("#CHROM"):
                    in_header = False
                continue
            in_header = False
            yield ln

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_output(path: str, fmt: str = "", index=False):
    """File object for VCF text output honoring the reference's
    vcf_output_format knob ("z"/"bgzf" or a .gz/.bgz filename -> BGZF
    text; "b"/"bcf" or a .bcf filename -> BGZF-framed BCF2.2 binary;
    otherwise plain text).  `index` emits a tabix index alongside
    compressed text output (index_output_VCF,
    genomicsdb_config_base.h:90): True/"auto" picks .tbi, upgrading to
    .csi past the 2^29-1 coordinate cap; "tbi"/"csi" force a format."""
    if fmt in ("b", "bcf") or path.endswith(".bcf"):
        return BCFFileWriter(path, index=bool(index))
    if fmt in ("z", "bgzf", "gz") or path.endswith((".gz", ".bgz")):
        if index:
            from .tabix import IndexedVCFWriter
            return IndexedVCFWriter(
                path, index_format=index if isinstance(index, str)
                else "auto")
        return BGZFWriter(path)
    return open(path, "w")
