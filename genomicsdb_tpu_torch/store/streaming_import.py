"""Streaming (buffer-stream) import.

Equivalent of the reference's GenomicsDBImporter streaming mode
(include/loader/genomicsdb_importer.h:46-144 + JNI
genomicsdb_GenomicsDBImporter.cc:37-326, driven by GATK4's
GenomicsDBImport): callers register named byte streams, push VCF text
chunks incrementally, and pump `import_batch()`; `is_done()` reflects
exhausted-stream back-pressure (tiledb_loader.cc:700-702).
"""

from __future__ import annotations

import io
from typing import Dict, List, Optional, Tuple

from ..core.vid import VidMapper
from ..vcf.reader import VCFHeader, parse_record, read_header
from .columnar import ColumnarStore
from .import_pipeline import VCFCellConverter, cells_to_store


BCF_MAGIC = b"BCF\x02\x02"


class _BufferStream:
    def __init__(self, name: str):
        self.name = name
        self.buffer = b""
        self.header: Optional[VCFHeader] = None
        self.header_lines: List[str] = []
        self.exhausted = False
        # "text" | "bcf", sniffed from the first 5 bytes — GATK4's
        # streaming import pushes BCF2-encoded streams by default
        # (GenomicsDBImporter useBCF; the JNI buffer carries the BCF2
        # header block + records)
        self.mode: Optional[str] = None

    def write(self, data: bytes):
        self.buffer += data
        self.exhausted = False

    def sniff(self) -> Optional[str]:
        if self.mode is None and len(self.buffer) >= 5:
            self.mode = "bcf" if self.buffer[:5] == BCF_MAGIC else "text"
        return self.mode

    def take_complete_lines(self) -> List[str]:
        if b"\n" not in self.buffer:
            return []
        body, _, rest = self.buffer.rpartition(b"\n")
        self.buffer = rest
        return (body.decode()).split("\n")

    def take_bcf_records(self) -> List[str]:
        """Consume complete BCF2 records (after the header block),
        decoded to VCF text lines via the from-spec reader.  Floats are
        decoded exactly (`bcf.exact_float_bits`), so a BCF2 stream
        imports the float32 values a text import of the same records
        stores; htslib's 6-digit rendering would round them."""
        import struct as _struct

        from ..vcf import bcf as _bcf
        out: List[str] = []
        if self.header is None:
            if len(self.buffer) < 9:
                return out
            (l_header,) = _struct.unpack_from("<I", self.buffer, 5)
            if len(self.buffer) < 9 + l_header:
                return out
            htext = self.buffer[9:9 + l_header].rstrip(b"\0").decode()
            self.header_lines = htext.splitlines()
            self._hd = _bcf._HeaderDict(self.header_lines)
            self._n_sample = max(
                0, len(self.header_lines[-1].split("\t")) - 9)
            self.header = read_header(io.StringIO(
                "\n".join(self.header_lines) + "\n"))
            self.buffer = self.buffer[9 + l_header:]
        while len(self.buffer) >= 8:
            l_shared, l_indiv = _struct.unpack_from("<II", self.buffer,
                                                    0)
            total = 8 + l_shared + l_indiv
            if len(self.buffer) < total:
                break
            r = _bcf._Reader(self.buffer[:total])
            out.append(_bcf._decode_record(r, self._hd, self._n_sample,
                                           _bcf.exact_float_bits))
            self.buffer = self.buffer[total:]
        return out


class StreamingImporter:
    """Push-based importer over named VCF byte streams."""

    def __init__(self, vid: VidMapper,
                 column_partition: Tuple[int, Optional[int]] = (0, None),
                 treat_deletions_as_intervals: bool = True):
        self.vid = vid
        self.partition = column_partition
        self.treat_deletions = treat_deletions_as_intervals
        self.streams: Dict[str, _BufferStream] = {}
        self.cells: List[dict] = []
        self._converters: Dict[str, VCFCellConverter] = {}
        self._setup_done = False

    def add_buffer_stream(self, name: str):
        """jniAddBufferStream equivalent."""
        self.streams[name] = _BufferStream(name)

    def setup(self):
        """Delayed loader setup (jniSetupGenomicsDBLoader): resolves
        stream -> row mappings from the callset map's stream names."""
        self._stream_rows: Dict[str, Dict[int, int]] = {}
        for cs in self.vid.callsets.values():
            key = cs.stream_name or cs.filename
            self._stream_rows.setdefault(key, {})[cs.idx_in_file] = \
                cs.row_idx
        self._setup_done = True

    def write(self, stream_name: str, data: bytes):
        """jniWriteDataToBufferStream equivalent."""
        if stream_name not in self.streams:
            raise KeyError(f"unknown stream {stream_name}")
        self.streams[stream_name].write(data)

    def import_batch(self) -> bool:
        """Consume all complete records currently buffered; returns True
        when every stream has pending (unconsumable) data == False, i.e.
        the loader is idle awaiting more input."""
        if not self._setup_done:
            self.setup()
        for stream in self.streams.values():
            mode = stream.sniff()
            if mode is None and stream.buffer:
                continue              # <5 bytes buffered: undetermined
            if mode == "bcf":
                records = stream.take_bcf_records()
                lines = []
            else:
                lines = stream.take_complete_lines()
                records = []
            for line in lines:
                if not line:
                    continue
                if line.startswith("#"):
                    stream.header_lines.append(line)
                    if line.startswith("#CHROM") and stream.header is None:
                        stream.header = read_header(io.StringIO(
                            "\n".join(stream.header_lines) + "\n"))
                else:
                    records.append(line)
            if records:
                conv = self._converter_for(stream)
                for line in records:
                    rec = parse_record(line)
                    conv_cells = self._convert_record(conv, rec)
                    self.cells.extend(conv_cells)
            stream.exhausted = True
        return all(s.exhausted for s in self.streams.values())

    def _converter_for(self, stream: _BufferStream) -> VCFCellConverter:
        conv = self._converters.get(stream.name)
        if conv is None:
            if stream.header is None:
                raise ValueError(
                    f"stream {stream.name}: records before header")

            class _Pseudo:
                header = stream.header
            idx_to_row = self._stream_rows.get(stream.name, {})
            conv = VCFCellConverter(_Pseudo(), self.vid, idx_to_row,
                                    self.treat_deletions)
            self._converters[stream.name] = conv
        return conv

    def _convert_record(self, conv: VCFCellConverter, rec) -> List[dict]:
        hdr = conv.vcf.header
        nsamples = len(hdr.samples)
        sample_rows = [conv.idx_to_row.get(i) for i in range(nsamples)]
        out = []
        col = self.vid.flatten_position(rec.chrom, rec.pos)
        end = conv._end_column(rec, col)
        alt = "|".join("&" if a == "<NON_REF>" else a for a in rec.alts)
        for local_idx, row in enumerate(sample_rows):
            if row is None:
                continue
            cell = {"row": row, "col": col, "end": end,
                    "REF": rec.ref, "ALT": alt}
            if conv.import_id and rec.rec_id and rec.rec_id != ".":
                cell["ID"] = rec.rec_id
            if rec.qual is not None:
                import numpy as np
                cell["QUAL"] = [np.float32(rec.qual)]
            cell["FILTER"] = [conv.filter_idx[f] for f in rec.filters
                              if f in conv.filter_idx]
            conv._convert_fields(rec, cell, local_idx, nsamples)
            out.append(cell)
        return out

    def finalize(self) -> ColumnarStore:
        """Build the columnar store from all imported cells (the global
        column-major merge, tiledb_loader.cc:845-964)."""
        return cells_to_store(self.cells, self.vid,
                              import_id="ID" in self.vid.fields,
                              column_partition=self.partition)
