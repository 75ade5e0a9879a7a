"""BCF2.2 binary encoding of combined-VCF text (+ decoder for round-trip).

The reference's Java stream path serves BCF2 bytes
(GenomicsDBBCFGenerator / VCFSerializedBufferAdapter "b" mode,
vcf_adapter.h:156, genomicsdb_bcf_generator.h:33); htslib mode "b" writes
BCF to disk.  This module encodes our byte-exact VCF text into the BCF2.2
record layout (uncompressed body; BGZF framing via vcf/bgzf.py), and
decodes it back for validation — text -> BCF -> text is byte-identical
for the combined-VCF dialect this engine emits.

Layout (htslib vcf.c / the BCFv2.2 spec):
  magic "BCF\\2\\2", u32 l_header, header text (NUL-terminated)
  per record: u32 l_shared, u32 l_indiv, then
    shared: s32 rid, s32 pos(0-based), s32 rlen, f32 qual,
            u32 n_allele<<16|n_info, u32 n_fmt<<24|n_sample,
            typed ID string, typed allele strings, typed FILTER int
            vector, n_info x (typed int key, typed value)
    indiv:  n_fmt x (typed int key, type descriptor, n_sample values)
  typed descriptor byte: (len<<4)|type, len==15 -> typed int follows
  types: 1=int8 2=int16 3=int32 5=float 7=char
  missing: int8 0x80 / int16 0x8000 / int32 0x80000000 / float bits
  0x7F800001; end-of-vector: +1 on each.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import formats

INT8_MISSING = -128
INT16_MISSING = -32768
INT32_MISSING = -2147483648
INT8_EOV = -127
INT16_EOV = -32767
INT32_EOV = -2147483647
FLOAT_MISSING_BITS = 0x7F800001
FLOAT_EOV_BITS = 0x7F800002

BCF_BT_INT8, BCF_BT_INT16, BCF_BT_INT32 = 1, 2, 3
BCF_BT_FLOAT, BCF_BT_CHAR = 5, 7


def _typed_descriptor(n: int, btype: int) -> bytes:
    if n < 15:
        return bytes([(n << 4) | btype])
    out = bytes([(15 << 4) | btype])
    return out + _typed_int(n)


def _typed_int(v: int) -> bytes:
    # width selection bounds match htslib vcf.c: BCF_MIN_BT_INT8 = -120,
    # BCF_MIN_BT_INT16 = -32760 (NOT INT16_MIN: missing/end sentinels
    # live below)
    if -120 <= v <= 127:
        return bytes([(1 << 4) | BCF_BT_INT8]) + struct.pack("<b", v)
    if -32760 <= v <= 32767:
        return bytes([(1 << 4) | BCF_BT_INT16]) + struct.pack("<h", v)
    return bytes([(1 << 4) | BCF_BT_INT32]) + struct.pack("<i", v)


def _typed_string(s: str) -> bytes:
    b = s.encode()
    return _typed_descriptor(len(b), BCF_BT_CHAR) + b


def _int_width(vals: List[int]) -> int:
    lo = min((v for v in vals if v != INT32_MISSING and v != INT32_EOV),
             default=0)
    hi = max((v for v in vals if v != INT32_MISSING and v != INT32_EOV),
             default=0)
    if -120 <= lo and hi <= 127:
        return BCF_BT_INT8
    if -32760 <= lo and hi <= 32767:
        return BCF_BT_INT16
    return BCF_BT_INT32


def _pack_ints(vals: List[int], btype: int) -> bytes:
    out = bytearray()
    for v in vals:
        if btype == BCF_BT_INT8:
            out += struct.pack(
                "<b", INT8_MISSING if v == INT32_MISSING
                else INT8_EOV if v == INT32_EOV else v)
        elif btype == BCF_BT_INT16:
            out += struct.pack(
                "<h", INT16_MISSING if v == INT32_MISSING
                else INT16_EOV if v == INT32_EOV else v)
        else:
            out += struct.pack("<i", v)
    return bytes(out)


def _typed_int_vec(vals: List[int]) -> bytes:
    if not vals:
        return _typed_descriptor(0, BCF_BT_INT8)
    bt = _int_width(vals)
    return _typed_descriptor(len(vals), bt) + _pack_ints(vals, bt)


def _typed_float_vec(bits: List[int]) -> bytes:
    out = _typed_descriptor(len(bits), BCF_BT_FLOAT)
    for b in bits:
        out += struct.pack("<I", b)
    return out


class _HeaderDict:
    """IDX dictionaries from the ## header lines (htslib semantics:
    FILTER/INFO/FORMAT share one string dictionary, PASS is implicit
    idx 0; contigs get their own dictionary in line order)."""

    def __init__(self, header_lines: List[str]):
        self.strings: List[str] = ["PASS"]
        self.str_idx: Dict[str, int] = {"PASS": 0}
        self.contigs: List[str] = []
        self.contig_idx: Dict[str, int] = {}
        self.info_type: Dict[str, Tuple[str, str]] = {}
        self.format_type: Dict[str, Tuple[str, str]] = {}
        for line in header_lines:
            if line.startswith(("##FILTER=", "##INFO=", "##FORMAT=")):
                body = line.split("=", 1)[1].strip("<>")
                fields = _split_header_body(body)
                name = fields.get("ID", "")
                if name and name not in self.str_idx:
                    self.str_idx[name] = len(self.strings)
                    self.strings.append(name)
                if line.startswith("##INFO="):
                    self.info_type[name] = (fields.get("Type", "String"),
                                            fields.get("Number", "."))
                elif line.startswith("##FORMAT="):
                    self.format_type[name] = (fields.get("Type", "String"),
                                              fields.get("Number", "."))
            elif line.startswith("##contig="):
                body = line.split("=", 1)[1].strip("<>")
                fields = _split_header_body(body)
                name = fields.get("ID", "")
                if name and name not in self.contig_idx:
                    self.contig_idx[name] = len(self.contigs)
                    self.contigs.append(name)


def _split_header_body(body: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    key = ""
    buf = []
    in_quotes = False
    parts = []
    for ch in body:
        if ch == '"':
            in_quotes = not in_quotes
            buf.append(ch)
        elif ch == "," and not in_quotes:
            parts.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    if buf:
        parts.append("".join(buf))
    for p in parts:
        if "=" in p:
            k, v = p.split("=", 1)
            out[k] = v.strip('"')
    return out


def _float_bits(tok: str) -> int:
    if tok == ".":
        return FLOAT_MISSING_BITS
    return int(np.float32(tok).view(np.uint32))


def _parse_number_tokens(toks: List[str], vtype: str):
    """-> ('i', ints) / ('f', bits) with '.' as missing."""
    if vtype in ("Integer",):
        return "i", [INT32_MISSING if t == "." else int(t) for t in toks]
    if vtype in ("Float",):
        return "f", [_float_bits(t) for t in toks]
    return "s", toks


def _infer_type(tokens: List[str]) -> str:
    saw_float = False
    for t in tokens:
        if t in (".", ""):
            continue
        try:
            int(t)
        except ValueError:
            try:
                float(t)
                saw_float = True
            except ValueError:
                return "String"
    return "Float" if saw_float else "Integer"


def _synthesize_declarations(record_lines: List[str],
                             hd: _HeaderDict) -> List[str]:
    """Minimal ##contig/##FILTER/##INFO/##FORMAT lines for ids used by
    records but absent from the header (types inferred from values).

    Hot path: when the header (template) already declares every id —
    the common streaming case — this must stay O(records), not
    O(records x samples): the per-sample FORMAT token scan only runs
    for records whose FORMAT column carries an undeclared name, and
    distinct FORMAT columns are memoized (a cohort has a handful)."""
    extra: List[str] = []
    seen_contig: Dict[str, bool] = {}
    info_vals: Dict[str, List[str]] = {}
    fmt_vals: Dict[str, List[str]] = {}
    filters: List[str] = []
    # FORMAT column -> (undeclared [(slot, name)], uses GT?)
    fmt_cache: Dict[str, tuple] = {}
    saw_undecl_gt = False
    for ln in record_lines:
        if not ln:
            continue
        cols = ln.split("\t", 9)       # cols[9] = samples, unsplit
        if cols[0] not in hd.contig_idx and cols[0] not in seen_contig:
            seen_contig[cols[0]] = True
            extra.append(f"##contig=<ID={cols[0]}>")
        if len(cols) > 6 and cols[6] not in (".",):
            for f in cols[6].split(";"):
                if f not in hd.str_idx and f not in filters:
                    filters.append(f)
        if len(cols) > 7 and cols[7] != ".":
            for kv in cols[7].split(";"):
                k, _, v = kv.partition("=")
                if k not in hd.info_type:
                    info_vals.setdefault(k, [])
                    if v:
                        info_vals[k].extend(v.split(","))
        if len(cols) > 9 and cols[8] != ".":
            cached = fmt_cache.get(cols[8])
            if cached is None:
                names = cols[8].split(":")
                undecl = [(i, n) for i, n in enumerate(names)
                          if n != "GT" and n not in hd.format_type]
                cached = (undecl, "GT" in names)
                fmt_cache[cols[8]] = cached
            undecl, has_gt = cached
            saw_undecl_gt = saw_undecl_gt or (
                has_gt and "GT" not in hd.format_type)
            if undecl:
                for sc in cols[9].split("\t"):
                    toks = sc.split(":")
                    for i, name in undecl:
                        fmt_vals.setdefault(name, [])
                        if i < len(toks) and toks[i] != ".":
                            fmt_vals[name].extend(toks[i].split(","))
    for f in filters:
        extra.append(f'##FILTER=<ID={f},Description="">')
    for k, vals in info_vals.items():
        t = "Flag" if not vals else _infer_type(vals)
        num = "0" if t == "Flag" else "."
        extra.append(f'##INFO=<ID={k},Number={num},Type={t},'
                     'Description="">')
    for k, vals in fmt_vals.items():
        t = _infer_type(vals)
        extra.append(f'##FORMAT=<ID={k},Number=.,Type={t},'
                     'Description="">')
    if saw_undecl_gt:
        extra.append('##FORMAT=<ID=GT,Number=1,Type=String,'
                     'Description="Genotype">')
    return extra


def _native_type_codes(hd: "_HeaderDict"):
    codes = getattr(hd, "_native_codes", None)
    if codes is None:
        n = len(hd.strings)
        info_c = np.zeros(n, dtype=np.uint8)
        fmt_c = np.zeros(n, dtype=np.uint8)
        num = {"Integer": 1, "Float": 2}
        for name, (t, _n) in hd.info_type.items():
            i = hd.str_idx.get(name)
            if i is not None:
                info_c[i] = num.get(t, 3)
        for name, (t, _n) in hd.format_type.items():
            i = hd.str_idx.get(name)
            if i is not None:
                # the Python encoder char-encodes only Type=String and
                # int-parses everything else; mirror that
                fmt_c[i] = num.get(t, 3 if t == "String" else 1)
        codes = hd._native_codes = (info_c, fmt_c)
    return codes


def _encode_blob_native(blob: bytes, offs: np.ndarray, hd: "_HeaderDict",
                        n_sample: int) -> Optional[bytes]:
    """Encode newline-separated record text (one multi-line blob with
    line offsets, as the block renderer emits) straight to concatenated
    BCF2 record bytes — no per-line string materialization.  None when
    the native kernel is unavailable."""
    import os

    from ..runtime import native_loader as nl
    if os.environ.get("GENOMICSDB_TPU_NO_NATIVE", "") not in ("", "0"):
        return None
    codes = _native_type_codes(hd)
    res = nl.bcf_encode_records(blob, offs, hd.contigs, hd.strings,
                                codes[0], codes[1], n_sample)
    if res is None:
        return None
    out, _oo = res   # already concatenated record bytes
    return out


def _encode_records_native(lines: List[str], hd: "_HeaderDict",
                           n_sample: int) -> Optional[List[bytes]]:
    """Batch-encode record lines with the native BCF2 kernel; None when
    unavailable or when a line needs the Python path (the two encoders
    are byte-identical — tests/test_bcf.py cross-checks)."""
    import os

    from ..runtime import native_loader as nl
    if not lines or os.environ.get("GENOMICSDB_TPU_NO_NATIVE", "") \
            not in ("", "0"):
        return None
    codes = _native_type_codes(hd)
    blob = "\n".join(lines).encode()
    if len(blob) != sum(len(ln) for ln in lines) + len(lines) - 1:
        return None   # non-ASCII text: byte offsets would not line up
    offs = np.zeros(len(lines) + 1, dtype=np.int64)
    np.cumsum([len(ln) + 1 for ln in lines], out=offs[1:])
    offs[-1] -= 1
    res = nl.bcf_encode_records(blob, offs, hd.contigs, hd.strings,
                                codes[0], codes[1], n_sample)
    if res is None:
        return None
    out, oo = res
    return [out[oo[i]:oo[i + 1]] for i in range(len(lines))]


def text_to_bcf(text: str) -> bytes:
    """Encode combined-VCF text (with header) to an uncompressed BCF2.2
    byte stream (magic + header + records)."""
    lines = text.splitlines()
    hdr_end = -1
    for i, ln in enumerate(lines):
        if ln.startswith("#CHROM"):
            hdr_end = i
            break
    if hdr_end < 0:
        # headerless record stream (query without a template): make a
        # minimal header; sample names are not recoverable from text
        n = max((len(ln.split("\t")) - 9 for ln in lines if ln),
                default=0)
        chrom = ("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"
                 + ("\tFORMAT" + "".join(f"\tSAMPLE{i}"
                                         for i in range(n)) if n else ""))
        lines = ["##fileformat=VCFv4.1", chrom] + lines
        hdr_end = 1
    header_lines = lines[:hdr_end + 1]
    hd = _HeaderDict(header_lines)
    # queries run without a template emit records with no ## header;
    # synthesize the missing declarations (htslib auto-assigns IDX for
    # undeclared ids) so the dictionary covers every record
    extra = _synthesize_declarations(lines[hdr_end + 1:], hd)
    if extra:
        header_lines = header_lines[:-1] + extra + [header_lines[-1]]
        hd = _HeaderDict(header_lines)
    samples = lines[hdr_end].split("\t")[9:]
    n_sample = len(samples)
    header_text = "\n".join(header_lines) + "\n\0"
    out = bytearray(b"BCF\x02\x02")
    out += struct.pack("<I", len(header_text))
    out += header_text.encode()
    recs = [ln for ln in lines[hdr_end + 1:] if ln]
    enc = _encode_records_native(recs, hd, n_sample)
    if enc is not None:
        for b in enc:
            out += b
    else:
        for ln in recs:
            out += _encode_record(ln, hd, n_sample)
    return bytes(out)


def _encode_record(line: str, hd: _HeaderDict, n_sample: int) -> bytes:
    cols = line.split("\t")
    chrom, pos, rid, ref, alt, qual, filt, info = cols[:8]
    fmt_names = cols[8].split(":") if len(cols) > 8 and cols[8] != "." \
        else []
    shared = bytearray()
    alleles = [ref] + ([] if alt == "." else alt.split(","))
    # rlen: htslib uses max(len(REF), END-POS+1); we encode from END when
    # present so round-trip preserves it
    rlen = len(ref)
    info_pairs = []
    if info != ".":
        for kv in info.split(";"):
            if "=" in kv:
                k, v = kv.split("=", 1)
            else:
                k, v = kv, None
            info_pairs.append((k, v))
    for k, v in info_pairs:
        if k == "END" and v is not None:
            rlen = int(v) - int(pos) + 1
    qbits = FLOAT_MISSING_BITS if qual == "." else \
        int(np.float32(qual).view(np.uint32))
    shared += struct.pack("<i", hd.contig_idx[chrom])
    shared += struct.pack("<i", int(pos) - 1)
    shared += struct.pack("<i", rlen)
    shared += struct.pack("<I", qbits)
    shared += struct.pack("<I", (len(alleles) << 16) | len(info_pairs))
    shared += struct.pack("<I", (len(fmt_names) << 24) | n_sample)
    shared += _typed_string("" if rid == "." else rid)
    for a in alleles:
        shared += _typed_string(a)
    if filt == ".":
        shared += _typed_int_vec([])
    else:
        shared += _typed_int_vec([hd.str_idx[f]
                                  for f in filt.split(";")])
    for k, v in info_pairs:
        shared += _typed_int(hd.str_idx[k])
        if v is None:   # flag
            shared += _typed_descriptor(0, BCF_BT_INT8)
            continue
        vtype = hd.info_type.get(k, ("String", "."))[0]
        kind, vals = _parse_number_tokens(v.split(","), vtype)
        if kind == "i":
            shared += _typed_int_vec(vals)
        elif kind == "f":
            shared += _typed_float_vec(vals)
        else:
            shared += _typed_string(v)
    indiv = bytearray()
    sample_cols = [c.split(":") for c in cols[9:]]
    for fi, fname in enumerate(fmt_names):
        indiv += _typed_int(hd.str_idx[fname])
        if fname == "GT":
            # htslib GT encoding: (allele+1)<<1 | phased; '.' -> 0
            per = []
            width = 0
            for sc in sample_cols:
                tok = sc[fi] if fi < len(sc) else "."
                enc = _encode_gt_tok(tok)
                width = max(width, len(enc))
                per.append(enc)
            vals = []
            for enc in per:
                vals.extend(enc + [INT32_EOV] * (width - len(enc)))
            bt = _int_width(vals)
            indiv += _typed_descriptor(width, bt)
            indiv += _pack_ints(vals, bt)
            continue
        vtype = hd.format_type.get(fname, ("String", "."))[0]
        if vtype == "String":
            toks = [(sc[fi] if fi < len(sc) else ".") for sc in sample_cols]
            width = max((len(t) for t in toks), default=1)
            width = max(width, 1)
            indiv += _typed_descriptor(width, BCF_BT_CHAR)
            for t in toks:
                b = t.encode()
                indiv += b + b"\x00" * (width - len(b))
            continue
        per_vals = []
        width = 0
        for sc in sample_cols:
            tok = sc[fi] if fi < len(sc) else "."
            if tok == ".":
                vals = [None]
            else:
                vals = tok.split(",")
            width = max(width, len(vals))
            per_vals.append(vals)
        if vtype == "Float":
            flat = []
            for vals in per_vals:
                row = [FLOAT_MISSING_BITS if t is None else _float_bits(t)
                       for t in vals]
                row += [FLOAT_EOV_BITS] * (width - len(row))
                flat.extend(row)
            indiv += _typed_descriptor(width, BCF_BT_FLOAT)
            for b in flat:
                indiv += struct.pack("<I", b)
        else:
            flat = []
            for vals in per_vals:
                row = [INT32_MISSING if t in (None, ".") else int(t)
                       for t in vals]
                row += [INT32_EOV] * (width - len(row))
                flat.extend(row)
            bt = _int_width(flat)
            indiv += _typed_descriptor(width, bt)
            indiv += _pack_ints(flat, bt)
    return (struct.pack("<II", len(shared), len(indiv))
            + bytes(shared) + bytes(indiv))


def _encode_gt_tok(tok: str) -> List[int]:
    if tok in (".", ""):
        return [0]
    out = []
    phased = False
    buf = ""
    for ch in tok:
        if ch in "/|":
            out.append(_gt_allele(buf, phased))
            phased = ch == "|"
            buf = ""
        else:
            buf += ch
    out.append(_gt_allele(buf, phased))
    return out


def _gt_allele(buf: str, phased: bool) -> int:
    base = 0 if buf == "." else (int(buf) + 1) << 1
    return base | (1 if phased else 0)


# ---------------------------------------------------------------------------
# Decoder (round-trip validation + FeatureReader-style consumption)
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.d = data
        self.o = 0

    def u32(self):
        v = struct.unpack_from("<I", self.d, self.o)[0]
        self.o += 4
        return v

    def i32(self):
        v = struct.unpack_from("<i", self.d, self.o)[0]
        self.o += 4
        return v

    def typed(self):
        """-> (btype, values list)"""
        desc = self.d[self.o]
        self.o += 1
        n = desc >> 4
        btype = desc & 0xF
        if n == 15:
            _, nv = self.typed()
            n = nv[0]
        if btype == BCF_BT_CHAR:
            s = self.d[self.o:self.o + n]
            self.o += n
            return btype, [s]
        vals = []
        for _ in range(n):
            if btype == BCF_BT_INT8:
                v = struct.unpack_from("<b", self.d, self.o)[0]
                self.o += 1
                v = INT32_MISSING if v == INT8_MISSING else \
                    INT32_EOV if v == INT8_EOV else v
            elif btype == BCF_BT_INT16:
                v = struct.unpack_from("<h", self.d, self.o)[0]
                self.o += 2
                v = INT32_MISSING if v == INT16_MISSING else \
                    INT32_EOV if v == INT16_EOV else v
            elif btype == BCF_BT_INT32:
                v = struct.unpack_from("<i", self.d, self.o)[0]
                self.o += 4
            elif btype == BCF_BT_FLOAT:
                v = struct.unpack_from("<I", self.d, self.o)[0]
                self.o += 4
            else:
                raise ValueError(f"bad btype {btype}")
            vals.append(v)
        return btype, vals


def bcf_to_text(data: bytes) -> str:
    """Decode a BCF2.2 stream produced by text_to_bcf back to VCF text.

    The record section decodes through the native pass
    (runtime/native/bcf_decode.cpp, ~100x the Python cleanroom decoder
    — the BCF-input import edge rides this); the Python decoder below
    remains the from-spec oracle (native == Python asserted in
    tests/test_bcf.py) and the fallback on any malformed byte."""
    if data[:5] != b"BCF\x02\x02":
        raise ValueError("not BCF2.2")
    r = _Reader(data)
    r.o = 5
    l_header = r.u32()
    header_text = data[r.o:r.o + l_header].rstrip(b"\0").decode()
    r.o += l_header
    header_lines = header_text.splitlines()
    hd = _HeaderDict(header_lines)
    chrom_line = header_lines[-1]
    n_sample = max(0, len(chrom_line.split("\t")) - 9)
    import os as _os
    if _os.environ.get("GENOMICSDB_TPU_NO_NATIVE", "") in ("", "0"):
        from ..runtime import native_loader as nl
        gt_ids = [1 if s == "GT" else 0 for s in hd.strings]
        body = bytes(data[r.o:])
        dec = nl.bcf_decode_records(body, hd.contigs, hd.strings,
                                    gt_ids, n_sample)
        if dec is not None:
            return "\n".join(header_lines) + "\n" + dec.decode()
    out = list(header_lines)
    while r.o < len(data):
        out.append(_decode_record(r, hd, n_sample))
    return "\n".join(out) + "\n"


def _fmt_float_bits(bits: int) -> str:
    if bits == FLOAT_MISSING_BITS:
        return "."
    f = np.frombuffer(struct.pack("<I", bits), dtype=np.float32)[0]
    return formats.format_float_vcf(f)


def exact_float_bits(bits: int) -> str:
    """A float32 (its bits) as text that parses back to the same float32
    (the decimal expansion of its double), or "." for the missing
    value."""
    if bits == FLOAT_MISSING_BITS:
        return "."
    return repr(float(np.frombuffer(struct.pack("<I", bits),
                                    dtype=np.float32)[0]))


def _decode_record(r: _Reader, hd: _HeaderDict, n_sample: int,
                   fmt_float=_fmt_float_bits) -> str:
    """One record as VCF text.  `fmt_float` renders a float32 (its bits)
    with its missing value: htslib's 6 significant digits by default,
    `exact_float_bits` where the text is parsed back into float32."""
    l_shared = r.u32()
    l_indiv = r.u32()
    end_shared = r.o + l_shared
    rid_ci = r.i32()
    pos = r.i32() + 1
    rlen = r.i32()
    qbits = r.u32()
    x = r.u32()
    n_allele, n_info = x >> 16, x & 0xFFFF
    y = r.u32()
    n_fmt = y >> 24
    _, idv = r.typed()
    rec_id = idv[0].decode() if idv and idv[0] else "."
    alleles = []
    for _ in range(n_allele):
        _, av = r.typed()
        alleles.append(av[0].decode())
    _, filt_v = r.typed()
    filt = ";".join(hd.strings[i] for i in filt_v) if filt_v else "."
    info_parts = []
    for _ in range(n_info):
        _, kv = r.typed()
        key = hd.strings[kv[0]]
        btype, vals = r.typed()
        if btype == BCF_BT_CHAR:
            info_parts.append(f"{key}={vals[0].decode()}")
        elif not vals:
            info_parts.append(key)   # flag
        elif btype == BCF_BT_FLOAT:
            info_parts.append(
                f"{key}=" + ",".join(fmt_float(b) for b in vals))
        else:
            info_parts.append(
                f"{key}=" + ",".join(
                    "." if v == INT32_MISSING else str(v) for v in vals))
    assert r.o == end_shared, (r.o, end_shared)
    end_indiv = r.o + l_indiv
    fmt_names = []
    sample_txt = [[] for _ in range(n_sample)]
    for _ in range(n_fmt):
        _, kv = r.typed()
        fname = hd.strings[kv[0]]
        fmt_names.append(fname)
        desc = r.d[r.o]
        width = desc >> 4
        btype = desc & 0xF
        r.o += 1
        if width == 15:
            _, nv = r.typed()
            width = nv[0]
        for s in range(n_sample):
            toks = []
            if btype == BCF_BT_CHAR:
                raw = r.d[r.o:r.o + width]
                r.o += width
                sample_txt[s].append(
                    raw.rstrip(b"\x00").decode() or ".")
                continue
            for _ in range(width):
                if btype == BCF_BT_INT8:
                    v = struct.unpack_from("<b", r.d, r.o)[0]
                    r.o += 1
                    v = INT32_MISSING if v == INT8_MISSING else \
                        INT32_EOV if v == INT8_EOV else v
                elif btype == BCF_BT_INT16:
                    v = struct.unpack_from("<h", r.d, r.o)[0]
                    r.o += 2
                    v = INT32_MISSING if v == INT16_MISSING else \
                        INT32_EOV if v == INT16_EOV else v
                elif btype == BCF_BT_INT32:
                    v = struct.unpack_from("<i", r.d, r.o)[0]
                    r.o += 4
                else:
                    v = struct.unpack_from("<I", r.d, r.o)[0]
                    r.o += 4
                toks.append(v)
            if fname == "GT":
                sample_txt[s].append(_decode_gt(toks))
            elif btype == BCF_BT_FLOAT:
                toks = [t for t in toks if t != FLOAT_EOV_BITS]
                txt = ",".join(fmt_float(t) for t in toks)
                sample_txt[s].append(txt if toks else ".")
            else:
                toks = [t for t in toks if t != INT32_EOV]
                txt = ",".join("." if t == INT32_MISSING else str(t)
                               for t in toks)
                sample_txt[s].append(txt if toks else ".")
    assert r.o == end_indiv, (r.o, end_indiv)
    qual = "." if qbits == FLOAT_MISSING_BITS else fmt_float(qbits)
    info_txt = ";".join(info_parts) if info_parts else "."
    cols = [hd.contigs[rid_ci], str(pos), rec_id, alleles[0],
            ",".join(alleles[1:]) if len(alleles) > 1 else ".",
            qual, filt, info_txt]
    _ = rlen
    if fmt_names:
        cols.append(":".join(fmt_names))
        for s in range(n_sample):
            cols.append(":".join(sample_txt[s]))
    return "\t".join(cols)


def _decode_gt(vals: List[int]) -> str:
    out = []
    for i, v in enumerate(vals):
        if v == INT32_EOV:
            break
        allele = "." if (v >> 1) == 0 else str((v >> 1) - 1)
        if i == 0:
            out.append(allele)
        else:
            out.append(("|" if v & 1 else "/") + allele)
    return "".join(out) if out else "."
