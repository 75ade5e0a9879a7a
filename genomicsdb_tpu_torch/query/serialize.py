"""Binary (de)serialization of query results for inter-process gather
(the port's copy of `genomicsdb_tpu.query.serialize`).

Replaces the reference's Variant::binary_serialize / binary_deserialize +
MPI_Gatherv blobs (variant.h:231, gt_mpi_gather.cc:149-295): per-rank
variants are packed into a bytes blob, gathered (host-side; device
collectives handle the fixed-layout columnar results), and deserialized at
the root for printing.

Layout per variant:
  [int64 start][int64 end][uint32 n_common]
    per common field: [name][payload]
  [uint32 n_calls]
    per call: [int64 row][int64 col][int64 end][uint32 n_fields]
      per field: [name][payload]
Strings are uint32-length-prefixed UTF-8; arrays are dtype-tagged.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

_DTYPE_TAGS = {"int32": 0, "float32": 1, "str": 2, "int64": 3,
               "list2d": 4, "strlist": 5}
_TAG_DTYPES = {v: k for k, v in _DTYPE_TAGS.items()}


def _pack_str(out: bytearray, s: str):
    b = s.encode()
    out += struct.pack("<I", len(b))
    out += b


def _unpack_str(buf: memoryview, off: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    s = bytes(buf[off:off + n]).decode()
    return s, off + n


def _pack_value(out: bytearray, v):
    if isinstance(v, str):
        out += struct.pack("<B", _DTYPE_TAGS["str"])
        _pack_str(out, v)
        return
    if isinstance(v, list) and all(isinstance(x, str) for x in v):
        out += struct.pack("<B", _DTYPE_TAGS["strlist"])
        out += struct.pack("<I", len(v))
        for x in v:
            _pack_str(out, x)
        return
    if isinstance(v, list):  # list of 1-D arrays (2-D ragged)
        out += struct.pack("<B", _DTYPE_TAGS["list2d"])
        out += struct.pack("<I", len(v))
        for sub in v:
            _pack_value(out, np.asarray(sub))
        return
    arr = np.atleast_1d(np.asarray(v))
    if arr.dtype == np.int64:
        tag = "int64"
    elif arr.dtype.kind == "f":
        tag = "float32"
        arr = arr.astype(np.float32, copy=False)
    else:
        tag = "int32"
        arr = arr.astype(np.int32, copy=False)
    out += struct.pack("<B", _DTYPE_TAGS[tag])
    out += struct.pack("<I", len(arr))
    out += arr.tobytes()


def _unpack_value(buf: memoryview, off: int):
    (tag,) = struct.unpack_from("<B", buf, off)
    off += 1
    kind = _TAG_DTYPES[tag]
    if kind == "str":
        return _unpack_str(buf, off)
    if kind == "strlist":
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        out = []
        for _ in range(n):
            s, off = _unpack_str(buf, off)
            out.append(s)
        return out, off
    if kind == "list2d":
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        out = []
        for _ in range(n):
            v, off = _unpack_value(buf, off)
            out.append(v)
        return out, off
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    dt = {"int32": np.int32, "float32": np.float32,
          "int64": np.int64}[kind]
    nbytes = n * dt().itemsize
    arr = np.frombuffer(buf[off:off + nbytes], dtype=dt).copy()
    return arr, off + nbytes


def serialize_variants(variants, qc) -> bytes:
    """variants: [(start, end, common_or_None, [CallView,...])] from
    variants_path.gt_get_column_interval."""
    out = bytearray()
    out += struct.pack("<I", len(variants))
    for (start, end, common, calls) in variants:
        out += struct.pack("<qq", start, end)
        if common is not None:
            ref, alts = common
            out += struct.pack("<I", 2)
            _pack_str(out, "REF")
            _pack_value(out, ref)
            _pack_str(out, "ALT")
            _pack_value(out, list(alts))
        else:
            out += struct.pack("<I", 0)
        out += struct.pack("<I", len(calls))
        for call in calls:
            out += struct.pack("<qqq", call.row, call.col, call.end)
            fields = []
            for name in qc.attributes:
                if name == "END":
                    continue
                if name in call._overrides:
                    v = call._overrides[name]
                else:
                    v = call.field(name)
                if v is not None:
                    fields.append((name, v))
            out += struct.pack("<I", len(fields))
            for name, v in fields:
                _pack_str(out, name)
                _pack_value(out, v)
    return bytes(out)


class DeserializedCall:
    """Printer-compatible stand-in for a CallView on the gather root."""

    def __init__(self, row, col, end, fields, store):
        self.row = row
        self.col = col
        self.end = end
        self._fields = fields
        self._overrides = {}
        self.store = store

    def field(self, name):
        return self._fields.get(name)


def deserialize_variants(blob: bytes, qc, store):
    buf = memoryview(blob)
    off = 0
    (n_var,) = struct.unpack_from("<I", buf, off)
    off += 4
    variants = []
    for _ in range(n_var):
        start, end = struct.unpack_from("<qq", buf, off)
        off += 16
        (n_common,) = struct.unpack_from("<I", buf, off)
        off += 4
        common = None
        cf = {}
        for _ in range(n_common):
            name, off = _unpack_str(buf, off)
            v, off = _unpack_value(buf, off)
            cf[name] = v
        if cf:
            common = (cf.get("REF"), cf.get("ALT"))
        (n_calls,) = struct.unpack_from("<I", buf, off)
        off += 4
        calls = []
        for _ in range(n_calls):
            row, col, cend = struct.unpack_from("<qqq", buf, off)
            off += 24
            (n_fields,) = struct.unpack_from("<I", buf, off)
            off += 4
            fields = {}
            for _ in range(n_fields):
                name, off = _unpack_str(buf, off)
                v, off = _unpack_value(buf, off)
                fields[name] = v
            calls.append(DeserializedCall(row, col, cend, fields, store))
        variants.append((start, end, common, calls))
    return variants
