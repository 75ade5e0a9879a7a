"""ctypes bindings for the native import kernels (auto-built on demand).

The library is built from `native/` at first use, into
`build/genomicsdb_tpu_torch/native/` under the checkout, never into the
package.  Falls back silently to None when no C++ toolchain is
available; callers keep the pure-Python path.  The first call builds
and loads under a lock: a thread that asks while another builds waits
for the library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from ..core import profile

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "native")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "genomicsdb_tpu_torch",
    "native")
_LIB_PATH = os.path.join(_BUILD_DIR, "libgdb_native.so")

_lib = None
_tried = False
_LOCK = threading.Lock()


def _text_buf(cap):
    """Uninitialized output text buffer: np.empty touches no pages,
    unlike ctypes.create_string_buffer which zero-fills the worst-case
    capacity (measured ~0.3 s/query of pure memset on the render
    paths)."""
    arr = np.empty(max(int(cap), 1), dtype=np.uint8)
    return arr, arr.ctypes.data_as(ctypes.c_char_p)


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    with _LOCK:
        if not _tried:
            _lib = _load()
            _tried = True
    return _lib


def _load() -> Optional[ctypes.CDLL]:
    """The library, built first where it is missing or older than a
    source (timed as the span `build.native`, counted in
    `COUNTS.native_builds`); None where it cannot be built or loaded."""
    srcs = [os.path.join(_NATIVE_DIR, f)
            for f in ("vcf_kernels.cpp", "seq_bench.cpp",
                      "bcf_encode.cpp", "bcf_decode.cpp")]
    stale = os.path.isfile(_LIB_PATH) and any(
        os.path.isfile(s)
        and os.path.getmtime(s) > os.path.getmtime(_LIB_PATH)
        for s in srcs)
    if not os.path.isfile(_LIB_PATH) or stale:
        try:
            # build under a private name and rename: processes that
            # build at once never load a half-written library
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
            profile.count("native_builds")
            with profile.span("build.native"):
                subprocess.run(["make", "-B", "-C", _NATIVE_DIR,
                                f"OUT={tmp}"], capture_output=True,
                               check=True)
            os.replace(tmp, _LIB_PATH)
        except Exception:
            if not os.path.isfile(_LIB_PATH):
                return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    i64 = ctypes.c_int64
    lib.gdb_tokenize_records.restype = i64
    lib.gdb_tokenize_records.argtypes = [
        ctypes.c_char_p, i64, i64, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int32)]
    for name in ("gdb_parse_int_lists",):
        f = getattr(lib, name)
        f.restype = i64
        f.argtypes = [ctypes.c_char_p, np.ctypeslib.ndpointer(np.int64),
                      np.ctypeslib.ndpointer(np.int64), i64, ctypes.c_char,
                      np.ctypeslib.ndpointer(np.int32), i64,
                      np.ctypeslib.ndpointer(np.int64)]
    lib.gdb_parse_float_lists.restype = i64
    lib.gdb_parse_float_lists.argtypes = [
        ctypes.c_char_p, np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64), i64, ctypes.c_char,
        np.ctypeslib.ndpointer(np.float32), i64,
        np.ctypeslib.ndpointer(np.int64)]
    lib.gdb_parse_gt.restype = i64
    lib.gdb_parse_gt.argtypes = [
        ctypes.c_char_p, np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64), i64, ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32), i64,
        np.ctypeslib.ndpointer(np.int64)]
    lib.gdb_split_field.restype = None
    lib.gdb_split_field.argtypes = [
        ctypes.c_char_p, np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64), i64, ctypes.c_char,
        ctypes.c_int32, np.ctypeslib.ndpointer(np.int64),
        np.ctypeslib.ndpointer(np.int64)]
    if hasattr(lib, "gdb_split_fields_multi"):
        lib.gdb_split_fields_multi.restype = None
        lib.gdb_split_fields_multi.argtypes = [
            ctypes.c_char_p, np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int64), i64, ctypes.c_char,
            np.ctypeslib.ndpointer(np.int32), ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int64),
            np.ctypeslib.ndpointer(np.int64)]
    return lib


def _bind_render(lib):
    i64 = ctypes.c_int64
    lib.gdb_render_int_lists.restype = i64
    lib.gdb_render_int_lists.argtypes = [
        np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.int64), i64, ctypes.c_char,
        ctypes.c_char_p, i64, np.ctypeslib.ndpointer(np.int64)]
    lib.gdb_join_columns.restype = i64
    lib.gdb_join_columns.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int32, i64, ctypes.c_char, ctypes.c_char_p, i64,
        np.ctypeslib.ndpointer(np.int64)]
    lib.gdb_join_rows.restype = i64
    lib.gdb_join_rows.argtypes = [
        ctypes.c_char_p, np.ctypeslib.ndpointer(np.int64), i64, i64,
        ctypes.c_char, ctypes.c_char_p, i64,
        np.ctypeslib.ndpointer(np.int64)]


def _bind_assemble(lib):
    import ctypes
    i64 = ctypes.c_int64
    ptr_i64 = np.ctypeslib.ndpointer(np.int64)
    ptr_i32 = np.ctypeslib.ndpointer(np.int32)
    lib.gdb_assemble_lines.restype = i64
    lib.gdb_assemble_lines.argtypes = [
        i64, ctypes.c_char_p, ptr_i64, ptr_i32, ptr_i64,
        ctypes.c_char_p, ctypes.c_void_p,   # id (offsets via void_p)
        ctypes.c_char_p, ptr_i64,           # ref
        ctypes.c_char_p, ptr_i64,           # alt
        ctypes.c_char_p, ctypes.c_void_p,   # qual
        ctypes.c_char_p, ctypes.c_void_p,   # filt
        ptr_i64,                            # info_end
        ctypes.c_char_p, ctypes.c_void_p,   # extra
        ptr_i64,                            # info_dp
        ctypes.c_char_p, ptr_i64, ptr_i32,  # fmt dict + idx
        ctypes.c_char_p, ctypes.c_void_p,   # samples
        ctypes.c_char_p, i64, ptr_i64]


def _offs_ptr(arr):
    import ctypes
    if arr is None:
        return None
    return arr.ctypes.data_as(ctypes.c_void_p)


def assemble_lines(cidx, pos1, names_blob, name_offs, id_col, ref_col,
                   alt_col, qual_col, filt_col, info_end, extra_col,
                   info_dp, fmt_blob, fmt_offs, fmt_idx, samp_col):
    """Assemble complete newline-terminated VCF record lines.

    Ragged columns are (bytes, offsets[n+1]) or None (renders '.').
    Returns (bytes, offsets[n+1]) with offsets PAST each trailing
    newline, or None without the native lib."""
    import ctypes
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_assemble_bound"):
        _bind_assemble(lib)
        lib._assemble_bound = True
    n = len(pos1)

    keep = []

    def blob(col):
        if col is None:
            return None, None
        v = col[0]
        if isinstance(v, np.ndarray):      # uint8 text blob by address
            v = np.ascontiguousarray(v)
            keep.append(v)                 # alive across the call
            v = ctypes.cast(ctypes.c_void_p(v.ctypes.data),
                            ctypes.c_char_p)
        return v, np.ascontiguousarray(col[1], dtype=np.int64)

    id_b, id_o = blob(id_col)
    ref_b, ref_o = blob(ref_col)
    alt_b, alt_o = blob(alt_col)
    qual_b, qual_o = blob(qual_col)
    filt_b, filt_o = blob(filt_col)
    ex_b, ex_o = blob(extra_col)
    samp_b, samp_o = blob(samp_col)
    cap = int(
        64 * n + len(names_blob) * 0 + sum(
            len(c[0]) for c in (id_col, ref_col, alt_col, qual_col,
                                filt_col, extra_col, samp_col)
            if c is not None)
        + n * (int(fmt_offs.max()) if len(fmt_offs) else 0) + 1024)
    out_arr, out = _text_buf(cap)
    out_offs = np.empty(n + 1, dtype=np.int64)
    w = lib.gdb_assemble_lines(
        n, names_blob, np.ascontiguousarray(name_offs, dtype=np.int64),
        np.ascontiguousarray(cidx, dtype=np.int32),
        np.ascontiguousarray(pos1, dtype=np.int64),
        id_b, _offs_ptr(id_o), ref_b, ref_o, alt_b, alt_o,
        qual_b, _offs_ptr(qual_o), filt_b, _offs_ptr(filt_o),
        np.ascontiguousarray(info_end, dtype=np.int64),
        ex_b, _offs_ptr(ex_o),
        np.ascontiguousarray(info_dp, dtype=np.int64),
        fmt_blob, np.ascontiguousarray(fmt_offs, dtype=np.int64),
        np.ascontiguousarray(fmt_idx, dtype=np.int32),
        samp_b, _offs_ptr(samp_o), out, cap, out_offs)
    if w < 0:
        raise RuntimeError("assemble_lines overflow")
    return out_arr[:w].tobytes(), out_offs


def assemble_lines_gapped(cidx, pos1, names_blob, name_offs, id_col,
                          ref_col, alt_col, qual_col, filt_col,
                          info_end, extra_col, info_dp, fmt_blob,
                          fmt_offs, fmt_idx, samp_lens):
    """Direct-write line assembly: exact-length phase + parallel prefix
    write, leaving per-record gaps of samp_lens[i] bytes for the sample
    text (filled afterwards by render_group_at).  Returns
    (out uint8 [total], line_offs[n+1], samp_dest[n]) or None when the
    kernels are unavailable."""
    import ctypes
    lib = get_lib()
    if lib is None or not hasattr(lib, "gdb_assemble_lens"):
        return None
    if not hasattr(lib, "_asm2_bound"):
        i64 = ctypes.c_int64
        p64 = np.ctypeslib.ndpointer(np.int64)
        p32 = np.ctypeslib.ndpointer(np.int32)
        cp = ctypes.c_char_p
        common = [i64, cp, p64, p32, p64, cp, ctypes.c_void_p, cp, p64,
                  cp, p64, cp, ctypes.c_void_p, cp, ctypes.c_void_p,
                  p64, cp, ctypes.c_void_p, p64, cp, p64, p32, p64]
        lib.gdb_assemble_lens.restype = i64
        lib.gdb_assemble_lens.argtypes = common + [p64, p64]
        lib.gdb_assemble_write.restype = None
        lib.gdb_assemble_write.argtypes = common + [p64, ctypes.c_void_p]
        lib._asm2_bound = True
    n = len(pos1)
    keep = []

    def blob(col):
        if col is None:
            return None, None
        v = col[0]
        if isinstance(v, np.ndarray):
            v = np.ascontiguousarray(v)
            keep.append(v)
            v = ctypes.cast(ctypes.c_void_p(v.ctypes.data),
                            ctypes.c_char_p)
        return v, np.ascontiguousarray(col[1], dtype=np.int64)

    id_b, id_o = blob(id_col)
    ref_b, ref_o = blob(ref_col)
    alt_b, alt_o = blob(alt_col)
    qual_b, qual_o = blob(qual_col)
    filt_b, filt_o = blob(filt_col)
    ex_b, ex_o = blob(extra_col)
    args = (n, names_blob,
            np.ascontiguousarray(name_offs, dtype=np.int64),
            np.ascontiguousarray(cidx, dtype=np.int32),
            np.ascontiguousarray(pos1, dtype=np.int64),
            id_b, _offs_ptr(id_o), ref_b, ref_o, alt_b, alt_o,
            qual_b, _offs_ptr(qual_o), filt_b, _offs_ptr(filt_o),
            np.ascontiguousarray(info_end, dtype=np.int64),
            ex_b, _offs_ptr(ex_o),
            np.ascontiguousarray(info_dp, dtype=np.int64),
            fmt_blob, np.ascontiguousarray(fmt_offs, dtype=np.int64),
            np.ascontiguousarray(fmt_idx, dtype=np.int32),
            np.ascontiguousarray(samp_lens, dtype=np.int64))
    line_offs = np.empty(n + 1, dtype=np.int64)
    samp_dest = np.empty(max(n, 1), dtype=np.int64)
    total = lib.gdb_assemble_lens(*args, line_offs, samp_dest)
    out = np.empty(int(total), dtype=np.uint8)
    lib.gdb_assemble_write(*args, line_offs,
                           out.ctypes.data_as(ctypes.c_void_p))
    _ = keep
    return out, line_offs, samp_dest[:n]


def render_int_lists(values: np.ndarray, offsets: np.ndarray,
                     delim: bytes = b","):
    """Ragged int32 rows -> delimited decimal text (missing -> '.')."""
    lib = get_lib()
    if not hasattr(lib, "_render_bound"):
        _bind_render(lib)
        lib._render_bound = True
    n = len(offsets) - 1
    cap = max(16, int(len(values)) * 12 + n * 2)
    out_arr, out = _text_buf(cap)
    out_offsets = np.empty(n + 1, dtype=np.int64)
    w = lib.gdb_render_int_lists(
        np.ascontiguousarray(values, dtype=np.int32),
        np.ascontiguousarray(offsets, dtype=np.int64), n, delim, out,
        cap, out_offsets)
    if w < 0:
        raise RuntimeError("render overflow")
    return out_arr[:w], out_offsets


def join_columns(columns, delim: bytes = b":"):
    """columns: list of (bytes, offsets[n+1]); returns row-joined
    (bytes, offsets)."""
    lib = get_lib()
    if not hasattr(lib, "_render_bound"):
        _bind_render(lib)
        lib._render_bound = True
    k = len(columns)
    n = len(columns[0][1]) - 1
    total = sum(len(v) for v, _ in columns) + n * k + 16
    out_arr, out = _text_buf(total)
    out_offsets = np.empty(n + 1, dtype=np.int64)
    # bytes pass directly as const char*; uint8 arrays pass by address
    def _ptr(v):
        if isinstance(v, np.ndarray):
            return ctypes.cast(ctypes.c_void_p(v.ctypes.data),
                               ctypes.c_char_p)
        return v if v else b"\x00"
    keep = [np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v
            for v, _ in columns]
    vals_arr = (ctypes.c_char_p * k)(*[_ptr(v) for v in keep])
    off_arrays = [np.ascontiguousarray(o, dtype=np.int64)
                  for _, o in columns]
    offs_arr = (ctypes.POINTER(ctypes.c_int64) * k)(
        *[o.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
          for o in off_arrays])
    w = lib.gdb_join_columns(vals_arr, offs_arr, k, n, delim, out,
                             int(total), out_offsets)
    if w < 0:
        raise RuntimeError("join overflow")
    return out_arr[:w], out_offsets


def join_rows(values: bytes, offsets: np.ndarray, group: int,
              delim: bytes = b"\t"):
    """Join consecutive groups of `group` ragged text rows with delim."""
    lib = get_lib()
    if not hasattr(lib, "_render_bound"):
        _bind_render(lib)
        lib._render_bound = True
    n = len(offsets) - 1
    n_out = n // group
    total = len(values) + n + 16
    out_arr, out = _text_buf(total)
    out_offsets = np.empty(n_out + 1, dtype=np.int64)
    if isinstance(values, np.ndarray):
        _keep = np.ascontiguousarray(values)   # alive across the call
        values = ctypes.cast(ctypes.c_void_p(_keep.ctypes.data),
                             ctypes.c_char_p)
    w = lib.gdb_join_rows(values, np.ascontiguousarray(offsets,
                                                       dtype=np.int64),
                          n, group, delim, out, int(total), out_offsets)
    if w < 0:
        raise RuntimeError("join_rows overflow")
    return out_arr[:w], out_offsets


def tokenize_records(text: bytes, max_cols: int = 64):
    """(col_offsets [n, max_cols+1], num_cols [n]) for a VCF record blob."""
    lib = get_lib()
    if lib is None:
        return None
    est_records = text.count(b"\n") + 1
    col_offsets = np.zeros((est_records, max_cols + 1), dtype=np.int64)
    num_cols = np.zeros(est_records, dtype=np.int32)
    n = lib.gdb_tokenize_records(text, len(text), est_records, max_cols,
                                 col_offsets, num_cols)
    if n < 0:
        return None
    return col_offsets[:n], num_cols[:n]


def parse_int_lists(text: bytes, starts: np.ndarray, ends: np.ndarray,
                    delim: bytes = b","):
    lib = get_lib()
    n = len(starts)
    cap = int((ends - starts).sum()) // 1 + n + 1
    values = np.empty(cap, dtype=np.int32)
    offsets = np.empty(n + 1, dtype=np.int64)
    total = lib.gdb_parse_int_lists(text, starts, ends, n, delim, values,
                                    cap, offsets)
    if total == -2:
        raise ValueError("malformed or out-of-range integer token "
                         "(matches the pure-Python loader's ValueError)")
    if total < 0:
        raise RuntimeError("int list parse overflow")
    return values[:total], offsets


def parse_float_lists(text: bytes, starts: np.ndarray, ends: np.ndarray,
                      delim: bytes = b","):
    lib = get_lib()
    n = len(starts)
    cap = int((ends - starts).sum()) + n + 1
    values = np.empty(cap, dtype=np.float32)
    offsets = np.empty(n + 1, dtype=np.int64)
    total = lib.gdb_parse_float_lists(text, starts, ends, n, delim, values,
                                      cap, offsets)
    if total < 0:
        raise RuntimeError("float list parse overflow")
    return values[:total], offsets


def parse_gt(text: bytes, starts: np.ndarray, ends: np.ndarray,
             store_phase: bool):
    lib = get_lib()
    n = len(starts)
    cap = int((ends - starts).sum()) * 2 + n + 2
    values = np.empty(cap, dtype=np.int32)
    offsets = np.empty(n + 1, dtype=np.int64)
    total = lib.gdb_parse_gt(text, starts, ends, n, int(store_phase),
                             values, cap, offsets)
    if total == -2:
        raise ValueError("malformed GT allele token")
    if total < 0:
        raise RuntimeError("GT parse overflow")
    return values[:total], offsets


def split_fields_multi(text: bytes, starts: np.ndarray, ends: np.ndarray,
                       delim: bytes, field_idxs):
    """One-pass split of n spans at `delim` for several (ascending) field
    indices.  Returns (starts[k, n], ends[k, n])."""
    lib = get_lib()
    n = len(starts)
    k = len(field_idxs)
    idxs = np.ascontiguousarray(field_idxs, dtype=np.int32)
    if k > 1:
        assert bool(np.all(idxs[1:] > idxs[:-1])), "field_idxs ascending"
    out_s = np.empty((k, n), dtype=np.int64)
    out_e = np.empty((k, n), dtype=np.int64)
    if not hasattr(lib, "gdb_split_fields_multi"):
        for j, fi in enumerate(idxs):
            out_s[j], out_e[j] = split_field(text, starts, ends, delim,
                                             int(fi))
        return out_s, out_e
    lib.gdb_split_fields_multi(text, starts, ends, n, delim, idxs, k,
                               out_s, out_e)
    return out_s, out_e


def _bind_prefix(lib):
    i64 = ctypes.c_int64
    p64 = np.ctypeslib.ndpointer(np.int64)
    p32 = np.ctypeslib.ndpointer(np.int32)
    pu8 = np.ctypeslib.ndpointer(np.uint8)
    lib.gdb_extract_spans.restype = i64
    lib.gdb_extract_spans.argtypes = [
        ctypes.c_char_p, p64, p64, i64, ctypes.c_char_p, i64, p64]
    lib.gdb_transform_alt.restype = i64
    lib.gdb_transform_alt.argtypes = [
        ctypes.c_char_p, p64, p64, p64, p64, i64, ctypes.c_char_p, i64,
        p64, pu8]
    lib.gdb_intern_spans.restype = i64
    lib.gdb_intern_spans.argtypes = [
        ctypes.c_char_p, p64, p64, i64, p32, p64, i64]
    lib.gdb_info_values.restype = None
    lib.gdb_info_values.argtypes = [
        ctypes.c_char_p, p64, p64, i64, ctypes.c_char_p, p64,
        ctypes.c_int32, p64, p64, pu8]
    lib.gdb_replicate_ragged.restype = i64
    lib.gdb_replicate_ragged.argtypes = [
        ctypes.c_char_p, i64, p64, i64, i64, ctypes.c_char_p, i64, p64]
    lib.gdb_copy_segments.restype = None
    lib.gdb_copy_segments.argtypes = [
        ctypes.c_char_p, p64, p64, p64, i64, i64, ctypes.c_char_p]


def _prefix_lib():
    lib = get_lib()
    if lib is None or not hasattr(lib, "gdb_extract_spans"):
        return None
    if not hasattr(lib, "_prefix_bound"):
        _bind_prefix(lib)
        lib._prefix_bound = True
    return lib


def extract_spans(text: bytes, starts: np.ndarray, ends: np.ndarray):
    """Copy n byte spans into one blob; returns (bytes, offsets[n+1])."""
    lib = _prefix_lib()
    n = len(starts)
    cap = int(np.maximum(ends - starts, 0).sum())
    out_arr, out = _text_buf(cap)
    out_offs = np.empty(n + 1, dtype=np.int64)
    w = lib.gdb_extract_spans(text, starts, ends, n, out, cap, out_offs)
    if w < 0:
        raise RuntimeError("extract_spans overflow")
    return out_arr[:w].tobytes(), out_offs


def transform_alt(text: bytes, starts, ends, ref_starts, ref_ends):
    """ALT spans -> '|'-joined serialized form + per-record deletion flag.

    Returns (bytes, offsets[n+1], del_flag[n] uint8)."""
    lib = _prefix_lib()
    n = len(starts)
    cap = int(np.maximum(ends - starts, 0).sum())
    out_arr, out = _text_buf(cap)
    out_offs = np.empty(n + 1, dtype=np.int64)
    del_flag = np.zeros(n, dtype=np.uint8)
    w = lib.gdb_transform_alt(text, starts, ends, ref_starts, ref_ends, n,
                              out, cap, out_offs, del_flag)
    if w < 0:
        raise RuntimeError("transform_alt overflow")
    return out_arr[:w].tobytes(), out_offs, del_flag


def intern_spans(text: bytes, starts: np.ndarray, ends: np.ndarray):
    """Group identical byte spans; returns (gids[n] int32,
    uniq_idx[n_uniq] — first record index per group)."""
    lib = _prefix_lib()
    n = len(starts)
    gids = np.empty(n, dtype=np.int32)
    max_uniq = n + 1
    uniq_idx = np.empty(max_uniq, dtype=np.int64)
    n_uniq = lib.gdb_intern_spans(text, starts, ends, n, gids, uniq_idx,
                                  max_uniq)
    if n_uniq < 0:
        raise RuntimeError("intern_spans overflow")
    return gids, uniq_idx[:n_uniq]


def info_values(text: bytes, starts, ends, keys):
    """Resolve each key of `keys` (list of str) over n INFO spans.

    Returns (val_starts[k, n], val_ends[k, n], present[k, n] bool)."""
    lib = _prefix_lib()
    n = len(starts)
    k = len(keys)
    blob = "".join(keys).encode()
    key_offs = np.zeros(k + 1, dtype=np.int64)
    np.cumsum([len(x.encode()) for x in keys], out=key_offs[1:])
    vs = np.empty((k, n), dtype=np.int64)
    ve = np.empty((k, n), dtype=np.int64)
    pres = np.empty((k, n), dtype=np.uint8)
    lib.gdb_info_values(text, starts, ends, n, blob, key_offs, k, vs, ve,
                        pres)
    return vs, ve, pres.astype(bool)


def replicate_ragged(values: np.ndarray, rec_offs: np.ndarray, K: int):
    """Per-record ragged -> per-cell ragged with each record's payload
    replicated to K consecutive cells.  Returns (values, offsets[n*K+1])."""
    lib = _prefix_lib()
    n = len(rec_offs) - 1
    elem = values.dtype.itemsize
    total = int(rec_offs[-1]) * K
    out = np.empty(total, dtype=values.dtype)
    out_offs = np.empty(n * K + 1, dtype=np.int64)
    w = lib.gdb_replicate_ragged(
        np.ascontiguousarray(values).ctypes.data_as(ctypes.c_char_p),
        elem, np.ascontiguousarray(rec_offs, dtype=np.int64), n, K,
        out.ctypes.data_as(ctypes.c_char_p), total, out_offs)
    if w < 0:
        raise RuntimeError("replicate_ragged overflow")
    return out, out_offs


def _bind_bcf(lib):
    i64 = ctypes.c_int64
    p64 = np.ctypeslib.ndpointer(np.int64)
    pu8 = np.ctypeslib.ndpointer(np.uint8)
    lib.gdb_bcf_encode_records.restype = i64
    lib.gdb_bcf_encode_records.argtypes = [
        ctypes.c_char_p, p64, i64,
        ctypes.c_char_p, p64, i64,
        ctypes.c_char_p, p64, i64,
        pu8, pu8, ctypes.c_int32,
        ctypes.c_char_p, i64, p64]


def _names_blob(names):
    blob = "".join(names).encode()
    offs = np.zeros(len(names) + 1, dtype=np.int64)
    np.cumsum([len(n.encode()) for n in names], out=offs[1:])
    return blob, offs


def bcf_encode_records(text: bytes, line_offs: np.ndarray,
                       contig_names, str_names, info_types, fmt_types,
                       n_sample: int):
    """Encode newline-free record line spans to BCF2 record bytes.

    info_types/fmt_types: per string-dict id, 0 none / 1 Integer /
    2 Float / 3 String-like.  Returns (bytes, offsets[n+1]) or None when
    the native path is unavailable / a dictionary lookup missed (caller
    falls back to the Python encoder)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "gdb_bcf_encode_records"):
        return None
    if not hasattr(lib, "_bcf_bound"):
        _bind_bcf(lib)
        lib._bcf_bound = True
    n = len(line_offs) - 1
    cb, co = _names_blob(contig_names)
    sb, so = _names_blob(str_names)
    it = np.ascontiguousarray(info_types, dtype=np.uint8)
    ft = np.ascontiguousarray(fmt_types, dtype=np.uint8)
    cap = int(len(text) * 2 + n * 64 + 1024)
    for _ in range(2):
        out_arr, out = _text_buf(cap)
        out_offs = np.empty(n + 1, dtype=np.int64)
        w = lib.gdb_bcf_encode_records(
            text, np.ascontiguousarray(line_offs, dtype=np.int64), n,
            cb, co, len(contig_names), sb, so, len(str_names), it, ft,
            n_sample, out, cap, out_offs)
        if w == -1:
            cap *= 4
            continue
        if w < 0:
            return None   # malformed token / missing name: Python path
        return out_arr[:w].tobytes(), out_offs
    return None


def bcf_decode_records(body: bytes, contig_names, str_names, gt_ids,
                       n_sample: int):
    """Decode a BCF2.2 record section to VCF text lines (one native
    pass; runtime/native/bcf_decode.cpp).  gt_ids: per string-dict id,
    1 when the name is GT.  Returns bytes (trailing newline) or None
    (native unavailable / malformed input -> Python cleanroom path)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "gdb_bcf_decode_records"):
        return None
    if not hasattr(lib, "_bcf_dec_bound"):
        i64 = ctypes.c_int64
        p64 = np.ctypeslib.ndpointer(np.int64)
        pu8 = np.ctypeslib.ndpointer(np.uint8)
        lib.gdb_bcf_decode_records.restype = i64
        lib.gdb_bcf_decode_records.argtypes = [
            ctypes.c_char_p, i64,
            ctypes.c_char_p, p64, i64,
            ctypes.c_char_p, p64, i64,
            pu8, ctypes.c_int32,
            ctypes.c_char_p, i64]
        lib._bcf_dec_bound = True
    cb, co = _names_blob(contig_names)
    sb, so = _names_blob(str_names)
    gt = np.ascontiguousarray(gt_ids, dtype=np.uint8)
    cap = int(len(body) * 4 + 4096)
    for _ in range(3):
        out_arr, out = _text_buf(cap)
        w = lib.gdb_bcf_decode_records(
            body, len(body), cb, co, len(contig_names),
            sb, so, len(str_names), gt, n_sample, out, cap)
        if w == -1:
            cap *= 4
            continue
        if w < 0:
            return None
        return out_arr[:w].tobytes()
    return None


def copy_segments(src: np.ndarray, src0, lens, dest0, out: np.ndarray):
    """out[dest0[i]:dest0[i]+lens[i]] = src[src0[i]:src0[i]+lens[i]] per
    segment; offsets in elements.  None when native lib is unavailable."""
    lib = _prefix_lib()
    if lib is None:
        return None
    n = len(src0)
    src = np.ascontiguousarray(src)
    assert out.flags.c_contiguous and out.dtype == src.dtype
    lib.gdb_copy_segments(
        src.ctypes.data_as(ctypes.c_char_p),
        np.ascontiguousarray(src0, dtype=np.int64),
        np.ascontiguousarray(lens, dtype=np.int64),
        np.ascontiguousarray(dest0, dtype=np.int64), n,
        src.dtype.itemsize, out.ctypes.data_as(ctypes.c_char_p))
    return out


def split_field(text: bytes, starts: np.ndarray, ends: np.ndarray,
                delim: bytes, field_idx: int):
    lib = get_lib()
    n = len(starts)
    out_s = np.empty(n, dtype=np.int64)
    out_e = np.empty(n, dtype=np.int64)
    lib.gdb_split_field(text, starts, ends, n, delim, field_idx, out_s,
                        out_e)
    return out_s, out_e


def identity_outputs(live, pl, pl_len, ad, ad_len, gt, gq, dp, min_dp,
                     gt_len, widths, ploidy: int, gt_phase: bool,
                     mixed: bool, out: dict = None,
                     dest_rows: np.ndarray = None):
    """Native form of combine_step.host_identity_outputs (the ref-block
    identity passthrough).  Returns the output dict or None when the
    native library is unavailable.  Without `out`, dense outputs of
    `widths` (G_out, M_out, P_out).  With `out`/`dest_rows`, record b
    writes into record dest_rows[b] of the caller's outputs: PL / AD /
    GT record-strided (`combine_step.RecordStrided`, or dense arrays,
    their uniform case) at the widths they hold there, GQ / DP / MIN_DP
    into the [B, S] arrays' rows (the split fetch fills its host
    outputs in place, no intermediate copy)."""
    from ..ops.combine_step import RecordStrided
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_ident_bound"):
        i64, i32 = ctypes.c_int64, ctypes.c_int32
        p32 = np.ctypeslib.ndpointer(np.int32)
        p64 = np.ctypeslib.ndpointer(np.int64)
        lib.gdb_identity_outputs.restype = ctypes.c_int
        lib.gdb_identity_outputs.argtypes = [
            p32, i64, i64, i64,            # live, B, S, C
            p32, i64, p32,                 # pl, wpl, pl_len
            p32, i64, p32,                 # ad, wad, ad_len
            p32, i64,                      # gt, wgt
            p32, p32, p32,                 # gq, dp, min_dp
            ctypes.c_void_p,               # gt_len (or NULL)
            i32, i32, i32,                 # ploidy, gt_phase, mixed
            p32, p64, p64,                 # pl out, off, w
            p32, p64, p64,                 # ad out, off, w
            p32, p64, p64,                 # gt out, off, w
            p64, p32, p32, p32]            # dest rows, gq, dp, min_dp
        lib._ident_bound = True
    live = np.ascontiguousarray(live, dtype=np.int32)
    B, S = live.shape
    C = pl.shape[1]
    pl = np.ascontiguousarray(pl, dtype=np.int32)
    ad = np.ascontiguousarray(ad, dtype=np.int32)
    gt = np.ascontiguousarray(gt, dtype=np.int32)
    if out is None:
        G_out, M_out, P_out = widths
        out = {
            "pl": np.empty((B, S, G_out), np.int32),
            "ad": np.empty((B, S, M_out), np.int32),
            "gt": np.empty((B, S, P_out), np.int32),
            "gq": np.empty((B, S), np.int32),
            "dp_format": np.empty((B, S), np.int32),
            "min_dp": np.empty((B, S), np.int32),
        }
    dest = np.arange(B, dtype=np.int64) if dest_rows is None \
        else np.ascontiguousarray(dest_rows, dtype=np.int64)
    strided = []
    for k in ("pl", "ad", "gt"):
        f = RecordStrided.of(out[k])
        assert f.vals.dtype == np.int32
        strided += [f.vals, np.ascontiguousarray(f.off[dest]),
                    np.ascontiguousarray(f.w[dest])]
    for k in ("gq", "dp_format", "min_dp"):
        v = out[k]
        assert v.flags.c_contiguous and v.dtype == np.int32
    if mixed:
        gt_len = np.ascontiguousarray(gt_len, dtype=np.int32)
        gtl_ptr = gt_len.ctypes.data_as(ctypes.c_void_p)
    else:
        gtl_ptr = None
    rc = lib.gdb_identity_outputs(
        live, B, S, C,
        pl, pl.shape[2], np.ascontiguousarray(pl_len, dtype=np.int32),
        ad, ad.shape[2], np.ascontiguousarray(ad_len, dtype=np.int32),
        gt, gt.shape[2],
        np.ascontiguousarray(gq, dtype=np.int32),
        np.ascontiguousarray(dp, dtype=np.int32),
        np.ascontiguousarray(min_dp, dtype=np.int32),
        gtl_ptr, int(ploidy), int(bool(gt_phase)), int(bool(mixed)),
        *strided, dest, out["gq"], out["dp_format"], out["min_dp"])
    if rc != 0:
        return None
    return out


def fmt_cohort(records: bytes, offs: np.ndarray, recs: np.ndarray,
               scols: np.ndarray, K_s: int, fidxs: np.ndarray,
               kinds: np.ndarray, mode: int, lens_list,
               offs_list=None, vals_list=None, fixed_w=None):
    """Cohort-wide FORMAT parse (gdb_fmt_cohort): mode 0 fills per-field
    cell-element counts, mode 1 parses values at final offsets.  Lists
    are per field: lens (int64 [n_cells]), offsets (int64 [n_cells+1],
    ragged fields), values (int32/float32 flat or fixed [n_cells, w]).
    Returns True, or None when the kernel is unavailable; raises on
    malformed numeric input."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "gdb_fmt_cohort"):
        return None
    if not hasattr(lib, "_fmtc_bound"):
        i64 = ctypes.c_int64
        vp = ctypes.POINTER(ctypes.c_void_p)
        lib.gdb_fmt_cohort.restype = ctypes.c_int
        lib.gdb_fmt_cohort.argtypes = [
            ctypes.c_char_p, np.ctypeslib.ndpointer(np.int64), i64,
            np.ctypeslib.ndpointer(np.int64), i64,
            np.ctypeslib.ndpointer(np.int64), i64, i64,
            np.ctypeslib.ndpointer(np.int32),
            np.ctypeslib.ndpointer(np.int32), i64, ctypes.c_int,
            vp, vp, vp, np.ctypeslib.ndpointer(np.int32)]
        lib._fmtc_bound = True
    F = len(lens_list)
    lens_p = (ctypes.c_void_p * F)()
    offs_p = (ctypes.c_void_p * F)()
    vals_p = (ctypes.c_void_p * F)()
    for f in range(F):
        lens_p[f] = lens_list[f].ctypes.data
        if offs_list is not None and offs_list[f] is not None:
            offs_p[f] = offs_list[f].ctypes.data
        if vals_list is not None and vals_list[f] is not None:
            vals_p[f] = vals_list[f].ctypes.data
    if fixed_w is None:
        fixed_w = np.zeros(F, np.int32)
    rc = lib.gdb_fmt_cohort(
        records, np.ascontiguousarray(offs, dtype=np.int64),
        offs.shape[1],
        np.ascontiguousarray(recs, dtype=np.int64), len(recs),
        np.ascontiguousarray(scols, dtype=np.int64), len(scols),
        int(K_s),
        np.ascontiguousarray(fidxs, dtype=np.int32),
        np.ascontiguousarray(kinds, dtype=np.int32), F, int(mode),
        ctypes.cast(lens_p, ctypes.POINTER(ctypes.c_void_p)),
        ctypes.cast(offs_p, ctypes.POINTER(ctypes.c_void_p)),
        ctypes.cast(vals_p, ctypes.POINTER(ctypes.c_void_p)),
        np.ascontiguousarray(fixed_w, dtype=np.int32))
    if rc == -2:
        raise ValueError("malformed numeric FORMAT token")
    return True


def _bind_group(lib):
    i64 = ctypes.c_int64
    vp = ctypes.POINTER(ctypes.c_void_p)
    common = [
        i64, np.ctypeslib.ndpointer(np.int32), vp, vp, vp, vp, vp, vp,
        ctypes.c_char_p, np.ctypeslib.ndpointer(np.int64), i64, i64]
    lib.gdb_render_group.restype = i64
    lib.gdb_render_group.argtypes = common + [
        ctypes.c_char_p, i64, np.ctypeslib.ndpointer(np.int64)]
    if hasattr(lib, "gdb_render_group_lens"):
        lib.gdb_render_group_lens.restype = None
        lib.gdb_render_group_lens.argtypes = common + [
            np.ctypeslib.ndpointer(np.int64)]
        lib.gdb_render_group_at.restype = None
        lib.gdb_render_group_at.argtypes = common + [
            np.ctypeslib.ndpointer(np.int64), ctypes.c_void_p]
    lib._group_bound = True


class _GroupDesc:
    """Marshalled gdb_render_group* argument pack for one signature
    group (kinds/widths/pointer tables + kept-alive source arrays)."""
    __slots__ = ("k", "kinds", "vpp", "rpp", "wpp", "lpp", "bpp", "opp",
                 "delims", "rows", "R", "S", "cap", "keep")


def _marshal_group(cols, rows: np.ndarray, S: int) -> _GroupDesc:
    from ..ops.combine_step import RecordStrided
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    R = len(rows)
    k = len(cols)
    kinds = np.zeros(k, np.int32)
    vals_p = (ctypes.c_void_p * k)()
    roff_p = (ctypes.c_void_p * k)()
    rw_p = (ctypes.c_void_p * k)()
    lens_p = (ctypes.c_void_p * k)()
    blob_p = (ctypes.c_void_p * k)()
    offs_p = (ctypes.c_void_p * k)()
    delims = bytearray(k)
    keep = []
    cap = R * max(S, 1) * (k + 1) + 16   # separators + dots floor

    def strided(c, vals, dtype, lens):
        """Column c's record-strided values; returns each cell's width
        [R, 1]."""
        if not isinstance(vals, RecordStrided):
            vals = np.ascontiguousarray(vals, dtype=dtype)
        f = RecordStrided.of(vals)
        assert f.vals.dtype == dtype
        keep.extend((f.vals, f.off, f.w, lens))
        vals_p[c] = f.vals.ctypes.data
        roff_p[c] = f.off.ctypes.data
        rw_p[c] = f.w.ctypes.data
        lens_p[c] = lens.ctypes.data
        return f.w[rows][:, None]

    for c, col in enumerate(cols):
        if col[0] in ("ints", "floats"):
            _, vals, lens, delim = col
            lens = np.ascontiguousarray(lens, dtype=np.int32)
            is_f = col[0] == "floats"
            w = strided(c, vals, np.float32 if is_f else np.int32, lens)
            kinds[c] = 3 if is_f else 0
            delims[c] = delim[0]
            # worst case per float ~14 chars ("-0.000123" / %g forms)
            cap += int(np.minimum(lens, w).sum()) * (16 if is_f else 12)
        elif col[0] == "blob":
            _, blob, offs = col
            if isinstance(blob, np.ndarray):
                blob = np.ascontiguousarray(blob)
                keep.append(blob)
                blob_p[c] = blob.ctypes.data
            else:
                if not blob:
                    blob = b"\x00"
                keep.append(blob)      # the pointer aliases these bytes
                blob_p[c] = ctypes.cast(ctypes.c_char_p(blob),
                                        ctypes.c_void_p).value
            offs = np.ascontiguousarray(offs, dtype=np.int64)
            keep.append(offs)
            kinds[c] = 1
            offs_p[c] = offs.ctypes.data
            cap += int(offs[-1])
        elif col[0] == "gt":
            _, vals, cell_mask, produce, phase = col
            cell_mask = np.ascontiguousarray(cell_mask, dtype=np.int32)
            w = strided(c, vals, np.int32, cell_mask)
            kinds[c] = 4
            delims[c] = (1 if produce else 0) | (2 if phase else 0)
            cap += int((cell_mask * (w * 12 + 2)).sum())
        elif col[0] == "dots":
            _, lens, delim = col
            lens = np.ascontiguousarray(lens, dtype=np.int32)
            keep.append(lens)
            kinds[c] = 2
            lens_p[c] = lens.ctypes.data
            delims[c] = delim[0]
            cap += int(lens.sum()) * 2
        else:
            raise ValueError(col[0])
    d = _GroupDesc()
    d.k = k
    d.kinds = kinds

    def table(p):
        return ctypes.cast(p, ctypes.POINTER(ctypes.c_void_p))

    d.vpp, d.rpp, d.wpp = table(vals_p), table(roff_p), table(rw_p)
    d.lpp, d.bpp, d.opp = table(lens_p), table(blob_p), table(offs_p)
    d.delims = bytes(delims)
    d.rows = rows
    d.R = R
    d.S = S
    d.cap = cap
    d.keep = keep
    return d


def render_group_fused(cols, rows: np.ndarray, S: int):
    """One-pass FORMAT-group render (gdb_render_group): `cols` is a
    list of descriptors —
      ("ints", vals, lens [R,S], delim)
      ("floats", vals, lens [R,S], delim)
      ("gt", vals, cell mask [R,S], produce_GT, phased)
      ("blob", blob bytes|uint8-array, offs int64 [R*S+1])
      ("dots", lens [R,S], delim)      # missing-call placeholders
    where vals is a `combine_step.RecordStrided` or a dense [B,S(,W)]
    array (its uniform case, taken without a copy).
    Returns (uint8 blob, rec_offsets[R+1]) of per-record sample text
    ("a:b\ta:b..."), or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_group_bound"):
        _bind_group(lib)
    d = _marshal_group(cols, rows, S)
    out_arr, out = _text_buf(d.cap)
    rec_offs = np.empty(d.R + 1, dtype=np.int64)
    w = lib.gdb_render_group(d.k, d.kinds, d.vpp, d.rpp, d.wpp, d.lpp,
                             d.bpp, d.opp, d.delims, d.rows, d.R, d.S,
                             out, d.cap, rec_offs)
    if w < 0:
        raise RuntimeError("render_group overflow")
    return out_arr[:w], rec_offs


def render_group_lens(desc: _GroupDesc) -> Optional[np.ndarray]:
    """Per-record sample-text byte lengths for one marshalled group
    (phase 1 of the direct-write render).  None without the kernel."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "gdb_render_group_lens"):
        return None
    if not hasattr(lib, "_group_bound"):
        _bind_group(lib)
    lens = np.empty(desc.R, dtype=np.int64)
    lib.gdb_render_group_lens(desc.k, desc.kinds, desc.vpp, desc.rpp,
                              desc.wpp, desc.lpp, desc.bpp, desc.opp,
                              desc.delims, desc.rows, desc.R, desc.S, lens)
    return lens


def render_group_at(desc: _GroupDesc, dest: np.ndarray,
                    out: np.ndarray) -> None:
    """Write each record's sample text at out[dest[r]:] (phase 2 of the
    direct-write render; lengths were taken from render_group_lens)."""
    lib = get_lib()
    if not hasattr(lib, "_group_bound"):
        _bind_group(lib)
    dest = np.ascontiguousarray(dest, dtype=np.int64)
    lib.gdb_render_group_at(desc.k, desc.kinds, desc.vpp, desc.rpp,
                            desc.wpp, desc.lpp, desc.bpp, desc.opp,
                            desc.delims, desc.rows, desc.R, desc.S, dest,
                            out.ctypes.data_as(ctypes.c_void_p))


def widen_scatter(narrow: np.ndarray, dest_off: np.ndarray, miss: int,
                  eov: int, out: np.ndarray):
    """Row r of `narrow` ([n, ...] int8 / int16), int32-widened with the
    sentinel remap (miss -> INT_MISSING, eov -> INT_VECTOR_END), written
    at element dest_off[r] of the flat int32 `out` (a negative offset
    skips the row), threaded.  Returns None when the native library is
    unavailable (caller keeps numpy)."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_widen_bound"):
        i64 = ctypes.c_int64
        lib.gdb_widen_scatter.restype = ctypes.c_int
        lib.gdb_widen_scatter.argtypes = [
            ctypes.c_void_p, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int64), i64, i64, i64, i64,
            np.ctypeslib.ndpointer(np.int32)]
        lib._widen_bound = True
    narrow = np.ascontiguousarray(narrow)
    if narrow.dtype.itemsize not in (1, 2):
        return None
    assert out.flags.c_contiguous and out.dtype == np.int32
    dest_off = np.ascontiguousarray(dest_off, dtype=np.int64)
    assert len(dest_off) == narrow.shape[0]
    elem = int(np.prod(narrow.shape[1:], dtype=np.int64)) \
        if narrow.ndim > 1 else 1
    rc = lib.gdb_widen_scatter(
        narrow.ctypes.data_as(ctypes.c_void_p), narrow.dtype.itemsize,
        dest_off, narrow.shape[0], elem, int(miss), int(eov), out)
    return True if rc == 0 else None


def _grid_fields():
    p, pp, i = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), \
        ctypes.c_int64
    return ([(n, p) for n in ("col", "end", "cell_of", "gt_len_sc",
                              "med_any_sc", "starts")]
            + [(n, i) for n in ("B", "S", "C", "N")]
            + [(n, p) for n in ("refblock", "hasdel", "ref_ok",
                                "gt_valid")]
            + [("other", pp), ("n_other", i), ("core", pp), ("n_core", i)]
            + [(n, p) for n in ("live", "cells", "starteq", "var",
                                "gt_len")]
            + [("core_out", pp)]
            + [(n, p) for n in ("endmin", "is_var", "rec_hasdel",
                                "first_start", "rw_any", "has_med",
                                "hasother")])


class _GridArgs(ctypes.Structure):
    """`struct GridArgs` of native/vcf_kernels.cpp, field for field."""
    _fields_ = _grid_fields()


def _ptr(arr) -> Optional[int]:
    return None if arr is None else arr.ctypes.data


def _ptrs(arrs):
    """A C array of the arrays' data pointers (a struct that holds it
    keeps it alive)."""
    return (ctypes.c_void_p * max(len(arrs), 1))(
        *[a.ctypes.data for a in arrs])


def _grid_lib():
    """The native library with `gdb_block_grid` and `gdb_lut_fill`
    bound, or None."""
    lib = get_lib()
    if lib is not None and not hasattr(lib, "_grid_bound"):
        lib.gdb_block_grid.restype = ctypes.c_int
        lib.gdb_block_grid.argtypes = [ctypes.POINTER(_GridArgs)]
        lib.gdb_lut_fill.restype = ctypes.c_int
        lib.gdb_lut_fill.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int64, ctypes.c_void_p] + [ctypes.c_int64] * 3 + [
            ctypes.c_void_p] * 2
        lib._grid_bound = True
    return lib


def block_grid(col: np.ndarray, end: np.ndarray, cell_of: np.ndarray,
               starts: np.ndarray, n_cells: int, *, refblock, hasdel,
               ref_ok, gt_len_sc, gt_valid=None, other=(), core=(),
               med_any_sc=None, slots: bool = True) -> Optional[dict]:
    """A chunk's records x samples grid over the [S, C] sorted cell
    layout for ascending `starts`, in one threaded pass
    (`gdb_block_grid`).  Per-cell tables, bool [n_cells]: `refblock`,
    `hasdel`, `ref_ok`, `gt_valid` (None: every GT valid), each of
    `other` and of `core`; per-slot tables, [S, C]: `gt_len_sc` (int32)
    and `med_any_sc` (bool, or None).

    Per record: `endmin` (least END of the live cells, INT64_MAX none),
    `is_var`, `hasdel`, `first_start` (first sample whose live cell
    starts here with a valid REF, -1 none), `rw_any` (a variant cell in
    `hasdel` that does not start here), `has_med` (None without
    `med_any_sc`), `hasother` (a live cell valid in any of `other`).
    With `slots`, per (record, sample) too: `live` (int32, the cell's
    column in its row, -1 none), `cells` (int64 store cell, -1),
    `starteq`, `var` (live and not `refblock`), `gt_len` (`gt_len_sc`
    where live and GT valid, else 0) and `core` (live and each of
    `core`).  None without the native library."""
    lib = _grid_lib()
    if lib is None:
        return None

    def flags(a):
        return None if a is None else np.ascontiguousarray(a, dtype=bool)
    col = np.ascontiguousarray(col, dtype=np.int64)
    end = np.ascontiguousarray(end, dtype=np.int64)
    cell_of = np.ascontiguousarray(cell_of, dtype=np.int64)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    gt_len_sc = np.ascontiguousarray(gt_len_sc, dtype=np.int32)
    S, C = col.shape
    B = len(starts)
    tables = {n: flags(a) for n, a in (
        ("refblock", refblock), ("hasdel", hasdel), ("ref_ok", ref_ok),
        ("gt_valid", gt_valid))}
    other = [flags(a) for a in other]
    core = [flags(a) for a in core]
    med_any_sc = flags(med_any_sc)
    out = {"endmin": np.empty(B, np.int64), "is_var": np.empty(B, bool),
           "hasdel": np.empty(B, bool), "first_start": np.empty(B, np.int64),
           "rw_any": np.empty(B, bool), "hasother": np.empty(B, bool),
           "has_med": np.empty(B, bool) if med_any_sc is not None
           else None}
    if slots:
        out.update(live=np.empty((B, S), np.int32),
                   cells=np.empty((B, S), np.int64),
                   starteq=np.empty((B, S), bool),
                   var=np.empty((B, S), bool),
                   gt_len=np.empty((B, S), np.int32),
                   core=[np.empty((B, S), bool) for _ in core])
    args = _GridArgs(
        col=_ptr(col), end=_ptr(end), cell_of=_ptr(cell_of),
        gt_len_sc=_ptr(gt_len_sc), med_any_sc=_ptr(med_any_sc),
        starts=_ptr(starts), B=B, S=S, C=C, N=n_cells,
        **{n: _ptr(a) for n, a in tables.items()},
        other=_ptrs(other), n_other=len(other), core=_ptrs(core),
        n_core=len(core) if slots else 0,
        live=_ptr(out.get("live")), cells=_ptr(out.get("cells")),
        starteq=_ptr(out.get("starteq")), var=_ptr(out.get("var")),
        gt_len=_ptr(out.get("gt_len")),
        core_out=_ptrs(out["core"] if slots else []),
        endmin=_ptr(out["endmin"]), is_var=_ptr(out["is_var"]),
        rec_hasdel=_ptr(out["hasdel"]),
        first_start=_ptr(out["first_start"]), rw_any=_ptr(out["rw_any"]),
        has_med=_ptr(out["has_med"]), hasother=_ptr(out["hasother"]))
    if lib.gdb_block_grid(ctypes.byref(args)) != 0:
        return None
    return out


def lut_fill(live: np.ndarray, var: np.ndarray, cells: np.ndarray,
             alt_ok: np.ndarray, rec_num_merged: np.ndarray, width: int):
    """(inv_bs int32 [B, S, width], nr_bs int32 [B, S]) written once
    (`gdb_lut_fill`) from `block_grid`'s `live`, `var` and `cells`: -1
    everywhere but each live reference-block slot (`live` >= 0, not
    `var`), which takes REF at 0 and, where its cell's ALT is valid,
    NON_REF at its record's merged width - 1 with nr 1.  None without
    the native library."""
    lib = _grid_lib()
    if lib is None:
        return None
    B, S = live.shape
    inv = np.empty((B, S, width), np.int32)
    nr = np.empty((B, S), np.int32)
    alt_ok = np.ascontiguousarray(alt_ok, dtype=bool)
    rnm = np.ascontiguousarray(rec_num_merged, dtype=np.int32)
    lib.gdb_lut_fill(_ptr(live), _ptr(var), _ptr(cells), _ptr(alt_ok),
                     len(alt_ok), _ptr(rnm), B, S, width, _ptr(inv),
                     _ptr(nr))
    return inv, nr
