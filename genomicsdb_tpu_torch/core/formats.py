"""Output formatting + missing-value sentinels.

Byte-exact reimplementation of the formatting used by the reference's output
paths:
  * VCF float values: htslib kputd-style 6-significant-digit fixed point with
    trailing-zero trimming, keeping at least one decimal digit, %g fallback
    outside [0.0001, 999999].  (Derived empirically from
    /root/reference/tests/golden_outputs/*: "31.72", "8.0", "93600.0",
    "0.055555", "0.005".)
  * calls JSON floats: C++ ostream default (6 significant digits).
  * variants JSON floats: std::fixed, setprecision(6)
    (reference variant.cc:965-966).
Sentinels mirror htslib's missing / vector-end values (vcf.h:60-134).
"""

from __future__ import annotations

import math
import struct

import numpy as np

# ---------------- sentinels ----------------

# htslib int32 sentinels
INT_MISSING = -(2**31)          # bcf_int32_missing = INT32_MIN
INT_VECTOR_END = -(2**31) + 1   # bcf_int32_vector_end

# htslib float sentinels (NaN payloads).  These are SIGNALING NaNs; any trip
# through a Python float (float64) quietens the payload, so they are kept as
# np.float32 scalars with exact bits and must never pass through float().
FLOAT_MISSING_BITS = 0x7F800001
FLOAT_VECTOR_END_BITS = 0x7F800002
FLOAT_MISSING = np.frombuffer(struct.pack("<I", FLOAT_MISSING_BITS),
                              dtype=np.float32)[0]
FLOAT_VECTOR_END = np.frombuffer(struct.pack("<I", FLOAT_VECTOR_END_BITS),
                                 dtype=np.float32)[0]

# char sentinels
CHAR_MISSING = "."   # bcf_str_missing is '.' (0x07 in BCF encoding)
CHAR_VECTOR_END = ""

# TileDB null sentinels used by the reference storage layer
# (variant_field_data.h: TILEDB_EMPTY_INT32 etc.)
TILEDB_EMPTY_INT32 = INT_MISSING
TILEDB_EMPTY_INT64 = -(2**63)
TILEDB_EMPTY_FLOAT32 = FLOAT_MISSING
TILEDB_EMPTY_CHAR = "\0"

# GT no-call allele index (bcf_gt_missing >> 1 - 1 == -1 stored form)
GT_NO_CALL = -1


def float_bits(x) -> int:
    """Exact float32 bit pattern (no float64 round trip for f32 inputs)."""
    a = np.asarray(x)
    if a.dtype != np.float32:
        a = a.astype(np.float32)
    return int(a.view(np.uint32))


def is_float_missing(x) -> bool:
    return float_bits(x) == FLOAT_MISSING_BITS


def is_float_vector_end(x) -> bool:
    return float_bits(x) == FLOAT_VECTOR_END_BITS


def is_bcf_valid_int(v: int) -> bool:
    """is_bcf_valid_value<int>: neither missing nor vector_end."""
    return v != INT_MISSING and v != INT_VECTOR_END


def is_bcf_valid_float(v) -> bool:
    b = float_bits(v)
    return b != FLOAT_MISSING_BITS and b != FLOAT_VECTOR_END_BITS


# ---------------- float → text ----------------

def _cpp_default_float(x: float) -> str:
    """C++ `ostream << float` default: %g with 6 significant digits."""
    s = "%g" % x
    return s


def format_float_calls_json(x) -> str:
    """calls-JSON float: ostream default formatting of a float32 value."""
    return _cpp_default_float(float(np.float32(x)))


def format_float_variants_json(x) -> str:
    """variants-JSON float: std::fixed setprecision(6) of a float32 value."""
    return "%.6f" % float(np.float32(x))


def format_float_vcf(x) -> str:
    """htslib kputd-equivalent used when rendering VCF float values.

    6 significant digits fixed-point; trailing zeros trimmed but at least one
    decimal digit kept; %g fallback for |x| outside [0.0001, 999999].
    """
    d = float(np.float32(x))
    if d == 0:
        return "-0" if math.copysign(1.0, d) < 0 else "0"
    sign = ""
    if d < 0:
        sign = "-"
        d = -d
    if d < 0.0001 or d > 999999:
        return sign + ("%g" % d)
    # 6 significant digits: decimals = 6 - floor(log10(d)) - 1
    # (negative "integer digits" for d < 1 extend the decimal count)
    int_digits = int(math.floor(math.log10(d))) + 1
    decimals = 6 - int_digits
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


def format_float_fixed3(x) -> str:
    """std::fixed setprecision(3) (2-D field stringify,
    reference variant_field_handler.cc stringify_2D_vector)."""
    return "%.3f" % float(np.float32(x))
