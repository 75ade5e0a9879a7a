"""Known-field registry.

Mirrors the reference's known-field semantics (field enum order, default
length descriptors and default INFO combine operations) so that query
bookkeeping and the combine operator behave identically.

Reference: src/main/cpp/include/utils/known_field_info.h:30-60 (enum),
src/main/cpp/src/utils/known_field_info.cc:225-310 (defaults).
"""

from __future__ import annotations

# Length descriptor codes (reference uses htslib's BCF_VL_* plus two custom
# codes; see src/main/cpp/include/utils/vid_mapper.h:176 FieldLengthDescriptor)
VL_FIXED = "FIXED"
VL_VAR = "VAR"
VL_A = "A"  # one element per ALT allele
VL_R = "R"  # one element per allele (REF + ALTs)
VL_G = "G"  # one element per genotype
VL_P = "P"  # ploidy (GT without phase)
VL_PP = "PP"  # phased ploidy (GT with interleaved phase elements)

ALLELE_DEPENDENT = {VL_A, VL_R, VL_G}
GENOTYPE_DEPENDENT = {VL_G}

# Combine operations (reference vid_mapper.h:151-162)
OP_SUM = "sum"
OP_MEAN = "mean"
OP_MEDIAN = "median"
OP_DP = "DP"
OP_MOVE_TO_FORMAT = "move_to_FORMAT"
OP_ELEMENT_WISE_SUM = "element_wise_sum"
OP_CONCATENATE = "concatenate"
OP_HISTOGRAM_SUM = "histogram_sum"
OP_NONE = None  # VCF_FIELD_COMBINE_OPERATION_UNKNOWN_OPERATION

# Known fields in reference enum order (known_field_info.h:30-60). The order
# matters only for identity; lookups are by name.
KNOWN_FIELD_NAMES = [
    "END", "REF", "ALT", "QUAL", "FILTER",
    "BaseQRankSum", "ClippingRankSum", "MQRankSum", "ReadPosRankSum",
    "DP", "MQ", "RAW_MQ", "MQ0", "DP_FORMAT", "MIN_DP", "GQ", "SB",
    "AD", "PL", "AF", "AN", "AC", "GT", "PS", "PGT", "PID", "ExcessHet",
    "ID",
]
KNOWN_FIELD_ENUM = {n: i for i, n in enumerate(KNOWN_FIELD_NAMES)}

# Default length descriptors (known_field_info.cc:239-284). Everything not
# listed defaults to FIXED length 1.
_DEFAULT_LENGTH = {
    "REF": (VL_VAR, 1),
    "ALT": (VL_VAR, 1),
    "FILTER": (VL_VAR, 1),
    "AF": (VL_A, 1),
    "AC": (VL_A, 1),
    "AD": (VL_R, 1),
    "PL": (VL_G, 1),
    "GT": (VL_PP, 1),  # BCF_VL_Phased_Ploidy by default
    "SB": (VL_FIXED, 4),
    "RAW_MQ": (VL_FIXED, 1),
    "PGT": (VL_VAR, 1),
    "PID": (VL_VAR, 1),
}

# Default INFO combine operations (known_field_info.cc:285-307)
_DEFAULT_COMBINE_OP = {
    "BaseQRankSum": OP_MEDIAN,
    "ClippingRankSum": OP_MEDIAN,
    "MQRankSum": OP_MEDIAN,
    "ReadPosRankSum": OP_MEDIAN,
    "MQ": OP_MEDIAN,
    "MQ0": OP_MEDIAN,
    "ExcessHet": OP_MEDIAN,
    "RAW_MQ": OP_SUM,
    "DP": OP_DP,
}


def is_known_field(name: str) -> bool:
    return name in KNOWN_FIELD_ENUM


def default_length_descriptor(name: str):
    """(code, num_elements) default for a known field; FIXED/1 otherwise."""
    return _DEFAULT_LENGTH.get(name, (VL_FIXED, 1))


def default_combine_op(name: str):
    return _DEFAULT_COMBINE_OP.get(name, OP_NONE)


def num_elements_for_length(code: str, num_alt: int, ploidy: int,
                            fixed_len: int = 1) -> int:
    """#elements of a field given the length descriptor code.

    Reference: known_field_info.cc:192-223
    (KnownFieldInfo::get_num_elements_for_known_field_enum).
    """
    n_alleles = num_alt + 1
    if code == VL_FIXED:
        return fixed_len
    if code == VL_VAR:
        return 1
    if code == VL_A:
        return num_alt
    if code == VL_R:
        return n_alleles
    if code == VL_G:
        return num_genotypes(num_alt, ploidy)
    if code in (VL_P, VL_PP):
        return ploidy
    raise ValueError(f"unknown length descriptor {code}")


def num_genotypes(num_alt: int, ploidy: int) -> int:
    """#genotypes for given #ALT alleles and ploidy = C(num_alt+ploidy, ploidy).

    Reference: variant_operations.h:317 (nCr use) /
    KnownFieldInfo::get_number_of_genotypes.
    """
    n = num_alt + ploidy
    r = ploidy
    # nCr
    result = 1
    for i in range(r):
        result = result * (n - i) // (i + 1)
    return result
