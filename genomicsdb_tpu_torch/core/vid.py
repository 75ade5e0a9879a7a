"""Vid mapper: contig map (flattened genome axis), field registry, callsets.

This is the metadata plane of the engine (reference:
src/main/cpp/include/utils/vid_mapper.h:439 VidMapper / :316 FieldInfo /
:176 FieldLengthDescriptor; JSON parsing src/main/cpp/src/utils/vid_mapper.cc).
"""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Tuple

from . import known_fields as kf

FORMAT_SUFFIX = "_FORMAT"  # reference vid_mapper.cc:103
TUPLE_SUFFIX = "_tuple_element_"  # reference vid_mapper.cc:104

_COMBINE_OP_NAMES = {
    "sum": kf.OP_SUM,
    "mean": kf.OP_MEAN,
    "median": kf.OP_MEDIAN,
    "DP": kf.OP_DP,
    "move_to_FORMAT": kf.OP_MOVE_TO_FORMAT,
    "element_wise_sum": kf.OP_ELEMENT_WISE_SUM,
    "concatenate": kf.OP_CONCATENATE,
    "histogram_sum": kf.OP_HISTOGRAM_SUM,
}

_LENGTH_CODES = {
    "A": kf.VL_A, "R": kf.VL_R, "G": kf.VL_G, "VAR": kf.VL_VAR,
    "P": kf.VL_P, "PP": kf.VL_PP,
}


@dataclass
class LengthDescriptor:
    """Per-dimension (code, fixed_len) pairs + VCF delimiters.

    Reference: vid_mapper.h:176 FieldLengthDescriptor.
    """
    dims: List[Tuple[str, int]] = dc_field(default_factory=lambda: [(kf.VL_FIXED, 1)])
    vcf_delimiters: List[str] = dc_field(default_factory=list)

    @property
    def num_dimensions(self) -> int:
        return len(self.dims)

    @property
    def code(self) -> str:
        return self.dims[0][0]

    @property
    def fixed_len(self) -> int:
        return self.dims[0][1]

    def is_fixed(self) -> bool:
        return all(c == kf.VL_FIXED for c, _ in self.dims)

    def is_allele_dependent(self) -> bool:
        return any(c in kf.ALLELE_DEPENDENT for c, _ in self.dims)

    def is_genotype_dependent(self) -> bool:
        return any(c in kf.GENOTYPE_DEPENDENT for c, _ in self.dims)

    def is_only_alt_dependent(self) -> bool:
        return self.code == kf.VL_A

    def contains_phase(self) -> bool:
        return any(c == kf.VL_PP for c, _ in self.dims)

    def is_ploidy_dependent(self) -> bool:
        return any(c in (kf.VL_P, kf.VL_PP) for c, _ in self.dims)

    def ploidy(self, num_elements: int) -> int:
        """Ploidy from the stored GT element count.

        With phase information, GT of ploidy p is stored as 2p-1 interleaved
        elements (reference broad_combined_gvcf.cc:650-652).
        """
        if self.contains_phase():
            return (num_elements + 1) // 2
        return num_elements

    def num_elements(self, num_alt: int = 0, ploidy: int = 0) -> int:
        return kf.num_elements_for_length(self.code, num_alt, ploidy,
                                          self.dims[0][1])

    def delimiter(self, dim: int) -> str:
        if dim < len(self.vcf_delimiters):
            return self.vcf_delimiters[dim]
        return ","


@dataclass
class FieldInfo:
    name: str                       # genomicsdb name (e.g. DP_FORMAT)
    vcf_name: str                   # VCF field name (e.g. DP)
    element_types: Tuple[str, ...]  # per-tuple-element: int/float/char/flag
    is_info: bool = False
    is_format: bool = False
    is_filter: bool = False
    length: LengthDescriptor = dc_field(default_factory=LengthDescriptor)
    vcf_type: Optional[str] = None  # "string" when multi-D serialized as text
    combine_op: Optional[str] = kf.OP_NONE
    field_idx: int = -1             # global vid field index
    is_flattened: bool = False
    parent_name: Optional[str] = None
    tuple_index: int = 0

    @property
    def type(self) -> str:
        return self.element_types[0]

    @property
    def num_elements_in_tuple(self) -> int:
        return len(self.element_types)

    def is_composite(self) -> bool:
        return len(self.element_types) > 1


@dataclass
class ContigInfo:
    name: str
    length: int
    offset: int  # tiledb_column_offset


@dataclass
class CallsetInfo:
    name: str
    row_idx: int
    idx_in_file: int
    filename: str
    stream_name: Optional[str] = None


class VidMapper:
    """Parsed vid + callset metadata with contig/position translation."""

    def __init__(self):
        self.fields: Dict[str, FieldInfo] = {}
        self.field_order: List[str] = []
        self.contigs: Dict[str, ContigInfo] = {}
        # contigs sorted by offset for position->contig lookup
        self._contig_offsets: List[int] = []
        self._contigs_by_offset: List[ContigInfo] = []
        self.callsets: Dict[str, CallsetInfo] = {}
        self.rows: Dict[int, CallsetInfo] = {}
        self.callsets_dir: Optional[str] = None

    # ---------------- construction ----------------

    @classmethod
    def from_files(cls, vid_file: str, callsets_file: Optional[str] = None
                   ) -> "VidMapper":
        vm = cls()
        with open(vid_file) as f:
            vm.parse_vid(json.load(f))
        if callsets_file:
            with open(callsets_file) as f:
                vm.parse_callsets(json.load(f))
            import os
            vm.callsets_dir = os.path.dirname(os.path.abspath(callsets_file))
        return vm

    def parse_vid(self, doc: dict):
        fields = doc.get("fields", {})
        if isinstance(fields, list):
            items = [(d["name"], d) for d in fields]
        else:
            items = list(fields.items())
        for name, spec in items:
            self._add_field(name, spec)
        self._add_mandatory_fields()
        self._flatten_fields()
        self._reindex()
        contigs = doc.get("contigs", {})
        if isinstance(contigs, list):
            citems = [(d["name"], d) for d in contigs]
        else:
            citems = list(contigs.items())
        for name, spec in citems:
            self.contigs[name] = ContigInfo(
                name=name, length=int(spec["length"]),
                offset=int(spec["tiledb_column_offset"]))
        self._contigs_by_offset = sorted(self.contigs.values(),
                                         key=lambda c: c.offset)
        self._contig_offsets = [c.offset for c in self._contigs_by_offset]

    def _add_field(self, name: str, spec: dict):
        ftype = spec.get("type", "int")
        if isinstance(ftype, list):
            element_types = tuple(ftype)
        else:
            element_types = (ftype,)
        classes = spec.get("vcf_field_class", [])
        length = self._parse_length(name, spec)
        combine_op = kf.OP_NONE
        if "VCF_field_combine_operation" in spec:
            combine_op = _COMBINE_OP_NAMES[spec["VCF_field_combine_operation"]]
        elif kf.is_known_field(name):
            combine_op = kf.default_combine_op(name)
        delimiters = spec.get("vcf_delimiter", [])
        if isinstance(delimiters, str):
            delimiters = [delimiters]
        length.vcf_delimiters = list(delimiters)
        info = FieldInfo(
            name=name, vcf_name=name, element_types=element_types,
            is_info="INFO" in classes, is_format="FORMAT" in classes,
            is_filter="FILTER" in classes, length=length,
            vcf_type=spec.get("vcf_type"), combine_op=combine_op)
        self.fields[name] = info
        self.field_order.append(name)

    def _add_mandatory_fields(self):
        """END/REF/ALT/QUAL/FILTER registered if absent
        (reference vid_mapper.cc:611-684)."""
        mandatory = [
            ("END", {"vcf_field_class": ["INFO"], "type": "int"}),
            ("REF", {"type": "char", "length": "VAR"}),
            ("ALT", {"type": "char", "length": "VAR"}),
            ("QUAL", {"type": "float"}),
            ("FILTER", {"type": "int", "length": "VAR"}),
        ]
        for name, spec in mandatory:
            if name not in self.fields:
                self._add_field(name, spec)

    def _parse_length(self, name: str, spec: dict) -> LengthDescriptor:
        if "length" not in spec:
            if kf.is_known_field(name):
                code, n = kf.default_length_descriptor(name)
                return LengthDescriptor([(code, n)])
            return LengthDescriptor([(kf.VL_FIXED, 1)])
        raw = spec["length"]
        dims = []
        raw_list = raw if isinstance(raw, list) else [raw]
        for entry in raw_list:
            if isinstance(entry, int):
                dims.append((kf.VL_FIXED, entry))
            else:
                code = _LENGTH_CODES.get(str(entry).upper())
                if code is None:
                    # integer-as-string, or unknown -> VAR
                    try:
                        dims.append((kf.VL_FIXED, int(entry)))
                        continue
                    except ValueError:
                        code = kf.VL_VAR
                dims.append((code, 1))
        return LengthDescriptor(dims)

    def _flatten_fields(self):
        """DP-style INFO+FORMAT split and composite-tuple flattening.

        Flattened fields are inserted IN PLACE right after their parent —
        the reference flattens each field immediately after parsing it
        (vid_mapper.cc:1430-1431 flatten_field call site), so DP_FORMAT
        sits between DP and the next vid field.
        """
        import copy
        new_order: List[str] = []
        for name in self.field_order:
            info = self.fields[name]
            new_order.append(name)
            both = info.is_info and info.is_format
            format_name = name
            if both:
                fmt = copy.deepcopy(info)
                fmt.name = name + FORMAT_SUFFIX
                fmt.is_info = False
                fmt.combine_op = kf.OP_NONE
                self.fields[fmt.name] = fmt
                new_order.append(fmt.name)
                info.is_format = False
                format_name = fmt.name
            if info.is_composite():
                for parent in ([name, format_name] if both else [name]):
                    pinfo = self.fields[parent]
                    for i, etype in enumerate(pinfo.element_types):
                        el = copy.deepcopy(pinfo)
                        el.name = f"{parent}{TUPLE_SUFFIX}{i}"
                        el.element_types = (etype,)
                        el.is_flattened = True
                        el.parent_name = parent
                        el.tuple_index = i
                        self.fields[el.name] = el
                        new_order.append(el.name)
        self.field_order = new_order

    def _reindex(self):
        for i, name in enumerate(self.field_order):
            self.fields[name].field_idx = i

    def parse_callsets(self, doc: dict):
        callsets = doc.get("callsets", doc)
        if isinstance(callsets, list):
            items = [(d["sample_name"] if "sample_name" in d else d["name"], d)
                     for d in callsets]
        else:
            items = list(callsets.items())
        for name, spec in items:
            cs = CallsetInfo(
                name=name, row_idx=int(spec["row_idx"]),
                idx_in_file=int(spec.get("idx_in_file", 0)),
                filename=spec.get("filename", spec.get("stream_name", "")),
                stream_name=spec.get("stream_name"))
            self.callsets[name] = cs
            self.rows[cs.row_idx] = cs

    # ---------------- queries ----------------

    def get_field_info(self, name: str) -> Optional[FieldInfo]:
        return self.fields.get(name)

    def flattened_field_name(self, name: str, tuple_idx: int) -> str:
        return f"{name}{TUPLE_SUFFIX}{tuple_idx}"

    def contig_offset(self, contig: str) -> int:
        return self.contigs[contig].offset

    def flatten_position(self, contig: str, pos_1based: int) -> int:
        """1-based VCF position -> 0-based flattened column."""
        return self.contigs[contig].offset + pos_1based - 1

    def get_contig_location(self, column: int) -> Optional[Tuple[str, int]]:
        """column -> (contig_name, 0-based offset within contig).

        Reference: vid_mapper.h:457-468 get_contig_location.
        """
        idx = bisect.bisect_right(self._contig_offsets, column) - 1
        if idx < 0:
            return None
        c = self._contigs_by_offset[idx]
        if column >= c.offset + c.length:
            return None
        return c.name, column - c.offset

    def get_next_contig_location(self, column: int
                                 ) -> Optional[Tuple[str, int]]:
        """Smallest contig offset > column -> (name, offset).

        Reference: VidMapper::get_next_contig_location.
        """
        idx = bisect.bisect_right(self._contig_offsets, column)
        if idx >= len(self._contigs_by_offset):
            return None
        c = self._contigs_by_offset[idx]
        return c.name, c.offset

    def max_callset_row_idx(self) -> int:
        return max(self.rows) if self.rows else -1

    def num_rows(self) -> int:
        return len(self.rows)

    def callset_name(self, row_idx: int) -> str:
        return self.rows[row_idx].name

    def schema_attribute_names(self, import_id: bool = False) -> List[str]:
        """Attribute order of the reference's array schema.

        Reference: vid_mapper.cc:354-434 build_tiledb_array_schema.
        """
        attrs = ["END", "REF", "ALT"]
        if import_id and "ID" in self.fields:
            attrs.append("ID")
        attrs += ["QUAL", "FILTER"]
        for name in self.field_order:
            info = self.fields[name]
            if name == "END" or info.is_composite():
                continue
            if info.is_info:
                attrs.append(name)
        for name in self.field_order:
            info = self.fields[name]
            if name == "END" or info.is_composite():
                continue
            if info.is_format:
                attrs.append(name)
        return attrs
