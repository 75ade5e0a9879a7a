"""Loader / query configuration + query bookkeeping.

JSON-plane compatible with the reference's loader and query JSON files
(src/main/cpp/src/config/json_config.cc) and its bookkeeping semantics
(src/main/cpp/src/genomicsdb/query_variants.cc:578-685
do_query_bookkeeping + variant_query_config.cc:161-185
reorder_query_fields).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field as dc_field
from typing import List, Optional, Tuple

from .vid import VidMapper

INT64_MAX = 2**63 - 1


def _parse_column_ranges(doc) -> List[List[Tuple[int, int]]]:
    """query_column_ranges: list (per rank) of lists of intervals.

    Accepts the reference's several syntaxes (json_config.cc):
      [{"range_list": [{"low": a, "high": b}, ...]}]
      [[a, b, [c, d], {"a": b}, ...]]   (scalars = single positions)
    """
    out = []
    for rank_entry in doc:
        intervals: List[Tuple[int, int]] = []
        if isinstance(rank_entry, dict) and "range_list" in rank_entry:
            for r in rank_entry["range_list"]:
                intervals.append((int(r["low"]), int(r["high"])))
        elif isinstance(rank_entry, dict) and \
                "column_or_interval_list" in rank_entry:
            # protobuf-JSON form (GATK path; reference
            # genomicsdb_export_config.proto + run.py
            # modify_query_column_ranges_for_PB)
            for item in rank_entry["column_or_interval_list"]:
                ci = item.get("column_interval", {})
                if "column_interval" in ci:
                    ci = ci["column_interval"]
                if "begin" in ci:
                    intervals.append((int(ci["begin"]), int(ci["end"])))
                elif "column" in item:
                    c = int(item["column"])
                    intervals.append((c, c))
        else:
            for item in rank_entry:
                if isinstance(item, (int, float)):
                    intervals.append((int(item), int(item)))
                elif isinstance(item, list):
                    intervals.append((int(item[0]), int(item[1])))
                elif isinstance(item, dict):
                    (k, v), = item.items()
                    intervals.append((int(k), int(v)))
        out.append(intervals)
    return out


@dataclass
class QueryParams:
    """Parsed query JSON (reference GenomicsDBConfigBase keys)."""
    workspace: str = ""
    array_name: str = ""
    vid_mapping_file: str = ""
    callset_mapping_file: str = ""
    column_ranges: List[List[Tuple[int, int]]] = dc_field(default_factory=list)
    row_ranges: List[List[Tuple[int, int]]] = dc_field(default_factory=list)
    attributes: List[str] = dc_field(default_factory=list)
    reference_genome: str = ""
    vcf_header_filename: Optional[str] = None
    scan_full: bool = False
    segment_size: int = 10 * 1024 * 1024
    produce_GT_field: bool = False
    produce_FILTER_field: bool = False
    sites_only_query: bool = False
    produce_GT_with_min_PL_value_for_spanning_deletions: bool = False
    max_diploid_alt_alleles_that_can_be_genotyped: int = 50  # gt_common.h:48
    vcf_output_format: str = ""
    vcf_output_filename: str = "-"
    index_output_VCF: bool = False
    base_dir: str = ""

    @classmethod
    def from_file(cls, path: str, rank: int = 0) -> "QueryParams":
        with open(path) as f:
            doc = json.load(f)
        qp = cls.from_dict(doc, rank)
        qp.base_dir = os.path.dirname(os.path.abspath(path))
        return qp

    @classmethod
    def from_dict(cls, doc: dict, rank: int = 0) -> "QueryParams":
        qp = cls()
        ws = doc.get("workspace", "")
        qp.workspace = ws[rank] if isinstance(ws, list) else ws
        an = doc.get("array_name", doc.get("array", ""))
        qp.array_name = an[rank] if isinstance(an, list) else an
        qp.vid_mapping_file = doc.get("vid_mapping_file", "")
        qp.callset_mapping_file = doc.get("callset_mapping_file", "")
        if "query_column_ranges" in doc:
            ranges = _parse_column_ranges(doc["query_column_ranges"])
            qp.column_ranges = (ranges[rank:rank + 1] if rank < len(ranges)
                                else [[]])
        if "query_row_ranges" in doc:
            qp.row_ranges = _parse_column_ranges(doc["query_row_ranges"])
        qp.attributes = list(doc.get("attributes", []))
        qp.reference_genome = doc.get("reference_genome", "")
        vh = doc.get("vcf_header_filename")
        if isinstance(vh, list):
            vh = vh[0] if vh else None
        qp.vcf_header_filename = vh
        qp.scan_full = bool(doc.get("scan_full", False))
        qp.segment_size = int(doc.get("segment_size", qp.segment_size))
        qp.produce_GT_field = bool(doc.get("produce_GT_field", False))
        qp.produce_FILTER_field = bool(doc.get("produce_FILTER_field", False))
        qp.sites_only_query = bool(doc.get("sites_only_query", False))
        qp.produce_GT_with_min_PL_value_for_spanning_deletions = bool(
            doc.get("produce_GT_with_min_PL_value_for_spanning_deletions",
                    False))
        qp.max_diploid_alt_alleles_that_can_be_genotyped = int(
            doc.get("max_diploid_alt_alleles_that_can_be_genotyped", 50))
        qp.vcf_output_format = doc.get("vcf_output_format", "")
        qp.vcf_output_filename = doc.get("vcf_output_filename", "-")
        qp.index_output_VCF = bool(doc.get("index_output_VCF", False))
        return qp

    def resolve(self, path: str) -> str:
        if not path or os.path.isabs(path):
            return path
        return os.path.join(self.base_dir, path) if self.base_dir else path


@dataclass
class ImportParams:
    """Parsed loader JSON."""
    column_partitions: List[dict] = dc_field(default_factory=list)
    callset_mapping_file: str = ""
    vid_mapping_file: str = ""
    size_per_column_partition: int = 0
    treat_deletions_as_intervals: bool = True
    vcf_header_filename: Optional[str] = None
    reference_genome: str = ""
    produce_combined_vcf: bool = False
    produce_tiledb_array: bool = True
    delete_and_create_tiledb_array: bool = False
    compress_tiledb_array: bool = False
    segment_size: int = 10 * 1024 * 1024
    num_cells_per_tile: int = 1000
    row_based_partitioning: bool = False
    fail_if_updating: bool = False
    lb_callset_row_idx: int = 0
    ub_callset_row_idx: int = INT64_MAX - 1
    consolidate_after_load: bool = False
    base_dir: str = ""

    @classmethod
    def from_file(cls, path: str, rank: int = 0) -> "ImportParams":
        with open(path) as f:
            doc = json.load(f)
        ip = cls.from_dict(doc, rank)
        ip.base_dir = os.path.dirname(os.path.abspath(path))
        return ip

    @classmethod
    def from_dict(cls, doc: dict, rank: int = 0) -> "ImportParams":
        ip = cls()
        ip.column_partitions = doc.get("column_partitions", [])
        ip.callset_mapping_file = doc.get("callset_mapping_file", "")
        ip.vid_mapping_file = doc.get("vid_mapping_file", "")
        ip.size_per_column_partition = int(
            doc.get("size_per_column_partition", 0))
        ip.treat_deletions_as_intervals = bool(
            doc.get("treat_deletions_as_intervals", True))
        ip.vcf_header_filename = doc.get("vcf_header_filename")
        ip.reference_genome = doc.get("reference_genome", "")
        ip.produce_combined_vcf = bool(doc.get("produce_combined_vcf", False))
        ip.produce_tiledb_array = bool(doc.get("produce_tiledb_array", True))
        ip.compress_tiledb_array = bool(
            doc.get("compress_tiledb_array", False))
        ip.segment_size = int(doc.get("segment_size", ip.segment_size))
        ip.num_cells_per_tile = int(doc.get("num_cells_per_tile", 1000))
        ip.row_based_partitioning = bool(
            doc.get("row_based_partitioning", False))
        ip.fail_if_updating = bool(doc.get("fail_if_updating", False))
        ip.lb_callset_row_idx = int(doc.get("lb_callset_row_idx", 0))
        ip.ub_callset_row_idx = int(
            doc.get("ub_callset_row_idx", INT64_MAX - 1))
        ip.consolidate_after_load = bool(
            doc.get("consolidate_tiledb_array_after_load", False))
        return ip

    def resolve(self, path: str) -> str:
        if not path or os.path.isabs(path):
            return path
        return os.path.join(self.base_dir, path) if self.base_dir else path

    def partition_bounds(self, rank: int) -> Tuple[int, int]:
        parts = sorted(self.column_partitions,
                       key=lambda p: int(p["begin"]))
        begin = int(parts[rank]["begin"])
        if "end" in parts[rank]:
            end = int(parts[rank]["end"])
        elif rank + 1 < len(parts):
            end = int(parts[rank + 1]["begin"]) - 1
        else:
            end = INT64_MAX - 1
        return begin, end


class QueryConfig:
    """Bookkept query configuration: ordered attribute list with vid info.

    Mirrors VariantQueryConfig after do_query_bookkeeping.
    """

    def __init__(self, vid: VidMapper, params: QueryParams,
                 schema_attributes: List[str]):
        self.vid = vid
        self.params = params
        self.schema_attributes = schema_attributes
        self.attributes: List[str] = []      # ordered query fields
        self.first_normal_field_idx = 0
        self.column_intervals: List[Tuple[int, int]] = []
        self.rows_to_query: List[int] = []
        self._bookkeeping(params)

    # -- reference do_query_bookkeeping (query_variants.cc:578-685) --
    def _bookkeeping(self, params: QueryParams):
        attrs = list(params.attributes)
        # flatten composite fields (variant_query_config.cc:187-240)
        flat: List[str] = []
        for a in attrs:
            info = self.vid.get_field_info(a)
            if info is None:
                raise ValueError(f"Unknown query attribute {a}")
            if info.is_composite():
                flat.append(a)  # removed below, elements appended at end
            else:
                flat.append(a)
        extra: List[str] = []
        for a in attrs:
            info = self.vid.get_field_info(a)
            if info.is_composite():
                for i in range(info.num_elements_in_tuple):
                    extra.append(self.vid.flattened_field_name(a, i))
        attrs = [a for a in flat
                 if not self.vid.get_field_info(a).is_composite()] + extra
        # finalize_queried_attributes (query_variants.cc:244-279)
        if not attrs:
            attrs = list(self.schema_attributes)
        if params.sites_only_query:
            keep = []
            needed = {"DP_FORMAT", "MIN_DP"}
            for a in attrs:
                info = self.vid.get_field_info(a)
                if info.is_format and a not in needed:
                    continue
                keep.append(a)
            attrs = keep
        # drop attributes not in schema? reference throws; keep behavior
        for a in attrs:
            if a not in self.schema_attributes and a != "END":
                raise ValueError(f"Invalid query attribute : {a}")
        # add END
        if "END" not in attrs:
            attrs.append("END")
        # add REF/ALT/GT deps (query_variants.cc:601-634)
        added_ref_alt = "REF" in attrs and "ALT" in attrs
        added_gt = "GT" in attrs
        i = 0
        while i < len(attrs):
            info = self.vid.get_field_info(attrs[i])
            if info is not None:
                if not added_ref_alt and info.length.is_allele_dependent():
                    if "ALT" not in attrs:
                        attrs.append("ALT")
                    if "REF" not in attrs:
                        attrs.append("REF")
                    added_ref_alt = True
                if not added_gt and info.length.is_genotype_dependent():
                    if "GT" not in attrs:
                        attrs.append("GT")
                    added_gt = True
            i += 1
        # reorder: END, REF, ALT first via swap (variant_query_config.cc:161)
        first_normal = 0
        for special in ("END", "REF", "ALT"):
            if special in attrs:
                qidx = attrs.index(special)
                if qidx > first_normal:
                    attrs[first_normal], attrs[qidx] = (attrs[qidx],
                                                        attrs[first_normal])
                first_normal += 1
        self.attributes = attrs
        self.first_normal_field_idx = first_normal
        # column intervals for this rank
        if params.scan_full or not params.column_ranges:
            self.column_intervals = []
        else:
            self.column_intervals = list(params.column_ranges[0])
        # rows
        num_rows = self.vid.max_callset_row_idx() + 1
        if params.row_ranges:
            rows = []
            for lo, hi in params.row_ranges[0]:
                hi = min(hi, num_rows - 1)
                rows.extend(range(lo, hi + 1))
            self.rows_to_query = sorted(set(rows))
        else:
            self.rows_to_query = list(range(num_rows))

    # ---------------- helpers ----------------

    def query_idx(self, name: str) -> Optional[int]:
        try:
            return self.attributes.index(name)
        except ValueError:
            return None

    def field_info(self, name: str):
        # hot in the sequential engine: called per (call, field) access
        cache = self.__dict__.get("_fi_cache")
        if cache is None:
            cache = self._fi_cache = {}
        try:
            return cache[name]
        except KeyError:
            info = cache[name] = self.vid.get_field_info(name)
            return info

    def is_queried(self, name: str) -> bool:
        return name in self.attributes

    @property
    def num_rows_to_query(self) -> int:
        return len(self.rows_to_query)

    @property
    def produce_GT_field(self) -> bool:
        return self.params.produce_GT_field

    @property
    def sites_only_query(self) -> bool:
        return self.params.sites_only_query
