"""Wire-compatible protobuf plane (reference schemas).

Parses the reference's binary protobuf configurations —
ExportConfiguration / ImportConfiguration / VidMappingPB /
CallsetMappingPB (src/resources/*.proto; built by GATK4's
GenomicsDBImport/SelectVariants path) — into this engine's
QueryParams / ImportParams / VidMapper.  Field numbers and names in
genomicsdb_tpu_torch/protos/compat/*.proto match the reference, so configs
serialized for GenomicsDB parse here unchanged.
"""

from __future__ import annotations

from typing import Optional, Tuple

_mods = None

_PROTOS = ["genomicsdb_coordinates", "genomicsdb_vid_mapping",
           "genomicsdb_callsets_mapping", "genomicsdb_export_config",
           "genomicsdb_import_config"]


def compat_pb2():
    """Lazily protoc-compile + import the compat bindings
    (`protos.bindings`: the port's own modules, by qualified name);
    returns a dict of module name -> module."""
    global _mods
    if _mods is None:
        from ..protos import bindings
        _mods = bindings("compat", _PROTOS)
    return _mods


def vid_mapper_from_pb(vid_pb, callset_pb=None):
    """VidMappingPB (+ CallsetMappingPB) -> VidMapper, through the same
    dict plane the JSON loader uses (vid_mapper_pb.cc equivalent)."""
    from .vid import VidMapper
    fields = {}
    for f in vid_pb.fields:
        spec: dict = {}
        types = list(f.type)
        if types:
            spec["type"] = types if len(types) > 1 else types[0]
        if f.vcf_field_class:
            spec["vcf_field_class"] = list(f.vcf_field_class)
        if f.HasField("vcf_type"):
            spec["vcf_type"] = f.vcf_type
        if f.length:
            dims = []
            for comp in f.length:
                if comp.HasField("fixed_length"):
                    dims.append(int(comp.fixed_length))
                else:
                    dims.append(comp.variable_length_descriptor)
            spec["length"] = dims if len(dims) > 1 else dims[0]
        if f.vcf_delimiter:
            spec["vcf_delimiter"] = list(f.vcf_delimiter)
        if f.HasField("VCF_field_combine_operation"):
            spec["VCF_field_combine_operation"] = \
                f.VCF_field_combine_operation
        fields[f.name] = spec
    contigs = {c.name: {"length": c.length,
                        "tiledb_column_offset": c.tiledb_column_offset}
               for c in vid_pb.contigs}
    vm = VidMapper()
    vm.parse_vid({"fields": fields, "contigs": contigs})
    if callset_pb is not None:
        callsets = {}
        for cs in callset_pb.callsets:
            entry = {"row_idx": cs.row_idx,
                     "idx_in_file": cs.idx_in_file}
            if cs.HasField("stream_name"):
                entry["stream_name"] = cs.stream_name
                entry["filename"] = cs.stream_name
            callsets[cs.sample_name] = entry
        vm.parse_callsets({"callsets": callsets})
    return vm


def _column_value(col, vid) -> int:
    if col.HasField("tiledb_column"):
        return int(col.tiledb_column)
    cp = col.contig_position   # 1-based genomic position
    return vid.flatten_position(cp.contig, cp.position) \
        if vid is not None else int(cp.position)


def _interval_value(civ, vid) -> Tuple[int, int]:
    if civ.HasField("column_interval"):
        return (int(civ.column_interval.begin),
                int(civ.column_interval.end))
    ci = civ.contig_interval
    if vid is None:
        return (int(ci.begin), int(ci.end))
    return (vid.flatten_position(ci.contig, ci.begin),
            vid.flatten_position(ci.contig, ci.end))


def export_config_to_query(data) -> Tuple["object", Optional["object"]]:
    """ExportConfiguration bytes/message -> (QueryParams, VidMapper|None).

    The VidMapper is returned when the config carries inline
    vid_mapping / callset_mapping PBs; with file paths, the caller loads
    them via VidMapper.from_files as in the JSON plane."""
    from .config import QueryParams
    mods = compat_pb2()
    if isinstance(data, (bytes, bytearray)):
        pb = mods["genomicsdb_export_config"].ExportConfiguration()
        pb.ParseFromString(bytes(data))
    else:
        pb = data
    vid = None
    if pb.HasField("vid_mapping"):
        cs = pb.callset_mapping if pb.HasField("callset_mapping") else None
        vid = vid_mapper_from_pb(pb.vid_mapping, cs)
    qp = QueryParams()
    qp.workspace = pb.workspace
    if pb.HasField("array_name"):
        qp.array_name = pb.array_name
    qp.reference_genome = pb.reference_genome
    qp.attributes = list(pb.attributes)
    if pb.HasField("vcf_header_filename"):
        qp.vcf_header_filename = pb.vcf_header_filename
    if pb.HasField("vcf_output_filename"):
        qp.vcf_output_filename = pb.vcf_output_filename
    if pb.HasField("vcf_output_format"):
        qp.vcf_output_format = pb.vcf_output_format
    if pb.HasField("vid_mapping_file"):
        qp.vid_mapping_file = pb.vid_mapping_file
    if pb.HasField("callset_mapping_file"):
        qp.callset_mapping_file = pb.callset_mapping_file
    qp.produce_GT_field = pb.produce_GT_field
    qp.produce_FILTER_field = pb.produce_FILTER_field
    qp.sites_only_query = pb.sites_only_query
    qp.produce_GT_with_min_PL_value_for_spanning_deletions = \
        pb.produce_GT_with_min_PL_value_for_spanning_deletions
    if pb.HasField("max_diploid_alt_alleles_that_can_be_genotyped"):
        qp.max_diploid_alt_alleles_that_can_be_genotyped = \
            pb.max_diploid_alt_alleles_that_can_be_genotyped
    qp.scan_full = pb.scan_full
    ranges = []
    for rank_list in pb.query_column_ranges:
        rank_ranges = []
        for coi in rank_list.column_or_interval_list:
            if coi.HasField("column"):
                v = _column_value(coi.column, vid)
                rank_ranges.append((v, v))
            else:
                rank_ranges.append(_interval_value(coi.column_interval,
                                                   vid))
        ranges.append(rank_ranges)
    if ranges:
        qp.column_ranges = ranges
    if pb.query_row_ranges:
        qp.row_ranges = [[(r.low, r.high) for r in rl.range_list]
                         for rl in pb.query_row_ranges]
    return qp, vid


def import_config_to_import(data) -> Tuple["object", Optional["object"]]:
    """ImportConfiguration bytes/message -> (ImportParams, VidMapper|None)."""
    from .config import ImportParams
    mods = compat_pb2()
    if isinstance(data, (bytes, bytearray)):
        pb = mods["genomicsdb_import_config"].ImportConfiguration()
        pb.ParseFromString(bytes(data))
    else:
        pb = data
    vid = None
    if pb.HasField("vid_mapping"):
        cs = pb.callset_mapping if pb.HasField("callset_mapping") else None
        vid = vid_mapper_from_pb(pb.vid_mapping, cs)
    doc: dict = {
        "row_based_partitioning": pb.row_based_partitioning,
        "produce_combined_vcf": pb.produce_combined_vcf,
        "produce_tiledb_array": pb.produce_tiledb_array,
        "treat_deletions_as_intervals": pb.treat_deletions_as_intervals,
        "delete_and_create_tiledb_array":
            pb.delete_and_create_tiledb_array,
        "segment_size": pb.segment_size,
        "fail_if_updating": pb.fail_if_updating,
        "consolidate_tiledb_array_after_load":
            pb.consolidate_tiledb_array_after_load,
        "lb_callset_row_idx": pb.lb_callset_row_idx,
    }
    if pb.HasField("ub_callset_row_idx"):
        doc["ub_callset_row_idx"] = pb.ub_callset_row_idx
    if pb.HasField("vid_mapping_file"):
        doc["vid_mapping_file"] = pb.vid_mapping_file
    if pb.HasField("callset_mapping_file"):
        doc["callset_mapping_file"] = pb.callset_mapping_file
    parts = []
    for p in pb.column_partitions:
        entry = {"begin": _column_value(p.begin, vid)}
        if p.HasField("workspace"):
            entry["workspace"] = p.workspace
        if p.HasField("array_name"):
            entry["array_name"] = p.array_name
        if p.HasField("end"):
            entry["end"] = _column_value(p.end, vid)
        if p.HasField("vcf_output_filename"):
            entry["vcf_output_filename"] = p.vcf_output_filename
        parts.append(entry)
    if parts:
        doc["column_partitions"] = parts
    ip = ImportParams.from_dict(doc, 0)
    return ip, vid
