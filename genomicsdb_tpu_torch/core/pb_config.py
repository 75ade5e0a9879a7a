"""Protobuf config plane: QuerySpec / ImportSpec / VidSpec / CallsetMap.

The programmatic (GATK-integration-style) configuration surface.  Protos
live in genomicsdb_tpu_torch/protos/; generated bindings are compiled on
demand with protoc (`protos.bindings`).  Converts PB messages into the same
VidMapper / QueryParams / ImportParams objects the JSON plane produces.
"""

from __future__ import annotations

_pb2 = None


def pb2():
    """Lazily compile + import the generated bindings
    (`protos.bindings`: the port's own module, by qualified name)."""
    global _pb2
    if _pb2 is None:
        from ..protos import bindings
        _pb2 = bindings("", ["genomicsdb_tpu_config"])[
            "genomicsdb_tpu_config"]
    return _pb2


def vid_from_pb(vid_spec, callset_map=None):
    """VidSpec (+ CallsetMap) -> VidMapper."""
    from .vid import VidMapper
    vm = VidMapper()
    fields = {}
    for f in vid_spec.fields:
        spec = {}
        if f.field_classes:
            spec["vcf_field_class"] = list(f.field_classes)
        ets = list(f.element_types) or ["int"]
        spec["type"] = ets if len(ets) > 1 else ets[0]
        if f.length_descriptors:
            dims = []
            for i, code in enumerate(f.length_descriptors):
                if code == "FIXED":
                    n = f.fixed_lengths[i] if i < len(f.fixed_lengths) else 1
                    dims.append(int(n))
                else:
                    dims.append(code)
            spec["length"] = dims if len(dims) > 1 else dims[0]
        if f.combine_operation:
            spec["VCF_field_combine_operation"] = f.combine_operation
        if f.vcf_delimiters:
            spec["vcf_delimiter"] = list(f.vcf_delimiters)
        if f.vcf_type:
            spec["vcf_type"] = f.vcf_type
        fields[f.name] = spec
    contigs = {c.name: {"length": c.length,
                        "tiledb_column_offset": c.column_offset}
               for c in vid_spec.contigs}
    vm.parse_vid({"fields": fields, "contigs": contigs})
    if callset_map is not None:
        callsets = {}
        for cs in callset_map.callsets:
            callsets[cs.sample_name] = {
                "row_idx": cs.row, "idx_in_file": cs.index_in_file,
                "filename": cs.filename or cs.stream_name,
            }
            if cs.stream_name:
                callsets[cs.sample_name]["stream_name"] = cs.stream_name
        vm.parse_callsets({"callsets": callsets})
    return vm


def query_params_from_pb(qspec, vid=None):
    """QuerySpec -> QueryParams (contig intervals resolved via the vid)."""
    from .config import QueryParams
    qp = QueryParams()
    qp.workspace = qspec.workspace
    qp.array_name = qspec.array_name
    qp.attributes = list(qspec.attributes)
    qp.reference_genome = qspec.reference_genome
    qp.vcf_header_filename = qspec.vcf_header_template or None
    qp.produce_GT_field = qspec.produce_GT_field
    qp.produce_FILTER_field = qspec.produce_FILTER_field
    qp.sites_only_query = qspec.sites_only_query
    qp.produce_GT_with_min_PL_value_for_spanning_deletions = \
        qspec.produce_GT_with_min_PL_value_for_spanning_deletions
    if qspec.max_diploid_alt_alleles_that_can_be_genotyped:
        qp.max_diploid_alt_alleles_that_can_be_genotyped = \
            qspec.max_diploid_alt_alleles_that_can_be_genotyped
    if qspec.segment_size:
        qp.segment_size = qspec.segment_size
    intervals = [(iv.begin, iv.end) for iv in qspec.column_intervals]
    if vid is not None:
        for ci in qspec.contig_intervals:
            lo = vid.flatten_position(ci.contig, ci.begin or 1)
            hi = vid.flatten_position(
                ci.contig, ci.end or vid.contigs[ci.contig].length)
            intervals.append((lo, hi))
    if intervals:
        qp.column_ranges = [intervals]
    if qspec.row_ranges:
        qp.row_ranges = [[(r.low, r.high) for r in qspec.row_ranges]]
    return qp


def vid_to_pb(vid) -> "object":
    """VidMapper -> VidSpec (for config export)."""
    mod = pb2()
    spec = mod.VidSpec()
    for name, c in vid.contigs.items():
        spec.contigs.add(name=name, length=c.length,
                         column_offset=c.offset)
    for name in vid.field_order:
        info = vid.fields[name]
        if info.is_flattened or name.endswith("_FORMAT"):
            continue  # flattening is re-derived on load
        f = spec.fields.add(name=name)
        if info.is_info:
            f.field_classes.append("INFO")
        if info.is_format or name == "DP":
            if "FORMAT" not in f.field_classes and (
                    info.is_format
                    or (name + "_FORMAT") in vid.fields):
                f.field_classes.append("FORMAT")
        if info.is_filter:
            f.field_classes.append("FILTER")
        f.element_types.extend(info.element_types)
        for code, n in info.length.dims:
            f.length_descriptors.append(code)
            f.fixed_lengths.append(n)
        if info.combine_op:
            f.combine_operation = info.combine_op
        if info.length.vcf_delimiters:
            f.vcf_delimiters.extend(info.length.vcf_delimiters)
        if info.vcf_type:
            f.vcf_type = info.vcf_type
    return spec
