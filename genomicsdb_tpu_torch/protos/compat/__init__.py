"""The reference's wire-compatible protobuf schemas (`core/pb_compat`)."""
