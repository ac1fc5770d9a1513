"""Host-side audits of the port (mirrors part of ``accelerate_tpu/analysis/``):
:mod:`.distributed_audit` derives and compares the disaggregated pair's
wire schemas."""

from .distributed_audit import check_wire_schemas, pair_preflight, wire_schema

__all__ = ["check_wire_schemas", "pair_preflight", "wire_schema"]
