"""The wire schema of the disaggregated prefill -> decode handoff (mirrors
the host part of ``accelerate_tpu/analysis/distributed_audit.py``:
``wire_schema`` :338, ``check_wire_schemas`` :428, ``pair_preflight``
:572).

:func:`wire_schema` derives, from a role's plugin and model config alone,
what the :class:`~accelerate_tpu_torch.serving.PagedKVTransport` puts on
the wire: page geometry, the pool's encoding (bf16 pages, or int8 / e4m3
codes with their f32 scales), the payload's shapes and dtypes and the
bytes a page costs.  Dtypes are named as the JAX package names them
(``"bfloat16"``, ``"int8"``, ``"float8_e4m3fn"``), so a schema compares
equal across the two frameworks.  Two roles with equal schemas read each
other's payloads bit for bit; the transport refuses a pair whose schemas
differ (:func:`check_wire_schemas`) and :func:`pair_preflight` reports
the same comparison before anything is allocated.

The JAX preflight's trace audits (GL401 collective schedules, GL402
resharding, GL404 warmup coverage) read jaxprs and compiled programs;
their counterparts wait for ROADMAP item A14, and the summary says they
did not run.
"""

from __future__ import annotations

import dataclasses

import torch

# torch dtype -> the name JAX's ``str(jnp.dtype(...))`` gives it
_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float16: "float16",
                torch.float32: "float32", torch.int8: "int8",
                torch.float8_e4m3fn: "float8_e4m3fn"}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One preflight finding: its rule id and what is wrong."""

    rule: str
    message: str


def wire_schema(model_config, plugin) -> dict:
    """The static schema of one role's side of the handoff: nothing is
    allocated.  Two roles with equal schemas parse each other's payloads
    exactly; any differing field would corrupt the decode side's pool."""
    from ..models.llama import KV_QUANT_DTYPES
    from ..serving.paged_cache import kv_page_bytes

    kvd = getattr(plugin, "kv_dtype", "") or "bf16"
    kvd = kvd if kvd in ("int8", "fp8") else "bf16"
    quantized = kvd != "bf16"
    cfg = model_config
    L, hkv, d = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    ps, pps = plugin.page_size, plugin.pages_per_slot
    page_dtype = _DTYPE_NAMES[KV_QUANT_DTYPES[kvd] if quantized else cfg.dtype]
    payload = {"k": ((L, hkv, pps, ps, d), page_dtype),
               "v": ((L, hkv, pps, ps, d), page_dtype)}
    if quantized:
        payload["k_scales"] = ((L, hkv, pps), "float32")
        payload["v_scales"] = ((L, hkv, pps), "float32")
    return {
        "page_size": ps,
        "pages_per_slot": pps,
        "kv_dtype": kvd,
        "page_dtype": page_dtype,
        "layers": L,
        "kv_heads": hkv,
        "head_dim": d,
        "payload": payload,
        "page_bytes": kv_page_bytes(cfg, ps, torch.empty((), dtype=cfg.dtype).element_size(),
                                    kvd if quantized else ""),
        # conventions that must agree for adopted pages to keep their
        # meaning across the pair
        "prefix_cache": getattr(plugin, "prefix_cache", "off"),
        "adapters": bool(getattr(plugin, "lora", None)),
    }


def schema_mismatches(src_schema: dict, dst_schema: dict) -> list:
    """``[(field, src_value, dst_value), ...]`` for every differing field."""
    keys = sorted(set(src_schema) | set(dst_schema))
    return [(k, src_schema.get(k), dst_schema.get(k)) for k in keys
            if src_schema.get(k) != dst_schema.get(k)]


def check_wire_schemas(src_schema: dict, dst_schema: dict) -> None:
    """Raise ``ValueError`` on any schema mismatch (the transport calls this
    at construction), geometry and page encoding named first."""
    geom_src = (src_schema["page_size"], src_schema["pages_per_slot"])
    geom_dst = (dst_schema["page_size"], dst_schema["pages_per_slot"])
    if geom_src != geom_dst:
        raise ValueError("prefill/decode page geometry must match for the in-process "
                         f"handoff: src={geom_src} vs dst={geom_dst}")
    if src_schema["kv_dtype"] != dst_schema["kv_dtype"]:
        raise ValueError(
            "prefill/decode KV page dtypes must match for the handoff (the wire payload "
            f"is the raw page codes + scales): src={src_schema['kv_dtype']!r} vs "
            f"dst={dst_schema['kv_dtype']!r}")
    diffs = schema_mismatches(src_schema, dst_schema)
    if diffs:
        raise ValueError("prefill/decode wire schemas must match for the handoff: "
                         + "; ".join(f"{f}: src={sv!r} vs dst={dv!r}" for f, sv, dv in diffs))


def pair_preflight(model_config, prefill_plugin, decode_plugin, *,
                   adapters: bool = False) -> tuple:
    """The host part of the pair preflight: the two roles' schemas compared
    (GL403: one finding listing every mismatched field) and, when they
    agree, the predicted side of the ``distributed.wire_bytes_per_page``
    twin recorded.  Returns ``(findings, summary)``; the summary lists the
    trace audits that did not run."""
    from ..telemetry import twin_registry

    schema_src = wire_schema(model_config, prefill_plugin)
    schema_dst = wire_schema(model_config, decode_plugin)
    diffs = schema_mismatches(schema_src, schema_dst)
    findings = []
    if diffs:
        detail = "; ".join(f"{f}: prefill={sv!r} vs decode={dv!r}" for f, sv, dv in diffs)
        findings.append(Finding("GL403", "wire schema of the prefill-role engine is "
                                f"incompatible with the decode-role engine ({detail})"))
    else:
        twin_registry().record_predicted(
            "distributed.wire_bytes_per_page", schema_src["page_bytes"],
            source="analysis/distributed_audit.pair_preflight")
    summary = {
        "roles": {role: {"page_bytes": schema["page_bytes"]}
                  for role, schema in (("prefill", schema_src), ("decode", schema_dst))},
        "schema_ok": not diffs,
        "kv_dtype": schema_dst["kv_dtype"],
        "adapters": adapters,
        "not_run": ["GL401", "GL402", "GL404"],
        "rules": sorted({f.rule for f in findings}),
        "findings": len(findings),
    }
    return findings, summary


__all__ = ["Finding", "check_wire_schemas", "pair_preflight", "schema_mismatches",
           "wire_schema"]
