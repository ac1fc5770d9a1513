"""The two-process disaggregated serving fabric (mirrors
``accelerate_tpu/test_utils/scripts/fleet_fabric.py``).

A gang worker (``test_utils/gang.run_gang``, a gloo world of 2
processes).  Rank 0 runs a **prefill-role** engine
(``hold_finished=True``), rank 1 a **decode-role** engine with n-gram
speculation armed (k 2).  The roles keep JAX's independent geometries
(:func:`plugins`: slots, pages, prefill chunk and buckets differ); page
geometry and ``kv_dtype`` are wire-schema fields, and the shared gate
(``analysis.wire_schema`` / ``check_wire_schemas``) runs on both ranks
before anything allocates.

For each request rank 0 broadcasts a fixed int64 header ``[uid,
prompt_len, first, n_pages]``, then the ``pps``-wide payload
(``PagedKVTransport.send(slot, None)``: codes plus their per-(kv head,
page) scales for a quantized pool) leaf by leaf in sorted wire-name order,
each leaf as its raw bytes (``ops.operations.broadcast_raw``: gloo has no
fp8 lane, and a card tensor crosses through host memory).  Rank 1 adopts
the request (``adopt_prefilled``) and scatters the pages (``recv``), then
decodes.  On the card the two processes share one GPU over a gloo-only
wire: no NCCL collective runs on this path, barriers included.

The pins (JAX's, less ``strict_compiles`` and the prewarm packs: eager
PyTorch compiles nothing):

- rank 1's tokens equal a fused serve of the same trace with the decode
  plugin in rank 1 (bitwise, or the caller's ``judge``);
- bytes sent = bytes received = ``transfer_accounting``'s
  ``page_transfer_bytes``, exactly (every request ships once: at least 2
  new tokens, no EOS);
- rank 1's verdict comes back to rank 0 as one fixed int64 tensor;
- rank 0 runs the ``FleetRouter`` smoke after the rounds: 2 replicas,
  prefix cache on, goodput 1.0, ``routed_by_prefix > 0``.

Run it as ``run_gang("accelerate_tpu_torch.test_utils.scripts.
fleet_fabric:fabric", 2, gang_dir, state=..., kv_dtype="int8")``; JAX's
environment contract (``FLEET_LEG_REQUESTS``, ``_SEED``, ``_KV_DTYPE``)
is the keyword arguments ``requests``, ``seed`` and ``kv_dtype``.
"""

from __future__ import annotations

import dataclasses as dc
import time
from typing import Callable, Optional

import torch

HEADER = 4
# verdict: [parity, bytes received, requests completed, payload bytes on the wire]
VERDICT = 4


def plugins(kv_dtype: str, page_size: int = 4, pages_per_slot: int = 8):
    """JAX ``_plugins``: the two roles' geometries.  Only slots, pages,
    chunk and buckets differ; ``page_size``, ``pages_per_slot`` and
    ``kv_dtype`` are wire-schema fields."""
    from ...utils.dataclasses import ServingPlugin

    shared = dict(page_size=page_size, pages_per_slot=pages_per_slot, kv_dtype=kv_dtype,
                  decode_kernel="native", default_deadline_ticks=0)
    prefill = ServingPlugin(num_slots=2, num_pages=20, prefill_chunk=8, prefill_buckets=(4, 8),
                            speculate="off", **shared)
    decode = ServingPlugin(num_slots=8, num_pages=64, prefill_chunk=4, prefill_buckets=(4,),
                           speculate="ngram", speculate_k=2, **shared)
    return prefill, decode


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def serve_fabric(rank: int, model, prefill_plugin, decode_plugin, gen_config, trace: list, *,
                 device="cpu", on_tick: Optional[Callable] = None,
                 on_phase: Optional[Callable] = None,
                 judge: Optional[Callable] = None) -> dict:
    """The fabric's rounds on this rank (see the module doc).  ``on_tick(
    engine)`` runs after every engine tick of either role; ``on_phase(name,
    engine)`` once the role's engine is warm (``"warm"``) and once its
    rounds are done (``"rounds"``), before the oracle and the router smoke;
    ``judge(got, fused)`` (rank 1) says whether the decode role's tokens
    pass against the fused serve's (default: equal).  Rank 0 returns its
    report with rank 1's verdict; rank 1 its tokens, the fused serve's and
    its timings."""
    from ...analysis.distributed_audit import check_wire_schemas, wire_schema
    from ...ops import operations as ops
    from ...serving import PagedKVTransport, ServingEngine, pages_for, transfer_accounting

    cfg = model.config
    role = "prefill" if rank == 0 else "decode"
    # the shared gate, on both ranks before anything allocates: a schema
    # mismatch must stop the gang, not corrupt a pool
    schema = wire_schema(cfg, prefill_plugin)
    check_wire_schemas(schema, wire_schema(cfg, decode_plugin))
    n = len(trace)
    originals = {r.uid: r for r in trace}
    page_bytes = schema["page_bytes"]
    dtype_bytes = torch.empty((), dtype=cfg.dtype).element_size()
    bytes_pred = transfer_accounting(cfg, trace, prefill_plugin.page_size,
                                     dtype_bytes=dtype_bytes,
                                     kv_dtype=schema["kv_dtype"] if schema["kv_dtype"] != "bf16"
                                     else "")["page_transfer_bytes"]
    # one broadcast per payload leaf, in sorted-name order on both ranks:
    # gloo pairs collectives by issue order
    wire_names = sorted(schema["payload"])
    templates = {name: torch.empty(shape, dtype=getattr(torch, dtype), device=device)
                 for name, (shape, dtype) in schema["payload"].items()}
    header = torch.zeros(HEADER, dtype=torch.int64)
    wire_s, wire_bytes = [], 0
    ticks = 0

    def tick(eng):
        nonlocal ticks
        eng.step()
        ticks += 1
        if on_tick is not None:
            on_tick(eng)

    if rank == 0:
        eng = ServingEngine(model, prefill_plugin, gen_config, device=device, hold_finished=True)
        eng.warmup()
        if on_phase is not None:
            on_phase("warm", eng)
        wire = PagedKVTransport(eng, eng)   # this process holds the send side only
        t0 = time.perf_counter()
        for r in trace:
            eng.add_request(dc.replace(r, max_new_tokens=1))
        sent = bytes_sent = 0
        first_token_s = {}
        while sent < n:
            if not eng.held:
                tick(eng)
                continue
            slot = eng.held[0]
            req = eng.sched.slots[slot].request
            first = eng.results[req.uid][0]
            first_token_s[req.uid] = time.perf_counter() - t0
            n_pages = int(pages_for(req.prompt_len, prefill_plugin.page_size))
            t_wire = time.perf_counter()
            ops.broadcast(torch.tensor([req.uid, req.prompt_len, first, n_pages],
                                       dtype=torch.int64))
            payload = wire.send(slot, None)
            for name in wire_names:
                ops.broadcast_raw(payload[name])
                wire_bytes += payload[name].numel() * payload[name].element_size()
            wire_s.append(time.perf_counter() - t_wire)
            eng.release_held(slot)
            bytes_sent += n_pages * page_bytes
            sent += 1
        _sync(device)
        serve_s = time.perf_counter() - t0
        if on_phase is not None:
            on_phase("rounds", eng)
        out = {"role": role, "requests": n, "kv_dtype": schema["kv_dtype"],
               "bytes_pred": bytes_pred, "bytes_sent": bytes_sent, "bytes_per_page": page_bytes,
               "wire_bytes": wire_bytes, "wire_s": wire_s, "serve_s": serve_s,
               "first_token_s": first_token_s, "ticks": ticks, "metrics": dict(eng.metrics)}
        out["fleet"] = fleet_smoke(model, gen_config, device=device)
        # rank 1's verdict: one fixed int64 tensor
        verdict = ops.broadcast(torch.zeros(VERDICT, dtype=torch.int64), from_process=1)
        out.update(zip(("parity", "bytes_recv", "completed", "wire_bytes_recv"),
                       (int(x) for x in verdict)))
        out["parity"] = bool(out["parity"])
        return out

    eng = ServingEngine(model, decode_plugin, gen_config, device=device)
    eng.warmup()
    if on_phase is not None:
        on_phase("warm", eng)
    wire = PagedKVTransport(eng, eng)   # this process holds the receive side only
    bytes_recv = 0
    t_recv = None
    for _ in range(n):
        uid, plen, first, n_pages = (int(x) for x in ops.broadcast(header))
        t_wire = time.perf_counter()
        t_recv = t_recv if t_recv is not None else t_wire
        payload = {name: ops.broadcast_raw(templates[name]) for name in wire_names}
        slot = eng.adopt_prefilled(originals[uid], first)
        wire.recv(slot, payload, n_pages, plen)
        _sync(device)
        wire_s.append(time.perf_counter() - t_wire)
        wire_bytes += sum(p.numel() * p.element_size() for p in payload.values())
        bytes_recv += n_pages * page_bytes
        del payload
    t_decode = time.perf_counter()
    while not eng.idle():
        tick(eng)
    _sync(device)
    decode_s = time.perf_counter() - t_decode
    if on_phase is not None:
        on_phase("rounds", eng)
    got = {uid: list(toks) for uid, toks in eng.results.items()}
    # the oracle: a fused serve of the same trace with the decode plugin, in
    # this process: attention over the received bytes must be the same as
    # over pages this engine prefilled itself
    fused = ServingEngine(model, decode_plugin, gen_config, device=device)
    fused.warmup()
    fused_results = fused.run([dc.replace(r) for r in trace])
    parity = (judge(got, fused_results) if judge is not None else got == fused_results)
    ops.broadcast(torch.tensor([int(bool(parity)), bytes_recv, len(got), wire_bytes],
                               dtype=torch.int64), from_process=1)
    return {"role": role, "results": got, "fused": fused_results, "parity": bool(parity),
            "bytes_recv": bytes_recv, "bytes_pred": bytes_pred, "wire_bytes": wire_bytes,
            "wire_s": wire_s, "recv_s": t_decode - t_recv, "decode_s": decode_s, "ticks": ticks,
            "tokens": sum(len(t) for t in got.values()), "metrics": dict(eng.metrics)}


def fleet_smoke(model, gen_config, *, device="cpu", seed: int = 24) -> dict:
    """JAX's router smoke: 2 in-process replicas behind the prefix-affinity
    router serve a shared-preamble trace at goodput 1.0 with
    prefix-routed placements (JAX's geometry: pages of 4 tokens, so the
    4-12 token prompts' shared preambles fill whole pages)."""
    from ...serving import FleetRouter, ServingEngine, fleet_replay, synthesize_trace
    from ...utils.dataclasses import ServingPlugin

    fp = ServingPlugin(num_slots=4, page_size=4, pages_per_slot=8, num_pages=24,
                       prefill_chunk=8, prefill_buckets=(4, 8), decode_kernel="native",
                       prefix_cache="on", default_deadline_ticks=0)
    trace = synthesize_trace(seed, 8, prefix_share=0.9, shared_prefixes=2,
                             prompt_len_range=(4, 12), new_tokens_range=(2, 6))
    router = FleetRouter([ServingEngine(model, fp, gen_config, device=device),
                          ServingEngine(model, fp, gen_config, device=device)])
    rep = fleet_replay(router, trace)
    return {k: rep[k] for k in ("replicas", "goodput_frac", "routed_by_prefix",
                                "prefix_hit_rate", "completed")}


def fabric_trace(seed: int, n: int):
    """JAX's fabric trace: every request arrives at once, no deadline, 2-6
    new tokens, prompts of 4-12."""
    from ...serving import synthesize_trace

    return [dc.replace(r, arrival_step=0, deadline_ticks=0)
            for r in synthesize_trace(seed, n, prompt_len_range=(4, 12), new_tokens_range=(2, 6))]


def _tiny(state: dict, device: str):
    from ...models.llama import LlamaConfig, LlamaForCausalLM

    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32), device=device)
    model.load_state_dict(state)
    return model


def fabric(rank: int, world: int, state: dict, requests: int = 6, seed: int = 23,
           kv_dtype: str = "int8", device: str = "cpu") -> dict:
    """The gang entry point: the tiny f32 Llama with ``state``'s weights (a
    state dict, e.g. ``torch_state_from_flax`` of the JAX model's), JAX's
    trace and plugins, 6 new tokens at most."""
    from ...generation import GenerationConfig

    if world != 2:
        raise ValueError(f"the fabric is a 2-process pair, got {world}")
    prefill, decode = plugins(kv_dtype)
    gen = GenerationConfig(max_new_tokens=6, eos_token_id=None)
    return serve_fabric(rank, _tiny(state, device), prefill, decode, gen,
                        fabric_trace(seed, requests), device=device)


def schema_gate(rank: int, world: int, state: dict, decode_overrides: dict,
                kv_dtype: str = "int8") -> dict:
    """The fabric with the decode plugin changed by ``decode_overrides`` on
    both ranks: what it raises, and how many engines were built first."""
    from ...generation import GenerationConfig
    from ...serving import engine as engine_mod

    built = []
    init = engine_mod.ServingEngine.__init__

    def counting(self, *a, **k):
        built.append(1)
        init(self, *a, **k)

    engine_mod.ServingEngine.__init__ = counting
    prefill, decode = plugins(kv_dtype)
    try:
        serve_fabric(rank, _tiny(state, "cpu"), prefill, dc.replace(decode, **decode_overrides),
                     GenerationConfig(max_new_tokens=6, eos_token_id=None), fabric_trace(23, 2))
        error = ""
    except ValueError as e:
        error = str(e)
    finally:
        engine_mod.ServingEngine.__init__ = init
    return {"error": error, "engines_built": len(built)}
