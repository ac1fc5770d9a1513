#!/usr/bin/env python3
"""Where an engine tick's time goes, on one GPU.

Run from the root of a checkout:  python3 profile_serving.py

Serves ``chip_smoke.py``'s 16-request trace on the 600m Llama (random
weights from seed 0); with ``--quantized``, with int8 weights
(``quantize_model_``) from int8 KV pages, as ``chip_smoke.py``'s quantized
serve; with ``--adapters``, the 8-tenant trace through a pool of 4 rank-16
LoRA adapters on q_proj and v_proj, as ``chip_smoke.py``'s LoRA serve;
with ``--speculate K``, speculatively (prompt lookup, ``K`` drafts: every
decode tick is a verify pass of ``K + 1`` lanes).
After ``--skip`` ticks, the next ``--window`` ticks run under
``torch.profiler``, each closed by a device sync.  Prints the card's name
and power limit, then one JSON line: the host wall per tick kind, the
device's busy share of the window (the union of its kernels' intervals),
device time in all and by kernel (with each kernel's launches), and the
host ops of most self time.  The profiler slows the host, so the busy
share is a lower bound on the unprofiled one.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

from chip_smoke import (
    LORA, LORA_TENANTS, MAX_NEW, MODEL, N_REQUESTS, PLUGIN, QUANT_KV, ROOT, TRACE, card_line,
    log, lora_store,
)


def profile_ticks(torch, model, card: str, skip: int, window: int, kv_dtype: str = "bf16",
                  adapters=None, speculate: int = 0) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from accelerate_tpu_torch import (
        GenerationConfig, ServingEngine, ServingPlugin, synthesize_trace,
    )

    on_card = model.device.type == "cuda"
    knobs = dict(speculate="ngram", speculate_k=speculate) if speculate else {}
    engine = ServingEngine(model, ServingPlugin(**PLUGIN, kv_dtype=kv_dtype, **knobs),
                           GenerationConfig(max_new_tokens=MAX_NEW), device=model.device,
                           adapters=adapters)
    engine.warmup()
    tenants = LORA_TENANTS if adapters is not None else 0
    pending = sorted(synthesize_trace(0, N_REQUESTS, **TRACE, adapters=tenants),
                     key=lambda r: (r.arrival_step, r.uid))

    def tick():
        while pending and pending[0].arrival_step <= engine.steps:
            engine.add_request(pending.pop(0))
        t0 = time.perf_counter()
        kind = engine.step()["type"]
        if on_card:
            torch.cuda.synchronize()
        return kind, time.perf_counter() - t0

    for _ in range(skip):
        tick()
    walls: dict = {}
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(window):
            kind, dt = tick()
            walls.setdefault(kind, []).append(dt)
        window_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end, by_name, count = 0.0, -math.inf, {}, {}
    for start, stop, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (stop - start) / 1e3
        count[name] = count.get(name, 0) + 1
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    host_ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:12]
    return {"card": card, "kv_dtype": kv_dtype, **knobs,
            "lora": None if adapters is None else {**LORA, "targets": list(LORA["targets"]),
                                                   "tenants": tenants},
            "ticks": window, "window_ms": window_ms,
            "host_ms_per_tick": {k: 1e3 * sum(v) / len(v) for k, v in walls.items()},
            "ticks_by_kind": {k: len(v) for k, v in walls.items()},
            "device_busy_share": busy_us / 1e3 / window_ms if spans else None,
            "device_ms": sum(by_name.values()) if spans else None,
            "kernels_launched": len(spans),
            "top_kernels_ms": [{"name": n[:90], "ms": ms, "launches": count[n]}
                               for n, ms in top],
            "top_host_ops_self_ms": [{"name": e.key[:60], "calls": e.count,
                                      "ms": e.self_cpu_time_total / 1e3} for e in host_ops]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--skip", type=int, default=40, help="ticks served before the window")
    parser.add_argument("--window", type=int, default=40, help="ticks under the profiler")
    parser.add_argument("--quantized", action="store_true",
                        help="int8 weights and int8 KV pages (chip_smoke's quantized serve)")
    parser.add_argument("--adapters", action="store_true",
                        help="8 tenants' LoRA adapters through a pool of 4 (chip_smoke's LoRA "
                             "serve)")
    parser.add_argument("--speculate", type=int, default=0, metavar="K",
                        help="speculative decode, prompt lookup with K drafts a verify pass")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from accelerate_tpu_torch import (
        LlamaConfig, LlamaForCausalLM, QuantizationConfig, quantize_model_,
    )

    card = card_line()
    log(card)
    model = LlamaForCausalLM(LlamaConfig(**MODEL, dtype=torch.bfloat16), device="cuda", seed=0)
    kv_dtype = "bf16"
    if args.quantized:
        quantize_model_(model, QuantizationConfig(load_in_8bit=True))
        kv_dtype = QUANT_KV
    adapters = lora_store(torch, model) if args.adapters else None
    with torch.inference_mode():
        report = profile_ticks(torch, model, card, args.skip, args.window, kv_dtype, adapters,
                               args.speculate)
    log("profile", json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
