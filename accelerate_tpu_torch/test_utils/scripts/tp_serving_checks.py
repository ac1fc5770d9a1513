"""Gang worker of ``tests/test_torch_tp_serving.py``: tensor-parallel
inference on each rank of a gloo world.  Each rank binds its tp slices of
a tiny f32 Llama (``parallel.sharding.bind_tp_slices``), releases the
whole model, and runs the LoRA forward (logits and ``output_hidden``),
``generate``, ``beam_search`` and the serving engine on a trace; the
report carries what the test holds against JAX and the one-process port."""

from __future__ import annotations

import numpy as np
import torch


def tp_pair(rank, world, state_path, lora_pool, lora_ids, prompts, trace, geometry,
            max_new, beams) -> dict:
    from ...accelerator import Accelerator
    from ...generation import GenerationConfig, beam_search, generate
    from ...models.llama import LlamaConfig, LlamaForCausalLM
    from ...parallel.sharding import bind_tp_slices, held_bytes
    from ...parallelism_config import ParallelismConfig
    from ...serving import Request, ServingEngine, verify_serving_invariants
    from ...utils.dataclasses import ServingPlugin

    Accelerator(cpu=True, parallelism_config=ParallelismConfig(tp_size=world)).mesh
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32), device="cpu")
    model.load_state_dict(torch.load(state_path))
    whole_bytes = held_bytes(model)
    bound = bind_tp_slices(model)
    del model
    pool = {k: {f: torch.from_numpy(v) for f, v in fac.items()} for k, fac in lora_pool.items()}
    ids = torch.from_numpy(prompts).long()
    slots = torch.tensor(lora_ids)
    out = {"whole_bytes": whole_bytes, "held_bytes": held_bytes(bound),
           "kv_heads": bound.cache_kv_heads()}
    with torch.no_grad():
        out["lora_logits"] = bound(ids, adapter_ids=slots, lora=pool).numpy()
        out["lora_hidden"] = bound(ids, adapter_ids=slots, lora=pool,
                                   output_hidden=True).numpy()
    gc = GenerationConfig(max_new_tokens=max_new)
    out["generate"] = generate(bound, ids, gc).numpy()
    out["beam_search"] = beam_search(bound, ids, gc, num_beams=beams).numpy()
    engine = ServingEngine(bound, ServingPlugin(**geometry, decode_kernel="flash"),
                           GenerationConfig(max_new_tokens=16), device="cpu")
    engine.warmup()
    engine.run([Request(*r) for r in trace])
    out["results"] = dict(engine.results)
    out["events"] = list(engine.sched.events)
    out["block_tables"] = engine.cache["block_tables"].numpy()
    out["invariants"] = verify_serving_invariants(engine)
    out["k_pages"] = np.stack([layer["k_pages"].numpy() for layer in engine.cache["layers"]])
    return out
