"""Gang worker of ``tests/test_torch_context_parallel.py``: ring attention
over a cp ring of this world (both rotate methods, forward and gradients),
the in-process virtual ring on rank 0, ``maybe_context_parallel`` and a
tiny-Llama step under cp 2 x dp_shard 2."""

from __future__ import annotations

import numpy as np
import torch


def _np(t):
    return t.detach().cpu().numpy()


def _ring_case(rank, world, mesh, case) -> dict:
    """One case on this rank: the global inputs reordered into the ring's
    layout (zigzag under causality), this rank's shard attended, the
    seeded cotangent pulled back, and out / dq / dk / dv gathered whole in
    the ring's layout."""
    from ...parallel import collectives as C
    from ...parallel.context_parallel import make_ring_attention, zigzag_shard

    causal = case["causal"]
    glob = {k: torch.from_numpy(case[k]) for k in ("q", "k", "v", "g")}
    seg = torch.from_numpy(case["seg"]) if case.get("seg") is not None else None
    if causal:
        glob = {k: zigzag_shard(v, world) for k, v in glob.items()}
        seg = zigzag_shard(seg, world) if seg is not None else None
    local = {k: torch.chunk(v, world, dim=1)[rank].contiguous() for k, v in glob.items()}
    q, k, v = (local[n].clone().requires_grad_() for n in ("q", "k", "v"))
    seg_local = torch.chunk(seg, world, dim=1)[rank].contiguous() if seg is not None else None
    attn = make_ring_attention(mesh, rotate_method=case["rotate"], zigzag=causal)
    out = attn(q, k, v, causal=causal, segment_ids=seg_local)
    (out * local["g"]).sum().backward()
    whole = {name: C.all_gather(t.detach().contiguous(), "cp", axis=1, mesh=mesh)
             for name, t in (("out", out), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad))}
    return {"whole": whole, "glob": glob, "seg": seg}


def cp_checks(rank: int, world: int, cases: list, tokens, llama_state: str) -> dict:
    from ...accelerator import Accelerator
    from ...parallel.context_parallel import virtual_ring_attention, zigzag_unshard
    from ...parallelism_config import ParallelismConfig

    acc = Accelerator(cpu=True, parallelism_config=ParallelismConfig(cp_size=world))
    out = {"cases": []}
    for case in cases:
        got = _ring_case(rank, world, acc.mesh, case)
        rep = {}
        for name, t in got["whole"].items():
            rep[name] = _np(zigzag_unshard(t, world) if case["causal"] else t)
        if rank == 0:
            # every rank of the ring in turn, in this one process, on the
            # same inputs in the same layout
            glob = got["glob"]
            q, k, v = (glob[n].clone().requires_grad_() for n in ("q", "k", "v"))
            vout = virtual_ring_attention(q, k, v, world, causal=case["causal"],
                                          segment_ids=got["seg"], zigzag=case["causal"])
            (vout * glob["g"]).sum().backward()
            rep["virtual_bitwise"] = {
                name: bool(torch.equal(a, got["whole"][name]))
                for name, a in (("out", vout.detach()), ("dq", q.grad), ("dk", k.grad),
                                ("dv", v.grad))}
        out["cases"].append(rep)

    ids = np.arange(2 * 32, dtype=np.int32).reshape(2, 32)
    with acc.maybe_context_parallel(buffers=[ids, torch.from_numpy(ids)],
                                    buffer_seq_dims=[1, 1]) as (a, b):
        out["mcp"] = (_np(a), _np(b))
    plain = Accelerator(cpu=True, parallelism_config=ParallelismConfig(dp_shard_size=world))
    with plain.maybe_context_parallel(buffers=[ids], buffer_seq_dims=[1]) as (same,):
        out["mcp_noop"] = np.asarray(same)
    with plain.maybe_context_parallel() as empty:
        out["mcp_empty"] = empty
    out["llama"] = _cp_llama_steps(world, tokens, llama_state)
    return out


def _cp_llama_steps(world, tokens, llama_state, steps: int = 2) -> list:
    """The tiny f32 Llama with ring attention under cp 2 x dp_shard 2: each
    rank takes its dp rows of the global batch, pre-shifts the labels and
    takes its zigzag cp shard of both; the step's loss is the global token
    mean."""
    from ...accelerator import Accelerator
    from ...data_loader import shard_global_batch
    from ...models import llama as tl
    from ...models.llama import make_llama_loss_fn
    from ...parallelism_config import ParallelismConfig

    cfg = ParallelismConfig(cp_size=2, dp_shard_size=world // 2)
    acc = Accelerator(cpu=True, parallelism_config=cfg)
    model = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(dtype=torch.float32,
                                                    attn_implementation="ring"), device="cpu")
    model.load_state_dict(torch.load(llama_state))
    state = acc.create_train_state(model, "adamw")
    step = acc.prepare_train_step(make_llama_loss_fn(model, fused_vocab_chunks=4))
    ids = torch.from_numpy(tokens).long()
    shift = torch.roll(ids, -1, dims=1)
    shift[:, -1] = -100
    spec = cfg.batch_spec(seq_axis=None, ndim=2)
    ids, shift = (shard_global_batch(x, acc.mesh, spec) for x in (ids, shift))
    losses = []
    for _ in range(steps):
        with acc.maybe_context_parallel(buffers=[ids, shift], buffer_seq_dims=[1, 1]) as (i, s):
            state, m = step(state, {"input_ids": i, "shift_labels": s})
        losses.append(m["loss"].item())
    return losses
