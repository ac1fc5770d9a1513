"""Gang workers of ``tests/test_torch_pipeline_parallel.py``: the tiny
Llama as a GPipe pipeline over the ``pp`` ranks of a gloo world, its
logits for several microbatch counts, its gradients through the schedule,
a few training steps, the divisibility error and the parameter
interchange."""

from __future__ import annotations

import numpy as np
import torch


def _np(t):
    return t.detach().cpu().float().numpy()


def pp_checks(rank, world, state_path, tokens, layers=4, microbatches=(2, 4, 8),
              train_steps=5) -> dict:
    """Under ``ParallelismConfig(pp_size=world)``: logits per microbatch
    count, the loss's gradients (each stage's layers gathered over pp, the
    rest as this rank holds them), the losses of ``train_steps`` AdamW
    steps (lr 1e-2) on the pipelined model, the error of a batch the
    microbatches do not divide, the unwrap and the merged parameters, and
    the unwrapped model after the training steps."""
    from ...accelerator import Accelerator
    from ...models import llama as tl
    from ...parallel import collectives as C
    from ...parallel.pipeline_parallel import prepare_pipeline
    from ...parallelism_config import ParallelismConfig

    acc = Accelerator(cpu=True, parallelism_config=ParallelismConfig(pp_size=world))
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32, num_hidden_layers=layers)
    state = torch.load(state_path)
    ids = torch.from_numpy(tokens).long()

    def fresh():
        model = tl.LlamaForCausalLM(cfg, device="cpu")
        model.load_state_dict(state)
        return model

    model = fresh()
    out = {"logits": {}}
    with torch.no_grad():
        for mb in microbatches:
            out["logits"][mb] = _np(prepare_pipeline(model, num_microbatches=mb)(ids))
    pm = prepare_pipeline(model, num_microbatches=2)
    out["unwrapped"] = acc.unwrap_model(pm) is model
    merged = pm.merged_params()
    out["merged_equal"] = all(torch.equal(merged[n], p.detach())
                              for n, p in model.named_parameters())
    loss = tl.causal_lm_loss(pm(ids), ids)
    loss.backward()
    out["loss"] = loss.item()
    out["stage_grads"] = {k: _np(C.all_gather(t.grad.contiguous(), "pp", axis=0))
                          for k, t in pm.stacked.items()}
    out["rest_grads"] = {n: _np(t.grad) for n, t in pm.rest.items()}
    try:
        prepare_pipeline(model, num_microbatches=3)(ids)
    except ValueError as exc:
        out["divisibility"] = str(exc)
    model = fresh()
    pm = prepare_pipeline(model, num_microbatches=2)
    opt = torch.optim.AdamW(pm.parameters(), lr=1e-2)
    losses = []
    for _ in range(train_steps):
        opt.zero_grad()
        loss = tl.causal_lm_loss(pm(ids), ids)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    out["train_losses"] = losses
    # the unwrapped model after training: the pipeline's tensors, its own
    # layers trained, its plain forward the pipeline's
    merged = pm.merged_params()
    unwrapped = acc.unwrap_model(pm)
    held = unwrapped.state_dict()
    layers = [n for n in merged if n.startswith("model.layers.")]
    with torch.no_grad():
        err = (unwrapped(ids) - pm(ids)).abs().max().item()
    out["unwrap_after_training"] = {
        "is_model": unwrapped is model,
        "equals_merged": all(torch.equal(held[n], merged[n]) for n in merged),
        "layers_trained": all(not torch.equal(held[n], state[n]) for n in layers),
        "logits_max_abs_err": err}
    return out


def surface_checks(rank, world) -> dict:
    """The Accelerator's worlds of ``world`` ranks: pp (its mesh, a
    pipeline over it, unwrapped) and ep (its mesh, the batch the prepared
    loader gives each ep rank, the tiny Mixtral's expert slice)."""
    from ...accelerator import Accelerator
    from ...models import llama as tl
    from ...models import mixtral as tm
    from ...parallel import collectives as C
    from ...parallel.pipeline_parallel import prepare_pipeline
    from ...parallelism_config import ParallelismConfig

    out = {}
    acc = Accelerator(cpu=True, parallelism_config=ParallelismConfig(pp_size=world))
    model = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(dtype=torch.float32), device="cpu")
    pm = prepare_pipeline(model, num_microbatches=2)
    out["pp"] = {"sizes": {a: s for a, s in C.mesh_sizes(acc.mesh).items() if s > 1},
                 "unwrapped": acc.unwrap_model(pm) is model,
                 "stage_layers": next(iter(pm.stacked.values())).shape[0]}
    acc = Accelerator(cpu=True, parallelism_config=ParallelismConfig(ep_size=world))
    rows = torch.arange(8 * 4).reshape(8, 4)
    loader = acc.prepare(torch.utils.data.DataLoader(
        torch.utils.data.TensorDataset(rows), batch_size=4,
        collate_fn=lambda b: {"input_ids": torch.stack([r[0] for r in b])}))
    model = tm.MixtralForCausalLM(tm.MixtralConfig.tiny(dtype=torch.float32), device="cpu")
    state = acc.create_train_state(model, "adamw")
    out["ep"] = {"sizes": {a: s for a, s in C.mesh_sizes(acc.mesh).items() if s > 1},
                 "non_data_parallel": acc.parallelism_config.non_data_parallel_size,
                 "batches": [_np(b["input_ids"]) for b in loader],
                 "experts": tuple(state.params[
                     "model.layers.0.block_sparse_moe.experts.gate_proj"].shape)}
    return out
