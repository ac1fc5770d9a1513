#!/usr/bin/env python3
"""Where a training step's time goes, on one GPU.

Run from the root of a checkout:  python3 profile_training.py [--steps 2]

Trains ``chip_smoke.py``'s 600m step (bf16, flash attention, lion-sr on
bf16 params, bf16 gradients, fused linear + CE over 4 vocab chunks, batch
10 x 2048) for two warm-up steps, then runs ``--steps`` steps under
``torch.profiler``, each closed by a device sync.  Prints the card's name
and power limit, then one JSON line: host wall per step, the device's busy
share of the window (the union of its kernels' intervals), device time per
step in all, by kernel class (the three flash kernels, cuBLAS GEMMs, the
rest) and by kernel.  The profiler slows the host, so the busy share is a
lower bound on the unprofiled one.  Then, without the profiler, the step's
layers timed apart with CUDA events: forward + backward (the loss and its
gradients, as the step forms them), the fused linear + CE alone on the
final hidden states, and the optimizer update with its global norm.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

from chip_smoke import ROOT, TRAIN, card_line, log, time_ms, token_batch, train_setup

_GEMM = ("gemm", "nvjet", "cutlass", "xmma", "sm90_")


def kernel_class(name: str) -> str:
    for kernel in ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel"):
        if kernel in name:
            return kernel
    if any(tag in name.lower() for tag in _GEMM):
        return "gemm"
    return "other"


def profile_steps(torch, card: str, steps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    cfg, model, params, acc, loss_fn = train_setup(torch)
    state = acc.create_train_state(params, TRAIN["optimizer"])
    step = acc.prepare_train_step(loss_fn)
    batch = token_batch(torch, cfg.vocab_size, TRAIN["batch"])
    for _ in range(TRAIN["warmup"]):
        state, m = step(state, batch)
    torch.cuda.synchronize()
    walls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            s0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - s0)
        window_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end, by_name, by_class = 0.0, -math.inf, {}, {}
    for start, stop, name in spans:
        ms = (stop - start) / 1e3
        by_name[name] = by_name.get(name, 0.0) + ms
        by_class[kernel_class(name)] = by_class.get(kernel_class(name), 0.0) + ms
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:16]
    layers = layer_times(torch, model, loss_fn, state, batch)
    return {"card": card, "steps": steps, "window_ms": window_ms,
            "host_ms_per_step": [1e3 * w for w in walls],
            "device_busy_share": busy_us / 1e3 / window_ms if spans else None,
            "device_ms_per_step": sum(by_name.values()) / steps if spans else None,
            "kernels_per_step": len(spans) / steps,
            "device_ms_per_step_by_class": {k: v / steps for k, v in
                                            sorted(by_class.items(), key=lambda kv: -kv[1])},
            "top_kernels_ms_per_step": [{"name": n[:90], "ms": ms / steps} for n, ms in top],
            "last_loss": float(m["loss"]), "layer_ms": layers}


def layer_times(torch, model, loss_fn, state, batch) -> dict:
    """CUDA-event times of the step's layers, each on its own."""
    from accelerate_tpu_torch.accelerator import global_norm
    from accelerate_tpu_torch.ops.fused_xent import fused_causal_lm_loss

    params = state.params

    def fwd_bwd():
        leaves = [p.detach().requires_grad_() for p in params.values()]
        loss = loss_fn(dict(zip(params, leaves)), batch).float()
        return torch.autograd.grad(loss, leaves)

    grads = fwd_bwd()
    with torch.no_grad():
        hidden = model(batch["input_ids"], output_hidden=True)
    weight = params["lm_head.weight"]

    def ce():
        h = hidden.detach().requires_grad_()
        w = weight.detach().requires_grad_()
        loss = fused_causal_lm_loss(h, w, batch["labels"], vocab_major=True,
                                    num_chunks=TRAIN["ce_chunks"])
        return torch.autograd.grad(loss, (h, w))

    def update():
        # as the step applies it: in place on the state's params (the
        # profile is over, so the repeats may move them)
        leaves = list(params.values())
        global_norm(grads)
        new_leaves, _ = state.tx.update(list(grads), state.opt_state, leaves)
        with torch.no_grad():
            for p, new in zip(leaves, new_leaves):
                p.copy_(new)

    return {"forward_backward": time_ms(torch, lambda i: fwd_bwd(), iters=3, warmup=1),
            "fused_ce_fwd_bwd": time_ms(torch, lambda i: ce(), iters=3, warmup=1),
            "update_with_global_norm": time_ms(torch, lambda i: update(), iters=3, warmup=1)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=2, help="steps under the profiler")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_training: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    card = card_line()
    log(card)
    log("profile", json.dumps(profile_steps(torch, card, args.steps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
