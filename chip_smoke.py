#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the port's CUDA kernels from ``accelerate_tpu_torch/csrc`` with
   nvcc (``sm_90a``), one nvcc per source, all started together, and
   reports the build times;
3. holds each paged kernel (#4, #6) against its plain PyTorch version at
   the shapes of the 600m serving model (block tables of distinct pages, as
   the allocator hands them out), and times the kernel, the plain version
   and one ``F.scaled_dot_product_attention`` call over the gathered KV (a
   yardstick only; the port never calls it) beside the least time the card
   could take (bytes over 3.35 TB/s or flops over 989 TFLOP/s bf16);
4. holds the flash-attention kernels (#1 forward, #2 dq, #3 dk/dv) against
   their plain versions at the 600m training shapes (16 q / 8 kv heads,
   head dim 96, T 2048): at batch 2 causal, segments, positions,
   non-causal, T not a multiple of the tile, and a nonzero logsumexp
   gradient; at the main path's batch 10 causal; runs #3 twice and
   requires bitwise-equal dk/dv; times the three kernels, their plain
   versions and SDPA's forward and backward at batch 10;
5. serves a 16-request trace on the 600m Llama (random weights from seed
   0) through ``ServingEngine`` under ``torch.inference_mode()``, checks
   that every request finishes, that the host page mirror agrees with the
   device allocator and that each kernel launched once per layer of every
   decode / prefill step; serves the trace again on a fresh engine with
   every kernel launch held against its plain version on the engine's own
   operands; then teacher-forces two of the served sequences through the
   model with the kernels and with their plain versions;
6. trains the 600m Llama (bench.py's training step: bf16, flash attention,
   lion-sr on bf16 params, bf16 gradients, fused linear + CE over 4 vocab
   chunks, batch 10 x 2048 of seeded random tokens, the same batch every
   step) through ``Accelerator.create_train_state`` /
   ``prepare_train_step``: 2 warm-up steps, then timed steps with their
   losses, step time, tokens/s, MFU against 989 TFLOP/s and peak memory;
   checks that every kernel launched once per layer per step and that the
   losses are finite and fall; holds every kernel launch of one more
   batch-10 step, and of a batch-2 step, against its plain version on the
   step's own operands; checks that one step at batch 2 through the
   kernels and through their plain versions agrees (loss, grad norm and
   every leaf's gradient);
7. prints the kernels' JSON line, then ``{"ok": true, "device": {...}}``
   as the last line.

``profile_serving.py`` profiles a window of the same engine's ticks.

Any failed phase raises: the script exits non-zero and prints no result.
It exits non-zero at once where there is no CUDA device, or where it is
not inside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16, NVIDIA data sheet
# a kernel's output row (one token of one slot, over heads and head dim)
# passes iff max|out - ref| <= KERNEL_TOL * min(1, max|ref row|): 2e-2 on rows
# of O(1), scaled down with rows that average a deep window.  A row's scale
# is floored at ROW_SCALE_FLOOR * min(1, max|ref|) over the whole output, so
# an all-zero row's limit stays above 0 and the limit of a tensor whose every
# value is small (the gradients of a random model) scales down with it.  The
# worst error over a whole output must also stay within KERNEL_TOL of the
# output's largest |ref|
KERNEL_TOL = 2e-2
ROW_SCALE_FLOOR = 1e-3

# the 600m serving model and its engine geometry
MODEL = dict(vocab_size=32000, hidden_size=1536, intermediate_size=4096,
             num_hidden_layers=16, num_attention_heads=16, num_key_value_heads=8,
             max_position_embeddings=4096, attn_implementation="flash")
PLUGIN = dict(num_slots=16, page_size=64, pages_per_slot=32, num_pages=256,
              prefill_chunk=512)
TRACE = dict(vocab_size=32000, mean_interarrival_steps=0.5,
             prompt_len_range=(64, 512), new_tokens_range=(32, 256))
MAX_NEW = 256
N_REQUESTS = 16

# the 600m training step (bench.py's headline configuration on one chip)
TRAIN = dict(batch=10, seq=2048, warmup=2, timed=10, ce_chunks=4, optimizer="lion-sr")
CHECK_BATCH = 2       # the batch of the six-case kernel checks and the step comparison
LOSS_RTOL = 1e-3      # kernels vs plain versions, one step at CHECK_BATCH
GNORM_RTOL = 2e-2
LEAF_RTOL = 5e-2      # per leaf: ||g_kernel - g_plain|| / ||g_plain||


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def sync(torch):
    """Wait for the card, where there is one (the CPU rehearsal has none)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn(i)`` over ``iters`` calls, CUDA events."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def paged_case(torch, *, slots, width, pos0, copies=4, seed=0):
    """Random bf16 operands at the 600m paged-attention geometry.  Each
    slot's live block-table entries name distinct pages, drawn without
    replacement from the pool as the engine's allocator hands them out;
    entries past a slot's last live page stay 0, as in a fresh cache.
    Several copies of the page pool rotate between timed launches, so each
    launch finds its pages out of the 50 MB L2 as a layer of the real model
    does."""
    hkv, h = MODEL["num_key_value_heads"], MODEL["num_attention_heads"]
    d = MODEL["hidden_size"] // h
    page, n, num_pages = PLUGIN["page_size"], PLUGIN["pages_per_slot"], PLUGIN["num_pages"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    pools = [(torch.randn(hkv, num_pages, page, d, generator=gen, device=dev).bfloat16(),
              torch.randn(hkv, num_pages, page, d, generator=gen, device=dev).bfloat16())
             for _ in range(copies)]
    live = [min((p + width - 1) // page, n - 1) + 1 for p in pos0]
    if sum(live) > num_pages:
        raise ValueError(f"{sum(live)} live pages do not fit a pool of {num_pages}")
    ids = torch.randperm(num_pages, generator=torch.Generator().manual_seed(seed))
    bt = torch.zeros(slots, n, dtype=torch.int32)
    start = 0
    for s, count in enumerate(live):
        bt[s, :count] = ids[start:start + count]
        start += count
    bt = bt.to(dev)
    pos0 = torch.as_tensor(pos0, dtype=torch.int32, device=dev)
    positions = (pos0[:, None] + torch.arange(width, device=dev, dtype=torch.int32)).contiguous()
    q = torch.randn(slots, width, h, d, generator=gen, device=dev).bfloat16()
    return dict(q=q, pools=pools, bt=bt, positions=positions, hkv=hkv, h=h, d=d,
                page=page, n=n)


def held_to_plain(torch, name, out, ref) -> dict:
    """A kernel's ``out`` against ``ref``, its plain version in f32 on the
    same bf16 operands, row by row (see ``KERNEL_TOL``).  Returns the
    readings; raises if a row fails or ``out`` is not finite."""
    width = out.shape[-2] * out.shape[-1]
    diff = (out.float() - ref.float()).reshape(-1, width).abs().amax(dim=1)
    scale = ref.float().reshape(-1, width).abs().amax(dim=1)
    floor = ROW_SCALE_FLOOR * scale.max().clamp(max=1.0).item()
    ratio = diff / (KERNEL_TOL * scale.clamp(min=max(floor, 1e-30), max=1.0))
    worst = int(ratio.argmax())
    rep = {"max_abs_err": diff.max().item(), "err_over_limit": ratio.max().item(),
           "worst_row_err": diff[worst].item(), "worst_row_ref_max": scale[worst].item(),
           "min_row_ref_max": scale.min().item(), "tensor_ref_max": scale.max().item(),
           "err_over_tensor_max": (diff.max() / scale.max().clamp(min=1e-30)).item()}
    if not (bool(torch.isfinite(out).all()) and rep["err_over_limit"] <= 1.0
            and rep["err_over_tensor_max"] <= KERNEL_TOL):
        raise AssertionError(f"{name}: output off its plain version: {rep}")
    return rep


def case_report(torch, F, fa, case, decode: bool) -> dict:
    q, pools, bt, positions = case["q"], case["pools"], case["bt"], case["positions"]
    slots, width, h, d = q.shape
    hkv, page, n = case["hkv"], case["page"], case["n"]
    kp, vp = pools[0]
    if decode:
        qk, pk = q[:, 0].contiguous(), positions[:, 0].contiguous()
        kernel, plain = fa.paged_decode_attention, fa.paged_decode_attention_plain
    else:
        qk, pk = q, positions
        kernel, plain = fa.paged_multitoken_attention, fa.paged_multitoken_attention_plain
    out = kernel(qk, kp, vp, bt, pk)
    torch.cuda.synchronize()
    ref = plain(qk.float(), kp.float(), vp.float(), bt, pk)
    held = held_to_plain(torch, kernel.__name__, out, ref)
    ms = time_ms(torch, lambda i: kernel(qk, *pools[i % len(pools)], bt, pk))
    plain_ms = time_ms(torch, lambda i: plain(qk, *pools[i % len(pools)], bt, pk), iters=5)

    # yardstick: one SDPA call over the gathered KV, GQA heads repeated and
    # the positional mask given as a boolean mask (set-up not timed)
    kv_len = n * page
    k_lin = kp[:, bt.long()].reshape(hkv, slots, kv_len, d).permute(1, 0, 2, 3)
    v_lin = vp[:, bt.long()].reshape(hkv, slots, kv_len, d).permute(1, 0, 2, 3)
    k_lin = k_lin.repeat_interleave(h // hkv, dim=1).contiguous()
    v_lin = v_lin.repeat_interleave(h // hkv, dim=1).contiguous()
    q_lin = q.permute(0, 2, 1, 3).contiguous()                       # [S, H, T, D]
    mask = (torch.arange(kv_len, device="cuda")[None, None, None, :]
            <= positions[:, None, :, None])                          # [S, 1, T, L]
    library_ms = time_ms(torch, lambda i: F.scaled_dot_product_attention(
        q_lin, k_lin, v_lin, attn_mask=mask))

    # least time for this data: q/out/tables read or written once, each
    # distinct page the slots' live entries name read once for K and for V
    # in every kv head; 4 flops per (q row, head dim, live key)
    live_pages = torch.clamp(positions[:, -1].long() // page, max=n - 1) + 1
    read = torch.cat([bt[s, :int(c)] for s, c in enumerate(live_pages.tolist())])
    pages_read = int(torch.unique(read).numel())
    nbytes = (2 * q.numel() * 2 + bt.numel() * 4 + positions.numel() * 4
              + pages_read * 2 * hkv * page * d * 2)
    flops = 4 * h * d * int((positions.long() + 1).sum())
    bound_ms, bound_by = bound(nbytes, flops)
    return {**held, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "shape": {"slots": slots, "width": width, "heads": h, "kv_heads": hkv,
                      "head_dim": d, "page": page, "pages_per_slot": n,
                      "pages_read": pages_read,
                      "pos0": [int(x) for x in positions[:, 0].tolist()]}}


def kernel_phases(torch, F, fa) -> dict:
    """Kernel #4 and #6 against their plain versions at the 600m shapes."""
    reports = {}
    # #4: 16 decode slots, ragged positions incl. 0, page edges and 2047
    # (the block table's last token)
    dec_pos = [0, 1, 63, 64, 65, 127, 128, 300, 511, 777, 1023, 1024, 1500, 2000, 2046, 2047]
    rep = case_report(torch, F, fa, paged_case(torch, slots=16, width=1, pos0=dec_pos),
                      decode=True)
    log("kernel paged_decode_attention", json.dumps(rep))
    reports["paged_decode_attention"] = rep
    # #6: one prefill chunk, T in {16, 512}, starting at 0 or a mid-table
    # page boundary; the 512-token chunk from 0 is the main path's shape
    cases = []
    for width in (16, 512):
        for pos0 in (0, 1024):
            rep = case_report(torch, F, fa, paged_case(torch, slots=1, width=width,
                                                       pos0=[pos0], seed=width + pos0),
                              decode=False)
            log("kernel paged_multitoken_attention", json.dumps(rep))
            cases.append(rep)
    main = dict(next(c for c in cases if c["shape"]["width"] == 512 and c["shape"]["pos0"] == [0]))
    main["max_abs_err"] = max(c["max_abs_err"] for c in cases)
    main["err_over_limit"] = max(c["err_over_limit"] for c in cases)
    main["cases"] = [{k: c[k] for k in ("shape", "max_abs_err", "err_over_limit",
                                         "worst_row_err", "worst_row_ref_max", "ms",
                                         "plain_ms", "library_ms", "bound_ms", "bound_by")}
                     for c in cases]
    reports["paged_multitoken_attention"] = main
    return reports


# -- flash attention kernels #1-#3 -------------------------------------------

FLASH_HEADS = dict(h=MODEL["num_attention_heads"], hkv=MODEL["num_key_value_heads"],
                   d=MODEL["hidden_size"] // MODEL["num_attention_heads"])
FLASH_REPLACES = {"flash_fwd": "accelerate_tpu/ops/flash_attention.py:195",
                  "flash_dq": "accelerate_tpu/ops/flash_attention.py:329",
                  "flash_dkv": "accelerate_tpu/ops/flash_attention.py:375"}


def flash_inputs(torch, *, b, t, seg=False, pos=False, lse_grad=False, seed=0, device="cuda"):
    """Random bf16 q/k/v/g at the 600m attention geometry, an f32 gradient
    for the logsumexp (zero unless ``lse_grad``), and the mask options."""
    h, hkv, d = FLASH_HEADS["h"], FLASH_HEADS["hkv"], FLASH_HEADS["d"]
    gen = torch.Generator(device=device).manual_seed(seed)
    rand = lambda *shape: torch.randn(*shape, generator=gen, device=device)
    q, g = rand(b, t, h, d).bfloat16(), rand(b, t, h, d).bfloat16()
    k, v = rand(b, t, hkv, d).bfloat16(), rand(b, t, hkv, d).bfloat16()
    g_lse = rand(b, t, h) if lse_grad else torch.zeros(b, t, h, device=device)
    kw = {}
    if seg:   # four packed segments per row
        cuts = torch.sort(torch.randint(1, t, (b, 3), generator=gen, device=device), dim=1).values
        kw["segment_ids"] = (torch.arange(t, device=device)[None, :, None] >= cuts[:, None]).sum(-1)
    if pos:   # shuffled positions: the causal diagonal is data dependent
        kw["positions"] = torch.stack([torch.randperm(t, generator=gen, device=device)
                                       for _ in range(b)]).int()
    return q, k, v, g, g_lse, kw


def flash_fwd_bwd(torch, fn, q, k, v, g, g_lse, causal, kw):
    """out, lse, dq, dk, dv of ``sum(out * g) + sum(lse * g_lse)``."""
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out, lse = fn(q, k, v, causal=causal, return_lse=True, **kw)
    (out.float() * g.float()).sum().add((lse * g_lse).sum()).backward()
    return out.detach(), lse.detach(), q.grad, k.grad, v.grad


def flash_bound(b, t, valid_pairs):
    """Bytes and flops of each kernel for this data: each input read once
    and each output written once; 4 / 6 / 8 flops per head-dim element of
    each unmasked (query, key) pair for #1 / #2 / #3."""
    h, hkv, d = FLASH_HEADS["h"], FLASH_HEADS["hkv"], FLASH_HEADS["d"]
    q_bytes, kv_bytes, row_bytes = b * t * h * d * 2, b * t * hkv * d * 2, b * h * t * 4
    return {
        "flash_fwd": bound(2 * q_bytes + 2 * kv_bytes + row_bytes, 4 * d * valid_pairs),
        "flash_dq": bound(3 * q_bytes + 2 * kv_bytes + 2 * row_bytes, 6 * d * valid_pairs),
        "flash_dkv": bound(2 * q_bytes + 4 * kv_bytes + 2 * row_bytes, 8 * d * valid_pairs),
    }


def flash_kernel_phases(torch, F, fa, device: str = "cuda") -> dict:
    """#1-#3 against their plain versions at batch CHECK_BATCH on six
    cases and at the main path's batch; #3's determinism; times at the
    main path's batch."""
    h, hkv, d = FLASH_HEADS["h"], FLASH_HEADS["hkv"], FLASH_HEADS["d"]
    seq = TRAIN["seq"]
    cases = [dict(name="causal", t=seq), dict(name="segments", t=seq, seg=True),
             dict(name="positions", t=seq, pos=True),
             dict(name="non_causal", t=seq, causal=False),
             dict(name="t_not_tile_multiple", t=seq - 48),
             dict(name="lse_grad", t=seq, lse_grad=True)]
    readings = {name: [] for name in FLASH_REPLACES}
    for i, case in enumerate(cases):
        causal = case.get("causal", True)
        q, k, v, g, g_lse, kw = flash_inputs(torch, b=CHECK_BATCH, t=case["t"],
                                             seg=case.get("seg", False),
                                             pos=case.get("pos", False),
                                             lse_grad=case.get("lse_grad", False), seed=100 + i,
                                             device=device)
        got = flash_fwd_bwd(torch, fa.flash_attention, q, k, v, g, g_lse, causal, kw)
        sync(torch)
        want = flash_fwd_bwd(torch, fa.flash_attention_plain, q, k, v, g, g_lse, causal, kw)
        rep = {}
        for label, x, ref in zip(("out", "lse", "dq", "dk", "dv"), got, want):
            if label == "lse":
                x, ref = x[..., None], ref[..., None]
            rep[label] = held_to_plain(torch, f"flash {case['name']} {label}", x, ref)
        log("kernel flash", case["name"], json.dumps(rep))
        for name, labels in (("flash_fwd", ("out", "lse")), ("flash_dq", ("dq",)),
                             ("flash_dkv", ("dk", "dv"))):
            readings[name] += [dict(rep[lb], case=case["name"], tensor=lb) for lb in labels]
        del got, want

    # the main path's shape: batch 10, causal.  Each kernel against its
    # plain version on the same operands (the backward ones on the
    # kernel's lse and delta, as the step gives them), #3 run twice
    b = TRAIN["batch"]
    q, k, v, g, _, _ = flash_inputs(torch, b=b, t=seq, seed=7, device=device)
    kw = dict(causal=True, sm_scale=d ** -0.5)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_dq(q, k, v, g, lse, delta, **kw)
    dkv_a = fa.flash_dkv(q, k, v, g, lse, delta, **kw)
    dkv_b = fa.flash_dkv(q, k, v, g, lse, delta, **kw)
    sync(torch)
    if not (torch.equal(dkv_a[0], dkv_b[0]) and torch.equal(dkv_a[1], dkv_b[1])):
        raise AssertionError("flash_dkv: two runs on the same operands differ")
    rep = {}
    for name, got, plain, labels in (
        ("flash_fwd", (out, lse), lambda: fa.flash_fwd_plain(q, k, v, **kw), ("out", "lse")),
        ("flash_dq", (dq,), lambda: (fa.flash_dq_plain(q, k, v, g, lse, delta, **kw),), ("dq",)),
        ("flash_dkv", dkv_a, lambda: fa.flash_dkv_plain(q, k, v, g, lse, delta, **kw),
         ("dk", "dv")),
    ):
        for label, x, ref in zip(labels, got, plain()):
            if label == "lse":
                x, ref = x[..., None], ref[..., None]
            rep[label] = held_to_plain(torch, f"flash B {b} {label}", x, ref)
            readings[name].append(dict(rep[label], case=f"causal_b{b}", tensor=label))
    log("kernel flash", f"causal_b{b}", json.dumps(rep))
    del out, dq, dkv_a, dkv_b
    ms = {"flash_fwd": time_ms(torch, lambda i: fa.flash_fwd(q, k, v, **kw)),
          "flash_dq": time_ms(torch, lambda i: fa.flash_dq(q, k, v, g, lse, delta, **kw)),
          "flash_dkv": time_ms(torch, lambda i: fa.flash_dkv(q, k, v, g, lse, delta, **kw))}
    plain_ms = {
        "flash_fwd": time_ms(torch, lambda i: fa.flash_fwd_plain(q, k, v, **kw), iters=3, warmup=1),
        "flash_dq": time_ms(torch, lambda i: fa.flash_dq_plain(q, k, v, g, lse, delta, **kw),
                            iters=3, warmup=1),
        "flash_dkv": time_ms(torch, lambda i: fa.flash_dkv_plain(q, k, v, g, lse, delta, **kw),
                             iters=3, warmup=1)}
    # yardstick: SDPA on [B, H, T, D] copies (set-up not timed); its
    # backward computes dq, dk and dv in one call, set against #2 + #3
    qs, ks, vs = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    gs = g.transpose(1, 2).contiguous()
    sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
    with torch.no_grad():
        sdpa_fwd = time_ms(torch, lambda i: sdpa())
    out_s = sdpa()
    sdpa_bwd = time_ms(torch, lambda i: torch.autograd.grad(out_s, (qs, ks, vs), gs,
                                                           retain_graph=True))
    del out_s
    pairs = b * h * seq * (seq + 1) // 2
    bounds = flash_bound(b, seq, pairs)
    reports = {}
    for name in FLASH_REPLACES:
        worst = max(readings[name], key=lambda r: r["err_over_limit"])
        reports[name] = {
            "max_abs_err": max(r["max_abs_err"] for r in readings[name]),
            "err_over_limit": worst["err_over_limit"], "worst": worst,
            "ms": ms[name], "plain_ms": plain_ms[name],
            "library_ms": sdpa_fwd if name == "flash_fwd" else sdpa_bwd,
            "library_call": ("F.scaled_dot_product_attention forward" if name == "flash_fwd"
                             else "its backward (dq, dk and dv in one call)"),
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            "shape": {"batch": b, "seq": seq, "heads": h, "kv_heads": hkv, "head_dim": d,
                      "causal": True, "unmasked_pairs": pairs},
            "cases": [c["name"] for c in cases] + [f"causal_b{b}"],
        }
        log("kernel", name, json.dumps(reports[name]))
    log(f"flash at B {b}: fwd {ms['flash_fwd']:.3f} ms, dq + dkv "
        f"{ms['flash_dq'] + ms['flash_dkv']:.3f} ms; SDPA fwd {sdpa_fwd:.3f} ms, bwd "
        f"{sdpa_bwd:.3f} ms")
    return reports


# -- the training step --------------------------------------------------------


@contextlib.contextmanager
def routed_flash(llama_mod, fn):
    """Route the model's uncached flash attention through ``fn``."""
    saved = llama_mod.flash_attention
    llama_mod.flash_attention = fn
    try:
        yield
    finally:
        llama_mod.flash_attention = saved


@contextlib.contextmanager
def checked_flash_kernels(torch, fa, readings: dict):
    """Hold every launch of #1-#3 against its plain version on the same
    operands while the block runs (the autograd function looks the kernel
    wrappers up when it calls them)."""
    saved = {n: getattr(fa, n) for n in FLASH_REPLACES}

    def check(name, outs, refs, labels):
        for label, x, ref in zip(labels, outs, refs):
            if label == "lse":
                x, ref = x[..., None], ref[..., None]
            readings[name].append(held_to_plain(torch, f"{name} {label}", x, ref))

    def fwd(*args, **kw):
        out = saved["flash_fwd"](*args, **kw)
        check("flash_fwd", out, fa.flash_fwd_plain(*args, **kw), ("out", "lse"))
        return out

    def dq(*args, **kw):
        out = saved["flash_dq"](*args, **kw)
        check("flash_dq", [out], [fa.flash_dq_plain(*args, **kw)], ("dq",))
        return out

    def dkv(*args, **kw):
        out = saved["flash_dkv"](*args, **kw)
        check("flash_dkv", out, fa.flash_dkv_plain(*args, **kw), ("dk", "dv"))
        return out

    # the kernel wrappers count on the module's names: the stand-ins carry
    # counters of their own, so checking launches never count as main-path ones
    fwd.launches = dq.launches = dkv.launches = 0
    fa.flash_fwd, fa.flash_dq, fa.flash_dkv = fwd, dq, dkv
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(fa, n, f)


def checked_step(torch, fa, acc, loss_fn, state, batch, layers: int):
    """One train step with every launch of #1-#3 held against its plain
    version on the step's own operands.  Returns the new state and each
    kernel's worst readings."""
    readings = {n: [] for n in FLASH_REPLACES}
    with checked_flash_kernels(torch, fa, readings):
        state, _ = acc.prepare_train_step(loss_fn)(state, batch)
    rep = {}
    for name, calls in readings.items():
        per_step = len(calls) // (2 if name in ("flash_fwd", "flash_dkv") else 1)
        if per_step != layers:
            raise AssertionError(f"{name}: {per_step} checked launches in one step")
        worst = max(calls, key=lambda r: r["err_over_limit"])
        rep[name] = {"calls": per_step, "max_abs_err": max(r["max_abs_err"] for r in calls),
                     "err_over_tensor_max": max(r["err_over_tensor_max"] for r in calls),
                     **{k: worst[k] for k in ("err_over_limit", "worst_row_err",
                                              "worst_row_ref_max", "tensor_ref_max")}}
    return state, rep


def train_setup(torch, seed: int = 0, device: str = "cuda"):
    """The 600m model, its bf16 params (lion-sr keeps the params themselves
    in bf16, norm scales included: bench.py's sr_recipe), the Accelerator
    and the loss."""
    from accelerate_tpu_torch import (
        Accelerator, GradSyncKwargs, LlamaConfig, LlamaForCausalLM, make_llama_loss_fn,
    )
    cfg = LlamaConfig(**MODEL, dtype=torch.bfloat16)
    model = LlamaForCausalLM(cfg, device=device, seed=seed)
    params = {n: p.detach().to(torch.bfloat16) for n, p in model.named_parameters()}
    acc = Accelerator(mixed_precision="bf16", device=device,
                      kwargs_handlers=[GradSyncKwargs(grad_dtype="bf16")])
    loss_fn = make_llama_loss_fn(model, fused_vocab_chunks=TRAIN["ce_chunks"])
    return cfg, model, params, acc, loss_fn


def token_batch(torch, vocab: int, batch: int, device: str = "cuda"):
    tokens = np.random.default_rng(0).integers(0, vocab, (batch, TRAIN["seq"]))
    ids = torch.from_numpy(tokens).to(device)
    return {"input_ids": ids, "labels": ids}


def training_phase(torch, fa, card: str, device: str = "cuda") -> dict:
    """bench.py's 600m step: warm-up, timed steps with their launches, one
    checked batch-10 step, then the batch-2 checks against the plain
    versions."""
    import accelerate_tpu_torch.models.llama as llama_mod
    from accelerate_tpu_torch.accelerator import global_norm
    from accelerate_tpu_torch.models.llama import count_params, flops_per_token

    cfg, model, params, acc, loss_fn = train_setup(torch, device=device)
    state = acc.create_train_state(params, TRAIN["optimizer"])
    step = acc.prepare_train_step(loss_fn)   # lion family: no clipping (bench.py)
    batch = token_batch(torch, cfg.vocab_size, TRAIN["batch"], device)
    losses = []
    for _ in range(TRAIN["warmup"]):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    sync(torch)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    timed = []
    for _ in range(TRAIN["timed"]):
        state, m = step(state, batch)
        timed.append(m["loss"])
    sync(torch)
    wall = time.perf_counter() - t0
    launches = {n: getattr(fa, n).launches for n in FLASH_REPLACES}
    losses += [float(x) for x in timed]
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    layers = cfg.num_hidden_layers
    for name, count in launches.items():
        if count != TRAIN["timed"] * layers:
            raise AssertionError(f"{name} launched {count} times in {TRAIN['timed']} steps, "
                                 f"expected {layers} per step")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses not finite and falling: {losses}")
    step_s = wall / TRAIN["timed"]
    tokens = TRAIN["batch"] * TRAIN["seq"]
    fpt = flops_per_token(cfg, TRAIN["seq"])
    rep = {"card": card, "params": count_params(params), "batch": TRAIN["batch"],
           "seq": TRAIN["seq"], "optimizer": TRAIN["optimizer"], "step_ms": step_s * 1e3,
           "tokens_per_s": tokens / step_s, "flops_per_token": fpt,
           "mfu_vs_989_tflops": fpt * tokens / step_s / BF16_FLOPS_PER_S,
           "max_memory_allocated_gib": peak / 2**30, "losses": losses,
           "launches_per_step": {n: c / TRAIN["timed"] for n, c in launches.items()}}
    log("train", json.dumps(rep))
    log(f"training on {card}: {rep['step_ms']:.1f} ms/step, {rep['tokens_per_s']:.0f} tokens/s, "
        f"MFU {100 * rep['mfu_vs_989_tflops']:.1f} % of the H100 SXM dense bf16 peak "
        f"(989 TFLOP/s), peak memory {rep['max_memory_allocated_gib']:.2f} GiB")
    # gate, outside the timed window: every launch of one more batch-10
    # step against its plain version on the step's own operands
    state, in_path = checked_step(torch, fa, acc, loss_fn, state, batch, layers)
    log("train_in_path", f"batch {TRAIN['batch']}", json.dumps(in_path))
    del state, params, model, step, m, timed
    if device == "cuda":
        torch.cuda.empty_cache()

    # gate: one step at CHECK_BATCH through the kernels and through the
    # plain versions, from the same weights
    cfg, model, params, acc, loss_fn = train_setup(torch, device=device)
    small = {k: v[:CHECK_BATCH] for k, v in batch.items()}
    start = {n: p.clone() for n, p in params.items()}

    def grads_of(route):
        leaves = {n: p.detach().requires_grad_() for n, p in start.items()}
        with routed_flash(llama_mod, route):
            loss = loss_fn(leaves, small).float()
        return loss.item(), torch.autograd.grad(loss, list(leaves.values()))

    loss_k, grads_k = grads_of(fa.flash_attention)
    loss_p, grads_p = grads_of(fa.flash_attention_plain)
    gn_k, gn_p = global_norm(grads_k).item(), global_norm(grads_p).item()
    leaf_err = {n: ((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30)).item()
                for n, a, b in zip(start, grads_k, grads_p)}
    worst_leaf = max(leaf_err, key=leaf_err.get)
    step_metrics = {}
    for route_name, route in (("kernels", fa.flash_attention), ("plain", fa.flash_attention_plain)):
        st = acc.create_train_state({n: p.clone() for n, p in start.items()}, TRAIN["optimizer"])
        with routed_flash(llama_mod, route):
            _, m = acc.prepare_train_step(loss_fn)(st, small)
        step_metrics[route_name] = {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item()}
        del st
    gate = {"loss_kernels": loss_k, "loss_plain": loss_p, "grad_norm_kernels": gn_k,
            "grad_norm_plain": gn_p, "loss_rel": abs(loss_k - loss_p) / abs(loss_p),
            "grad_norm_rel": abs(gn_k - gn_p) / gn_p, "worst_leaf": worst_leaf,
            "worst_leaf_rel_err": leaf_err[worst_leaf],
            "median_leaf_rel_err": float(np.median(list(leaf_err.values()))),
            "step": step_metrics}
    log("train_vs_plain", json.dumps(gate))
    sm = step_metrics
    if (gate["loss_rel"] > LOSS_RTOL or gate["grad_norm_rel"] > GNORM_RTOL
            or gate["worst_leaf_rel_err"] > LEAF_RTOL
            or abs(sm["kernels"]["loss"] - sm["plain"]["loss"]) > LOSS_RTOL * abs(sm["plain"]["loss"])
            or abs(sm["kernels"]["grad_norm"] - sm["plain"]["grad_norm"])
            > GNORM_RTOL * sm["plain"]["grad_norm"]):
        raise AssertionError(f"the kernel step disagrees with the plain step: {gate}")
    del grads_k, grads_p

    # gate: every launch of a CHECK_BATCH step against its plain version
    st = acc.create_train_state({n: p.clone() for n, p in start.items()}, TRAIN["optimizer"])
    st, in_path_small = checked_step(torch, fa, acc, loss_fn, st, small, cfg.num_hidden_layers)
    log("train_in_path", f"batch {CHECK_BATCH}", json.dumps(in_path_small))
    del st, params, model, start
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"launches": launches, "report": rep, "in_path": in_path,
            "in_path_check_batch": in_path_small}


@contextlib.contextmanager
def routed_attention(llama_mod, decode, multitoken):
    """Route the model's paged attention through ``decode`` / ``multitoken``
    in place of the kernel wrappers while the block runs."""
    saved = (llama_mod.paged_decode_attention, llama_mod.paged_multitoken_attention)
    llama_mod.paged_decode_attention = decode
    llama_mod.paged_multitoken_attention = multitoken
    try:
        yield
    finally:
        llama_mod.paged_decode_attention, llama_mod.paged_multitoken_attention = saved


def checked(torch, kernel, plain, readings: list):
    """``kernel``'s wrapper, followed on every call by its plain version in
    f32 on the same operands; each call's readings go to ``readings``."""
    def call(q, k_pages, v_pages, block_tables, positions, **kw):
        out = kernel(q, k_pages, v_pages, block_tables, positions, **kw)
        ref = plain(q.float(), k_pages.float(), v_pages.float(), block_tables, positions, **kw)
        readings.append(held_to_plain(torch, kernel.__name__, out, ref))
        return out
    return call


def in_path_check(torch, model, llama_mod, fa, trace) -> dict:
    """Serve ``trace`` on a fresh engine with every kernel launch held
    against its plain version on the operands the engine gives it: the
    allocator's block tables, bucket-padded prefill windows and the dead
    slots of each decode step.  Returns each kernel's worst readings."""
    from accelerate_tpu_torch import GenerationConfig, ServingEngine, ServingPlugin

    engine = ServingEngine(model, ServingPlugin(**PLUGIN), GenerationConfig(max_new_tokens=MAX_NEW),
                           device=model.device)
    engine.warmup()
    readings = {"paged_decode_attention": [], "paged_multitoken_attention": []}
    with routed_attention(
        llama_mod,
        checked(torch, fa.paged_decode_attention, fa.paged_decode_attention_plain,
                readings["paged_decode_attention"]),
        checked(torch, fa.paged_multitoken_attention, fa.paged_multitoken_attention_plain,
                readings["paged_multitoken_attention"]),
    ):
        engine.run(trace)
    rep = {}
    for name, calls in readings.items():
        if not calls:
            raise AssertionError(f"{name}: no launch in the checked serving pass")
        worst = max(calls, key=lambda r: r["err_over_limit"])
        rep[name] = {"calls": len(calls), "max_abs_err": max(r["max_abs_err"] for r in calls),
                     **{k: worst[k] for k in ("err_over_limit", "worst_row_err",
                                              "worst_row_ref_max")},
                     "min_row_ref_max": min(r["min_row_ref_max"] for r in calls)}
    return rep


def teacher_forced_check(torch, model, llama_mod, fa, request, generated) -> dict:
    """Run prompt + generated tokens through the model's paged path twice,
    with the kernels and with their plain versions: the prompt as one
    prefill chunk, then one decode step per later token.  Compares every
    position's logits."""
    from accelerate_tpu_torch.models.llama import init_paged_cache

    dev = model.device
    tokens = list(request.prompt) + list(generated[:-1])
    p_len = request.prompt_len
    page = PLUGIN["page_size"]
    n_pages = -(-len(tokens) // page)
    ids = torch.tensor(tokens, device=dev)[None]
    pos = torch.arange(len(tokens), device=dev)[None]

    def run():
        cache = init_paged_cache(model.config, n_pages, page, 1, n_pages, device=dev)
        bt = torch.arange(n_pages, dtype=torch.int32, device=dev)[None]
        layers = [{"k_pages": l["k_pages"], "v_pages": l["v_pages"], "block_tables": bt}
                  for l in cache["layers"]]
        out = []
        with torch.inference_mode():
            for a, b in [(0, p_len)] + [(t, t + 1) for t in range(p_len, len(tokens))]:
                lg, layers = model(ids[:, a:b], positions=pos[:, a:b], cache=layers,
                                   cache_write_mask=torch.ones(1, b - a, dtype=torch.bool,
                                                               device=dev))
                out.append(lg[0])
        return torch.cat(out)

    k_logits = run()
    with routed_attention(llama_mod, fa.paged_decode_attention_plain,
                          fa.paged_multitoken_attention_plain):
        p_logits = run()
    if k_logits.shape != (len(tokens), model.config.vocab_size):
        raise AssertionError(f"teacher-forced logits of shape {tuple(k_logits.shape)}")
    if not (torch.isfinite(k_logits).all() and torch.isfinite(p_logits).all()):
        raise AssertionError("non-finite logits in the teacher-forced run")
    agree = (k_logits.argmax(-1) == p_logits.argmax(-1)).float().mean().item()
    rel = ((k_logits - p_logits).abs().mean() / p_logits.abs().mean()).item()
    # the kernel path's greedy continuation of the prompt against what the
    # engine served (reported, not gated: the engine ran bucket-padded
    # prefill chunks, so the matrix products saw other shapes)
    served = (k_logits[p_len - 1:].argmax(-1).tolist() == list(generated))
    rep = {"uid": request.uid, "positions": len(tokens), "argmax_agreement": agree,
           "mean_abs_dlogit_over_mean_abs_logit": rel, "kernel_argmax_equals_served": served}
    if agree < 0.98 or rel > 1e-2:
        raise AssertionError(f"teacher-forced check failed: {rep}")
    return rep


def engine_phase(torch, card: str, device: str = "cuda") -> dict:
    import accelerate_tpu_torch.models.llama as llama_mod
    from accelerate_tpu_torch import (
        GenerationConfig, LlamaConfig, LlamaForCausalLM, ServingEngine, ServingPlugin,
        replay, synthesize_trace,
    )
    from accelerate_tpu_torch.ops import flash_attention as fa

    cfg = LlamaConfig(**MODEL, dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=device, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    engine = ServingEngine(model, ServingPlugin(**PLUGIN), GenerationConfig(max_new_tokens=MAX_NEW),
                           device=device)
    trace = synthesize_trace(0, N_REQUESTS, **TRACE)
    engine.warmup()
    setup_s = time.perf_counter() - t0
    fa.reset_launch_counts()
    report = replay(engine, trace)
    decode_launches = fa.paged_decode_attention.launches
    prefill_launches = fa.paged_multitoken_attention.launches
    m = engine.metrics
    layers = cfg.num_hidden_layers
    if report["completed"] != len(trace):
        raise AssertionError(f"{report['completed']} of {len(trace)} requests finished")
    for r in trace:
        if len(engine.results[r.uid]) != r.max_new_tokens:
            raise AssertionError(f"request {r.uid}: {len(engine.results[r.uid])} tokens, "
                                 f"expected {r.max_new_tokens}")
    if not engine.free_page_mirror_in_sync():
        raise AssertionError("host free-page mirror out of sync with the device allocator")
    if decode_launches != m["decode_steps"] * layers:
        raise AssertionError(f"paged_decode_attention launched {decode_launches} times, "
                             f"expected {m['decode_steps']} decode steps x {layers}")
    if prefill_launches != m["prefill_steps"] * layers:
        raise AssertionError(f"paged_multitoken_attention launched {prefill_launches} "
                             f"times, expected {m['prefill_steps']} prefill steps x {layers}")
    if decode_launches == 0 or prefill_launches == 0:
        raise AssertionError("a kernel of the main path never launched")
    log("engine", json.dumps({"card": card, "params": n_params, "setup_s": setup_s,
                              **report, "launches": {
                                  "paged_decode_attention": decode_launches,
                                  "paged_multitoken_attention": prefill_launches}}))
    in_path = in_path_check(torch, model, llama_mod, fa, trace)
    log("in_path", json.dumps(in_path))
    checks = [teacher_forced_check(torch, model, llama_mod, fa, trace[i],
                                   engine.results[trace[i].uid]) for i in (0, 1)]
    log("teacher_forced", json.dumps(checks))
    log(f"serving on {card}: {report['tokens_per_sec']:.1f} tokens/s, "
        f"TTFT p50 {report['ttft_p50_ms']:.2f} ms, token latency p50 "
        f"{report['p50_token_latency_ms']:.3f} ms / p99 {report['p99_token_latency_ms']:.3f} ms")
    return {"decode": decode_launches, "prefill": prefill_launches, "in_path": in_path}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "accelerate_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F

    from accelerate_tpu_torch.ops import _build
    from accelerate_tpu_torch.ops import flash_attention as fa

    # the plain versions are the reference: full-f32 products, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    libs = _build.build_all(["paged_attention", "flash_attention"])
    log(f"build (parallel nvcc): {time.perf_counter() - t0:.2f} s -> "
        f"{', '.join(lib.name for lib in libs.values())}")
    for name in libs:
        log(f"{name}: nvcc {_build.BUILD_LOG[name]['seconds']:.2f} s")
        log(_build.BUILD_LOG[name]["ptxas"].strip())

    kernels = kernel_phases(torch, F, fa)
    kernels.update(flash_kernel_phases(torch, F, fa))
    with torch.inference_mode():
        launches = engine_phase(torch, card)
    train = training_phase(torch, fa, card)

    entries = []
    for name, replaces, source, count, in_path in (
        ("flash_fwd", FLASH_REPLACES["flash_fwd"], "accelerate_tpu_torch/csrc/flash_attention.cu",
         train["launches"]["flash_fwd"], train["in_path"]["flash_fwd"]),
        ("flash_dq", FLASH_REPLACES["flash_dq"], "accelerate_tpu_torch/csrc/flash_attention.cu",
         train["launches"]["flash_dq"], train["in_path"]["flash_dq"]),
        ("flash_dkv", FLASH_REPLACES["flash_dkv"], "accelerate_tpu_torch/csrc/flash_attention.cu",
         train["launches"]["flash_dkv"], train["in_path"]["flash_dkv"]),
        ("paged_decode_attention", "accelerate_tpu/ops/flash_attention.py:589",
         "accelerate_tpu_torch/csrc/paged_attention.cu", launches["decode"],
         launches["in_path"]["paged_decode_attention"]),
        ("paged_multitoken_attention", "accelerate_tpu/ops/flash_attention.py:809",
         "accelerate_tpu_torch/csrc/paged_attention.cu", launches["prefill"],
         launches["in_path"]["paged_multitoken_attention"]),
    ):
        rep = kernels[name]
        entries.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": count,
                        "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
                        "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
                        "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
                        "err_over_limit": rep["err_over_limit"], "in_path": in_path,
                        "card": card, "shape": rep["shape"],
                        **({"cases": rep["cases"]} if "cases" in rep else {})})
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
