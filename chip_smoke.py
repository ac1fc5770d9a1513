#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the port's CUDA kernels from ``accelerate_tpu_torch/csrc`` with
   nvcc (``sm_90a``) and reports the build time;
3. holds each kernel against its plain PyTorch version at the shapes of the
   600m serving model (block tables of distinct pages, as the allocator
   hands them out), and times the kernel, the plain version and one
   ``F.scaled_dot_product_attention`` call over the gathered KV (a
   yardstick only; the port never calls it) beside the least time the
   card could take (bytes over 3.35 TB/s or flops over 989 TFLOP/s bf16);
4. serves a 16-request trace on the 600m Llama (random weights from seed
   0) through ``ServingEngine``, checks that every request finishes, that
   the host page mirror agrees with the device allocator and that each
   kernel launched once per layer of every decode / prefill step; serves
   the trace again on a fresh engine with every kernel launch held against
   its plain version on the engine's own operands; then teacher-forces two
   of the served sequences through the model with the kernels and with
   their plain versions and compares the logits;
5. prints the kernels' JSON line, then ``{"ok": true, "device": {...}}``
   as the last line.

``profile_serving.py`` profiles a window of the same engine's ticks.

Any failed phase raises: the script exits non-zero and prints no result.
It exits non-zero at once where there is no CUDA device, or where it is
not inside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16, NVIDIA data sheet
# a kernel's output row (one token of one slot, over heads and head dim)
# passes iff max|out - ref| <= KERNEL_TOL * min(1, max|ref|): 2e-2 on rows of
# O(1), scaled down with rows that average a deep window; ROW_SCALE_FLOOR
# keeps the limit of an all-zero row above 0
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


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


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
    ratio = diff / (KERNEL_TOL * scale.clamp(min=ROW_SCALE_FLOOR, max=1.0))
    worst = int(ratio.argmax())
    rep = {"max_abs_err": diff.max().item(), "err_over_limit": ratio.max().item(),
           "worst_row_err": diff[worst].item(), "worst_row_ref_max": scale[worst].item(),
           "min_row_ref_max": scale.min().item()}
    if not (bool(torch.isfinite(out).all()) and rep["err_over_limit"] <= 1.0):
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
        with torch.no_grad():
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
    lib = _build.build("paged_attention")
    log(f"build paged_attention: {time.perf_counter() - t0:.2f} s -> {lib.name}")
    log(_build.BUILD_LOG["paged_attention"]["ptxas"].strip())

    kernels = kernel_phases(torch, F, fa)
    launches = engine_phase(torch, card)

    entries = []
    for name, replaces, count in (
        ("paged_decode_attention", "accelerate_tpu/ops/flash_attention.py:589",
         launches["decode"]),
        ("paged_multitoken_attention", "accelerate_tpu/ops/flash_attention.py:809",
         launches["prefill"]),
    ):
        rep = kernels[name]
        entries.append({"name": name, "route": "cuda",
                        "source": "accelerate_tpu_torch/csrc/paged_attention.cu",
                        "replaces": replaces, "launches": count,
                        "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
                        "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
                        "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
                        "err_over_limit": rep["err_over_limit"],
                        "in_path": launches["in_path"][name],
                        "card": card, "shape": rep["shape"],
                        **({"cases": rep["cases"]} if "cases" in rep else {})})
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
