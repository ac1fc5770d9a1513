"""The port's activation recomputation and scanned layer stack
(``LlamaConfig.remat`` / ``remat_policy`` / ``scan_layers`` /
``scan_block_size`` / ``boundary_offload_fraction``) held against the
port's plain stack and against the JAX package.

Within torch every policy and layout is bitwise the plain unrolled stack:
logits, every parameter's gradient and two train steps' params and int8
optimizer state (a recomputed forward runs the same ops on the same
inputs; a scanned layer runs the same module on its slice).  Against JAX in
f32: logits and gradients to 1e-5 (JAX ``tests/test_models.py:242``), the
stacked layout and a JAX scan-layers tree converted exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from accelerate_tpu.models import llama as jl
from accelerate_tpu_torch import (
    Accelerator, GenerationConfig, ServingEngine, ServingPlugin, generate, synthesize_trace,
)
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import torch_state_from_flax

TOL = dict(atol=1e-5, rtol=1e-5)
POLICIES = ["full", "dots", "offload"]


@pytest.fixture(scope="module")
def tiny():
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, num_hidden_layers=4)
    params = jl.LlamaForCausalLM(jcfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    host = jax.tree.map(np.asarray, params)
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32, num_hidden_layers=4,
                              attn_implementation="flash")
    ids = np.random.default_rng(0).integers(0, 256, (2, 16))
    return jcfg, params, host, cfg, ids


def _port(cfg, state):
    model = tl.LlamaForCausalLM(cfg, device="cpu", seed=1)
    model.load_state_dict(state)
    return model


def _logits_and_grads(model, ids):
    out = model(torch.from_numpy(ids))
    out.float().square().mean().backward()
    return out.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


def test_llama_config_validation_matches_jax():
    bad = [dict(remat_policy="everything"), dict(boundary_offload_fraction=0.0),
           dict(boundary_offload_fraction=1.5), dict(scan_block_size=2),
           dict(scan_layers=True, scan_block_size=3)]
    for kw in bad:
        with pytest.raises(ValueError) as jerr:
            jl.LlamaConfig.tiny(**kw)
        with pytest.raises(ValueError) as terr:
            tl.LlamaConfig.tiny(**kw)
        assert str(terr.value).split()[0] == str(jerr.value).split()[0], kw
    tl.LlamaConfig.tiny(scan_layers=True, scan_block_size=2, remat=True, remat_policy="offload",
                        boundary_offload_fraction=0.5)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_matches_no_remat_bitwise_and_jax(tiny, policy):
    jcfg, params, host, cfg, ids = tiny
    ref_out, ref_g = _logits_and_grads(_port(cfg, torch_state_from_flax(host)), ids)
    model = _port(dataclasses.replace(cfg, remat=True, remat_policy=policy),
                  torch_state_from_flax(host))
    out, g = _logits_and_grads(model, ids)
    assert torch.equal(out, ref_out)
    for n in ref_g:
        assert torch.equal(g[n], ref_g[n]), n
    # against JAX's remat at the same policy (its CPU offload runs full)
    jmodel = jl.LlamaForCausalLM(dataclasses.replace(jcfg, remat=True, remat_policy=policy,
                                                     attn_implementation="flash"))

    def jloss(p):
        return jnp.mean(jmodel.apply(p, jnp.asarray(ids)).astype(jnp.float32) ** 2)

    jout = jmodel.apply(params, jnp.asarray(ids))
    jgrads = torch_state_from_flax(jax.tree.map(np.asarray, jax.grad(jloss)(params)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    for n, gj in jgrads.items():
        np.testing.assert_allclose(g[n].numpy(), gj.numpy(), atol=1e-6, rtol=1e-4, err_msg=n)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_recomputes_with_the_weights_the_forward_read(tiny, policy):
    """Under ``functional_call`` with other tensors than the module's own
    (a train state's bf16 copies of an f32 model), the backward's
    recompute reads the tensors the forward read: the gradients are the
    plain stack's."""
    *_, host, cfg, ids = tiny
    model = _port(dataclasses.replace(cfg, remat=True, remat_policy=policy),
                  torch_state_from_flax(host))
    plain = _port(cfg, torch_state_from_flax(host))
    grads = []
    for m in (plain, model):
        params = {n: p.detach().bfloat16().requires_grad_() for n, p in m.named_parameters()}
        out = torch.func.functional_call(m, params, (torch.from_numpy(ids),),
                                         {"output_hidden": True})
        grads.append(torch.autograd.grad(out.float().square().mean(), list(params.values()),
                                         allow_unused=True))
    assert sum(g is not None for g in grads[1]) == len(grads[1]) - 1     # all but the head
    for a, b in zip(*grads):
        assert (a is None and b is None) or (a.dtype == torch.bfloat16 and torch.equal(a, b))


@pytest.mark.parametrize("policy, calls", [(None, 1), ("full", 2), ("dots", 2), ("offload", 2)])
def test_flash_runs_twice_a_layer_under_remat(tiny, monkeypatch, policy, calls):
    """The recomputed forward runs flash attention (#1 on the card) again
    under every policy: ``dots`` saves the products, not the attention."""
    *_, cfg, ids = tiny
    seen = []
    real = tl.flash_attention

    def counting(*a, **k):
        seen.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tl, "flash_attention", counting)
    model = tl.LlamaForCausalLM(dataclasses.replace(cfg, remat=policy is not None,
                                                    remat_policy=policy or "full"), device="cpu")
    _logits_and_grads(model, ids)
    assert len(seen) == calls * cfg.num_hidden_layers


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


def test_dots_saves_the_matmul_outputs(tiny):
    """The backward of ``dots`` runs 6 dense products a layer fewer than
    ``full``: ``full`` recomputes q, k, v, o, gate and up (the recompute
    stops before down_proj, whose output the backward never reads),
    ``dots`` saved them."""
    *_, cfg, ids = tiny
    counts = {}
    for policy in ("full", "dots"):
        model = tl.LlamaForCausalLM(dataclasses.replace(cfg, remat=True, remat_policy=policy),
                                    device="cpu")
        loss = model(torch.from_numpy(ids)).float().square().mean()
        with _CountMM() as mode:
            loss.backward()
        counts[policy] = mode.mm
    assert counts["full"] - counts["dots"] == 6 * cfg.num_hidden_layers


@pytest.mark.parametrize("bs", [1, 2])
@pytest.mark.parametrize("policy", [None] + POLICIES)
def test_scan_matches_unrolled_bitwise(tiny, bs, policy):
    *_, host, cfg, ids = tiny
    state = torch_state_from_flax(host)
    ref_out, ref_g = _logits_and_grads(_port(cfg, state), ids)
    scfg = dataclasses.replace(cfg, scan_layers=True, scan_block_size=bs,
                               remat=policy is not None, remat_policy=policy or "full",
                               boundary_offload_fraction=0.5)
    model = _port(scfg, tl.stack_layer_params(state, bs))
    out, g = _logits_and_grads(model, ids)
    assert torch.equal(out, ref_out)
    g = tl.unstack_layer_params(g)
    assert sorted(g) == sorted(ref_g)
    for n in ref_g:
        assert torch.equal(g[n], ref_g[n]), n


@pytest.mark.parametrize("bs", [1, 2])
def test_stack_unstack_round_trip_and_equal_jax(tiny, bs):
    *_, host, cfg, _ = tiny
    state = torch_state_from_flax(host)
    stacked = tl.stack_layer_params(state, bs)
    want = torch_state_from_flax(jax.tree.map(np.asarray, jl.stack_layer_params(host, bs)))
    assert sorted(stacked) == sorted(want)
    for n in want:
        assert torch.equal(stacked[n], want[n]), n
    back = tl.unstack_layer_params(stacked)
    assert sorted(back) == sorted(state)
    for n in state:
        assert torch.equal(back[n], state[n])
    assert tl.stack_layer_params({"lm_head.weight": state["lm_head.weight"]}) == \
        {"lm_head.weight": state["lm_head.weight"]}
    with pytest.raises(ValueError, match="scan_block_size"):
        tl.stack_layer_params(state, 3)


def test_jax_scan_tree_converts(tiny):
    """A JAX ``scan_layers=True`` model's tree into the port's scanned
    model: the same logits to 1e-5."""
    jcfg, *_, cfg, ids = tiny
    jscan = jl.LlamaForCausalLM(dataclasses.replace(jcfg, scan_layers=True, scan_block_size=2))
    sparams = jscan.init(jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))
    model = _port(dataclasses.replace(cfg, scan_layers=True, scan_block_size=2),
                  torch_state_from_flax(jax.tree.map(np.asarray, sparams)))
    with torch.no_grad():
        out = model(torch.from_numpy(ids))
    np.testing.assert_allclose(out.numpy(), np.asarray(jscan.apply(sparams, jnp.asarray(ids))),
                               **TOL)


def test_boundary_offload_bytes_and_rows():
    for t, frac, want in ((16, 0.5, 8), (16, 1.0, 16), (16, 0.1, 8), (2048, 0.5, 1024),
                          (8192, 0.3, 2048), (8192, 0.01, 1024), (100, 0.99, 96)):
        assert tl.boundary_offload_rows(t, frac) == want, (t, frac)
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32, num_hidden_layers=4, scan_layers=True,
                              scan_block_size=2, remat=True, remat_policy="offload",
                              boundary_offload_fraction=0.5)
    model = tl.LlamaForCausalLM(cfg, device="cpu")
    ids = torch.zeros(3, 16, dtype=torch.long)
    model(ids).float().sum().backward()
    per = 3 * 8 * cfg.hidden_size * 4      # B x aligned head rows x hidden x f32
    assert model.boundary_stats == {"d2h_bytes": 2 * per, "h2d_bytes": 2 * per}


def _sr8_steps(cfg, state, ids, steps=2):
    model = _port(cfg, state)
    acc = Accelerator(cpu=True)
    st = acc.create_train_state(model, "lion-sr8")
    step = acc.prepare_train_step(tl.make_llama_loss_fn(model, fused_vocab_chunks=2))
    losses = []
    for _ in range(steps):
        st, m = step(st, {"input_ids": torch.from_numpy(ids), "labels": torch.from_numpy(ids)})
        losses.append(m["loss"].item())
    return losses, st


def test_remat_train_steps_bitwise_with_int8_state(tiny):
    """Two lion-sr8 steps from the same state under off / full / dots /
    offload: params, codes and scales bitwise."""
    *_, host, cfg, ids = tiny
    state = {k: v for k, v in torch_state_from_flax(host).items()}
    ref_losses, ref = _sr8_steps(cfg, state, ids)
    for policy in POLICIES:
        losses, st = _sr8_steps(dataclasses.replace(cfg, remat=True, remat_policy=policy),
                                state, ids)
        assert losses == ref_losses
        for n in ref.params:
            assert torch.equal(st.params[n], ref.params[n]), (policy, n)
        for a, b in zip(st.opt_state.mu + st.opt_state.mu_scale,
                        ref.opt_state.mu + ref.opt_state.mu_scale):
            assert torch.equal(a, b), policy


def test_generate_from_scan_layout_params(tiny):
    *_, host, cfg, ids = tiny
    state = torch_state_from_flax(host)
    gc = GenerationConfig(max_new_tokens=4)
    ref = generate(_port(cfg, state), ids[:1, :8], gc)
    for bs in (1, 2):
        scan = _port(dataclasses.replace(cfg, scan_layers=True, scan_block_size=bs),
                     tl.stack_layer_params(state, bs))
        assert torch.equal(generate(scan, ids[:1, :8], gc), ref)


def test_serving_engine_serves_a_scanned_model(tiny):
    *_, host, cfg, _ = tiny
    state = torch_state_from_flax(host)
    geometry = dict(num_slots=4, page_size=4, pages_per_slot=10, num_pages=24, prefill_chunk=8)
    trace = dict(seed=0, n_requests=5, vocab_size=256, prompt_len_range=(4, 12),
                 new_tokens_range=(3, 6))
    results = []
    for model in (_port(cfg, state),
                  _port(dataclasses.replace(cfg, scan_layers=True), tl.stack_layer_params(state))):
        eng = ServingEngine(model, ServingPlugin(**geometry), GenerationConfig(max_new_tokens=8),
                            device="cpu")
        results.append(eng.run(synthesize_trace(**trace)))
    assert results[0] == results[1]


def test_lora_and_scan_refused(tiny):
    *_, cfg, ids = tiny
    model = tl.LlamaForCausalLM(dataclasses.replace(cfg, scan_layers=True), device="cpu")
    with pytest.raises(ValueError, match="scan_layers"):
        model(torch.from_numpy(ids), adapter_ids=torch.zeros(2, dtype=torch.long), lora={})
