"""The port's ZeRO-offload train step (``Accelerator`` with
``FullyShardedDataParallelPlugin(cpu_offload=True)``) and the chunked
update's pieces (``ops/streaming.py``) held against the resident step and
against the JAX package.

On the CPU the host is the device, so the transfers are the identity, but
the offloaded step's whole path runs: the compute-copy fetch, the staging,
the host update over leaf groups with group-relative SR salts, the
host-side global norm, the merge.  Within torch every offload-vs-resident
and pipelined-vs-serial comparison is bitwise (JAX's own tests allow an ulp
where XLA fuses two programs differently; eager torch runs the same ops).
Against JAX: ``chunk_groups`` and ``offload_transfer_accounting`` exactly,
and the chunked lion-sr8 run bitwise against JAX's chunked update from the
same gradients (a loss linear in the params); adamw-sr8
at the log map's settled terms (``tests/test_torch_int8_state.py``).  The
JAX tests of ``tests/test_offload.py`` run here in torch form but
``test_host_constant_hoist`` and the adafactor case (XLA's host-region
constants; the port has no such rule and no adafactor recipe).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.ops import streaming as jst
from accelerate_tpu_torch import Accelerator, GradientAccumulationPlugin, GradSyncKwargs
from accelerate_tpu_torch.ops import streaming as tst
from accelerate_tpu_torch.ops.stochastic_rounding import adamw_bf16_sr, lion_bf16_sr
from accelerate_tpu_torch.optimizer import adamw, lion
from accelerate_tpu_torch.utils.dataclasses import FullyShardedDataParallelPlugin


def _mlp_params(seed=0, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return {"dense.kernel": (torch.randn(8, 64, generator=gen) * 0.1).to(dtype),
            "dense.bias": torch.zeros(64, dtype=dtype),
            "out.kernel": (torch.randn(64, 1, generator=gen) * 0.1).to(dtype),
            "out.bias": torch.zeros(1, dtype=dtype)}


def _mlp_loss(p, batch):
    h = torch.tanh(batch["x"] @ p["dense.kernel"].to(batch["x"].dtype)
                   + p["dense.bias"].to(batch["x"].dtype))
    pred = (h @ p["out.kernel"].to(h.dtype) + p["out.bias"].to(h.dtype))[..., 0]
    return ((pred.float() - batch["y"]) ** 2).mean()


def _batches(n=6, bs=16, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.normal(size=(bs, 8)).astype(np.float32)
        out.append({"x": torch.from_numpy(x), "y": torch.from_numpy((x.sum(-1) * 0.5)
                                                                    .astype(np.float32))})
    return out


def _run(offload, accum_plugin=None, mixed_precision="no", n_steps=6, chunk_gib=None,
         tx=None, max_grad_norm=1.0, kwargs_handlers=None, pipeline=True, params=None,
         keep=False):
    plugin = FullyShardedDataParallelPlugin(cpu_offload=offload,
                                            host_update_chunk_gib=chunk_gib,
                                            host_update_pipeline=pipeline)
    acc = Accelerator(cpu=True, fsdp_plugin=plugin, gradient_accumulation_plugin=accum_plugin,
                      mixed_precision=mixed_precision, kwargs_handlers=kwargs_handlers)
    tx = tx if tx is not None else adamw(1e-2, weight_decay=1e-4)
    state = acc.create_train_state(params if params is not None else _mlp_params(),
                                   acc.prepare_optimizer(tx))
    step = acc.prepare_train_step(_mlp_loss, max_grad_norm=max_grad_norm)
    losses = []
    for batch in _batches(n=n_steps):
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
    out = {n: p.clone() for n, p in state.params.items()}
    return (losses, out, state, acc) if keep else (losses, out)


def _equal(a: dict, b: dict):
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_offload_matches_resident_simple():
    losses_res, params_res = _run(offload=False)
    losses_off, params_off = _run(offload=True)
    assert losses_off == losses_res
    _equal(params_off, params_res)


def test_offload_matches_resident_across_steps_accum():
    plugin = GradientAccumulationPlugin(num_steps=3, mode="across_steps")
    losses_res, params_res = _run(offload=False, accum_plugin=plugin)
    losses_off, params_off = _run(offload=True, accum_plugin=GradientAccumulationPlugin(
        num_steps=3, mode="across_steps"))
    assert losses_off == losses_res
    _equal(params_off, params_res)


def test_offload_with_bf16_grads_tracks_resident():
    losses_res, params_res = _run(offload=False, mixed_precision="bf16", max_grad_norm=None)
    losses_off, params_off = _run(offload=True, mixed_precision="bf16", max_grad_norm=None,
                                  kwargs_handlers=[GradSyncKwargs(grad_dtype="bf16")])
    np.testing.assert_allclose(losses_off, losses_res, rtol=5e-2)
    for k in params_res:
        np.testing.assert_allclose(params_off[k].float().numpy(), params_res[k].float().numpy(),
                                   rtol=0.1, atol=5e-3)


def test_offload_matches_resident_in_step_accum():
    losses_res, params_res = _run(offload=False, accum_plugin=GradientAccumulationPlugin(
        num_steps=4))
    losses_off, params_off = _run(offload=True, accum_plugin=GradientAccumulationPlugin(
        num_steps=4))
    assert losses_off == losses_res
    _equal(params_off, params_res)


@pytest.mark.parametrize("pipeline", [False, True])
def test_chunked_host_update_matches_monolithic(pipeline):
    """A chunk budget of one leaf per group (4 groups for the MLP) against
    one group: adamw is per-leaf independent and salt-free, so bitwise."""
    losses_mono, params_mono = _run(offload=True)
    losses_chunk, params_chunk = _run(offload=True, chunk_gib=1e-6, pipeline=pipeline)
    assert losses_chunk == losses_mono
    _equal(params_chunk, params_mono)


def test_chunked_host_update_matches_resident():
    losses_res, params_res = _run(offload=False)
    losses_chunk, params_chunk = _run(offload=True, chunk_gib=1e-6)
    assert losses_chunk == losses_res
    _equal(params_chunk, params_res)


def test_chunked_host_update_unclipped_and_logged():
    losses, params, state, acc = _run(offload=True, chunk_gib=1e-6, max_grad_norm=None,
                                      keep=True)
    losses_res, params_res = _run(offload=False, max_grad_norm=None)
    assert np.isfinite(losses).all() and losses == losses_res
    _equal(params, params_res)
    log = acc.offload_log
    n_bytes = sum(p.numel() * p.element_size() for p in state.params.values())
    assert log["groups"] == len(tst.chunk_groups(state.params, int(1e-6 * 2**30))) == 3
    assert log["d2h_bytes"] == n_bytes
    assert log["h2d_bytes"] == n_bytes    # offload_params follows cpu_offload
    assert log["host_update_ms"] > 0


def test_offload_with_fp16_loss_scaling():
    losses, _ = _run(offload=True, mixed_precision="fp16", n_steps=8)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_offload_plugin_flag_resolution():
    assert FullyShardedDataParallelPlugin(cpu_offload=True).offload_params is True
    p2 = FullyShardedDataParallelPlugin(cpu_offload=True, offload_params=False)
    assert p2.offload_params is False
    assert FullyShardedDataParallelPlugin().cpu_offload is False
    # params kept on the device: the host update still matches resident
    acc = Accelerator(cpu=True, fsdp_plugin=p2)
    assert acc._offload_flags() == (True, False)
    losses_res, params_res = _run(offload=False)
    plugin = FullyShardedDataParallelPlugin(cpu_offload=True,
                                            offload_params=False)
    acc = Accelerator(cpu=True, fsdp_plugin=plugin)
    state = acc.create_train_state(_mlp_params(), acc.prepare_optimizer(
        adamw(1e-2, weight_decay=1e-4)))
    step = acc.prepare_train_step(_mlp_loss, max_grad_norm=1.0)
    for batch in _batches():
        state, _ = step(state, batch)
    _equal({k: v.clone() for k, v in state.params.items()}, params_res)


def test_offload_state_checkpoint_roundtrip(tmp_path):
    plugin = FullyShardedDataParallelPlugin(cpu_offload=True)
    acc = Accelerator(cpu=True, fsdp_plugin=plugin, project_dir=str(tmp_path))
    state = acc.create_train_state(_mlp_params(), acc.prepare_optimizer(
        adamw(1e-2, weight_decay=1e-4)))
    step = acc.prepare_train_step(_mlp_loss, max_grad_norm=1.0)
    batches = _batches()
    for batch in batches[:3]:
        state, _ = step(state, batch)
    path = acc.save_state(train_state=state)
    template = acc.create_train_state(_mlp_params(seed=3), acc.prepare_optimizer(
        adamw(1e-2, weight_decay=1e-4)))
    restored = acc.load_state(path, train_state=template)
    _equal(restored.params, state.params)
    for a, b in zip(restored.opt_state.mu + restored.opt_state.nu,
                    state.opt_state.mu + state.opt_state.nu):
        assert torch.equal(a, b)
    a, _ = step(state, batches[3])
    b, _ = step(restored, batches[3])
    _equal(a.params, b.params)


@pytest.mark.parametrize("make_tx, ref", [(lion_bf16_sr, "lion"), (adamw_bf16_sr, "adamw")])
def test_offload_sr_bf16_masters_trains(make_tx, ref):
    """The -sr recipes on bf16 params through the offload machinery:
    offload == resident bitwise, the SR recipe tracks its f32 reference at
    the same hyperparameters, and the chunked run trains."""
    def run(offload, chunk_gib=None):
        return _run(offload, mixed_precision="bf16", chunk_gib=chunk_gib, tx=make_tx(3e-3),
                    max_grad_norm=None, kwargs_handlers=[GradSyncKwargs(grad_dtype="bf16")],
                    params=_mlp_params(dtype=torch.bfloat16))

    losses_res, params_res = run(False)
    losses_off, params_off = run(True)
    assert params_res["dense.kernel"].dtype == torch.bfloat16
    assert losses_off == losses_res
    _equal(params_off, params_res)
    ref_tx = (lion(3e-3, b1=0.9, b2=0.99, weight_decay=0.0, mu_dtype=torch.bfloat16)
              if ref == "lion" else adamw(3e-3, weight_decay=0.0))
    ref_losses, _ = _run(False, mixed_precision="bf16", tx=ref_tx, max_grad_norm=None)
    np.testing.assert_allclose(losses_res, ref_losses, rtol=0.35)
    losses_chunk, params_chunk = run(True, chunk_gib=1e-6)
    assert params_chunk["dense.kernel"].dtype == torch.bfloat16
    assert np.isfinite(losses_chunk).all()
    np.testing.assert_allclose(losses_chunk, ref_losses, rtol=0.35)


def _run_sr8(recipe, offload, chunk_gib=None, pipeline=True):
    plugin = FullyShardedDataParallelPlugin(cpu_offload=offload,
                                            host_update_chunk_gib=chunk_gib,
                                            host_update_pipeline=pipeline)
    acc = Accelerator(cpu=True, fsdp_plugin=plugin, mixed_precision="bf16",
                      kwargs_handlers=[GradSyncKwargs(grad_dtype="bf16")])
    state = acc.create_train_state(_mlp_params(dtype=torch.bfloat16),
                                   acc.prepare_optimizer(recipe))
    step = acc.prepare_train_step(_mlp_loss)
    losses = []
    for batch in _batches():
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())
    opt = [t.clone() for field in state.opt_state if isinstance(field, list) for t in field]
    return losses, {n: p.clone() for n, p in state.params.items()}, opt


def _equal_lists(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_pipelined_offload_update_matches_serial_bitwise():
    losses_ser, params_ser = _run(offload=True, chunk_gib=1e-6, pipeline=False)
    losses_pipe, params_pipe = _run(offload=True, chunk_gib=1e-6, pipeline=True)
    assert losses_pipe == losses_ser
    _equal(params_pipe, params_ser)


@pytest.mark.parametrize("recipe", ["lion-sr8", "adamw-sr8"])
def test_pipelined_offload_sr8_matches_serial_bitwise(recipe):
    losses_ser, params_ser, opt_ser = _run_sr8(recipe, True, chunk_gib=1e-6, pipeline=False)
    losses_pipe, params_pipe, opt_pipe = _run_sr8(recipe, True, chunk_gib=1e-6, pipeline=True)
    assert losses_pipe == losses_ser
    _equal(params_pipe, params_ser)
    _equal_lists(opt_pipe, opt_ser)


def test_pipelined_offload_with_clipping_matches_serial():
    losses_ser, params_ser = _run(offload=True, chunk_gib=1e-6, pipeline=False, max_grad_norm=1.0)
    losses_pipe, params_pipe = _run(offload=True, chunk_gib=1e-6, pipeline=True,
                                    max_grad_norm=1.0)
    assert losses_pipe == losses_ser
    _equal(params_pipe, params_ser)


@pytest.mark.parametrize("recipe", ["lion-sr8", "adamw-sr8"])
def test_offload_sr8_matches_resident_bitwise(recipe):
    losses_res, params_res, opt_res = _run_sr8(recipe, offload=False)
    losses_off, params_off, opt_off = _run_sr8(recipe, offload=True)
    assert params_res["dense.kernel"].dtype == torch.bfloat16
    assert losses_off == losses_res
    _equal(params_off, params_res)
    _equal_lists(opt_off, opt_res)
    assert opt_off[0].dtype == torch.int8
    losses_chunk, params_chunk, _ = _run_sr8(recipe, offload=True, chunk_gib=1e-6)
    assert params_chunk["dense.kernel"].dtype == torch.bfloat16
    assert np.isfinite(losses_chunk).all()
    np.testing.assert_allclose(losses_chunk, losses_res, rtol=0.35)


# -- the pieces against JAX ------------------------------------------------------


def test_chunk_groups_and_accounting_equal_jax():
    from accelerate_tpu.models import llama as jl
    from accelerate_tpu_torch.models.convert import torch_state_from_flax
    from accelerate_tpu_torch.ops.stochastic_rounding import flax_leaf_order

    cfg = jl.LlamaConfig.tiny(num_hidden_layers=11)
    params = jl.LlamaForCausalLM(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    state = torch_state_from_flax(jax.tree.map(np.asarray, params))
    ordered = {n: state[n] for n in flax_leaf_order(state)}
    for chunk in (1, 4096, 65536, 1 << 20, 1 << 30):
        for itemsize in (2, 4):
            assert tst.chunk_groups(ordered, chunk, itemsize) == jst.chunk_groups(
                params, chunk, itemsize)
    for kw in (dict(), dict(optimizer="lion-sr8", offload_params=False),
               dict(optimizer="adamw-sr8", grad_bytes_per_param=4, host_rate_gibs=3.0)):
        assert tst.offload_transfer_accounting(614_000_000, **kw) == \
            jst.offload_transfer_accounting(614_000_000, **kw)


def test_slice_and_merge_congruent_round_trip():
    from accelerate_tpu_torch.ops.int8_state import lion_int8_sr

    leaves = [torch.randn(3, 4).bfloat16() for _ in range(5)]
    tx = lion_int8_sr(block_size=4)
    st = tx.init(leaves)
    groups = tst.chunk_groups(leaves, 24)
    assert groups == [[0], [1], [2], [3], [4]]
    groups = tst.chunk_groups(leaves, 100)
    subs = [tst.slice_congruent(st, 5, g) for g in groups]
    assert [len(s.mu) for s in subs] == [len(g) for g in groups]
    assert all(s.hyperparams is st.hyperparams and s.count == st.count for s in subs)
    merged = tst.merge_congruent(st, subs, 5, groups)
    assert type(merged) is type(st)
    for a, b in zip(merged.mu + merged.mu_scale, st.mu + st.mu_scale):
        assert a is b
    assert tst.slice_congruent(leaves, 5, [4, 1]) == [leaves[4], leaves[1]]


def _jax_chunked_run(recipe, chunk_bytes, grads_np, params_np):
    """JAX's chunked host update (its accelerator's group loop: the
    package's ``chunk_groups`` / ``slice_congruent`` / ``merge_congruent``
    around the recipe's update), run op by op on the bf16-rounded
    gradients a compute-width step gives."""
    import optax

    from accelerate_tpu.optimizer import make_optimizer as jax_make_optimizer

    tx = jax_make_optimizer(recipe)
    params = {k: {kk: jnp.asarray(v, jnp.bfloat16) for kk, v in d.items()}
              for k, d in params_np.items()}
    opt = tx.init(params)
    treedef = jax.tree_util.tree_structure(params)
    groups = jst.chunk_groups(params, chunk_bytes)
    for g in grads_np:
        grads = {k: {kk: jnp.asarray(g[f"{k}.{kk}"], jnp.bfloat16) for kk in d}
                 for k, d in params_np.items()}
        outs = []
        for idxs in groups:
            g_params = jst.slice_congruent(params, treedef, idxs)
            updates, g_opt = tx.update(jst.slice_congruent(grads, treedef, idxs),
                                       jst.slice_congruent(opt, treedef, idxs), g_params)
            outs.append((optax.apply_updates(g_params, updates), g_opt))
        params = jst.merge_congruent(params, [o[0] for o in outs], treedef, groups)
        opt = jst.merge_congruent(opt, [o[1] for o in outs], treedef, groups)
    return params, opt


@pytest.mark.parametrize("recipe", ["lion-sr8", "adamw-sr8"])
def test_chunked_sr8_offload_equals_jax_chunked(recipe):
    """Group-relative salts as in JAX: three chunked offloaded steps of a
    loss linear in the params (its compute-width gradients are the bf16
    coefficients in both frameworks) give the params, codes and scales of
    JAX's chunked update — bitwise for lion-sr8, at the log map's terms
    for adamw-sr8.  JAX's update runs op by op: its jitted step fuses the
    momentum's multiply-add, which rounds differently from step 2 on
    (ROADMAP Queue C)."""
    rng = np.random.default_rng(0)
    shapes = {"dense": {"bias": (64,), "kernel": (8, 64)}, "out": {"bias": (1,),
                                                                   "kernel": (64, 1)}}
    params_np = {k: {kk: (rng.normal(size=s) * 0.1).astype(np.float32) for kk, s in d.items()}
                 for k, d in shapes.items()}
    grads_np = [{f"{k}.{kk}": rng.normal(size=s).astype(np.float32)
                 for k, d in shapes.items() for kk, s in d.items()} for _ in range(3)]
    jp, jopt = _jax_chunked_run(recipe, int(1e-6 * 2**30), grads_np, params_np)

    acc = Accelerator(cpu=True, mixed_precision="bf16",
                      kwargs_handlers=[GradSyncKwargs(grad_dtype="bf16")],
                      fsdp_plugin=FullyShardedDataParallelPlugin(
                          cpu_offload=True, host_update_chunk_gib=1e-6))
    tparams = {f"{k}.{kk}": torch.from_numpy(v).bfloat16()
               for k, d in params_np.items() for kk, v in d.items()}
    state = acc.create_train_state(tparams, acc.prepare_optimizer(recipe))

    def loss(p, batch):
        return sum((p[n].float() * batch[n]).sum() for n in p)

    step = acc.prepare_train_step(loss)
    for g in grads_np:
        state, _ = step(state, {k: torch.from_numpy(v) for k, v in g.items()})
    got = np.concatenate([p.float().numpy().ravel() for p in state.params.values()])
    want = np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree_util.tree_leaves(jp)])
    fields = [("mu", jopt.mu, state.opt_state.mu),
              ("mu_scale", jopt.mu_scale, state.opt_state.mu_scale)]
    if recipe == "adamw-sr8":
        fields += [("nu", jopt.nu, state.opt_state.nu)]
    for label, jm, tm in fields:
        a = np.concatenate([np.asarray(x).astype(np.float64).ravel()
                            for x in jax.tree_util.tree_leaves(jm)])
        b = np.concatenate([x.double().numpy().ravel() for x in tm])
        if recipe == "lion-sr8":
            np.testing.assert_array_equal(b, a, err_msg=label)
        elif label.endswith("scale"):
            np.testing.assert_allclose(b, a, rtol=2 ** -6)
        else:
            assert (a == b).mean() > 0.97 and np.abs(a - b).max() <= 1
    if recipe == "lion-sr8":
        np.testing.assert_array_equal(got, want)
    else:
        assert (got == want).mean() > 0.97
        np.testing.assert_allclose(got, want, rtol=2 ** -7)
