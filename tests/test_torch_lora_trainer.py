"""The port's ``LoraTrainer`` (``serving/adapters.py``) held against the JAX
package's.

- Every assertion of JAX's ``test_lora_trainer_batched_step_and_verified_
  checkpoint`` (``tests/test_lora.py:407``) on the port: the batched loss
  equals the per-tenant sequential schedule, a tenant with no rows is left
  bitwise, the int8 optimizer state round-trips bitwise through the
  verified checkpoint, a restored trainer continues bitwise, a torn shard
  raises.
- On the same f32 base and adapters: the port's batched loss equals JAX's
  ``LoraTrainer.step`` loss and each tenant's gradients equal JAX's (1e-5),
  and the per-tenant sequential schedule's (the card's gradient gate).
- Given JAX's gradients, the port's per-tenant ``lion-sr8`` update is
  bitwise JAX's (bf16 adapters, two steps: weights, int8 codes, scales).
- The file layout crosses both ways: in a port-written and in a JAX-written
  directory the ``w/`` entries carry JAX's adapter paths and the same
  values, and each side's verifier accepts the other's manifest.  The
  ``s/`` entries keep each package's own optimizer-state leaves.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu.models import llama as jl
from accelerate_tpu.ops import lora as jlora
from accelerate_tpu.serving import LoraTrainer as JaxLoraTrainer
from accelerate_tpu.utils.dataclasses import LoraPlugin as JaxLoraPlugin
from accelerate_tpu_torch import LlamaConfig, LlamaForCausalLM, LoraPlugin
from accelerate_tpu_torch.checkpointing import CheckpointCorruptError
from accelerate_tpu_torch.models.convert import lora_tree_from_flax, torch_state_from_flax
from accelerate_tpu_torch.ops.lora import adapter_state_accounting
from accelerate_tpu_torch.serving import LoraTrainer
from accelerate_tpu_torch.serving.adapters import _jax_module_path, _state_tensors

PLUGIN = dict(rank=4, kernel="native", optimizer="lion-sr8")


def _plug(**kw):
    return LoraPlugin(**{**PLUGIN, "pool_slots": 3, **kw})


def _jplug(**kw):
    return JaxLoraPlugin(**{**PLUGIN, "pool_slots": 3, **kw})


def _batch(seed=2, shape=(4, 8)):
    toks = np.random.default_rng(seed).integers(1, 255, shape)
    return {"input_ids": toks, "labels": toks}


@pytest.fixture(scope="module")
def port_model():
    return LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")


def _leaves(trainer, tid):
    return [t.clone() for t in trainer._flat(trainer.adapters[tid])]


def test_lora_trainer_batched_step_and_verified_checkpoint(port_model, tmp_path):
    """JAX's test, assertion by assertion, on the port."""
    trainer = LoraTrainer(port_model, _plug())
    for t in (1, 2, 3):
        trainer.add_adapter(t)
    untouched_w = _leaves(trainer, 3)
    untouched_s = [t.clone() for t in _state_tensors(trainer.opt_states[3])]
    batch = _batch()
    seq_loss = trainer.sequential_loss(batch, [1, 2, 0, 1])
    loss = trainer.step(batch, [1, 2, 0, 1])
    assert np.isclose(loss, seq_loss, rtol=1e-2)
    for before, after in zip(untouched_w, _leaves(trainer, 3)):
        assert torch.equal(before, after)
    for before, after in zip(untouched_s, _state_tensors(trainer.opt_states[3])):
        assert torch.equal(before, after)
    assert trainer.opt_states[3].count == 0 and trainer.opt_states[1].count == 1
    rep = trainer.host_state_report()
    assert rep["n_adapters"] == 3 and rep["state_bytes"] > 0

    ck = tmp_path / "adapters_ck"
    trainer.save(str(ck))
    assert not (tmp_path / "adapters_ck.tmp").exists()
    restored = LoraTrainer(port_model, _plug())
    assert restored.load(str(ck)) == [1, 2, 3]
    for t in (1, 2, 3):
        for a, b in zip(trainer._flat(trainer.adapters[t]),
                        restored._flat(restored.adapters[t])):
            assert a.dtype == b.dtype and torch.equal(a, b)
        sa, sb = trainer.opt_states[t], restored.opt_states[t]
        assert sa.count == sb.count
        for a, b in zip(_state_tensors(sa), _state_tensors(sb)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        for k, v in sa.hyperparams.items():
            w = sb.hyperparams[k]
            assert (torch.equal(v, w) if isinstance(v, torch.Tensor) else v == w), k
    assert trainer.step(batch, [1, 2, 0, 1]) == restored.step(batch, [1, 2, 0, 1])
    trainer.save(str(ck))
    assert LoraTrainer(port_model, _plug()).load(str(ck)) == [1, 2, 3]

    shard = sorted(ck.glob("adapter_*.npz"))[0]
    shard.write_bytes(shard.read_bytes()[:-16])
    with pytest.raises(CheckpointCorruptError):
        LoraTrainer(port_model, _plug()).load(str(ck))


def test_lora_trainer_guards_and_report(port_model):
    trainer = LoraTrainer(port_model, _plug(pool_slots=2))
    with pytest.raises(ValueError, match=">= 1"):
        trainer.add_adapter(0)
    for t in (1, 2, 3):
        trainer.add_adapter(t)
    with pytest.raises(KeyError):
        trainer.step(_batch(), [1, 9, 0, 1])
    with pytest.raises(ValueError, match="pool_slots"):
        trainer.step(_batch(), [1, 2, 3, 0])
    rep = trainer.host_state_report()
    pred = adapter_state_accounting(trainer.spec, 4, 3, optimizer="lion-sr8")
    assert rep["weight_bytes"] == pred["weight_bytes_per_adapter"] * 3
    # the int8 codes + f32 block scales: within 10 % of the ladder's 8.1 B/param
    # (whose 4 bf16 weight bytes the report counts as weights)
    state_per_param = rep["state_bytes"] / (3 * pred["params_per_adapter"])
    assert 1.0 <= state_per_param <= 1.2
    # base rows only: nothing moves
    before = _leaves(trainer, 1)
    loss = trainer.step(_batch(), [0, 0, 0, 0])
    assert math.isfinite(loss) and trainer.step_log["tenants"] == 0
    assert all(torch.equal(a, b) for a, b in zip(before, _leaves(trainer, 1)))


@pytest.fixture(scope="module")
def f32_pair():
    jmodel = jl.LlamaForCausalLM(jl.LlamaConfig.tiny(dtype=jnp.float32))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tmodel = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32), device="cpu")
    tmodel.load_state_dict(torch_state_from_flax(jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel


def _same_adapters(jtrainer, trainer, tids, dtype):
    """JAX-drawn adapters (b normal, so ``a`` has a gradient too) set on
    both trainers."""
    for t in tids:
        jtrainer.add_adapter(t)
        trainer.add_adapter(t)
        tree = jlora.init_adapter_params(jax.random.PRNGKey(50 + t), jtrainer.spec, 4,
                                         init_b="normal", dtype=dtype)
        jtrainer.adapters[t] = tree
        port = lora_tree_from_flax(jax.tree.map(np.asarray, tree))
        for name, fac in trainer.adapters[t].items():
            for f in ("a", "b"):
                fac[f].copy_(port[name][f])


def test_batched_loss_and_tenant_grads_match_jax(f32_pair):
    jmodel, params, tmodel = f32_pair
    jtrainer = JaxLoraTrainer(jmodel, params, _jplug())
    trainer = LoraTrainer(tmodel, _plug())
    _same_adapters(jtrainer, trainer, (1, 2, 3), jnp.float32)
    batch = _batch(seed=7)
    ids = [2, 0, 1, 2]
    loss, grads = trainer.tenant_grads(batch, ids)
    # JAX's gradients on its stacked pool, sliced per tenant as its step does
    slot_of = {1: 1, 2: 2}
    pool = jtrainer._stack([1, 2])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jtrainer._grad_step(params, pool, jbatch,
                                        jnp.asarray([slot_of.get(t, 0) for t in ids], jnp.int32))
    assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss))
    for t in (1, 2):
        want = lora_tree_from_flax(jax.tree.map(lambda x, t=t: np.asarray(x[slot_of[t]]),
                                                jgrads))
        for name, fac in grads[t].items():
            for f in ("a", "b"):
                ref = want[name][f]
                scale = float(ref.abs().max())
                assert scale > 0
                assert float((fac[f] - ref).abs().max()) <= 1e-5 * scale, (t, name, f)
    # and JAX's own step reports the same batched loss
    assert abs(jtrainer.step(jbatch, ids) - loss) <= 1e-5 * abs(loss)


def _worst_rel_err(grads, ref) -> float:
    return max(float((grads[t][n][f] - ref[t][n][f]).norm() / ref[t][n][f].norm())
               for t in ref for n in ref[t] for f in ("a", "b"))


def test_sequential_grads_match_the_batched_grads(f32_pair):
    """Each tenant's gradients from its rows alone equal its slice of the
    batched backward (1e-5), where a tenant shares its slot between rows;
    the same comparison against a schedule that drops a shared row or
    swaps two tenants' rows is far off, so it sees those faults."""
    jmodel, params, tmodel = f32_pair
    jtrainer = JaxLoraTrainer(jmodel, params, _jplug())
    trainer = LoraTrainer(tmodel, _plug())
    _same_adapters(jtrainer, trainer, (1, 2), jnp.float32)
    batch = _batch(seed=9)
    ids = [2, 0, 1, 2]
    _, grads = trainer.tenant_grads(batch, ids)
    seq = trainer.sequential_grads(batch, ids)
    assert sorted(seq) == [1, 2]
    assert _worst_rel_err(grads, seq) <= 1e-5
    assert _worst_rel_err(grads, trainer.sequential_grads(batch, [2, 0, 1, 0])) > 0.1
    swapped = trainer.sequential_grads(batch, ids)
    swapped[1], swapped[2] = swapped[2], swapped[1]
    assert _worst_rel_err(grads, swapped) > 0.1


def test_tenant_update_bitwise_jax_given_its_grads():
    """bf16 adapters, lion-sr8: two updates per tenant from JAX's gradients
    give JAX's weights, int8 codes and block scales bit for bit."""
    jmodel = jl.LlamaForCausalLM(jl.LlamaConfig.tiny())
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tmodel = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    tmodel.load_state_dict(torch_state_from_flax(jax.tree.map(np.asarray, params)))
    jtrainer = JaxLoraTrainer(jmodel, params, _jplug(), seed=3)
    trainer = LoraTrainer(tmodel, _plug(), seed=3)
    _same_adapters(jtrainer, trainer, (1, 2), jnp.bfloat16)
    rng = np.random.default_rng(11)
    for t in (1, 2):
        state = trainer.opt_states[t]
        for _ in range(2):
            g = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape) * 1e-2,
                                                   jnp.float32), jtrainer.adapters[t])
            # JAX's recipe op by op (its trainer jits it, and XLA's CPU
            # fusion may contract b2 * m + (1 - b2) * g into one FMA)
            updates, new_s = jtrainer.tx.update(g, jtrainer.opt_states[t], jtrainer.adapters[t])
            new_p = optax.apply_updates(jtrainer.adapters[t], updates)
            jtrainer.adapters[t], jtrainer.opt_states[t] = new_p, new_s
            g_port = trainer._flat(lora_tree_from_flax(jax.tree.map(np.asarray, g)))
            got_p, state = trainer.tx.update(g_port, state, trainer._flat(trainer.adapters[t]))
            trainer.adapters[t] = trainer._tree(got_p)
        want_p = trainer._flat(lora_tree_from_flax(jax.tree.map(np.asarray,
                                                                jtrainer.adapters[t])))
        for a, b in zip(trainer._flat(trainer.adapters[t]), want_p):
            assert a.dtype == torch.bfloat16 and torch.equal(a, b)
        js = jtrainer.opt_states[t]
        for got, want in ((state.mu, js.mu), (state.mu_scale, js.mu_scale)):
            want = trainer._flat(lora_tree_from_flax(jax.tree.map(np.asarray, want)))
            for a, b in zip(got, want):
                assert torch.equal(a, b.reshape(a.shape))
        assert state.count == int(js.count) == 2


def test_checkpoint_layout_crosses_both_ways(f32_pair, tmp_path):
    """The ``w/`` entries are JAX's names and values both ways; the
    manifest verifies either side's directory."""
    jmodel, params, tmodel = f32_pair
    jtrainer = JaxLoraTrainer(jmodel, params, _jplug())
    trainer = LoraTrainer(tmodel, _plug())
    _same_adapters(jtrainer, trainer, (1, 2), jnp.float32)
    trainer.save(str(tmp_path / "port"))
    jtrainer.save(str(tmp_path / "jax"))
    for side in ("port", "jax"):
        for t in (1, 2):
            with np.load(tmp_path / side / f"adapter_{t}.npz") as z:
                w = {k[2:]: z[k] for k in z.files if k.startswith("w/")}
            want = {f"{_jax_module_path(name)}/{f}": trainer.adapters[t][name][f].numpy()
                    for name, f in trainer.leaves}
            assert set(w) == set(want), side
            for k, v in want.items():
                np.testing.assert_array_equal(w[k], v, err_msg=f"{side} {k}")
    from accelerate_tpu.checkpointing import verify_checkpoint as jax_verify
    from accelerate_tpu_torch.checkpointing import verify_checkpoint

    assert jax_verify(str(tmp_path / "port"))[0] and verify_checkpoint(str(tmp_path / "jax"))[0]
