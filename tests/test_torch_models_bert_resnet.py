"""The port's BERT and ResNet (``models/bert.py``, ``models/resnet.py``),
their converters and the HF BERT loader, held against the JAX package's
flax modules on the same seeded weights and inputs.

f32 models at 1e-5 (the JAX package's tolerance for its own f32 paths),
bf16 at 2e-2 of the largest |logit| (one bf16 rounding per layer input).
The ResNet's new running averages (flax's ``batch_stats``, the port's
train-step aux) at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models.bert import BertConfig as JBertConfig
from accelerate_tpu.models.bert import BertForSequenceClassification as JBert
from accelerate_tpu.models.bert import make_bert_loss_fn as j_bert_loss
from accelerate_tpu.models.hf_interop import load_hf_bert as j_load_hf_bert
from accelerate_tpu.models.resnet import ResNet as JResNet
from accelerate_tpu.models.resnet import ResNetConfig as JResNetConfig
from accelerate_tpu.models.resnet import make_resnet_loss_fn as j_resnet_loss
from accelerate_tpu_torch.big_modeling import abstract_init
from accelerate_tpu_torch.models import (
    BertConfig,
    BertForSequenceClassification,
    ResNet,
    ResNetConfig,
    hf_bert_key_map,
    load_hf_bert,
    make_bert_loss_fn,
    make_resnet_loss_fn,
    torch_state_from_flax_bert,
    torch_state_from_flax_resnet,
)
from accelerate_tpu_torch.models.convert import resnet_batch_stats_from_flax
from accelerate_tpu_torch.utils.serialization import save_safetensors


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _bert_pair(dtype_j, dtype_t, token_types=False, seed=0):
    jcfg = JBertConfig.tiny(dtype=dtype_j)
    jmodel = JBert(jcfg)
    ids = jnp.zeros((1, 8), jnp.int32)
    args = (ids, jnp.ones_like(ids)) + ((jnp.zeros_like(ids),) if token_types else ())
    params = jmodel.init(jax.random.PRNGKey(seed), *args)
    tmodel = BertForSequenceClassification(BertConfig.tiny(dtype=dtype_t), device="cpu")
    state = torch_state_from_flax_bert(_np(params))
    missing, unexpected = tmodel.load_state_dict(state, strict=False)
    assert not unexpected
    assert missing == ([] if token_types else ["token_type_embeddings.weight"])
    return jmodel, params, tmodel


def _bert_inputs(seed=1, b=3, t=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 512, (b, t))
    mask = np.ones((b, t), np.int64)
    mask[1, 9:] = 0          # a padded row
    types = (np.arange(t)[None, :] >= t // 2).astype(np.int64).repeat(b, 0)
    labels = rng.integers(0, 2, (b,))
    return ids, mask, types, labels


@pytest.mark.parametrize("token_types", [False, True])
def test_bert_logits_and_loss_match_flax_f32(token_types):
    jmodel, params, tmodel = _bert_pair(jnp.float32, torch.float32, token_types)
    ids, mask, types, labels = _bert_inputs()
    jkw = dict(token_type_ids=jnp.asarray(types)) if token_types else {}
    want = np.asarray(jmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask), **jkw))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids), torch.from_numpy(mask),
                     torch.from_numpy(types) if token_types else None).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    batch = {"input_ids": ids, "attention_mask": mask, "labels": labels,
             **({"token_type_ids": types} if token_types else {})}
    jl = float(j_bert_loss(jmodel)(params, {k: jnp.asarray(v) for k, v in batch.items()}))
    tl = float(make_bert_loss_fn(tmodel)(None, {k: torch.from_numpy(v)
                                               for k, v in batch.items()}))
    assert abs(tl - jl) <= 1e-5 * max(1.0, abs(jl))


def test_bert_logits_match_flax_bf16():
    jmodel, params, tmodel = _bert_pair(jnp.bfloat16, torch.bfloat16)
    ids, mask, _, _ = _bert_inputs(seed=4)
    want = np.asarray(jmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask)), np.float32)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids), torch.from_numpy(mask)).float().numpy()
    assert np.abs(got - want).max() <= 2e-2 * max(1.0, np.abs(want).max())


def test_bert_gradients_match_flax_f32():
    jmodel, params, tmodel = _bert_pair(jnp.float32, torch.float32)
    ids, mask, _, labels = _bert_inputs(seed=5)
    jbatch = {"input_ids": jnp.asarray(ids), "attention_mask": jnp.asarray(mask),
              "labels": jnp.asarray(labels)}
    jgrads = jax.grad(j_bert_loss(jmodel))(params, jbatch)
    want = torch_state_from_flax_bert(_np(jgrads))
    params_t = {n: p.detach().requires_grad_() for n, p in tmodel.named_parameters()}
    loss = make_bert_loss_fn(tmodel)(params_t, {"input_ids": torch.from_numpy(ids),
                                                "attention_mask": torch.from_numpy(mask),
                                                "labels": torch.from_numpy(labels)})
    names = list(want)
    grads = torch.autograd.grad(loss, [params_t[n] for n in names])
    for n, g in zip(names, grads):
        ref = want[n]
        assert torch.allclose(g, ref, rtol=1e-4, atol=1e-6), n


def _resnet_pair(dtype_j, dtype_t, seed=0, hw=16):
    jmodel = JResNet(JResNetConfig.tiny(dtype=dtype_j))
    variables = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, hw, hw, 3), jnp.float32),
                            train=False)
    # running averages away from their init, so the fold is visible
    rng = np.random.default_rng(seed + 7)
    variables = {"params": variables["params"], "batch_stats": jax.tree.map(
        lambda x: jnp.asarray(rng.uniform(0.5, 1.5, x.shape), jnp.float32),
        variables["batch_stats"])}
    tmodel = ResNet(ResNetConfig.tiny(dtype=dtype_t), device="cpu")
    tmodel.load_state_dict(torch_state_from_flax_resnet(_np(variables)), strict=True)
    return jmodel, variables, tmodel


def _images(seed=3, b=4, hw=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hw, hw, 3)).astype(np.float32),
            rng.integers(0, 10, (b,)))


@pytest.mark.parametrize("hw", [16, 15])
def test_resnet_eval_logits_match_flax_f32(hw):
    jmodel, variables, tmodel = _resnet_pair(jnp.float32, torch.float32, hw=hw)
    images, _ = _images(hw=hw)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(images), train=False))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(images), train=False).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_resnet_train_loss_and_batch_stats_match_flax_f32():
    jmodel, variables, tmodel = _resnet_pair(jnp.float32, torch.float32)
    images, labels = _images()
    jloss, jstats = j_resnet_loss(jmodel)(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]},
        {"image": jnp.asarray(images), "label": jnp.asarray(labels)})
    tloss, tstats = make_resnet_loss_fn(tmodel)(
        None, {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)})
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * max(1.0, abs(float(jloss)))
    want = resnet_batch_stats_from_flax(_np(jstats))
    assert set(tstats) == set(want)
    for name, s in want.items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(tstats[name][k].numpy(), s[k].numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=f"{name}.{k}")
    # folding the stats back gives the flax model's next running averages
    tmodel.load_batch_stats(tstats)
    folded = {"params": variables["params"], "batch_stats": jstats}
    want_eval = np.asarray(jmodel.apply(folded, jnp.asarray(images), train=False))
    with torch.no_grad():
        got_eval = tmodel(torch.from_numpy(images), train=False).numpy()
    np.testing.assert_allclose(got_eval, want_eval, rtol=1e-4, atol=1e-5)


def test_resnet_logits_match_flax_bf16():
    jmodel, variables, tmodel = _resnet_pair(jnp.bfloat16, torch.bfloat16)
    images, _ = _images(seed=8)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(images), train=False), np.float32)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(images), train=False).float().numpy()
    assert np.abs(got - want).max() <= 2e-2 * max(1.0, np.abs(want).max())


def _hf_bert_state(seed=2):
    """A tiny random HF BERT sequence classifier's ``state_dict`` (HF's
    names and ``[out, in]`` layout), drawn with numpy."""
    rng = np.random.default_rng(seed)
    h, f, v, p, n = 64, 128, 512, 128, 2

    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.05)

    state = {"bert.embeddings.word_embeddings.weight": r(v, h),
             "bert.embeddings.position_embeddings.weight": r(p, h),
             "bert.embeddings.token_type_embeddings.weight": r(2, h),
             "bert.embeddings.LayerNorm.weight": 1 + r(h), "bert.embeddings.LayerNorm.bias": r(h),
             "bert.embeddings.position_ids": torch.arange(p)[None],
             "bert.pooler.dense.weight": r(h, h), "bert.pooler.dense.bias": r(h),
             "classifier.weight": r(n, h), "classifier.bias": r(n)}
    for i in range(2):
        pre = f"bert.encoder.layer.{i}."
        for m in ("query", "key", "value"):
            state[pre + f"attention.self.{m}.weight"] = r(h, h)
            state[pre + f"attention.self.{m}.bias"] = r(h)
        state[pre + "attention.output.dense.weight"] = r(h, h)
        state[pre + "attention.output.dense.bias"] = r(h)
        state[pre + "attention.output.LayerNorm.weight"] = 1 + r(h)
        state[pre + "attention.output.LayerNorm.bias"] = r(h)
        state[pre + "intermediate.dense.weight"] = r(f, h)
        state[pre + "intermediate.dense.bias"] = r(f)
        state[pre + "output.dense.weight"] = r(h, f)
        state[pre + "output.dense.bias"] = r(h)
        state[pre + "output.LayerNorm.weight"] = 1 + r(h)
        state[pre + "output.LayerNorm.bias"] = r(h)
    return state


def test_load_hf_bert_matches_jax_loader(tmp_path):
    state = _hf_bert_state()
    path = tmp_path / "model.safetensors"
    save_safetensors(path, state)
    for name in state:
        import accelerate_tpu.models.hf_interop as jhf

        assert hf_bert_key_map(name) == jhf.hf_bert_key_map(name), name
    model, store = load_hf_bert(abstract_init(BertForSequenceClassification,
                                              BertConfig.tiny(dtype=torch.float32),
                                              device="cpu"),
                                path, dtype=torch.float32, device="cpu")
    assert store is None
    jmodel = JBert(JBertConfig.tiny(dtype=jnp.float32))
    jparams, _ = j_load_hf_bert(jmodel, path, dtype=jnp.float32)
    ids, mask, types, _ = _bert_inputs(seed=6)
    want = np.asarray(jmodel.apply(jparams, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
        zero_types = model(torch.from_numpy(ids), torch.from_numpy(mask),
                           torch.zeros_like(torch.from_numpy(types))).numpy()
        typed = model(torch.from_numpy(ids), torch.from_numpy(mask),
                      torch.from_numpy(types)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # type 0 folded into positions: explicit zeros change nothing
    np.testing.assert_allclose(zero_types, got, rtol=1e-6, atol=1e-6)
    # type 1 adds HF's type[1] - type[0] on top of the fold
    tt = state["bert.embeddings.token_type_embeddings.weight"]
    assert torch.equal(model.token_type_embeddings.weight, tt - tt[0])
    assert not np.allclose(typed, got)
