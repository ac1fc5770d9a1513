"""The port's beam search and layer-streamed decode
(``accelerate_tpu_torch/generation.py``) held against the JAX package's.

Both frameworks run ``LlamaConfig.tiny()`` in f32 on the same weights (a
JAX param tree crossing through ``models/convert.py``) and the same numpy
prompts: right-padded rows of different lengths, an EOS inside the
window.  Tokens must be equal; captured logits of the streamed decode
agree at 1e-5 (absolute and relative).  Within the port, the streamed
decode is bitwise: prefetch on equals off, the disk tier (an
``OffloadStore``'s memory maps) equals the pinned host tier, and both
equal ``generate``.  On the CPU only the disk tier streams (its files
read into staging slots, the prefetcher's lookahead and wrap engaged:
the accounting is held exactly); the pinned tier is the CPU's own memory
there and moves nothing, and the pinned slots, side stream and events
run only on the card (``test_torch_cuda_kernels.py``).  Beam search must rank ties as ``jax.lax.top_k`` does
(the lower index first).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu import generation as jgen
from accelerate_tpu.big_modeling import offload_state_dict as j_offload_state_dict
from accelerate_tpu.big_modeling import offload_store_params as j_offload_store_params
from accelerate_tpu.models import llama as jl
from accelerate_tpu.utils import quantization as jq
from accelerate_tpu_torch import generation as tgen
from accelerate_tpu_torch.big_modeling import offload_state_dict, offload_store_params
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import load_converted_state, torch_state_from_flax
from accelerate_tpu_torch.ops.streaming import StreamStats
from accelerate_tpu_torch.utils import quantization as tq

ATOL = RTOL = 1e-5
BATCH = np.asarray([[5, 42, 7, 9, 31, 2], [11, 3, 77, 0, 0, 0]], np.int32)
LENS = np.asarray([6, 3], np.int32)


@pytest.fixture(scope="module")
def pair():
    cfg_j = jl.LlamaConfig.tiny(dtype=jnp.float32)
    model_j = jl.LlamaForCausalLM(cfg_j)
    params = model_j.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree.map(lambda x: np.array(x, copy=True), params)
    model_t = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(dtype=torch.float32), device="cpu")
    model_t.load_state_dict(torch_state_from_flax(params))
    return model_j, params, model_t


def _tokens_equal(ours, theirs):
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def _eos_inside(model_j, params, num_beams):
    """The token JAX's beam search emits at step 1 of row 0: as the EOS
    id, a beam ends there, inside the window."""
    out = jgen.beam_search(model_j, params, BATCH, jgen.GenerationConfig(max_new_tokens=6),
                           num_beams=num_beams, prompt_lengths=LENS)
    return int(np.asarray(out)[0, 1])


@pytest.mark.parametrize("num_beams", [1, 2, 4])
@pytest.mark.parametrize("eos", [False, True])
def test_beam_search_tokens_equal_jax(pair, num_beams, eos):
    model_j, params, model_t = pair
    eos_id = _eos_inside(model_j, params, num_beams) if eos else None
    gc_kw = dict(max_new_tokens=6, eos_token_id=eos_id)
    want = jgen.beam_search(model_j, params, BATCH, jgen.GenerationConfig(**gc_kw),
                            num_beams=num_beams, prompt_lengths=LENS)
    got = tgen.beam_search(model_t, torch.from_numpy(BATCH), tgen.GenerationConfig(**gc_kw),
                           num_beams=num_beams, prompt_lengths=torch.from_numpy(LENS))
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 6)
    _tokens_equal(got, want)
    for row in got.tolist():          # pad after an EOS
        if eos_id in row:
            assert all(t == 0 for t in row[row.index(eos_id) + 1:])


def test_beam_search_k1_equals_greedy(pair):
    _, _, model_t = pair
    gc = tgen.GenerationConfig(max_new_tokens=5)
    ids, lens = torch.from_numpy(BATCH), torch.from_numpy(LENS)
    greedy = tgen.generate(model_t, ids, gc, prompt_lengths=lens)
    assert torch.equal(tgen.beam_search(model_t, ids, gc, num_beams=1, prompt_lengths=lens),
                       greedy)


def test_beam_search_score_at_least_greedy(pair):
    """The best of 4 beams scores at least the greedy hypothesis (sum of
    token log-probs under the model), as in JAX."""
    _, _, model_t = pair
    prompt = torch.tensor([[5, 42, 7, 9]])
    gc = tgen.GenerationConfig(max_new_tokens=5)

    def seq_logprob(new):
        seq = torch.cat([prompt[0], new.long()])[None]
        with torch.no_grad():
            logp = torch.log_softmax(model_t(seq).float(), dim=-1)
        return sum(float(logp[0, prompt.shape[1] - 1 + i, int(t)]) for i, t in enumerate(new))

    greedy = tgen.generate(model_t, prompt, gc)[0]
    beam = tgen.beam_search(model_t, prompt, gc, num_beams=4)[0]
    assert seq_logprob(beam) >= seq_logprob(greedy) - 1e-4


def test_beam_search_length_penalty_counts_eos_step(pair):
    """JAX's stub transition: a hypothesis ending in EOS at step 2 has
    length 2 (the EOS step counts); dropping it would flip the winner."""
    _, _, model_t = pair
    prefill_row = torch.log(torch.tensor([0.25, 0.30, 0.28, 0.17]))
    row_eos = torch.log(torch.tensor([0.001, 0.001, 0.001, 0.997]))
    row_tok2 = torch.log(torch.tensor([0.001, 0.001, 0.997, 0.001]))

    def stub_apply(ids, positions=None, cache=None, cache_write_mask=None):
        b, t = ids.shape
        if t > 1:
            return prefill_row.expand(b, t, 4), cache
        return torch.where((ids == 1)[..., None], row_eos, row_tok2), cache

    gc = tgen.GenerationConfig(max_new_tokens=2, eos_token_id=3, pad_token_id=0)
    out = tgen.beam_search(model_t, torch.tensor([[5, 5]]), gc, num_beams=2,
                           length_penalty=1.0, apply_fn=stub_apply)
    assert out.tolist() == [[1, 3]]


def test_top_k_ties_follow_jax_order():
    """Equal scores rank lower index first, as ``jax.lax.top_k`` does."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, (6, 40)).astype(np.float32)     # many ties
    x[2] = 1.0                                              # all equal
    for k in (1, 3, 8, 40):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = tgen._top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_generate_streamed_tokens_and_logits_equal_jax(pair):
    model_j, params, model_t = pair
    gc_kw = dict(max_new_tokens=5, eos_token_id=2)
    logits_j, logits_t = [], []
    want = jgen.generate_streamed(model_j, params, BATCH, jgen.GenerationConfig(**gc_kw),
                                  prompt_lengths=LENS, capture_logits=logits_j)
    stats = StreamStats()
    got = tgen.generate_streamed(model_t, torch.from_numpy(BATCH), tgen.GenerationConfig(**gc_kw),
                                 prompt_lengths=torch.from_numpy(LENS),
                                 capture_logits=logits_t, stream_stats=stats, device="cpu")
    _tokens_equal(got, want)
    assert len(logits_t) == len(logits_j) == 5
    assert stats.h2d_bytes == 0         # in the CPU's own memory: nothing streams
    for a, b in zip(logits_t, logits_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=RTOL)


def _layer_bytes(model, i):
    return sum(t.numel() * t.element_size() for k, t in model.state_dict().items()
               if k.startswith(f"model.layers.{i}."))


def test_generate_streamed_prefetch_on_equals_off_and_generate(pair, tmp_path):
    """Prefetch only moves where the upload is issued: on and off give
    bitwise-equal logits at every forward, and the tokens of
    ``generate``.  The layers stream from the disk tier, and the
    accounting shows the lookahead engaged, as in JAX: every layer fetched
    once a forward, all but the cold first a hit, and layer 0 once more
    (the lookahead wraps past the last forward)."""
    _, _, model_t = pair
    gc = tgen.GenerationConfig(max_new_tokens=5, eos_token_id=2)
    ids, lens = torch.from_numpy(BATCH), torch.from_numpy(LENS)
    disk = offload_store_params(offload_state_dict(str(tmp_path), model_t.state_dict()))
    off_logits, on_logits = [], []
    off_stats, stats = StreamStats(), StreamStats()
    off = tgen.generate_streamed(model_t, ids, gc, params=disk, prompt_lengths=lens,
                                 prefetch=False, stream_stats=off_stats,
                                 capture_logits=off_logits, device="cpu")
    on = tgen.generate_streamed(model_t, ids, gc, params=disk, prompt_lengths=lens, prefetch=True,
                                stream_stats=stats, capture_logits=on_logits, device="cpu")
    assert torch.equal(on, off)
    assert torch.equal(on, tgen.generate(model_t, ids, gc, prompt_lengths=lens))
    for a, b in zip(on_logits, off_logits):
        assert torch.equal(a, b)
    n_layers, forwards = model_t.config.num_hidden_layers, len(on_logits)
    per_forward = sum(_layer_bytes(model_t, i) for i in range(n_layers))
    assert (off_stats.fetches, off_stats.prefetch_hits) == (forwards * n_layers, 0)
    assert off_stats.h2d_bytes == forwards * per_forward
    assert stats.fetches == forwards * n_layers + 1
    assert stats.prefetch_hits == forwards * n_layers - 1
    assert stats.h2d_bytes == forwards * per_forward + _layer_bytes(model_t, 0)
    assert stats.wall_s > 0


def test_generate_streamed_disk_tier_equals_host_and_jax(pair, tmp_path):
    """The disk tier (every tensor an ``OffloadStore`` memory map, given as
    ``params``) gives the pinned tier's tokens and logits bitwise, and
    JAX's streamed tokens from its own store."""
    model_j, params, model_t = pair
    gc = tgen.GenerationConfig(max_new_tokens=4)
    ids = torch.tensor([[5, 42, 7]])
    host_logits, disk_logits = [], []
    host_model = tl.LlamaForCausalLM(model_t.config, device="cpu")
    host_model.load_state_dict(model_t.state_dict())
    tgen.place_params_host(host_model)
    host_stats, disk_stats = StreamStats(), StreamStats()
    host = tgen.generate_streamed(host_model, ids, gc, capture_logits=host_logits,
                                  stream_stats=host_stats, device="cpu")
    store = offload_state_dict(str(tmp_path / "port"), model_t.state_dict())
    disk_params = offload_store_params(store)
    assert disk_params["model.layers.0.mlp.up_proj.weight"].untyped_storage().data_ptr() != \
        model_t.model.layers[0].mlp.up_proj.weight.untyped_storage().data_ptr()
    disk = tgen.generate_streamed(model_t, ids, gc, params=disk_params,
                                  capture_logits=disk_logits, stream_stats=disk_stats,
                                  device="cpu")
    assert host_stats.h2d_bytes == 0           # the CPU's own memory there
    layers = range(model_t.config.num_hidden_layers)
    assert disk_stats.h2d_bytes == 4 * sum(_layer_bytes(model_t, i) for i in layers) \
        + _layer_bytes(model_t, 0)
    assert torch.equal(host, disk)
    for a, b in zip(host_logits, disk_logits):
        assert torch.equal(a, b)
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    j_store = j_offload_state_dict(str(tmp_path / "jax"), {
        "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
        for path, leaf in flat})
    want = jgen.generate_streamed(model_j, j_offload_store_params(j_store), np.asarray(ids),
                                  jgen.GenerationConfig(max_new_tokens=4))
    _tokens_equal(disk, want)


def test_generate_streamed_int8_equals_jax_and_generate(pair, tmp_path):
    """int8 leaves (every matrix, ``min_size=1``, as JAX's test) stream
    their codes and scales; tokens equal JAX's streamed tokens and the
    port's ``generate``; logits at 1e-5."""
    model_j, params, model_t = pair
    cfg = dict(load_in_8bit=True, min_size=1)
    qparams = jq.quantize_params(params, jq.QuantizationConfig(**cfg))
    qmodel = tl.LlamaForCausalLM(model_t.config, device="cpu")
    load_converted_state(qmodel, torch_state_from_flax(jax.tree.map(
        lambda x: x, qparams, is_leaf=jq.is_quantized)))
    gc_kw = dict(max_new_tokens=5, eos_token_id=2)
    logits_j, logits_t = [], []
    want = jgen.generate_streamed(model_j, qparams, BATCH, jgen.GenerationConfig(**gc_kw),
                                  prompt_lengths=LENS, capture_logits=logits_j)
    got = tgen.generate_streamed(qmodel, torch.from_numpy(BATCH), tgen.GenerationConfig(**gc_kw),
                                 prompt_lengths=torch.from_numpy(LENS), capture_logits=logits_t,
                                 device="cpu")
    _tokens_equal(got, want)
    for a, b in zip(logits_t, logits_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=RTOL)
    assert torch.equal(got, tgen.generate(qmodel, torch.from_numpy(BATCH),
                                          tgen.GenerationConfig(**gc_kw),
                                          prompt_lengths=torch.from_numpy(LENS)))
    assert isinstance(qmodel.model.layers[0].mlp.gate_proj.quantized, tq.QuantizedTensor)
    # the codes and scales stream from the disk tier too, bitwise
    disk = offload_store_params(offload_state_dict(str(tmp_path), qmodel.state_dict()))
    assert disk["model.layers.0.mlp.gate_proj.qcodes"].dtype == torch.int8
    stats, disk_logits = StreamStats(), []
    from_disk = tgen.generate_streamed(qmodel, torch.from_numpy(BATCH),
                                       tgen.GenerationConfig(**gc_kw), params=disk,
                                       prompt_lengths=torch.from_numpy(LENS),
                                       capture_logits=disk_logits, stream_stats=stats,
                                       device="cpu")
    assert torch.equal(from_disk, got)
    for a, b in zip(disk_logits, logits_t):
        assert torch.equal(a, b)
    layers = range(qmodel.config.num_hidden_layers)
    assert stats.h2d_bytes == 5 * sum(_layer_bytes(qmodel, i) for i in layers) \
        + _layer_bytes(qmodel, 0)


def test_place_params_host_keeps_values(pair):
    _, _, model_t = pair
    state = {k: v.clone() for k, v in model_t.state_dict().items()}
    placed = tgen.place_params_host(dict(state))
    assert placed.keys() == state.keys()
    for k in state:
        assert placed[k].device.type == "cpu" and torch.equal(placed[k], state[k])

