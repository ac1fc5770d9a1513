"""The sharded step's memory and precision recipes on 4-rank gloo gangs
(``accelerate_tpu_torch/test_utils/scripts/sharded_recipes_checks.py``) and
on virtual worlds (``parallel/virtual.py``, every rank a thread of this
process), held against the whole-tree step, the resident step, the
one-process step and the JAX package.

Tolerances:

- per-unit gathering (``reshard_after_forward`` True and False) against the
  whole-tree step: bitwise (losses, grad norms, params, the -sr8 codes and
  scales), in every configuration; the dp_shard step against JAX's at
  ``test_torch_data_parallel.py``'s terms (first step 1e-6, then losses
  1e-3 and norms 5e-3; params against the one-process port step at atol
  3e-6);
- ZeRO-offload under a plan: the monolithic host update bitwise the
  resident plan step, the pipelined chunked update bitwise the serial one
  (chunking re-keys the -sr salts, so a chunked run is held to the resident
  run's neighbourhood, JAX's rtol 0.35), the chunk groups equal to JAX's
  ``chunk_groups`` on the global shapes, a rank's bytes equal to
  ``offload_transfer_accounting`` of its ranges; JAX's ``dp_shard_size=8``
  offload tests (``tests/test_offload.py``) at their own tolerances on a
  virtual world of 8;
- fp8: the metas bitwise JAX's (``init_fp8_state`` on the whole weights,
  ``Fp8Meta.updated`` with the whole weights' amax each step) and equal on
  every rank; the dp gang's losses against the one-process fp8 step over
  the global batch, the first at rtol 1e-6 (the same e4m3 / e5m2 codes:
  every amax is the global tensor's; the f32 sums of the loss run in
  another order), the next two at 1e-3 (the f32 sums of dw run in another
  order too, so the updated weights part by an ulp, which moves the next
  step's amaxes and so some of its codes); the fp8 trajectory on a world of 8 within JAX's 5 % (+0.05) of
  JAX's own fp8 run and of the port's bf16 run; the ring's operands bitwise
  JAX's ``fp8_fake_quantize`` of the global tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.accelerator import Accelerator as JaxAccelerator
from accelerate_tpu.models import llama as jl
from accelerate_tpu.ops import fp8 as jfp8
from accelerate_tpu.ops import precision as jprec
from accelerate_tpu.ops import streaming as jst
from accelerate_tpu.optimizer import make_optimizer as jax_make_optimizer
from accelerate_tpu.parallelism_config import ParallelismConfig as JaxParallelismConfig
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu.utils.dataclasses import FullyShardedDataParallelPlugin as JaxPlugin
from accelerate_tpu_torch import Accelerator, GradientAccumulationPlugin, GradSyncKwargs
from accelerate_tpu_torch.data_loader import shard_global_batch
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import flax_module_to_port_name, torch_state_from_flax
from accelerate_tpu_torch.optimizer import adamw, make_optimizer
from accelerate_tpu_torch.parallel.virtual import VirtualMesh, module_replica
from accelerate_tpu_torch.parallelism_config import ParallelismConfig
from accelerate_tpu_torch.test_utils.gang import run_gang
from accelerate_tpu_torch.test_utils.scripts.sharded_recipes_checks import UNIT_CASES
from accelerate_tpu_torch.utils.dataclasses import FullyShardedDataParallelPlugin

WORLD = 4
CHECKS = "accelerate_tpu_torch.test_utils.scripts.sharded_recipes_checks"


def _tokens():
    return np.random.default_rng(4).integers(0, 256, (8, 32)).astype(np.int32)


def _batches():
    rng = np.random.default_rng(4)
    return [rng.integers(0, 256, (8, 32)).astype(np.int32) for _ in range(3)]


@pytest.fixture(scope="module")
def host():
    cfg = jl.LlamaConfig.tiny(dtype=jnp.float32)
    params = jl.LlamaForCausalLM(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return jax.tree.map(lambda x: np.array(x, copy=True), params)


@pytest.fixture(scope="module")
def state_path(host, tmp_path_factory):
    d = tmp_path_factory.mktemp("recipes")
    torch.save(torch_state_from_flax(host), d / "tiny.pt")
    return d / "tiny.pt"


@pytest.fixture(scope="module")
def units(state_path):
    return run_gang(f"{CHECKS}:unit_checks", WORLD, state_path.parent / "units", timeout=300,
                    state_path=str(state_path), tokens=_tokens())


@pytest.fixture(scope="module")
def offload(state_path):
    return run_gang(f"{CHECKS}:offload_checks", WORLD, state_path.parent / "offload",
                    timeout=300, tokens=_tokens())


@pytest.fixture(scope="module")
def fp8(state_path):
    return run_gang(f"{CHECKS}:fp8_checks", WORLD, state_path.parent / "fp8", timeout=300,
                    state_path=str(state_path), tokens=_tokens())


# -- per-unit gathering -------------------------------------------------------------


CASES = sorted([f"{label}/lion-sr8" for label in UNIT_CASES] + ["dp_shard/adamw-sr8"])


@pytest.mark.parametrize("case", CASES)
def test_per_unit_gathering_is_the_whole_tree_step_bitwise(units, case):
    """Both modes of ``reshard_after_forward`` against the step that gathers
    the whole tree before the forward, over 3 steps on every rank: losses,
    grad norms, params and the optimizer state (-sr8 codes and scales),
    bit for bit.  FULL_SHARD dp_shard 4, HSDP 2 x 2, tp 2 x dp_shard 2, the
    cp 2 ring, remat full / dots, the scanned stack and Mixtral under ep 2 x
    dp_shard 2."""
    for rank in range(WORLD):
        rep = units[rank][case]
        assert rep["owned"], "no leaf was gathered unit by unit"
        for mode in ("True", "False"):
            assert rep[mode] == {"trajectory": True, "params": True, "opt": True}, (rank, mode)


def test_unit_gathers_recorded_in_forward_and_backward(units):
    """The collectives recorder counts one gather a unit in the forward (the
    embedding, the two blocks, the head) under both modes, and under
    ``True`` one more for each unit whose backward reads its weights (the
    blocks and the head: the embedding's backward reads the ids only); the
    whole-tree step gathers no unit."""
    for rank in range(WORLD):
        rep = units[rank]["dp_shard/lion-sr8"]
        assert rep["gathers"] == {"whole": 0, "True": 4 + 3, "False": 4}


def test_reshard_saves_no_full_weight_for_the_backward(units):
    """A saved-tensor audit (``saved_tensors_hooks`` around the step) over
    the first step: under ``True`` no full weight of a sharded leaf is
    saved for the backward; under ``False`` every 2-D weight a product
    reads is (the audit sees them)."""
    for rank in range(WORLD):
        saved = units[rank]["dp_shard/lion-sr8"]["saved_weights"]
        assert saved["True"] == []
        assert "lm_head.weight" in saved["False"]
        assert "model.layers.1.mlp.down_proj.weight" in saved["False"]


def _jax_dp_trajectory(host):
    JaxAcceleratorState._reset_state(reset_partial_state=True)
    JaxGradientState._reset_state()
    try:
        model = jl.LlamaForCausalLM(jl.LlamaConfig.tiny(dtype=jnp.float32))
        acc = JaxAccelerator(
            parallelism_config=JaxParallelismConfig(dp_shard_size=WORLD,
                                                    devices=jax.devices()[:WORLD]),
            fsdp_plugin=JaxPlugin(sharding_strategy="FULL_SHARD", min_weight_size=0))
        state = acc.create_train_state(jax.tree.map(jnp.asarray, host),
                                       jax_make_optimizer("adamw"), apply_fn=model.apply)
        step = acc.prepare_train_step(jl.make_llama_loss_fn(model, fused_vocab_chunks=4),
                                      max_grad_norm=1.0)
        out = []
        for ids in _batches():
            state, m = step(state, {"input_ids": jnp.asarray(ids), "labels": jnp.asarray(ids)})
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return np.asarray(out)
    finally:
        JaxAcceleratorState._reset_state(reset_partial_state=True)
        JaxGradientState._reset_state()


def test_per_unit_step_equals_jax_dp_shard_step(host, state_path):
    """Both modes of the dp_shard 4 step (adamw, clipping) against JAX's
    FULL_SHARD ``Accelerator`` on 4 of its CPU devices, and their params
    against the one-process port step on the global batches."""
    gang = run_gang(f"{CHECKS}:jax_step_checks", WORLD, state_path.parent / "jax_step",
                    timeout=120, state_path=str(state_path), batches=_batches())
    want = _jax_dp_trajectory(host)
    model = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(dtype=torch.float32,
                                                    attn_implementation="flash"), device="cpu")
    model.load_state_dict(torch.load(state_path))
    acc = Accelerator(cpu=True)
    state = acc.create_train_state(model, "adamw")
    step = acc.prepare_train_step(tl.make_llama_loss_fn(model, fused_vocab_chunks=4),
                                  max_grad_norm=1.0)
    for ids in _batches():
        ids = torch.from_numpy(ids).long()
        state, _ = step(state, {"input_ids": ids, "labels": ids})
    for rank in range(WORLD):
        for mode in ("True", "False"):
            got = gang[rank][mode]["trajectory"]
            np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
            np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-3)
            np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=5e-3)
            for name, p in gang[rank][mode]["params"].items():
                np.testing.assert_allclose(p, state.params[name].detach().numpy(), atol=3e-6,
                                           err_msg=name)


def _virtual_world(pcfg, world, make, batches, mesh=None):
    """``make(rank) -> (accelerator, state, step, feed)`` on every rank of a
    virtual world (``mesh``, or a new one), then each global batch through
    every rank's step: ``(metrics by step and rank, each rank's (accelerator,
    state, step, feed), the mesh)``."""
    mesh = mesh if mesh is not None else VirtualMesh(*pcfg.mesh_layout(world))
    ranks = mesh.run(make, pcfg)
    steps = []
    for batch in batches:
        def one(r, batch=batch):
            acc, state, step, feed = ranks[r]
            state, m = step(state, feed(acc, batch))
            ranks[r] = (acc, state, step, feed)
            return {k: v.item() if torch.is_tensor(v) else v for k, v in m.items()}
        steps.append(mesh.run(one, pcfg))
    return steps, ranks, mesh


@pytest.mark.parametrize("reshard", [True, False])
def test_virtual_world_per_unit_is_the_whole_tree_step(state_path, reshard):
    """On a virtual world of 4 (the card's harness): the backward's unit
    gathers and reductions run in memory, and both modes are the
    whole-tree step bitwise over 3 lion-sr8 steps."""
    pcfg = ParallelismConfig(dp_shard_size=WORLD)
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32, attn_implementation="flash")
    model = tl.LlamaForCausalLM(cfg, device="cpu")
    model.load_state_dict(torch.load(state_path))
    full = {n: p.detach().clone() for n, p in model.named_parameters()}
    replicas = [module_replica(model) for _ in range(WORLD)]

    def run(units: bool):
        def make(r):
            acc = Accelerator(cpu=True, parallelism_config=pcfg,
                              fsdp_plugin=FullyShardedDataParallelPlugin(
                                  min_weight_size=0, reshard_after_forward=reshard))
            loss_fn = tl.make_llama_loss_fn(replicas[r], fused_vocab_chunks=4)
            if not units:
                inner = loss_fn
                loss_fn = lambda p, b: inner(p, b)  # noqa: E731
            state = acc.create_train_state({n: p.clone() for n, p in full.items()},
                                           "lion-sr8")

            def feed(acc, ids):
                local = shard_global_batch(torch.from_numpy(ids).long(), acc.mesh,
                                           pcfg.batch_spec(seq_axis=None, ndim=2))
                return {"input_ids": local, "labels": local}

            return acc, state, acc.prepare_train_step(loss_fn, max_grad_norm=1.0), feed

        return _virtual_world(pcfg, WORLD, make, _batches())

    got, got_ranks, _ = run(True)
    want, want_ranks, _ = run(False)
    assert got == want
    for (_, a, _, _), (_, b, _, _) in zip(got_ranks, want_ranks):
        assert all(torch.equal(a.params[n], p) for n, p in b.params.items())
        for fa, fb in zip(a.opt_state, b.opt_state):
            if isinstance(fa, list):
                assert all(torch.equal(x, y) for x, y in zip(fa, fb))


# -- ZeRO-offload under a plan ---------------------------------------------------------


@pytest.mark.parametrize("recipe", ["lion-sr8", "adamw-sr8"])
def test_offload_under_a_plan_is_the_resident_plan_step(offload, recipe):
    """dp_shard 4: the monolithic offloaded step is the resident plan step
    bitwise (with clipping: the host norm summed over the ranks), the
    pipelined chunked update the serial one, and the chunked run lands in
    the resident run's neighbourhood (JAX's rtol 0.35; its salts are
    group-relative); each rank's state lives on the host."""
    for rank in range(WORLD):
        rep = offload[rank][recipe]
        assert rep["mono_vs_resident"] == {"trajectory": True, "params": True, "opt": True}
        assert rep["pipelined_vs_serial"] == {"trajectory": True, "params": True, "opt": True}
        np.testing.assert_allclose(np.asarray(rep["chunked_trajectory"])[:, 0],
                                   np.asarray(rep["resident_trajectory"])[:, 0], rtol=0.35)
        assert rep["pinned_on_host"]


def test_offloaded_rank_moves_its_ranges_bytes(offload):
    """A rank's D2H (its reduced f32 gradient ranges) and H2D (its bf16
    compute ranges) bytes are ``offload_transfer_accounting`` of its range
    elements: a quarter of the model's (and its padding)."""
    for rank in range(WORLD):
        for recipe in ("lion-sr8", "adamw-sr8"):
            rep = offload[rank][recipe]
            for log in rep["logs"].values():
                assert log["d2h_bytes"] == rep["predicted"]["d2h_bytes"]
                assert log["h2d_bytes"] == rep["predicted"]["h2d_bytes"]
            assert rep["range_elements"] * WORLD >= rep["whole_elements"]
            assert rep["range_elements"] * WORLD < 1.05 * rep["whole_elements"]


def test_chunk_groups_come_from_the_global_shapes(offload):
    """The chunked update's groups are JAX's ``chunk_groups`` over the
    global leaves (the -sr salts are group-relative leaf indices), not over
    a rank's ranges."""
    cfg = jl.LlamaConfig.tiny()
    params = jl.LlamaForCausalLM(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    want = len(jst.chunk_groups(params, int(1e-6 * 2**30)))
    for rank in range(WORLD):
        assert offload[rank]["lion-sr8"]["logs"]["pipelined"]["groups"] == want


def test_offloaded_sharded_checkpoint_continues_bitwise(offload):
    """Each rank saves its ranges from host memory in the sharded layout
    after the first step; the restore onto a fresh offloaded plan lands on
    the host, and the next two steps are the uninterrupted resident run's
    bitwise (params, codes and scales)."""
    for rank in range(WORLD):
        for recipe in ("lion-sr8", "adamw-sr8"):
            assert offload[rank][recipe]["restored_vs_resident"] == {
                "trajectory": True, "params": True, "opt": True}


def _mlp_params(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"dense.kernel": torch.randn(8, 64, generator=gen) * 0.1,
            "dense.bias": torch.zeros(64),
            "out.kernel": torch.randn(64, 1, generator=gen) * 0.1,
            "out.bias": torch.zeros(1)}


def _mlp_loss(p, batch):
    h = torch.tanh(batch["x"] @ p["dense.kernel"].to(batch["x"].dtype)
                   + p["dense.bias"].to(batch["x"].dtype))
    pred = (h @ p["out.kernel"].to(h.dtype) + p["out.bias"].to(h.dtype))[..., 0]
    return ((pred.float() - batch["y"]) ** 2).mean()


def _mlp_batches(n=6, bs=16, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.normal(size=(bs, 8)).astype(np.float32)
        out.append((x, (x.sum(-1) * 0.5).astype(np.float32)))
    return out


def _run8(offload, accum_plugin=None, mixed_precision="no", n_steps=6, chunk_gib=None,
          max_grad_norm=1.0, kwargs_handlers=None, pipeline=True, ckpt=None, bs=16):
    """JAX ``tests/test_offload.py``'s ``_run`` on a virtual world of 8
    (dp_shard 8, ``min_weight_size=0``): the losses and the whole params.
    ``ckpt``: a directory the state is saved to after the third step and
    restored from onto a fresh template.  ``bs``: the global batch."""
    world = 8
    pcfg = ParallelismConfig(dp_shard_size=world)

    def make(r):
        acc = Accelerator(cpu=True, parallelism_config=pcfg, mixed_precision=mixed_precision,
                          gradient_accumulation_plugin=accum_plugin,
                          kwargs_handlers=kwargs_handlers,
                          fsdp_plugin=FullyShardedDataParallelPlugin(
                              min_weight_size=0, cpu_offload=offload,
                              host_update_chunk_gib=chunk_gib, host_update_pipeline=pipeline))
        state = acc.create_train_state(_mlp_params(), adamw(1e-2, weight_decay=1e-4))

        def feed(acc, batch):
            x, y = (torch.from_numpy(t) for t in batch)
            spec = pcfg.batch_spec(seq_axis=None, ndim=1)
            return {"x": shard_global_batch(x, acc.mesh, spec),
                    "y": shard_global_batch(y, acc.mesh, spec)}

        return acc, state, acc.prepare_train_step(_mlp_loss, max_grad_norm=max_grad_norm), feed

    batches = _mlp_batches(n=n_steps, bs=bs)
    if ckpt is None:
        steps, ranks, mesh = _virtual_world(pcfg, world, make, batches)
    else:
        from accelerate_tpu_torch.checkpointing import load_train_state, save_train_state

        steps, ranks, mesh = _virtual_world(pcfg, world, make, batches[:3])
        # each rank's ranges from host memory, in the sharded layout
        mesh.run(lambda r: save_train_state(ckpt, ranks[r][1], ranks[r][0]._dp_plan), pcfg)

        def restore(r):
            acc, state, step, feed = make(r)
            return acc, load_train_state(ckpt, state, acc._dp_plan), step, feed

        rest, ranks, _ = _virtual_world(pcfg, world, restore, batches[3:], mesh)
        steps = steps + rest
    losses = [s[0]["loss"] for s in steps]
    whole = mesh.run(lambda r: {n: p.detach().float().clone() for n, p in
                                ranks[r][0].device_params(ranks[r][1].params).items()}, pcfg)
    return losses, whole[0]


def _close(a: dict, b: dict, **tol):
    for name in b:
        np.testing.assert_allclose(a[name].numpy(), b[name].numpy(), err_msg=name, **tol)


def test_world8_offload_matches_resident_simple():
    """JAX ``test_offload_matches_resident_simple`` (rtol 1e-6)."""
    res, p_res = _run8(False)
    off, p_off = _run8(True)
    np.testing.assert_allclose(off, res, rtol=1e-6)
    _close(p_off, p_res, rtol=1e-6)


@pytest.mark.parametrize("mode,num", [("in_step", 4), ("across_steps", 3)])
def test_world8_offload_matches_resident_under_accumulation(mode, num):
    """JAX ``test_offload_matches_resident_in_step_accum`` /
    ``..._across_steps_accum`` (rtol 1e-6).  A rank splits its own rows into
    the microbatches, so in_step 4 takes global batches of 32 (4 rows a
    rank), where JAX splits its global 16."""
    bs = 32 if mode == "in_step" else 16
    plugin = GradientAccumulationPlugin(num_steps=num, mode=mode)
    res, p_res = _run8(False, accum_plugin=plugin, bs=bs)
    plugin = GradientAccumulationPlugin(num_steps=num, mode=mode)
    off, p_off = _run8(True, accum_plugin=plugin, bs=bs)
    np.testing.assert_allclose(off, res, rtol=1e-6)
    _close(p_off, p_res, rtol=1e-6)


def test_world8_offload_with_bf16_grads_tracks_resident():
    """JAX ``test_offload_with_bf16_grads_tracks_resident`` (losses rtol
    5e-2; params rtol 0.1, atol 5e-3)."""
    res, p_res = _run8(False, mixed_precision="bf16", max_grad_norm=None)
    off, p_off = _run8(True, mixed_precision="bf16", max_grad_norm=None,
                       kwargs_handlers=[GradSyncKwargs(grad_dtype="bf16")])
    np.testing.assert_allclose(off, res, rtol=5e-2)
    _close(p_off, p_res, rtol=0.1, atol=5e-3)


@pytest.mark.parametrize("clip", [1.0, None])
def test_world8_chunked_host_update_matches_monolithic(clip):
    """JAX ``test_chunked_host_update_matches_monolithic`` and
    ``..._unclipped`` (losses rtol 1e-6; params rtol 2e-6, atol 1e-8)."""
    mono, p_mono = _run8(True, max_grad_norm=clip)
    chunk, p_chunk = _run8(True, chunk_gib=1e-6, max_grad_norm=clip)
    np.testing.assert_allclose(chunk, mono, rtol=1e-6)
    _close(p_chunk, p_mono, rtol=2e-6, atol=1e-8)


def test_world8_chunked_host_update_matches_resident():
    """JAX ``test_chunked_host_update_matches_resident`` (rtol 1e-5)."""
    res, p_res = _run8(False)
    chunk, p_chunk = _run8(True, chunk_gib=1e-6)
    np.testing.assert_allclose(chunk, res, rtol=1e-5)
    _close(p_chunk, p_res, rtol=1e-5)


def test_world8_offload_with_fp16_loss_scaling():
    """JAX ``test_offload_with_fp16_loss_scaling``: finite and falling."""
    losses, _ = _run8(True, mixed_precision="fp16", n_steps=8)
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_world8_offload_state_checkpoint_roundtrip(tmp_path):
    """JAX ``test_offload_state_checkpoint_roundtrip`` (:231): the offloaded
    sharded state saved after 3 steps and restored onto a fresh offloaded
    template trains on as the uninterrupted run, bitwise."""
    straight, p_straight = _run8(True)
    resumed, p_resumed = _run8(True, ckpt=tmp_path / "ckpt")
    assert resumed == straight
    _close(p_resumed, p_straight, rtol=0, atol=0)


# -- fp8 across ranks -------------------------------------------------------------------


def _jax_metas(host):
    flat = {}

    def walk(tree, path=()):
        for k, v in tree.items():
            if k == "w_meta":
                flat[flax_module_to_port_name("/".join(path))] = v
            else:
                walk(v, path + (k,))

    walk(jfp8.init_fp8_state(host, history_len=16, margin=0))
    return flat


@pytest.mark.parametrize("label", ["dp", "tp_dp"])
def test_fp8_metas_are_jax_and_equal_on_every_rank(fp8, host, label):
    """Under dp 4 and tp 2 x dp_shard 2: ``init_fp8_state`` on every rank is
    JAX's on the whole weights, bitwise; each step's metas are JAX's
    ``Fp8Meta.updated`` with the amax of the whole post-update weights; and
    every rank holds the same metas."""
    want0 = _jax_metas(host)
    for rank in range(WORLD):
        rec = fp8[rank][label]
        assert sorted(rec["metas"][0]) == sorted(want0)
        for name, meta in want0.items():
            np.testing.assert_array_equal(rec["metas"][0][name][0], np.asarray(meta.amax_history))
            np.testing.assert_array_equal(rec["metas"][0][name][1], np.asarray(meta.scale))
        for i, metas in enumerate(rec["metas"]):
            for name, (hist, scale) in metas.items():
                np.testing.assert_array_equal(hist, fp8[0][label]["metas"][i][name][0])
                np.testing.assert_array_equal(scale, fp8[0][label]["metas"][i][name][1])
    rec = fp8[0][label]
    for i, weights in enumerate(rec["weights"]):
        for name, w in weights.items():
            prev = jprec.Fp8Meta(jnp.asarray(rec["metas"][i][name][0]),
                                 jnp.asarray(rec["metas"][i][name][1]))
            amax = jnp.max(jnp.abs(jnp.asarray(w))).astype(jnp.float32)
            want = prev.updated(amax, jprec.E4M3_MAX, 0)
            np.testing.assert_array_equal(rec["metas"][i + 1][name][0],
                                          np.asarray(want.amax_history), err_msg=name)
            np.testing.assert_array_equal(rec["metas"][i + 1][name][1], np.asarray(want.scale),
                                          err_msg=name)


def test_fp8_gang_losses_equal_the_one_process_step(fp8, state_path):
    """The dp 4 gang's fp8 losses against the one-process fp8 step over the
    global batch: the first step's at rtol 1e-6, the next two's at 1e-3
    (the module doc)."""
    model = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(dtype=torch.float32), device="cpu")
    model.load_state_dict(torch.load(state_path))
    acc = Accelerator(cpu=True, mixed_precision="fp8")
    state = acc.create_train_state(model, "adamw")
    step = acc.prepare_train_step(tl.make_llama_loss_fn(model, fused_vocab_chunks=4),
                                  max_grad_norm=1.0)
    ids = torch.from_numpy(_tokens()).long()
    want = []
    for _ in range(3):
        state, m = step(state, {"input_ids": ids, "labels": ids})
        want.append(m["loss"].item())
    for rank in range(WORLD):
        got = fp8[rank]["dp"]["losses"]
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
        np.testing.assert_allclose(got[1:], want[1:], rtol=1e-3)


def _jax_fp8_run(n_steps=8):
    """JAX ``tests/test_fp8.py``'s ``_train_llama("fp8")`` on dp_shard 8."""
    import optax

    JaxAcceleratorState._reset_state(reset_partial_state=True)
    JaxGradientState._reset_state()
    try:
        acc = JaxAccelerator(parallelism_config=JaxParallelismConfig(dp_shard_size=8),
                             mixed_precision="fp8")
        model = jl.LlamaForCausalLM(jl.LlamaConfig.tiny())
        params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
        host = jax.tree.map(lambda x: np.array(x, copy=True), params)
        state = acc.create_train_state(params, optax.adamw(1e-3), apply_fn=model.apply)
        step = acc.prepare_train_step(jl.make_llama_loss_fn(model), max_grad_norm=1.0)
        toks = np.random.default_rng(0).integers(0, 256, (8, 32)).astype(np.int32)
        losses = []
        for _ in range(n_steps):
            state, m = step(state, {"input_ids": jnp.asarray(toks), "labels": jnp.asarray(toks)})
            losses.append(float(m["loss"]))
        return losses, host, toks
    finally:
        JaxAcceleratorState._reset_state(reset_partial_state=True)
        JaxGradientState._reset_state()


def test_fp8_world8_trajectory_holds_jax_terms():
    """JAX's ``_train_llama("fp8")`` on ``dp_shard_size=8`` against the
    port's fp8 step on a virtual world of 8 from the same weights and
    batch: each loss within JAX's 5 % (+0.05) of JAX's fp8 run and of the
    port's bf16 run on the same world, and it learns."""
    want, host, toks = _jax_fp8_run()
    state = torch_state_from_flax(host)
    pcfg = ParallelismConfig(dp_shard_size=8)

    def run(mp):
        model = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(dtype=torch.float32), device="cpu")
        model.load_state_dict(state)
        full = {n: p.detach().clone() for n, p in model.named_parameters()}
        replicas = [module_replica(model) for _ in range(8)]

        def make(r):
            acc = Accelerator(cpu=True, parallelism_config=pcfg, mixed_precision=mp)
            st = acc.create_train_state({n: p.clone() for n, p in full.items()},
                                        make_optimizer("adamw", 1e-3, weight_decay=1e-4))

            def feed(acc, ids):
                local = shard_global_batch(torch.from_numpy(ids).long(), acc.mesh,
                                           pcfg.batch_spec(seq_axis=None, ndim=2))
                return {"input_ids": local, "labels": local}

            return acc, st, acc.prepare_train_step(tl.make_llama_loss_fn(replicas[r]),
                                                   max_grad_norm=1.0), feed

        steps, _, _ = _virtual_world(pcfg, 8, make, [toks] * 8)
        return [s[0]["loss"] for s in steps]

    fp8, bf16 = run("fp8"), run("bf16")
    assert all(np.isfinite(fp8)) and fp8[-1] < fp8[0]
    for a, b, j in zip(fp8, bf16, want):
        assert abs(a - b) < 0.05 * abs(b) + 0.05, (fp8, bf16)
        assert abs(a - j) < 0.05 * abs(j) + 0.05, (fp8, want)


def test_fp8_ring_operands_are_jax_fake_quantized_global_tensors():
    """Under tp 2 with the ring on, a column dense hands the ring both
    operands rounded through e4m3 at the global tensors' amax: gathered
    over the ranks they equal JAX's ``fp8_fake_quantize`` of the global
    activations and weight, bitwise."""
    from accelerate_tpu_torch.models import layers as tlayers
    from accelerate_tpu_torch.ops import collective_matmul as tcm
    from accelerate_tpu_torch.ops.precision import fp8_amax_over, fp8_autocast

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 16)).astype(np.float32) * 3
    w = rng.normal(size=(12, 16)).astype(np.float32)
    pcfg = ParallelismConfig(tp_size=2)
    mesh = VirtualMesh(*pcfg.mesh_layout(2))
    seen = {}
    saved = tcm.dense_collective_matmul

    def spy(xs, ws, kind, **kw):
        seen[mesh.rank] = (xs.detach().clone(), ws.detach().clone())
        return saved(xs, ws, kind, **kw)

    def rank(r):
        route = tlayers.DenseRoute(mesh, "tp", "ring")
        local = torch.from_numpy(x).chunk(2, dim=1)[r].contiguous()
        with fp8_autocast(), fp8_amax_over(mesh, ("tp",)):
            return tlayers.tp_linear(local, torch.from_numpy(w).chunk(2, dim=0)[r], "column",
                                     route, 16, 12, fp8=True)

    tcm.dense_collective_matmul = spy
    try:
        with tcm.collective_matmul("ring"):
            mesh.run(rank, pcfg)
    finally:
        tcm.dense_collective_matmul = saved
    got_x = torch.cat([seen[r][0] for r in range(2)], dim=1).numpy()
    got_w = torch.cat([seen[r][1] for r in range(2)], dim=0).numpy()
    np.testing.assert_array_equal(got_x, np.asarray(jfp8.fp8_fake_quantize(jnp.asarray(x))))
    np.testing.assert_array_equal(got_w, np.asarray(jfp8.fp8_fake_quantize(jnp.asarray(w))))


# -- what still raises ------------------------------------------------------------------


def test_what_is_left_raises_naming_its_item():
    """The rest of A13h still raises, each naming its sub-item: a quantized
    dense inside a collective-matmul ring (A13h.7; with the ring off it and
    cached decoding on tp slices run since A13h.4: ``test_torch_tp_serving.
    py``), a leaf split over both tp and ep and Mixtral under tp (A13h.5),
    pp composed with tp (A13h.6)."""
    from accelerate_tpu_torch.models import mixtral as tm
    from accelerate_tpu_torch.models.layers import DenseRoute, QuantizableDense
    from accelerate_tpu_torch.parallel.sharding import model_split
    from accelerate_tpu_torch.parallelism_config import PartitionSpec
    from accelerate_tpu_torch.utils.quantization import QuantizationConfig, quantize

    dense = QuantizableDense(16, 8, torch.float32)
    dense.tp_mode = "column"
    dense.set_quantized(quantize(torch.randn(16, 8), QuantizationConfig(load_in_8bit=True)))
    with pytest.raises(NotImplementedError, match=r"A13h\.7"):
        dense(torch.randn(2, 16), route=DenseRoute(None, "tp", "ring"))
    with pytest.raises(NotImplementedError, match=r"A13h\.5"):
        model_split(PartitionSpec(("tp", "ep"), None), {"tp": 2, "ep": 2})
    mixtral = tm.MixtralForCausalLM(tm.MixtralConfig.tiny(dtype=torch.float32), device="cpu")
    mesh = VirtualMesh(*ParallelismConfig(tp_size=2).mesh_layout(2))
    with pytest.raises(NotImplementedError, match=r"A13h\.5"):
        mesh.run(lambda r: mixtral(torch.zeros(1, 4, dtype=torch.long)),
                 ParallelismConfig(tp_size=2))
    with pytest.raises(NotImplementedError, match=r"A13h\.6"):
        Accelerator(cpu=True, parallelism_config=ParallelismConfig(pp_size=2, tp_size=2))
