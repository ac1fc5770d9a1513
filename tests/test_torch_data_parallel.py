"""The port's data-parallel train step on a 4-rank gloo world (one gang of
CPU processes, ``accelerate_tpu_torch/test_utils/gang.py``) held against
the JAX package's ``Accelerator`` on 4 of its CPU devices and against the
port's own single-process step on the same global batch.

Tolerances: the regression baseline at JAX's rtol 1e-5; the tiny f32
Llama's 3-step loss / grad-norm trajectory against the single-process
port step at rtol 1e-5 (summation order: the global mean is the ranks'
weighted losses summed) and its params at atol 3e-6 (adamw's bf16
momentum can round one ulp apart, a step of ~lr * 2^-8 = 1.2e-6, in each
of the 3 steps); against the JAX
package at slice 2's trajectory tolerances (first step 1e-6, then 1e-3 /
5e-3).  The HSDP replicas, and the sharded -sr / -sr8 updates against the
whole-leaf update given the same gradients, bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.accelerator import Accelerator as JaxAccelerator
from accelerate_tpu.data_loader import batch_rows_by_device
from accelerate_tpu.models import llama as jl
from accelerate_tpu.optimizer import make_optimizer as jax_make_optimizer
from accelerate_tpu.parallelism_config import ParallelismConfig as JaxParallelismConfig
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu.test_utils.training import regression_init_params, regression_loss_fn
from accelerate_tpu.utils.dataclasses import FullyShardedDataParallelPlugin as JaxPlugin
from accelerate_tpu_torch import Accelerator, make_llama_loss_fn
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import torch_state_from_flax
from accelerate_tpu_torch.test_utils.gang import run_gang

WORLD = 4
CONFIGS = {"dp_shard": dict(dp_shard_size=4), "hsdp": dict(dp_replicate_size=2, dp_shard_size=2)}
STRATEGY = {"dp_shard": "FULL_SHARD", "hsdp": "HYBRID_SHARD"}


def _batches():
    rng = np.random.default_rng(4)
    return [rng.integers(0, 256, (8, 32)).astype(np.int32) for _ in range(3)]


@pytest.fixture(scope="module")
def host():
    cfg = jl.LlamaConfig.tiny(dtype=jnp.float32)
    params = jl.LlamaForCausalLM(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return jax.tree.map(lambda x: np.array(x, copy=True), params)


@pytest.fixture(scope="module")
def gang(host, tmp_path_factory):
    d = tmp_path_factory.mktemp("dp_gang")
    torch.save(torch_state_from_flax(host), d / "tiny.pt")
    return run_gang("accelerate_tpu_torch.test_utils.scripts.data_parallel_checks:dp_checks",
                    WORLD, d, timeout=120, state_path=str(d / "tiny.pt"), batches=_batches())


def _jax_trajectory(host, label):
    JaxAcceleratorState._reset_state(reset_partial_state=True)
    JaxGradientState._reset_state()
    try:
        model = jl.LlamaForCausalLM(jl.LlamaConfig.tiny(dtype=jnp.float32))
        acc = JaxAccelerator(
            parallelism_config=JaxParallelismConfig(**CONFIGS[label],
                                                    devices=jax.devices()[:WORLD]),
            fsdp_plugin=JaxPlugin(sharding_strategy=STRATEGY[label], min_weight_size=0))
        params = jax.tree.map(jnp.asarray, host)
        state = acc.create_train_state(params, jax_make_optimizer("adamw"), apply_fn=model.apply)
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


def _port_single_process(host):
    model = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(dtype=torch.float32,
                                                    attn_implementation="flash"), device="cpu")
    model.load_state_dict(torch_state_from_flax(host))
    acc = Accelerator(cpu=True)
    state = acc.create_train_state(model, "adamw")
    step = acc.prepare_train_step(make_llama_loss_fn(model, fused_vocab_chunks=4),
                                  max_grad_norm=1.0)
    out = []
    for ids in _batches():
        ids = torch.from_numpy(ids).long()
        state, m = step(state, {"input_ids": ids, "labels": ids})
        out.append((m["loss"].item(), m["grad_norm"].item()))
    return np.asarray(out), {n: p.detach().numpy() for n, p in state.params.items()}


def test_dp_sharded_matches_baseline(gang):
    """JAX ``tests/test_accelerator.py:50``: dp_shard 4 over global batches
    of 16 (4 rows a rank) lands where the single-logic SGD loop does."""
    params = regression_init_params()
    import optax

    from accelerate_tpu.test_utils.training import make_regression_loader

    tx = optax.sgd(0.1)
    opt_state = tx.init(params)
    for _ in range(2):
        for batch in make_regression_loader(batch_size=16):
            b = {"x": jnp.asarray(batch["x"].numpy()), "y": jnp.asarray(batch["y"].numpy())}
            grads = jax.grad(regression_loss_fn)(params, b)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
    for rank in range(WORLD):
        np.testing.assert_allclose(gang[rank]["regression"]["a"], float(params["a"]), rtol=1e-5)
        np.testing.assert_allclose(gang[rank]["regression"]["b"], float(params["b"]), rtol=1e-5)


@pytest.mark.parametrize("label", sorted(CONFIGS))
def test_llama_steps_match_single_process_and_jax(gang, host, label):
    """The tiny f32 Llama, 3 adamw steps with clipping: every rank reports
    the global loss and norm; they equal the single-process port step's on
    the same global batch, and JAX's sharded ``Accelerator``'s."""
    single, single_params = _port_single_process(host)
    want = _jax_trajectory(host, label)
    for rank in range(WORLD):
        got = gang[rank][label]["trajectory"]
        np.testing.assert_allclose(got, single, rtol=1e-5)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-3)
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=5e-3)
        for name, p in gang[rank][label]["params"].items():
            np.testing.assert_allclose(p, single_params[name], atol=3e-6, err_msg=name)


@pytest.mark.parametrize("label", sorted(CONFIGS))
def test_each_rank_holds_its_shard(gang, label):
    """The ZeRO memory property: a rank's params and optimizer state are
    the bytes the plans give one device (``plan_bytes_per_device``), and
    every sharded leaf holds a quarter (a half under HSDP) of its
    elements."""
    ways = 4 if label == "dp_shard" else 2
    for rank in range(WORLD):
        rep = gang[rank][label]
        assert rep["local_bytes"] == rep["plan_bytes"]
        for name, (p_axes, o_axes, chunk) in rep["layouts"].items():
            full = rep["params"][name]
            if p_axes:
                assert p_axes == ("dp_shard",) and rep["local"][name].size == chunk
                assert chunk * ways == full.size
            else:
                assert rep["local"][name].shape == full.shape


def test_hsdp_replicas_bit_identical(gang):
    """JAX ``tests/test_accelerator.py:190``: ranks differing only in their
    ``dp_replicate`` coordinate (rank = 2 r + s) hold identical bytes."""
    for s in range(2):
        a, b = gang[s]["hsdp"]["local"], gang[2 + s]["hsdp"]["local"]
        for name in a:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    # and the shards differ across dp_shard (the plan did shard)
    assert not np.array_equal(gang[0]["hsdp"]["local"]["lm_head.weight"],
                              gang[1]["hsdp"]["local"]["lm_head.weight"])


@pytest.mark.parametrize("layout", ["FULL_SHARD", "SHARD_GRAD_OP", "FULL_SHARD_cp"])
def test_sharded_sr_updates_bitwise_whole_leaf(gang, layout):
    """Two updates of lion-sr, lion-sr8, adamw-sr and adamw-sr8 on bf16
    leaves laid out by the plan equal, bit for bit, the whole-leaf updates
    given the same reduced gradients: params and optimizer state (codes and
    scales).  Under FULL_SHARD the attention, MLP and head kernels split on
    the port's dimension 1 (JAX's ``in``), whose shards are not contiguous
    in the leaf; their ranges of the flatten keep the -sr8 blocks whole."""
    for rank in range(WORLD):
        rep = gang[rank][f"bitwise_{layout}"]
        for recipe in ("lion-sr", "lion-sr8", "adamw-sr", "adamw-sr8"):
            assert rep[recipe] == {"params": True, "state": True}, (rank, recipe)
        assert len(rep["sharded_leaves"]) == 16
        if layout != "SHARD_GRAD_OP":
            assert "model.layers.0.mlp.down_proj.weight" in rep["dim1_leaves"]
            assert "model.layers.1.self_attn.q_proj.weight" in rep["dim1_leaves"]


def test_gather_for_metrics_drops_padded_tail(gang):
    """10 samples, 2 a rank, 4 ranks: the last global batch is padded with
    6 repeats; ``gather_for_metrics`` keeps its 2 real rows, as JAX's."""
    for rank in range(WORLD):
        np.testing.assert_array_equal(gang[rank]["feeds"]["metrics"], np.arange(10.0))


def test_prepared_loader_feeds_jax_process_local_rows(gang):
    """Under ``split_batches`` each rank reads the rows JAX's
    ``batch_rows_by_device`` gives its device (a device of the JAX mesh is
    a rank), cp peers the same rows."""
    devices = jax.devices()[:WORLD]
    for label, cfg in (("dp_shard", JaxParallelismConfig(dp_shard_size=4, devices=devices)),
                       ("cp", JaxParallelismConfig(cp_size=2, dp_shard_size=2,
                                                   devices=devices))):
        mesh = cfg.build_device_mesh()
        rows = batch_rows_by_device(mesh, cfg.batch_spec(seq_axis=None, ndim=1), (8,))
        for rank, dev in enumerate(mesh.devices.flat):
            start, stop = rows[dev]
            got = gang[rank]["feeds"][f"rows_{label}"]
            np.testing.assert_array_equal(got[0], np.arange(start, stop))
            np.testing.assert_array_equal(got[1], np.arange(8 + start, 8 + stop))
