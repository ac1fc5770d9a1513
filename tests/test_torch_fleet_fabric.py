"""The port's two-process serving fabric
(``accelerate_tpu_torch/test_utils/scripts/fleet_fabric.py``) against the
JAX package's pins (``tests/test_router.py::
test_fleet_fabric_two_process_launch``).

A gloo gang of 2 CPU processes serves JAX's fabric trace on the tiny f32
Llama with the JAX model's weights (``torch_state_from_flax``), over int8
and fp8 pages: rank 1's tokens are bitwise its fused serve's and equal the
JAX package's ``ServingEngine.run`` with the decode plugin; bytes sent =
bytes received = JAX's ``transfer_accounting``, exactly; the fleet smoke's
goodput is 1.0 with prefix-routed placements; a plugin pair whose page
size or page dtype differs is refused on both ranks before any engine is
built.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from accelerate_tpu.generation import GenerationConfig as JaxGenerationConfig
from accelerate_tpu.models import llama as jl
from accelerate_tpu.serving import Request as JaxRequest
from accelerate_tpu.serving import ServingEngine as JaxServingEngine
from accelerate_tpu.serving import transfer_accounting as jax_transfer_accounting
from accelerate_tpu.utils.dataclasses import ServingPlugin as JaxServingPlugin
from accelerate_tpu_torch.models.convert import torch_state_from_flax
from accelerate_tpu_torch.test_utils import fleet_fabric_script_path, train_fabric_script_path
from accelerate_tpu_torch.test_utils.gang import run_gang
from accelerate_tpu_torch.test_utils.scripts.fleet_fabric import fabric_trace, plugins

TARGET = "accelerate_tpu_torch.test_utils.scripts.fleet_fabric"


@pytest.fixture(scope="module")
def weights():
    cfg = jl.LlamaConfig.tiny(dtype=jnp.float32)
    model = jl.LlamaForCausalLM(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return cfg, model, params, torch_state_from_flax(jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module", params=["int8", "fp8"])
def gang(request, weights, tmp_path_factory):
    d = tmp_path_factory.mktemp(f"fabric_{request.param}")
    return request.param, run_gang(f"{TARGET}:fabric", 2, d, timeout=60, state=weights[3],
                                   kv_dtype=request.param)


def _jax_decode_serve(weights, kv_dtype: str) -> dict:
    cfg, model, params, _ = weights
    decode = plugins(kv_dtype)[1]
    plugin = JaxServingPlugin(**{f.name: getattr(decode, f.name)
                                 for f in dataclasses.fields(JaxServingPlugin)
                                 if hasattr(decode, f.name)})
    eng = JaxServingEngine(model, params, plugin,
                           JaxGenerationConfig(max_new_tokens=6, eos_token_id=None))
    trace = [JaxRequest(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                        arrival_step=r.arrival_step, deadline_ticks=r.deadline_ticks)
             for r in fabric_trace(23, 6)]
    return {uid: [int(t) for t in toks] for uid, toks in eng.run(trace).items()}


def test_decode_tokens_bitwise_the_fused_serve(gang):
    _, (prefill, decode) = gang
    assert prefill["role"] == "prefill" and decode["role"] == "decode"
    assert decode["results"] == decode["fused"]
    assert decode["parity"] and prefill["parity"]
    assert prefill["completed"] == len(decode["results"]) == 6
    assert all(len(t) >= 2 for t in decode["results"].values())


def test_decode_tokens_equal_jax_engine(gang, weights):
    kv_dtype, (_, decode) = gang
    assert decode["results"] == _jax_decode_serve(weights, kv_dtype)


def test_bytes_sent_received_equal_jax_accounting(gang, weights):
    kv_dtype, (prefill, decode) = gang
    want = jax_transfer_accounting(weights[0], fabric_trace(23, 6), 4,
                                   kv_dtype=kv_dtype)["page_transfer_bytes"]
    assert want > 0
    assert prefill["bytes_sent"] == prefill["bytes_recv"] == decode["bytes_recv"] == want
    assert prefill["bytes_pred"] == want
    # the pps-wide payload: every leaf of every request crossed, both ways
    assert prefill["wire_bytes"] == prefill["wire_bytes_recv"] == decode["wire_bytes"]


def test_fleet_smoke_on_rank_0(gang):
    _, (prefill, _) = gang
    fleet = prefill["fleet"]
    assert fleet["replicas"] == 2
    assert fleet["goodput_frac"] == 1.0
    assert fleet["routed_by_prefix"] > 0


@pytest.mark.parametrize("overrides", [{"page_size": 8}, {"kv_dtype": "fp8"}],
                         ids=["page_size", "kv_dtype"])
def test_schema_mismatch_raises_on_both_ranks_before_allocation(weights, overrides, tmp_path):
    out = run_gang(f"{TARGET}:schema_gate", 2, tmp_path, timeout=60, state=weights[3],
                   decode_overrides=overrides)
    word = "page geometry" if "page_size" in overrides else "page dtypes"
    for rank in out:
        assert word in rank["error"]
        assert rank["engines_built"] == 0


def test_script_paths_exist():
    assert fleet_fabric_script_path().name == "fleet_fabric.py"
    assert train_fabric_script_path().name == "train_fabric.py"
    assert fleet_fabric_script_path().is_file() and train_fabric_script_path().is_file()
