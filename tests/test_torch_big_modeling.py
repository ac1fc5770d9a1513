"""The port's big-model loading, placement and offload
(``accelerate_tpu_torch/big_modeling.py``) held against the JAX package's.

Integers are held exactly: the module sizes and placements of JAX's own
test trees (run through both planners as they are) and of
``LlamaConfig.tiny()`` in f32, whose module names map to JAX's flax paths
through ``models/convert.py``.  Flax sorts a module's children by name
where torch keeps their registration order, so the Llama placements are
compared at budgets where the greedy fill does not depend on that order
(whole layers on each tier).  The offload store's ``index.json`` and
``.dat`` files must be JAX's bytes; a checkpoint loaded into a ``meta``
model gives JAX's logits at 1e-5 (absolute and relative).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accelerate_tpu_torch as at
from accelerate_tpu import big_modeling as jbm
from accelerate_tpu.models import llama as jl
from accelerate_tpu.models.hf_interop import load_hf_llama as j_load_hf_llama
from accelerate_tpu_torch import big_modeling as tbm
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.models.convert import flax_to_hf_name, torch_state_from_flax
from accelerate_tpu_torch.utils.serialization import save_safetensors

ATOL = RTOL = 1e-5
TINY = dict(dtype=torch.float32)


@pytest.fixture(scope="module")
def pair():
    model_j = jl.LlamaForCausalLM(jl.LlamaConfig.tiny(dtype=jnp.float32))
    params = model_j.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree.map(lambda x: np.array(x, copy=True), params)
    model_t = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(**TINY), device="cpu")
    model_t.load_state_dict(torch_state_from_flax(params))
    return model_j, params, model_t


@pytest.fixture(scope="module")
def hf_file(pair, tmp_path_factory):
    """One HF-format safetensors file of the pair's weights."""
    _, _, model_t = pair
    path = tmp_path_factory.mktemp("hf") / "model.safetensors"
    save_safetensors(path, model_t.state_dict())
    return path


def _meta_model(**kw):
    return tbm.abstract_init(tl.LlamaForCausalLM, tl.LlamaConfig.tiny(**TINY, **kw),
                             device="cpu")


def _port_name(jax_path: str, jax_sizes: dict) -> str:
    """A JAX module / leaf path as the port's name: a leaf below it mapped
    through ``flax_to_hf_name``, as many trailing parts dropped again."""
    leaf = next(p for p in jax_sizes if p == jax_path or p.startswith(jax_path + "."))
    leaf = max((p for p in jax_sizes if p.startswith(leaf)), key=len)
    extra = leaf.count(".") - jax_path.count(".")
    name = flax_to_hf_name(leaf)
    return name.rsplit(".", extra)[0] if extra else name


# -- meta-device init ---------------------------------------------------------


def test_abstract_init_puts_every_parameter_on_meta():
    model = _meta_model()
    params = list(model.parameters())
    assert len(params) > 10 and all(p.device.type == "meta" for p in params)
    # buffers stay real unless asked: the rope tables
    assert model.rope_cos.device.type == "cpu"
    with tbm.init_empty_weights(include_buffers=True):
        full = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(**TINY), device="cpu")
    assert full.rope_cos.device.type == "meta"


def test_init_empty_weights_keeps_tied_weights_and_restores_registration():
    tied = _meta_model(tie_word_embeddings=True)
    assert tied.lm_head.weight is tied.model.embed_tokens.weight
    assert "lm_head.weight" not in tbm._named_tensors(tied)
    real = torch.nn.Linear(2, 2)
    assert real.weight.device.type == "cpu"


def test_init_on_device_places_parameters_on_the_device():
    """``init_on_device(device)`` (the reference's signature) builds on that
    device, buffers where they are made unless ``include_buffers``;
    ``init_empty_weights`` is the same on ``meta``."""
    with tbm.init_on_device("meta"):
        lin = torch.nn.Linear(3, 2)
        bn = torch.nn.BatchNorm1d(2)
    assert lin.weight.device.type == "meta" and isinstance(lin.weight, torch.nn.Parameter)
    assert bn.weight.device.type == "meta" and bn.running_mean.device.type == "cpu"
    with tbm.init_on_device(torch.device("meta"), include_buffers=True):
        bn = torch.nn.BatchNorm1d(2)
    assert bn.running_mean.device.type == "meta"
    with tbm.init_on_device("cpu"):
        model = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(**TINY), device="cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())
    assert model(torch.ones(1, 4, dtype=torch.long)).shape == (1, 4, 256)
    with pytest.raises(TypeError, match="include_buffers"):
        with tbm.init_on_device("meta", "cpu"):
            pass
    assert torch.nn.Linear(2, 2).weight.device.type == "cpu"     # restored


def test_init_params_leafwise_materialises_each_tensor():
    model = _meta_model()
    tbm.init_params_leafwise(model, device="cpu", placement={"model.layers.1": "cpu"},
                             dtype=torch.bfloat16)
    assert all(p.device.type == "cpu" and p.dtype == torch.bfloat16 for p in model.parameters())
    assert torch.equal(model.model.norm.weight, torch.ones(64, dtype=torch.bfloat16))
    std = float(model.model.layers[0].self_attn.q_proj.weight.float().std())
    assert std == pytest.approx(0.02, rel=0.2)
    assert model(torch.ones(1, 8, dtype=torch.long)).shape == (1, 8, 256)
    with pytest.raises(ValueError, match="offload_folder"):
        tbm.init_params_leafwise(_meta_model(), device="cpu", placement={"lm_head": "disk"})


# -- sizes and placement --------------------------------------------------------


def test_compute_module_sizes_synthetic_equals_jax():
    params = {"a": {"w": np.ones((4, 4), np.float32)}, "b": np.ones((2,), np.float32)}
    want = jbm.compute_module_sizes(params)
    got = tbm.compute_module_sizes({"a": {"w": torch.ones(4, 4)}, "b": torch.ones(2)})
    assert got == want == {"a.w": 64, "a": 64, "b": 8, "": 72}
    # dotted names are levels too
    assert tbm.compute_module_sizes({"a.w": torch.ones(4, 4), "b": torch.ones(2)}) == want


def test_compute_module_sizes_llama_equals_jax(pair):
    model_j, _, _ = pair
    abstract = jbm.abstract_init(model_j, jax.random.key(0), jnp.ones((1, 8), jnp.int32))
    want = jbm.compute_module_sizes(abstract)
    got = tbm.compute_module_sizes(_meta_model())
    assert got[""] == want[""]
    compared = set()
    for path, size in want.items():
        if path in ("", "params"):        # the port's root has model and lm_head
            continue
        name = _port_name(path, want)
        assert got[name] == size, path
        compared.add(name)
    # every port module but the root, "model" and the ModuleList level
    assert compared == set(got) - {"", "model", "model.layers"}


def _shape_tree(tree):
    return jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32), tree,
                        is_leaf=lambda x: isinstance(x, tuple))


JAX_CASES = {
    "overflow to cpu and disk": (
        {"big": (1024,), "medium": (256,), "small": (64,)},
        dict(max_memory={0: 4200, "cpu": 1100})),
    "descends below the root": (
        {"params": {"layer0": {"w": (256,)}, "layer1": {"w": (256,)}, "layer2": {"w": (256,)}}},
        dict(max_memory={0: 1100, "cpu": 1100})),
    "no_split_paths": (
        {"params": {"block": {"a": (256,), "b": (256,)}}},
        dict(max_memory={0: 1100, "cpu": 4096}, no_split_paths=["params.block"])),
    "raises when full": (
        {"big": (1024,)}, dict(max_memory={0: 10, "cpu": 10}, offload_to_disk=False)),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_infer_auto_placement_equals_jax(case):
    shapes, kw = JAX_CASES[case]
    port_tree = jax.tree.map(lambda s: torch.empty(s, device="meta"), shapes,
                             is_leaf=lambda x: isinstance(x, tuple))
    try:
        want = jbm.infer_auto_placement(_shape_tree(shapes), **kw)
    except ValueError as e:
        assert "Cannot place" in str(e)
        with pytest.raises(ValueError, match="Cannot place"):
            tbm.infer_auto_placement(port_tree, **kw)
        return
    assert tbm.infer_auto_placement(port_tree, **kw) == want


def _llama_budgets(sizes):
    emb, layer, head = sizes["params.embed_tokens"], sizes["params.layers_0"], \
        sizes["params.lm_head"]
    return {
        "layer 0 on the card, layer 1 on cpu, the rest on disk": {0: emb + layer + 100,
                                                                   "cpu": layer + 100},
        "both layers on cpu": {0: emb + 300, "cpu": 2 * layer + head},
        "all on the card": {0: sizes[""], "cpu": 0},
    }


@pytest.mark.parametrize("case", [
    "layer 0 on the card, layer 1 on cpu, the rest on disk", "both layers on cpu",
    "all on the card"])
@pytest.mark.parametrize("no_split", [False, True])
def test_infer_auto_placement_llama_equals_jax(pair, case, no_split):
    model_j, _, _ = pair
    abstract = jbm.abstract_init(model_j, jax.random.key(0), jnp.ones((1, 8), jnp.int32))
    sizes = jbm.compute_module_sizes(abstract)
    budget = _llama_budgets(sizes)[case]
    j_split = ["params.layers_0", "params.layers_1"] if no_split else None
    t_split = ["model.layers.0", "model.layers.1"] if no_split else None
    want = jbm.infer_auto_placement(abstract, max_memory=budget, no_split_paths=j_split)
    model = _meta_model()
    got = tbm.infer_auto_placement(model, max_memory=budget, no_split_paths=t_split)
    if "params" not in want:      # JAX's root is one module, "params": whole on one tier
        assert got == {_port_name(p, sizes): v for p, v in want.items()}
    # every tensor on JAX's tier for its leaf
    j_norm = jbm._normalize_placement(want)
    leaves = {flax_to_hf_name(p): p for p in sizes
              if p and not any(q.startswith(p + ".") for q in sizes)}
    assert set(leaves) == set(tbm._named_tensors(model))
    for name, leaf in leaves.items():
        assert tbm._lookup_placement(name, got) == \
            jbm._lookup_placement(leaf.replace(".", "/"), j_norm), name


def test_get_max_memory_parses_sizes():
    assert tbm.get_max_memory({0: "2GB", "cpu": "512MB", "disk": 7}) == \
        jbm.get_max_memory({0: "2GB", "cpu": "512MB", "disk": 7}) == \
        {0: 2 * 2**30, "cpu": 512 * 2**20, "disk": 7}
    auto = tbm.get_max_memory()
    assert auto["cpu"] > 0
    assert [k for k in auto if isinstance(k, int)] == list(range(torch.cuda.device_count()))


# -- the offload store ------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_offload_state_dict_writes_jax_bytes(tmp_path, dtype):
    import ml_dtypes

    rng = np.random.default_rng(3)
    arrays = {"layer/w": rng.normal(size=(3, 5)).astype(np.float32),
              "model.layers.0.b": rng.normal(size=(7,)).astype(np.float32),
              "scalar": np.asarray(1.5, np.float32)}
    if dtype == "int8":
        arrays = {k: np.asarray((v * 40).astype(np.int8)) for k, v in arrays.items()}
    j_arrays = {k: v.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else v
                for k, v in arrays.items()}
    t_arrays = {k: torch.from_numpy(v).to(torch.bfloat16) if dtype == "bfloat16"
                else torch.from_numpy(v) for k, v in arrays.items()}
    jbm.offload_state_dict(str(tmp_path / "jax"), j_arrays)
    tbm.offload_state_dict(str(tmp_path / "port"), t_arrays)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    for name in names:
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "port" / name).read_bytes()
    store = tbm.OffloadStore(tmp_path / "port")
    for key, t in t_arrays.items():
        mapped = tbm._mapped_tensor(store, key)
        assert mapped.dtype == t.dtype and torch.equal(mapped, t)
    assert json.loads((tmp_path / "port" / "index.json").read_text())["scalar"]["shape"] == []


def test_offload_store_params_maps_without_copying(tmp_path, pair):
    _, _, model_t = pair
    store = tbm.offload_state_dict(str(tmp_path), model_t.state_dict())
    lazy = tbm.offload_store_params(store)
    assert lazy.keys() == model_t.state_dict().keys()
    for k, v in model_t.state_dict().items():
        assert torch.equal(lazy[k], v)
    # the same file backs a second map: nothing was copied into memory
    again = tbm.offload_store_params(store)
    assert again["lm_head.weight"].data_ptr() != lazy["lm_head.weight"].data_ptr()


# -- streaming a checkpoint -------------------------------------------------------


def _write_shards(state: dict, folder, n: int = 3):
    """``state`` as ``n`` HF-style shards plus ``model.safetensors.index.json``."""
    folder.mkdir(parents=True, exist_ok=True)
    names = list(state)
    weight_map = {}
    for i in range(n):
        part = {k: state[k] for k in names[i::n]}
        fname = f"model-{i + 1:05d}-of-{n:05d}.safetensors"
        save_safetensors(folder / fname, part)
        weight_map.update({k: fname for k in part})
    (folder / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))
    return folder


def test_load_checkpoint_in_model_logits_equal_jax(pair, hf_file):
    """One HF-format file, streamed into a meta model on both sides (JAX
    through its ``load_hf_llama``): logits at 1e-5."""
    model_j, _, model_t = pair
    params_j, _ = j_load_hf_llama(model_j, hf_file, dtype=jnp.float32)
    model, store = tbm.load_checkpoint_in_model(_meta_model(), hf_file, device="cpu",
                                                strict=True)
    assert store is None
    ids = np.random.default_rng(0).integers(0, 256, (2, 12))
    want = np.asarray(model_j.apply(params_j, jnp.asarray(ids, jnp.int32)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    for k, v in model_t.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


@pytest.mark.parametrize("layout", ["index", "directory", "npz", "iterable"])
def test_load_checkpoint_sources(pair, tmp_path, layout):
    _, _, model_t = pair
    state = model_t.state_dict()
    if layout == "index":
        src = _write_shards(state, tmp_path / "sharded")
    elif layout == "directory":
        src = tmp_path / "plain"
        src.mkdir()
        save_safetensors(src / "a.safetensors", dict(list(state.items())[:5]))
        save_safetensors(src / "b.safetensors", dict(list(state.items())[5:]))
    elif layout == "npz":
        src = tmp_path / "npz"
        src.mkdir()
        np.savez(src / "w.npz", **{k: v.numpy() for k, v in state.items()})
    else:
        src = iter(list(state.items()))
    model, _ = tbm.load_checkpoint_in_model(_meta_model(), src, device="cpu", strict=True)
    for k, v in state.items():
        assert torch.equal(model.state_dict()[k], v), k


def test_load_checkpoint_tiers_and_dtype(pair, tmp_path, hf_file):
    """Each tensor lands at its placement: the device, host, or the store
    (then a memory map of its .dat file); cast to ``dtype`` on the host;
    ``offloaded_apply`` runs the tiered model as the resident one."""
    _, _, model_t = pair
    placement = {"model.layers.1": "cpu", "lm_head": "disk", "model.norm": 0}
    model, store = tbm.load_checkpoint_in_model(
        _meta_model(), hf_file, device="cpu", dtype=torch.bfloat16, offload_placement=placement,
        offload_folder=str(tmp_path), strict=True)
    assert sorted(store.keys()) == ["lm_head.weight"]
    assert torch.equal(tbm._mapped_tensor(store, "lm_head.weight"), model.lm_head.weight)
    assert all(t.dtype == torch.bfloat16 for t in model.state_dict().values())
    assert torch.equal(model.model.layers[1].mlp.up_proj.weight,
                       model_t.model.layers[1].mlp.up_proj.weight.to(torch.bfloat16))
    ids = torch.randint(0, 256, (1, 6))
    ref = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(dtype=torch.bfloat16), device="cpu")
    ref.load_state_dict(model_t.state_dict())
    with torch.no_grad():
        assert torch.equal(tbm.offloaded_apply(model, "cpu")(model, ids), ref(ids))


def test_load_checkpoint_strict_and_shape_errors(pair, tmp_path, hf_file):
    _, _, model_t = pair
    state = dict(model_t.state_dict())
    state.pop("model.norm.weight")
    partial = tmp_path / "partial.safetensors"
    save_safetensors(partial, state)
    with pytest.raises(ValueError, match="missing keys: \\['model.norm.weight'\\]"):
        tbm.load_checkpoint_in_model(_meta_model(), partial, device="cpu", strict=True)
    model, _ = tbm.load_checkpoint_in_model(_meta_model(), partial, device="cpu")
    assert model.model.norm.weight.device.type == "meta"      # left as it was
    extra = tmp_path / "extra.safetensors"
    save_safetensors(extra, {**model_t.state_dict(), "model.stray.weight": torch.ones(2)})
    with pytest.raises(ValueError, match="unexpected keys: \\['model.stray.weight'\\]"):
        tbm.load_checkpoint_in_model(_meta_model(), extra, device="cpu", strict=True)
    narrow = tbm.abstract_init(tl.LlamaForCausalLM,
                               tl.LlamaConfig.tiny(hidden_size=32, **TINY), device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        tbm.load_checkpoint_in_model(narrow, hf_file, device="cpu")


def test_load_checkpoint_and_dispatch_tiers_as_jax_plans(pair, tmp_path, hf_file):
    """``device_map="auto"`` over a card budget: the same placement as
    JAX's planner; every tensor lands where it says."""
    model_j, _, _ = pair
    abstract = jbm.abstract_init(model_j, jax.random.key(0), jnp.ones((1, 8), jnp.int32))
    sizes = jbm.compute_module_sizes(abstract)
    budget = _llama_budgets(sizes)["layer 0 on the card, layer 1 on cpu, the rest on disk"]
    stats = {}
    model, store = tbm.load_checkpoint_and_dispatch(
        _meta_model(), hf_file, max_memory=budget, offload_folder=str(tmp_path), device="cpu",
        stats=stats)
    plan = {_port_name(p, sizes): v for p, v in jbm.infer_auto_placement(
        abstract, max_memory=budget).items()}
    on_disk = {k for k in tbm._named_tensors(model) if tbm._lookup_placement(k, plan) == "disk"}
    assert set(store.keys()) == on_disk and on_disk
    assert stats["tensors"] == 21 and stats["bytes"] == sizes[""]
    # no budget pressure: no placement, no store
    model, store = tbm.load_checkpoint_and_dispatch(_meta_model(), hf_file,
                                                    max_memory={0: sizes[""], "cpu": 0},
                                                    device="cpu")
    assert store is None


def test_load_checkpoint_and_serve_equals_the_in_process_engine(pair, hf_file):
    from accelerate_tpu_torch import Request, ServingEngine, ServingPlugin

    _, _, model_t = pair
    plugin = ServingPlugin(num_slots=2, page_size=8, pages_per_slot=4, num_pages=8,
                           prefill_chunk=16)
    gc = at.GenerationConfig(max_new_tokens=6)
    engine = tbm.load_checkpoint_and_serve(_meta_model(), hf_file, serving_plugin=plugin,
                                           generation_config=gc, device="cpu")
    ref = ServingEngine(model_t, plugin, gc, device="cpu")
    prompts = [(5, 42, 7, 9), (11, 3, 77)]
    for e in (engine, ref):
        for uid, p in enumerate(prompts):
            e.add_request(Request(uid=uid, prompt=p, max_new_tokens=6))
    assert engine.run([]) == ref.run([])


# -- placing materialised weights -------------------------------------------------


def test_dispatch_model_tiers_and_bytes_equal_jax(pair, tmp_path):
    """JAX's case (a mapping to cpu and disk), then the Llama: every tensor
    on the tier JAX puts its leaf on, the disk tier's .dat bytes JAX's."""
    placed, store = tbm.dispatch_model({"a": torch.ones(4), "b": torch.ones(4)},
                                       {"a": "cpu", "b": "disk"},
                                       offload_folder=str(tmp_path / "ab"), device="cpu")
    assert placed["a"].device.type == "cpu" and list(store.keys()) == ["b"]
    assert torch.equal(placed["b"], torch.ones(4))

    _, params, model_t = pair
    j_placement = {"params.layers_1": "cpu", "params.lm_head": "disk", "params.norm": "disk"}
    j_placed, j_store = jbm.dispatch_model(params, j_placement,
                                           offload_folder=str(tmp_path / "jax"))
    sizes = jbm.compute_module_sizes(params)
    t_placement = {_port_name(p, sizes): v for p, v in j_placement.items()}
    model = tl.LlamaForCausalLM(model_t.config, device="cpu")
    model.load_state_dict(model_t.state_dict())
    model, store = tbm.dispatch_model(model, t_placement, offload_folder=str(tmp_path / "port"),
                                      device="cpu")
    flat, _ = jax.tree_util.tree_flatten_with_path(j_placed)
    for path, leaf in flat:
        key = "/".join(str(k.key) for k in path)
        name = flax_to_hf_name(key.replace("/", "."))
        assert (name in store) == isinstance(leaf, np.memmap), name
        if name in store:          # a kernel is [in, out] in JAX, [out, in] here
            want = np.asarray(leaf).T if key.endswith("kernel") else np.asarray(leaf)
            assert (tmp_path / "port" / f"{name}.dat").read_bytes() == \
                np.ascontiguousarray(want).tobytes()
            assert (tmp_path / "jax" / f"{key.replace('/', '--')}.dat").read_bytes() == \
                np.asarray(leaf).tobytes()
    ids = torch.randint(0, 256, (1, 5))
    with torch.no_grad():
        assert torch.equal(tbm.offloaded_apply(model, "cpu")(model, ids), model_t(ids))


def test_cpu_and_disk_offload_wrappers(tmp_path):
    """JAX's case: the whole mapping leaves the device; the wrapped call
    fetches it per call and computes the same output."""
    params = {"dense": {"kernel": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                        "bias": torch.ones(4)}}

    def apply_fn(p, x):
        return x @ p["dense"]["kernel"] + p["dense"]["bias"]

    x = torch.ones(2, 3)
    want = apply_fn(params, x)
    placed, wrapped = at.cpu_offload(params, apply_fn, execution_device="cpu")
    assert torch.equal(wrapped(placed, x), want)
    placed_d, wrapped_d = at.disk_offload(params, tmp_path / "off", apply_fn,
                                          execution_device="cpu")
    assert sorted(tbm.OffloadStore(tmp_path / "off").keys()) == ["dense.bias", "dense.kernel"]
    assert torch.equal(wrapped_d(placed_d, x), want)
    # numpy leaves (JAX's host tier) are fetched too
    np_params = {"w": np.arange(8.0, dtype=np.float32).reshape(2, 4)}
    out = tbm.offloaded_apply(lambda p, x: x @ p["w"], "cpu")(np_params, torch.ones(3, 2))
    assert torch.equal(out, torch.ones(3, 2) @ torch.from_numpy(np_params["w"]))


def test_reference_parity_top_level_exports():
    for name in ["init_empty_weights", "init_on_device", "abstract_init", "init_params_leafwise",
                 "compute_module_sizes", "get_max_memory", "infer_auto_placement",
                 "infer_auto_device_map", "offload_state_dict", "offload_store_params",
                 "load_checkpoint_in_model", "load_checkpoint_and_dispatch", "serve_model",
                 "load_checkpoint_and_serve", "dispatch_model", "cpu_offload", "disk_offload",
                 "offloaded_apply", "hooks", "layerwise_casting", "load_hf_llama",
                 "quantized_apply", "load_and_quantize_model", "place_params_host",
                 "generate_streamed", "beam_search", "LayerPrefetcher", "StreamStats"]:
        assert hasattr(at, name), name
    assert at.infer_auto_device_map is at.infer_auto_placement


def test_offload_store_reads_bf16_without_ml_dtypes(tmp_path):
    """A bf16 tensor's store entry loads as its 16-bit patterns where numpy
    knows no ``bfloat16`` (no ``ml_dtypes`` imported: the port alone, as
    on the card)."""
    import subprocess
    import sys

    code = (
        "import sys, torch\n"
        "from accelerate_tpu_torch.big_modeling import offload_state_dict\n"
        f"store = offload_state_dict({str(tmp_path)!r}, "
        "{'w': torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)})\n"
        "assert 'ml_dtypes' not in sys.modules\n"
        "bits = store.load('w')\n"
        "assert bits.dtype.name == 'uint16' and bits.shape == (2, 3), bits.dtype\n"
        "assert torch.equal(store.load_tensor('w'), "
        "torch.arange(6, dtype=torch.bfloat16).reshape(2, 3))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    done = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120)
    assert done.returncode == 0, done.stderr
