"""The port's module hooks (``accelerate_tpu_torch/hooks.py``) held
against the JAX package's ``hooks.py``: every case of
``tests/test_hooks.py`` in torch form.  JAX wraps an apply function; the
port attaches the same hooks to an ``nn.Module`` (``add_hook_to_module``).
Both run ``y = x @ w + b`` on the same numpy weights; outputs agree at
1e-6, and the fp8 weights a casting hook upcasts are JAX's bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from accelerate_tpu import hooks as jh
from accelerate_tpu_torch import hooks as th
from accelerate_tpu_torch.big_modeling import offload_state_dict

ATOL = 1e-6


class Affine(nn.Module):
    """``y = x @ w + b`` (the JAX tests' apply function), ``w`` ``[4, 3]``."""

    def __init__(self, w, b):
        super().__init__()
        self.w = nn.Parameter(torch.as_tensor(np.asarray(w)).clone())
        self.b = nn.Parameter(torch.as_tensor(np.asarray(b)).clone())

    def forward(self, x):
        return x @ self.w + self.b


def _apply(params, x):
    return x @ params["w"] + params["b"]


def _params():
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((4, 3)).astype(np.float32), "b": np.zeros(3, np.float32)}


def _module():
    p = _params()
    return Affine(p["w"], p["b"])


def _jax_params():
    return {k: jnp.asarray(v) for k, v in _params().items()}


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)


def test_hook_pre_and_post_forward():
    calls = []

    class JScale(jh.ModelHook):
        def pre_forward(self, params, *args, **kwargs):
            return jax.tree.map(lambda p: p * 2, params), args, kwargs

        def post_forward(self, params, output):
            return output + 1

    class TScale(th.ModelHook):
        def pre_forward(self, module, *args, **kwargs):
            calls.append("pre")
            return (args[0] * 2,), kwargs

        def post_forward(self, module, output):
            calls.append("post")
            return output + 1

    x = np.ones((2, 4), np.float32)
    want = jh.add_hook_to_apply(_apply, JScale())(_jax_params(), jnp.asarray(x))
    # scaling the input by 2 scales x @ w by 2, as JAX's doubled params do
    # with b = 0
    got = th.add_hook_to_module(_module(), TScale())(torch.from_numpy(x))
    _close(got, want)
    assert calls == ["pre", "post"]


def test_sequential_hook_order():
    order = []

    def mk(tag):
        class H(th.ModelHook):
            def pre_forward(self, module, *args, **kwargs):
                order.append(f"pre-{tag}")
                return args, kwargs

            def post_forward(self, module, output):
                order.append(f"post-{tag}")
                return output

        return H()

    th.add_hook_to_module(_module(), th.SequentialHook(mk("a"), mk("b")))(torch.ones(1, 4))
    assert order == ["pre-a", "pre-b", "post-b", "post-a"]


def test_add_replaces_unless_append():
    class TAddOne(th.ModelHook):
        def post_forward(self, module, output):
            return output + 1

    class JAddOne(jh.ModelHook):
        def post_forward(self, params, output):
            return output + 1

    x = np.ones((1, 4), np.float32)
    j_once = jh.add_hook_to_apply(_apply, JAddOne())
    replaced_j = jh.add_hook_to_apply(j_once, JAddOne())(_jax_params(), jnp.asarray(x))
    appended_j = jh.add_hook_to_apply(j_once, JAddOne(), append=True)(_jax_params(),
                                                                     jnp.asarray(x))
    m = th.add_hook_to_module(_module(), TAddOne())
    th.add_hook_to_module(m, TAddOne())                       # replace: still +1
    _close(m(torch.from_numpy(x)), replaced_j)
    th.add_hook_to_module(m, TAddOne(), append=True)          # chain: +2
    _close(m(torch.from_numpy(x)), appended_j)
    assert len(m._forward_hooks) == 1 and len(m._forward_pre_hooks) == 1


def test_remove_hook_restores_original():
    class AddOne(th.ModelHook):
        def post_forward(self, module, output):
            return output + 1

    m = _module()
    x = torch.ones(1, 4)
    base = m(x)
    th.add_hook_to_module(m, AddOne())
    assert torch.equal(m(x), base + 1)
    assert th.remove_hook_from_module(m) is m
    assert torch.equal(m(x), base)
    assert not hasattr(m, "_at_hook") and not m._forward_hooks and not m._forward_pre_hooks
    assert th.remove_hook_from_module(m) is m          # no-op without a hook


def test_align_devices_hook_ships_host_params():
    x = np.ones((2, 4), np.float32)
    want = jh.attach_align_device_hook(_apply)({k: np.asarray(v) for k, v in _params().items()},
                                               jnp.asarray(x))
    m = th.attach_align_device_hook(_module(), execution_device="cpu")
    _close(m(torch.from_numpy(x)), want)


@pytest.mark.parametrize("io_buffer", [True, False])
def test_align_devices_hook_reads_offload_store(tmp_path, io_buffer):
    """The weights come from an offload store's memmaps (the module's own
    on ``meta``); a call fetches them and leaves the module as it was."""
    store = offload_state_dict(str(tmp_path), _params())
    lazy = {k: store.load(k) for k in _params()}
    x = np.ones((2, 4), np.float32)
    want = jh.attach_align_device_hook(_apply)(lazy, jnp.asarray(x))
    m = _module().to("meta")
    hook = th.AlignDevicesHook("cpu", io_buffer=io_buffer, weights_map=lazy)
    th.add_hook_to_module(m, hook)
    _close(m(torch.from_numpy(x)), want)
    assert m.w.device.type == "meta"                    # the copies were dropped


def test_align_devices_hook_without_offload_fetches_once(tmp_path):
    store = offload_state_dict(str(tmp_path), _params())
    m = _module().to("meta")
    th.add_hook_to_module(m, th.AlignDevicesHook(
        "cpu", offload=False, weights_map={k: store.load(k) for k in _params()}))
    x = torch.ones(2, 4)
    first = m(x)
    assert m.w.device.type == "cpu"                     # kept
    kept = m.w
    assert torch.equal(m(x), first) and m.w is kept


def test_cpu_offload_hook():
    x = np.ones((2, 4), np.float32)
    want = jh.add_hook_to_apply(_apply, jh.CpuOffloadHook())(_jax_params(), jnp.asarray(x))
    m = th.add_hook_to_module(_module(), th.CpuOffloadHook(execution_device="cpu"))
    _close(m(torch.from_numpy(x)), want)
    assert m.w.device.type == "cpu"


def test_layerwise_casting_hook():
    """fp8 storage upcast in-call: JAX's stored bits, JAX's output."""
    from accelerate_tpu.ops.precision import layerwise_casting as j_layerwise_casting
    from accelerate_tpu_torch.ops.precision import layerwise_casting

    kernel = (np.random.default_rng(0).standard_normal((4, 3)) * 0.1).astype(np.float32)
    j_cast, _ = j_layerwise_casting({"dense": {"kernel": jnp.asarray(kernel)}},
                                    jnp.float8_e4m3fn, jnp.float32, skip_patterns=())
    x = np.ones((2, 4), np.float32)
    want = jh.add_hook_to_apply(lambda p, x: x @ p["dense"]["kernel"],
                                jh.LayerwiseCastingHook(jnp.float8_e4m3fn, jnp.float32))(
        j_cast, jnp.asarray(x))
    m = Affine(kernel, np.zeros(3, np.float32))
    with torch.no_grad():
        m.b.zero_()
    layerwise_casting(m, torch.float8_e4m3fn, torch.float32, skip_patterns=("b",))
    assert m.w.dtype == torch.float8_e4m3fn and m.b.dtype == torch.float32
    np.testing.assert_array_equal(m.w.view(torch.uint8).numpy(),
                                  np.asarray(j_cast["dense"]["kernel"]).view(np.uint8))
    _close(m(torch.from_numpy(x)), want)
    assert m.w.dtype == torch.float8_e4m3fn            # stored again after the call


def _counting_reads(monkeypatch):
    from accelerate_tpu_torch import native

    calls, real = [], native.read_file

    def read_file(path, *args, **kwargs):
        calls.append(str(path))
        return real(path, *args, **kwargs)

    monkeypatch.setattr(native, "read_file", read_file)
    return calls


def test_align_devices_hook_reads_memmaps_through_the_staging_slot(tmp_path, monkeypatch):
    """With ``io_buffer`` each memmap weight is read from its file (the
    native engine's ``pread`` into the hook's one staging slot) on every
    call; the outputs are JAX's and equal call to call.  Without it the
    file is not read that way."""
    calls = _counting_reads(monkeypatch)
    store = offload_state_dict(str(tmp_path), _params())
    lazy = {k: store.load(k) for k in _params()}
    x = np.ones((2, 4), np.float32)
    want = jh.attach_align_device_hook(_apply)(lazy, jnp.asarray(x))
    m = th.add_hook_to_module(_module().to("meta"), th.AlignDevicesHook("cpu", weights_map=lazy))
    first, second = m(torch.from_numpy(x)), m(torch.from_numpy(x))
    _close(first, want)
    assert torch.equal(first, second)
    assert sorted(calls) == sorted(2 * [str(store._path(k)) for k in lazy])
    calls.clear()
    plain = th.add_hook_to_module(_module().to("meta"),
                                  th.AlignDevicesHook("cpu", io_buffer=False, weights_map=lazy))
    assert torch.equal(plain(torch.from_numpy(x)), first) and calls == []


def test_pinned_staging_reads_files_and_keeps_bits(tmp_path, monkeypatch):
    """The staging slot behind the hook and the streamed decode.  With
    ``read_files`` (the hook's), a tensor over a whole ``.dat`` file
    (``offload_store_params``) and a read-only memmap (``OffloadStore.load``,
    bf16 as its 16-bit patterns, viewed as the ``like`` tensor's dtype) are
    read from their files, a tensor in memory and a copy-on-write memmap
    copied; without it (the streamed decode's) every source is copied.
    Every result is the source's bits; slots are taken in turn."""
    from accelerate_tpu_torch.big_modeling import offload_store_params
    from accelerate_tpu_torch.ops.streaming import PinnedStaging, file_span

    calls = _counting_reads(monkeypatch)
    src = {"w": torch.randn(5, 7, dtype=torch.bfloat16), "s": torch.tensor(3.0)}
    store = offload_state_dict(str(tmp_path), src)
    mapped = offload_store_params(store)
    cow = np.memmap(store._path("w"), dtype=np.uint16, mode="c", shape=(5, 7))
    assert file_span(mapped["w"]) == (str(store._path("w")), 0)
    assert file_span(store.load("w")) is not None and file_span(cow) is None
    assert file_span(src["w"]) is None and file_span(mapped["w"][1:]) is None
    sources = {"a": mapped["w"], "b": store.load("w"), "c": src["w"], "d": cow,
               "e": mapped["s"]}
    for read_files in (True, False):
        calls.clear()
        staging = PinnedStaging(2, pin=False, read_files=read_files)
        out, slot = staging.stage(sources, like={"b": src["w"], "d": src["w"]})
        assert slot == 0 and staging.stage({"c": src["w"]})[1] == 1
        for k in "abcd":
            assert out[k].dtype == torch.bfloat16 and torch.equal(
                out[k].view(torch.int16), src["w"].view(torch.int16)), k
        assert out["e"].shape == () and float(out["e"]) == 3.0
        read = sorted([str(store._path("w"))] * 2 + [str(store._path("s"))])
        assert sorted(calls) == (read if read_files else [])
    with pytest.raises(ValueError, match="bytes"):
        staging.stage({"w": mapped["w"]}, like={"w": src["s"]})
