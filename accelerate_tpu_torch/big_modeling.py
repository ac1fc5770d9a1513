"""Big-model loading, placement and offload (mirrors
``accelerate_tpu/big_modeling.py``).

A user takes a checkpoint from disk onto the card, even when it does not
fit there:

- :func:`init_empty_weights` (JAX :118) builds a model with its parameters
  on the ``meta`` device: no memory, no init.  JAX's is a no-op (flax init
  is lazy already); here it is the torch reference's meaning, a patch of
  ``nn.Module.register_parameter`` for the duration of the block.
  :func:`abstract_init` (JAX :51) builds one under it.
- :func:`compute_module_sizes` (:138), :func:`get_max_memory` (:164) and
  :func:`infer_auto_placement` (:233, alias :data:`infer_auto_device_map`)
  plan which modules live on the card, in pinned host memory (``"cpu"``)
  or on disk (``"disk"``).  Keys are the port's module names
  (``model.layers.3``) where JAX's are flax paths; sizes and the greedy
  rule are JAX's, so the same tree gives the same integers.
- :func:`load_checkpoint_in_model` (:433) streams a safetensors file, an
  index of shards, a directory or an iterable of ``(name, tensor)`` into
  an ``nn.Module`` (one on ``meta`` included), one tensor at a time, each
  cast on the host before its copy and landing at its placement: the card,
  pinned host memory, or an :class:`OffloadStore` file that the parameter
  then maps (``np.memmap``: no host memory until read).
  :func:`load_checkpoint_and_dispatch` (:537) plans and loads in one call;
  :func:`load_checkpoint_and_serve` (:601) then stands up a
  :class:`~accelerate_tpu_torch.serving.ServingEngine` on the result.
- :func:`dispatch_model` (:619), :func:`cpu_offload` (:648),
  :func:`disk_offload` (:660) and :func:`offloaded_apply` (:677) place a
  model or a name -> tensor dict that exists already, and run it with the
  off-card tensors fetched for one call.  The layer-streamed decode is
  ``generation.generate_streamed``; the hooks that run a module whose
  weights live elsewhere are in ``hooks.py``.

Disk-backed tensors: one ``.dat`` memmap per tensor plus ``index.json``,
the reference ``OffloadedWeightsLoader`` format (:class:`OffloadStore`,
JAX :286-330; also the adapter pool's cold tier, ``serving/adapters.py``).
numpy has no bfloat16, so a bf16 tensor is stored as its 16-bit patterns
under the dtype name ``"bfloat16"`` — the bytes and index the JAX store
writes for an ``ml_dtypes`` bf16 array — and :meth:`OffloadStore.load_tensor`
reads it back as a ``torch.bfloat16`` tensor.

Placement targets are a card index (``0``), ``"cpu"`` or ``"disk"``; a
tensor that no placement entry covers goes to ``device`` (``"cuda"`` unless
the caller asks for the CPU, as the tests do).  "Pinned" host memory is
pinned where a card exists.  JAX's sharding plans have no counterpart: the
port drives one card.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from pathlib import Path
from typing import Any, Callable, Iterator, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from .ops.streaming import register_file_backed
from .utils.constants import SAFE_WEIGHTS_INDEX_NAME
from .utils.device import resolve_device

logger = logging.getLogger(__name__)

_BITS_DTYPES = {"bfloat16": (np.uint16, torch.bfloat16)}


def _as_numpy(array):
    """``(numpy array, dtype name for the index)``."""
    if isinstance(array, torch.Tensor):
        t = array.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(array)
    return arr, str(arr.dtype)


# ---------------------------------------------------------------------------
# Meta-device init (JAX :51-135)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def init_on_device(device, include_buffers: bool = False):
    """Build models with their parameters on ``device`` (reference
    big_modeling.py:96): a parameter is made where its module makes it and
    then moved, so its type, ``requires_grad`` and attributes stay; this
    patches ``nn.Module.register_parameter`` for the block.  Buffers move
    too with ``include_buffers``; by default they stay where they are made
    (the Llama's rope tables are needed as they are)."""
    if not isinstance(include_buffers, bool):
        raise TypeError(f"include_buffers must be a bool, got {include_buffers!r}")
    device = torch.device(device)
    old_param = nn.Module.register_parameter
    old_buffer = nn.Module.register_buffer

    def register_parameter(module, name, param):
        old_param(module, name, param)
        if param is not None and param.device != device:
            p = module._parameters[name]
            kwargs = dict(p.__dict__)
            kwargs["requires_grad"] = p.requires_grad
            module._parameters[name] = type(p)(p.to(device), **kwargs)

    def register_buffer(module, name, buffer, persistent=True):
        old_buffer(module, name, buffer, persistent=persistent)
        if buffer is not None:
            module._buffers[name] = module._buffers[name].to(device)

    nn.Module.register_parameter = register_parameter
    if include_buffers:
        nn.Module.register_buffer = register_buffer
    try:
        yield
    finally:
        nn.Module.register_parameter = old_param
        nn.Module.register_buffer = old_buffer


def init_empty_weights(include_buffers: bool = False):
    """Build models with their parameters on the ``meta`` device: no
    memory, no init (JAX's no-op context made real: reference
    big_modeling.py:61); :func:`init_on_device` on ``meta``."""
    return init_on_device(torch.device("meta"), include_buffers=include_buffers)


def abstract_init(model_fn: Callable[..., nn.Module], *args, **kwargs) -> nn.Module:
    """``model_fn(*args, **kwargs)`` (a model class, or any factory) built
    under :func:`init_empty_weights`: every parameter on ``meta``."""
    with init_empty_weights():
        return model_fn(*args, **kwargs)


def _module_tables(module: nn.Module, non_persistent: bool, remove_duplicate: bool = True):
    """``(dotted name, owner, attribute, tensor, is_parameter)`` for every
    parameter and buffer of ``module`` (non-persistent buffers only with
    ``non_persistent``), in registration order."""
    for mod_name, mod in module.named_modules(remove_duplicate=remove_duplicate):
        for table, is_param in ((mod._parameters, True), (mod._buffers, False)):
            for leaf, t in table.items():
                if t is None or (not is_param and not non_persistent
                                 and leaf in mod._non_persistent_buffers_set):
                    continue
                yield f"{mod_name}.{leaf}" if mod_name else leaf, mod, leaf, t, is_param


def _named_tensors(module: nn.Module, non_persistent: bool = False) -> dict[str, torch.Tensor]:
    """A module's parameters and persistent buffers (a quantized layer's
    codes and scales; all buffers with ``non_persistent``), by name, a tied
    tensor once (under its first name), parameters first as
    ``named_parameters`` orders them: the names a checkpoint holds, and the
    tensors a hook moves."""
    out = dict(module.named_parameters())
    for name, _, _, t, is_param in _module_tables(module, non_persistent):
        if not is_param:
            out.setdefault(name, t)
    return out


def _aliases(module: nn.Module, non_persistent: bool = False
             ) -> dict[str, list[tuple[nn.Module, str, bool]]]:
    """For each name of :func:`_named_tensors`, every ``(owner module,
    attribute, is_parameter)`` holding that tensor (a tied weight has two)."""
    first: dict[int, str] = {}
    out: dict[str, list] = {}
    for name, mod, leaf, t, is_param in _module_tables(module, non_persistent,
                                                       remove_duplicate=False):
        name = first.setdefault(id(t), name)
        entry = (mod, leaf, is_param)
        if entry not in out.setdefault(name, []):
            out[name].append(entry)
    return out


def _get_tensor(holders) -> torch.Tensor:
    mod, leaf, is_param = holders[0]
    return mod._parameters[leaf] if is_param else mod._buffers[leaf]


def _set_tensor(holders, value: torch.Tensor) -> torch.Tensor:
    """Hold ``value`` in place of the tensor every holder had (a new
    tensor object: nothing is copied into the old one; a parameter given
    as one is held as it is, so a swap can be undone); returns the tensor
    held before."""
    old = _get_tensor(holders)
    for mod, leaf, is_param in holders:
        if is_param:
            if not isinstance(value, nn.Parameter):
                grad = mod._parameters[leaf].requires_grad and value.is_floating_point()
                value = nn.Parameter(value, requires_grad=grad)
            mod._parameters[leaf] = value
        else:
            mod._buffers[leaf] = value
    return old


def _normal_init(shape, dtype, device, scale: float, seed: int) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


@torch.no_grad()
def init_params_leafwise(model: nn.Module, *, scale: float = 0.02, dtype=None, device=None,
                         placement: Optional[Mapping[str, Any]] = None) -> nn.Module:
    """Materialise a (meta) model's parameters one tensor at a time, each
    straight to its placement (``placement``: module name -> a card index
    or ``"cpu"``, pinned host; the rest to ``device``): the peak is one
    tensor, where building the model on the card first would hold it all.
    Synthetic, as JAX's (:56): normal(0, ``scale``) for matrices (seeded by
    the tensor's index), ones for names holding ``scale`` or ``norm``,
    zeros elsewhere; ``dtype`` overrides the floating ones.  Returns
    ``model``."""
    aliases = _aliases(model)
    for i, (name, t) in enumerate(_named_tensors(model).items()):
        want = dtype if (dtype is not None and t.is_floating_point()) else t.dtype
        target = _lookup_placement(name, placement) if placement else None
        dev = torch.device("cpu") if target == "cpu" else _exec_device(target, device)
        if t.dim() >= 2:
            value = _normal_init(t.shape, want, dev, scale, i)
        elif "scale" in name or "norm" in name.lower():
            value = torch.ones(t.shape, dtype=want, device=dev)
        else:
            value = torch.zeros(t.shape, dtype=want, device=dev)
        _set_tensor(aliases[name], _place(name, value, target, None, device))
    return model


# ---------------------------------------------------------------------------
# Size accounting (JAX :138-200)
# ---------------------------------------------------------------------------


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(getattr(leaf, "nbytes", 0))


def _as_tree(params) -> dict:
    """A nested dict over ``params``: a module's named tensors, or a
    mapping whose (dotted) keys and nested dicts both give the levels."""
    if isinstance(params, nn.Module):
        params = _named_tensors(params)
    tree: dict = {}
    for key, value in params.items():
        parts = str(key).split(".")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = _as_tree(value) if isinstance(value, Mapping) else value
    return tree


def compute_module_sizes(params, prefix: str = "") -> dict[str, int]:
    """Bytes of every module (dotted prefix) and tensor of ``params`` (a
    module, or a name -> tensor mapping), ``""`` the total."""
    sizes: dict[str, int] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            total = 0
            for k, v in node.items():
                total += walk(v, f"{path}.{k}" if path else str(k))
            sizes[path] = total
            return total
        sizes[path] = _nbytes(node)
        return sizes[path]

    total = walk(_as_tree(params), prefix)
    sizes[""] = total
    return sizes


def get_max_memory(max_memory: Optional[dict] = None) -> dict:
    """Budget per target: each card's free memory (``torch.cuda.
    mem_get_info``) and the host's available memory, each x 0.9 (JAX :164
    takes the device limit).  Given ``max_memory``, its values, strings
    like ``"10GB"`` parsed."""
    if max_memory is not None:
        from .checkpointing import parse_size

        return {k: (parse_size(v) if isinstance(v, str) else v) for k, v in max_memory.items()}
    out = {}
    for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        out[i] = int(torch.cuda.mem_get_info(i)[0] * 0.9)
    try:
        import psutil

        out["cpu"] = int(psutil.virtual_memory().available * 0.9)
    except ImportError:
        out["cpu"] = int(_available_host_memory() * 0.9)
    return out


def _available_host_memory() -> int:
    """Available (not total) host memory from ``/proc/meminfo``; half the
    physical memory where that file is missing."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") * 0.5)


# ---------------------------------------------------------------------------
# Placement planner (JAX :207-283)
# ---------------------------------------------------------------------------


def _placement_units(tree: dict, sizes: dict[str, int], max_unit: int,
                     no_split: frozenset) -> list[str]:
    """Split the tree into placement units: descend into any module larger
    than ``max_unit`` (the largest single budget) unless ``no_split``
    lists it; tree order, so adjacent layers share a tier."""
    units: list[str] = []

    def walk(node, path):
        splittable = (isinstance(node, Mapping) and len(node) > 0 and path not in no_split
                      and (path == "" or sizes.get(path, 0) > max_unit))
        if splittable:
            for k, v in node.items():
                walk(v, f"{path}.{k}" if path else str(k))
        elif path:
            units.append(path)

    walk(tree, "")
    return units


def infer_auto_placement(params, max_memory: Optional[dict] = None,
                         no_split_paths: Optional[list[str]] = None,
                         offload_to_disk: bool = True) -> dict[str, Union[int, str]]:
    """Greedy assignment of ``params``' modules (a module, or a name ->
    tensor mapping) to the cards' budgets, then ``"cpu"``, then
    ``"disk"``, in tree order (JAX :233, reference modeling.py:1278).
    Modules larger than the largest card budget are split down to their
    children; ``no_split_paths`` keep theirs whole.  Returns ``{module name:
    target}``; raises where a unit fits nowhere and disk is off."""
    budgets = dict(get_max_memory(max_memory))
    tree = _as_tree(params)
    sizes = compute_module_sizes(tree)
    device_targets = [k for k in budgets if isinstance(k, int)]
    order = device_targets + ["cpu"] + (["disk"] if offload_to_disk else [])
    max_unit = max((budgets[t] for t in device_targets), default=budgets.get("cpu", 0))
    units = _placement_units(tree, sizes, max_unit, frozenset(no_split_paths or ()))
    placement: dict[str, Union[int, str]] = {}
    for path in units:
        size = sizes.get(path, 0)
        for target in order:
            if target == "disk":
                placement[path] = "disk"
                break
            if budgets.get(target, 0) >= size:
                budgets[target] -= size
                placement[path] = target
                break
        else:
            raise ValueError(f"Cannot place subtree {path!r} ({size} bytes) within max_memory "
                             f"{budgets}; enable offload_to_disk or raise budgets")
    return placement


# the reference's name (modeling.py:1278): the same planner
infer_auto_device_map = infer_auto_placement


def _lookup_placement(key: str, placement: Mapping[str, Any]):
    """The most specific entry of ``placement`` (dotted module names, or
    ``""`` for the whole model) that covers tensor ``key``."""
    parts = key.split(".")
    for depth in range(len(parts), 0, -1):
        hit = placement.get(".".join(parts[:depth]))
        if hit is not None:
            return hit
    return placement.get("")


# ---------------------------------------------------------------------------
# Offload store (JAX :286-330)
# ---------------------------------------------------------------------------


class OffloadStore:
    """Disk-backed tensors: one .dat memmap per tensor + index.json."""

    def __init__(self, save_folder: Union[str, os.PathLike], autoflush: bool = True):
        self.folder = Path(save_folder)
        self.folder.mkdir(parents=True, exist_ok=True)
        self.index_file = self.folder / "index.json"
        self.autoflush = autoflush
        self._dirty = False
        self.index: dict[str, dict] = (
            json.loads(self.index_file.read_text()) if self.index_file.exists() else {}
        )

    def _path(self, key: str) -> Path:
        return self.folder / f"{key.replace('/', '--')}.dat"

    def save(self, key: str, array) -> None:
        """Write ``array`` (a numpy array or a torch tensor) under ``key``."""
        arr, dtype_name = _as_numpy(array)
        mm = np.memmap(self._path(key), dtype=arr.dtype, mode="w+", shape=arr.shape or (1,))
        mm[...] = arr.reshape(arr.shape or (1,))
        mm.flush()
        self.index[key] = {"dtype": dtype_name, "shape": list(arr.shape)}
        self._dirty = True
        if self.autoflush:
            self.flush()

    def flush(self) -> None:
        """Write index.json once; bulk writers pass autoflush=False and call
        this at the end."""
        if self._dirty:
            self.index_file.write_text(json.dumps(self.index))
            self._dirty = False

    def load(self, key: str) -> np.ndarray:
        """The stored array as a read-only memmap (a bf16 tensor's as its
        ``uint16`` bit patterns)."""
        meta = self.index[key]
        shape = tuple(meta["shape"])
        bits = _BITS_DTYPES.get(meta["dtype"])
        dtype = bits[0] if bits is not None else np.dtype(meta["dtype"])
        return np.memmap(self._path(key), dtype=dtype, mode="r",
                         shape=shape or (1,)).reshape(shape)

    def load_tensor(self, key: str) -> torch.Tensor:
        """The stored array as a CPU tensor in its own dtype (bf16 included),
        copied out of the memmap."""
        arr = np.array(self.load(key))
        bits = _BITS_DTYPES.get(self.index[key]["dtype"])
        if bits is not None:
            return torch.from_numpy(arr.view(np.int16)).view(bits[1])
        return torch.from_numpy(arr)

    def keys(self):
        return self.index.keys()

    def __contains__(self, key):
        return key in self.index


# ---------------------------------------------------------------------------
# Placing one tensor
# ---------------------------------------------------------------------------


def _exec_device(target, device) -> torch.device:
    """The device a card target (an index, or None for ``device``) means."""
    dev = resolve_device(device)
    if isinstance(target, (int, np.integer)) and not isinstance(target, bool) \
            and dev.type == "cuda":
        return torch.device("cuda", int(target))
    return dev


def _pinned(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host, page-locked where a card exists (the side-stream
    copies of the streamed decode read it asynchronously)."""
    t = t.detach().to("cpu")
    if torch.cuda.is_available() and not t.is_pinned():
        t = t.pin_memory()
    return t


def _mapped_tensor(store: OffloadStore, key: str) -> torch.Tensor:
    """The stored tensor ``key`` as a CPU tensor over its ``.dat`` file's
    memory map (copy-on-write: nothing is read until used, nothing written
    back), in its own dtype (bf16 included)."""
    meta = store.index[key]
    shape = tuple(meta["shape"])
    bits = _BITS_DTYPES.get(meta["dtype"])
    np_dtype = np.int16 if bits is not None else np.dtype(meta["dtype"])
    mm = np.memmap(store._path(key), dtype=np_dtype, mode="c", shape=shape or (1,))
    t = torch.from_numpy(mm).reshape(shape)
    return register_file_backed(t.view(bits[1]) if bits is not None else t, mm, store._path(key))


def _place(key: str, t: torch.Tensor, target, store: Optional[OffloadStore], device):
    """``t`` at ``target``: ``"disk"`` (written to ``store``, returned as
    its memory map), ``"cpu"`` (pinned host) or a card (an index, or None
    for ``device``)."""
    if target == "disk":
        if store is None:
            raise ValueError("placement says 'disk' but no offload_folder was given")
        store.save(key, t)
        return _mapped_tensor(store, key)
    if target == "cpu":
        return _pinned(t)
    return t.to(_exec_device(target, device))


# ---------------------------------------------------------------------------
# Checkpoint streaming (JAX :400-582)
# ---------------------------------------------------------------------------


def offload_state_dict(save_dir: str, state_dict: Mapping[str, Any]) -> OffloadStore:
    """Write every tensor of ``state_dict`` to an :class:`OffloadStore`
    (reference offload.py:85)."""
    store = OffloadStore(save_dir, autoflush=False)
    for k, v in state_dict.items():
        store.save(k, v)
    store.flush()
    return store


def offload_store_params(store: OffloadStore) -> dict[str, torch.Tensor]:
    """Every tensor of ``store`` as a CPU tensor over its ``.dat`` file's
    memory map, by key: the disk tier that ``generation.generate_streamed``
    streams (its ``params=``), costing no host memory until a layer's
    turn."""
    return {key: _mapped_tensor(store, key) for key in store.keys()}


def _iter_checkpoint_tensors(checkpoint) -> Iterator[tuple[str, torch.Tensor]]:
    """``(name, CPU tensor)`` from a safetensors or ``.npz`` file, a
    directory (its ``model.safetensors.index.json`` shards, else its
    ``*.safetensors``, else its ``*.npz``), or any iterable of pairs,
    passed through.  Each safetensors tensor is read when its turn comes."""
    if not isinstance(checkpoint, (str, os.PathLike)):
        yield from checkpoint
        return
    p = Path(checkpoint)
    if p.is_dir():
        index = p / SAFE_WEIGHTS_INDEX_NAME
        if index.exists():
            names = sorted(set(json.loads(index.read_text())["weight_map"].values()))
            files = [p / n for n in names]
        else:
            files = sorted(p.glob("*.safetensors")) or sorted(p.glob("*.npz"))
    else:
        files = [p]
    for f in files:
        if f.suffix == ".safetensors":
            from .utils.serialization import LazySafetensorsFile

            sf = LazySafetensorsFile(f)
            for name in sf.keys():
                yield name, sf.get(name)
        elif f.suffix == ".npz":
            data = np.load(f)
            for name in data.files:
                yield name, torch.from_numpy(np.ascontiguousarray(data[name]))
        else:
            raise ValueError(f"unsupported checkpoint file {f}")


def _stream_into(model: nn.Module, checkpoint, *, device=None, dtype=None,
                 offload_placement=None, offload_folder=None, strict=False, key_map=None,
                 tensor_map=None, quantization_config=None, stats=None):
    """The loader behind :func:`load_checkpoint_in_model` and
    ``utils.quantization.load_and_quantize_model``: with
    ``quantization_config``, each weight it takes is copied to the card
    and quantized there as it arrives."""
    targets = _named_tensors(model)
    aliases = _aliases(model)
    store = OffloadStore(offload_folder, autoflush=False) if offload_folder else None
    loaded: set = set()
    unexpected: list = []
    timing = {"read_s": 0.0, "h2d_s": 0.0, "quantize_s": 0.0, "bytes": 0, "tensors": 0}
    stream = _iter_checkpoint_tensors(checkpoint)
    try:
        while True:
            t0 = time.perf_counter()
            try:
                name, tensor = next(stream)
            except StopIteration:
                break
            key = key_map(name) if key_map else name
            if key is None:           # a key_map skip (HF's rotary inv_freq buffers)
                continue
            if key not in targets:
                unexpected.append(name)
                continue
            target_t = targets[key]
            want = dtype if (dtype is not None and target_t.is_floating_point()) \
                else target_t.dtype
            tensor = torch.as_tensor(tensor)
            if tensor_map is not None:
                tensor = torch.as_tensor(tensor_map(key, tensor))
            if tuple(tensor.shape) != tuple(target_t.shape):
                raise ValueError(f"shape mismatch for {name}: checkpoint {tuple(tensor.shape)} "
                                 f"vs model {tuple(target_t.shape)}")
            # cast on the host before the copy: the card receives exactly
            # the target dtype's bytes (JAX :507-511)
            if tensor.dtype != want:
                tensor = tensor.to(want)
            tensor = tensor.contiguous()
            timing["read_s"] += time.perf_counter() - t0
            timing["bytes"] += tensor.numel() * tensor.element_size()
            timing["tensors"] += 1
            target = _lookup_placement(key, offload_placement) if offload_placement else None
            owner_name, _, leaf = key.rpartition(".")
            owner = model.get_submodule(owner_name) if owner_name else model
            t1 = time.perf_counter()
            if quantization_config is not None and leaf == "weight" \
                    and hasattr(owner, "set_quantized") \
                    and quantization_config.should_quantize(key, tensor):
                from .utils.quantization import quantize

                on_card = tensor.to(_exec_device(target, device))
                _sync(on_card)
                t2 = time.perf_counter()
                owner.set_quantized(quantize(on_card.t(), quantization_config))
                del on_card
                _sync(owner.qcodes)
                timing["h2d_s"] += t2 - t1
                timing["quantize_s"] += time.perf_counter() - t2
            else:
                value = _place(key, tensor, target, store, device)
                _sync(value)
                timing["h2d_s"] += time.perf_counter() - t1
                _set_tensor(aliases[key], value)
            loaded.add(key)
    finally:
        # index.json stays consistent with the .dat files already written,
        # even when a shape mismatch aborts the stream
        if store is not None:
            store.flush()
    missing = [k for k in targets if k not in loaded]
    if strict and (missing or unexpected):
        raise ValueError(f"missing keys: {missing}; unexpected keys: {unexpected}")
    for k in missing:
        logger.warning("key %s missing from checkpoint; left as it was", k)
    if stats is not None:
        stats.update(timing)
    return model, store


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def load_checkpoint_in_model(model: nn.Module, checkpoint, *, device=None, dtype=None,
                             offload_placement: Optional[dict] = None,
                             offload_folder: Optional[str] = None, strict: bool = False,
                             key_map: Optional[Callable[[str], Optional[str]]] = None,
                             tensor_map: Optional[Callable] = None,
                             stats: Optional[dict] = None):
    """Stream ``checkpoint`` into ``model`` (on ``meta`` or not), one
    tensor at a time (JAX :433, reference modeling.py:1788).

    Each checkpoint tensor is renamed by ``key_map`` (None skips it),
    reshaped by ``tensor_map(key, tensor)``, checked against the model's
    shape, cast on the host to ``dtype`` (floating tensors; default: the
    model's) and placed by ``offload_placement`` (``{module name: target}``,
    the most specific entry wins): on the card, in pinned host memory
    (``"cpu"``) or in an :class:`OffloadStore` under ``offload_folder``
    (``"disk"``), which the parameter then maps.  The model holds each new
    tensor in place of its old one (a tied weight in both places).
    ``strict`` raises on missing or unexpected keys; otherwise a missing
    one stays as it was.  ``stats`` (a dict) receives the seconds spent
    reading and casting (``read_s``), copying to their place (``h2d_s``,
    each copy waited for) and the bytes.  Returns ``(model, store or
    None)``."""
    return _stream_into(model, checkpoint, device=device, dtype=dtype,
                        offload_placement=offload_placement, offload_folder=offload_folder,
                        strict=strict, key_map=key_map, tensor_map=tensor_map, stats=stats)


def load_checkpoint_and_dispatch(model: nn.Module, checkpoint, *,
                                 device_map: Union[str, dict, None] = "auto",
                                 max_memory: Optional[dict] = None,
                                 offload_folder: Optional[str] = None, dtype=None,
                                 strict: bool = False, key_map=None, tensor_map=None,
                                 device=None, stats: Optional[dict] = None):
    """Plan and load in one call (JAX :537, reference big_modeling.py:513):
    with ``device_map="auto"`` a model larger than the cards' budgets is
    tiered by :func:`infer_auto_placement` (to disk only with an
    ``offload_folder``); a dict is a placement as it is; None puts all on
    ``device``.  Build ``model`` under :func:`init_empty_weights`.  Returns
    ``(model, store or None)``."""
    placement = None
    if device_map == "auto":
        sizes = compute_module_sizes(model)
        budgets = get_max_memory(max_memory)
        on_cards = sum(v for k, v in budgets.items() if isinstance(k, int))
        if sizes[""] > on_cards:
            placement = infer_auto_placement(model, max_memory,
                                             offload_to_disk=offload_folder is not None)
    elif isinstance(device_map, dict):
        placement = device_map
    return load_checkpoint_in_model(model, checkpoint, device=device, dtype=dtype,
                                    offload_placement=placement, offload_folder=offload_folder,
                                    strict=strict, key_map=key_map, tensor_map=tensor_map,
                                    stats=stats)


def serve_model(model: nn.Module, serving_plugin=None, generation_config=None, *,
                seed: int = 0, device=None):
    """A continuous-batching :class:`~accelerate_tpu_torch.serving.ServingEngine`
    over a loaded model (JAX :585): paged KV cache, per-step admission,
    chunked prefill.  An int8 model (``load_and_quantize_model``) decodes
    through the W8A16 kernels unchanged."""
    from .serving import ServingEngine

    return ServingEngine(model, serving_plugin, generation_config, seed=seed,
                         device=device if device is not None else model.device)


def load_checkpoint_and_serve(model: nn.Module, checkpoint, *, serving_plugin=None,
                              generation_config=None, dtype=None, **dispatch_kwargs):
    """:func:`load_checkpoint_and_dispatch`, then :func:`serve_model` (JAX
    :601): one call from a checkpoint to a serving engine."""
    model, _store = load_checkpoint_and_dispatch(model, checkpoint, dtype=dtype,
                                                 **dispatch_kwargs)
    return serve_model(model, serving_plugin, generation_config,
                       device=dispatch_kwargs.get("device"))


# ---------------------------------------------------------------------------
# Dispatch and offload of materialised weights (JAX :619-694)
# ---------------------------------------------------------------------------


def _map_leaves(tree, fn, prefix=""):
    if isinstance(tree, Mapping):
        return {k: _map_leaves(v, fn, f"{prefix}.{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def dispatch_model(params, placement: dict[str, Union[int, str]],
                   offload_folder: Optional[str] = None, device=None):
    """Place an already materialised model (in place) or name -> tensor
    mapping (a new one) by ``placement`` (JAX :619, reference
    big_modeling.py:310): tensors no entry covers go to ``device``.
    Returns ``(placed, store or None)``."""
    store = OffloadStore(offload_folder, autoflush=False) if offload_folder else None
    try:
        if isinstance(params, nn.Module):
            aliases = _aliases(params)
            for key, t in _named_tensors(params).items():
                target = _lookup_placement(key, placement)
                _set_tensor(aliases[key], _place(key, t.detach(), target, store, device))
            placed = params
        else:
            placed = _map_leaves(params, lambda key, t: _place(
                key, torch.as_tensor(t).detach(), _lookup_placement(key, placement), store,
                device))
    finally:
        if store is not None:
            store.flush()
    return placed, store


def cpu_offload(params, apply_fn: Optional[Callable] = None, execution_device=None):
    """Every tensor of a model or mapping to pinned host memory (JAX :648,
    reference big_modeling.py:175); with ``apply_fn``, also the wrapped
    call of :func:`offloaded_apply`, which fetches them to
    ``execution_device`` per call.  For a layer-streamed decode use
    ``generation.generate_streamed``."""
    placed, _ = dispatch_model(params, {"": "cpu"})
    if apply_fn is None:
        return placed
    return placed, offloaded_apply(apply_fn, execution_device)


def disk_offload(params, offload_dir: Union[str, os.PathLike],
                 apply_fn: Optional[Callable] = None, execution_device=None):
    """Every tensor written to ``offload_dir`` and held as its memory map
    (JAX :660, reference big_modeling.py:226); with ``apply_fn``, also the
    wrapped call of :func:`offloaded_apply`."""
    placed, _ = dispatch_model(params, {"": "disk"}, offload_folder=str(offload_dir))
    if apply_fn is None:
        return placed
    return placed, offloaded_apply(apply_fn, execution_device)


def _fetch(x, dev: torch.device):
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.array(x))
    return x.to(dev) if isinstance(x, torch.Tensor) else x


def offloaded_apply(apply_fn, device=None):
    """Wrap ``apply_fn(params, *args, **kwargs)`` so that host and disk
    tensors of ``params`` (a mapping, or a module: its named tensors) are
    copied to ``device`` for the call and dropped after (JAX :677, the
    ``AlignDevicesHook`` capability, functionally).  ``apply_fn`` may be a
    module itself: it then runs through ``torch.func.functional_call`` on
    the fetched tensors, its own left where they are."""

    def wrapped(params, *args, **kwargs):
        dev = resolve_device(device)
        if isinstance(params, nn.Module):
            params = _named_tensors(params)
        device_params = _map_leaves(params, lambda _k, x: _fetch(x, dev))
        try:
            if isinstance(apply_fn, nn.Module):
                return torch.func.functional_call(apply_fn, device_params, args, kwargs)
            return apply_fn(device_params, *args, **kwargs)
        finally:
            del device_params

    return wrapped
