"""Module hooks (mirrors ``accelerate_tpu/hooks.py``).

A hook interposes on a module's forward: :meth:`ModelHook.pre_forward`
may rewrite the call's arguments and the module's tensors before it runs,
:meth:`ModelHook.post_forward` the output after.  JAX wraps an apply
function (``add_hook_to_apply`` :88, ``remove_hook_from_apply`` :110)
because a flax module holds no weights; here a hook attaches to an
``nn.Module`` through its forward pre- and post-hooks
(:func:`add_hook_to_module` / :func:`remove_hook_from_module`, the torch
reference's own names), and a hook that moves weights sets new tensors on
the module for the call and puts the old ones back after: nothing is
copied into a parameter another stream may still read.

- :class:`AlignDevicesHook` (JAX :119): a module whose weights live on the
  host or on disk runs on ``execution_device``; ``offload=True`` fetches
  them for every call and drops the copies after, ``offload=False`` once.
  ``weights_map`` supplies the weights (an :class:`~..big_modeling.OffloadStore`'s
  ``np.memmap``s, or tensors); what is not in pinned memory is staged
  through the slot ``ops.streaming.PinnedStaging`` that the layer-streamed
  decode stages its disk tier through, a memmap read from its file with
  the native IO engine's ``pread``.
- :class:`CpuOffloadHook` (:169): the module's tensors kept in pinned host
  memory between calls.
- :class:`LayerwiseCastingHook` (:187): weights stored in a narrow dtype
  (``ops.precision.layerwise_casting``: fp8) upcast for the call.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .big_modeling import _aliases, _named_tensors, _set_tensor
from .ops.streaming import PinnedStaging
from .utils.device import resolve_device

__all__ = [
    "ModelHook",
    "SequentialHook",
    "add_hook_to_module",
    "remove_hook_from_module",
    "AlignDevicesHook",
    "CpuOffloadHook",
    "LayerwiseCastingHook",
    "attach_align_device_hook",
]


class ModelHook:
    """Lifecycle of a hook on one module (JAX :40, reference hooks.py:43)."""

    def init_hook(self, module: nn.Module) -> nn.Module:
        """Called once when attached."""
        return module

    def pre_forward(self, module: nn.Module, *args, **kwargs):
        """Before the forward: returns ``(args, kwargs)``."""
        return args, kwargs

    def post_forward(self, module: nn.Module, output):
        """After the forward: returns the output."""
        return output

    def detach_hook(self, module: nn.Module) -> nn.Module:
        """Called when removed; undoes what ``init_hook`` did."""
        return module


class SequentialHook(ModelHook):
    """Hooks in order: pre-forwards first to last, post-forwards last to
    first (JAX :61)."""

    def __init__(self, *hooks: ModelHook):
        self.hooks = list(hooks)

    def init_hook(self, module):
        for h in self.hooks:
            module = h.init_hook(module)
        return module

    def pre_forward(self, module, *args, **kwargs):
        for h in self.hooks:
            args, kwargs = h.pre_forward(module, *args, **kwargs)
        return args, kwargs

    def post_forward(self, module, output):
        for h in reversed(self.hooks):
            output = h.post_forward(module, output)
        return output

    def detach_hook(self, module):
        for h in reversed(self.hooks):
            module = h.detach_hook(module)
        return module


def _unregister(module: nn.Module) -> None:
    for handle in getattr(module, "_at_hook_handles", ()):
        handle.remove()
    module._at_hook_handles = ()


def add_hook_to_module(module: nn.Module, hook: ModelHook, append: bool = False) -> nn.Module:
    """Attach ``hook`` to ``module``'s forward; an attached hook is
    replaced, or with ``append=True`` runs first in a
    :class:`SequentialHook` with the new one (JAX ``add_hook_to_apply``
    :88).  Returns ``module``."""
    old = getattr(module, "_at_hook", None)
    if old is not None:
        _unregister(module)
        if append:
            hook = SequentialHook(old, hook)
    module = hook.init_hook(module)

    def pre(mod, args, kwargs):
        return hook.pre_forward(mod, *args, **kwargs)

    def post(mod, args, kwargs, output):
        return hook.post_forward(mod, output)

    module._at_hook = hook
    module._at_hook_handles = (module.register_forward_pre_hook(pre, with_kwargs=True),
                               module.register_forward_hook(post, with_kwargs=True))
    return module


def remove_hook_from_module(module: nn.Module) -> nn.Module:
    """Detach ``module``'s hook; a module without one is returned as it
    is (JAX :110)."""
    hook = getattr(module, "_at_hook", None)
    if hook is not None:
        _unregister(module)
        hook.detach_hook(module)
        del module._at_hook
        del module._at_hook_handles
    return module


def _to_device(x, dev: torch.device):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, (tuple, list)):
        return type(x)(_to_device(v, dev) for v in x)
    if isinstance(x, Mapping):
        return {k: _to_device(v, dev) for k, v in x.items()}
    return x


class AlignDevicesHook(ModelHook):
    """Run a module whose weights are off ``execution_device`` there
    (JAX :119, reference hooks.py:227): each weight of ``weights_map``
    (default: the module's own tensors, non-persistent buffers included,
    that lie elsewhere at attach time) is copied to the device before the
    forward, tensor arguments too.  ``offload=True``: the copies are
    dropped after every call and the module holds its host / disk tensors
    again.  ``offload=False``: fetched once, kept.  ``io_buffer``: a weight
    in pageable memory (an ``np.memmap`` is read with the native engine's
    parallel ``pread``) goes through a reusable pinned slot; without it,
    such a weight is copied as it is."""

    def __init__(self, execution_device=None, offload: bool = True, io_buffer: bool = True,
                 weights_map: Optional[Mapping[str, Any]] = None):
        self.execution_device = execution_device
        self.offload = offload
        self.io_buffer = io_buffer
        self.weights_map = dict(weights_map) if weights_map is not None else None
        self._saved: Optional[dict] = None
        self._fetched = False
        self._staging: Optional[PinnedStaging] = None

    @property
    def device(self) -> torch.device:
        dev = resolve_device(self.execution_device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev

    def _fetch(self, module: nn.Module) -> dict:
        """The weights of ``weights_map`` on the device, in the dtype and
        shape of the module's own (an ``OffloadStore`` keeps bf16 as its
        16-bit patterns)."""
        dev = self.device
        like = _named_tensors(module, non_persistent=True)
        values, staged = {}, {}
        for name, x in self.weights_map.items():
            if isinstance(x, torch.Tensor) and (x.device == dev or x.is_pinned()):
                values[name] = x.to(dev, non_blocking=True)
            elif self.io_buffer:
                staged[name] = x
            elif isinstance(x, torch.Tensor):
                values[name] = x.to(dev)
            else:
                raw = torch.from_numpy(np.array(x).reshape(-1).view(np.uint8))
                values[name] = raw.view(like[name].dtype).view(like[name].shape).to(dev)
        if staged:
            if self._staging is None:
                self._staging = PinnedStaging(1, pin=dev.type == "cuda", read_files=True)
            host, slot = self._staging.stage(staged, like)
            event = None
            for name, t in host.items():
                values[name] = t.to(dev, non_blocking=True)
            if dev.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(dev))
            elif not self.offload:
                # kept for good: not a view of a slot another fetch reuses
                values = {k: v.clone() if k in host else v for k, v in values.items()}
            self._staging.release(slot, event)
        return values

    def init_hook(self, module):
        if self.weights_map is None:
            dev = self.device
            self.weights_map = {k: t for k, t in _named_tensors(module, non_persistent=True).items()
                                if t.device != dev}
        return module

    def _swap(self, module: nn.Module, values: dict) -> dict:
        holders = _aliases(module, non_persistent=True)
        return {name: _set_tensor(holders[name], v) for name, v in values.items()}

    def pre_forward(self, module, *args, **kwargs):
        if self.offload:
            self._saved = self._swap(module, self._fetch(module))
        elif not self._fetched:
            self._swap(module, self._fetch(module))
            self._fetched = True
        dev = self.device
        return _to_device(args, dev), _to_device(kwargs, dev)

    def post_forward(self, module, output):
        if self.offload and self._saved is not None:
            self._swap(module, self._saved)
            self._saved = None
        return output

    def detach_hook(self, module):
        if self._saved is not None:
            self.post_forward(module, None)
        return module


class CpuOffloadHook(ModelHook):
    """Keep the module's tensors on the host (pinned where a card exists)
    between calls and run it on ``execution_device`` (JAX :169, reference
    hooks.py:693)."""

    def __init__(self, execution_device=None):
        self.execution_device = execution_device
        self._align: Optional[AlignDevicesHook] = None

    def init_hook(self, module):
        from .big_modeling import dispatch_model

        dispatch_model(module, {"": "cpu"})
        self._align = AlignDevicesHook(self.execution_device)
        return self._align.init_hook(module)

    def pre_forward(self, module, *args, **kwargs):
        return self._align.pre_forward(module, *args, **kwargs)

    def post_forward(self, module, output):
        return self._align.post_forward(module, output)


class LayerwiseCastingHook(ModelHook):
    """Upcast the module's ``storage_dtype`` tensors to ``compute_dtype``
    for the call, the stored ones held again after (JAX :187, reference
    hooks.py:757; ``ops.precision.layerwise_casting`` stores them)."""

    def __init__(self, storage_dtype=torch.float8_e4m3fn, compute_dtype=torch.bfloat16):
        self.storage_dtype = storage_dtype
        self.compute_dtype = compute_dtype
        self._saved: Optional[dict] = None

    def pre_forward(self, module, *args, **kwargs):
        holders = _aliases(module, non_persistent=True)
        self._saved = {}
        for name, t in _named_tensors(module, non_persistent=True).items():
            if t.dtype == self.storage_dtype:
                self._saved[name] = _set_tensor(holders[name],
                                                t.detach().to(self.compute_dtype))
        return args, kwargs

    def post_forward(self, module, output):
        if self._saved:
            holders = _aliases(module, non_persistent=True)
            for name, old in self._saved.items():
                _set_tensor(holders[name], old)
        self._saved = None
        return output

    def detach_hook(self, module):
        self.post_forward(module, None)
        return module


def attach_align_device_hook(module: nn.Module, execution_device=None, offload: bool = True,
                             weights_map: Optional[Mapping[str, Any]] = None,
                             extra_hooks: Optional[Sequence[ModelHook]] = None) -> nn.Module:
    """Attach an :class:`AlignDevicesHook`, composed with ``extra_hooks``
    in order (JAX :206)."""
    hooks: list[ModelHook] = [AlignDevicesHook(execution_device, offload=offload,
                                               weights_map=weights_map)]
    if extra_hooks:
        hooks.extend(extra_hooks)
    return add_hook_to_module(module, hooks[0] if len(hooks) == 1 else SequentialHook(*hooks))
