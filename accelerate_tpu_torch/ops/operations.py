"""Pytree helpers and the process collectives (mirrors
``accelerate_tpu/ops/operations.py``).

The helpers map over nested lists, tuples, namedtuples and mappings of
tensors (and numpy arrays), rebuilding each container with its own type.
The collectives run over every process of the ``torch.distributed`` group
with the JAX package's semantics: ``gather`` concatenates the processes'
tensors along dim 0, ``reduce`` sums (and divides for ``"mean"``) then
scales, ``pad_across_processes`` pads each tensor to the largest size any
process holds along ``dim``; in a world of one process each returns its
input (``reduce`` the input times ``scale``).  Tensors travel on their own
device: the CPU under gloo, the card under NCCL.  Under
``ACCELERATE_DEBUG_MODE`` each collective first gathers the operands'
shapes and raises :class:`~..utils.dataclasses.DistributedOperationException`
on a mismatch instead of hanging (JAX ``verify_operation`` :239).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from ..state import world as _world
from ..utils.dataclasses import DistributedOperationException, parse_flag_from_env


def is_array_like(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _container_spec(node) -> Optional[tuple]:
    """``(children, rebuild)`` for a container node, None for a leaf
    (namedtuples rebuild positionally, mappings through their own type)."""
    if isinstance(node, Mapping):
        keys = list(node.keys())
        return [node[k] for k in keys], lambda vals: type(node)(dict(zip(keys, vals)))
    if isinstance(node, (list, tuple)):
        children = list(node)
        if hasattr(node, "_fields"):
            return children, lambda vals: type(node)(*vals)
        return children, lambda vals: type(node)(vals)
    return None


def map_pytree(on_leaf: Callable[[Any], Any], node: Any) -> Any:
    """Depth-first map over nested containers, ``on_leaf`` on the rest."""
    spec = _container_spec(node)
    if spec is None:
        return on_leaf(node)
    children, rebuild = spec
    return rebuild([map_pytree(on_leaf, child) for child in children])


def _leaves(node) -> list:
    spec = _container_spec(node)
    if spec is None:
        return [node]
    return [leaf for child in spec[0] for leaf in _leaves(child)]


def honor_type(obj, generator):
    """``obj``'s container type holding ``generator``'s values."""
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*generator)
    return type(obj)(generator)


def recursively_apply(func: Callable, data: Any, *args,
                      test_type: Callable[[Any], bool] = is_array_like,
                      error_on_other_type: bool = False, **kwargs):
    """``func`` on every leaf of ``data`` that passes ``test_type``; other
    leaves pass through, or raise with ``error_on_other_type``."""

    def on_leaf(leaf):
        if test_type(leaf):
            return func(leaf, *args, **kwargs)
        if error_on_other_type:
            raise TypeError(
                f"Unsupported type {type(leaf)} passed to {getattr(func, '__name__', func)}; "
                "only nested list/tuple/dict of arrays are supported."
            )
        return leaf

    return map_pytree(on_leaf, data)


def send_to_device(tensor, device=None, non_blocking: bool = True, skip_keys=None):
    """Move every tensor (and numpy array, as a tensor) of a tree to
    ``device``; ``skip_keys`` are left as they are at every mapping
    level."""
    if isinstance(skip_keys, str):
        skip_keys = [skip_keys]
    if skip_keys and isinstance(tensor, Mapping):
        return type(tensor)({
            k: (v if k in skip_keys else send_to_device(v, device, non_blocking, skip_keys))
            for k, v in tensor.items()})
    if isinstance(tensor, (tuple, list)):
        return honor_type(tensor, (send_to_device(t, device, non_blocking, skip_keys)
                                   for t in tensor))

    def _send(t):
        t = torch.as_tensor(t)
        return t.to(device, non_blocking=non_blocking) if device is not None else t

    return recursively_apply(_send, tensor)


class TensorInformation:
    """Shape and dtype of a leaf (the JAX ``ShapeDtypeStruct`` role)."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = tuple(shape), dtype

    def __repr__(self):
        return f"TensorInformation(shape={self.shape}, dtype={self.dtype})"


def get_data_structure(data):
    """The shape / dtype skeleton of a tree."""
    return recursively_apply(lambda t: TensorInformation(t.shape, t.dtype), data)


def initialize_tensors(data_structure):
    """Zeros matching a skeleton."""
    def _zeros(t):
        if isinstance(t.dtype, torch.dtype):
            return torch.zeros(t.shape, dtype=t.dtype)
        return torch.from_numpy(np.zeros(t.shape, dtype=t.dtype))

    return recursively_apply(_zeros, data_structure,
                             test_type=lambda x: isinstance(x, TensorInformation))


def find_batch_size(data) -> Optional[int]:
    """Dim 0 of the first leaf with a dimension."""
    for leaf in _leaves(data):
        if is_array_like(leaf) and leaf.ndim >= 1:
            return leaf.shape[0]
    return None


def slice_tensors(data, tensor_slice, process_index=None, num_processes=None):
    """Every leaf sliced along dim 0."""
    return recursively_apply(lambda t: t[tensor_slice], data)


def listify(data):
    """Leaves as nested python lists."""
    return recursively_apply(lambda t: t.tolist(), data)


def convert_to_fp32(tensor):
    """Upcast f16 / bf16 tensors to f32; other leaves untouched."""
    return recursively_apply(
        lambda t: t.float(), tensor,
        test_type=lambda t: isinstance(t, torch.Tensor) and t.dtype in (torch.float16,
                                                                        torch.bfloat16))


class ConvertOutputsToFp32:
    """A pickleable decorator: the wrapped forward's outputs in f32."""

    def __init__(self, model_forward):
        self.model_forward = model_forward
        functools.update_wrapper(self, model_forward)

    def __call__(self, *args, **kwargs):
        return convert_to_fp32(self.model_forward(*args, **kwargs))


convert_outputs_to_fp32 = ConvertOutputsToFp32


def _tree_shapes(data):
    return [(tuple(leaf.shape), str(leaf.dtype)) for leaf in _leaves(data) if is_array_like(leaf)]


def verify_operation(function):
    """Under ``ACCELERATE_DEBUG_MODE``, gather the operands' shapes first
    and raise on a mismatch across processes."""

    @functools.wraps(function)
    def wrapper(*args, **kwargs):
        n, _ = _world()
        if n == 1 or not parse_flag_from_env("ACCELERATE_DEBUG_MODE"):
            return function(*args, **kwargs)
        tensor = kwargs.get("tensor", args[0] if args else None)
        all_shapes = gather_object([_tree_shapes(tensor)])
        if not all(s == all_shapes[0] for s in all_shapes):
            operation = f"{function.__module__}.{function.__name__}"
            raise DistributedOperationException(
                f"Cannot apply desired operation due to shape mismatches. All shapes across "
                f"devices must be valid.\n\nOperation: `{operation}`\nInput shapes:\n"
                + "\n".join(f"  - Process {i}: {s}" for i, s in enumerate(all_shapes))
            )
        return function(*args, **kwargs)

    return wrapper


def _on_tensor(fn):
    """``fn`` over a tensor leaf; a numpy leaf goes through it as a tensor
    and comes back as an array."""

    def apply(t):
        if isinstance(t, np.ndarray):
            return fn(torch.from_numpy(np.ascontiguousarray(t))).numpy()
        return fn(t)

    return apply


@verify_operation
def gather(tensor):
    """Every process's tensors concatenated along dim 0 (the input itself
    in a world of one)."""
    import torch.distributed as dist

    n, _ = _world()
    if n == 1:
        return tensor

    def _gather(t):
        t = t.contiguous()
        if t.dim() == 0:
            t = t[None]
        out = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t)
        return out

    return recursively_apply(_on_tensor(_gather), tensor, error_on_other_type=True)


def gather_object(object: Any) -> list:
    """Every process's picklable object, as one list (list inputs are
    concatenated)."""
    import torch.distributed as dist

    n, _ = _world()
    if n == 1:
        return object if isinstance(object, list) else [object]
    gathered = [None] * n
    dist.all_gather_object(gathered, object)
    out = []
    for obj in gathered:
        out.extend(obj if isinstance(obj, list) else [obj])
    return out


@verify_operation
def broadcast(tensor, from_process: int = 0):
    """``from_process``'s tensors on every process."""
    import torch.distributed as dist

    n, _ = _world()
    if n == 1:
        return tensor

    def _bcast(t):
        out = t.to(torch.uint8) if t.dtype == torch.bool else t.clone().contiguous()
        dist.broadcast(out, src=from_process)
        return out.bool() if t.dtype == torch.bool else out

    return recursively_apply(_on_tensor(_bcast), tensor, error_on_other_type=True)


def broadcast_raw(tensor: torch.Tensor, from_process: int = 0, group=None) -> torch.Tensor:
    """``from_process``'s ``tensor`` on every process, sent as its raw bytes:
    a ``uint8`` view of a host copy crosses the group and the receiver
    views it back as ``tensor``'s dtype and shape, on ``tensor``'s device
    (a receiver's ``tensor`` is the template; its values are not read).
    Every dtype crosses a gloo group this way (gloo has no fp8 lane), and a
    card tensor crosses through host memory, which a gloo group needs.  The
    input itself in a world of one."""
    import torch.distributed as dist

    n, _ = _world()
    if n == 1:
        return tensor
    host = tensor.detach().to("cpu", copy=True).contiguous()
    raw = host.reshape(-1).view(torch.uint8)
    dist.broadcast(raw, src=from_process, group=group)
    out = raw.view(tensor.dtype).reshape(tensor.shape)
    return out if tensor.device.type == "cpu" else out.to(tensor.device)


def broadcast_object_list(object_list: list, from_process: int = 0) -> list:
    """``from_process``'s picklable objects into ``object_list`` on every
    process (mutated and returned)."""
    import torch.distributed as dist

    n, _ = _world()
    if n == 1:
        return object_list
    dist.broadcast_object_list(object_list, src=from_process)
    return object_list


@verify_operation
def reduce(tensor, reduction: str = "mean", scale: float = 1.0):
    """The sum over processes (``"mean"``: divided by their number), times
    ``scale``."""
    import torch.distributed as dist

    n, _ = _world()

    def _reduce(t):
        if n > 1:
            t = t.clone().contiguous()
            dist.all_reduce(t)
            if reduction == "mean":
                t = t / n
        return t * scale

    return recursively_apply(_on_tensor(_reduce), tensor, error_on_other_type=True)


def pad_across_processes(tensor, dim: int = 0, pad_index: int = 0, pad_first: bool = False):
    """Pad each tensor along ``dim`` to the largest size any process holds,
    with ``pad_index`` at the end (or, ``pad_first``, the start)."""
    import torch.distributed as dist

    n, _ = _world()

    def _pad(t):
        if dim >= t.dim() or n == 1:
            return t
        size = torch.tensor([t.shape[dim]], dtype=torch.int64, device=t.device)
        sizes = torch.empty(n, dtype=torch.int64, device=t.device)
        dist.all_gather_into_tensor(sizes, size)
        max_size = int(sizes.max())
        if t.shape[dim] == max_size:
            return t
        new_shape = list(t.shape)
        new_shape[dim] = max_size
        out = torch.full(new_shape, pad_index, dtype=t.dtype, device=t.device)
        idx = [slice(None)] * t.dim()
        idx[dim] = (slice(max_size - t.shape[dim], max_size) if pad_first
                    else slice(0, t.shape[dim]))
        out[tuple(idx)] = t
        return out

    return recursively_apply(_on_tensor(_pad), tensor, error_on_other_type=True)


def pad_input_tensors(tensor, batch_size: int, num_processes: int, dim: int = 0):
    """Pad dim 0 with copies of the first row so ``batch_size`` divides
    across ``num_processes``."""

    def _pad(t):
        remainder = batch_size % num_processes
        if remainder == 0:
            return t
        reps = [t[:1]] * (num_processes - remainder)
        return torch.cat([t] + reps, dim=dim)

    return recursively_apply(_on_tensor(_pad), tensor, error_on_other_type=True)


def concatenate(data: list, dim: int = 0):
    """Concatenate structurally identical trees leaf by leaf."""
    if isinstance(data[0], (tuple, list)):
        return honor_type(data[0], (concatenate([d[i] for d in data], dim=dim)
                                    for i in range(len(data[0]))))
    if isinstance(data[0], Mapping):
        return type(data[0])({k: concatenate([d[k] for d in data], dim=dim)
                              for k in data[0].keys()})
    if not is_array_like(data[0]):
        raise TypeError(f"Can only concatenate arrays or nested list/tuple/dicts of arrays, "
                        f"got {type(data[0])}")
    if isinstance(data[0], np.ndarray):
        return np.concatenate(data, axis=dim)
    return torch.cat(data, dim=dim)
