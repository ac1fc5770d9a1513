"""Memory utilities (mirrors ``accelerate_tpu/utils/memory.py``):
``find_executable_batch_size`` (the out-of-memory retry that halves the
batch until the function runs), ``release_memory``,
``should_reduce_batch_size`` and ``get_device_memory_stats``.

On the card an out-of-memory error is ``torch.cuda.OutOfMemoryError``
(CUDA's ``out of memory`` text); a host one is ``MemoryError``.  After
each such error the caching allocator hands its free blocks back
(``torch.cuda.empty_cache``) before the retry.
"""

from __future__ import annotations

import functools
import gc
import inspect
from typing import Callable, Optional

import torch


def _empty_cache() -> None:
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def release_memory(*objects):
    """Drop the references ``objects`` held (returns as many Nones, for
    ``a, b = release_memory(a, b)``), collect, and give the card's free
    cached blocks back."""
    if len(objects) == 1 and isinstance(objects[0], (list, tuple)):
        objects = list(objects[0])
    else:
        objects = list(objects)
    for i in range(len(objects)):
        objects[i] = None
    gc.collect()
    _empty_cache()
    return objects


_OOM_TEXT = (
    "CUDA out of memory",
    "out of memory",
    "Out of memory",
    "CUBLAS_STATUS_ALLOC_FAILED",
    "DefaultCPUAllocator: can't allocate memory",
    "RESOURCE_EXHAUSTED",
    "Resource exhausted",
    "Allocation failure",
)


def should_reduce_batch_size(exception: Exception) -> bool:
    """True for an out-of-memory error: ``torch.cuda.OutOfMemoryError``, a
    ``MemoryError``, or an error whose text is one of CUDA's, cuBLAS's or
    the allocators' out-of-memory messages."""
    if isinstance(exception, (MemoryError, torch.cuda.OutOfMemoryError)):
        return True
    return isinstance(exception, Exception) and any(s in str(exception) for s in _OOM_TEXT)


def find_executable_batch_size(function: Optional[Callable] = None,
                               starting_batch_size: int = 128):
    """Decorator: calls ``function(batch_size, ...)`` from
    ``starting_batch_size``, halving the batch after each out-of-memory
    error (collecting and emptying the allocator's cache in between), and
    raises once it reaches zero.  Other errors pass through."""
    if function is None:
        return functools.partial(find_executable_batch_size,
                                 starting_batch_size=starting_batch_size)

    batch_size_holder = [starting_batch_size]

    def decorator(*args, **kwargs):
        batch_size_holder[0] = starting_batch_size
        while True:
            if batch_size_holder[0] == 0:
                raise RuntimeError("No executable batch size found, reached zero.")
            try:
                params = list(inspect.signature(function).parameters.keys())
                if len(params) < 1 or params[0] != "batch_size":
                    raise TypeError(
                        f"Batch size was passed into `{function.__name__}` as the first "
                        f"argument, but its signature is {params} — the first argument must "
                        "be `batch_size`.")
                return function(batch_size_holder[0], *args, **kwargs)
            except Exception as e:
                if should_reduce_batch_size(e):
                    gc.collect()
                    _empty_cache()
                    batch_size_holder[0] //= 2
                else:
                    raise

    return decorator


def get_device_memory_stats(device=None) -> dict:
    """The card's allocator counters: ``bytes_in_use`` (allocated now),
    ``peak_bytes_in_use`` (the high-water mark since the last reset) and
    ``bytes_limit`` (the card's memory), from
    ``torch.cuda.memory_stats``.  Zeros on the CPU or a machine without a
    card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0}
    stats = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(dev).total_memory),
    }
