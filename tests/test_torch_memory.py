"""The port's memory utilities (``utils/memory.py``) held against the JAX
package's ``accelerate_tpu/utils/memory.py``: the cases of JAX's
``tests/test_observability.py:124-180`` in torch form, the out-of-memory
halving sequence step for step equal to JAX's, and the CUDA / allocator
out-of-memory errors recognised."""

import pytest
import torch

from accelerate_tpu.utils import memory as jmemory
from accelerate_tpu_torch.utils import memory as tmemory
from accelerate_tpu_torch.utils.memory import (
    find_executable_batch_size,
    get_device_memory_stats,
    release_memory,
    should_reduce_batch_size,
)


def _halving(module, error, start, fits):
    attempts = []

    @module.find_executable_batch_size(starting_batch_size=start)
    def train(batch_size):
        attempts.append(batch_size)
        if batch_size > fits:
            raise error
        return batch_size

    return train(), attempts


@pytest.mark.parametrize("start,fits", [(64, 16), (128, 1), (100, 30), (7, 7)])
def test_halving_sequence_equals_jax(monkeypatch, start, fits):
    monkeypatch.setattr(jmemory.jax, "clear_caches", lambda: None)
    emptied = []
    monkeypatch.setattr(tmemory, "_empty_cache", lambda: emptied.append(1))
    got = _halving(tmemory, torch.cuda.OutOfMemoryError("CUDA out of memory."), start, fits)
    want = _halving(jmemory, RuntimeError("RESOURCE_EXHAUSTED: out of memory"), start, fits)
    assert got == want
    assert len(emptied) == len(got[1]) - 1   # one allocator release per OOM retry


def test_find_executable_batch_size_reaches_zero():
    @find_executable_batch_size(starting_batch_size=4)
    def train(batch_size):
        raise MemoryError()

    with pytest.raises(RuntimeError, match="reached zero"):
        train()


def test_find_executable_batch_size_non_oom_propagates():
    @find_executable_batch_size(starting_batch_size=8)
    def train(batch_size):
        raise ValueError("unrelated")

    with pytest.raises(ValueError, match="unrelated"):
        train()


def test_find_executable_batch_size_signature_check():
    @find_executable_batch_size(starting_batch_size=8)
    def train(foo):
        return foo

    with pytest.raises(TypeError, match="batch_size"):
        train()


def test_top_level_export_as_jax():
    """JAX's tests/test_big_modeling.py:265 reads it at the top level."""
    import accelerate_tpu
    import accelerate_tpu_torch

    assert accelerate_tpu_torch.find_executable_batch_size is find_executable_batch_size
    assert hasattr(accelerate_tpu, "find_executable_batch_size")


def test_find_executable_batch_size_passes_arguments():
    @find_executable_batch_size(starting_batch_size=8)
    def train(batch_size, a, b=0):
        return batch_size, a, b

    assert train(1, b=2) == (8, 1, 2)


@pytest.mark.parametrize("exc,want", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"), True),
    (RuntimeError("CUDA error: out of memory"), True),
    (RuntimeError("CUBLAS_STATUS_ALLOC_FAILED when calling cublasCreate(handle)"), True),
    (RuntimeError("DefaultCPUAllocator: can't allocate memory: you tried to allocate 8 GB"),
     True),
    (RuntimeError("RESOURCE_EXHAUSTED: ..."), True),
    (MemoryError(), True),
    (ValueError("nope"), False),
    (RuntimeError("shape mismatch"), False),
])
def test_should_reduce_batch_size(exc, want):
    assert should_reduce_batch_size(exc) is want
    if not isinstance(exc, torch.cuda.OutOfMemoryError) and "CUB" not in str(exc) \
            and "Allocator" not in str(exc) and "CUDA" not in str(exc):
        assert jmemory.should_reduce_batch_size(exc) is want


def test_release_memory():
    a, b = torch.ones(10), torch.ones(10)
    a, b = release_memory(a, b)
    assert a is None and b is None
    assert release_memory([torch.ones(2), torch.ones(3)]) == [None, None]


def test_device_memory_stats():
    stats = get_device_memory_stats("cpu")
    assert stats == {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0}
    assert set(get_device_memory_stats()) == set(jmemory.get_device_memory_stats())
