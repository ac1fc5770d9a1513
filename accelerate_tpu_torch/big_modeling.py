"""Disk-backed tensor store (the port's own copy of ``OffloadStore``,
``accelerate_tpu/big_modeling.py:286-330``): one ``.dat`` memmap per tensor
plus ``index.json``, the reference ``OffloadedWeightsLoader`` format.

The adapter pool's cold tier (``serving/adapters.py``, ``offload_dir=``).
numpy has no bfloat16, so a bf16 tensor is stored as its 16-bit patterns
under the dtype name ``"bfloat16"`` — the bytes and index the JAX store
writes for an ``ml_dtypes`` bf16 array — and :meth:`OffloadStore.load_tensor`
reads it back as a ``torch.bfloat16`` tensor.  Meta-device init,
``load_checkpoint_and_dispatch`` and ``generate_streamed`` are ROADMAP
item A9.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Union

import numpy as np
import torch

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
        dtype = _BITS_DTYPES.get(meta["dtype"], (np.dtype(meta["dtype"]),))[0]
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
