"""Safetensors write / read / lazy file over torch tensors, on the native IO
engine (the port's own copy of ``accelerate_tpu/utils/serialization.py``).

The JSON header is built here and each tensor's bytes move through the
native segment writer / reader (``native/src/io_engine.cc``) straight
between the tensor's own host memory and its file offset.  The bytes equal
the JAX package's writer's for the same arrays: the same header JSON (keys
in the mapping's order, compact separators, ``__metadata__`` last), the
same space padding of the header to 8 bytes, the same offsets.

Format (safetensors spec): ``u64 header_len | JSON header | payload``; the
header maps a tensor name to ``{dtype, shape, data_offsets=[begin, end)}``,
offsets relative to the payload's start.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch

from .. import native

_DTYPE_TO_STR = {
    torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
    torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32",
    torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL",
    torch.float8_e4m3fn: "F8_E4M3", torch.float8_e5m2: "F8_E5M2",
}
for _name, _code in (("uint16", "U16"), ("uint32", "U32"), ("uint64", "U64")):
    if hasattr(torch, _name):  # unsigned wide types: torch >= 2.3
        _DTYPE_TO_STR[getattr(torch, _name)] = _code
_STR_TO_DTYPE = {v: k for k, v in _DTYPE_TO_STR.items()}


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """A flat uint8 numpy view of a contiguous CPU tensor's bytes."""
    return t.reshape(-1).view(torch.uint8).numpy()


def save_safetensors(path, tensors: Mapping[str, torch.Tensor],
                     metadata: Optional[dict] = None, nthreads: Optional[int] = None) -> None:
    """Write ``tensors`` (CPU, or copied to the CPU here) as one safetensors
    file through the native parallel segment writer."""
    header: dict = {}
    payload = []
    offset = 0
    for name, t in tensors.items():
        dt = _DTYPE_TO_STR.get(t.dtype)
        if dt is None:
            raise TypeError(f"dtype {t.dtype} of tensor {name!r} is not safetensors-serializable")
        t = t.detach().to("cpu").contiguous()
        nbytes = t.numel() * t.element_size()
        # a 0-d tensor is written with shape [1], as the JAX writer's
        # np.ascontiguousarray writes a 0-d array
        header[name] = {"dtype": dt, "shape": list(t.shape) or [1],
                        "data_offsets": [offset, offset + nbytes]}
        payload.append((name, t))
        offset += nbytes
    if metadata:
        header["__metadata__"] = {k: str(v) for k, v in metadata.items()}

    hjson = json.dumps(header, separators=(",", ":")).encode()
    hjson += b" " * (-(8 + len(hjson)) % 8)  # pad the header to a multiple of 8
    prefix = struct.pack("<Q", len(hjson)) + hjson
    base = len(prefix)
    segments = [(0, np.frombuffer(prefix, np.uint8))]
    for name, t in payload:
        if t.numel():
            segments.append((base + header[name]["data_offsets"][0], _host_bytes(t)))
    native.write_file_segments(path, segments, total_size=base + offset, nthreads=nthreads)


def read_safetensors_header(path) -> tuple[dict, int]:
    """(header dict incl. ``__metadata__``, payload byte offset in file)."""
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
    return header, 8 + hlen


def _empty(info: dict, name: str, pin_memory: bool) -> torch.Tensor:
    dtype = _STR_TO_DTYPE.get(info["dtype"])
    if dtype is None:
        raise TypeError(f"unsupported safetensors dtype {info['dtype']} for {name!r}")
    return torch.empty(info["shape"], dtype=dtype, pin_memory=pin_memory)


def load_safetensors(path, names: Optional[list[str]] = None, nthreads: Optional[int] = None,
                     pin_memory: bool = False) -> dict[str, torch.Tensor]:
    """Read tensors (all, or the given ``names``) into CPU tensors (pinned
    with ``pin_memory``) with one parallel scatter-read."""
    header, base = read_safetensors_header(path)
    out: dict[str, torch.Tensor] = {}
    segments = []
    for name, info in header.items():
        if name == "__metadata__" or (names is not None and name not in names):
            continue
        t = _empty(info, name, pin_memory)
        out[name] = t
        if t.numel():
            segments.append((base + info["data_offsets"][0], _host_bytes(t)))
    native.read_file_segments(path, segments, nthreads=nthreads)
    return out


def safetensors_metadata(path) -> dict:
    """The file's ``__metadata__`` (string values), ``{}`` where it has none."""
    return read_safetensors_header(path)[0].get("__metadata__", {})


class LazySafetensorsFile:
    """Per-tensor lazy reader over one file (``safe_open`` analog): holds
    only the header; each :meth:`get` is a direct offset read."""

    def __init__(self, path):
        self.path = Path(path)
        self.header, self.base = read_safetensors_header(path)
        self.metadata = self.header.pop("__metadata__", {})

    def keys(self):
        return self.header.keys()

    def get(self, name: str) -> torch.Tensor:
        info = self.header[name]
        t = _empty(info, name, False)
        if t.numel():
            native.read_file_segments(self.path, [(self.base + info["data_offsets"][0],
                                                   _host_bytes(t))])
        return t
