"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into a shared library with
a plain C interface, bound with :mod:`ctypes` (no PyTorch headers, so a
build takes seconds).  The library lands in ``build/`` at the root of the
checkout, named by a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, at the first call that needs it; later
calls and later processes reuse it.  Nothing here runs at
import time: the CPU tests import every module of the port and have no
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, dict] = {}  # source name -> {"seconds", "ptxas", "path"}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc``
    or the first ``nvcc`` on ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels build "
            "from accelerate_tpu_torch/csrc at first use"
        )
    return found


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names) -> dict[str, Path]:
    """Compile every ``csrc/<name>.cu`` that has no library built from the
    same source and flags in ``build/`` yet, one ``nvcc`` per source, all
    started together (each library's ptxas report beside it, so that a
    later process reads it from ``BUILD_LOG`` too).  Returns each
    library's path."""
    out = {name: _target(name) for name in names}
    started = {}
    for name, lib in out.items():
        if lib.is_file():
            log = lib.with_suffix(".ptxas")     # the build's ptxas report, kept beside it
            BUILD_LOG.setdefault(name, {"seconds": 0.0, "path": str(lib),
                                        "ptxas": log.read_text() if log.is_file() else ""})
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        started[name] = (proc, tmp, time.perf_counter())
    failed = []
    for name, (proc, tmp, t0) in started.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu:\n{stdout}\n{stderr}")
            continue
        out[name].with_suffix(".ptxas").write_text(stderr)
        os.replace(tmp, out[name])
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "ptxas": stderr,
                           "path": str(out[name])}
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library built from the same
    source and flags is already in ``build/``.  Returns the library path."""
    return build_all([name])[name]


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first if
    needed.  ``signatures`` maps each C function to ``(argtypes,
    restype)``, set once when the library loads."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LIBS[name] = lib
    return lib
