"""Host-side native runtime: parallel checkpoint IO and the staging ring
(the port's own copy of ``accelerate_tpu/native/``; the C++ sources in
``src/`` are that package's, unchanged, and depend on no framework).

``src/*.cc`` compile with ``g++`` into ``build/native/`` at the root of the
checkout (a library named by a hash of the sources and flags) at the first
call that needs it, never at import, and are driven through ctypes.
ctypes foreign calls release the GIL, so checkpoint writes and staging
copies overlap Python-side work.  Where no C++ compiler exists (or
``ACCELERATE_TPU_DISABLE_NATIVE=1``), every function below takes its
pure-Python path and :func:`is_available` returns False.

Surface:
- :func:`write_file` / :func:`read_file` — multi-threaded pwrite/pread.
- :func:`write_file_segments` / :func:`read_file_segments` — scatter/gather
  segment IO (the safetensors payload layout without a concatenation copy).
- :func:`crc32` — the checksum of ``zlib.crc32``.
- :class:`StagingRing` — bounded arena of aligned slots with blocking
  producer/consumer semantics (the data loader's prefetch buffer).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-Wall", "-shared")

_lib = None
_load_lock = threading.Lock()
_load_attempted = False
BUILD_LOG: dict = {}   # "seconds", "path" of the build this process made or found


def _target() -> Path:
    srcs = sorted(_SRC_DIR.glob("*.cc"))
    digest = hashlib.sha256(b"".join(s.read_bytes() for s in srcs)
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libaccel_native-{digest}.so"


def _build() -> Optional[Path]:
    """The library built from ``src/*.cc`` (compiled now if no build of the
    same sources and flags exists), or None where there is no compiler or
    it fails.  Several processes may race here: the compile goes to a
    per-pid file and lands by an atomic rename under an flock."""
    import fcntl
    import time

    target = _target()
    if target.exists():
        BUILD_LOG.update(seconds=0.0, path=str(target))
        return target
    cxx = os.environ.get("CXX", "g++")
    if shutil.which(cxx) is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if target.exists():  # another process built it while we waited
            BUILD_LOG.update(seconds=0.0, path=str(target))
            return target
        tmp = target.with_suffix(f".so.tmp.{os.getpid()}")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, sorted(_SRC_DIR.glob("*.cc")))]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            if proc.returncode != 0 or not tmp.exists():
                return None
            os.replace(tmp, target)   # loaders never see a partial library
        finally:
            tmp.unlink(missing_ok=True)
        BUILD_LOG.update(seconds=time.perf_counter() - t0, path=str(target))
    return target


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u64, i64, u32, i32 = ctypes.c_uint64, ctypes.c_int64, ctypes.c_uint32, ctypes.c_int
    p, pp, cs = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p
    pu64 = ctypes.POINTER(u64)

    lib.at_file_size.argtypes = [cs]
    lib.at_file_size.restype = i64
    lib.at_write_file.argtypes = [cs, p, u64, i32]
    lib.at_write_file.restype = i32
    lib.at_read_file.argtypes = [cs, p, u64, u64, i32]
    lib.at_read_file.restype = i32
    lib.at_write_file_segments.argtypes = [cs, pp, pu64, pu64, i32, u64, i32]
    lib.at_write_file_segments.restype = i32
    lib.at_read_file_segments.argtypes = [cs, pp, pu64, pu64, i32, i32]
    lib.at_read_file_segments.restype = i32
    lib.at_crc32.argtypes = [p, u64, u32]
    lib.at_crc32.restype = u32
    lib.at_ring_create.argtypes = [i32, u64]
    lib.at_ring_create.restype = p
    lib.at_ring_slot_bytes.argtypes = [p]
    lib.at_ring_slot_bytes.restype = u64
    lib.at_ring_acquire.argtypes = [p]
    lib.at_ring_acquire.restype = p
    lib.at_ring_commit.argtypes = [p, p, u64]
    lib.at_ring_commit.restype = i32
    lib.at_ring_pop.argtypes = [p, pp, pu64]
    lib.at_ring_pop.restype = i32
    lib.at_ring_release.argtypes = [p, p]
    lib.at_ring_release.restype = i32
    lib.at_ring_close.argtypes = [p]
    lib.at_ring_close.restype = None
    lib.at_ring_destroy.argtypes = [p]
    lib.at_ring_destroy.restype = None
    return lib


def _load():
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    with _load_lock:
        if _lib is not None or _load_attempted:
            return _lib
        _load_attempted = True
        if os.environ.get("ACCELERATE_TPU_DISABLE_NATIVE", "").lower() in ("1", "true"):
            return None
        path = _build()
        if path is not None:
            try:
                _lib = _bind(ctypes.CDLL(str(path)))
            except OSError:
                _lib = None
    return _lib


def is_available() -> bool:
    """True when the native library is built and loaded (building it now if
    need be); False means every call here takes its pure-Python path."""
    return _load() is not None


def _as_bytes_view(buf) -> np.ndarray:
    """Flat contiguous uint8 view (copies only if non-contiguous)."""
    arr = np.ascontiguousarray(buf) if isinstance(buf, np.ndarray) else np.frombuffer(buf, np.uint8)
    return arr.reshape(-1).view(np.uint8)


DEFAULT_IO_THREADS = max(4, (os.cpu_count() or 1))


def write_file(path, buf, nthreads: Optional[int] = None) -> None:
    lib = _load()
    view = _as_bytes_view(buf)
    if lib is None:
        Path(path).write_bytes(view.tobytes())
        return
    rc = lib.at_write_file(
        os.fsencode(str(path)), view.ctypes.data, view.nbytes, nthreads or DEFAULT_IO_THREADS
    )
    if rc != 0:
        raise OSError(rc, os.strerror(rc), str(path))


def read_file(path, nbytes: Optional[int] = None, offset: int = 0,
              nthreads: Optional[int] = None, out: Optional[np.ndarray] = None) -> np.ndarray:
    lib = _load()
    if nbytes is None:
        nbytes = file_size(path) - offset
    if lib is None:
        with open(path, "rb") as f:
            f.seek(offset)
            data = np.frombuffer(f.read(nbytes), np.uint8)
        if out is not None:
            out.reshape(-1).view(np.uint8)[: data.nbytes] = data
            return out
        return data.copy()
    if out is None:
        out = np.empty(nbytes, np.uint8)
    view = out.reshape(-1).view(np.uint8)
    if view.nbytes < nbytes:
        raise ValueError(f"out buffer too small: {view.nbytes} < {nbytes}")
    rc = lib.at_read_file(
        os.fsencode(str(path)), view.ctypes.data, nbytes, offset, nthreads or DEFAULT_IO_THREADS
    )
    if rc != 0:
        raise OSError(rc, os.strerror(rc), str(path))
    return out


def file_size(path) -> int:
    lib = _load()
    if lib is None:
        return os.path.getsize(path)
    size = lib.at_file_size(os.fsencode(str(path)))
    if size < 0:
        raise OSError(-size, os.strerror(-size), str(path))
    return size


def write_file_segments(path, segments, total_size: Optional[int] = None,
                        nthreads: Optional[int] = None) -> None:
    """Write ``[(offset, buf), ...]`` segments of one file in a single pass:
    each buffer goes straight from its own host memory to its file offset,
    no concatenation copy (the safetensors layout writer)."""
    views = [(off, _as_bytes_view(buf)) for off, buf in segments]
    if total_size is None:
        total_size = max((off + v.nbytes for off, v in views), default=0)
    lib = _load()
    if lib is None:
        with open(path, "wb") as f:
            f.truncate(total_size)
            for off, v in views:
                f.seek(off)
                f.write(v.tobytes())
        return
    n = len(views)
    ptrs = (ctypes.c_void_p * n)(*[v.ctypes.data for _, v in views])
    sizes = (ctypes.c_uint64 * n)(*[v.nbytes for _, v in views])
    offs = (ctypes.c_uint64 * n)(*[off for off, _ in views])
    rc = lib.at_write_file_segments(
        os.fsencode(str(path)), ptrs, sizes, offs, n, total_size,
        nthreads or DEFAULT_IO_THREADS,
    )
    if rc != 0:
        raise OSError(rc, os.strerror(rc), str(path))


def read_file_segments(path, segments, nthreads: Optional[int] = None) -> None:
    """Scatter-read ``[(offset, out_array), ...]``: each segment lands
    directly in its destination buffer, which must be a C-contiguous numpy
    array."""
    views = []
    for off, out in segments:
        if not (isinstance(out, np.ndarray) and out.flags.c_contiguous):
            raise ValueError("read_file_segments requires C-contiguous output arrays")
        views.append((off, out.reshape(-1).view(np.uint8)))
    lib = _load()
    if lib is None:
        with open(path, "rb") as f:
            for off, v in views:
                f.seek(off)
                data = f.read(v.nbytes)
                if len(data) != v.nbytes:
                    raise OSError(f"short read of {path} at {off}")
                v[:] = np.frombuffer(data, np.uint8)
        return
    n = len(views)
    ptrs = (ctypes.c_void_p * n)(*[v.ctypes.data for _, v in views])
    sizes = (ctypes.c_uint64 * n)(*[v.nbytes for _, v in views])
    offs = (ctypes.c_uint64 * n)(*[off for off, _ in views])
    rc = lib.at_read_file_segments(
        os.fsencode(str(path)), ptrs, sizes, offs, n, nthreads or DEFAULT_IO_THREADS
    )
    if rc != 0:
        raise OSError(rc, os.strerror(rc), str(path))


def crc32(buf, seed: int = 0) -> int:
    """``zlib.crc32(buf, seed)``."""
    lib = _load()
    view = _as_bytes_view(buf)
    if lib is None:
        import zlib

        return zlib.crc32(view, seed)
    return int(lib.at_crc32(view.ctypes.data, view.nbytes, seed))


_CRC_CHUNK = 64 << 20


def file_crc32(path) -> int:
    """The crc32 of a whole file, read in 64 MiB chunks."""
    size = file_size(path)
    buf = np.empty(min(size, _CRC_CHUNK), np.uint8)
    crc, off = 0, 0
    while off < size:
        n = min(_CRC_CHUNK, size - off)
        read_file(path, n, offset=off, out=buf, nthreads=1)
        crc = crc32(buf[:n], crc)
        off += n
    return crc & 0xFFFFFFFF


class StagingRing:
    """Bounded arena of aligned byte slots with blocking producer/consumer
    semantics — the host-side prefetch buffer behind
    ``DataLoaderShard(prefetch_size=...)``.

    Producer thread: ``slot = ring.acquire(); <copy bytes into slot>;
    ring.commit(slot, n)``.  Consumer: ``view = ring.pop(); ...;
    ring.release(view)``.  ``close()`` wakes both sides.
    """

    def __init__(self, n_slots: int, slot_bytes: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native runtime unavailable (no C++ compiler)")
        self._lib = lib
        self._h = lib.at_ring_create(n_slots, slot_bytes)
        if not self._h:
            raise MemoryError(f"cannot allocate staging ring ({n_slots}x{slot_bytes} B)")
        self.n_slots = n_slots
        self.slot_bytes = int(lib.at_ring_slot_bytes(self._h))
        self._closed = False

    def acquire(self) -> Optional[np.ndarray]:
        """Blocking; a writable uint8 view of a free slot, or None if closed."""
        ptr = self._lib.at_ring_acquire(self._h)
        if not ptr:
            return None
        return np.ctypeslib.as_array((ctypes.c_uint8 * self.slot_bytes).from_address(ptr))

    def commit(self, slot: np.ndarray, size: int) -> None:
        rc = self._lib.at_ring_commit(self._h, slot.ctypes.data, size)
        if rc != 0:
            raise ValueError(f"ring commit failed ({rc})")

    def pop(self) -> Optional[np.ndarray]:
        """Blocking; a uint8 view of the oldest staged bytes, or None when the
        ring is closed and drained."""
        ptr = ctypes.c_void_p()
        size = ctypes.c_uint64()
        got = self._lib.at_ring_pop(self._h, ctypes.byref(ptr), ctypes.byref(size))
        if not got:
            return None
        return np.ctypeslib.as_array((ctypes.c_uint8 * size.value).from_address(ptr.value))

    def release(self, view: np.ndarray) -> None:
        rc = self._lib.at_ring_release(self._h, view.ctypes.data)
        if rc != 0:
            raise ValueError(f"ring release failed ({rc})")

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._lib.at_ring_close(self._h)

    def destroy(self) -> None:
        if self._h:
            self.close()
            self._lib.at_ring_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.destroy()
