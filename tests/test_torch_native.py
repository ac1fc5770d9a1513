"""The port's native runtime (``accelerate_tpu_torch/native``) and
safetensors serializer held against the JAX package's: the same IO engine
sources (built here with g++ into ``build/native``), crc32 equal to
zlib's and to the JAX package's native checksum, safetensors files equal
byte for byte in both directions, the staging ring, and the data loader's
ring-backed prefetch.  Each path also runs with the library absent (the
pure-Python fallbacks) and must give the same bytes."""

import subprocess
import sys
import threading
import zlib
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from accelerate_tpu import native as jax_native
from accelerate_tpu.utils import serialization as JS
from accelerate_tpu_torch import native
from accelerate_tpu_torch.utils import serialization as S

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(params=["native", "python"])
def io_path(request, monkeypatch):
    """Run a test on the native library and again on the pure-Python path."""
    assert native.is_available(), "g++ is in this container: the native path must build"
    if request.param == "python":
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_load", lambda: None)
    return request.param


def test_native_builds_from_its_sources_and_reports_its_path():
    assert native.is_available()
    assert Path(native.BUILD_LOG["path"]).parent == REPO / "build" / "native"
    srcs = sorted(p.name for p in (REPO / "accelerate_tpu_torch/native/src").glob("*.cc"))
    assert srcs == ["io_engine.cc", "ring.cc"]
    # the pure-Python path where the library is switched off
    code = ("import accelerate_tpu_torch.native as n; print(n.is_available())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env={"ACCELERATE_TPU_DISABLE_NATIVE": "1",
                                        "PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO)},
                         timeout=120)
    assert out.stdout.strip() == "False", out.stderr[-2000:]


def test_write_read_roundtrip(tmp_path, io_path):
    data = np.random.default_rng(0).integers(0, 255, 3_000_000, dtype=np.uint8)
    path = tmp_path / "blob.bin"
    native.write_file(path, data, nthreads=4)
    assert native.file_size(path) == data.nbytes
    assert np.array_equal(data, native.read_file(path, nthreads=4))


def test_read_offset_and_out_buffer(tmp_path, io_path):
    data = np.arange(1000, dtype=np.uint8)
    path = tmp_path / "blob.bin"
    native.write_file(path, data)
    out = np.empty(100, np.uint8)
    got = native.read_file(path, nbytes=100, offset=50, out=out)
    assert got is out and np.array_equal(out, data[50:150])


def test_segments_scatter_gather(tmp_path, io_path):
    path = tmp_path / "seg.bin"
    a = np.random.rand(64, 3).astype(np.float32)
    b = np.arange(17, dtype=np.int64)
    native.write_file_segments(path, [(0, a), (1024, b)])
    out_a, out_b = np.empty_like(a), np.empty_like(b)
    native.read_file_segments(path, [(0, out_a), (1024, out_b)])
    assert np.array_equal(a, out_a) and np.array_equal(b, out_b)
    with pytest.raises(ValueError, match="C-contiguous"):
        native.read_file_segments(path, [(0, np.empty((8, 8), np.float32)[:, ::2])])


def test_crc32_equals_zlib_and_the_jax_native_crc(io_path):
    """Slicing by 8 in the port's copy: every tail length, any seed."""
    data = np.random.default_rng(1).integers(0, 255, 100_003, dtype=np.uint8)
    for n in (0, 1, 7, 8, 9, 63, 64, 65, 100_003):
        for seed in (0, 0xDEADBEEF):
            want = zlib.crc32(data[:n].tobytes(), seed)
            assert native.crc32(data[:n], seed) == want == jax_native.crc32(data[:n], seed)


def test_file_crc32_in_chunks(tmp_path, monkeypatch):
    data = np.random.default_rng(3).integers(0, 255, 1_000_001, dtype=np.uint8)
    path = tmp_path / "blob.bin"
    native.write_file(path, data)
    monkeypatch.setattr(native, "_CRC_CHUNK", 65_536)
    assert native.file_crc32(path) == zlib.crc32(data.tobytes())


def test_missing_file_raises(tmp_path, io_path):
    with pytest.raises(OSError):
        native.read_file(tmp_path / "nope.bin", nbytes=10)
    with pytest.raises(OSError):
        native.file_size(tmp_path / "nope.bin")


# -- safetensors -------------------------------------------------------------


def _sample_arrays():
    rng = np.random.default_rng(2)
    return {
        "layer/kernel": rng.standard_normal((32, 16)).astype(np.float32),
        "layer/bias": rng.standard_normal(16).astype(np.float16),
        "ids": np.arange(7, dtype=np.int64),
        "bf16": rng.standard_normal((8, 8)).astype(ml_dtypes.bfloat16),
        "e4m3": rng.standard_normal((4, 8)).astype(ml_dtypes.float8_e4m3fn),
        "e5m2": rng.standard_normal((4, 8)).astype(ml_dtypes.float8_e5m2),
        "mask": rng.random(5) > 0.5,
        "codes": rng.integers(-128, 127, (3, 5)).astype(np.int8),
        "empty": np.zeros((0, 4), np.float32),
        "scalar": np.array(3, np.int64),
    }


def _as_torch(arr: np.ndarray) -> torch.Tensor:
    special = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
               "float8_e5m2": torch.float8_e5m2}
    if arr.dtype.name in special:
        raw = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint8).copy())
        return raw.view(special[arr.dtype.name]).reshape(arr.shape)
    return torch.from_numpy(np.array(arr, copy=True))


def _bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def test_safetensors_files_equal_the_jax_writer_both_ways(tmp_path, io_path):
    """The port writes the JAX writer's bytes for the same arrays (bf16 and
    both fp8 kinds included; a 0-d tensor as shape [1], as JAX writes a 0-d
    array), and each reads the other's file back bit for bit."""
    arrays = _sample_arrays()
    tensors = {k: _as_torch(v) for k, v in arrays.items()}
    JS.save_safetensors(str(tmp_path / "jax.safetensors"), arrays, metadata={"step": 7})
    S.save_safetensors(tmp_path / "port.safetensors", tensors, metadata={"step": 7})
    assert (tmp_path / "jax.safetensors").read_bytes() == (tmp_path / "port.safetensors").read_bytes()
    back = S.load_safetensors(tmp_path / "jax.safetensors")
    for k, t in tensors.items():
        assert back[k].dtype == t.dtype and back[k].numel() == t.numel(), k
        assert _bytes(back[k]) == _bytes(t), k
    assert S.safetensors_metadata(tmp_path / "jax.safetensors") == {"step": "7"}
    jback = JS.load_safetensors(str(tmp_path / "port.safetensors"))
    for k, a in arrays.items():
        assert np.ascontiguousarray(a).tobytes() == jback[k].tobytes(), k


def test_safetensors_library_agrees(tmp_path):
    from safetensors.torch import load_file, save_file

    tensors = {k: _as_torch(v) for k, v in _sample_arrays().items() if k != "scalar"}
    S.save_safetensors(tmp_path / "port.safetensors", tensors)
    for k, t in load_file(str(tmp_path / "port.safetensors")).items():
        assert _bytes(t) == _bytes(tensors[k]), k
    save_file(tensors, str(tmp_path / "lib.safetensors"))
    for k, t in S.load_safetensors(tmp_path / "lib.safetensors").items():
        assert _bytes(t) == _bytes(tensors[k]), k


def test_lazy_file_and_name_subset(tmp_path):
    tensors = {k: _as_torch(v) for k, v in _sample_arrays().items()}
    path = tmp_path / "m.safetensors"
    S.save_safetensors(path, tensors, metadata={"format": "pt"})
    lazy = S.LazySafetensorsFile(path)
    assert set(lazy.keys()) == set(tensors) and lazy.metadata == {"format": "pt"}
    assert torch.equal(lazy.get("ids"), tensors["ids"])
    subset = S.load_safetensors(path, names=["layer/kernel"])
    assert list(subset) == ["layer/kernel"]
    assert torch.equal(subset["layer/kernel"], tensors["layer/kernel"])
    with pytest.raises(TypeError, match="not safetensors-serializable"):
        S.save_safetensors(path, {"c": torch.zeros(2, dtype=torch.complex64)})


# -- staging ring ------------------------------------------------------------


def test_ring_fifo_under_backpressure():
    with native.StagingRing(3, 256) as ring:
        results = []

        def producer():
            for i in range(50):
                slot = ring.acquire()
                slot[:4] = np.frombuffer(np.int32(i).tobytes(), np.uint8)
                ring.commit(slot, 4)
            ring.close()

        t = threading.Thread(target=producer)
        t.start()
        while True:
            view = ring.pop()
            if view is None:
                break
            results.append(int(view[:4].view(np.int32)[0]))
            ring.release(view)
        t.join(timeout=10)
        assert not t.is_alive() and results == list(range(50))


def test_ring_close_unblocks_producer():
    ring = native.StagingRing(1, 64)
    slot = ring.acquire()
    ring.commit(slot, 8)  # the ring is full now
    acquired = []
    t = threading.Thread(target=lambda: acquired.append(ring.acquire()))
    t.start()
    ring.close()
    t.join(timeout=5)
    assert not t.is_alive() and acquired == [None]
    ring.destroy()


# -- the data loader's prefetch ring -----------------------------------------


def _batches(n=10):
    return [{"x": np.full((4, 8), i, np.float32), "y": np.arange(4) + 10 * i,
             "h": torch.full((2,), i, dtype=torch.bfloat16)} for i in range(n)]


def test_prefetch_loader_matches_plain():
    from accelerate_tpu_torch.data_loader import DataLoaderShard

    plain = list(DataLoaderShard(_batches(), device="cpu"))
    pref = list(DataLoaderShard(_batches(), device="cpu", prefetch_size=3))
    assert len(plain) == len(pref) == 10
    for a, b in zip(plain, pref):
        for k in ("x", "y", "h"):
            assert isinstance(b[k], torch.Tensor) and torch.equal(a[k], b[k]), k


def test_prefetch_loader_multiple_epochs_and_early_break():
    from accelerate_tpu_torch.data_loader import DataLoaderShard

    dl = DataLoaderShard(_batches(), device="cpu", prefetch_size=2)
    assert len(list(dl)) == 10
    for i, _ in enumerate(dl):
        if i == 2:
            break
    # a whole pass after an abandoned one still yields everything, in order
    assert [int(b["x"][0, 0]) for b in dl] == list(range(10))


def test_prefetch_oversized_batch_falls_back():
    """A batch larger than a slot rides the queue (the raw path)."""
    from accelerate_tpu_torch.data_loader import _RingPrefetcher

    batches = [{"x": np.full((8,), 1, np.float32)},
               {"x": np.random.rand(600_000).astype(np.float32)},
               {"x": np.full((8,), 3, np.float32)}]
    got = list(_RingPrefetcher(batches, lambda b: b, depth=2))
    assert len(got) == 3 and got[1]["x"].shape == (600_000,)
    assert float(got[2]["x"][0]) == 3.0


def test_prefetch_propagates_producer_error():
    from accelerate_tpu_torch.data_loader import DataLoaderShard

    def gen():
        yield {"x": np.zeros(4, np.float32)}
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        list(DataLoaderShard(gen(), device="cpu", prefetch_size=2))
