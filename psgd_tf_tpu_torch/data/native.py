"""ctypes bindings for the native host-side data pipeline.

Counterpart of `psgd_tf_tpu/data/native.py`, over the port's own copy of
the C++ source (`_native/batcher.cpp`). At first use it is built with
`g++ -O3 -shared -fPIC` into `psgd_tf_tpu_torch/_build/<hash>/batcher.so`,
keyed by a hash of the source and the flags (as `ops/hopper/_build.py`
keys the CUDA library), and loaded; an unchanged source loads the library
already built. Nothing is written next to the source.

`available()` is False when there is no compiler or the build or load
fails; `data.mnist.load_idx` then decodes in Python. The decoders and the
batch helpers raise `RuntimeError` without the library, and keep the JAX
package's header validation and errors.
"""
from __future__ import annotations

import ctypes
import gzip
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "_native" / "batcher.cpp"
_BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None
_tried = False


def _so_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16] / "batcher.so"


def _build(so: Path) -> bool:
    """Compile to a private name and rename: a concurrent build never
    loads a half-written library."""
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            so = _so_path()
        except OSError:
            return None
        if not so.exists() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        u8, f32 = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)
        i32, i64 = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
        long, u64 = ctypes.c_long, ctypes.c_uint64
        for name, restype, argtypes in [
            ("psgd_decode_idx_images", long, [u8, long, f32, long]),
            ("psgd_decode_idx_labels", long, [u8, long, i32, long]),
            ("psgd_sample_batch", None, [f32, i32, long, long, long, u64, f32, i32]),
            ("psgd_shuffle_epoch", None, [long, u64, i64]),
        ]:
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError("native batcher unavailable")
    return lib


def _read_bytes(path: str) -> bytes:
    if path.endswith(".gz") or not os.path.exists(path) and os.path.exists(path + ".gz"):
        gz = path if path.endswith(".gz") else path + ".gz"
        with gzip.open(gz, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def decode_idx_images(path: str, max_n: int = 1 << 31) -> np.ndarray:
    """(n, rows*cols) float32 in [0,1] from an idx3 file (native decode)."""
    lib = _require()
    raw = np.frombuffer(_read_bytes(path), dtype=np.uint8)
    # validate the header before sizing any allocation from it
    if raw.size < 16 or int.from_bytes(raw[0:4].tobytes(), "big") != 2051:
        raise ValueError(f"bad idx3 file: {path}")
    n_hdr = int.from_bytes(raw[4:8].tobytes(), "big")
    rows = int.from_bytes(raw[8:12].tobytes(), "big")
    cols = int.from_bytes(raw[12:16].tobytes(), "big")
    n = min(n_hdr, max_n)
    if rows * cols <= 0 or raw.size < 16 + n * rows * cols:
        raise ValueError(f"bad idx3 file: {path}")
    out = np.empty((n, rows * cols), np.float32)
    got = lib.psgd_decode_idx_images(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_long(raw.size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_long(n),
    )
    if got < 0:
        raise ValueError(f"bad idx3 file: {path}")
    return out[:got]


def decode_idx_labels(path: str, max_n: int = 1 << 31) -> np.ndarray:
    """(n,) int32 labels from an idx1 file (native decode)."""
    lib = _require()
    raw = np.frombuffer(_read_bytes(path), dtype=np.uint8)
    if raw.size < 8 or int.from_bytes(raw[0:4].tobytes(), "big") != 2049:
        raise ValueError(f"bad idx1 file: {path}")
    n = min(int.from_bytes(raw[4:8].tobytes(), "big"), max_n)
    if raw.size < 8 + n:
        raise ValueError(f"bad idx1 file: {path}")
    out = np.empty((n,), np.int32)
    got = lib.psgd_decode_idx_labels(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_long(raw.size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_long(n),
    )
    if got < 0:
        raise ValueError(f"bad idx1 file: {path}")
    return out[:got]


def sample_batch(
    images: np.ndarray, labels: np.ndarray, batch: int, seed: int
) -> tuple[np.ndarray, np.ndarray]:
    """Uniformly sample a (batch, feat) x / (batch,) y pair, native gather."""
    lib = _require()
    if not (images.dtype == np.float32 and images.flags.c_contiguous and images.ndim == 2):
        raise ValueError("images must be a C-contiguous (n, feat) float32 array")
    if not (labels.dtype == np.int32 and labels.flags.c_contiguous
            and labels.shape == images.shape[:1]):
        raise ValueError("labels must be a C-contiguous (n,) int32 array")
    n, feat = images.shape
    if n == 0 and batch > 0:
        raise ValueError("cannot sample a batch from an empty dataset")
    out_x = np.empty((batch, feat), np.float32)
    out_y = np.empty((batch,), np.int32)
    lib.psgd_sample_batch(
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_long(n),
        ctypes.c_long(feat),
        ctypes.c_long(batch),
        ctypes.c_uint64(seed),
        out_x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_y.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out_x, out_y


def shuffle_epoch(n: int, seed: int) -> np.ndarray:
    """Deterministic Fisher-Yates permutation of range(n), native."""
    lib = _require()
    out = np.empty((n,), np.int64)
    lib.psgd_shuffle_epoch(
        ctypes.c_long(n),
        ctypes.c_uint64(seed),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out
