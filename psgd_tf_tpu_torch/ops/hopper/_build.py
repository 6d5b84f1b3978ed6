"""Build and load the CUDA kernels of `psgd_tf_tpu_torch/csrc/`.

Every `*.cu` file is compiled by `nvcc` for sm_90a into one shared library
with a plain C interface, loaded with ctypes. The build runs at the first
CUDA call, never at import, into `psgd_tf_tpu_torch/_build/<hash>/`, keyed
by a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads the library already built.

No `--use_fast_math` and no `-ftz=true`: the step normalizer adds the fp32
denormal `tiny` (1.4e-45), and flushing it to zero turns a zero group
gradient into `step / 0`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_IP = ctypes.POINTER(ctypes.c_int)
# C entry points: (restype, argtypes)
_SIGNATURES = {
    "psgd_tri_inv_upper": (ctypes.c_int, [ctypes.c_int, _PP, _PP, _IP, _P]),
    "psgd_kron_dd_scratch_floats": (ctypes.c_size_t, [ctypes.c_int, _IP, _IP]),
    "psgd_kron_dd_update": (
        ctypes.c_int,
        [ctypes.c_int, _PP, _PP, _PP, _PP, _PP, _PP, _IP, _IP,
         ctypes.c_float, _P, _P],
    ),
}

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the Hopper kernels build with the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    so = out_dir / "libpsgd_hopper.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        # build to a private name, then rename: concurrent builders never
        # load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [_nvcc(), *FLAGS, f"-I{CSRC}", "-o", tmp,
               *[str(s) for s in sorted(CSRC.glob("*.cu"))]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        (out_dir / "build.log").write_text(
            " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        )
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
            )
        os.replace(tmp, so)
    loaded = ctypes.CDLL(str(so))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(loaded, name)
        fn.restype = restype
        fn.argtypes = argtypes
    _lib = loaded
    return _lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def ptr_array(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def int_array(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)
