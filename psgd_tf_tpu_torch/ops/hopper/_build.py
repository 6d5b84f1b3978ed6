"""Build and load the CUDA kernels of `psgd_tf_tpu_torch/csrc/`.

Every `*.cu` file is compiled by its own `nvcc` for sm_90a, all started
together, and the objects are linked into one shared library with a plain
C interface, loaded with ctypes. The build runs at the first CUDA call,
never at import, into `psgd_tf_tpu_torch/_build/<hash>/`, keyed by a hash
of the sources and flags, so an edited source rebuilds and an unchanged
one loads the library already built.

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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_IP = ctypes.POINTER(ctypes.c_int)
# C entry points: (restype, argtypes)
_SIGNATURES = {
    "psgd_tri_inv_upper": (ctypes.c_int, [ctypes.c_int, _PP, _PP, _IP, _P]),
    "psgd_kron_multi_scratch_floats": (ctypes.c_size_t, [ctypes.c_int, _IP, _IP, _IP]),
    "psgd_kron_multi_update": (
        ctypes.c_int,
        [ctypes.c_int, ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, _P, _P, ctypes.c_int],
    ),
    "psgd_kron_dd_batched_scratch_floats": (
        ctypes.c_size_t, [ctypes.c_int, ctypes.c_int, ctypes.c_int, _IP, _IP],
    ),
    "psgd_kron_dd_batched_update": (
        ctypes.c_int,
        [ctypes.c_int, ctypes.c_int, ctypes.c_int] + [_P] * 6
        + [_IP, _IP, ctypes.c_float, _P, _P, ctypes.c_int, _IP],
    ),
    "psgd_kron_ns_update_scratch_floats": (ctypes.c_size_t, [ctypes.c_int] * 4),
    "psgd_kron_ns_update": (
        ctypes.c_int,
        [ctypes.c_int, ctypes.c_int] + [_P] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_float]
        + [_P] * 4,
    ),
    "psgd_kron_nd_big_scratch_floats": (ctypes.c_size_t, [ctypes.c_int, ctypes.c_int]),
    "psgd_gemm_test": (
        ctypes.c_int,
        [ctypes.c_int] * 3 + [_P, ctypes.c_int, ctypes.c_int, _P, ctypes.c_int, ctypes.c_int]
        + [_P] * 7 + [ctypes.c_float] + [ctypes.c_int] * 4 + [_P],
    ),
    "psgd_kron_nd_big": (
        ctypes.c_int,
        [ctypes.c_int, ctypes.c_int, _P, ctypes.c_int, _P, ctypes.c_int] + [_P] * 10,
    ),
    "psgd_kron_ds_update_scratch_floats": (ctypes.c_size_t, [ctypes.c_int, ctypes.c_int]),
    "psgd_kron_ds_update": (
        ctypes.c_int,
        [ctypes.c_int, ctypes.c_int, _P, _P, _P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_float]
        + [_P] * 4,
    ),
    "psgd_kron_apply_scratch_floats": (ctypes.c_size_t, [ctypes.c_int] * 3),
    "psgd_kron_apply_ns": (ctypes.c_int, [ctypes.c_int, ctypes.c_int] + [_P] * 6),
    "psgd_kron_apply_nd": (ctypes.c_int, [ctypes.c_int, ctypes.c_int] + [_P] * 6),
    "psgd_tri_solve_scratch_floats": (ctypes.c_size_t, [ctypes.c_int] * 4),
    "psgd_tri_solve": (ctypes.c_int, [ctypes.c_int] * 5 + [_IP, ctypes.c_int] + [_P] * 5),
    "psgd_dense_scratch_floats": (ctypes.c_size_t, [ctypes.c_int]),
    "psgd_dense_update": (
        ctypes.c_int,
        [ctypes.c_int, _P, _P, _P, _P, ctypes.c_float, _P, _P, _P, ctypes.c_int, _P],
    ),
    "psgd_lra_scratch_floats": (ctypes.c_size_t, [ctypes.c_int, ctypes.c_int]),
    "psgd_lra_stage1": (ctypes.c_int, [ctypes.c_int] * 3 + [_P] * 8),
    "psgd_lra_stage3": (ctypes.c_int, [ctypes.c_int] * 3 + [_P] * 12),
    "psgd_lra_stage4": (ctypes.c_int, [ctypes.c_int] * 3 + [_P] * 9),
    "psgd_lra_corner_a": (
        ctypes.c_int, [ctypes.c_int, _P, _P, ctypes.c_float, ctypes.c_int, ctypes.c_int] + [_P] * 4,
    ),
    "psgd_lra_corner_b": (ctypes.c_int, [ctypes.c_int, _P, _P, ctypes.c_float] + [_P] * 4),
    "psgd_lra_update": (
        ctypes.c_int,
        [ctypes.c_int] * 2 + [_P] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_int] + [_P] * 5,
    ),
    "psgd_splu_scratch_floats": (ctypes.c_size_t, [ctypes.c_int, ctypes.c_int]),
    "psgd_splu_update": (
        ctypes.c_int, [ctypes.c_int, ctypes.c_int] + [_P] * 7 + [ctypes.c_float] + [_P] * 7,
    ),
    "psgd_splu_mono_grid": (ctypes.c_int, [ctypes.c_int] * 4 + [_IP]),
    "psgd_splu_mono": (
        ctypes.c_int,
        [ctypes.c_int, ctypes.c_int] + [_P] * 7 + [ctypes.c_float] + [_P] * 6 + [ctypes.c_int, _P],
    ),
    "psgd_splu_sharded_stage1": (ctypes.c_int, [ctypes.c_int] * 3 + [_P] * 10),
    "psgd_splu_sharded_stage2": (ctypes.c_int, [ctypes.c_int] * 2 + [_P] * 11),
    "psgd_splu_sharded_stage3": (
        ctypes.c_int, [ctypes.c_int] * 2 + [_P] * 7 + [ctypes.c_float] + [_P] * 8,
    ),
    "psgd_splu_sharded_stage4": (ctypes.c_int, [ctypes.c_int] * 2 + [_P] * 9),
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
        _compile_and_link(out_dir, so)
    loaded = ctypes.CDLL(str(so))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(loaded, name)
        fn.restype = restype
        fn.argtypes = argtypes
    _lib = loaded
    return _lib


def _run_all(cmds: list[list[str]], log) -> None:
    """Run the commands concurrently; log each one's output; raise if any fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out = proc.communicate()[0]
        log.write(" ".join(cmd) + "\n" + out + "\n")
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({proc.returncode}):\n{out[-4000:]}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def _compile_and_link(out_dir: Path, so: Path) -> None:
    """One nvcc per source, all at once, then one link. The library is
    linked to a private name and renamed: concurrent builders never load a
    half-written library."""
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    objs = [tmp / (src.stem + ".o") for src in sorted(CSRC.glob("*.cu"))]
    with open(out_dir / "build.log", "w") as log:
        _run_all([[nvcc, *FLAGS, f"-I{CSRC}", "-c", str(CSRC / (o.stem + ".cu")), "-o", str(o)]
                  for o in objs], log)
        _run_all([[nvcc, "-shared", "-o", str(tmp / so.name), *map(str, objs)]], log)
    os.replace(tmp / so.name, so)
    shutil.rmtree(tmp, ignore_errors=True)


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def ptr_array(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def int_array(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)
