"""Build and load the hand-written CUDA kernels of ``aruco3_tpu_torch/csrc``.

All ``csrc/*.cu`` sources compile with one ``nvcc`` call into one shared
library with a plain C interface, loaded with ``ctypes``.  The library is
built at first use into ``build/aruco3_tpu_torch/`` at the root of the
checkout, named by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads at once.  Nothing here runs when the
module is imported.

Every kernel keeps ``-fmad=false``: the JAX reference decides ties (fit
argmax, refine scores, Otsu scores) on exact float32 results, and a
contracted multiply-add rounds differently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "aruco3_tpu_torch"
NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-fmad=false",
    "-shared",
    "-Xcompiler",
    "-fPIC",
]

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLT = ctypes.c_float

# C signatures: every pointer and the stream as c_void_p.
SIGNATURES = {
    "a3_frontend": [_PTR] * 5 + [_INT] * 8 + [_PTR],
    "a3_coarse_fit": [_PTR] * 16 + [_INT] * 15 + [_FLT, _FLT, _INT, _PTR],
    "a3_refine": [_PTR] * 8 + [_INT] * 8 + [_PTR],
    "a3_warp_decode": [_PTR] * 12 + [_INT] * 6 + [_PTR],
}

_lib = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    return BUILD_DIR / f"libaruco3_kernels_{_digest()}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            "nvcc failed:\n" + " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        )
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def checked_ptr(t: torch.Tensor, dtype, shape=None, name="tensor"):
    """Validate a kernel input: CUDA, dtype, contiguity and shape."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    return ctypes.c_void_p(t.data_ptr())


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
