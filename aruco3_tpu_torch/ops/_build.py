"""Build and load the hand-written CUDA kernels of ``aruco3_tpu_torch/csrc``.

Each ``csrc/*.cu`` source compiles in its own ``nvcc`` process, all
started together, and one more links the objects into one shared library
with a plain C interface, loaded with ``ctypes``.  The library is built at
first use into ``build/aruco3_tpu_torch/`` at the root of the checkout,
named by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one loads at once.  Nothing here runs when the module is
imported.

Every kernel keeps ``-fmad=false``: the JAX reference decides ties (fit
argmax, refine scores, Otsu scores) on exact float32 results, and a
contracted multiply-add rounds differently.
"""

from __future__ import annotations

import ctypes
import functools
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
    "-Xcompiler",
    "-fPIC",
]

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLT = ctypes.c_float
_LL = ctypes.c_longlong

# C signatures: every pointer and the stream as c_void_p.
SIGNATURES = {
    "a3_frontend": [_PTR] * 5 + [_INT] * 14 + [_PTR],
    "a3_coarse_layout": [_INT] * 3 + [_PTR],
    "a3_coarse_fit": [_PTR] * 15 + [_INT] * 15 + [_FLT, _FLT] + [_INT] * 2 + [_LL, _PTR],
    "a3_coarse_labels": [_PTR] * 4 + [_INT] * 13 + [_LL, _PTR],
    "a3_coarse_cluster_layout": [_INT] * 3 + [_PTR],
    "a3_rank_layout": [_INT] * 4 + [_PTR],
    "a3_rank_roots": [_PTR] * 5 + [_LL] + [_INT] * 6 + [_PTR],
    "a3_lanes_layout": [_INT] * 2 + [_PTR],
    "a3_fit_lanes": [_PTR] * 8 + [_LL] + [_INT] * 6 + [_FLT, _PTR],
    "a3_fused_layout": [_INT] * 3 + [_PTR],
    "a3_fused_fit": [_PTR] * 15 + [_INT] * 8 + [_FLT, _FLT] + [_INT] * 2 + [_LL, _PTR],
    "a3_refine": [_PTR] * 8 + [_INT] * 8 + [_PTR],
    "a3_warp_decode": [_PTR] * 3 + [_INT] + [_PTR] * 9 + [_INT] * 7 + [_PTR],
    "a3_warp_eval": [_PTR] * 4 + [_INT] * 3 + [_PTR],
    "a3_ippe": [_PTR] * 2 + [_FLT] * 2 + [_PTR] * 3 + [_LL, _PTR],
}

_lib = None
_fns: dict = {}


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


def _run(cmds: list[list[str]]) -> None:
    """Run the commands side by side; raise with the output of a failure."""
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for cmd in cmds
    ]
    failed = []
    for cmd, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(" ".join(cmd) + "\n" + log)
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in sources()]
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)] for obj, src in zip(objs, sources())])
        lib_tmp = os.path.join(tmp, out.name)
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib_tmp, *objs]])
        os.replace(lib_tmp, out)  # atomic: a concurrent build never sees a partial file
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


def fn(name: str):
    """The library's C function ``name`` (looked up once)."""
    f = _fns.get(name)
    if f is None:
        f = _fns[name] = getattr(lib(), name)
    return f


@functools.lru_cache(maxsize=None)
def layout(name: str, *args: int) -> tuple[int, int]:
    """(bytes of shared memory a block, ints of device scratch a frame or
    block) that a kernel takes, from the library's ``a3_*_layout`` export
    ``name``: the kernel's source decides where its state lives.  Looked
    up once per shape (a wrapper asks on every launch)."""
    out = (ctypes.c_longlong * 2)()
    check(fn(name)(*args, out), name)
    return int(out[0]), int(out[1])


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher: ValueError
    for cudaErrorInvalidValue (arguments the launcher refuses), else
    RuntimeError."""
    if err == 1:
        raise ValueError(f"{name}: arguments outside what the kernel takes")
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


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def stream() -> int:
    """The current CUDA stream of the current device, as a raw handle (no
    ``torch.cuda.Stream`` object is built: this runs on every launch)."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
