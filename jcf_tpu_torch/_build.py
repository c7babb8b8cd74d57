"""Build and load the package's CUDA kernels; count their launches.

``csrc/*.cu`` compile at first use with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``. Each C
entry launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises if that is not 0. The library
lands in a build directory named after a hash of the sources, under
``build/`` at the repository root, so an edited source never loads a
stale build. Nothing here runs at import time.

Each kernel wrapper module keeps a ``LAUNCHES`` dict of plain ints, one
per kernel, which its wrapper increments where it launches the kernel
and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry -> argument types (pointers and the stream as c_void_p)
SIGNATURES = {
    "jcf_view": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "jcf_assemble": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "jcf_ln_quant": [_P, _P, _P, _I, _I, _P],
    "jcf_int8_gemm": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "jcf_attention": [_P, _P, _P, _I, _I, _I, _I, _P],
}

_lib = None


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    srcs = sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + f.read())
    out_dir = os.path.join(os.path.dirname(_PKG), "build", "jcf_tpu_torch", h.hexdigest()[:16])
    lib_path = os.path.join(out_dir, "libjcf_kernels.so")
    if not os.path.exists(lib_path):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{lib_path}.tmp{os.getpid()}"
        cmd = [nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
               *(p for p in srcs if p.endswith(".cu"))]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
