"""Build and load the package's CUDA kernels and its host JPEG decoder;
count their launches.

``csrc/*.cu`` compile at first use with ``nvcc`` for ``sm_90a``, one
process per source started together, and link into one shared library
with a plain C interface, loaded with ``ctypes``. Each C entry launches
on the stream it is given and returns ``cudaGetLastError()``; ``check``
raises if that is not 0. ``csrc/jpeg_entropy.cpp`` (the JPEG markers and
Huffman decoding, host code) compiles with ``g++`` into a library of its
own (``load_entropy``), on the card's host and on a CPU-only machine
alike. Each library lands in a build directory named after a hash of its
sources and flags, under ``build/`` at the repository root, so an edited
source never loads a stale build; a build writes to a temporary name and
``os.replace``s it, so processes that race build it each and load whole
files. Nothing here runs at import time.

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
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]
ENTROPY_SRC = "jpeg_entropy.cpp"
GXX_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry -> argument types (pointers and the stream as c_void_p)
SIGNATURES = {
    "jcf_view": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "jcf_assemble": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "jcf_ln_quant": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "jcf_quant_rows": [_P, _P, _P, _I, _I, _I, _I, _P],
    "jcf_int8_gemm": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P],
    "jcf_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _F, _I, _I, _P],
    "jcf_cls_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
    "jcf_bf16_gemm": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _P],
    "jcf_f32_gemm": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _P],
    "jcf_tf32_split": [_P, _P, ctypes.c_longlong, _P],
    "jcf_ln_affine": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "jcf_masked_attention": [_P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _P],
    "jcf_pair_attention": [_P, _P, _I, _I, _I, _I, _F, _F, _I, _P],
    "jcf_packed_attention": [_P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P],
    "jcf_packed_attention_bwd": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P],
    "jcf_blocked_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, *[ctypes.c_longlong] * 6,
                              _F, _I, _P],
    "jcf_int8_layers": [_I, *[_P] * 31, *[_I] * 8, _P],
    "jcf_block_float": [_I, *[_P] * 19, _I, _I, _I, _I, _I, _F, _P],
    "jcf_jpeg_idct": [_P, _P, _P, _I, ctypes.c_longlong, _P, _P],
    "jcf_jpeg_upsample_color": [_P, _P, _I, ctypes.c_longlong, _P, _P],
    "jcf_resize_crop": [_P, _I, ctypes.c_longlong, _I, _P, _P],
    "jcf_copy_add_one": [_P, _P, ctypes.c_longlong, _P],
    "jcf_batched_dot_mma": [_P, _P, _P, _P, _I, _I, _P],
    "jcf_batched_dot_loop": [_P, _P, _P, _P, _I, _I, _P],
    "jcf_w4a8_gemm": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "jcf_unpack_int4": [_P, _P, _I, _I, _P],
    "jcf_patch_regroup": [_P, _P, _I, _I, _I, _I, _I, _P],
}
# the entropy decoder's entries (csrc/jpeg_entropy.cpp)
ENTROPY_SIGNATURES = {
    "jcf_jpeg_open": ([_P, ctypes.c_longlong, _P, _P, _I], _P),
    "jcf_jpeg_copy": ([_P, _P, _P], None),
    "jcf_jpeg_close": ([_P], None),
}

_lib = None
_entropy_lib = None
_entropy_lock = threading.Lock()


def cuda_home() -> str:
    return os.environ.get("CUDA_HOME") or "/usr/local/cuda"


def nvcc() -> str:
    home = cuda_home()
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _run(cmd) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(cmd[0])} failed: {' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")


def _out_dir() -> str:
    """The build directory of these sources and flags."""
    srcs = sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh")))
    return _hashed_dir(srcs, NVCC_FLAGS)


def _hashed_dir(srcs: list, flags: list) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in srcs:
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + f.read())
    return os.path.join(os.path.dirname(_PKG), "build", "jcf_tpu_torch", h.hexdigest()[:16])


def _compile_all(out_dir: str, names: list, tag: str) -> dict:
    """One nvcc per source, all at once -> {name: (object path, error or None)}."""
    procs = {}
    for name in names:
        obj = os.path.join(out_dir, f"{name}.{tag}.o")
        cmd = [nvcc(), *NVCC_FLAGS, "-c", "-I", CSRC, "-o", obj, os.path.join(CSRC, name)]
        procs[name] = (obj, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True))
    done = {}
    for name, (obj, cmd, proc) in procs.items():
        out, _ = proc.communicate()
        done[name] = (obj, None if proc.returncode == 0 else f"{' '.join(cmd)}\n{out}")
    return done


def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    out_dir = _out_dir()
    lib_path = os.path.join(out_dir, "libjcf_kernels.so")
    if not os.path.exists(lib_path):
        os.makedirs(out_dir, exist_ok=True)
        tag = f"tmp{os.getpid()}"
        names = sorted(f for f in os.listdir(CSRC) if f.endswith(".cu"))
        done = _compile_all(out_dir, names, tag)
        failed = [err for _, err in done.values() if err]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = f"{lib_path}.{tag}"
        objs = [done[name][0] for name in names]
        _run([nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp, *objs])
        for obj in objs:
            os.remove(obj)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def gxx() -> str:
    found = shutil.which("g++") or shutil.which("c++")
    if not found:
        raise RuntimeError("g++ not found; the JPEG entropy decoder cannot be built")
    return found


def load_entropy() -> ctypes.CDLL:
    """Build (once per source hash, with g++) and load the host JPEG
    entropy decoder (``csrc/jpeg_entropy.cpp``)."""
    global _entropy_lib
    with _entropy_lock:
        if _entropy_lib is not None:
            return _entropy_lib
        src = os.path.join(CSRC, ENTROPY_SRC)
        out_dir = _hashed_dir([src], GXX_FLAGS)
        lib_path = os.path.join(out_dir, "libjcf_jpeg_entropy.so")
        if not os.path.exists(lib_path):
            os.makedirs(out_dir, exist_ok=True)
            tmp = f"{lib_path}.tmp{os.getpid()}"
            _run([gxx(), *GXX_FLAGS, "-o", tmp, src])
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(lib_path)
        for name, (argtypes, restype) in ENTROPY_SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _entropy_lib = lib
        return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
