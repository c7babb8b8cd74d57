"""Build and load the package's CUDA kernels; count their launches.

``csrc/*.cu`` compile at first use with ``nvcc`` for ``sm_90a``, one
process per source started together, and link into one shared library
with a plain C interface, loaded with ``ctypes``; ``csrc/jpeg.cu`` (the
nvJPEG decoder) compiles in the same pass and links into a second
library with ``-lnvjpeg`` (``load_jpeg``), so that a toolkit without
nvJPEG fails the decoder alone, naming where it looked for ``nvjpeg.h``. Each C entry launches
on the stream it is given and returns ``cudaGetLastError()``; ``check``
raises if that is not 0. The library
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
              "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry -> argument types (pointers and the stream as c_void_p)
SIGNATURES = {
    "jcf_view": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "jcf_assemble": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "jcf_ln_quant": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "jcf_quant_rows": [_P, _P, _P, _I, _I, _I, _P],
    "jcf_int8_gemm": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "jcf_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _F, _I, _P],
    "jcf_cls_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P],
    "jcf_bf16_gemm": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "jcf_f32_gemm": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "jcf_ln_affine": [_P, _P, _P, _P, _I, _I, _I, _P],
    "jcf_masked_attention": [_P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P],
    "jcf_pair_attention": [_P, _P, _I, _I, _I, _I, _F, _F, _I, _P],
    "jcf_packed_attention": [_P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    "jcf_packed_attention_bwd": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    "jcf_blocked_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, *[ctypes.c_longlong] * 6,
                              _F, _I, _P],
    "jcf_block_int8": [*[_P] * 20, *[_I] * 7, _P],
    "jcf_layer_fused_int8": [*[_P] * 20, *[_I] * 7, _P],
    "jcf_stream_tower_int8": [*[_P] * 20, *[_I] * 7, _P],
    "jcf_block_bf16": [*[_P] * 17, _I, _I, _I, _I, _F, _P],
    "jcf_block_bf16_scratch": [_I, _I, _I],
    "jcf_block_f32": [*[_P] * 16, _I, _I, _I, _I, _F, _P],
    "jcf_block_f32_scratch": [_I, _I, _I],
}
# C entries that return something other than a cudaError_t
RESTYPES = {"jcf_block_bf16_scratch": ctypes.c_longlong, "jcf_block_f32_scratch": ctypes.c_longlong}
# the decoder library's entries (csrc/jpeg.cu): nvjpegStatus_t codes, and a
# cudaError_t for the resize
JPEG_SRC = "jpeg.cu"
JPEG_SIGNATURES = {
    "jcf_jpeg_create": [_P],
    "jcf_jpeg_state_create": [_P, _P],
    "jcf_jpeg_state_destroy": [_P],
    "jcf_jpeg_info": [_P, _P, ctypes.c_longlong, _P],
    "jcf_jpeg_decode": [_P, _P, _P, ctypes.c_longlong, _I, _I, _P, _P],
    "jcf_resize_crop": [_P, _I, _I, _I, _I, _I, _P, _P, _P],
}

_lib = None
_jpeg_lib = None
_jpeg_error = None  # why the decoder library did not build in load()'s pass


def cuda_home() -> str:
    return os.environ.get("CUDA_HOME") or "/usr/local/cuda"


def nvjpeg_include_dirs() -> list:
    """Where the toolkit keeps ``nvjpeg.h``."""
    home = cuda_home()
    return [os.path.join(home, "include"), os.path.join(home, "targets", "x86_64-linux", "include")]


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
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")


def _out_dir() -> str:
    """The build directory of these sources and flags."""
    srcs = sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + f.read())
    return os.path.join(os.path.dirname(_PKG), "build", "jcf_tpu_torch", h.hexdigest()[:16])


def _jpeg_link(obj: str, lib_path: str, tag: str) -> None:
    home = cuda_home()
    libdirs = [os.path.join(home, "lib64"), os.path.join(home, "targets", "x86_64-linux", "lib")]
    flags = [f for d in libdirs if os.path.isdir(d)
             for f in ("-L", d, "-Xlinker", "-rpath", "-Xlinker", d)]
    tmp = f"{lib_path}.{tag}"
    _run([nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp, obj, *flags, "-lnvjpeg"])
    os.replace(tmp, lib_path)


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
    """Build (once per source hash) and load the kernel library; the
    decoder library is built in the same nvcc pass where ``nvjpeg.h``
    exists (``load_jpeg`` loads it)."""
    global _lib, _jpeg_error
    if _lib is not None:
        return _lib
    out_dir = _out_dir()
    lib_path = os.path.join(out_dir, "libjcf_kernels.so")
    if not os.path.exists(lib_path):
        os.makedirs(out_dir, exist_ok=True)
        tag = f"tmp{os.getpid()}"
        names = sorted(f for f in os.listdir(CSRC) if f.endswith(".cu") and f != JPEG_SRC)
        with_jpeg = any(os.path.exists(os.path.join(d, "nvjpeg.h")) for d in nvjpeg_include_dirs())
        done = _compile_all(out_dir, names + ([JPEG_SRC] if with_jpeg else []), tag)
        failed = [err for name, (_, err) in done.items() if err and name != JPEG_SRC]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = f"{lib_path}.{tag}"
        objs = [done[name][0] for name in names]
        _run([nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp, *objs])
        for obj in objs:
            os.remove(obj)
        os.replace(tmp, lib_path)
        if with_jpeg:
            obj, err = done[JPEG_SRC]
            try:
                if err:
                    raise RuntimeError(f"nvcc failed:\n{err}")
                _jpeg_link(obj, os.path.join(out_dir, "libjcf_jpeg.so"), tag)
            except RuntimeError as exc:
                _jpeg_error = str(exc)
            finally:
                if os.path.exists(obj):
                    os.remove(obj)
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = RESTYPES.get(name, ctypes.c_int)
    _lib = lib
    return lib


def load_jpeg() -> ctypes.CDLL:
    """The nvJPEG decoder library (``csrc/jpeg.cu``), built beside the
    kernels. Raises, naming the directories searched, where the toolkit
    has no ``nvjpeg.h``, and with nvcc's output where it did not build."""
    global _jpeg_lib
    if _jpeg_lib is not None:
        return _jpeg_lib
    load()
    out_dir = _out_dir()
    lib_path = os.path.join(out_dir, "libjcf_jpeg.so")
    if not os.path.exists(lib_path):
        dirs = nvjpeg_include_dirs()
        if not any(os.path.exists(os.path.join(d, "nvjpeg.h")) for d in dirs):
            raise RuntimeError(f"nvjpeg.h not found in {dirs}: the JPEG decoder cannot be built")
        if _jpeg_error:
            raise RuntimeError(f"the nvJPEG decoder did not build: {_jpeg_error}")
        # the kernel library was built by an earlier process; build the decoder alone
        tag = f"tmp{os.getpid()}"
        obj, err = _compile_all(out_dir, [JPEG_SRC], tag)[JPEG_SRC]
        if err:
            raise RuntimeError(f"the nvJPEG decoder did not build: {err}")
        try:
            _jpeg_link(obj, lib_path, tag)
        finally:
            os.remove(obj)
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in JPEG_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _jpeg_lib = lib
    return lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
