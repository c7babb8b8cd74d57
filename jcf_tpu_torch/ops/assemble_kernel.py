"""K2: fused vision-token assembly (``jcf_tpu/ops/assemble_kernel.py``).

Patch-embed int32 accumulators -> the flat ``[B' * S, E]`` bf16 row stream
the int8 tower consumes: per crop, the epilogue ``acc * col_scale +
col_bias`` in f32, a bf16 cast, ``+ pos[1:]`` in bf16, ln_pre with f32
statistics, bf16 rows; row 0 of each crop is the precomputed CLS row.
``assemble_dense_rows`` launches ``csrc/assemble.cu`` for CUDA tensors and
runs ``assemble_dense_rows_plain`` for CPU tensors.

K2 is written in CUDA, like the other kernels of the slice, rather than
Triton: it is one warp-per-row pass, and keeping it in the nvcc-built
library means a serving host needs no Triton JIT.
"""

from __future__ import annotations

import torch

from jcf_tpu_torch import _build
from jcf_tpu_torch.ops.layers import layer_norm

# launches of the assembly kernel (assemble_dense_rows on CUDA tensors)
LAUNCHES = {"assemble": 0}


def make_cls_row(class_embedding, pos_row0, ln_scale, ln_bias, *, dtype=torch.bfloat16):
    """ln_pre(cls + pos[0]) with the reference's cast points: one [E]
    vector shared by every crop."""
    y = class_embedding.to(dtype) + pos_row0.to(dtype)
    return layer_norm(y[None, :], ln_scale, ln_bias)[0]


def assemble_dense_rows_plain(conv_out, col_scale, col_bias, pos_tail, cls_row,
                              ln_scale, ln_bias, *, dtype=torch.bfloat16):
    """Plain version of K2: conv_out [B', gy, gx, E] -> [B' * (gy*gx+1), E]."""
    b, n_gy, n_gx, e = conv_out.shape
    t = conv_out.reshape(b, n_gy * n_gx, e).float() * col_scale.float() + col_bias.float()
    y = t.to(dtype) + pos_tail.to(dtype)
    rows = layer_norm(y, ln_scale, ln_bias).to(dtype)
    out = torch.cat([cls_row.to(dtype).expand(b, 1, e), rows], dim=1)
    return out.reshape(b * (n_gy * n_gx + 1), e)


def assemble_dense_rows(conv_out, col_scale, col_bias, pos_tail, cls_row,
                        ln_scale, ln_bias, *, dtype=torch.bfloat16):
    """K2 wrapper: the CUDA kernel for CUDA tensors (int32 accumulators,
    bf16 rows), the plain version for CPU tensors."""
    if not conv_out.is_cuda:
        return assemble_dense_rows_plain(conv_out, col_scale, col_bias, pos_tail, cls_row,
                                         ln_scale, ln_bias, dtype=dtype)
    b, n_gy, n_gx, e = conv_out.shape
    n_tok = n_gy * n_gx
    if conv_out.dtype != torch.int32 or dtype != torch.bfloat16:
        raise TypeError("assemble kernel takes int32 accumulators and emits bf16 rows")
    if e > 1024:
        raise ValueError(f"assemble kernel supports E <= 1024, got {e}")
    dev = conv_out.device

    def vec(t, dt, shape):
        t = t.to(device=dev, dtype=dt).contiguous()
        if tuple(t.shape) != shape:
            raise ValueError(f"expected shape {shape}, got {tuple(t.shape)}")
        return t

    args = (
        conv_out.contiguous(),
        vec(col_scale, torch.float32, (e,)), vec(col_bias, torch.float32, (e,)),
        vec(pos_tail, torch.bfloat16, (n_tok, e)), vec(cls_row, torch.bfloat16, (e,)),
        vec(ln_scale, torch.float32, (e,)), vec(ln_bias, torch.float32, (e,)),
    )
    out = torch.empty((b * (n_tok + 1), e), dtype=torch.bfloat16, device=dev)
    lib = _build.load()
    err = lib.jcf_assemble(*(t.data_ptr() for t in args), out.data_ptr(), b, n_tok, e,
                           _build.stream_ptr(dev))
    _build.check(err, "assemble")
    LAUNCHES["assemble"] += 1
    return out
