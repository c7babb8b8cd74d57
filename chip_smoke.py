#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``jcf_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

1. prints the card (``nvidia-smi`` name and power limit), the torch, CUDA
   and nvcc versions, and what the host offers for JPEG decode (libjpeg,
   g++, nvJPEG);
2. builds every CUDA kernel from ``jcf_tpu_torch/csrc``;
3. holds each serving kernel (K1-K5) against its plain PyTorch version on
   the card and times both, at B' = 1024 crops and at the serving path's
   own shapes (b1024 x 8 views = 8192 crops, the numbers reported);
4. holds each text-tower kernel (K6a, K6b) against its plain version on
   one batch of 512 prompts x 77 tokens at ViT-B/32 text widths, and the
   composed halves and the 12-layer tower;
5. builds the zero-shot classifier the way ``jcf-ood`` does
   (``synthesize_templates`` from a 403-line ``classes.txt``, then
   ``build_text_weights``: 403 x 8 prompts), counting the kernels it
   launches, checks it against the plain-version tower, and checks that a
   second call hits the classifier cache;
6. drives ``TTAEngine.features_from_images`` at ViT-B/32 full width with
   seed-0 weights, images and classifier (as ``bench.py`` makes them),
   b1024 x 8 views, counting the kernels it launches;
7. certifies the int8 path against the port's plain f32 path on the same
   crop geometry (top-1 agreement >= 0.99, top-5 overlap >= 0.97, the gates
   of ``bench.py``), then serves once with the built classifier;
8. times the slice in images/s.

Every weight and input is made from seed 0. Exits nonzero, without the
final line, when no CUDA device is present or any phase fails. Before the
last line it prints the kernels JSON line (launches on the path, error
against the plain version, kernel / plain / library-call times and the
card's bound for the same work; the residual GEMMs at c_proj's shape,
their out-proj shape in the log) and the card's name and power limit. The
last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 1024  # images per serving batch, as bench.py
VIEWS = 8  # views per image, the center view included
ITERS = 10  # timed serving iterations
N_CLASSES = 403  # the reference's class count (DataConfig.num_classes)
TEXT_BATCH = 512  # prompts per text-tower call (encode_class_templates)

# published dense peaks of one H100 SXM at 700 W: memory bytes/s, int8
# ops/s, bf16 flop/s
PEAK_BYTES = 3.35e12
PEAK_INT8 = 1979e12
PEAK_BF16 = 989e12

# kernel -> (path, source, TPU kernel it replaces); the int8 patch-embed
# GEMM replaces an XLA convolution, not a Pallas kernel
KERNELS = {
    "view": ("serving", "jcf_tpu_torch/csrc/view.cu", "jcf_tpu/ops/view_kernel.py:60"),
    "int8_gemm_s32": ("serving", "jcf_tpu_torch/csrc/int8_gemm.cu", "jcf_tpu/infer/engine.py:593"),
    "assemble": ("serving", "jcf_tpu_torch/csrc/assemble.cu", "jcf_tpu/ops/assemble_kernel.py:44"),
    "ln_quant": ("serving", "jcf_tpu_torch/csrc/block.cu", "jcf_tpu/ops/block_kernel.py:565"),
    "int8_gemm_bf16": ("serving", "jcf_tpu_torch/csrc/int8_gemm.cu",
                       "jcf_tpu/ops/block_kernel.py:565"),
    "attention": ("serving", "jcf_tpu_torch/csrc/block.cu", "jcf_tpu/ops/block_kernel.py:322"),
    "int8_gemm_residual": ("serving", "jcf_tpu_torch/csrc/int8_gemm.cu",
                           "jcf_tpu/ops/block_kernel.py:643"),
    "int8_gemm_gelu_quant": ("serving", "jcf_tpu_torch/csrc/int8_gemm.cu",
                             "jcf_tpu/ops/block_kernel.py:643"),
    "cls_attention": ("serving", "jcf_tpu_torch/csrc/block.cu", "jcf_tpu/ops/block_kernel.py:1508"),
    "ln_affine": ("classifier", "jcf_tpu_torch/csrc/text_block.cu",
                  "jcf_tpu/ops/block_kernel.py:528"),
    "bf16_gemm_bias": ("classifier", "jcf_tpu_torch/csrc/bf16_gemm.cu",
                       "jcf_tpu/ops/block_kernel.py:528"),
    "causal_attention": ("classifier", "jcf_tpu_torch/csrc/text_block.cu",
                         "jcf_tpu/ops/block_kernel.py:464"),
    "bf16_gemm_residual": ("classifier", "jcf_tpu_torch/csrc/bf16_gemm.cu",
                           "jcf_tpu/ops/block_kernel.py:704"),
    "bf16_gemm_gelu": ("classifier", "jcf_tpu_torch/csrc/bf16_gemm.cu",
                       "jcf_tpu/ops/block_kernel.py:704"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cmd_output(cmd) -> str:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as exc:
        raise RuntimeError(f"{cmd[0]} failed: {exc}") from exc
    return proc.stdout.strip()


def decode_facts(nvcc_path: str) -> str:
    """What the host offers a JPEG decoder: libjpeg's header and library,
    a C++ compiler, and nvJPEG in the CUDA toolkit."""
    cuda_home = os.path.dirname(os.path.dirname(nvcc_path))
    include_dirs = ["/usr/include", "/usr/local/include", "/usr/include/x86_64-linux-gnu"]
    lib_dirs = ["/usr/lib", "/usr/lib64", "/usr/local/lib", "/usr/lib/x86_64-linux-gnu"]

    def any_file(dirs, names):
        return [os.path.join(d, n) for d in dirs for n in names if os.path.exists(os.path.join(d, n))]

    facts = {
        "jpeglib.h": any_file(include_dirs, ["jpeglib.h"]),
        "libjpeg": any_file(lib_dirs, ["libjpeg.so", "libjpeg.so.8", "libjpeg.so.62",
                                       "libjpeg.a", "libturbojpeg.so", "libturbojpeg.so.0"]),
        "g++": [p for p in [shutil.which("g++")] if p],
        "nvjpeg.h": any_file([os.path.join(cuda_home, "include"),
                              os.path.join(cuda_home, "targets", "x86_64-linux", "include")],
                             ["nvjpeg.h"]),
    }
    return "; ".join(f"{k}: {', '.join(v) if v else 'absent'}" for k, v in facts.items())


def time_ms(fn, reps: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, ops: float, peak_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak for their type."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, ops / peak_ops * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_int8(name, got, ref, max_frac):
    """int8 outputs: |diff| <= 1 everywhere, on at most ``max_frac`` of
    the elements (rounding ties of values that differ in the last f32 bit)."""
    d = (got.int() - ref.int()).abs()
    frac = float((d > 0).float().mean())
    ok = int(d.max()) <= 1 and frac <= max_frac
    log(f"  {name}: max |diff| {int(d.max())}, differing {frac:.2e} (tol: <= 1 on <= {max_frac})")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return float(d.max())


def check_bf16(name, got, ref):
    """bf16 outputs: within one bf16 ulp of the larger value, plus 1e-3 for
    values near zero (sums taken in another order move small outputs by
    more than their own ulp)."""
    g, r = got.float(), ref.float()
    d = (g - r).abs()
    bad = d > 2.0**-7 * g.abs().maximum(r.abs()) + 1e-3
    log(f"  {name}: max |diff| {float(d.max()):.3e}, over tolerance {int(bad.sum())} "
        f"(tol: 1 bf16 ulp + 1e-3)")
    if bool(bad.any()) or not bool(g.isfinite().all()):
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return float(d.max())


def cosine_rows(a, b):
    a, b = a.float(), b.float()
    return (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1) + 1e-12)


def check_composed(name, got, ref, kern, plain):
    """Composed kernels vs the same composition of plain versions: min row
    cos >= 0.999 and |diff| <= 0.05 + 0.05 |ref|; then both timed."""
    cos = float(cosine_rows(got, ref).min())
    close = bool(((got.float() - ref.float()).abs() <= 0.05 + 0.05 * ref.float().abs()).all())
    log(f"  {name}: min row cos {cos:.6f}, max |diff| {max_err(got, ref):.3e} "
        f"(tol: cos >= 0.999, |diff| <= 0.05 + 0.05 |ref|)")
    if cos < 0.999 or not close:
        raise AssertionError(f"{name}: kernels disagree with the plain composition")
    log(f"  {name}: kernels {time_ms(kern):.3f} ms, plain {time_ms(plain):.3f} ms")


class Phase:
    """Runs each kernel against its plain version and keeps, per kernel,
    its error, kernel / plain / library-call times and its bound."""

    def __init__(self):
        self.results = {}

    def run(self, name, kern, plain, check, work, library=None):
        out = kern()
        ref = plain()
        import torch

        torch.cuda.synchronize()
        r = {"max_abs_err": check(name, out, ref), "ms": time_ms(kern),
             "plain_ms": time_ms(plain), **work,
             "library_ms": time_ms(library) if library is not None else None}
        self.results[name] = r
        lib = "none" if library is None else f"{r['library_ms']:.3f} ms"
        log(f"  {name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, library {lib}, "
            f"bound {r['bound_ms']:.3f} ms ({r['bound_by']})")
        return out


def gemm_work(a, w, out_itemsize, peak, *extra):
    """The bound of a [M, K] x [N, K] product: operands and extra inputs
    read once, the [M, N] output written once."""
    m, k = a.shape
    n = w.shape[0]
    return bound(nbytes(a, w, *extra) + m * n * out_itemsize, 2.0 * m * n * k, peak)


def serving_kernel_phase(engine, images, geometry):
    """Each serving kernel against its plain version, stage by stage
    through layer 0 of the real weights (and K5 with the last layer's), at
    B' = images x views crops -> per-kernel results."""
    import torch

    from jcf_tpu_torch.models.clip import _patchify
    from jcf_tpu_torch.ops import assemble_kernel as ak
    from jcf_tpu_torch.ops import block_kernel as bk
    from jcf_tpu_torch.ops import int8_gemm as ig
    from jcf_tpu_torch.ops import view_kernel as vk
    from jcf_tpu_torch.ops.layers import layer_slice

    cfg = engine.cfg
    res, p, s, heads = cfg.image_resolution, cfg.vision_patch_size, cfg.vision_seq_len, cfg.vision_heads
    cy, cx, inv = geometry
    n_crops = cy.shape[0] * cy.shape[1]
    log(f"serving kernel checks at B' = {n_crops} crops")
    ph = Phase()

    views = ph.run("view",
                   lambda: vk.fused_views_nchw(images, cy, cx, inv, res),
                   lambda: vk.fused_views_nchw_plain(images, cy, cx, inv, res, quantize=True),
                   lambda n, a, b: check_int8(n, a, b, 5e-3),
                   bound(nbytes(images) + n_crops * 3 * res * res, 0.0, PEAK_INT8))
    cols = _patchify(views.reshape(n_crops, 3, res, res), p).reshape(-1, 3 * p * p).contiguous()
    k_q = engine._k_q
    acc = ph.run("int8_gemm_s32",
                 lambda: ig.int8_gemm_s32(cols, k_q),
                 lambda: ig.int8_matmul_plain(cols, k_q),
                 lambda n, a, b: check_int8(n, a, b, 0.0),
                 gemm_work(cols, k_q, 4, PEAK_INT8),
                 lambda: torch._int_mm(cols, k_q.T))
    g = cfg.grid_size
    asm_args = (acc.reshape(n_crops, g, g, -1), engine._k_scale, engine._k_bias,
                engine._pos_tail, engine._cls_row, engine._ln_pre["scale"], engine._ln_pre["bias"])
    rows = ph.run("assemble",
                  lambda: ak.assemble_dense_rows(*asm_args),
                  lambda: ak.assemble_dense_rows_plain(*asm_args),
                  check_bf16,
                  bound(nbytes(*asm_args) + n_crops * s * acc.shape[-1] * 2, 0.0, PEAK_BF16))
    layer = layer_slice(engine._quant, 0)
    attn, mlp = layer["attn"], layer["mlp"]
    x_q = ph.run("ln_quant",
                 lambda: bk.ln_quant(rows, attn["ln_inv"]),
                 lambda: bk.ln_quant_plain(rows, attn["ln_inv"]),
                 lambda n, a, b: check_int8(n, a, b, 1e-3),
                 bound(nbytes(rows) + rows.numel(), 0.0, PEAK_INT8))
    wq, wo = attn["w_qkv"], attn["w_out"]
    qkv = ph.run("int8_gemm_bf16",
                 lambda: ig.int8_gemm_bf16(x_q, wq.w_int8, wq.w_scale, wq.bias),
                 lambda: ig.dequant_plain(ig.int8_matmul_plain(x_q, wq.w_int8), wq.w_scale,
                                          wq.bias).to(torch.bfloat16),
                 check_bf16,
                 gemm_work(x_q, wq.w_int8, 2, PEAK_INT8, wq.w_scale, wq.bias),
                 lambda: torch._int_mm(x_q, wq.w_int8.T))
    d = qkv.shape[1] // 3 // heads
    ctx = ph.run("attention",
                 lambda: bk.attention(qkv, attn["ctx_inv"], s, heads),
                 lambda: bk.attention_plain(qkv, attn["ctx_inv"], s, heads),
                 lambda n, a, b: check_int8(n, a, b, 1e-2),
                 bound(nbytes(qkv) + x_q.numel(), 4.0 * n_crops * heads * s * s * d, PEAK_BF16))
    # out-proj: the residual epilogue at K = E (recorded beside c_proj's)
    mid = ph.run("int8_gemm_residual (out-proj)",
                 lambda: ig.int8_gemm_residual(ctx, wo.w_int8, wo.w_scale, wo.bias, rows),
                 lambda: (rows.float() + ig.dequant_plain(ig.int8_matmul_plain(ctx, wo.w_int8),
                                                          wo.w_scale, wo.bias)).to(torch.bfloat16),
                 check_bf16,
                 gemm_work(ctx, wo.w_int8, 2, PEAK_INT8, rows, wo.w_scale, wo.bias),
                 lambda: torch._int_mm(ctx, wo.w_int8.T))
    fc, pr = mlp["c_fc"], mlp["c_proj"]
    h_inv = mlp["h_inv"].reshape(())
    fc_sc, fc_b, gelu_c = fc.w_scale * h_inv, fc.bias * h_inv, bk.GELU_TANH_COEF / h_inv
    m_q = bk.ln_quant(mid, mlp["ln_inv"])
    h_q = ph.run("int8_gemm_gelu_quant",
                 lambda: ig.int8_gemm_gelu_quant(m_q, fc.w_int8, fc_sc, fc_b, gelu_c),
                 lambda: ig.gelu_quant_plain(
                     ig.dequant_plain(ig.int8_matmul_plain(m_q, fc.w_int8), fc_sc, fc_b), gelu_c),
                 lambda n, a, b: check_int8(n, a, b, 1e-3),
                 gemm_work(m_q, fc.w_int8, 1, PEAK_INT8, fc_sc, fc_b),
                 lambda: torch._int_mm(m_q, fc.w_int8.T))
    ph.run("int8_gemm_residual",
           lambda: ig.int8_gemm_residual(h_q, pr.w_int8, pr.w_scale, pr.bias, mid),
           lambda: (mid.float() + ig.dequant_plain(ig.int8_matmul_plain(h_q, pr.w_int8),
                                                   pr.w_scale, pr.bias)).to(torch.bfloat16),
           check_bf16,
           gemm_work(h_q, pr.w_int8, 2, PEAK_INT8, mid, pr.w_scale, pr.bias),
           lambda: torch._int_mm(h_q, pr.w_int8.T))

    # K5 with the last layer's weights: K/V on all rows, Q on the CLS rows
    last = layer_slice(engine._quant, cfg.vision_layers - 1)["attn"]
    e = rows.shape[1]
    lw = last["w_qkv"]
    lx_q = bk.ln_quant(rows, last["ln_inv"])
    kv = ig.int8_gemm_bf16(lx_q, lw.w_int8[e:], lw.w_scale[e:], lw.bias[e:])
    q = ig.int8_gemm_bf16(lx_q[::s].contiguous(), lw.w_int8[:e], lw.w_scale[:e], lw.bias[:e])
    ph.run("cls_attention",
           lambda: bk.cls_attention(q, kv, last["ctx_inv"], s, heads),
           lambda: bk.cls_attention_plain(q, kv, last["ctx_inv"], s, heads),
           lambda n, a, b: check_int8(n, a, b, 1e-2),
           bound(nbytes(q, kv) + q.numel(), 4.0 * n_crops * heads * s * d, PEAK_BF16))

    # the composed halves against the same halves built from plain versions
    def attn_half_plain(x):
        xq = bk.ln_quant_plain(x, attn["ln_inv"])
        t = ig.dequant_plain(ig.int8_matmul_plain(xq, wq.w_int8), wq.w_scale, wq.bias)
        c = bk.attention_plain(t.to(torch.bfloat16), attn["ctx_inv"], s, heads)
        y = ig.dequant_plain(ig.int8_matmul_plain(c, wo.w_int8), wo.w_scale, wo.bias)
        return (x.float() + y).to(torch.bfloat16)

    def mlp_half_plain(x):
        xq = bk.ln_quant_plain(x, mlp["ln_inv"])
        hq = ig.gelu_quant_plain(
            ig.dequant_plain(ig.int8_matmul_plain(xq, fc.w_int8), fc_sc, fc_b), gelu_c)
        y = ig.dequant_plain(ig.int8_matmul_plain(hq, pr.w_int8), pr.w_scale, pr.bias)
        return (x.float() + y).to(torch.bfloat16)

    def cls_half_plain(x):
        xq = bk.ln_quant_plain(x, last["ln_inv"])
        kv_ = ig.dequant_plain(ig.int8_matmul_plain(xq, lw.w_int8[e:]), lw.w_scale[e:], lw.bias[e:])
        q_ = ig.dequant_plain(ig.int8_matmul_plain(xq[::s], lw.w_int8[:e]), lw.w_scale[:e],
                              lw.bias[:e])
        c = bk.cls_attention_plain(q_.to(torch.bfloat16), kv_.to(torch.bfloat16),
                                   last["ctx_inv"], s, heads)
        wo_ = last["w_out"]
        y = ig.dequant_plain(ig.int8_matmul_plain(c, wo_.w_int8), wo_.w_scale, wo_.bias)
        return (x[::s].float() + y).to(torch.bfloat16)

    for name, kern, plain, x in (
            ("K3 attention half", lambda x: bk.attn_half_int8(x, attn, s, heads), attn_half_plain,
             rows),
            ("K4 MLP half", lambda x: bk.mlp_half_int8(x, mlp), mlp_half_plain, mid),
            ("K5 CLS attention half", lambda x: bk.attn_cls_int8(x, last, s, heads),
             cls_half_plain, rows)):
        check_composed(name, kern(x), plain(x), lambda: kern(x), lambda: plain(x))
    return ph.results


def text_tower_plain(x, blocks, n_heads, s):
    """The text tower composed from the plain versions (on the card)."""
    from jcf_tpu_torch.ops.layers import layer_slice

    for i in range(blocks["attn"]["w_qkv"].shape[0]):
        layer = layer_slice(blocks, i)
        x = text_half_plain(text_half_plain(x, layer, s, n_heads, "attn"), layer, s, n_heads, "mlp")
    return x


def encode_text_plain(text, cfg, ids):
    """``encode_text`` with the plain-version tower."""
    import torch

    from jcf_tpu_torch.ops.layers import layer_norm

    bf = torch.bfloat16
    b, s = ids.shape
    x = text["token_embedding"][ids].to(bf) + text["positional_embedding"].to(bf)
    x = text_tower_plain(x.reshape(b * s, -1), text["blocks"], cfg.text_heads, s).reshape(b, s, -1)
    x = x[torch.arange(b, device=x.device), ids.argmax(dim=-1)]
    x = layer_norm(x, text["ln_final"]["scale"], text["ln_final"]["bias"])
    return torch.matmul(x.float(), text["text_projection"].to(bf).float()).to(bf)


def text_kernel_phase(text, cfg, ids):
    """Each text-tower kernel against its plain version on one batch of
    prompts, stage by stage through layer 0; then the composed halves and
    the whole tower."""
    import torch
    import torch.nn.functional as F

    from jcf_tpu_torch.ops import bf16_gemm as bg
    from jcf_tpu_torch.ops import block_kernel as bk
    from jcf_tpu_torch.ops.layers import layer_slice

    bf = torch.bfloat16
    b, s = ids.shape
    heads = cfg.text_heads
    log(f"text kernel checks at {b} prompts x {s} tokens")
    ph = Phase()
    x = (text["token_embedding"][ids].to(bf) + text["positional_embedding"].to(bf)).reshape(b * s, -1)
    e = x.shape[1]
    layer = layer_slice(text["blocks"], 0)
    ln1 = (layer["ln_1"]["scale"].to(bf), layer["ln_1"]["bias"].to(bf))
    ln2 = (layer["ln_2"]["scale"].to(bf), layer["ln_2"]["bias"].to(bf))
    attn, mlp = layer["attn"], layer["mlp"]
    w_qkv, w_out = attn["w_qkv"].to(bf), attn["w_out"].to(bf)
    w_fc, w_pr = mlp["c_fc"]["w"].to(bf), mlp["c_proj"]["w"].to(bf)
    h = ph.run("ln_affine",
               lambda: bk.ln_affine(x, *ln1),
               lambda: bk.ln_affine_plain(x, *ln1),
               check_bf16,
               bound(2 * nbytes(x) + nbytes(*ln1), 0.0, PEAK_BF16),
               lambda: F.layer_norm(x, (e,), ln1[0], ln1[1], 1e-5))
    qkv = ph.run("bf16_gemm_bias",
                 lambda: bg.bf16_gemm_bias(h, w_qkv, attn["b_qkv"]),
                 lambda: (bg.matmul_plain(h, w_qkv) + attn["b_qkv"]).to(bf),
                 check_bf16,
                 gemm_work(h, w_qkv, 2, PEAK_BF16, attn["b_qkv"]),
                 lambda: torch.matmul(h, w_qkv.T))
    d = e // heads
    q, k, v = qkv.reshape(b, s, 3, heads, d).permute(2, 0, 3, 1, 4)
    ctx = ph.run("causal_attention",
                 lambda: bk.causal_attention(qkv, s, heads),
                 lambda: bk.causal_attention_plain(qkv, s, heads),
                 check_bf16,
                 # keys j <= i: s (s + 1) / 2 score and PV pairs per head
                 bound(nbytes(qkv) + nbytes(x), 4.0 * b * heads * (s * (s + 1) // 2) * d, PEAK_BF16),
                 lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    mid = ph.run("bf16_gemm_residual (out-proj)",
                 lambda: bg.bf16_gemm_residual(ctx, w_out, attn["b_out"], x),
                 lambda: (x.float() + (bg.matmul_plain(ctx, w_out) + attn["b_out"])).to(bf),
                 check_bf16,
                 gemm_work(ctx, w_out, 2, PEAK_BF16, x, attn["b_out"]),
                 lambda: torch.matmul(ctx, w_out.T))
    h2 = bk.ln_affine(mid, *ln2)
    hid = ph.run("bf16_gemm_gelu",
                 lambda: bg.bf16_gemm_gelu(h2, w_fc, mlp["c_fc"]["b"]),
                 lambda: bg.gelu_plain(bg.matmul_plain(h2, w_fc) + mlp["c_fc"]["b"]).to(bf),
                 check_bf16,
                 gemm_work(h2, w_fc, 2, PEAK_BF16, mlp["c_fc"]["b"]),
                 lambda: torch.matmul(h2, w_fc.T))
    ph.run("bf16_gemm_residual",
           lambda: bg.bf16_gemm_residual(hid, w_pr, mlp["c_proj"]["b"], mid),
           lambda: (mid.float() + (bg.matmul_plain(hid, w_pr) + mlp["c_proj"]["b"])).to(bf),
           check_bf16,
           gemm_work(hid, w_pr, 2, PEAK_BF16, mid, mlp["c_proj"]["b"]),
           lambda: torch.matmul(hid, w_pr.T))

    check_composed("K6a attention half", bk.attn_half(x, layer, s, heads),
                   text_half_plain(x, layer, s, heads, "attn"),
                   lambda: bk.attn_half(x, layer, s, heads),
                   lambda: text_half_plain(x, layer, s, heads, "attn"))
    check_composed("K6b MLP half", bk.mlp_half(mid, layer),
                   text_half_plain(mid, layer, s, heads, "mlp"),
                   lambda: bk.mlp_half(mid, layer),
                   lambda: text_half_plain(mid, layer, s, heads, "mlp"))
    check_composed(f"text tower ({cfg.text_layers} layers)",
                   bk.run_text_tower(x, text["blocks"], heads, s=s),
                   text_tower_plain(x, text["blocks"], heads, s),
                   lambda: bk.run_text_tower(x, text["blocks"], heads, s=s),
                   lambda: text_tower_plain(x, text["blocks"], heads, s))
    return ph.results


def text_half_plain(x, layer, s, n_heads, half):
    """One half of one text layer from the plain versions."""
    import torch

    from jcf_tpu_torch.ops import bf16_gemm as bg
    from jcf_tpu_torch.ops import block_kernel as bk

    bf = torch.bfloat16
    if half == "attn":
        ln, attn = layer["ln_1"], layer["attn"]
        h = bk.ln_affine_plain(x, ln["scale"].to(bf), ln["bias"].to(bf))
        qkv = (bg.matmul_plain(h, attn["w_qkv"].to(bf)) + attn["b_qkv"]).to(bf)
        ctx = bk.causal_attention_plain(qkv, s, n_heads)
        return (x.float() + (bg.matmul_plain(ctx, attn["w_out"].to(bf)) + attn["b_out"])).to(bf)
    ln, mlp = layer["ln_2"], layer["mlp"]
    h = bk.ln_affine_plain(x, ln["scale"].to(bf), ln["bias"].to(bf))
    hid = bg.gelu_plain(bg.matmul_plain(h, mlp["c_fc"]["w"].to(bf)) + mlp["c_fc"]["b"]).to(bf)
    return (x.float() + (bg.matmul_plain(hid, mlp["c_proj"]["w"].to(bf))
                         + mlp["c_proj"]["b"])).to(bf)


def synthetic_classes(path: str) -> None:
    """A 403-line ``classes.txt`` in the reference's "Domain_Class_name id"
    form, the names made from seed 0 (the real class list is not in the
    repository)."""
    rng = np.random.default_rng(0)
    domains = ["Animal", "Food", "Thing", "Caltech-101", "Thu-dog", "Stanford-Cars"]
    words = ["red", "giant", "small", "striped", "wild", "golden", "spotted", "panda", "eagle",
             "pie", "coupe", "terrier", "lamp", "chair", "boat", "shirt", "apple", "bridge"]
    with open(path, "w") as f:
        for i in range(N_CLASSES):
            name = "_".join(rng.choice(words, size=int(rng.integers(1, 4))))
            f.write(f"{domains[i % len(domains)]}_{name.capitalize()}_{i} {i}\n")


def classifier_phase(params, cfg, dev, counters):
    """The classifier build of every ``jcf-ood`` run: templates from a
    403-line class list, ``build_text_weights`` at 403 x 8 prompts with its
    kernels counted, checked against the plain-version tower, then a cache
    hit. -> (weights, launches, text kernel results)."""
    import torch

    from jcf_tpu_torch.config import DataConfig, PipelineConfig, RuntimeConfig
    from jcf_tpu_torch.models.clip import encode_text, tree_to
    from jcf_tpu_torch.ops.layers import l2_normalize
    from jcf_tpu_torch.pipelines.common import build_text_weights, ensure_templates
    from jcf_tpu_torch.tokenizer import tokenize

    text = tree_to(params["text"], dev)
    tparams = {"text": text}
    with tempfile.TemporaryDirectory() as tmp:
        synthetic_classes(os.path.join(tmp, "classes.txt"))
        pc = PipelineConfig(DataConfig(os.path.join(tmp, "classes.txt"), os.path.join(tmp, "tpl"), ""),
                            RuntimeConfig("bfloat16", os.path.join(tmp, "cache")))
        templates = ensure_templates(pc)
        n_t = len(templates[0])
        prompts = [p for c in sorted(templates) for p in templates[c]]
        log(f"classifier: {len(templates)} classes x {n_t} templates = {len(prompts)} prompts")
        ids = torch.from_numpy(tokenize(prompts[:TEXT_BATCH], truncate=True)).to(dev).long()
        text_results = text_kernel_phase(text, cfg, ids)

        torch.cuda.synchronize()
        for c in counters:
            c.update(dict.fromkeys(c, 0))
        t0 = time.perf_counter()
        built = build_text_weights(tparams, cfg, templates, pc, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        launches = {k: v for c in counters for k, v in c.items()}
        log(f"classifier built in {build_s:.2f} s (cache miss); launches: {launches}")
        t0 = time.perf_counter()
        hit = build_text_weights(tparams, cfg, templates, pc, device=dev)
        torch.cuda.synchronize()
        log(f"classifier cache hit in {time.perf_counter() - t0:.2f} s")
        if not torch.equal(hit, built):
            raise AssertionError("the cache hit returned other weights than the build")

    if tuple(built.shape) != (N_CLASSES, cfg.embed_dim) or not bool(built.float().isfinite().all()):
        raise AssertionError(f"bad classifier: shape {tuple(built.shape)}")
    norm_err = float((built.float().norm(dim=-1) - 1).abs().max())
    emb_k = l2_normalize(encode_text(tparams, cfg, ids, device=dev))
    emb_p = l2_normalize(encode_text_plain(text, cfg, ids))
    cos_emb = float(cosine_rows(emb_k, emb_p).min())
    n_c = TEXT_BATCH // n_t
    ref_w = l2_normalize(emb_p.float().reshape(n_c, n_t, -1).mean(dim=1))
    cos_w = float(cosine_rows(built[:n_c], ref_w).min())
    log(f"classifier: max |row norm - 1| {norm_err:.2e} (tol 1e-2); first {TEXT_BATCH} prompts "
        f"kernel vs plain tower min row cos {cos_emb:.6f}, classifier rows of their {n_c} "
        f"classes {cos_w:.6f} (tol 0.999)")
    if norm_err > 1e-2 or cos_emb < 0.999 or cos_w < 0.999:
        raise AssertionError("the built classifier disagrees with the plain-version tower")
    return built, launches, text_results


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from jcf_tpu_torch import _build
    from jcf_tpu_torch.infer.engine import TTAEngine
    from jcf_tpu_torch.models.clip import VIT_B_32, init_clip_params
    from jcf_tpu_torch.ops import assemble_kernel, bf16_gemm, block_kernel, int8_gemm, view_kernel

    counters = [m.LAUNCHES for m in (view_kernel, int8_gemm, assemble_kernel, block_kernel,
                                     bf16_gemm)]

    # every f32 reference and the calibration use full f32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = cmd_output(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    smi = smi.splitlines()[0]
    log(f"card: {smi}")
    nvcc_v = cmd_output([_build.nvcc(), "--version"]).splitlines()[-1]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc: {nvcc_v}")
    log(f"decode on this host: {decode_facts(_build.nvcc())}")

    t0 = time.perf_counter()
    _build.load()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")

    cfg = VIT_B_32
    n_random = VIEWS - 1
    t0 = time.perf_counter()
    params = init_clip_params(0, cfg)
    rng = np.random.default_rng(0)
    images_np = rng.random((BATCH, 3, 256, 256)).astype(np.float32)
    text = rng.standard_normal((N_CLASSES, cfg.embed_dim)).astype(np.float32)
    text = torch.from_numpy(text / np.linalg.norm(text, axis=-1, keepdims=True)).to(dev)
    images = torch.from_numpy(images_np).to(dev, torch.bfloat16)
    engine = TTAEngine(params, cfg, device=dev, n_views=n_random, calibration_images=images_np)
    torch.cuda.synchronize()
    log(f"engine built (weights, calibration, quantization) in {time.perf_counter() - t0:.1f} s")

    geometry = engine.sample_geometry(torch.Generator(device=dev).manual_seed(0),
                                      BATCH, images.shape[2:])
    n_small = 1024 // VIEWS
    serving_kernel_phase(engine, images[:n_small], tuple(t[:n_small] for t in geometry))
    results = serving_kernel_phase(engine, images, geometry)

    built, launches_cls, text_results = classifier_phase(params, cfg, dev, counters)
    results.update(text_results)

    # the serving path, counted
    torch.cuda.synchronize()
    for c in counters:
        c.update(dict.fromkeys(c, 0))
    modes = engine.features_from_images(images, text, geometry=geometry)
    torch.cuda.synchronize()
    launches_srv = {k: v for c in counters for k, v in c.items()}
    log(f"serving path launches: {launches_srv}")
    launches = {"serving": launches_srv, "classifier": launches_cls}
    missing = [k for k, (path, _, _) in KERNELS.items() if launches[path].get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels of their path never launched: {missing}")
    norms = modes.norm(dim=-1)
    if tuple(modes.shape) != (BATCH, cfg.embed_dim) or not bool(modes.isfinite().all()):
        raise AssertionError(f"bad modes: shape {tuple(modes.shape)}")
    if float((norms - 1).abs().max()) > 1e-3:
        raise AssertionError("modes are not unit-norm")

    # int8 vs the plain f32 path on the same geometry (bench.py's cert)
    t0 = time.perf_counter()
    ref = TTAEngine(params, cfg, device=dev, n_views=n_random, quant=None)

    def f32_modes(classifier, chunk=128):
        return torch.cat([
            ref.features_from_images(images[i : i + chunk], classifier,
                                     geometry=tuple(t[i : i + chunk] for t in geometry))
            for i in range(0, BATCH, chunk)
        ])

    def agreement(modes_q, modes_f, classifier):
        top5_q = engine.logits(modes_q, classifier.float()).topk(5, dim=-1).indices
        top5_f = ref.logits(modes_f, classifier.float()).topk(5, dim=-1).indices
        top1 = float((top5_q[:, 0] == top5_f[:, 0]).float().mean())
        overlap = float((top5_q[:, :, None] == top5_f[:, None, :]).any(-1).float().mean())
        return top1, overlap, float(cosine_rows(modes_q, modes_f).mean())

    top1, overlap, cos = agreement(modes, f32_modes(text), text)
    log(f"cert int8 vs f32 ({time.perf_counter() - t0:.1f} s): top1_agree {top1:.4f} "
        f"top5_overlap {overlap:.4f} mode_cos {cos:.6f} (gates: >= 0.99, >= 0.97)")
    if top1 < 0.99 or overlap < 0.97:
        raise AssertionError("int8 path fails the ranking certificate")

    # one pass with the built classifier: finite unit-norm modes; the
    # agreement is printed, not gated (random-init text features may be
    # near-collinear)
    modes_b = engine.features_from_images(images, built, geometry=geometry)
    if not bool(modes_b.isfinite().all()) or float((modes_b.norm(dim=-1) - 1).abs().max()) > 1e-3:
        raise AssertionError("bad modes with the built classifier")
    top1_b, overlap_b, cos_b = agreement(modes_b, f32_modes(built), built)
    log(f"built classifier, int8 vs f32 (not gated): top1_agree {top1_b:.4f} "
        f"top5_overlap {overlap_b:.4f} mode_cos {cos_b:.6f}")

    # throughput: fresh geometry per iteration, sampled on the card
    gen = torch.Generator(device=dev).manual_seed(2)
    for _ in range(2):
        engine.features_from_images(images, text, generator=gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        out = engine.features_from_images(images, text, generator=gen)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    ips = BATCH * ITERS / elapsed
    log(f"slice throughput: {ips:.2f} img/s (b{BATCH} x {VIEWS} views, "
        f"{ITERS} iters, {elapsed / ITERS * 1e3:.2f} ms/iter) on {smi}")
    if not bool(out.isfinite().all()):
        raise AssertionError("non-finite modes in the timed run")

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[path][name], **results[name]}
        for name, (path, src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
