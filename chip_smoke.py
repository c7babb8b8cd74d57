#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``jcf_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

1. prints the card (``nvidia-smi`` name and power limit) and the torch,
   CUDA and nvcc versions;
2. builds every CUDA kernel of the serving slice from ``jcf_tpu_torch/csrc``;
3. holds each kernel against its plain PyTorch version on the card and
   times both, at B' = 1024 crops and at the serving path's own shapes
   (b1024 x 8 views = 8192 crops, the numbers the kernel table reports);
4. drives ``TTAEngine.features_from_images`` at ViT-B/32 full width with
   seed-0 weights, images and classifier (as ``bench.py`` makes them), b1024
   x 8 views, checks the modes and that every kernel of the path launched;
5. certifies the int8 path against the port's plain f32 path on the same
   crop geometry (top-1 agreement >= 0.99, top-5 overlap >= 0.97, the gates
   of ``bench.py``);
6. times the slice in images/s.

Exits nonzero, without the final line, when no CUDA device is present or
any phase fails. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 1024  # images per serving batch, as bench.py
VIEWS = 8  # views per image, the center view included
ITERS = 10  # timed serving iterations

# kernel -> (source, TPU kernel it replaces); the int8 patch-embed GEMM
# replaces an XLA convolution, not a Pallas kernel
KERNELS = {
    "view": ("jcf_tpu_torch/csrc/view.cu", "jcf_tpu/ops/view_kernel.py:60"),
    "int8_gemm_s32": ("jcf_tpu_torch/csrc/int8_gemm.cu", "jcf_tpu/infer/engine.py:593"),
    "assemble": ("jcf_tpu_torch/csrc/assemble.cu", "jcf_tpu/ops/assemble_kernel.py:44"),
    "ln_quant": ("jcf_tpu_torch/csrc/block.cu", "jcf_tpu/ops/block_kernel.py:565"),
    "int8_gemm_bf16": ("jcf_tpu_torch/csrc/int8_gemm.cu", "jcf_tpu/ops/block_kernel.py:565"),
    "attention": ("jcf_tpu_torch/csrc/block.cu", "jcf_tpu/ops/block_kernel.py:322"),
    "int8_gemm_residual": ("jcf_tpu_torch/csrc/int8_gemm.cu", "jcf_tpu/ops/block_kernel.py:643"),
    "int8_gemm_gelu_quant": ("jcf_tpu_torch/csrc/int8_gemm.cu", "jcf_tpu/ops/block_kernel.py:643"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cmd_output(cmd) -> str:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as exc:
        raise RuntimeError(f"{cmd[0]} failed: {exc}") from exc
    return proc.stdout.strip()


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
    values near zero (a LayerNorm's statistics summed in another order
    move its small outputs by more than their own ulp)."""
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


def kernel_phase(engine, images, geometry):
    """Each kernel against its plain version, stage by stage through layer
    0 of the real weights, at B' = images x views crops -> per-kernel
    {max_abs_err, ms, plain_ms}."""
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
    log(f"kernel checks at B' = {n_crops} crops")
    results = {}

    def run(name, kern, plain, check):
        out = kern()
        ref = plain()
        torch.cuda.synchronize()
        err = check(name, out, ref)
        results[name] = {"max_abs_err": err, "ms": time_ms(kern), "plain_ms": time_ms(plain)}
        log(f"  {name}: kernel {results[name]['ms']:.3f} ms, plain {results[name]['plain_ms']:.3f} ms")
        return out

    views = run("view",
                lambda: vk.fused_views_nchw(images, cy, cx, inv, res),
                lambda: vk.fused_views_nchw_plain(images, cy, cx, inv, res, quantize=True),
                lambda n, a, b: check_int8(n, a, b, 5e-3))
    cols = _patchify(views.reshape(n_crops, 3, res, res), p).reshape(-1, 3 * p * p).contiguous()
    acc = run("int8_gemm_s32",
              lambda: ig.int8_gemm_s32(cols, engine._k_q),
              lambda: ig.int8_matmul_plain(cols, engine._k_q),
              lambda n, a, b: check_int8(n, a, b, 0.0))
    g = cfg.grid_size
    asm_args = (acc.reshape(n_crops, g, g, -1), engine._k_scale, engine._k_bias,
                engine._pos_tail, engine._cls_row, engine._ln_pre["scale"], engine._ln_pre["bias"])
    rows = run("assemble",
               lambda: ak.assemble_dense_rows(*asm_args),
               lambda: ak.assemble_dense_rows_plain(*asm_args),
               check_bf16)
    layer = layer_slice(engine._quant, 0)
    attn, mlp = layer["attn"], layer["mlp"]
    x_q = run("ln_quant",
              lambda: bk.ln_quant(rows, attn["ln_inv"]),
              lambda: bk.ln_quant_plain(rows, attn["ln_inv"]),
              lambda n, a, b: check_int8(n, a, b, 1e-3))
    wq, wo = attn["w_qkv"], attn["w_out"]
    qkv = run("int8_gemm_bf16",
              lambda: ig.int8_gemm_bf16(x_q, wq.w_int8, wq.w_scale, wq.bias),
              lambda: ig.dequant_plain(ig.int8_matmul_plain(x_q, wq.w_int8), wq.w_scale,
                                       wq.bias).to(torch.bfloat16),
              check_bf16)
    ctx = run("attention",
              lambda: bk.attention(qkv, attn["ctx_inv"], s, heads),
              lambda: bk.attention_plain(qkv, attn["ctx_inv"], s, heads),
              lambda n, a, b: check_int8(n, a, b, 1e-2))
    mid = ig.int8_gemm_residual(ctx, wo.w_int8, wo.w_scale, wo.bias, rows)
    fc, pr = mlp["c_fc"], mlp["c_proj"]
    h_inv = mlp["h_inv"].reshape(())
    fc_sc, fc_b, gelu_c = fc.w_scale * h_inv, fc.bias * h_inv, bk.GELU_TANH_COEF / h_inv
    m_q = bk.ln_quant(mid, mlp["ln_inv"])
    h_q = run("int8_gemm_gelu_quant",
              lambda: ig.int8_gemm_gelu_quant(m_q, fc.w_int8, fc_sc, fc_b, gelu_c),
              lambda: ig.gelu_quant_plain(
                  ig.dequant_plain(ig.int8_matmul_plain(m_q, fc.w_int8), fc_sc, fc_b), gelu_c),
              lambda n, a, b: check_int8(n, a, b, 1e-3))
    run("int8_gemm_residual",
        lambda: ig.int8_gemm_residual(h_q, pr.w_int8, pr.w_scale, pr.bias, mid),
        lambda: (mid.float() + ig.dequant_plain(ig.int8_matmul_plain(h_q, pr.w_int8),
                                                pr.w_scale, pr.bias)).to(torch.bfloat16),
        check_bf16)

    # the composed halves against the same halves built from plain versions
    def attn_half_plain(x):
        xq = bk.ln_quant_plain(x, attn["ln_inv"])
        q = ig.dequant_plain(ig.int8_matmul_plain(xq, wq.w_int8), wq.w_scale, wq.bias)
        c = bk.attention_plain(q.to(torch.bfloat16), attn["ctx_inv"], s, heads)
        y = ig.dequant_plain(ig.int8_matmul_plain(c, wo.w_int8), wo.w_scale, wo.bias)
        return (x.float() + y).to(torch.bfloat16)

    def mlp_half_plain(x):
        xq = bk.ln_quant_plain(x, mlp["ln_inv"])
        hq = ig.gelu_quant_plain(
            ig.dequant_plain(ig.int8_matmul_plain(xq, fc.w_int8), fc_sc, fc_b), gelu_c)
        y = ig.dequant_plain(ig.int8_matmul_plain(hq, pr.w_int8), pr.w_scale, pr.bias)
        return (x.float() + y).to(torch.bfloat16)

    for name, kern, plain, x in (("K3 attention half", bk.attn_half_int8, attn_half_plain, rows),
                                 ("K4 MLP half", bk.mlp_half_int8, mlp_half_plain, mid)):
        args = (attn, s, heads) if kern is bk.attn_half_int8 else (mlp,)
        got, ref = kern(x, *args), plain(x)
        cos = float(cosine_rows(got, ref).min())
        err = max_err(got, ref)
        log(f"  {name}: min row cos {cos:.6f}, max |diff| {err:.3e} "
            f"(tol: cos >= 0.999, |diff| <= 0.05 + 0.05 |ref|)")
        close = bool(((got.float() - ref.float()).abs() <= 0.05 + 0.05 * ref.float().abs()).all())
        if cos < 0.999 or not close:
            raise AssertionError(f"{name}: kernels disagree with the plain composition")
        ms = time_ms(lambda: kern(x, *args))
        plain_ms = time_ms(lambda: plain(x))
        log(f"  {name}: kernels {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return results


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from jcf_tpu_torch import _build
    from jcf_tpu_torch.infer.engine import TTAEngine
    from jcf_tpu_torch.models.clip import VIT_B_32, init_clip_params
    from jcf_tpu_torch.ops import assemble_kernel, block_kernel, int8_gemm, view_kernel

    counters = [m.LAUNCHES for m in (view_kernel, int8_gemm, assemble_kernel, block_kernel)]

    # every f32 reference and the calibration use full f32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = cmd_output(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    smi = smi.splitlines()[0]
    log(f"card: {smi}")
    nvcc_v = cmd_output([_build.nvcc(), "--version"]).splitlines()[-1]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc: {nvcc_v}")

    t0 = time.perf_counter()
    _build.load()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")

    cfg = VIT_B_32
    n_random = VIEWS - 1
    t0 = time.perf_counter()
    params = init_clip_params(0, cfg)
    rng = np.random.default_rng(0)
    images_np = rng.random((BATCH, 3, 256, 256)).astype(np.float32)
    text = rng.standard_normal((403, cfg.embed_dim)).astype(np.float32)
    text = torch.from_numpy(text / np.linalg.norm(text, axis=-1, keepdims=True)).to(dev)
    images = torch.from_numpy(images_np).to(dev, torch.bfloat16)
    engine = TTAEngine(params, cfg, device=dev, n_views=n_random, calibration_images=images_np)
    torch.cuda.synchronize()
    log(f"engine built (weights, calibration, quantization) in {time.perf_counter() - t0:.1f} s")

    geometry = engine.sample_geometry(torch.Generator(device=dev).manual_seed(0),
                                      BATCH, images.shape[2:])
    n_small = 1024 // VIEWS
    kernel_phase(engine, images[:n_small], tuple(t[:n_small] for t in geometry))
    results = kernel_phase(engine, images, geometry)

    # the serving path, counted
    torch.cuda.synchronize()
    for c in counters:
        c.update(dict.fromkeys(c, 0))
    modes = engine.features_from_images(images, text, geometry=geometry)
    torch.cuda.synchronize()
    launches = {k: v for c in counters for k, v in c.items()}
    log(f"serving path launches: {launches}")
    missing = [k for k in KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels of the path never launched: {missing}")
    norms = modes.norm(dim=-1)
    if tuple(modes.shape) != (BATCH, cfg.embed_dim) or not bool(modes.isfinite().all()):
        raise AssertionError(f"bad modes: shape {tuple(modes.shape)}")
    if float((norms - 1).abs().max()) > 1e-3:
        raise AssertionError("modes are not unit-norm")

    # int8 vs the plain f32 path on the same geometry (bench.py's cert)
    t0 = time.perf_counter()
    ref = TTAEngine(params, cfg, device=dev, n_views=n_random, quant=None)
    chunk = 128
    modes_f = torch.cat([
        ref.features_from_images(images[i : i + chunk], text,
                                 geometry=tuple(t[i : i + chunk] for t in geometry))
        for i in range(0, BATCH, chunk)
    ])
    logits_q = engine.logits(modes, text)
    logits_f = ref.logits(modes_f, text)
    top5_q = logits_q.topk(5, dim=-1).indices
    top5_f = logits_f.topk(5, dim=-1).indices
    top1 = float((top5_q[:, 0] == top5_f[:, 0]).float().mean())
    overlap = float((top5_q[:, :, None] == top5_f[:, None, :]).any(-1).float().mean())
    cos = float(cosine_rows(modes, modes_f).mean())
    log(f"cert int8 vs f32 ({time.perf_counter() - t0:.1f} s): top1_agree {top1:.4f} "
        f"top5_overlap {overlap:.4f} mode_cos {cos:.6f} (gates: >= 0.99, >= 0.97)")
    if top1 < 0.99 or overlap < 0.97:
        raise AssertionError("int8 path fails the ranking certificate")

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
         "launches": launches[name], **results[name]}
        for name, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
