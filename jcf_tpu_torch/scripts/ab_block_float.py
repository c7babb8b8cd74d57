"""Times K9b, the float whole-layer kernel (``block_bf16``, ``block_f32``),
at the four shapes its paths run, beside the halves and one PyTorch layer
on the same rows, for an A/B of two checkouts on one NVIDIA GPU.

    python3 jcf_tpu_torch/scripts/ab_block_float.py [ROOT]   # the card
    python3 jcf_tpu_torch/scripts/ab_block_float.py --device cpu --scale 256 --rounds 1 --reps 1

``ROOT`` (default: the checkout holding this script) is the checkout
whose ``jcf_tpu_torch`` is timed; run the script as a file, so that the
package is imported from there. To compare two builds, unpack the other
commit (``git archive``) under the git-ignored ``build/`` and run both on
the same card in turns: A, B, B, A.

Shapes (sequences x tokens x width, hidden 4 x width): the bf16 parity
engine's vision tower under ``_FUSE = "block"`` (8192 x 50 x 768, a zero
bias), the classifier build's text tower (512 x 77 x 512, causal), and
the same two in f32 at ``jcf-ood``'s default (4104 x 50 x 768 and 512 x
77 x 512); ``--scale`` divides the sequence counts. Seeded normal rows
and one layer of seeded weights (std 0.02, qkv 0.05; LN affines 1 +/-
0.1 and biases nonzero); in f32 the layer carries its weights' TF32
planes where the checkout splits them once a tree (``with_tf32_planes``,
before the timing), and a checkout without it splits them in each call. For each shape, medians of ``--rounds`` rounds
of ``--reps`` launches (CUDA events; on the CPU the host clock, where the
wrappers run their plain versions), eager and, on the card, captured in
one CUDA graph, of:
- K9b, with its launches, its output's SHA-256 and its distance from the
  plain version;
- the halves (K6a + K6b, seven launches);
- the yardstick, one PyTorch call: ``torch.nn.TransformerEncoderLayer(
  norm_first=True, batch_first=True, dropout=0, activation=QuickGELU)`` in
  eval, loaded with the layer's weights, the bias as ``src_mask``, in the
  rows' dtype (f32 with TF32 off). Its roundings differ from K9b's: it is
  a yardstick of speed, not of the numbers.
Each shape also prints its bound: the products at the bf16 peak (989
TFLOP/s) or, in f32, as three TF32 products at 495 TFLOP/s (the f32 FMA
bound at 67 beside it), and the attention at the same peaks, against the
bytes at 3.35 TB/s.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
# one H100 SXM (NVIDIA's data sheet, dense, 700 W)
PEAK_BYTES, PEAK_BF16, PEAK_TF32, PEAK_F32 = 3.35e12, 989e12, 495e12, 67e12
# (label, dtype name, sequences, tokens, width, causal)
SHAPES = (("bf16 vision", "bfloat16", 8192, 50, 768, False),
          ("bf16 text", "bfloat16", 512, 77, 512, True),
          ("f32 vision", "float32", 4104, 50, 768, False),
          ("f32 text", "float32", 512, 77, 512, True))


def _load(name: str):
    """This checkout's script ``name``.py, loaded by path before any
    ``jcf_tpu_torch`` is imported."""
    spec = importlib.util.spec_from_file_location(f"_{name}", os.path.join(HERE, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def seeded_layer(e: int, hidden: int, device, seed: int = 0) -> dict:
    """One float block of seeded f32 weights (the JAX layout: [out, in])."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)

    def n(*shape, std=0.02):
        return torch.randn(*shape, device=device, generator=g) * std

    return {"ln_1": {"scale": 1 + n(e, std=0.1), "bias": n(e, std=0.1)},
            "ln_2": {"scale": 1 + n(e, std=0.1), "bias": n(e, std=0.1)},
            "attn": {"w_qkv": n(3 * e, e, std=0.05), "b_qkv": n(3 * e), "w_out": n(e, e),
                     "b_out": n(e)},
            "mlp": {"c_fc": {"w": n(hidden, e), "b": n(hidden)},
                    "c_proj": {"w": n(e, hidden), "b": n(e)}}}


def with_planes(layer: dict) -> dict:
    """The f32 layer as a tree made for serving holds it: with its weights'
    TF32 planes, where the imported checkout has ``with_tf32_planes``."""
    from jcf_tpu_torch.ops import f32_gemm as fg
    from jcf_tpu_torch.ops.layers import layer_slice

    if not hasattr(fg, "with_tf32_planes"):
        return layer

    def stack(tree):
        return {k: stack(v) for k, v in tree.items()} if isinstance(tree, dict) else tree[None]

    return layer_slice(fg.with_tf32_planes(stack(layer)), 0)


def yardstick(layer: dict, e: int, heads: int, dtype, device):
    """``torch.nn.TransformerEncoderLayer`` holding the block's weights,
    in eval, in ``dtype``."""
    import torch

    hidden = layer["mlp"]["c_fc"]["w"].shape[0]
    mod = torch.nn.TransformerEncoderLayer(e, heads, hidden, dropout=0.0,
                                           activation=lambda h: h * torch.sigmoid(1.702 * h),
                                           layer_norm_eps=1e-5, batch_first=True, norm_first=True)
    with torch.no_grad():
        mod.norm1.weight.copy_(layer["ln_1"]["scale"])
        mod.norm1.bias.copy_(layer["ln_1"]["bias"])
        mod.norm2.weight.copy_(layer["ln_2"]["scale"])
        mod.norm2.bias.copy_(layer["ln_2"]["bias"])
        mod.self_attn.in_proj_weight.copy_(layer["attn"]["w_qkv"])
        mod.self_attn.in_proj_bias.copy_(layer["attn"]["b_qkv"])
        mod.self_attn.out_proj.weight.copy_(layer["attn"]["w_out"])
        mod.self_attn.out_proj.bias.copy_(layer["attn"]["b_out"])
        mod.linear1.weight.copy_(layer["mlp"]["c_fc"]["w"])
        mod.linear1.bias.copy_(layer["mlp"]["c_fc"]["b"])
        mod.linear2.weight.copy_(layer["mlp"]["c_proj"]["w"])
        mod.linear2.bias.copy_(layer["mlp"]["c_proj"]["b"])
    return mod.to(device=device, dtype=dtype).eval()


def bound_ms(rows: int, s: int, e: int, hidden: int, heads: int, causal: bool, f32: bool):
    """(bound ms, what bounds it, the f32 FMA bound ms or None)."""
    pairs = rows // s * (s * (s + 1) // 2 if causal else s * s)
    products = 2.0 * rows * e * (4 * e + 2 * hidden)
    attn = 4.0 * heads * pairs * (e // heads)
    t = 4 if f32 else 2
    n_bytes = 2 * rows * e * t + t * e * (4 * e + 2 * hidden) + 4 * (5 * e + hidden + s * s)
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    if f32:
        t_ops = (3 * products / PEAK_TF32 + attn / PEAK_F32) * 1e3
        fma = max(t_bytes, (products + attn) / PEAK_F32 * 1e3)
    else:
        t_ops, fma = (products + attn) / PEAK_BF16 * 1e3, None
    return max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations", fma


def run(root: str = ROOT, device="cuda", scale: int = 1, rounds: int = 7,
        reps: int = 10) -> dict:
    """Times every shape above from ``root``'s package -> {label: median ms}."""
    ab = _load("ab_gemm")
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    package = ab.import_package(root)
    from jcf_tpu_torch import _build
    from jcf_tpu_torch.ops import block_kernel as bk
    from jcf_tpu_torch.ops.attention import causal_mask
    from jcf_tpu_torch.scripts.common import card_line

    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        _build.load()
    print(card_line(device), flush=True)
    print(f"package: {package}", flush=True)
    res = {}

    def timed(label, launch):
        res[label] = ab.report(label, launch, device, rounds, reps)
        if device.type == "cuda":
            try:
                res[label + " (graph)"] = ab.graph_ms(label, launch, device, rounds, reps)
            except RuntimeError as err:  # a capture the call refuses
                print(f"{label}: in a CUDA graph not measured ({str(err).splitlines()[0]})",
                      flush=True)

    for tag, dname, n_seq, s, e, causal in SHAPES:
        dt = getattr(torch, dname)
        n_seq = max(1, n_seq // scale)
        heads, hidden, rows = e // 64, 4 * e, n_seq * s
        layer = seeded_layer(e, hidden, device)
        if dt == torch.float32:
            layer = with_planes(layer)
        x = torch.randn(rows, e, device=device,
                        generator=torch.Generator(device=device).manual_seed(1)).to(dt)
        bias = (causal_mask(s, device) if causal
                else torch.zeros((s, s), dtype=torch.float32, device=device))
        label = f"{tag}, {n_seq} x {s} x {e}"
        b, by, fma = bound_ms(rows, s, e, hidden, heads, causal, dt == torch.float32)
        print(f"{label}: bound {b:.4f} ms ({by})"
              + (f", f32 FMA bound {fma:.4f} ms" if fma is not None else ""), flush=True)
        kern = bk.block_bf16 if dt == torch.bfloat16 else bk.block_f32
        plain = bk.block_bf16_plain if dt == torch.bfloat16 else bk.block_f32_plain
        name = kern.__name__
        ref = plain(x, layer, s, heads, bias).float()
        lab = f"{name} {label}"
        before = bk.LAUNCHES[name]
        got = kern(x, layer, s, heads, bias).float()
        d = (got - ref).abs()
        cos = float(torch.nn.functional.cosine_similarity(got, ref).min())
        print(f"{lab}: launches {bk.LAUNCHES[name] - before}, vs plain max |diff| "
              f"{float(d.max()):.3e}, over 1e-5 + 1e-5 |ref| "
              f"{int((d > 1e-5 + 1e-5 * ref.abs()).sum())}, min row cos {cos:.7f}", flush=True)
        del got, d
        timed(lab, lambda: kern(x, layer, s, heads, bias))
        timed(f"halves {label}",
              lambda: bk.mlp_half(bk.attn_half(x, layer, s, heads, causal=causal), layer))
        mod = yardstick(layer, e, heads, dt, device)
        xs = x.reshape(n_seq, s, e)
        with torch.no_grad():
            timed(f"yardstick TransformerEncoderLayer {label}",
                  lambda: mod(xs, src_mask=bias))
        del layer, x, ref, mod, xs
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=ROOT, help="checkout whose package is timed")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=int, default=1, help="divides every sequence count")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    run(args.root, args.device, args.scale, args.rounds, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
