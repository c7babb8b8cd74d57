"""Times the int8 whole-layer kernels K9a (``block_int8``), K9d
(``layer_fused_int8``) and K9c (``stream_tower_int8``) at the rows
PERF.md reports them at, beside the halves on the same rows, for an A/B
of two checkouts on one NVIDIA GPU.

    python3 jcf_tpu_torch/scripts/ab_k9.py [ROOT]   # the card
    python3 jcf_tpu_torch/scripts/ab_k9.py --device cpu --scale 4096 --rounds 1 --reps 1

``ROOT`` (default: the checkout holding this script) is the checkout
whose ``jcf_tpu_torch`` is timed; run the script as a file, so that the
package is imported from there. To compare two builds, unpack the other
commit (``git archive``) under the git-ignored ``build/`` and run both on
the same card in turns: A, B, B, A.

Trees: the seed-0 ViT-B/32 vision tower (12 layers, width 768, 12 heads,
hidden 3072), folded in the modes "full", "ln", "hidden", "full+score"
from one fixed calibration table (``profile_k9.py``'s amax columns),
folded dynamic (no calibration), and unfolded (its LN affines from the
float blocks). Rows (crops x tokens; ``--scale`` divides the crops):
"full", "ln", "hidden", "full+score" and "unfolded" at 8192 x 50 (b1024
x 8 views), "dynamic" at 4104 x 54 (jcf-predict's prompted tower: 8
images x 513 crops, 4 prompt tokens), "82 tokens" ("full") at 2048 x 82
(288²); seeded normal bf16 rows. Each row times, as medians of
``--rounds`` rounds of ``--reps`` launches (CUDA events; on the CPU the
host clock, where the wrappers run their plain versions), eager and, on
the card, captured in one CUDA graph:
- K9a and K9d on layer 0, with their launches and their distance from
  their plain versions;
- the halves (K3 + K4) on layer 0, at ``_MLP_NSPLIT`` = 1 and, beside
  K9d, at 4 (``_LAYER_NSPLIT``, K9d's chunk count);
- K9c on all 12 layers (rows "full", "dynamic", "unfolded"), with its
  launches and its cosine to its plain version.
Then K9a's branches off the dense route, each beside the halves on its
route: the text tower's masked layer (512 prompts x 77 tokens, causal,
width 512, the unfolded tree, dynamic) on f32 and on bf16 rows, the
3-head tower (width 192, 1024 x 50, unfolded) and the 64-token tower
(width 128, 1024 x 64, the non-dense route, unfolded). Each output's
SHA-256 is printed (equal bits across checkouts show an unchanged
result), and each row's bound: the products' int8 operations at 1979
TOP/s and the attention's at the bf16 peak, against the bytes at 3.35
TB/s.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
# one H100 SXM (NVIDIA's data sheet, dense, 700 W)
PEAK_BYTES, PEAK_INT8, PEAK_BF16 = 3.35e12, 1979e12, 989e12
HEADS, LAYERS = 12, 12
# vision_ln_z_amax's columns: LN1 and LN2 z-norm, context, hidden, score
# amax and the weakest row's score max (profile_k9.py's table)
AMAX = (6.0, 6.0, 3.0, 4.0, 45.0, 2.0)
# (row, tree, crops, tokens, K9c too)
ROWS = (("full", "full", 8192, 50, True), ("dynamic", "dynamic", 4104, 54, True),
        ("unfolded", "unfolded", 8192, 50, True), ("ln", "ln", 8192, 50, False),
        ("hidden", "hidden", 8192, 50, False), ("full+score", "full+score", 8192, 50, False),
        ("82 tokens", "full", 2048, 82, False))
# K9a off the dense route, on the unfolded tree: (row, tower, width,
# sequences, tokens, causal, rows' dtype name)
BRANCH_ROWS = (("masked f32", "text", 512, 512, 77, True, "float32"),
               ("masked bf16", "text", 512, 512, 77, True, "bfloat16"),
               ("masked 3 heads", "visual", 192, 1024, 50, False, "bfloat16"),
               ("nondense", "visual", 128, 1024, 64, False, "bfloat16"))
STATIC = {"full": ("ctx", "hidden"), "ln": (), "hidden": ("hidden",),
          "full+score": ("ctx", "hidden", "score")}


def _load(name: str):
    """This checkout's script ``name``.py, loaded by path before any
    ``jcf_tpu_torch`` is imported."""
    spec = importlib.util.spec_from_file_location(f"_{name}", os.path.join(HERE, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bound_ms(rows: int, s: int, e: int, hidden: int, layers: int, w_bytes: int):
    """(bound ms, what bounds it) of ``layers`` int8 layers on ``rows``
    rows: the products' E (4E + 2 hidden) multiply-adds a row at the int8
    peak and QK^T and PV at the bf16 peak, against the rows read and
    written once and every layer's weights read once."""
    t_ops = layers * (2.0 * rows * e * (4 * e + 2 * hidden) / PEAK_INT8
                      + 4.0 * rows * s * e / PEAK_BF16) * 1e3
    t_bytes = (2 * rows * e * 2 + w_bytes) / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations"


def run(root: str = ROOT, device="cuda", scale: int = 1, rounds: int = 7, reps: int = 10,
        rows=None) -> dict:
    """Times the rows above (``rows``: their names, default all) from
    ``root``'s package -> {label: median ms}."""
    ab = _load("ab_gemm")
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    package = ab.import_package(root)
    from jcf_tpu_torch import _build
    from jcf_tpu_torch.models.clip import CLIPConfig, init_clip_params, tree_to
    from jcf_tpu_torch.ops import block_kernel as bk
    from jcf_tpu_torch.ops.layers import layer_slice
    from jcf_tpu_torch.ops.quant import quantize_clip_params
    from jcf_tpu_torch.scripts.common import card_line

    if device.type == "cuda":
        _build.load()
    print(card_line(device), flush=True)
    print(f"package: {package}", flush=True)
    cfg = CLIPConfig(vision_layers=LAYERS, text_layers=1)
    params = tree_to(init_clip_params(0, cfg), device)
    heads = {"visual": HEADS, "text": cfg.text_heads}
    amax = torch.tensor([AMAX] * LAYERS, device=device)
    blocks = params["visual"]["blocks"]
    res = {}

    def timed(label, launch):
        res[label] = ab.report(label, launch, device, rounds, reps)
        if device.type == "cuda":
            try:
                res[label + " (graph)"] = ab.graph_ms(label, launch, device, rounds, reps)
            except RuntimeError as err:  # a capture the call refuses
                print(f"{label}: in a CUDA graph not measured ({str(err).splitlines()[0]})",
                      flush=True)

    def counted(name, fn):
        before = bk.LAUNCHES[name]
        out = fn()
        return out, bk.LAUNCHES[name] - before

    for row, mode, crops, s, stream in ROWS:
        if rows and row not in rows:
            continue
        crops = max(1, crops // scale)
        if mode == "unfolded":
            tree = quantize_clip_params(params)["visual"]
        elif mode == "dynamic":
            tree = quantize_clip_params(params, fold=True, heads=heads)["visual"]
        else:
            tree = quantize_clip_params(params, fold=True, heads=heads,
                                        act_scales={"visual": amax},
                                        act_static=STATIC[mode])["visual"]
        unfolded = mode == "unfolded"
        dt = torch.bfloat16
        lns0 = (tuple({k: blocks[n][k][0].to(dt) for k in ("scale", "bias")}
                      for n in ("ln_1", "ln_2")) if unfolded else (None, None))
        lns = (tuple({k: blocks[n][k].to(dt) for k in ("scale", "bias")} for n in ("ln_1", "ln_2"))
               if unfolded else (None, None))
        layer = layer_slice(tree, 0)
        e = cfg.vision_width
        hidden = layer["mlp"]["c_fc"].w_int8.shape[0]
        x = torch.randn(crops * s, e, device=device,
                        generator=torch.Generator(device=device).manual_seed(1)).to(dt)
        w_bytes = sum(t.numel() * t.element_size() for q in (
            layer["attn"]["w_qkv"], layer["attn"]["w_out"], layer["mlp"]["c_fc"],
            layer["mlp"]["c_proj"]) for t in q)
        label = f"{row}, {crops} x {s}"
        b, by = bound_ms(crops * s, s, e, hidden, 1, w_bytes)
        print(f"{label}: bound {b:.4f} ms a layer ({by})", flush=True)
        for name in ("block_int8", "layer_fused_int8"):
            kern, plain = getattr(bk, name), getattr(bk, f"{name}_plain")
            got, n = counted(name, lambda: kern(x, layer, s, HEADS, lns=lns0))
            ref = plain(x, layer, s, HEADS, lns=lns0)
            d = (got.float() - ref.float()).abs()
            cos = float(torch.nn.functional.cosine_similarity(got.float(), ref.float()).min())
            print(f"{name} {label}: launches {n}, vs plain max |diff| {float(d.max()):.3e}, "
                  f"min row cos {cos:.6f}", flush=True)
            del got, ref, d
            timed(f"{name} {label}", lambda: kern(x, layer, s, HEADS, lns=lns0))
        timed(f"halves {label}", lambda: bk._halves_int8(x, layer, s, HEADS, lns0))
        saved = bk._MLP_NSPLIT
        bk._MLP_NSPLIT = bk._LAYER_NSPLIT
        try:
            timed(f"halves nsp {bk._LAYER_NSPLIT} {label}",
                  lambda: bk._halves_int8(x, layer, s, HEADS, lns0))
        finally:
            bk._MLP_NSPLIT = saved
        if stream:
            b, by = bound_ms(crops * s, s, e, hidden, LAYERS, LAYERS * w_bytes)
            print(f"{label}: {LAYERS} layers' bound {b:.4f} ms ({by})", flush=True)
            got, n = counted("stream_tower_int8",
                             lambda: bk.stream_tower_int8(x, tree, HEADS, s=s, lns=lns))
            ref = bk.stream_tower_int8_plain(x, tree, HEADS, s=s, lns=lns)
            cos = float(torch.nn.functional.cosine_similarity(got.float(), ref.float()).min())
            print(f"stream_tower_int8 {label}: launches {n}, vs plain min row cos {cos:.6f}",
                  flush=True)
            del got, ref
            timed(f"stream_tower_int8 {LAYERS} layers {label}",
                  lambda: bk.stream_tower_int8(x, tree, HEADS, s=s, lns=lns))
        del x, tree, layer
        if device.type == "cuda":
            torch.cuda.empty_cache()

    for row, tower, width, seqs, s, causal, dt_name in BRANCH_ROWS:
        if rows and row not in rows:
            continue
        dt = getattr(torch, dt_name)
        seqs = max(1, seqs // scale)
        kw = ({"text_width": width, "text_heads": width // 64} if tower == "text"
              else {"vision_width": width})
        bcfg = CLIPConfig(vision_layers=1, text_layers=1, **kw)
        bparams = tree_to(init_clip_params(0, bcfg), device)
        bblocks = bparams[tower]["blocks"]
        layer = layer_slice(quantize_clip_params(bparams)[tower], 0)
        lns0 = tuple({k: bblocks[n][k][0].to(dt) for k in ("scale", "bias")}
                     for n in ("ln_1", "ln_2"))
        heads = width // 64
        dense = not causal and heads % 2 == 0 and s % 16 != 0
        hidden = layer["mlp"]["c_fc"].w_int8.shape[0]
        x = torch.randn(seqs * s, width, device=device,
                        generator=torch.Generator(device=device).manual_seed(2)).to(dt)
        w_bytes = sum(t.numel() * t.element_size() for q in (
            layer["attn"]["w_qkv"], layer["attn"]["w_out"], layer["mlp"]["c_fc"],
            layer["mlp"]["c_proj"]) for t in q)
        label = f"{row}, {seqs} x {s}"
        b, by = bound_ms(seqs * s, s, width, hidden, 1, w_bytes)
        print(f"{label}: bound {b:.4f} ms a layer ({by})", flush=True)
        kw = dict(lns=lns0, causal=causal, dense=dense)
        got, n = counted("block_int8", lambda: bk.block_int8(x, layer, s, heads, **kw))
        ref = bk.block_int8_plain(x, layer, s, heads, **kw)
        d = (got.float() - ref.float()).abs()
        cos = float(torch.nn.functional.cosine_similarity(got.float(), ref.float()).min())
        print(f"block_int8 {label}: launches {n}, vs plain max |diff| {float(d.max()):.3e}, "
              f"min row cos {cos:.6f}", flush=True)
        del got, ref, d
        timed(f"block_int8 {label}", lambda: bk.block_int8(x, layer, s, heads, **kw))
        timed(f"halves {label}", lambda: bk._halves_int8(x, layer, s, heads, lns0, causal=causal,
                                                         dense=dense))
        del x, layer, bparams
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=ROOT, help="checkout whose package is timed")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=int, default=1, help="divides every crop count")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rows", nargs="*", help="the rows to time (default: all)")
    args = ap.parse_args(argv)
    run(args.root, args.device, args.scale, args.rounds, args.reps, args.rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
