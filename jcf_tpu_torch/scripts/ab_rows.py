"""Times the float towers' LayerNorm row kernel and probe P2's regroup
kernels, for an A/B of two checkouts on one NVIDIA GPU.

    python3 jcf_tpu_torch/scripts/ab_rows.py [ROOT]   # the card
    python3 jcf_tpu_torch/scripts/ab_rows.py --device cpu --crops 2 --prompts 1 --planes 2 --rounds 1 --reps 1

``ROOT`` (default: the checkout holding this script) is the checkout
whose ``jcf_tpu_torch`` is timed; run the script as a file, so that the
package is imported from there. To compare two builds, unpack the other
commit (``git archive``) under the git-ignored ``build/`` and run both on
the same card in turns: A, B, B, A.

Seeded inputs, through the wrappers each caller uses:
- ``ops.block_kernel.ln_affine`` (rows, scale and bias in one dtype) at
  the four shapes the port runs it: bf16 at the classifier build's text
  width (``--prompts`` P x 77 rows of 512, default 512 prompts) and the
  parity engine's vision width (``--crops`` N x 50 rows of 768, default
  8192 crops), f32 at the f32 engine's vision width and the f32 text
  tower's; each beside ``F.layer_norm`` on the same inputs (the library
  call, the same in both checkouts);
- ``scripts.exp_patch_regroup.patch_regroup`` A, B and C on ``--planes``
  planes of 224² (default 512) in f32 and int8, beside the plain copy.
Each prints the median, min and max ms per launch over ``--rounds``
rounds of ``--reps`` launches (CUDA events; on the CPU the host clock,
where the wrappers run their plain versions) and the SHA-256 of the
output's bytes (``ab_gemm.py``'s ``report``).
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
TEXT_E, VISION_E, TEXT_S, VISION_S = 512, 768, 77, 50


def _ab_gemm():
    """This checkout's ``ab_gemm.py`` (its ``import_package`` and
    ``report``), loaded by path before any ``jcf_tpu_torch`` is imported."""
    spec = importlib.util.spec_from_file_location("_ab_gemm", os.path.join(HERE, "ab_gemm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(root: str = ROOT, device="cuda", crops: int = 8192, prompts: int = 512,
        planes: int = 512, rounds: int = 7, reps: int = 10) -> dict:
    """Times every line of the list above from ``root``'s package ->
    {label: median ms}."""
    ab = _ab_gemm()
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    package = ab.import_package(root)
    from jcf_tpu_torch.scripts.common import card_line

    print(card_line(device), flush=True)
    print(f"package: {package}", flush=True)

    res = {}

    def timed(label, launch):
        res[label] = ab.report(label, launch, device, rounds, reps)

    ln_rows(timed, device, crops, prompts)
    regroup_rows(timed, device, planes)
    return res


def ln_rows(timed, device, crops: int, prompts: int) -> None:
    """``ln_affine`` and ``F.layer_norm`` at the four shapes."""
    import torch
    import torch.nn.functional as F

    from jcf_tpu_torch.ops import block_kernel as bk

    gen = torch.Generator(device=device).manual_seed(0)
    shapes = (("bf16", torch.bfloat16, "text", TEXT_S * prompts, TEXT_E),
              ("bf16", torch.bfloat16, "vision", VISION_S * crops, VISION_E),
              ("f32", torch.float32, "vision", VISION_S * crops, VISION_E),
              ("f32", torch.float32, "text", TEXT_S * prompts, TEXT_E))
    for tag, dtype, tower, rows, e in shapes:
        x = torch.randn(rows, e, device=device, generator=gen).to(dtype)
        scale = (1 + 0.1 * torch.randn(e, device=device, generator=gen)).to(dtype)
        bias = (0.1 * torch.randn(e, device=device, generator=gen)).to(dtype)
        timed(f"ln_affine {tag} {tower}, {rows} x {e}", lambda: bk.ln_affine(x, scale, bias))
        timed(f"F.layer_norm {tag} {tower}, {rows} x {e}",
              lambda: F.layer_norm(x, (e,), scale, bias, 1e-5))
        del x


def regroup_rows(timed, device, planes: int) -> None:
    """P2's three strategies and the plain copy in f32 and int8."""
    from jcf_tpu_torch.scripts import exp_patch_regroup as p2

    for tag, dtype in p2.DTYPES.items():
        x = p2.planes(planes, dtype, device)
        for s in p2.STRATEGIES:
            timed(f"patch_regroup_{s} {tag}, {planes} planes of {p2.SIDE}²",
                  lambda: p2.patch_regroup(x, s))
        timed(f"plain copy {tag}, {planes} planes of {p2.SIDE}²",
              lambda: p2.patch_regroup_plain(x))
        del x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=ROOT, help="checkout whose package is timed")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--crops", type=int, default=8192, help="ViT-B/32 crops (x 50 rows)")
    ap.add_argument("--prompts", type=int, default=512, help="text prompts (x 77 rows)")
    ap.add_argument("--planes", type=int, default=512, help="P2's 224² planes")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    run(args.root, args.device, args.crops, args.prompts, args.planes, args.rounds, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
