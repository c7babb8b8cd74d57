"""Times K1 (the view kernel) and the int8 towers' LayerNorm + quant row
kernel, for an A/B of two checkouts on one NVIDIA GPU.

    python3 jcf_tpu_torch/scripts/ab_views.py [ROOT]   # the card
    python3 jcf_tpu_torch/scripts/ab_views.py --device cpu --batch 2 --rows 64 --rounds 1 --reps 1

``ROOT`` (default: the checkout holding this script) is the checkout
whose ``jcf_tpu_torch`` is timed; run the script as a file, so that the
package is imported from there. To compare two builds, unpack the other
commit (``git archive``) under the git-ignored ``build/`` and run both on
the same card in turns: A, B, B, A.

Seeded inputs, through the wrappers each caller uses:
- ``ops.view_kernel.fused_views_nchw`` at the serving cell (``--batch``
  images of 256², default 1024, x 8 views into 224²): int8 pixels, bf16
  and f32 views in the NCHW layout; the int8 pixels as ViT-B/32's patch
  rows (``patch=32``, where the checkout has the option) beside the NCHW
  kernel followed by the engine's former im2col copy (``_patchify`` and
  ``.contiguous()``); the same int8 lines at the 288² cell (a quarter of
  the batch, 329² sources: rows of 658 bytes);
- ``ops.block_kernel``'s LN + quant instances: ``ln_quant`` (static),
  ``ln_quant_rows`` (dynamic) and ``ln_affine_quant_rows`` on bf16 rows
  of the vision tower (``--rows`` x 768, default 409,600: 8192 crops x
  50), and on f32 rows of the f32 text tower (39,424 x 512: 512 prompts x
  77) the three f32 instances.
Each prints the median, min and max ms per launch over ``--rounds``
rounds of ``--reps`` launches (CUDA events; on the CPU the host clock,
where the wrappers run their plain versions) and the SHA-256 of the
output's bytes (``ab_gemm.py``'s ``report``; of the first output where a
wrapper returns two).
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
VIEWS, SRC, RES, PATCH = 8, 256, 224, 32
SRC_288, RES_288 = 329, 288
VISION_E, TEXT_ROWS, TEXT_E = 768, 512 * 77, 512


def _ab_gemm():
    """This checkout's ``ab_gemm.py`` (its ``import_package`` and
    ``report``), loaded by path before any ``jcf_tpu_torch`` is imported."""
    spec = importlib.util.spec_from_file_location("_ab_gemm", os.path.join(HERE, "ab_gemm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(root: str = ROOT, device="cuda", batch: int = 1024, rows: int = 409600, rounds: int = 7,
        reps: int = 10) -> dict:
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
        res[label] = ab.report(label, lambda: first(launch()), device, rounds, reps)

    view_rows(timed, device, batch, SRC, RES, float_modes=True)
    view_rows(timed, device, max(1, batch // 4), SRC_288, RES_288, float_modes=False)
    ln_quant_rows(timed, device, rows)
    return res


def first(out):
    return out[0] if isinstance(out, tuple) else out


def view_rows(timed, device, batch: int, src: int, res: int, float_modes: bool) -> None:
    """K1 at ``batch`` images of ``src``² x 8 views into ``res``²."""
    import torch

    from jcf_tpu_torch.models.clip import _patchify
    from jcf_tpu_torch.ops import view_kernel as vk

    gen = torch.Generator(device=device).manual_seed(src)
    img = torch.rand(batch, 3, src, src, device=device, generator=gen)
    geo = vk.sample_view_centers(gen, batch, VIEWS, (src, src), res)
    img_bf = img.bfloat16()
    tag = f"{batch} x {VIEWS} views of {src}² into {res}²"
    timed(f"view int8 NCHW, {tag}", lambda: vk.fused_views_nchw(img_bf, *geo, res, quantize=True))

    def nchw_and_copy():
        views = vk.fused_views_nchw(img_bf, *geo, res, quantize=True)
        return _patchify(views.reshape(-1, 3, res, res), PATCH).reshape(
            -1, 3 * PATCH * PATCH).contiguous()

    timed(f"view int8 NCHW + im2col copy (p {PATCH}), {tag}", nchw_and_copy)
    try:
        vk.fused_views_nchw(img_bf[:1], *(t[:1] for t in geo), res, quantize=True, patch=PATCH)
    except TypeError:
        print(f"view int8 patch rows (p {PATCH}), {tag}: not in this checkout", flush=True)
    else:
        timed(f"view int8 patch rows (p {PATCH}), {tag}",
              lambda: vk.fused_views_nchw(img_bf, *geo, res, quantize=True, patch=PATCH))
    if float_modes:
        timed(f"view bf16 NCHW, {tag}", lambda: vk.fused_views_nchw(img_bf, *geo, res))
        del img_bf
        timed(f"view f32 NCHW, {tag}", lambda: vk.fused_views_nchw(img, *geo, res))


def ln_quant_rows(timed, device, rows: int) -> None:
    """The LN + quant instances on seeded rows."""
    import torch

    from jcf_tpu_torch.ops import block_kernel as bk

    gen = torch.Generator(device=device).manual_seed(1)
    inv = torch.tensor([[127.0 / 4.5]], device=device)
    for dtype, m, e in ((torch.bfloat16, rows, VISION_E), (torch.float32, TEXT_ROWS, TEXT_E)):
        x = torch.randn(m, e, device=device, generator=gen).to(dtype)
        g = 1 + 0.1 * torch.randn(e, device=device, generator=gen)
        b = 0.1 * torch.randn(e, device=device, generator=gen)
        tag = f"{'bf16' if dtype == torch.bfloat16 else 'f32'}, {m} x {e}"
        timed(f"ln_quant (static) {tag}", lambda: bk.ln_quant(x, inv))
        timed(f"ln_quant_rows (dynamic) {tag}", lambda: bk.ln_quant_rows(x))
        timed(f"ln_affine_quant_rows {tag}", lambda: bk.ln_affine_quant_rows(x, g, b))
        del x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=ROOT, help="checkout whose package is timed")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=1024, help="serving images (x 8 views)")
    ap.add_argument("--rows", type=int, default=409600, help="bf16 vision rows (x 768)")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    run(args.root, args.device, args.batch, args.rows, args.rounds, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
