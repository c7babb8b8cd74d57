"""Times the JPEG decoder's kernels (``jpeg_idct``, ``jpeg_upsample_color``,
``resize_crop``) eager and in a CUDA graph, for an A/B of two checkouts on
one NVIDIA GPU.

    python3 jcf_tpu_torch/scripts/ab_jpeg.py [ROOT]   # the card
    python3 jcf_tpu_torch/scripts/ab_jpeg.py --device cpu --images 4 --rounds 1 --reps 1

``ROOT`` (default: the checkout holding this script) is the checkout
whose ``jcf_tpu_torch`` is timed; run the script as a file, so that the
package is imported from there. To compare two builds, unpack the other
commit (``git archive``) under the git-ignored ``build/`` and run both on
the same card in turns: A, B, B, A.

Two inputs from ``tests/fixtures/jpeg``: the largest fixture at full size
(the parity path's decode of one file), and a ``--perf`` decode_batch:
``--images`` (128) of the six fixtures in turn at libjpeg's scale for a
256 short side (``data.decode.native_scale``). For each, per decode call,
as the checkout's decode call launches it, on inputs already on the card:
- ``jpeg_idct``: every component of every image: one launch of the
  batched kernel where the checkout has ``idct_batch``, else one launch a
  component (``idct``);
- ``jpeg_upsample_color``: every image's planes to its pixels: one launch
  over a ``DecodePlan``'s table where the checkout has
  ``upsample_color_batch``, else one launch an image;
- ``resize_crop`` (the batch only): every image to 256²: one launch where
  the checkout has ``resize_crop_batch``, else one launch (of two
  kernels) an image;
- the whole ``decode_batch`` (the batch only; eager, the host's Huffman
  decoding included), timed at 256² and hashed at 256², 224² from 256 and
  288².
Each line prints the median, min and max ms per call over ``--rounds``
rounds of ``--reps`` calls (CUDA events; on the CPU the host clock, where
the wrappers run their plain versions), on the card the median of
``--reps`` calls captured in one CUDA graph (the device time without the
wrappers' host time), the launches a call, the bytes bound at 3.35 TB/s
(each input byte read once, each output byte written once; the resize's
input: the source rows and columns that the crop's windows reach) and the
SHA-256 of the output's bytes image by image, which two checkouts that
compute the same bits share.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import os
import statistics
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "jpeg")
PEAK_BYTES = 3.35e12  # one H100 SXM (NVIDIA's data sheet)
OUT = 256  # the --perf path's square sources


def _ab_gemm():
    spec = importlib.util.spec_from_file_location("_ab_gemm", os.path.join(HERE, "ab_gemm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sha(tensors) -> str:
    """SHA-256 of the tensors' bytes in turn (first 16 hex digits)."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().reshape(-1).numpy().tobytes())
    return h.hexdigest()[:16]


def eager_ms(call, device, rounds: int, reps: int) -> list:
    import torch

    times = []
    for _ in range(rounds):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                call()
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end) / reps)
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                call()
            times.append((time.perf_counter() - t0) / reps * 1e3)
    return times


def reached_bytes(dec, img) -> int:
    """The bytes of ``img`` (uint8 [H, W, C]) that an ``OUT``² crop of its
    resize to an ``OUT`` short side reads: the rows and columns of nonzero
    weight, as ``resize_crop_plain`` slices them."""
    sh, sw, ch = img.shape
    rw, rh, left, top = dec._geometry(sw, sh, OUT, OUT)
    spans = []
    for size, resized, first in ((sh, rh, top), (sw, rw, left)):
        hit = np.nonzero(dec._triangle_weights(size, resized, first, OUT).any(axis=0))[0]
        spans.append(int(hit[-1]) + 1 - int(hit[0]))
    return spans[0] * spans[1] * ch


def idct_call(jpeg, images, device):
    """(a decode call's IDCT launches on card-resident inputs, its output ->
    the planes in order) as the checkout runs them."""
    import torch

    if hasattr(jpeg, "idct_batch"):
        layout = jpeg.idct_layout(images)
        coefs = torch.cat([c.coefs for c, _ in images]).to(device)
        quant = torch.cat([c.quant for c, _ in images]).to(device)
        desc = torch.from_numpy(layout.desc).to(device)
        return (lambda: jpeg.idct_batch(coefs, quant, desc, layout),
                lambda out: [out[o:o + h * w].view(h, w) for mine in layout.planes
                             for o, h, w in mine])
    comps = [(c.coefs.to(device), c.quant.to(device), p.size)
             for coef, geo in images for c, p in zip(coef.components, geo)]
    return lambda: [jpeg.idct(c, q, size) for c, q, size in comps], lambda out: out


def run(root: str = ROOT, device="cuda", n_images: int = 128, rounds: int = 7,
        reps: int = 10) -> dict:
    """Times every line of the list above from ``root``'s package ->
    {label: median ms}."""
    ab = _ab_gemm()
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    package = ab.import_package(root)
    from jcf_tpu_torch.data import decode as dec
    from jcf_tpu_torch.data import jpeg
    from jcf_tpu_torch.scripts.common import card_line

    print(card_line(device), flush=True)
    print(f"package: {package}", flush=True)
    res = {}

    def timed(label, call, outputs, n_bytes):
        before = dict(jpeg.LAUNCHES)
        digest = sha(outputs(call()))
        launched = {k: v - before[k] for k, v in jpeg.LAUNCHES.items() if v != before[k]}
        times = eager_ms(call, device, rounds, reps)
        res[label] = med = statistics.median(times)
        print(f"{label}: median {med:.4f} ms per call, min {min(times):.4f}, max {max(times):.4f} "
              f"({rounds} x {reps}), launches {launched}, bound {n_bytes / PEAK_BYTES * 1e3:.4f} "
              f"ms (bytes), sha256 {digest}", flush=True)
        if device.type == "cuda":
            res[label + " (graph)"] = ab.graph_ms(label, call, device, rounds, reps)

    fixtures = sorted(os.path.join(FIXTURES, f) for f in os.listdir(FIXTURES) if f.endswith(".jpg"))
    largest = max(fixtures, key=os.path.getsize)
    inputs = {f"{os.path.basename(largest)} at full size": [(largest, 1)],
              f"decode_batch of {n_images}": [
                  (p, None) for p in (fixtures[i % len(fixtures)] for i in range(n_images))]}
    for name, files in inputs.items():
        images, sizes = [], []
        for path, scale in files:
            with open(path, "rb") as f:
                coef = jpeg.read_coefficients(f.read(), path)
            d = scale or dec.native_scale(coef.width, coef.height, OUT)
            out_w, out_h, geo = jpeg.geometry(coef, d, path)
            images.append((coef, geo))
            sizes.append((out_w, out_h))
        blocks = [(c.blocks_w * c.blocks_h, p.size) for coef, geo in images
                  for c, p in zip(coef.components, geo)]
        call, planes_of = idct_call(jpeg, images, device)
        timed(f"jpeg_idct, {name}: {len(blocks)} components, {sum(n for n, _ in blocks)} blocks",
              call, planes_of, sum(n * (128 + s * s) for n, s in blocks) + 256 * len(blocks))
        planes = planes_of(call())
        up_bytes = sum(p.width * p.height for _, geo in images for p in geo) + sum(
            w * h * len(coef.components) for (w, h), (coef, _) in zip(sizes, images))
        if hasattr(jpeg, "upsample_color_batch"):
            plan = jpeg.DecodePlan([(c, g, w, h) for (c, g), (w, h) in zip(images, sizes)],
                                   device)
            staged = plan.tables()
            packed = plan.idct.run(jpeg.stage(device, staged[:3]))
            up_d = torch.from_numpy(plan.up.desc).to(device)
            upsample = lambda: jpeg.upsample_color_batch(packed, up_d, plan.up, plan.rgb)  # noqa: E731
            pixels_of = plan.up.views
        else:
            per_image, at = [], 0
            for coef, _ in images:
                per_image.append(planes[at:at + len(coef.components)])
                at += len(coef.components)
            upsample = lambda: [jpeg.upsample_color(pl, geo, w, h, coef.ycc)  # noqa: E731
                                for pl, (coef, geo), (w, h) in zip(per_image, images, sizes)]
            pixels_of = lambda out: out  # noqa: E731
        timed(f"jpeg_upsample_color, {name}", upsample, pixels_of, up_bytes)
        if len(images) == 1:
            continue
        pixels = pixels_of(upsample())
        if hasattr(dec, "resize_crop_batch"):
            layout = dec.resize_layout(pixels, OUT, OUT)
            rs_d = torch.from_numpy(layout.desc).to(device)
            resize = lambda: dec.resize_crop_batch(pixels, OUT, OUT, layout=layout,  # noqa: E731
                                                   desc=rs_d)
        else:
            resize = lambda: [dec.resize_crop(img, OUT, OUT) for img in pixels]  # noqa: E731
        timed(f"resize_crop, {name} to {OUT}²", resize, lambda out: list(out),
              sum(reached_bytes(dec, img) for img in pixels) + len(pixels) * OUT * OUT * 3)
        paths = [p for p, _ in files]
        for resize_to, out_size in ((OUT, OUT), (OUT, 224), (288, 288)):
            before = dict(jpeg.LAUNCHES)
            digest = sha([dec.decode_batch(paths, resize_to, out_size, device=device, uint8=True)])
            launched = {k: v - before[k] for k, v in jpeg.LAUNCHES.items() if v != before[k]}
            print(f"decode_batch, {name} at {out_size}² from {resize_to}: launches {launched}, "
                  f"sha256 {digest}", flush=True)
        times = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            dec.decode_batch(paths, OUT, OUT, device=device, uint8=True)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            times.append((time.perf_counter() - t0) * 1e3)
        res[f"decode_batch, {name}"] = med = statistics.median(times)
        print(f"decode_batch, {name} (host clock, Huffman decoding included): median {med:.2f} "
              f"ms per call, min {min(times):.2f}, max {max(times):.2f} ({rounds} calls)",
              flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", nargs="?", default=ROOT, help="checkout whose package is timed")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--images", type=int, default=128, help="images of the decode_batch")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    run(args.root, args.device, args.images, args.rounds, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
