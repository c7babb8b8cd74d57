"""``jcf-ood``'s card pieces on an NVIDIA GPU: K9b in f32 (``block_f32``)
against its plain version, the JPEG decode (PIL's bytes at every scale,
``tests/fixtures/jpeg/libjpeg_sha256.json``) and the resize + crop kernel
against the committed references, the batched upsample and resize
against their plain versions, the PIL-exact transforms on the card
against the same functions on the CPU.

Marked ``gpu``: each test skips where no CUDA device is present. The file
imports neither JAX, ``jcf_tpu`` nor PIL, so it also runs on the card's
host; from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_ood.py -q
"""

import os
import threading

import numpy as np
import pytest
import torch

from jcf_tpu_torch.data import decode as dec
from jcf_tpu_torch.data import read_image
from jcf_tpu_torch.data import transforms as tt
from jcf_tpu_torch.data import jpeg
from jcf_tpu_torch.ops import block_kernel as bk
from jcf_tpu_torch.ops import f32_gemm as fg
from jcf_tpu_torch.ops.attention import causal_mask
from jcf_tpu_torch.ops.layers import layer_slice

pytestmark = pytest.mark.gpu

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "jpeg")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _layer(e, hidden, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def n(*shape, std=0.02):
        return torch.randn(*shape, device=dev, generator=g) * std

    return {"ln_1": {"scale": 1 + n(e, std=0.1), "bias": n(e, std=0.1)},
            "ln_2": {"scale": 1 + n(e, std=0.1), "bias": n(e, std=0.1)},
            "attn": {"w_qkv": n(3 * e, e, std=0.05), "b_qkv": n(3 * e), "w_out": n(e, e),
                     "b_out": n(e)},
            "mlp": {"c_fc": {"w": n(hidden, e), "b": n(hidden)},
                    "c_proj": {"w": n(e, hidden), "b": n(e)}}}


def _stack(tree):
    return {k: _stack(v) for k, v in tree.items()} if isinstance(tree, dict) else tree[None]


def _f32_layer(e, hidden, dev, seed):
    """``_layer`` with its weights' TF32 planes beside them, as a layer of
    an f32 tree that ``with_tf32_planes`` split holds them."""
    return layer_slice(fg.with_tf32_planes(_stack(_layer(e, hidden, dev, seed))), 0)


@pytest.mark.parametrize("s,causal,heads,n_seq", [(77, True, 2, 5), (50, False, 4, 7),
                                                  (64, False, 2, 3), (17, True, 6, 9)])
def test_block_f32(cuda, s, causal, heads, n_seq):
    e = 64 * heads
    layer = _f32_layer(e, 4 * e, cuda, s)
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(n_seq * s, e, device=cuda, generator=gen)
    bias = causal_mask(s, cuda) if causal else torch.zeros(s, s, device=cuda)
    before = bk.LAUNCHES["block_f32"]
    got = bk.block_f32(x, layer, s, heads, bias)
    assert bk.LAUNCHES["block_f32"] == before + 1
    ref = bk.block_f32_plain(x, layer, s, heads, bias)
    assert bool(((got - ref).abs() <= 1e-5 + 1e-5 * ref.abs()).all())


def _bias(kind, s, dev):
    if kind == "causal":
        return causal_mask(s, dev)
    if kind == "zero":
        return torch.zeros(s, s, device=dev)
    return torch.randn(s, s, device=dev, generator=torch.Generator(device=dev).manual_seed(s))


def _f32_close(got, ref):
    """``check_block_f32``'s bar: 1e-5 + 1e-5 |ref| and row cos >= 0.99999."""
    assert bool(((got - ref).abs() <= 1e-5 + 1e-5 * ref.abs()).all())
    assert float(torch.nn.functional.cosine_similarity(got, ref).min()) >= 0.99999


@pytest.mark.parametrize("bias", ["causal", "zero", "random"])
@pytest.mark.parametrize("s", [17, 50, 77, 80])
@pytest.mark.parametrize("width", [128, 512, 768])
def test_block_f32_kernel_shapes(cuda, width, s, bias):
    """K9b (csrc/block_float.cu) in f32, three TF32 products a product, vs
    its plain version (exact f32) on 3 sequences, at each width, length
    and bias."""
    layer = _f32_layer(width, 4 * width, cuda, width + s)
    x = torch.randn(3 * s, width, device=cuda, generator=torch.Generator(device=cuda).manual_seed(s))
    b, h = _bias(bias, s, cuda), width // 64
    before = bk.LAUNCHES["block_f32"]
    got = bk.block_f32(x, layer, s, h, b)
    assert bk.LAUNCHES["block_f32"] == before + 1
    _f32_close(got, bk.block_f32_plain(x, layer, s, h, b))


@pytest.mark.parametrize("n_seq,chunk", [(1, None), (9, 4), (7, 3), (5, 2), (4, 1), (9, None)])
def test_block_f32_kernel_chunks(cuda, n_seq, chunk):
    """K9b in f32 over forced chunks of whole sequences (a partial last
    one where the chunk does not divide them), one sequence, and all the
    sequences in one chunk (None, the wrappers' default), against its
    plain version."""
    layer = _f32_layer(768, 3072, cuda, n_seq)
    x = torch.randn(n_seq * 50, 768, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(n_seq))
    b = torch.zeros(50, 50, device=cuda)
    got = bk._block_float("block_f32", x, layer, 50, 12, b, torch.float32, chunk=chunk)
    _f32_close(got, bk.block_f32_plain(x, layer, 50, 12, b))


def test_block_f32_reads_the_planes_bit_for_bit(cuda):
    """K9b f32 on planes split by the kernel and by the plain version (then
    copied to the card): the same output bit for bit, no split launch."""
    layer = _f32_layer(768, 3072, cuda, 5)
    host = {**layer, "attn": {**layer["attn"]}, "mlp": {k: dict(v) for k, v in layer["mlp"].items()}}
    for owner, k in ((host["attn"], "w_qkv"), (host["attn"], "w_out"), (host["mlp"]["c_fc"], "w"),
                     (host["mlp"]["c_proj"], "w")):
        owner[k + "_tf32"] = fg.tf32_split_plain(owner[k].cpu()).to(cuda)
    x = torch.randn(7 * 50, 768, device=cuda, generator=torch.Generator(device=cuda).manual_seed(5))
    b = torch.zeros(50, 50, device=cuda)
    before = fg.LAUNCHES["tf32_split"]
    got = bk.block_f32(x, layer, 50, 12, b)
    assert torch.equal(bk.block_f32(x, host, 50, 12, b).view(torch.int32), got.view(torch.int32))
    assert fg.LAUNCHES["tf32_split"] == before


def test_block_f32_refuses_what_it_does_not_take(cuda):
    layer = _layer(128, 512, cuda, 0)
    before = bk.LAUNCHES["block_f32"]
    with pytest.raises(ValueError, match="with_tf32_planes"):
        bk.block_f32(torch.zeros(2 * 50, 128, device=cuda), layer, 50, 2,
                     torch.zeros(50, 50, device=cuda))
    assert bk.LAUNCHES["block_f32"] == before
    with pytest.raises(ValueError, match="block_f32"):
        bk.block_f32(torch.zeros(2 * 90, 128, device=cuda), layer, 90, 2,
                     torch.zeros(90, 90, device=cuda))
    with pytest.raises(ValueError, match="block_f32"):
        bk.block_f32(torch.zeros(2 * 50, 128, device=cuda, dtype=torch.bfloat16), layer, 50, 2,
                     torch.zeros(50, 50, device=cuda))


def test_decode_matches_the_committed_references(cuda):
    """The full-size decode + resize within one level of PIL's decode +
    the plain resize (``pil_256``), ``decode_batch`` within one level of
    ``jcf_tpu.native``'s output (``pil_256`` + ``delta``): the resize
    kernel's f32 sums are the one difference."""
    refs = np.load(os.path.join(FIXTURES, "native_minus_pil.npz"))
    for name, delta in zip(refs["names"], refs["delta"]):
        name = str(name)
        path = os.path.join(FIXTURES, name)
        with open(os.path.join(FIXTURES, "pil_256", name[:-4] + ".png"), "rb") as f:
            pil = dec.decode_png(f.read()).astype(np.int16)
        full = dec.resize_crop(dec.decode_file(path, cuda), 256, 256).cpu().numpy()
        batch = dec.decode_batch([path], device=cuda, uint8=True)[0].cpu().numpy()
        for got, ref in ((full, pil), (batch, pil + delta)):
            d = np.abs(got.astype(np.int16) - ref)
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (name, d.max(), (d > 0).mean())


def test_decode_hashes_at_every_scale(cuda):
    """Every committed JPEG decoded on the card at every scale PIL's draft
    reaches hashes to PIL's decode; each decode is one IDCT and one
    upsample launch whose pixels equal the plain versions' (``idct_plain``,
    then ``upsample_color_plain``) bit for bit."""
    import hashlib
    import json

    with open(os.path.join(FIXTURES, "libjpeg_sha256.json")) as f:
        refs = json.load(f)["images"]
    for rel, scales in refs.items():
        with open(os.path.join(FIXTURES, rel), "rb") as f:
            data = f.read()
        coef = jpeg.read_coefficients(data, rel)
        for scale, ref in scales.items():
            out_w, out_h, geo = jpeg.geometry(coef, int(scale))
            before = dict(jpeg.LAUNCHES)
            img = jpeg.decode_jpeg(data, cuda, scale_denom=int(scale), name=rel)
            got = {k: v - before[k] for k, v in jpeg.LAUNCHES.items() if v != before[k]}
            assert got == {"jpeg_idct": 1, "jpeg_upsample_color": 1}, (rel, scale)
            planes = [jpeg.idct_plain(c.coefs.to(cuda), c.quant.to(cuda), p.size)
                      for c, p in zip(coef.components, geo)]
            assert torch.equal(img, jpeg.upsample_color_plain(planes, geo, out_w, out_h,
                                                              coef.ycc)), (rel, scale)
            x = img.cpu().numpy()
            x = np.repeat(x, 3, axis=2) if x.shape[2] == 1 else x
            assert list(x.shape) == ref["shape"], (rel, scale)
            assert hashlib.sha256(x.tobytes()).hexdigest() == ref["sha256"], (rel, scale)


def _fixture_images():
    """Every committed JPEG at scales 1, 2, 4 and 8."""
    import json

    with open(os.path.join(FIXTURES, "libjpeg_sha256.json")) as f:
        rels = sorted(json.load(f)["images"])
    images = []
    for rel in rels:
        with open(os.path.join(FIXTURES, rel), "rb") as f:
            coef = jpeg.read_coefficients(f.read(), rel)
        images += [(coef, jpeg.geometry(coef, d, rel)[2]) for d in jpeg.SCALES]
    return images


@pytest.mark.parametrize("kind", ["fixtures", "random"])
def test_batched_idct_is_one_launch_equal_to_plain(cuda, kind):
    """One ``jpeg_idct`` launch over many images of mixed IDCT sizes (the
    committed JPEGs at every scale; random coefficients past 16 bits) equals
    ``idct_plain`` of each component, and its plain version over the same
    table, bit for bit."""
    images = (_fixture_images() if kind == "fixtures"
              else jpeg.random_idct_images(np.random.default_rng(3), 24))
    before = jpeg.LAUNCHES["jpeg_idct"]
    layout = jpeg.idct_layout(images)
    got = layout.views(layout.run(jpeg.stage(cuda, layout.tables(images))))
    assert jpeg.LAUNCHES["jpeg_idct"] == before + 1
    for (coef, geo), planes in zip(images, got):
        for c, p, plane in zip(coef.components, geo, planes):
            assert torch.equal(plane, jpeg.idct_plain(c.coefs.to(cuda), c.quant.to(cuda), p.size))
    coefs = torch.cat([c.coefs for c, _ in images]).to(cuda)
    quant = torch.cat([c.quant for c, _ in images]).to(cuda)
    desc = torch.from_numpy(layout.desc).to(cuda)
    out = jpeg.idct_batch(coefs, quant, desc, layout)
    ref = jpeg.idct_batch_plain(coefs, quant, desc, layout.out_bytes)
    for mine in layout.planes:
        for off, h, w in mine:
            assert torch.equal(out[off:off + h * w], ref[off:off + h * w])


def test_decode_calls_launch_one_idct(cuda):
    """``decode_file`` makes one IDCT launch an image, ``decode_batch`` one
    a call, whatever the images' components."""
    paths = [os.path.join(FIXTURES, f) for f in sorted(os.listdir(FIXTURES))
             if f.endswith(".jpg")] * 3
    before = dict(jpeg.LAUNCHES)
    for p in paths:
        dec.decode_file(p, cuda)
    assert jpeg.LAUNCHES["jpeg_idct"] - before["jpeg_idct"] == len(paths)
    before = dict(jpeg.LAUNCHES)
    dec.decode_batch(paths, device=cuda)
    got = {k: v - before[k] for k, v in jpeg.LAUNCHES.items()}
    assert got == {"jpeg_idct": 1, "jpeg_upsample_color": 1, "resize_crop": 1}


@pytest.mark.parametrize("kind", ["fixtures", "random", "wide"])
def test_batched_upsample_is_one_launch_equal_to_plain(cuda, kind):
    """One ``jpeg_upsample_color`` launch over many images equals
    ``upsample_color_batch_plain`` bit for bit: the committed JPEGs at
    every scale (through a ``DecodePlan``, against the same plan on the
    CPU), random planes (every method, planes of 1 to 3 samples a side,
    unaligned offsets and strides), and rows too wide for one CTA's shared
    memory beside a tall narrow image."""
    if kind == "fixtures":
        images = [(coef, geo, *jpeg.geometry(coef, jpeg.SCALES[i % len(jpeg.SCALES)])[:2])
                  for i, (coef, geo) in enumerate(_fixture_images())]
        before = jpeg.LAUNCHES["jpeg_upsample_color"]
        plan = jpeg.DecodePlan(images, cuda)
        got = plan.run(jpeg.stage(cuda, plan.tables()))
        assert jpeg.LAUNCHES["jpeg_upsample_color"] == before + 1
        ref = jpeg.DecodePlan(images, "cpu")
        for g, w in zip(got, ref.run(jpeg.stage("cpu", ref.tables()))):
            assert torch.equal(g.cpu(), w)
        return
    rng = np.random.default_rng(7)
    planes, images = (jpeg.random_color_images(rng, 40) if kind == "random" else
                      jpeg.random_color_images(rng, 3, sizes=[(14001, 3), (2, 2500), (9000, 2)]))
    layout = jpeg.upsample_layout(images)
    desc = torch.from_numpy(layout.desc)
    before = jpeg.LAUNCHES["jpeg_upsample_color"]
    got = jpeg.upsample_color_batch(planes.to(cuda), desc.to(cuda), layout).cpu()
    assert jpeg.LAUNCHES["jpeg_upsample_color"] == before + 1
    want = jpeg.upsample_color_batch_plain(planes, desc, layout.out_bytes)
    for g, w in zip(layout.views(got), layout.views(want)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("size", [(256, 256), (224, 200), (300, 288)])
def test_batched_resize_is_one_launch(cuda, size):
    """One ``resize_crop`` launch over the fixtures at libjpeg's scale, a
    4x downscale of a PNG-sized source and a gray source: within one level
    on <= 1e-3 of the values of the plain version, and equal to each image
    resized alone (a table of one) bit for bit."""
    resize_to, out = size
    sources = []
    for path in sorted(os.listdir(FIXTURES)):
        if path.endswith(".jpg"):
            with open(os.path.join(FIXTURES, path), "rb") as f:
                coef = jpeg.read_coefficients(f.read(), path)
            d = dec.native_scale(coef.width, coef.height, resize_to)
            sources.append(jpeg.decode_coefficients(coef, cuda, d))
    rng = np.random.default_rng(0)
    sources.append(torch.from_numpy(rng.integers(0, 256, (1100, 1040, 3), np.uint8)).to(cuda))
    sources.append(torch.from_numpy(rng.integers(0, 256, (97, 50, 1), np.uint8)).to(cuda))
    before = jpeg.LAUNCHES["resize_crop"]
    got = dec.resize_crop_batch(sources, resize_to, out)
    assert jpeg.LAUNCHES["resize_crop"] == before + 1
    ref = dec.resize_crop_batch_plain(sources, resize_to, out)
    d = (got.int() - ref.int()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3
    for g, img in zip(got, sources):
        assert torch.equal(g, dec.resize_crop(img, resize_to, out))


def test_decode_in_a_thread_while_the_card_is_busy(cuda):
    """Decoded back to back in a second thread while the stream is busy,
    images must still equal their decode alone."""
    paths = [os.path.join(FIXTURES, f) for f in sorted(os.listdir(FIXTURES))
             if f.endswith(".jpg")] * 16
    ref = []
    for p in paths:
        ref.append(dec.decode_batch([p], device=cuda, uint8=True)[0])
        torch.cuda.synchronize()
    got = []
    worker = threading.Thread(target=lambda: got.append(dec.decode_batch(paths, device=cuda,
                                                                         uint8=True)))
    a = torch.randn(2048, 2048, device=cuda)
    worker.start()
    for _ in range(200):
        a = (a @ a) * 1e-3
    worker.join(timeout=300)
    assert not worker.is_alive()
    torch.cuda.synchronize()
    assert all(torch.equal(g, r) for g, r in zip(got[0], ref))


@pytest.mark.parametrize("size", [(256, 256), (224, 200), (300, 288)])
def test_resize_crop_kernel(cuda, size):
    resize_to, out = size
    for path in sorted(os.listdir(FIXTURES)):
        if not path.endswith(".jpg"):
            continue
        raw = dec.decode_file(os.path.join(FIXTURES, path), cuda)
        got = dec.resize_crop(raw, resize_to, out)
        ref = dec.resize_crop_plain(raw, resize_to, out)
        d = (got.int() - ref.int()).abs()
        assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3


def test_decode_refuses_a_corrupt_jpeg(cuda, tmp_path):
    path = tmp_path / "broken.jpg"
    path.write_bytes(b"\xff\xd8\xff\xe0" + b"\x00" * 64)
    with pytest.raises(ValueError, match="broken.jpg"):
        dec.decode_file(str(path), cuda)


def test_transforms_on_the_card_equal_the_cpu(cuda):
    """The float64 resample is exact, so the card's crops equal the CPU's
    (which equal PIL's, ``tests/test_torch_transforms.py``)."""
    img = read_image(os.path.join(FIXTURES, "f4_420_540x720.jpg"), cuda)
    sampler = tt.TTACropSampler(n_views=33, size=224, seed=0)
    assert torch.equal(sampler(img, 5).cpu(), sampler(img.cpu(), 5))
    assert torch.equal(tt.preprocess_center(img).cpu(), tt.preprocess_center(img.cpu()))


def test_cli_runs_bf16_from_the_default_reduction_flag(cuda, tmp_path, monkeypatch):
    """``jcf-ood-torch --dtype bfloat16`` on the card: PyTorch's default
    lets bf16 products reduce in reduced precision, which
    ``ops.layers.linear`` refuses; the CLI turns it off, so a run from the
    default completes and writes both split files (a one-layer CLIP at
    width 128 on the six fixture JPEGs, 403 synthetic classes)."""
    import pickle

    from chip_smoke import ood_dataset
    from jcf_tpu_torch.cli import ood as cli
    from jcf_tpu_torch.models.clip import CLIPConfig, init_clip_params
    from jcf_tpu_torch.models.loader import state_dict_from_params

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_bf16_reduced_precision_reduction", True)
    cfg = CLIPConfig(embed_dim=64, vision_width=128, vision_layers=1, text_width=128,
                     text_heads=2, text_layers=1)
    ckpt = tmp_path / "tiny.pkl"
    with open(ckpt, "wb") as f:
        pickle.dump(state_dict_from_params(init_clip_params(0, cfg), cfg), f)
    ds = ood_dataset(str(tmp_path / "Dataset"), 6)
    monkeypatch.chdir(tmp_path)
    out = cli.main(["--root_path", ds, "--clip_checkpoint", str(ckpt), "--dtype", "bfloat16",
                    "--n_views", "3", "--batch_images", "4"])
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    assert out["n_base"] + out["n_new"] == 6
    assert all(os.path.isfile(out[k]) for k in ("base_path", "new_path"))
