"""``jcf-ood``'s card pieces on an NVIDIA GPU: K9b in f32 (``block_f32``)
against its plain version, the nvJPEG decode and the resize + crop
kernel against the committed references, the PIL-exact transforms on
the card against the same functions on the CPU.

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
from jcf_tpu_torch.ops import block_kernel as bk
from jcf_tpu_torch.ops.attention import causal_mask

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


@pytest.mark.parametrize("s,causal,heads,n_seq", [(77, True, 2, 5), (50, False, 4, 7),
                                                  (64, False, 2, 3), (17, True, 6, 9)])
def test_block_f32(cuda, s, causal, heads, n_seq):
    e = 64 * heads
    layer = _layer(e, 4 * e, cuda, s)
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(n_seq * s, e, device=cuda, generator=gen)
    bias = causal_mask(s, cuda) if causal else torch.zeros(s, s, device=cuda)
    before = bk.LAUNCHES["block_f32"]
    got = bk.block_f32(x, layer, s, heads, bias)
    assert bk.LAUNCHES["block_f32"] == before + 1
    ref = bk.block_f32_plain(x, layer, s, heads, bias)
    assert bool(((got - ref).abs() <= 1e-5 + 1e-5 * ref.abs()).all())


def test_block_f32_refuses_what_it_does_not_take(cuda):
    layer = _layer(128, 512, cuda, 0)
    with pytest.raises(ValueError, match="block_f32"):
        bk.block_f32(torch.zeros(2 * 90, 128, device=cuda), layer, 90, 2,
                     torch.zeros(90, 90, device=cuda))
    with pytest.raises(ValueError, match="block_f32"):
        bk.block_f32(torch.zeros(2 * 50, 128, device=cuda, dtype=torch.bfloat16), layer, 50, 2,
                     torch.zeros(50, 50, device=cuda))


def test_decode_matches_the_committed_references(cuda):
    refs = np.load(os.path.join(FIXTURES, "native_minus_pil.npz"))
    for name, delta in zip(refs["names"], refs["delta"]):
        name = str(name)
        with open(os.path.join(FIXTURES, "pil_256", name[:-4] + ".png"), "rb") as f:
            pil = dec.decode_png(f.read()).astype(np.int16)
        got = dec.decode_batch([os.path.join(FIXTURES, name)], device=cuda, uint8=True)
        got = got[0].cpu().numpy().astype(np.int16)
        for ref in (pil, pil + delta):
            d = np.abs(got - ref)
            assert d.max() <= 16 and d.mean() <= 1.5, (name, d.max(), d.mean())


def test_decode_in_a_thread_while_the_card_is_busy(cuda):
    """nvJPEG reuses its state's buffers on the next call; decoded back to
    back while the stream is busy, images must still equal their decode
    alone."""
    paths = [os.path.join(FIXTURES, f) for f in sorted(os.listdir(FIXTURES))
             if f.endswith(".jpg")] * 16
    ref = []
    for p in paths:
        ref.append(dec.resize_crop(dec.decode_file(p, cuda), 256, 256))
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
