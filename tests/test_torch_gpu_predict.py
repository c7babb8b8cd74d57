"""``jcf-predict``'s card pieces on an NVIDIA GPU: K9a, K9c and K9d in
every quantization mode of the folded tree (dynamic, "ln", "hidden",
"full", "full+score") against their plain versions, at ViT-B/32's width
on the prompted tower's 54 rows and the plain tower's 50, with 1 and 4
hidden chunks; and the MoCo RN50's f32 convolutions on the card against
the same function on the CPU.

The bars are ``chip_smoke.py`` phase 9's: each layer's output rows at row
cos >= 0.999 and within 0.05 + 0.05 |ref| (an int8 value may flip at a
rounding tie where the card's f32 sums run in another order); the K9c
tower (every layer, the flips compounding) at row cos >= 0.999 only.

Marked ``gpu``: each test skips where no CUDA device is present. The file
imports neither JAX nor ``jcf_tpu``, so it also runs on the card's host;
from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu_predict.py -q
"""

import functools

import numpy as np
import pytest
import torch

from jcf_tpu_torch.models import clip as tclip
from jcf_tpu_torch.models import resnet as tresnet
from jcf_tpu_torch.ops import block_kernel as bk
from jcf_tpu_torch.ops.layers import layer_slice
from jcf_tpu_torch.ops.quant import quantize_clip_params

pytestmark = pytest.mark.gpu

MODES = [None, "ln", "hidden", "full", "full+score"]
H, E, CROPS = 12, 768, 96


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@functools.lru_cache(maxsize=None)
def _tree(mode):
    """The folded 2-layer ViT-B/32 tree (seed-0 weights) in ``mode``:
    dynamic without calibration, else calibrated on 4 seeded images (the
    score amax column raised so that the shift is not clamped to 0)."""
    cfg = tclip.CLIPConfig(vision_layers=2, text_layers=1, vocab_size=100)
    params = tclip.init_clip_params(0, cfg)
    if mode is None:
        return quantize_clip_params(params, fold=True, heads={"visual": H})["visual"]
    from jcf_tpu_torch.infer.engine import static_act

    act, with_scores = static_act(mode)
    imgs = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 3, 224, 224))
                            .astype(np.float32))
    amax = tclip.vision_ln_z_amax(params, cfg, imgs, with_scores=with_scores)
    if with_scores:
        amax[:, 4] = 43.0
    return quantize_clip_params(params, fold=True, heads={"visual": H},
                                act_scales={"visual": amax}, act_static=act)["visual"]


def _on(tree, dev):
    return tclip.tree_to(tree, dev)


def _rows(s, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(CROPS * s, E, device=dev, generator=g).bfloat16()


def _close(got, ref, *, cos_only=False):
    got, ref = got.float(), ref.float()
    cos = torch.nn.functional.cosine_similarity(got, ref, dim=-1).min().item()
    assert cos >= 0.999, cos
    if not cos_only:
        over = ((got - ref).abs() > 0.05 + 0.05 * ref.abs()).float().mean().item()
        assert over == 0.0, over


@pytest.mark.parametrize("nsp", [1, 4])
@pytest.mark.parametrize("s", [54, 50])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["block_int8", "layer_fused_int8"])
def test_layer_kernels_match_plain(cuda, monkeypatch, name, mode, s, nsp):
    monkeypatch.setattr(bk, "_MLP_NSPLIT", nsp)
    monkeypatch.setattr(bk, "_LAYER_NSPLIT", nsp)
    layer = layer_slice(_on(_tree(mode), cuda), 1)
    x = _rows(s, cuda)
    before = bk.LAUNCHES[name]
    got = getattr(bk, name)(x, layer, s, H)
    torch.cuda.synchronize()
    assert bk.LAUNCHES[name] == before + 1
    ref = getattr(bk, f"{name}_plain")(x, layer, s, H)
    _close(got, ref)


@pytest.mark.parametrize("nsp", [1, 4])
@pytest.mark.parametrize("mode", MODES)
def test_stream_tower_matches_plain(cuda, monkeypatch, mode, nsp):
    monkeypatch.setattr(bk, "_MLP_NSPLIT", nsp)
    tree = _on(_tree(mode), cuda)
    x = _rows(54, cuda, seed=1)
    got = bk.stream_tower_int8(x, tree, H, s=54)
    torch.cuda.synchronize()
    _close(got, bk.stream_tower_int8_plain(x, tree, H, s=54), cos_only=True)


def test_layer_kernels_refuse_bad_operands(cuda):
    tree = _on(_tree(None), cuda)
    with pytest.raises(ValueError, match="S <= 64"):
        bk.block_int8(_rows(66, cuda), layer_slice(tree, 0), 66, H)
    unfolded = quantize_clip_params(tclip.tree_to(
        {"visual": {"blocks": _unfolded_blocks()}}, cuda))["visual"]
    with pytest.raises(NotImplementedError, match="Queue 2"):
        bk.layer_fused_int8(_rows(50, cuda), layer_slice(unfolded, 0), 50, H)


def _unfolded_blocks():
    cfg = tclip.CLIPConfig(vision_layers=1, text_layers=1, vocab_size=100)
    return tclip.init_clip_params(0, cfg)["visual"]["blocks"]


def _rn50(seed=0):
    """Seed-0 RN50 weights with BatchNorm statistics of a trained tower
    (scales 0.2-0.6, running variances 0.5-2): identity BatchNorms let the
    random tower's features grow to ~1e3."""
    params = tresnet.init_resnet50_params(seed)
    rng = np.random.default_rng(seed + 5)

    def stats(bn):
        c = bn["weight"].shape[0]
        for k, lo_hi in (("weight", (0.2, 0.6)), ("running_var", (0.5, 2.0))):
            bn[k] = torch.from_numpy(rng.uniform(*lo_hi, c).astype(np.float32))
        for k, std in (("bias", 0.05), ("running_mean", 0.1)):
            bn[k] = torch.from_numpy((std * rng.standard_normal(c)).astype(np.float32))

    stats(params["bn1"])
    for stage in params["layers"]:
        for block in stage:
            for i in (1, 2, 3):
                stats(block[f"bn{i}"])
            if "downsample" in block:
                stats(block["downsample"]["bn"])
    return params


@pytest.mark.parametrize("size", [64, 96])
def test_resnet50_f32_matches_cpu(cuda, size):
    """The MoCo RN50 in f32 on the card (cuDNN with TF32 off) against the
    same function on the CPU: within 1e-4."""
    params = _rn50()
    imgs = torch.from_numpy(np.random.default_rng(size).standard_normal((2, 3, size, size))
                            .astype(np.float32))
    ref = tresnet.resnet50_features(params, imgs)
    got = tresnet.resnet50_features(tclip.tree_to(params, cuda), imgs.to(cuda))
    assert got.shape == (2, 2048) and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)


def test_resnet50_refuses_tf32_convolutions(cuda, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    params = tclip.tree_to(tresnet.init_resnet50_params(0), cuda)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        tresnet.resnet50_features(params, torch.zeros(1, 3, 64, 64, device=cuda))
