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
    """S > 127 raises before any launch; S = 66 and the unfolded tree run,
    each against its plain version."""
    tree = _on(_tree(None), cuda)
    before = dict(bk.LAUNCHES)
    with pytest.raises(ValueError, match="S <= 127"):
        bk.block_int8(_rows(128, cuda), layer_slice(tree, 0), 128, H)
    assert bk.LAUNCHES == before
    x = _rows(66, cuda)
    _close(bk.block_int8(x, layer_slice(tree, 0), 66, H),
           bk.block_int8_plain(x, layer_slice(tree, 0), 66, H))
    blocks = _on(_unfolded_blocks(), cuda)
    unfolded = quantize_clip_params(tclip.tree_to(
        {"visual": {"blocks": _unfolded_blocks()}}, cuda))["visual"]
    lns = tuple(bk._layer_ln(blocks, 0, n, torch.bfloat16) for n in ("ln_1", "ln_2"))
    x = _rows(50, cuda)
    _close(bk.layer_fused_int8(x, layer_slice(unfolded, 0), 50, H, lns=lns),
           bk.layer_fused_int8_plain(x, layer_slice(unfolded, 0), 50, H, lns=lns))


# the K9 branches off the folded dense route at 64 tokens or fewer, at
# ViT-B/32 widths, and the masked attention's key-chunk counts (4 up to 64
# tokens, 5 up to 80, 8 to 127) and f32 rows on the pair attention: (tower,
# width, folded mode or "unfolded", S, causal, rows dtype, the kernels that
# take the route)
BRANCHES = {
    "text f32 unfolded": ("text", 512, "unfolded", 77, True, torch.float32, ("block_int8",)),
    "text f32 folded": ("text", 512, None, 77, True, torch.float32, ("block_int8",)),
    "text bf16 unfolded": ("text", 512, "unfolded", 77, True, torch.bfloat16, ("block_int8",)),
    "unfolded 50": ("visual", 768, "unfolded", 50, False, torch.bfloat16, (
        "block_int8", "layer_fused_int8", "stream_tower_int8")),
    "82 tokens full": ("visual", 768, "full", 82, False, torch.bfloat16, (
        "block_int8", "layer_fused_int8", "stream_tower_int8")),
    "101 tokens dynamic": ("visual", 768, None, 101, False, torch.bfloat16, (
        "block_int8", "layer_fused_int8", "stream_tower_int8")),
    "odd heads unfolded": ("visual", 192, "unfolded", 50, False, torch.bfloat16, ("block_int8",)),
    "odd heads full": ("visual", 704, "full", 50, False, torch.bfloat16, ("block_int8",)),
    "64 tokens full+score": ("visual", 768, "full+score", 64, False, torch.bfloat16,
                             ("block_int8",)),
    "64 tokens unfolded": ("visual", 768, "unfolded", 64, False, torch.bfloat16, ("block_int8",)),
    "text bf16 unfolded 17": ("text", 512, "unfolded", 17, True, torch.bfloat16, ("block_int8",)),
    "text f32 folded 32": ("text", 512, None, 32, True, torch.float32, ("block_int8",)),
    "text bf16 folded 127": ("text", 512, None, 127, True, torch.bfloat16, ("block_int8",)),
    "odd heads full+score 100": ("visual", 704, "full+score", 100, False, torch.bfloat16,
                                 ("block_int8",)),
    "odd heads unfolded 127": ("visual", 192, "unfolded", 127, False, torch.bfloat16,
                               ("block_int8",)),
    "f32 rows dense 50": ("visual", 768, None, 50, False, torch.float32, ("block_int8",)),
    "f32 rows unfolded 64": ("visual", 768, "unfolded", 64, False, torch.float32, ("block_int8",)),
}


@functools.lru_cache(maxsize=None)
def _branch_tree(tower, width, mode):
    """(2-layer tree, float blocks) of seed-0 weights: the text tower at
    ``width`` (77 tokens), or the vision tower at ``width``; unfolded, or
    folded dynamic (None), or folded in a static mode calibrated on 4
    seeded images (the score column raised so that the shift is not 0)."""
    kw = ({"text_width": width, "text_heads": width // 64} if tower == "text"
          else {"vision_width": width})
    cfg = tclip.CLIPConfig(vision_layers=2, text_layers=2, vocab_size=100, **kw)
    params = tclip.init_clip_params(0, cfg)
    blocks = params[tower]["blocks"]
    if mode == "unfolded":
        return quantize_clip_params(params)[tower], blocks
    heads = {"visual": cfg.vision_heads, "text": cfg.text_heads}
    if mode is None:
        return quantize_clip_params(params, fold=True, heads=heads)[tower], blocks
    from jcf_tpu_torch.infer.engine import static_act

    act, with_scores = static_act(mode)
    imgs = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 3, 224, 224))
                            .astype(np.float32))
    amax = tclip.vision_ln_z_amax(params, cfg, imgs, with_scores=with_scores)
    if with_scores:
        amax[:, 4] = 43.0
    return quantize_clip_params(params, fold=True, heads=heads, act_scales={"visual": amax},
                                act_static=act)["visual"], blocks


@pytest.mark.parametrize("nsp", [1, 4])
@pytest.mark.parametrize("name", list(BRANCHES))
def test_k9_branches_match_plain(cuda, monkeypatch, name, nsp):
    """Each kernel of each branch against its plain version on the same
    card tensors (48 crops or prompts): one layer (K9a on its route, K9d)
    within 0.05 + 0.05 |ref| at row cos >= 0.999, the 2-layer K9c at row
    cos >= 0.999; each launch counted under its kernel and its branch."""
    tower, width, mode, s, causal, dtype, kernels = BRANCHES[name]
    monkeypatch.setattr(bk, "_MLP_NSPLIT", nsp)
    monkeypatch.setattr(bk, "_LAYER_NSPLIT", nsp)
    tree, blocks = _branch_tree(tower, width, mode)
    tree, blocks = _on(tree, cuda), _on(blocks, cuda)
    heads = width // 64
    dense = not causal and heads % 2 == 0 and s % 16 != 0
    folded = mode != "unfolded"
    g = torch.Generator(device=cuda).manual_seed(s)
    x = torch.randn(48 * s, width, device=cuda, generator=g).to(dtype)
    for name_k in kernels:
        before = dict(bk.LAUNCHES)
        branch = bk.k9_branch(tree, s, heads, dtype, causal=causal, dense=dense)
        if name_k == "stream_tower_int8":
            lns = (None, None) if folded else tuple(
                {k: blocks[n][k].to(dtype) for k in ("scale", "bias")} for n in ("ln_1", "ln_2"))
            got = bk.stream_tower_int8(x, tree, heads, s=s, lns=lns)
            ref = bk.stream_tower_int8_plain(x, tree, heads, s=s, lns=lns)
        else:
            lns = (None, None) if folded else tuple(
                bk._layer_ln(blocks, 1, n, dtype) for n in ("ln_1", "ln_2"))
            kw = dict(causal=causal, dense=dense) if name_k == "block_int8" else {}
            got = getattr(bk, name_k)(x, layer_slice(tree, 1), s, heads, lns=lns, **kw)
            ref = getattr(bk, f"{name_k}_plain")(x, layer_slice(tree, 1), s, heads, lns=lns, **kw)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == x.shape
        assert bk.LAUNCHES[name_k] == before[name_k] + 1
        assert branch and bk.LAUNCHES[f"{name_k}/{branch}"] == before[f"{name_k}/{branch}"] + 1
        _close(got, ref, cos_only=name_k == "stream_tower_int8")


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


# ---------------------------------------------------------------------------
# K9a's dense branches and K9c on the persistent kernel (csrc/block_int8.cu)
# ---------------------------------------------------------------------------

PERSISTENT_SEQS = [50, 54, 66, 82, 127]


def _counted(fn):
    before = dict(bk.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: bk.LAUNCHES[k] - before[k] for k in before if bk.LAUNCHES[k] != before[k]}


def _persistent_tree(mode, dev):
    """(2-layer tree, lns of layer i, the stacked lns) on ``dev`` at
    ViT-B/32 width: folded in ``mode`` (None: dynamic; no lns), or
    unfolded (its LN affines in bf16)."""
    tree, blocks = _branch_tree("visual", E, mode)
    tree, blocks = _on(tree, dev), _on(blocks, dev)
    if mode != "unfolded":
        return tree, lambda i: (None, None), (None, None)
    stacked = tuple({k: blocks[n][k].to(torch.bfloat16) for k in ("scale", "bias")}
                    for n in ("ln_1", "ln_2"))
    return tree, lambda i: tuple(bk._layer_ln(blocks, i, n, torch.bfloat16)
                                 for n in ("ln_1", "ln_2")), stacked


@pytest.mark.parametrize("nsp", [1, 4])
@pytest.mark.parametrize("s", PERSISTENT_SEQS)
@pytest.mark.parametrize("mode", MODES + ["unfolded"])
def test_persistent_k9_matches_plain(cuda, monkeypatch, mode, s, nsp):
    """K9a (one layer: phase 9's bars) and K9c (both layers: the cosine)
    against their plain versions in every mode, folded and unfolded, at
    nsp chunks and S from 50 to 127; one launch a layer or a tower, each
    counted under its branch."""
    monkeypatch.setattr(bk, "_MLP_NSPLIT", nsp)
    tree, lns_of, lns = _persistent_tree(mode, cuda)
    branch = bk.k9_branch(tree, s, H, torch.bfloat16)
    assert bk._layers_plan("block_int8", _rows(s, cuda), layer_slice(tree, 1), s, H, 1, nsp, True,
                           lns_of(1))["flags"] & bk.FLAG_DENSE
    x = torch.randn(48 * s, E, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(s)).bfloat16()
    layer = layer_slice(tree, 1)
    got, n = _counted(lambda: bk.block_int8(x, layer, s, H, lns=lns_of(1)))
    assert n == {"block_int8": 1, **({f"block_int8/{branch}": 1} if branch else {})}
    _close(got, bk.block_int8_plain(x, layer, s, H, lns=lns_of(1)))
    got, n = _counted(lambda: bk.stream_tower_int8(x, tree, H, s=s, lns=lns))
    assert n == {"stream_tower_int8": 1, **({f"stream_tower_int8/{branch}": 1} if branch else {})}
    _close(got, bk.stream_tower_int8_plain(x, tree, H, s=s, lns=lns), cos_only=True)


def _one_layer(tree, i):
    """Layer i of a stacked tree as a stacked tree of one layer."""
    out = {k: v for k, v in tree.items() if k not in ("attn", "mlp")}
    for half in ("attn", "mlp"):
        out[half] = {k: (type(v)(*(t[i:i + 1] for t in v)) if isinstance(v, tuple) else v[i:i + 1])
                     for k, v in tree[half].items()}
    return out


@pytest.mark.parametrize("s", [50, 54])
@pytest.mark.parametrize("mode", MODES)
def test_persistent_stream_tower_equals_its_layers_and_the_halves(cuda, monkeypatch, mode, s):
    """K9c's layer loop runs one device body: the 2-layer tower equals two
    one-layer K9c launches bit for bit, and at one hidden chunk the halves
    (K3 + K4) layer by layer, which run the same bodies and roundings."""
    monkeypatch.setattr(bk, "_MLP_NSPLIT", 1)
    tree = _on(_tree(mode), cuda)
    x = _rows(s, cuda, seed=2)
    tower = bk.stream_tower_int8(x, tree, H, s=s)
    chain, halves = x, x
    for i in range(2):
        chain = bk.stream_tower_int8(chain, _one_layer(tree, i), H, s=s)
        halves = bk._halves_int8(halves, layer_slice(tree, i), s, H)
    torch.cuda.synchronize()
    assert torch.equal(tower, chain)
    assert torch.equal(tower, halves)


@pytest.mark.parametrize("name", ["odd heads full", "64 tokens full+score", "text f32 folded"])
def test_k9a_other_branches_take_the_persistent_kernel(cuda, monkeypatch, name):
    """K9a's masked and non-dense branches run the persistent kernel: one
    ``_launch_layers`` on the route's flags (the mask, the causal mask, no
    dense route, f32 rows), and the rows agree with the plain version."""
    tower, width, mode, s, causal, dtype, _ = BRANCHES[name]
    tree, _ = _branch_tree(tower, width, mode)
    tree = _on(tree, cuda)
    heads = width // 64
    dense = not causal and heads % 2 == 0 and s % 16 != 0
    branch = bk.k9_branch(tree, s, heads, dtype, causal=causal, dense=dense)
    seen = []
    launch = bk._launch_layers

    def spy(*a, **k):
        seen.append(bk._layers_plan(*a[:8], k.get("lns", (None, None)), causal=k["causal"],
                                    dense=k["dense"])["flags"])
        return launch(*a, **k)

    monkeypatch.setattr(bk, "_launch_layers", spy)
    x = torch.randn(48 * s, width, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(3)).to(dtype)
    got, n = _counted(lambda: bk.block_int8(x, layer_slice(tree, 1), s, heads, causal=causal,
                                            dense=dense))
    assert n == {"block_int8": 1, f"block_int8/{branch}": 1}
    assert len(seen) == 1 and not seen[0] & bk.FLAG_DENSE
    assert bool(seen[0] & bk.FLAG_USE_MASK) == (causal or heads % 2 == 1)
    assert bool(seen[0] & bk.FLAG_CAUSAL) == causal
    assert bool(seen[0] & bk.FLAG_F32_ROWS) == (dtype == torch.float32)
    _close(got, bk.block_int8_plain(x, layer_slice(tree, 1), s, heads, causal=causal, dense=dense))


def test_persistent_grid_past_the_card_is_refused(cuda):
    """A grid larger than the blocks that fit on the card at once is
    refused by the cooperative launch (an error, no launch counted, no
    error left behind); the occupancy's grid runs."""
    tree = _on(_tree("full"), cuda)
    layer = layer_slice(tree, 1)
    x = _rows(50, cuda)
    before = dict(bk.LAUNCHES)
    with pytest.raises(RuntimeError):
        bk._launch_layers("block_int8", x, layer, 50, H, 1, 1, True, grid=1 << 20)
    assert bk.LAUNCHES == before
    _close(bk._launch_layers("block_int8", x, layer, 50, H, 1, 1, True),
           bk.block_int8_plain(x, layer, 50, H))


# ---------------------------------------------------------------------------
# K9d on the persistent kernel (its one-layer launch with K9c's bf16 mid)
# ---------------------------------------------------------------------------

K9D_SEQS = [17, 50, 54, 66, 82, 127]


@pytest.mark.parametrize("s", K9D_SEQS)
@pytest.mark.parametrize("nsp", [1, 4])
@pytest.mark.parametrize("mode", MODES + ["unfolded"])
def test_k9d_matches_plain(cuda, monkeypatch, mode, nsp, s):
    """K9d against its plain version in every mode, folded and unfolded, at
    nsp chunks and S from 17 to 127 (phase 9's bars); one launch, counted
    under its branch; and equal bit for bit to a one-layer K9c at the same
    chunk count (one device body)."""
    monkeypatch.setattr(bk, "_LAYER_NSPLIT", nsp)
    monkeypatch.setattr(bk, "_MLP_NSPLIT", nsp)
    tree, lns_of, _ = _persistent_tree(mode, cuda)
    branch = bk.k9_branch(tree, s, H, torch.bfloat16)
    x = torch.randn(48 * s, E, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(s + 1)).bfloat16()
    layer = layer_slice(tree, 1)
    got, n = _counted(lambda: bk.layer_fused_int8(x, layer, s, H, lns=lns_of(1)))
    assert n == {"layer_fused_int8": 1, **({f"layer_fused_int8/{branch}": 1} if branch else {})}
    _close(got, bk.layer_fused_int8_plain(x, layer, s, H, lns=lns_of(1)))
    stacked = tuple(None if ln is None else {k: t[None] for k, t in ln.items()}
                    for ln in lns_of(1))
    one = bk.stream_tower_int8(x, _one_layer(tree, 1), H, s=s, lns=stacked)
    torch.cuda.synchronize()
    assert torch.equal(got, one)
