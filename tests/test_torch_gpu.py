"""The port's CUDA kernels vs their plain versions, on an NVIDIA GPU.

Marked ``gpu``: each test skips where no CUDA device is present. The file
imports neither JAX nor ``jcf_tpu``, so it also runs on a host without
them; from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py -q

Shapes are small and ragged (rows not a multiple of the tiles) to reach
the kernels' edges; ``chip_smoke.py`` checks them at the serving shapes.
"""

import pytest
import torch

from jcf_tpu_torch.models.clip import CLIPConfig, init_clip_params, tree_to
from jcf_tpu_torch.ops import assemble_kernel as ak
from jcf_tpu_torch.ops import attention as at
from jcf_tpu_torch.ops import bf16_gemm as bg
from jcf_tpu_torch.ops import block_kernel as bk
from jcf_tpu_torch.ops import int8_gemm as ig
from jcf_tpu_torch.ops import view_kernel as vk
from jcf_tpu_torch.ops.layers import layer_slice

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda", 0)


def _int8_close(got, ref, frac):
    d = (got.int() - ref.int()).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= frac


def _bf16_close(got, ref):
    g, r = got.float(), ref.float()
    assert bool(((g - r).abs() <= 2.0**-7 * g.abs().maximum(r.abs()) + 1e-3).all())


@pytest.mark.parametrize("seed", [0, 1])
def test_view_kernel(cuda, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    images = torch.rand(5, 3, 80, 72, device=cuda, generator=gen).bfloat16()
    cy, cx, inv = vk.sample_view_centers(gen, 5, 6, (80, 72), 48)
    got = vk.fused_views_nchw(images, cy, cx, inv, 48, quantize=True)
    ref = vk.fused_views_nchw_plain(images, cy, cx, inv, 48, quantize=True)
    _int8_close(got, ref, 5e-3)


@pytest.mark.parametrize("m,n,k", [(200, 72, 96), (128, 128, 64), (77, 24, 3072)])
def test_int8_gemm_epilogues(cuda, m, n, k):
    g = torch.Generator(device=cuda).manual_seed(m + n + k)
    a = torch.randint(-127, 128, (m, k), device=cuda, generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), device=cuda, generator=g, dtype=torch.int8)
    scale = torch.rand(n, device=cuda, generator=g) * 2e-5
    bias = torch.randn(n, device=cuda, generator=g) * 0.1
    resid = torch.randn(m, n, device=cuda, generator=g).bfloat16()
    c = torch.tensor(0.851 / 30.0, device=cuda)
    assert torch.equal(ig.int8_gemm_s32(a, w), ig.int8_matmul_plain(a, w))
    acc = ig.int8_matmul_plain(a, w)
    _bf16_close(ig.int8_gemm_bf16(a, w, scale, bias),
                ig.dequant_plain(acc, scale, bias).bfloat16())
    _bf16_close(ig.int8_gemm_residual(a, w, scale, bias, resid),
                (resid.float() + ig.dequant_plain(acc, scale, bias)).bfloat16())
    _int8_close(ig.int8_gemm_gelu_quant(a, w, scale * 30, bias * 30, c),
                ig.gelu_quant_plain(ig.dequant_plain(acc, scale * 30, bias * 30), c), 1e-3)


def test_assemble_kernel(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    e = 768
    acc = torch.randint(-20000, 20000, (9, 7, 7, e), device=cuda, generator=g, dtype=torch.int32)
    scale = torch.rand(e, device=cuda, generator=g) * 1e-4
    bias = torch.randn(e, device=cuda, generator=g)
    pos = torch.randn(49, e, device=cuda, generator=g).bfloat16()
    lns, lnb = torch.ones(e, device=cuda), torch.zeros(e, device=cuda)
    cls = ak.make_cls_row(torch.randn(e, device=cuda, generator=g), pos[0], lns, lnb)
    args = (acc, scale, bias, pos, cls, lns, lnb)
    _bf16_close(ak.assemble_dense_rows(*args), ak.assemble_dense_rows_plain(*args))


def test_ln_quant_and_attention_kernels(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    s, h, d, crops = 50, 12, 64, 33
    x = torch.randn(crops * s, h * d, device=cuda, generator=g).bfloat16()
    inv = torch.tensor([[127.0 / 4.5]], device=cuda)
    _int8_close(bk.ln_quant(x, inv), bk.ln_quant_plain(x, inv), 1e-3)
    qkv = (torch.randn(crops * s, 3 * h * d, device=cuda, generator=g) * 0.5).bfloat16()
    ctx_inv = torch.tensor([[30.0]], device=cuda)
    _int8_close(bk.attention(qkv, ctx_inv, s, h), bk.attention_plain(qkv, ctx_inv, s, h), 1e-2)


@pytest.mark.parametrize("m,n,k", [(200, 72, 96), (128, 128, 64), (77, 24, 2048)])
def test_bf16_gemm_epilogues(cuda, m, n, k):
    g = torch.Generator(device=cuda).manual_seed(m + n + k)
    a = torch.randn(m, k, device=cuda, generator=g).bfloat16()
    w = (torch.randn(n, k, device=cuda, generator=g) * k**-0.5).bfloat16()
    bias = torch.randn(n, device=cuda, generator=g) * 0.1
    resid = torch.randn(m, n, device=cuda, generator=g).bfloat16()
    acc = bg.matmul_plain(a, w)
    _bf16_close(bg.bf16_gemm_bias(a, w, bias), (acc + bias).bfloat16())
    _bf16_close(bg.bf16_gemm_residual(a, w, bias, resid), (resid.float() + (acc + bias)).bfloat16())
    _bf16_close(bg.bf16_gemm_gelu(a, w, bias), bg.gelu_plain(acc + bias).bfloat16())


def test_ln_affine_and_causal_attention_kernels(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    s, h, d, seqs = 77, 8, 64, 9
    x = torch.randn(seqs * s, h * d, device=cuda, generator=g).bfloat16()
    scale = (1 + 0.1 * torch.randn(h * d, device=cuda, generator=g)).bfloat16()
    bias = (0.1 * torch.randn(h * d, device=cuda, generator=g)).bfloat16()
    _bf16_close(bk.ln_affine(x, scale, bias), bk.ln_affine_plain(x, scale, bias))
    qkv = torch.randn(seqs * s, 3 * h * d, device=cuda, generator=g).bfloat16()
    _bf16_close(bk.causal_attention(qkv, s, h), bk.causal_attention_plain(qkv, s, h))


@pytest.mark.parametrize("s", [50, 64])
def test_cls_attention_kernel(cuda, s):
    g = torch.Generator(device=cuda).manual_seed(s)
    h, crops = 12, 37
    q = (torch.randn(crops, h * 64, device=cuda, generator=g) * 0.5).bfloat16()
    kv = (torch.randn(crops * s, 2 * h * 64, device=cuda, generator=g) * 0.5).bfloat16()
    ctx_inv = torch.tensor([[30.0]], device=cuda)
    _int8_close(bk.cls_attention(q, kv, ctx_inv, s, h),
                bk.cls_attention_plain(q, kv, ctx_inv, s, h), 1e-2)


def test_text_tower_kernels_vs_plain(cuda):
    """A 2-layer full-width text tower (512 wide, 8 heads, 77 tokens): the
    kernel route vs the same tower run from the plain versions on the CPU."""
    params = init_clip_params(0, CLIPConfig(text_layers=2))["text"]["blocks"]
    x = torch.randn(6 * 77, 512, generator=torch.Generator().manual_seed(0)).bfloat16()
    ref = bk.run_float_tower(x, params, 8, s=77, causal=True)
    got = bk.run_float_tower(x.to(cuda), tree_to(params, cuda), 8, s=77, causal=True).cpu()
    cos = torch.nn.functional.cosine_similarity(got.float(), ref.float())
    assert float(cos.min()) >= 0.999


def test_tower_kernels_vs_plain(cuda):
    """A 2-layer full-width tower: the kernel route vs the same tower run
    from the plain versions (the tree moved to the CPU)."""
    from jcf_tpu_torch.ops.quant import quantize_clip_params

    cfg = CLIPConfig(vision_layers=2)
    params = init_clip_params(0, cfg)
    amax = torch.tensor([[6.0, 6.0, 3.0, 4.0]] * 2)
    tree = quantize_clip_params(params, fold=True, heads={"visual": 12}, act_scales={"visual": amax})["visual"]
    x = torch.randn(16 * 50, 768, generator=torch.Generator().manual_seed(0)).bfloat16()
    ref = bk.run_fused_tower(x, tree, 12, flat_s=50)
    got = bk.run_fused_tower(x.to(cuda), tree_to(tree, cuda), 12, flat_s=50).cpu()
    cos = torch.nn.functional.cosine_similarity(got.float(), ref.float())
    assert float(cos.min()) >= 0.999


def _f32_close(got, ref):
    assert bool(((got - ref).abs() <= 1e-5 + 1e-5 * ref.abs()).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,h,causal", [(77, 8, True), (50, 12, False), (23, 3, True)])
def test_packed_attention_kernels(cuda, dtype, s, h, causal):
    """K7 forward and backward vs the plain forward and autograd through
    it: f32 within 1e-5 (+ 1e-5 relative), bf16 within 1 bf16 ulp + 1e-3."""
    g = torch.Generator(device=cuda).manual_seed(s + h)
    b = 5
    qkv = torch.randn(b, s, 3 * h * 64, device=cuda, generator=g).to(dtype)
    dout = torch.randn(b, s, h * 64, device=cuda, generator=g).to(dtype)
    bias = at.causal_mask(s, cuda) if causal else torch.zeros(s, s, device=cuda)
    close = _f32_close if dtype == torch.float32 else _bf16_close
    close(at.packed_attention_fwd(qkv, h, bias).float(),
          at.packed_attention_plain(qkv, h, bias).float())
    x = qkv.clone().requires_grad_(True)
    ref, = torch.autograd.grad(at.packed_attention_plain(x, h, bias), x, dout)
    close(at.packed_attention_bwd(qkv, h, bias, dout).float(), ref.float())


def test_packed_attention_autograd_launches_both_kernels(cuda):
    qkv = torch.randn(4, 50, 3 * 128, device=cuda).requires_grad_(True)
    before = dict(at.LAUNCHES)
    at.packed_attention(qkv, 2).sum().backward()
    assert at.LAUNCHES["packed_attention"] == before["packed_attention"] + 1
    assert at.LAUNCHES["packed_attention_bwd"] == before["packed_attention_bwd"] + 1
    assert qkv.grad.shape == qkv.shape and bool(qkv.grad.isfinite().all())


def test_stage1_step_kernels_vs_plain_attention(cuda, monkeypatch):
    """One f32 stage-1 step of a 2-layer full-width model through K7 and
    one through the plain K7 (autograd through ``packed_attention_plain``),
    from the same state and dropout seeds: losses within 1e-5 relative, the
    updated factors within 1e-5 (1% of the learning rate: Adam divides by
    sqrt(v) + 1e-8, so a gradient near 1e-8 turns a last-bit difference
    into a few 1e-6 of its factor)."""
    from jcf_tpu_torch.peft import LoraSpec, init_lora_params
    from jcf_tpu_torch.train import adamw, make_stage1_step

    cfg = CLIPConfig(text_layers=2, vision_layers=2)
    spec = LoraSpec()
    params = init_clip_params(0, cfg)
    lora = init_lora_params(1, spec, 2, cfg.text_width, 2, cfg.vision_width)
    gen = torch.Generator().manual_seed(0)
    banks = torch.randint(1, 49000, (2, 7, 77), generator=gen)
    banks[:, :, 20] = 49407
    images = torch.rand(6, 3, 224, 224, generator=gen)
    targets = torch.randint(0, 7, (6,), generator=gen)
    init_state, step, frozen = make_stage1_step(params, cfg, spec, banks, adamw(1e-3),
                                                device=cuda)
    outs = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(at, "packed_attention", at.packed_attention_plain)
        state, m = step(frozen, init_state(lora), images, targets, 1,
                        torch.Generator(device=cuda).manual_seed(3))
        state, m = step(frozen, state, images, targets, 0,
                        torch.Generator(device=cuda).manual_seed(4))
        outs.append((float(m["loss"]), {t: {k: v.detach().cpu() for k, v in d.items()}
                                        for t, d in state.lora.items()}))
    (loss_k, lora_k), (loss_p, lora_p) = outs
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    for t in lora_k:
        for k in lora_k[t]:
            assert float((lora_k[t][k] - lora_p[t][k]).abs().max()) <= 1e-5, (t, k)


def test_wrappers_raise_instead_of_falling_back(cuda):
    images = torch.rand(1, 3, 64, 64, device=cuda)  # f32: int8 pixels take bf16
    cy = torch.zeros(1, 2, 32, device=cuda)
    inv = torch.ones(1, 2, 2, device=cuda)
    with pytest.raises(TypeError):
        vk.fused_views_nchw(images, cy, cy, inv, 32, quantize=True)
    with pytest.raises(ValueError):  # S = 128: the dense rows stop at 127
        bk.attention(torch.zeros(128, 3 * 128, device=cuda).bfloat16(),
                     torch.ones(1, device=cuda), 128, 2)
    with pytest.raises(ValueError):  # f16 rows: the kernel takes bf16 or f32
        bk.causal_attention(torch.zeros(77, 3 * 128, device=cuda).half(), 77, 2)
    with pytest.raises(ValueError):  # head dim 32: the kernel takes 64
        bk.cls_attention(torch.zeros(2, 64, device=cuda).bfloat16(),
                         torch.zeros(100, 128, device=cuda).bfloat16(),
                         torch.ones(1, device=cuda), 50, 2)
    # K7's C entries refuse what its tiles cannot hold
    before = dict(at.LAUNCHES)
    with pytest.raises(RuntimeError):  # S = 128, D = 128: over the shared memory
        at.packed_attention_bwd(torch.zeros(1, 128, 3 * 128, device=cuda), 1,
                                torch.zeros(128, 128, device=cuda),
                                torch.zeros(1, 128, 128, device=cuda))
    with pytest.raises(RuntimeError):  # S = 129: a lane holds 4 keys of a row
        at.packed_attention_fwd(torch.zeros(1, 129, 3 * 128, device=cuda), 2,
                                torch.zeros(129, 129, device=cuda))
    assert at.LAUNCHES == before
    # the refusals leave no error behind for the next launch
    at.packed_attention_fwd(torch.zeros(1, 50, 3 * 128, device=cuda), 2,
                            torch.zeros(50, 50, device=cuda))
    with pytest.raises(ValueError):  # f16: the kernels take f32 or bf16
        at.packed_attention_fwd(torch.zeros(1, 50, 3 * 128, device=cuda).half(), 2,
                                torch.zeros(50, 50, device=cuda))
    with pytest.raises(ValueError):  # K % 8 != 0
        bg.bf16_gemm_bias(torch.zeros(4, 12, device=cuda).bfloat16(),
                          torch.zeros(8, 12, device=cuda).bfloat16(), torch.zeros(8, device=cuda))
    # the refused calls launched nothing
    before = dict(bk.LAUNCHES)
    with pytest.raises(ValueError):
        bk.ln_quant(torch.zeros(4, 2048, device=cuda).bfloat16(), torch.ones(1, device=cuda))
    assert bk.LAUNCHES == before


def test_launch_counters(cuda):
    x = torch.randn(100, 768, device=cuda).bfloat16()
    n = bk.LAUNCHES["ln_quant"]
    bk.ln_quant(x, torch.ones(1, device=cuda))
    bk.ln_quant(x.cpu(), torch.ones(1))  # the plain version: not a launch
    assert bk.LAUNCHES["ln_quant"] == n + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [12, 16])
@pytest.mark.parametrize("s,causal", [(50, True), (145, False), (197, False), (257, False),
                                      (577, False)])
def test_blocked_attention_kernel(cuda, dtype, h, s, causal):
    """K8 vs ``attention_plain`` on head views of a packed qkv (the layout
    the tower gives it, unit-scale entries as a LayerNorm'd row through a
    unit-variance projection gives): f32 within 1e-5 (+ 1e-5 relative),
    bf16 within 1 bf16 ulp + 1e-3. (On peakier rows a p that rounds to
    bf16 on the other side of a tie moves the output by an ulp of p times
    |v|, which can exceed an ulp of a small output.)"""
    g = torch.Generator(device=cuda).manual_seed(s + h)
    b, e = 3, h * 64
    qkv = torch.randn(b, s, 3 * e, device=cuda, generator=g).to(dtype)
    q, k, v = qkv.reshape(b, s, 3, h, 64).permute(2, 0, 3, 1, 4)
    bias = at.causal_mask(s, cuda) if causal else None
    got = at.fused_attention(q, k, v, bias)
    assert got.dtype == dtype and got.shape == (b, h, s, 64)
    close = _f32_close if dtype == torch.float32 else _bf16_close
    close(got.float(), at.attention_plain(q, k, v, bias).float())


def test_blocked_attention_refuses_over_its_limit(cuda):
    """S = 1024: the score tile is over the card's shared memory. The C
    entry refuses, nothing launches, and the next launch runs."""
    before = at.LAUNCHES["blocked_attention"]
    q = torch.zeros(1, 2, 1024, 64, device=cuda)
    with pytest.raises(RuntimeError):
        at.fused_attention(q, q, q)
    assert at.LAUNCHES["blocked_attention"] == before
    q = torch.randn(1, 2, 197, 64, device=cuda)
    _f32_close(at.fused_attention(q, q, q), at.attention_plain(q, q, q))
    assert at.LAUNCHES["blocked_attention"] == before + 1
    with pytest.raises(ValueError):  # head dim 32: the kernel takes 64
        at.fused_attention(*(torch.zeros(1, 2, 200, 32, device=cuda),) * 3)


@pytest.mark.parametrize("m,n,k", [(200, 72, 96), (197 * 3, 2304, 768), (77, 768, 3072)])
def test_int8_gemm_rowscale(cuda, m, n, k):
    g = torch.Generator(device=cuda).manual_seed(m + n + k)
    a = torch.randint(-127, 128, (m, k), device=cuda, generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), device=cuda, generator=g, dtype=torch.int8)
    row_scale = torch.rand(m, device=cuda, generator=g) * 0.05
    scale = torch.rand(n, device=cuda, generator=g) * 2e-4
    bias = torch.randn(n, device=cuda, generator=g) * 0.1
    _bf16_close(ig.int8_gemm_rowscale(a, w, row_scale, scale, bias),
                ig.rowscale_plain(ig.int8_matmul_plain(a, w), row_scale, scale, bias).bfloat16())


def test_b16_int8_engine_launches_and_matches_plain(cuda):
    """A 2-layer ViT-B/16 int8 engine (full width, 197 tokens) at 2 images
    x 4 views: one K1, one s32 patch GEMM, 2 K8 and 8 row-scale GEMMs, no
    other kernel; its modes match the same engine's plain versions on the
    CPU (min cos >= 0.999)."""
    from jcf_tpu_torch.infer.engine import TTAEngine
    from jcf_tpu_torch.ops.quant import quantize_rows

    cfg = CLIPConfig(vision_patch_size=16, vision_layers=2)
    params = init_clip_params(0, cfg)
    gen = torch.Generator().manual_seed(0)
    images = torch.rand(2, 3, 256, 256, generator=gen).bfloat16()
    text = torch.nn.functional.normalize(torch.randn(10, 512, generator=gen), dim=-1)
    cpu = TTAEngine(params, cfg, device="cpu", n_views=3)
    geometry = cpu.sample_geometry(gen, 2, (256, 256))
    counters = [vk.LAUNCHES, ig.LAUNCHES, ak.LAUNCHES, bk.LAUNCHES, bg.LAUNCHES, at.LAUNCHES]
    for c in counters:
        c.update(dict.fromkeys(c, 0))
    got = TTAEngine(params, cfg, device=cuda, n_views=3).features_from_images(
        images.to(cuda), text.to(cuda), geometry=tuple(t.to(cuda) for t in geometry))
    torch.cuda.synchronize()
    launches = {k: v for c in counters for k, v in c.items() if v}
    assert launches == {"view": 1, "int8_gemm_s32": 1, "blocked_attention": 2,
                        "int8_gemm_rowscale": 8}, launches
    ref = cpu.features_from_images(images, text, geometry=geometry)
    cos = torch.nn.functional.cosine_similarity(got.cpu(), ref)
    assert float(cos.min()) >= 0.999
    # the row quantization is plain PyTorch on both devices: equal rows
    x = torch.randn(50, 768, generator=gen)
    for dev_out, cpu_out in zip(quantize_rows(x.to(cuda)), quantize_rows(x)):
        assert torch.equal(dev_out.cpu(), cpu_out)


def _int8_tree(width, layers=2):
    from jcf_tpu_torch.ops.quant import quantize_clip_params

    params = init_clip_params(0, CLIPConfig(vision_layers=layers, vision_width=width))
    amax = torch.tensor([[6.0, 6.0, 3.0, 4.0]] * layers)
    return quantize_clip_params(params, fold=True, heads={"visual": width // 64},
                                act_scales={"visual": amax})["visual"]


def _rows_close(got, ref):
    """Layer outputs: min row cos >= 0.999 and |diff| <= 0.05 + 0.05 |ref|
    (int8 values flip at ties where the sums run in another order)."""
    g, r = got.float(), ref.float()
    assert float(torch.nn.functional.cosine_similarity(g, r).min()) >= 0.999
    assert bool(((g - r).abs() <= 0.05 + 0.05 * r.abs()).all())


@pytest.mark.parametrize("width,s,crops,nsplit", [
    (128, 50, 1, (1, 4)), (128, 17, 3, (2, 3)), (768, 50, 3, (1, 4)), (768, 17, 1, (2, 2))])
def test_fused_int8_layer_kernels(cuda, monkeypatch, width, s, crops, nsplit):
    """K9a, K9d and K9c vs their plain versions, with (_MLP_NSPLIT,
    _LAYER_NSPLIT) chunk counts (3 does not divide the hidden width: one
    chunk)."""
    monkeypatch.setattr(bk, "_MLP_NSPLIT", nsplit[0])
    monkeypatch.setattr(bk, "_LAYER_NSPLIT", nsplit[1])
    tree = tree_to(_int8_tree(width), cuda)
    layer, h = layer_slice(tree, 1), width // 64
    x = torch.randn(crops * s, width, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(s)).bfloat16()
    before = dict(bk.LAUNCHES)
    _rows_close(bk.block_int8(x, layer, s, h), bk.block_int8_plain(x, layer, s, h))
    _rows_close(bk.layer_fused_int8(x, layer, s, h), bk.layer_fused_int8_plain(x, layer, s, h))
    _rows_close(bk.stream_tower_int8(x, tree, h, s=s), bk.stream_tower_int8_plain(x, tree, h, s=s))
    assert {k: bk.LAUNCHES[k] - before[k] for k in before if bk.LAUNCHES[k] != before[k]} == {
        "block_int8": 1, "layer_fused_int8": 1, "stream_tower_int8": 1}


@pytest.mark.parametrize("width,s,seqs,causal", [
    (512, 77, 3, True), (128, 77, 1, False), (128, 17, 3, True), (768, 50, 5, False)])
def test_block_bf16_kernel(cuda, width, s, seqs, causal):
    """K9b vs its plain version, with the causal mask or a zero bias; at
    768 wide (the float vision tower) through its global scratch."""
    cfg = CLIPConfig(text_layers=1, text_width=width, text_heads=width // 64)
    layer = layer_slice(tree_to(init_clip_params(0, cfg)["text"]["blocks"], cuda), 0)
    x = torch.randn(seqs * s, width, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(s)).bfloat16()
    bias = at.causal_mask(s, cuda) if causal else torch.zeros(s, s, device=cuda)
    h = width // 64
    _rows_close(bk.block_bf16(x, layer, s, h, bias), bk.block_bf16_plain(x, layer, s, h, bias))


def test_fused_routes_launch_the_kernels(cuda, monkeypatch):
    """Each _FUSE route of both towers launches its kernel on every layer
    it covers and no K3 attention, K6 row kernel or bf16 GEMM, and agrees
    with the same route from the plain versions on the CPU."""
    tree = _int8_tree(128, layers=3)
    x = torch.randn(4 * 50, 128, generator=torch.Generator().manual_seed(1)).bfloat16()
    for fuse, name, n in (("block", "block_int8", 2), ("layer", "layer_fused_int8", 2),
                          ("stream", "stream_tower_int8", 1)):
        monkeypatch.setattr(bk, "_FUSE", fuse)
        ref = bk.run_fused_tower(x, tree, 2, flat_s=50)
        before = dict(bk.LAUNCHES)
        got = bk.run_fused_tower(x.to(cuda), tree_to(tree, cuda), 2, flat_s=50)
        assert got.shape == (4, 128)
        assert bk.LAUNCHES[name] - before[name] == n and bk.LAUNCHES["attention"] == before["attention"]
        _rows_close(got.cpu(), ref)
    cfg = CLIPConfig(text_layers=2, text_width=128, text_heads=2)
    blocks = init_clip_params(0, cfg)["text"]["blocks"]
    xt = torch.randn(3 * 77, 128, generator=torch.Generator().manual_seed(2)).bfloat16()
    monkeypatch.setattr(bk, "_FUSE", "block")
    ref = bk.run_float_tower(xt, blocks, 2, s=77, causal=True)
    before, before_g = dict(bk.LAUNCHES), dict(bg.LAUNCHES)
    got = bk.run_float_tower(xt.to(cuda), tree_to(blocks, cuda), 2, s=77, causal=True)
    assert bk.LAUNCHES["block_bf16"] - before["block_bf16"] == 2 and bg.LAUNCHES == before_g
    assert all(bk.LAUNCHES[k] == before[k] for k in ("ln_affine", "causal_attention"))
    _rows_close(got.cpu(), ref)


def test_fused_layer_wrappers_refuse(cuda, monkeypatch):
    """The K9 wrappers raise on trees, shapes and types their kernels do
    not take, launching nothing: a tree not marked folded (the unfolded
    tree's K9a/c/d are not ported: ``NotImplementedError``), S > 64; for
    K9b f32 rows, S > 80, a bias of the wrong shape. The C entries refuse
    a flag set off the folded dense route (masked, non-dense, unfolded)
    themselves. Every static-option subset of the folded tree runs
    (``tests/test_torch_gpu_predict.py``)."""
    tree = tree_to(_int8_tree(128), cuda)
    layer = layer_slice(tree, 0)
    x = torch.randn(2 * 50, 128, device=cuda).bfloat16()
    unmarked = {"attn": layer["attn"], "mlp": layer["mlp"]}
    stacked_unmarked = {"attn": tree["attn"], "mlp": tree["mlp"]}
    text = layer_slice(tree_to(init_clip_params(0, CLIPConfig(
        text_layers=1, text_width=128, text_heads=2))["text"]["blocks"], cuda), 0)
    before = dict(bk.LAUNCHES)
    for fn in (bk.block_int8, bk.layer_fused_int8):
        with pytest.raises(NotImplementedError):
            fn(x, unmarked, 50, 2)
        with pytest.raises(ValueError):  # S = 100 > 64
            fn(x, layer, 100, 2)
    with pytest.raises(NotImplementedError):
        bk.stream_tower_int8(x, stacked_unmarked, 2, s=50)
    with pytest.raises(ValueError):  # f32 rows
        bk.block_bf16(x.float(), text, 50, 2, at.causal_mask(50, cuda))
    with pytest.raises(ValueError):  # S = 100 > 80
        bk.block_bf16(x, text, 100, 2, at.causal_mask(100, cuda))
    with pytest.raises(ValueError):  # a bias of the wrong shape
        bk.block_bf16(x, text, 50, 2, at.causal_mask(49, cuda))
    assert bk.LAUNCHES == before
    flags = bk.quant_flags(layer)
    for bad in (flags | bk.FLAG_USE_MASK, flags & ~bk.FLAG_DENSE, flags & ~bk.FLAG_FOLDED):
        monkeypatch.setattr(bk, "quant_flags", lambda tree, bad=bad: bad)
        for fn in (bk.block_int8, bk.layer_fused_int8):
            with pytest.raises(RuntimeError):
                fn(x, layer, 50, 2)
        with pytest.raises(RuntimeError):
            bk.stream_tower_int8(x, tree, 2, s=50)
    monkeypatch.undo()
    assert bk.LAUNCHES == before
    bk.block_int8(x, layer, 50, 2)  # the refusals leave no error behind
    assert bk.LAUNCHES["block_int8"] == before["block_int8"] + 1


# ---------------------------------------------------------------------------
# the dynamic and partial static modes, and 65 to 127 tokens
# ---------------------------------------------------------------------------


def _mode_tree(mode):
    """A 2-layer full-width folded tree in one of the engine's modes: None
    (dynamic), or "<base>[+score]" with fixed amax (shifts of 3 and 4)."""
    from jcf_tpu_torch.infer.engine import static_act
    from jcf_tpu_torch.ops.quant import quantize_clip_params

    params = init_clip_params(0, CLIPConfig(vision_layers=2))
    if mode is None:
        return quantize_clip_params(params, fold=True, heads={"visual": 12})["visual"]
    act_static, _ = static_act(mode)
    amax = torch.tensor([[6.0, 6.0, 3.0, 4.0, 43.0, -5.0], [6.0, 6.0, 3.0, 4.0, 44.0, -5.0]])
    return quantize_clip_params(params, fold=True, heads={"visual": 12}, act_scales={"visual": amax},
                                act_static=act_static)["visual"]


@pytest.mark.parametrize("m,e", [(700, 768), (333, 3072), (50, 128)])
def test_row_quant_kernels(cuda, m, e):
    """LN + dynamic row quant (bf16 rows) and the row quant of f32 rows,
    with and without QuickGELU, all-zero rows included: int8 within 1 on
    <= 1e-3 of the elements, scales within 1e-6 relative."""
    g = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn(m, e, device=cuda, generator=g) * 3
    x[7] = 0.0
    xb = x[:, :768].bfloat16()  # LayerNorm rows: E <= 1024
    before = dict(bk.LAUNCHES)
    for (q, s), (q_ref, s_ref) in (
            (bk.ln_quant_rows(xb), bk.ln_quant_rows_plain(xb)),
            (bk.quant_rows(x), bk.quant_rows_plain(x)),
            (bk.quant_rows(x, gelu=True), bk.gelu_quant_rows_plain(x))):
        _int8_close(q, q_ref, 1e-3)
        assert bool(((s - s_ref).abs() <= 1e-6 * s_ref.abs()).all())
    assert {k: bk.LAUNCHES[k] - before[k] for k in before if bk.LAUNCHES[k] != before[k]} == {
        "ln_quant_rows": 1, "quant_rows": 1, "gelu_quant_rows": 1}


@pytest.mark.parametrize("m,n,k", [(200, 72, 96), (77, 2304, 768), (130, 768, 3072)])
def test_int8_gemm_row_epilogues(cuda, m, n, k):
    """The fused tower's row-scale epilogues, ``(acc * scale) * row +
    bias``: to bf16, + a bf16 residual, to f32; and the f32 one without
    rows."""
    g = torch.Generator(device=cuda).manual_seed(m + n + k)
    a = torch.randint(-127, 128, (m, k), device=cuda, generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), device=cuda, generator=g, dtype=torch.int8)
    rows = torch.rand(m, device=cuda, generator=g) * 0.05
    scale = torch.rand(n, device=cuda, generator=g) * 2e-4
    bias = torch.randn(n, device=cuda, generator=g) * 0.1
    resid = torch.randn(m, n, device=cuda, generator=g).bfloat16()
    acc = ig.int8_matmul_plain(a, w)
    _bf16_close(ig.int8_gemm_bf16(a, w, scale, bias, row_scale=rows),
                ig.dequant_plain(acc, scale, bias, rows).bfloat16())
    _bf16_close(ig.int8_gemm_residual(a, w, scale, bias, resid, row_scale=rows),
                (resid.float() + ig.dequant_plain(acc, scale, bias, rows)).bfloat16())
    _f32_close(ig.int8_gemm_f32(a, w, scale, bias, row_scale=rows),
               ig.dequant_plain(acc, scale, bias, rows))
    _f32_close(ig.int8_gemm_f32(a, w, scale, bias), ig.dequant_plain(acc, scale, bias))


def _ctx_slack(qkv, s, h, shift):
    """2^-7 sum_j p_j |v_j| / l: how far a p that rounds to bf16 on the
    other side of a tie can move an f32 context element."""
    e = qkv.shape[1] // 3
    absv = torch.cat([qkv[:, : 2 * e], qkv[:, 2 * e :].abs()], dim=1)
    return 2.0**-7 * bk.attention_plain(absv, None, s, h, shift)


@pytest.mark.parametrize("shift", [None, 1.5])
@pytest.mark.parametrize("s", [50, 82, 127])
def test_attention_kernel_modes(cuda, s, shift):
    """K3's attention at S up to 127: the static int8 context and the f32
    context of a dynamic one, with the pair max or a calibrated shift."""
    g = torch.Generator(device=cuda).manual_seed(s)
    h, crops = 12, 9
    qkv = (torch.randn(crops * s, 3 * h * 64, device=cuda, generator=g) * 0.5).bfloat16()
    sh = None if shift is None else torch.tensor([[shift]], device=cuda)
    ctx_inv = torch.tensor([[30.0]], device=cuda)
    _int8_close(bk.attention(qkv, ctx_inv, s, h, sh), bk.attention_plain(qkv, ctx_inv, s, h, sh),
                1e-2)
    got, ref = bk.attention(qkv, None, s, h, sh), bk.attention_plain(qkv, None, s, h, sh)
    assert got.dtype == torch.float32
    assert bool(((got - ref).abs() <= 1e-5 + 1e-5 * ref.abs() + _ctx_slack(qkv, s, h, sh)).all())


@pytest.mark.parametrize("shift", [None, 1.5])
def test_cls_attention_kernel_modes(cuda, shift):
    """K5's attention: the f32 context of a dynamic ctx, and the shift."""
    g = torch.Generator(device=cuda).manual_seed(5)
    h, crops, s = 12, 37, 50
    q = (torch.randn(crops, h * 64, device=cuda, generator=g) * 0.5).bfloat16()
    kv = (torch.randn(crops * s, 2 * h * 64, device=cuda, generator=g) * 0.5).bfloat16()
    sh = None if shift is None else torch.tensor([[shift]], device=cuda)
    ctx_inv = torch.tensor([[30.0]], device=cuda)
    _int8_close(bk.cls_attention(q, kv, ctx_inv, s, h, sh),
                bk.cls_attention_plain(q, kv, ctx_inv, s, h, sh), 1e-2)
    got, ref = bk.cls_attention(q, kv, None, s, h, sh), bk.cls_attention_plain(q, kv, None, s, h, sh)
    slack = 2.0**-7 * bk.cls_attention_plain(q, torch.cat([kv[:, : h * 64], kv[:, h * 64 :].abs()], 1),
                                             None, s, h, sh)
    assert bool(((got - ref).abs() <= 1e-5 + 1e-5 * ref.abs() + slack).all())


@pytest.mark.parametrize("s", [50, 82])
@pytest.mark.parametrize("mode", [None, "ln", "hidden", "full+score"])
def test_tower_kernels_vs_plain_modes(cuda, mode, s):
    """A 2-layer full-width tower in each mode, the CLS rows and every
    row: the kernel route vs the plain versions on the CPU (row cos >=
    0.999); at 82 tokens no K5 launch."""
    tree = _mode_tree(mode)
    x = torch.randn(12 * s, 768, generator=torch.Generator().manual_seed(s)).bfloat16()
    tree_gpu = tree_to(tree, cuda)
    for cls_only in (True, False):
        ref = bk.run_fused_tower(x, tree, 12, flat_s=s, cls_only=cls_only)
        before = dict(bk.LAUNCHES)
        got = bk.run_fused_tower(x.to(cuda), tree_gpu, 12, flat_s=s, cls_only=cls_only).cpu()
        k5 = sum(bk.LAUNCHES[k] - before[k] for k in ("cls_attention", "cls_attention_f32"))
        assert k5 == (1 if cls_only and s <= 64 else 0)
        cos = torch.nn.functional.cosine_similarity(got.float(), ref.float())
        assert got.shape == ref.shape and float(cos.min()) >= 0.999


def test_features_from_crops_on_the_card(cuda):
    """A 2-layer dynamic int8 engine (no calibration): crop features and
    modes on the card vs the CPU's plain versions (cos >= 0.999), and the
    modes equal to ``mta_from_features(crop_features)``."""
    from jcf_tpu_torch.infer.engine import TTAEngine

    cfg = CLIPConfig(vision_layers=2)
    params = init_clip_params(0, cfg)
    gen = torch.Generator().manual_seed(0)
    crops = torch.randn(2, 5, 3, 224, 224, generator=gen)
    text = torch.nn.functional.normalize(torch.randn(10, 512, generator=gen), dim=-1)
    cpu = TTAEngine(params, cfg, device="cpu")
    card = TTAEngine(params, cfg, device=cuda)
    before = dict(bk.LAUNCHES)
    feats = card.crop_features(crops)
    assert bk.LAUNCHES["attention_f32"] - before["attention_f32"] == 2
    assert bk.LAUNCHES["cls_attention_f32"] == before["cls_attention_f32"]
    cos = torch.nn.functional.cosine_similarity(feats.cpu(), cpu.crop_features(crops), dim=-1)
    assert float(cos.min()) >= 0.999
    modes = card.features_from_crops(crops, text)
    assert torch.equal(modes, card.mta_from_features(feats, text))
    cos = torch.nn.functional.cosine_similarity(modes.cpu(), cpu.features_from_crops(crops, text))
    assert float(cos.min()) >= 0.999


# ---------------------------------------------------------------------------
# the unquantized towers: K1's float views, the f32 GEMMs, f32 LN and
# causal attention, the mask-free pair attention in bf16 and f32
# ---------------------------------------------------------------------------


def _f32_close(got, ref, slack=None):
    """f32: within 1e-5 + 1e-5 |ref| (+ ``slack``, per element)."""
    tol = 1e-5 + 1e-5 * ref.abs() + (0.0 if slack is None else slack)
    assert bool(((got - ref).abs() <= tol).all()) and bool(got.isfinite().all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_view_kernel_float(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(5)
    images = torch.rand(5, 3, 80, 72, device=cuda, generator=gen).to(dtype)
    cy, cx, inv = vk.sample_view_centers(gen, 5, 6, (80, 72), 48)
    before = dict(vk.LAUNCHES)
    got = vk.fused_views_nchw(images, cy, cx, inv, 48)
    ref = vk.fused_views_nchw_plain(images, cy, cx, inv, 48)
    name = "view_f32" if dtype == torch.float32 else "view_bf16"
    assert got.dtype == dtype and vk.LAUNCHES[name] == before[name] + 1
    (_f32_close if dtype == torch.float32 else _bf16_close)(got, ref)


@pytest.mark.parametrize("m,n,k", [(200, 72, 96), (128, 128, 64), (77, 24, 3072), (5, 132, 12)])
def test_f32_gemm_epilogues(cuda, m, n, k):
    """Each epilogue vs its plain version: the same f32 sums in another
    order, within 1e-5 + 1e-5 |ref| + 1e-6 sum_k |a w| (the worst case of
    K-term f32 sums is K u sum |a w|; 1e-6 is far above the typical)."""
    from jcf_tpu_torch.ops import f32_gemm as fg

    g = torch.Generator(device=cuda).manual_seed(m + n + k)
    a = torch.randn(m, k, device=cuda, generator=g)
    w = torch.randn(n, k, device=cuda, generator=g) * k**-0.5
    bias = torch.randn(n, device=cuda, generator=g) * 0.1
    resid = torch.randn(m, n, device=cuda, generator=g)
    slack = 1e-6 * torch.matmul(a.abs(), w.abs().T)
    _f32_close(fg.f32_gemm_bias(a, w, bias), fg.f32_gemm_bias_plain(a, w, bias), slack)
    _f32_close(fg.f32_gemm_residual(a, w, bias, resid),
               fg.f32_gemm_residual_plain(a, w, bias, resid), slack)
    _f32_close(fg.f32_gemm_gelu(a, w, bias), fg.f32_gemm_gelu_plain(a, w, bias), slack)


def test_ln_affine_and_causal_attention_f32(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    s, h, d, seqs = 77, 8, 64, 9
    x = torch.randn(seqs * s, h * d, device=cuda, generator=g)
    scale = 1 + 0.1 * torch.randn(h * d, device=cuda, generator=g)
    bias = 0.1 * torch.randn(h * d, device=cuda, generator=g)
    before = dict(bk.LAUNCHES)
    _f32_close(bk.ln_affine(x, scale, bias), bk.ln_affine_plain(x, scale, bias))
    qkv = torch.randn(seqs * s, 3 * h * d, device=cuda, generator=g)
    _f32_close(bk.causal_attention(qkv, s, h), bk.causal_attention_plain(qkv, s, h))
    assert bk.LAUNCHES["ln_affine_f32"] == before["ln_affine_f32"] + 1
    assert bk.LAUNCHES["causal_attention_f32"] == before["causal_attention_f32"] + 1
    assert bk.LAUNCHES["causal_attention"] == before["causal_attention"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,h", [(50, 12), (56, 4), (82, 12), (127, 2)])
def test_pair_attention_kernel(cuda, dtype, s, h):
    """The mask-free attention vs its plain version: f32 within 1e-5 +
    1e-5 |ref|; bf16 within one ulp + 1e-3 plus 2^-7 sum_j p_j |v_j| / l
    (how far a p that rounds to bf16 across a tie moves an element)."""
    g = torch.Generator(device=cuda).manual_seed(s + h)
    crops, d = 7, 64
    qkv = (torch.randn(crops * s, 3 * h * d, device=cuda, generator=g) * 0.5).to(dtype)
    before = dict(bk.LAUNCHES)
    got = bk.pair_attention(qkv, s, h)
    ref = bk.pair_attention_plain(qkv, s, h)
    name = "pair_attention_f32" if dtype == torch.float32 else "pair_attention_bf16"
    assert got.dtype == dtype and bk.LAUNCHES[name] == before[name] + 1
    if dtype == torch.float32:
        _f32_close(got, ref)
    else:
        v = qkv.float()[:, 2 * h * d :].abs().to(dtype)
        slack = 2.0**-7 * bk.pair_attention_plain(torch.cat([qkv[:, : 2 * h * d], v], 1), s, h).float()
        d_ = (got.float() - ref.float()).abs()
        tol = 2.0**-7 * got.float().abs().maximum(ref.float().abs()) + 1e-3 + slack
        assert bool((d_ <= tol).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [False, True])
def test_float_tower_kernels_vs_plain(cuda, dtype, causal):
    """A 2-layer full-width float tower (ViT-B/32's vision tower at S = 50
    mask-free, its text tower at 77 causal): the kernels vs the plain
    versions on the CPU; 7 launches a layer, nothing of K7."""
    cfg = CLIPConfig(vision_layers=2, text_layers=2)
    p = init_clip_params(0, cfg)
    blocks, s, h, e = ((p["text"]["blocks"], 77, 8, 512) if causal
                       else (p["visual"]["blocks"], 50, 12, 768))
    from jcf_tpu_torch.ops import f32_gemm as fg

    x = torch.randn(6 * s, e, generator=torch.Generator().manual_seed(1)).to(dtype)
    ref = bk.run_float_tower(x, blocks, h, s=s, causal=causal)
    counts = (bk.LAUNCHES, at.LAUNCHES, bg.LAUNCHES, fg.LAUNCHES)
    before = {k: v for c in counts for k, v in c.items()}
    got = bk.run_float_tower(x.to(cuda), tree_to(blocks, cuda), h, s=s, causal=causal).cpu()
    after = {k: v for c in counts for k, v in c.items()}
    launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert sum(launched.values()) == 2 * 7 and "packed_attention" not in launched
    cos = torch.nn.functional.cosine_similarity(got.float(), ref.float())
    assert float(cos.min()) >= (0.99999 if dtype == torch.float32 else 0.999)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_unquantized_engine_on_the_card(cuda, dtype):
    """A 2-layer unquantized engine: K1 in the compute dtype, the float
    tower on every row, modes vs the CPU's plain versions (cos >= 0.999);
    the f32 engine refuses TF32."""
    from jcf_tpu_torch.infer.engine import TTAEngine

    cfg = CLIPConfig(vision_layers=2)
    params = init_clip_params(0, cfg)
    gen = torch.Generator().manual_seed(0)
    images = torch.rand(3, 3, 256, 256, generator=gen)
    text = torch.nn.functional.normalize(torch.randn(10, 512, generator=gen), dim=-1)
    cpu = TTAEngine(params, cfg, device="cpu", quant=None, dtype=dtype, n_views=3)
    card = TTAEngine(params, cfg, device=cuda, quant=None, dtype=dtype, n_views=3)
    geo = cpu.sample_geometry(torch.Generator().manual_seed(1), 3, (256, 256))
    before = dict(vk.LAUNCHES)
    modes = card.features_from_images(images.to(cuda), text, geometry=geo)
    name = "view_f32" if dtype == torch.float32 else "view_bf16"
    assert vk.LAUNCHES[name] == before[name] + 1
    cos = torch.nn.functional.cosine_similarity(modes.cpu(), cpu.features_from_images(images, text, geometry=geo))
    assert float(cos.min()) >= 0.999
    if dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            with pytest.raises(RuntimeError, match="allow_tf32"):
                card.features_from_images(images.to(cuda), text, geometry=geo)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False


# ---------------------------------------------------------------------------
# the masked and unfolded int8 halves: kernel A (LN + its affine + row
# quant), kernel B (masked attention), kernel C (f32 residual epilogues),
# K3 / K5 attention with the unfolded score scale
# ---------------------------------------------------------------------------


def _launched(before):
    return {k: bk.LAUNCHES[k] - before[k] for k in before if bk.LAUNCHES[k] != before[k]}


@pytest.mark.parametrize("m,e,dtype", [(700, 768, torch.bfloat16), (333, 512, torch.float32),
                                       (77, 192, torch.bfloat16)])
def test_ln_affine_quant_rows_kernel(cuda, m, e, dtype):
    """Kernel A vs its plain version: int8 within 1 on <= 1e-3 of the
    elements (the f32 statistics sum in another order), scales within
    1e-6 relative; the f32 rows' z-norm variants as well."""
    g = torch.Generator(device=cuda).manual_seed(m + e)
    x = (torch.randn(m, e, device=cuda, generator=g) * 3).to(dtype)
    x[5] = 0.0
    scale = (1 + 0.1 * torch.randn(e, device=cuda, generator=g)).to(dtype)
    bias = (0.1 * torch.randn(e, device=cuda, generator=g)).to(dtype)
    before = dict(bk.LAUNCHES)
    pairs = [(bk.ln_affine_quant_rows(x, scale, bias), bk.ln_affine_quant_rows_plain(x, scale, bias)),
             (bk.ln_quant_rows(x), bk.ln_quant_rows_plain(x))]
    for (q, s), (q_ref, s_ref) in pairs:
        _int8_close(q, q_ref, 1e-3)
        assert bool(((s - s_ref).abs() <= 1e-6 * s_ref.abs()).all())
    inv = torch.tensor([[20.0]], device=cuda)
    _int8_close(bk.ln_quant(x, inv), bk.ln_quant_plain(x, inv), 1e-3)
    sfx = "_f32" if dtype == torch.float32 else ""
    assert _launched(before) == {f"ln_affine_quant_rows{sfx}": 1, f"ln_quant_rows{sfx}": 1,
                                 f"ln_quant{sfx}": 1}


@pytest.mark.parametrize("s,h,causal", [(77, 8, True), (17, 3, False), (50, 1, False)])
@pytest.mark.parametrize("scaled", [True, False])
def test_masked_attention_kernel(cuda, s, h, causal, scaled):
    """Kernel B vs its plain version on bf16 qkv: the f32 context within
    1e-5 + 1e-5 |ref| + 2^-7 sum_j p_j |v_j| (a p rounding to bf16 across
    a tie), the int8 context within 1 on <= 1e-2; the float halves'
    variants (bf16 within 1 ulp + 1e-3 + that slack, f32 within 1e-5)."""
    g = torch.Generator(device=cuda).manual_seed(s + h)
    e, seqs = 64 * h, 23
    qkv = (torch.randn(seqs * s, 3 * e, device=cuda, generator=g) * 1.5).bfloat16()
    sc = 0.125 if scaled else None
    kw = dict(causal=causal, scale=sc)
    absv = torch.cat([qkv[:, : 2 * e], qkv[:, 2 * e :].abs()], dim=1)
    slack = 2.0**-7 * bk.masked_attention_plain(absv, s, h, f32_ctx=True, **kw)
    before = dict(bk.LAUNCHES)
    got = bk.masked_attention(qkv, s, h, f32_ctx=True, **kw)
    ref = bk.masked_attention_plain(qkv, s, h, f32_ctx=True, **kw)
    assert got.dtype == torch.float32
    assert bool(((got - ref).abs() <= 1e-5 + 1e-5 * ref.abs() + slack).all())
    ctx_inv = torch.tensor([[30.0]], device=cuda)
    _int8_close(bk.masked_attention(qkv, s, h, ctx_inv=ctx_inv, **kw),
                bk.masked_attention_plain(qkv, s, h, ctx_inv=ctx_inv, **kw), 1e-2)
    got, ref = bk.masked_attention(qkv, s, h, **kw), bk.masked_attention_plain(qkv, s, h, **kw)
    d = (got.float() - ref.float()).abs()
    assert bool((d <= 2.0**-7 * ref.float().abs().maximum(got.float().abs()) + 1e-3 + slack).all())
    q32 = qkv.float()
    _f32_close(bk.masked_attention(q32, s, h, **kw), bk.masked_attention_plain(q32, s, h, **kw))
    name = "causal_attention" if causal else "head_attention"
    assert _launched(before) == {"masked_attention_f32": 1, "masked_attention": 1, name: 1,
                                 f"{name}_f32": 1}


@pytest.mark.parametrize("m,n,k", [(200, 72, 96), (77, 512, 2048), (130, 768, 3072)])
def test_int8_gemm_f32_residual_epilogues(cuda, m, n, k):
    """Kernel C: the f32 residual epilogues with and without row scales,
    in the fused tower's op order, within 1e-5 + 1e-5 |ref|."""
    g = torch.Generator(device=cuda).manual_seed(m + n)
    a = torch.randint(-127, 128, (m, k), device=cuda, generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), device=cuda, generator=g, dtype=torch.int8)
    rows = torch.rand(m, device=cuda, generator=g) * 0.05
    scale = torch.rand(n, device=cuda, generator=g) * 2e-4
    bias = torch.randn(n, device=cuda, generator=g) * 0.1
    resid = torch.randn(m, n, device=cuda, generator=g)
    acc = ig.int8_matmul_plain(a, w)
    before = dict(ig.LAUNCHES)
    got = ig.int8_gemm_residual(a, w, scale, bias, resid, row_scale=rows)
    assert got.dtype == torch.float32
    _f32_close(got, resid + ig.dequant_plain(acc, scale, bias, rows))
    _f32_close(ig.int8_gemm_residual(a, w, scale, bias, resid),
               resid + ig.dequant_plain(acc, scale, bias))
    assert {k_: ig.LAUNCHES[k_] - before[k_] for k_ in before if ig.LAUNCHES[k_] != before[k_]} == {
        "int8_gemm_residual_f32_rows": 1, "int8_gemm_residual_f32": 1}


@pytest.mark.parametrize("s,floor", [(50, 0.0), (64, float("-inf")), (82, 0.0)])
def test_attention_kernel_unfolded(cuda, s, floor):
    """K3's mask-free attention with the scores x 1/sqrt(d) (the unfolded
    tree) and the pair shift's floor of each route; K5 with the scale."""
    g = torch.Generator(device=cuda).manual_seed(s)
    h, crops = 12, 19
    qkv = (torch.randn(crops * s, 3 * h * 64, device=cuda, generator=g) * 4).bfloat16()
    kw = dict(scale=0.125, floor=floor)
    before = dict(bk.LAUNCHES)
    got, ref = bk.attention(qkv, None, s, h, **kw), bk.attention_plain(qkv, None, s, h, **kw)
    e = h * 64
    absv = torch.cat([qkv[:, : 2 * e], qkv[:, 2 * e :].abs()], dim=1)
    slack = 2.0**-7 * bk.attention_plain(absv, None, s, h, **kw)
    assert bool(((got - ref).abs() <= 1e-5 + 1e-5 * ref.abs() + slack).all())
    launched = {"attention_scaled_f32": 1}
    if s <= 64:
        q = qkv[::s, :e].contiguous()
        kv = qkv[:, e:].contiguous()
        got = bk.cls_attention(q, kv, None, s, h, scale=0.125)
        ref = bk.cls_attention_plain(q, kv, None, s, h, scale=0.125)
        slack = 2.0**-7 * bk.cls_attention_plain(q, torch.cat([kv[:, :e], kv[:, e:].abs()], 1),
                                                 None, s, h, scale=0.125)
        assert bool(((got - ref).abs() <= 1e-5 + 1e-5 * ref.abs() + slack).all())
        launched["cls_attention_scaled_f32"] = 1
    assert _launched(before) == launched


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_text_tower_on_the_card(cuda, dtype):
    """A 2-layer int8 text tower at ViT-B/32 width (512, 8 heads, 77
    tokens, the unfolded tree, causal) on the card vs the CPU's plain
    versions (row cos >= 0.999): 2 launches of each masked-route kernel
    a layer's worth, nothing of the mask-free attention or K5."""
    from jcf_tpu_torch.ops.quant import quantize_clip_params

    p = init_clip_params(0, CLIPConfig(vision_layers=1, text_layers=2))
    blocks = p["text"]["blocks"]
    quant = quantize_clip_params(p)["text"]
    x = torch.randn(6 * 77, 512, generator=torch.Generator().manual_seed(3)).to(dtype)
    ref = bk.run_fused_tower(x, quant, 8, flat_s=77, cls_only=False, blocks=blocks, causal=True)
    before, before_g = dict(bk.LAUNCHES), dict(ig.LAUNCHES)
    got = bk.run_fused_tower(x.to(cuda), tree_to(quant, cuda), 8, flat_s=77, cls_only=False,
                             blocks=tree_to(blocks, cuda), causal=True).cpu()
    sfx = "_f32" if dtype == torch.float32 else ""
    assert _launched(before) == {f"ln_affine_quant_rows{sfx}": 4, "masked_attention_f32": 2,
                                 "quant_rows": 2, "gelu_quant_rows": 2}
    res = "int8_gemm_residual_f32_rows" if dtype == torch.float32 else "int8_gemm_residual_rows"
    assert {k: ig.LAUNCHES[k] - before_g[k] for k in before_g if ig.LAUNCHES[k] != before_g[k]} == {
        "int8_gemm_bf16_rows": 2, res: 4, "int8_gemm_f32_rows": 2}
    assert got.dtype == dtype
    cos = torch.nn.functional.cosine_similarity(got.float(), ref.float())
    assert float(cos.min()) >= 0.999


def test_unfolded_vision_tower_on_the_card(cuda):
    """A 2-layer unfolded int8 ViT-B/32 vision tower (768 wide, 12 heads,
    50 tokens, dense) on the card vs the CPU's plain versions, every row
    and the CLS rows (K5 with the scale, then K4 on the CLS rows with the
    f32 LN affine)."""
    from jcf_tpu_torch.ops.quant import quantize_clip_params

    p = init_clip_params(0, CLIPConfig(vision_layers=2, text_layers=1))
    blocks = p["visual"]["blocks"]
    quant = quantize_clip_params(p)["visual"]
    x = torch.randn(16 * 50, 768, generator=torch.Generator().manual_seed(4)).bfloat16()
    qg, bg_ = tree_to(quant, cuda), tree_to(blocks, cuda)
    for cls_only in (False, True):
        ref = bk.run_fused_tower(x, quant, 12, flat_s=50, cls_only=cls_only, blocks=blocks)
        before = dict(bk.LAUNCHES)
        got = bk.run_fused_tower(x.to(cuda), qg, 12, flat_s=50, cls_only=cls_only,
                                 blocks=bg_).cpu()
        launched = _launched(before)
        assert launched["ln_affine_quant_rows"] == 4
        assert launched["attention_scaled_f32"] == (1 if cls_only else 2)
        assert launched.get("cls_attention_scaled_f32", 0) == (1 if cls_only else 0)
        cos = torch.nn.functional.cosine_similarity(got.float(), ref.float())
        assert got.shape == ref.shape and float(cos.min()) >= 0.999


@pytest.mark.parametrize("width,s", [(192, 17), (128, 64)])
def test_odd_head_and_64_token_towers_on_the_card(cuda, width, s):
    """An odd head count (3 heads: the masked route, no mask) and a
    64-token tower (the non-dense mask-free route, no pair-shift floor),
    2 layers of the unfolded tree, int8 and float, vs the CPU's plain
    versions."""
    from jcf_tpu_torch.ops.quant import quantize_clip_params

    p = init_clip_params(0, CLIPConfig(vision_layers=2, vision_width=width, text_layers=1))
    blocks = p["visual"]["blocks"]
    quant = quantize_clip_params(p)["visual"]
    h = width // 64
    x = torch.randn(9 * s, width, generator=torch.Generator().manual_seed(s)).bfloat16()
    before = dict(bk.LAUNCHES)
    for cls_only in (False, True):
        ref = bk.run_fused_tower(x, quant, h, flat_s=s, cls_only=cls_only, blocks=blocks)
        got = bk.run_fused_tower(x.to(cuda), tree_to(quant, cuda), h, flat_s=s,
                                 cls_only=cls_only, blocks=tree_to(blocks, cuda)).cpu()
        cos = torch.nn.functional.cosine_similarity(got.float(), ref.float())
        assert got.shape == ref.shape and float(cos.min()) >= 0.999
    ref = bk.run_float_tower(x, blocks, h, s=s, causal=False)
    got = bk.run_float_tower(x.to(cuda), tree_to(blocks, cuda), h, s=s, causal=False).cpu()
    assert float(torch.nn.functional.cosine_similarity(got.float(), ref.float()).min()) >= 0.999
    launched = _launched(before)
    attn = "masked_attention_f32" if h % 2 else "attention_scaled_f32"
    assert launched[attn] == 4 and "cls_attention_scaled_f32" not in launched
    assert launched["head_attention" if h % 2 else "pair_attention_bf16"] == 2
