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


GEMM_M, GEMM_N, GEMM_K = (1, 127, 129, 4097), (64, 192, 768, 2304), (192, 768, 3072)


@pytest.mark.parametrize("k", GEMM_K)
@pytest.mark.parametrize("n", GEMM_N)
@pytest.mark.parametrize("m", GEMM_M)
def test_int8_gemm_wgmma_shapes(cuda, m, n, k):
    """The wgmma GEMM at ragged shapes (M past the 128-row tile, N not a
    multiple of the 128 / 256 tile, K not of the 128-byte stage; at 4097 x
    2304, 297 tiles over at most 132 blocks): s32 equal to the exact
    product, every other epilogue at its chip_smoke bar against its plain
    version, one launch each."""
    g = torch.Generator(device=cuda).manual_seed(m * 7 + n * 3 + k)
    a = torch.randint(-127, 128, (m, k), device=cuda, generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), device=cuda, generator=g, dtype=torch.int8)
    scale = torch.rand(n, device=cuda, generator=g) * 3e-5
    bias = torch.randn(n, device=cuda, generator=g) * 0.1
    rows = torch.rand(m, device=cuda, generator=g) + 0.5
    resid = torch.randn(m, n, device=cuda, generator=g)
    c = torch.tensor(0.851 / 30.0, device=cuda)
    before = dict(ig.LAUNCHES)
    assert torch.equal(ig.int8_gemm_s32(a, w), ig.int8_matmul_plain(a, w))
    for r in (None, rows):
        _bf16_close(ig.int8_gemm_bf16(a, w, scale, bias, r),
                    ig.int8_gemm_bf16_plain(a, w, scale, bias, r))
        _bf16_close(ig.int8_gemm_residual(a, w, scale, bias, resid.bfloat16(), r),
                    ig.int8_gemm_residual_plain(a, w, scale, bias, resid.bfloat16(), r))
        _f32_close(ig.int8_gemm_residual(a, w, scale, bias, resid, r),
                   ig.int8_gemm_residual_plain(a, w, scale, bias, resid, r))
        _f32_close(ig.int8_gemm_f32(a, w, scale, bias, r), ig.int8_gemm_f32_plain(a, w, scale, bias, r))
    _int8_close(ig.int8_gemm_gelu_quant(a, w, scale * 30, bias * 30, c),
                ig.int8_gemm_gelu_quant_plain(a, w, scale * 30, bias * 30, c), 1e-3)
    _bf16_close(ig.int8_gemm_rowscale(a, w, rows, scale, bias),
                ig.int8_gemm_rowscale_plain(a, w, rows, scale, bias))
    assert {k: v - before[k] for k, v in ig.LAUNCHES.items()} == dict.fromkeys(ig.LAUNCHES, 1)


def test_int8_gemm_refuses_unaligned_operands(cuda):
    """TMA reads 16-byte aligned bases only: an A or B one byte off raises
    ``ValueError`` before any launch; a row slice at a multiple of 16 bytes
    (K5's ``w_int8[e:]``) runs."""
    g = torch.Generator(device=cuda).manual_seed(16)
    buf = torch.randint(-127, 128, (64 * 96 + 1,), device=cuda, generator=g, dtype=torch.int8)
    a, w = buf[:64 * 96].view(64, 96), buf[1:].view(64, 96)
    before = dict(ig.LAUNCHES)
    with pytest.raises(ValueError):
        ig.int8_gemm_s32(a, w)
    with pytest.raises(ValueError):
        ig.int8_gemm_s32(w, a)
    assert ig.LAUNCHES == before
    assert torch.equal(ig.int8_gemm_s32(a, a[16:]), ig.int8_matmul_plain(a, a[16:]))


def test_int8_gemm_c_entry_takes_the_256_tile_for_s32_only(cuda):
    """The 256-column tile is built for the s32 epilogue alone: the C entry
    refuses bn 256 with another epilogue, and bn off 128 / 256, before any
    launch; s32 at bn 256 equals the exact product."""
    from jcf_tpu_torch import _build

    g = torch.Generator(device=cuda).manual_seed(256)
    a = torch.randint(-127, 128, (130, 64), device=cuda, generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (512, 64), device=cuda, generator=g, dtype=torch.int8)
    scale, bias = torch.ones(512, device=cuda), torch.zeros(512, device=cuda)
    lib, stream = _build.load(), _build.stream_ptr(cuda)
    out = torch.zeros(130, 512, dtype=torch.int32, device=cuda)

    def call(epilogue, bn):
        return lib.jcf_int8_gemm(a.data_ptr(), w.data_ptr(), out.data_ptr(), 130, 512, 64, epilogue,
                                 scale.data_ptr(), bias.data_ptr(), None, None, None, bn, 4, stream)

    assert call(1, 256) != 0 and call(0, 64) != 0
    torch.cuda.synchronize(cuda)
    assert int(out.abs().sum()) == 0
    assert call(0, 256) == 0
    assert torch.equal(out, ig.int8_matmul_plain(a, w))


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


# the float GEMMs' edges (wgmma fed by TMA, 128 x 128 tiles): M across
# many row tiles and off the tile, N off the 128 tile (24, 72, 132 f32
# only, 384, 576), K off the stage (12 f32 only, 96, 192) and deep (2048,
# 3072); at 9000 x 576 from K 2048 on, 355 tiles over the persistent
# grid's 264 blocks (bf16; f32: 132 blocks at every K)
FLOAT_GEMM_SHAPES = [(200, 72, 96), (128, 128, 64), (77, 24, 2048), (4097, 384, 128),
                     (1000, 576, 192), (129, 24, 3072), (9000, 576, 2048), (300, 72, 3072)]


@pytest.mark.parametrize("m,n,k", FLOAT_GEMM_SHAPES)
def test_bf16_gemm_epilogues(cuda, m, n, k):
    """Each epilogue vs its plain version within 1 bf16 ulp + 1e-3 (wgmma
    sums in another order than the f32 matmul: an output moves by at most a
    bf16 tie), one launch each."""
    g = torch.Generator(device=cuda).manual_seed(m + n + k)
    a = torch.randn(m, k, device=cuda, generator=g).bfloat16()
    w = (torch.randn(n, k, device=cuda, generator=g) * k**-0.5).bfloat16()
    bias = torch.randn(n, device=cuda, generator=g) * 0.1
    resid = torch.randn(m, n, device=cuda, generator=g).bfloat16()
    acc = bg.matmul_plain(a, w)
    before = dict(bg.LAUNCHES)
    _bf16_close(bg.bf16_gemm_bias(a, w, bias), (acc + bias).bfloat16())
    _bf16_close(bg.bf16_gemm_residual(a, w, bias, resid), (resid.float() + (acc + bias)).bfloat16())
    _bf16_close(bg.bf16_gemm_gelu(a, w, bias), bg.gelu_plain(acc + bias).bfloat16())
    assert {k: v - before[k] for k, v in bg.LAUNCHES.items()} == dict.fromkeys(bg.LAUNCHES, 1)


def test_float_gemms_refuse_before_launch(cuda):
    """TMA reads 16-byte aligned bases and rows only: an A or B one element
    off 16 bytes, K off 8 (bf16) or 4 (f32) raise ``ValueError`` before
    any launch, the f32 GEMM's weight split included, and so does an f32
    product without the weight's TF32 planes; a row slice at a multiple of
    16 bytes runs on its planes."""
    from jcf_tpu_torch.ops import f32_gemm as fg

    g = torch.Generator(device=cuda).manual_seed(19)
    buf = torch.randn(64 * 96 + 8, device=cuda, generator=g)
    bias = torch.zeros(64, device=cuda)
    before = {**bg.LAUNCHES, **fg.LAUNCHES}
    hb = buf.bfloat16()
    for a, w in ((hb[1:64 * 96 + 1].view(64, 96), hb[:64 * 96].view(64, 96)),
                 (hb[:64 * 96].view(64, 96), hb[1:64 * 96 + 1].view(64, 96)),
                 (hb[:60 * 100].view(60, 100), hb[:60 * 100].view(60, 100))):
        with pytest.raises(ValueError):
            bg.bf16_gemm_bias(a, w, bias)
    for a, w in ((buf[1:64 * 96 + 1].view(64, 96), buf[:64 * 96].view(64, 96)),
                 (buf[:64 * 96].view(64, 96), buf[1:64 * 96 + 1].view(64, 96)),
                 (buf[:64 * 90].view(64, 90), buf[:64 * 90].view(64, 90))):
        with pytest.raises(ValueError):
            fg.f32_gemm_bias(a, w, bias)
    with pytest.raises(ValueError):
        fg.tf32_split(buf[1:9])
    a, w = buf[:64 * 96].view(64, 96), buf[:64 * 96].view(64, 96)[8:]
    with pytest.raises(ValueError, match="with_tf32_planes"):
        fg.f32_gemm_bias(a, w, bias[8:])
    assert {**bg.LAUNCHES, **fg.LAUNCHES} == before
    _f32_close(fg.f32_gemm_bias(a, w, bias[8:], planes=fg.tf32_split(w)),
               fg.f32_gemm_bias_plain(a, w, bias[8:]), 1e-6 * torch.matmul(a.abs(), w.abs().T))


def test_tf32_split_kernel_matches_plain_bit_for_bit(cuda):
    """The weights' split kernel equals ``tf32_split_plain`` bit for bit:
    seeded normal values over 40 binades, zeros of both signs, subnormals,
    powers of two and the ties of the 13 dropped bits (rounded away from
    zero), at c_fc's 3072 x 768 and a ragged 4 x 12."""
    from jcf_tpu_torch.ops import f32_gemm as fg

    g = torch.Generator(device=cuda).manual_seed(23)
    w = torch.randn(3072, 768, device=cuda, generator=g)
    w = w * torch.exp2(torch.randint(-20, 20, w.shape, device=cuda, generator=g).float())
    bits = torch.randint(0, 2**23, (4096,), device=cuda, generator=g, dtype=torch.int32)
    special = torch.cat([
        torch.tensor([0.0, -0.0, 1.0, -1.0, 2.0**-126, 2.0**-149, -(2.0**-149), 2.0**100],
                     device=cuda),
        (bits & 0x7FFFFF).view(torch.float32),                   # subnormals
        ((bits & 0x7FFFE000) | 0x3F801000).view(torch.float32),  # ties
        (bits | 0x40001000).view(torch.float32)])
    w.view(-1)[:special.numel()] = special
    before = fg.LAUNCHES["tf32_split"]
    for x in (w, w[:4, :12].contiguous()):
        got, ref = fg.tf32_split(x), fg.tf32_split_plain(x)
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert fg.LAUNCHES["tf32_split"] == before + 2


def test_tree_planes_on_the_card(cuda):
    """``with_tf32_planes`` on a 2-layer ViT-B/32-width tree on the card:
    one ``tf32_split`` a layer and weight (8), every plane equal to the
    plain split of its layer bit for bit, the source tree untouched."""
    from jcf_tpu_torch.ops import f32_gemm as fg

    blocks = tree_to(init_clip_params(0, CLIPConfig(vision_layers=2))["visual"]["blocks"], cuda)
    before = fg.LAUNCHES["tf32_split"]
    planes = fg.with_tf32_planes(blocks)
    assert fg.LAUNCHES["tf32_split"] == before + 2 * 4
    assert "w_qkv_tf32" not in blocks["attn"]
    for path in fg.PLANE_WEIGHTS:
        owner = planes
        for key in path[:-1]:
            owner = owner[key]
        w, p = owner[path[-1]], owner[fg.planes_key(path[-1])]
        assert p.shape == (2, 2, *w.shape[1:])
        for i in range(2):
            assert torch.equal(p[i].view(torch.int32), fg.tf32_split_plain(w[i]).view(torch.int32))


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


def _k7_bias(kind, s, device):
    """K7's additive [S, S] bias: the causal mask, zeros, or random finite
    values (seeded)."""
    if kind == "causal":
        return at.causal_mask(s, device)
    if kind == "zero":
        return torch.zeros(s, s, device=device)
    return torch.randn(s, s, device=device, generator=torch.Generator(device=device).manual_seed(s))


# bf16 at S = 23, 50, 77 and 128 with each bias (the tensor-core backward);
# f32 up to 77 (the CUDA-core backward's f32 tiles stop short of 128 at D = 64)
K7_CASES = [(dt, s, h, b) for s, h in ((23, 3), (50, 12), (77, 8), (128, 2))
            for b in ("causal", "zero", "random") for dt in (torch.float32, torch.bfloat16)
            if dt == torch.bfloat16 or s < 128]


@pytest.mark.parametrize("dtype,s,h,bias_kind", K7_CASES)
def test_packed_attention_kernels(cuda, dtype, s, h, bias_kind):
    """K7 forward and backward vs the plain forward and autograd through
    it: f32 within 1e-5 (+ 1e-5 relative), bf16 within 1 bf16 ulp + 1e-3;
    the bf16 backward also at check_grad_bf16's bar (per head row of dQ,
    dK, dV cos >= 0.999, rows the mask leaves at zero within 1e-6) and on
    the tensor-core route, the f32 one on the row loop."""
    g = torch.Generator(device=cuda).manual_seed(s + h)
    b = 5
    qkv = torch.randn(b, s, 3 * h * 64, device=cuda, generator=g).to(dtype)
    dout = torch.randn(b, s, h * 64, device=cuda, generator=g).to(dtype)
    bias = _k7_bias(bias_kind, s, cuda)
    close = _f32_close if dtype == torch.float32 else _bf16_close
    route = "mma" if dtype == torch.bfloat16 else "rowloop"
    before = dict(at.LAUNCHES)
    close(at.packed_attention_fwd(qkv, h, bias).float(),
          at.packed_attention_plain(qkv, h, bias).float())
    assert {k: at.LAUNCHES[k] - before[k] for k in before if at.LAUNCHES[k] != before[k]} == {
        "packed_attention": 1, f"packed_attention/{route}": 1}
    x = qkv.clone().requires_grad_(True)
    ref, = torch.autograd.grad(at.packed_attention_plain(x, h, bias), x, dout)
    before = dict(at.LAUNCHES)
    got = at.packed_attention_bwd(qkv, h, bias, dout)
    close(got.float(), ref.float())
    assert {k: at.LAUNCHES[k] - before[k] for k in before if at.LAUNCHES[k] != before[k]} == {
        "packed_attention_bwd": 1, f"packed_attention_bwd/{route}": 1}
    if dtype == torch.bfloat16:
        gr, rr = got.float().reshape(-1, 64), ref.float().reshape(-1, 64)
        live = rr.norm(dim=-1) > 0
        cos = torch.nn.functional.cosine_similarity(gr[live], rr[live])
        assert float(cos.min()) >= 0.999
        assert not bool((~live).any()) or float(gr[~live].abs().max()) <= 1e-6


@pytest.mark.parametrize("d,dtype,offset", [(32, torch.bfloat16, 0), (64, torch.float32, 0),
                                            (64, torch.bfloat16, 2), (64, torch.bfloat16, 0)])
def test_packed_attention_bwd_routes(cuda, d, dtype, offset):
    """K7's backward takes the tensor cores for bf16 at head dim 64 with
    16-byte aligned rows and the CUDA-core kernel otherwise (head dim 32,
    f32, qkv 4 bytes off alignment), counted by route; both agree with
    autograd through the plain forward (f32 1e-5, bf16 1 ulp + 1e-3)."""
    g = torch.Generator(device=cuda).manual_seed(d + offset)
    b, s, h = 4, 50, 3
    n = b * s * 3 * h * d
    buf = torch.randn(n + 8, device=cuda, generator=g).to(dtype)
    qkv = buf[offset:offset + n].view(b, s, 3 * h * d)
    assert qkv.is_contiguous()
    dout = torch.randn(b, s, h * d, device=cuda, generator=g).to(dtype)
    bias = at.causal_mask(s, cuda)
    x = qkv.clone().requires_grad_(True)
    ref, = torch.autograd.grad(at.packed_attention_plain(x, h, bias), x, dout)
    before = dict(at.LAUNCHES)
    got = at.packed_attention_bwd(qkv, h, bias, dout)
    (_f32_close if dtype == torch.float32 else _bf16_close)(got.float(), ref.float())
    route = at.attention_route(dtype, d, qkv.data_ptr(), dout.data_ptr())
    assert route == ("mma" if (d, dtype, offset) == (64, torch.bfloat16, 0) else "rowloop")
    key = f"packed_attention_bwd/{route}"
    assert at.LAUNCHES[key] == before[key] + 1


@pytest.mark.parametrize("d,dtype,offset", [(32, torch.bfloat16, 0), (64, torch.float32, 0),
                                            (64, torch.bfloat16, 2), (64, torch.bfloat16, 0)])
def test_packed_attention_fwd_routes(cuda, d, dtype, offset):
    """K7's forward takes the tensor cores for bf16 at head dim 64 with
    16-byte aligned rows and the CUDA-core kernel otherwise (head dim 32,
    f32, qkv 4 bytes off alignment), counted by route; both agree with the
    plain forward (f32 1e-5, bf16 1 ulp + 1e-3) under the causal mask and
    a random finite bias."""
    g = torch.Generator(device=cuda).manual_seed(d + offset)
    b, s, h = 4, 50, 3
    n = b * s * 3 * h * d
    buf = torch.randn(n + 8, device=cuda, generator=g).to(dtype)
    qkv = buf[offset:offset + n].view(b, s, 3 * h * d)
    assert qkv.is_contiguous()
    route = at.attention_route(dtype, d, qkv.data_ptr())
    assert route == ("mma" if (d, dtype, offset) == (64, torch.bfloat16, 0) else "rowloop")
    close = _f32_close if dtype == torch.float32 else _bf16_close
    before = dict(at.LAUNCHES)
    for bias in (at.causal_mask(s, cuda), _k7_bias("random", s, cuda)):
        close(at.packed_attention_fwd(qkv, h, bias).float(),
              at.packed_attention_plain(qkv, h, bias).float())
    assert {k: at.LAUNCHES[k] - before[k] for k in before if at.LAUNCHES[k] != before[k]} == {
        "packed_attention": 2, f"packed_attention/{route}": 2}


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


@pytest.mark.parametrize("encoder", ["text", "vision"])
def test_stage1_step_with_one_lora_tower(cuda, encoder):
    """An f32 stage-1 step with LoRA on one tower only, on a 2-layer
    full-width model: the other tower runs the fused route on the TF32
    planes ``make_stage1_step`` split for it (8 ``tf32_split`` launches
    there, none in the step), and the step's loss is within 1e-4 relative
    of the same step on the CPU (no dropout; the products' roundings
    differ)."""
    from jcf_tpu_torch.ops import f32_gemm as fg
    from jcf_tpu_torch.peft import LoraSpec, init_lora_params
    from jcf_tpu_torch.train import adamw, make_stage1_step

    cfg = CLIPConfig(text_layers=2, vision_layers=2)
    spec = LoraSpec(encoder=encoder)
    params = init_clip_params(0, cfg)
    lora = init_lora_params(1, spec, 2, cfg.text_width, 2, cfg.vision_width)
    gen = torch.Generator().manual_seed(0)
    banks = torch.randint(1, 49000, (2, 7, 77), generator=gen)
    banks[:, :, 20] = 49407
    images = torch.rand(6, 3, 224, 224, generator=gen)
    targets = torch.randint(0, 7, (6,), generator=gen)
    losses = []
    for device in (cuda, torch.device("cpu")):
        before = fg.LAUNCHES["tf32_split"]
        init_state, step, frozen = make_stage1_step(params, cfg, spec, banks, adamw(1e-3),
                                                    device=device)
        built = fg.LAUNCHES["tf32_split"]
        _, m = step(frozen, init_state(lora), images, targets, 1, None)
        losses.append(float(m["loss"]))
        if device.type == "cuda":
            assert (built - before, fg.LAUNCHES["tf32_split"] - built) == (2 * 4, 0)
    assert torch.isfinite(torch.tensor(losses)).all()
    assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[1])


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
@pytest.mark.parametrize("s,causal", [(50, True), (128, False), (145, False), (197, False),
                                      (208, False), (256, False), (257, False), (300, False),
                                      (577, False), (768, False)])
def test_blocked_attention_kernel(cuda, dtype, h, s, causal):
    """K8 vs ``attention_plain`` on head views of a packed qkv (the layout
    the tower gives it, unit-scale entries as a LayerNorm'd row through a
    unit-variance projection gives): f32 within 1e-5 (+ 1e-5 relative),
    bf16 within 1 bf16 ulp + 1e-3. (On peakier rows a p that rounds to
    bf16 on the other side of a tie moves the output by an ulp of p times
    |v|, which can exceed an ulp of a small output.) In bf16, S = 128, 208
    and 256 are whole 16-row tiles, up to 208 keys held in registers in
    one pass; from 257 the keys stream in two passes. In f32 up to 256
    keys one block holds a head (197: a part-full last unit of 8 rows);
    from 257 a block holds 64 query rows and streams 128-key groups twice
    (300: a part-full last query block and key group; 577: a last query
    block of one row; 768: the limit)."""
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
    """S = 1024, over K8's 768 (in bf16 K and V of the head would be over
    the card's shared memory). The C entry refuses, nothing launches, and
    the next launch runs."""
    before = at.LAUNCHES["blocked_attention"]
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros(1, 2, 1024, 64, device=cuda, dtype=dtype)
        with pytest.raises(RuntimeError):
            at.fused_attention(q, q, q)
    assert at.LAUNCHES["blocked_attention"] == before
    q = torch.randn(1, 2, 197, 64, device=cuda)
    _f32_close(at.fused_attention(q, q, q), at.attention_plain(q, q, q))
    assert at.LAUNCHES["blocked_attention"] == before + 1
    with pytest.raises(ValueError):  # head dim 32: the kernel takes 64
        at.fused_attention(*(torch.zeros(1, 2, 200, 32, device=cuda),) * 3)


@pytest.mark.parametrize("offset,width", [(4, 3 * 128 + 4), (0, 3 * 128 + 4), (8, 3 * 128 + 8),
                                          (2, 3 * 128 + 2), (0, 3 * 128 + 2)])
def test_blocked_attention_refuses_unaligned_bf16_views(cuda, offset, width):
    """K8 reads 16-byte rows in bf16 and in f32: head views at an offset or
    row stride that is not a whole 16 bytes (8 bf16 or 4 f32 elements)
    raise ``ValueError`` and launch nothing (an aligned view at an offset
    of 8, or of 4 in f32, runs)."""
    g = torch.Generator(device=cuda).manual_seed(offset + width)
    buf = torch.randn(2, 150, width, device=cuda, generator=g)
    for dtype in (torch.bfloat16, torch.float32):
        qkv = buf.to(dtype)[..., offset: offset + 3 * 128]
        q, k, v = qkv.unflatten(-1, (3, 2, 64)).permute(2, 0, 3, 1, 4)
        before = at.LAUNCHES["blocked_attention"]
        step = 16 // qkv.element_size()
        aligned = offset % step == 0 and width % step == 0
        if not aligned:
            with pytest.raises(ValueError):
                at.fused_attention(q, k, v)
            assert at.LAUNCHES["blocked_attention"] == before
            continue
        close = _f32_close if dtype == torch.float32 else _bf16_close
        close(at.fused_attention(q, k, v).float(), at.attention_plain(q, k, v).float())
        assert at.LAUNCHES["blocked_attention"] == before + 1


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
    cpu = TTAEngine(params, cfg, device="cpu", quant="int8", n_views=3)
    geometry = cpu.sample_geometry(gen, 2, (256, 256))
    counters = [vk.LAUNCHES, ig.LAUNCHES, ak.LAUNCHES, bk.LAUNCHES, bg.LAUNCHES, at.LAUNCHES]
    for c in counters:
        c.update(dict.fromkeys(c, 0))
    got = TTAEngine(params, cfg, device=cuda, quant="int8", n_views=3).features_from_images(
        images.to(cuda), text.to(cuda), geometry=tuple(t.to(cuda) for t in geometry))
    torch.cuda.synchronize()
    launches = {k: v for c in counters for k, v in c.items() if v}
    assert launches == {"view": 1, "view/patch": 1, "int8_gemm_s32": 1, "blocked_attention": 2,
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


def _float_layer(e, dev, seed):
    """One float block of E = e, hidden 4e, on the card: ``init_clip_params``'s
    text block 0 with its LN affines and biases moved off 1 and 0."""
    cfg = CLIPConfig(text_layers=1, text_width=e, text_heads=e // 64)
    layer = layer_slice(tree_to(init_clip_params(seed, cfg)["text"]["blocks"], dev), 0)
    g = torch.Generator(device=dev).manual_seed(seed)

    def bump(t, std):
        return t + std * torch.randn(t.shape, device=dev, generator=g)

    for ln in ("ln_1", "ln_2"):
        layer[ln] = {k: bump(v, 0.1) for k, v in layer[ln].items()}
    for k in ("b_qkv", "b_out"):
        layer["attn"][k] = bump(layer["attn"][k], 0.02)
    for fc in ("c_fc", "c_proj"):
        layer["mlp"][fc]["b"] = bump(layer["mlp"][fc]["b"], 0.02)
    return layer


def _block_bias(kind, s, dev):
    if kind == "causal":
        return at.causal_mask(s, dev)
    if kind == "zero":
        return torch.zeros(s, s, device=dev)
    return torch.randn(s, s, device=dev, generator=torch.Generator(device=dev).manual_seed(s))


@pytest.mark.parametrize("bias", ["causal", "zero", "random"])
@pytest.mark.parametrize("s", [17, 50, 77, 80])
@pytest.mark.parametrize("width", [128, 512, 768])
def test_block_bf16_kernel_shapes(cuda, width, s, bias):
    """K9b (csrc/block_float.cu) in bf16 vs its plain version on 3
    sequences in one chunk, at each width, length and bias."""
    layer = _float_layer(width, cuda, width + s)
    x = torch.randn(3 * s, width, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(s)).bfloat16()
    b, h = _block_bias(bias, s, cuda), width // 64
    before = bk.LAUNCHES["block_bf16"]
    got = bk.block_bf16(x, layer, s, h, b)
    assert bk.LAUNCHES["block_bf16"] == before + 1
    _rows_close(got, bk.block_bf16_plain(x, layer, s, h, b))


@pytest.mark.parametrize("n_seq,chunk", [(1, None), (9, 4), (7, 3), (5, 2), (4, 1), (9, None)])
def test_block_bf16_kernel_chunks(cuda, n_seq, chunk):
    """K9b in bf16 over forced chunks of whole sequences (a partial last
    one where the chunk does not divide them), one sequence, and all the
    sequences in one chunk (None, the wrappers' default), against its
    plain version."""
    layer = _float_layer(768, cuda, n_seq)
    x = torch.randn(n_seq * 77, 768, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(n_seq)).bfloat16()
    b = at.causal_mask(77, cuda)
    got = bk._block_float("block_bf16", x, layer, 77, 12, b, torch.bfloat16, chunk=chunk)
    _rows_close(got, bk.block_bf16_plain(x, layer, 77, 12, b))


@pytest.mark.parametrize("dtype,name", [(torch.bfloat16, "block_bf16"), (torch.float32, "block_f32")])
def test_block_float_is_one_launch_a_layer(cuda, monkeypatch, dtype, name):
    """Under "block" a 2-layer float tower launches K9b once a layer and
    nothing else: no GEMM, attention, LayerNorm or weight-split launch."""
    from jcf_tpu_torch.ops import f32_gemm as fg

    cfg = CLIPConfig(text_layers=2, text_width=256, text_heads=4)
    blocks = tree_to(init_clip_params(3, cfg)["text"]["blocks"], cuda)
    if dtype == torch.float32:
        blocks = fg.with_tf32_planes(blocks)  # split once, before the count
    x = torch.randn(5 * 50, 256, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(5)).to(dtype)
    monkeypatch.setattr(bk, "_FUSE", "block")
    before, before_g, before_f = dict(bk.LAUNCHES), dict(bg.LAUNCHES), dict(fg.LAUNCHES)
    got = bk.run_float_tower(x, blocks, 4, s=50, causal=False)
    assert {k: bk.LAUNCHES[k] - before[k] for k in before if bk.LAUNCHES[k] != before[k]} == {name: 2}
    assert bg.LAUNCHES == before_g and fg.LAUNCHES == before_f
    monkeypatch.setattr(bk, "_FUSE", "halves")
    ref = bk.run_float_tower(x, blocks, 4, s=50, causal=False)
    g, r = got.float(), ref.float()
    assert float(torch.nn.functional.cosine_similarity(g, r).min()) >= 0.999


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
    not take, launching nothing: a tree not marked folded without its LN
    affines, S > 127; for K9b f32 rows, S > 80, a bias of the wrong
    shape. A flag set no route gives (a mask on the dense route, a causal
    mask without one) is refused before the launch, the unfolded options
    without the LN affines by the C entry. S = 100 and the unfolded tree run, each
    against its plain version (``tests/test_torch_gpu_predict.py`` holds
    every branch)."""
    from jcf_tpu_torch.ops.quant import quantize_clip_params

    tree = tree_to(_int8_tree(128), cuda)
    layer = layer_slice(tree, 0)
    x = torch.randn(2 * 50, 128, device=cuda).bfloat16()
    unmarked = {"attn": layer["attn"], "mlp": layer["mlp"]}
    stacked_unmarked = {"attn": tree["attn"], "mlp": tree["mlp"]}
    text = layer_slice(tree_to(init_clip_params(0, CLIPConfig(
        text_layers=1, text_width=128, text_heads=2))["text"]["blocks"], cuda), 0)
    before = dict(bk.LAUNCHES)
    for fn in (bk.block_int8, bk.layer_fused_int8):
        with pytest.raises(ValueError, match="lns"):
            fn(x, unmarked, 50, 2)
        with pytest.raises(ValueError):  # S = 128 > 127
            fn(torch.randn(128, 128, device=cuda).bfloat16(), layer, 128, 2)
    with pytest.raises(ValueError, match="lns"):
        bk.stream_tower_int8(x, stacked_unmarked, 2, s=50)
    with pytest.raises(ValueError):  # f32 rows
        bk.block_bf16(x.float(), text, 50, 2, at.causal_mask(50, cuda))
    with pytest.raises(ValueError):  # S = 100 > 80
        bk.block_bf16(x, text, 100, 2, at.causal_mask(100, cuda))
    with pytest.raises(ValueError):  # a bias of the wrong shape
        bk.block_bf16(x, text, 50, 2, at.causal_mask(49, cuda))
    assert bk.LAUNCHES == before
    flags = bk.quant_flags(layer)
    # no route gives these (a ValueError before the launch, from
    # _layers_plan's route check); the last reaches the launch, which
    # refuses it
    for bad, err in ((flags | bk.FLAG_USE_MASK, ValueError), (flags | bk.FLAG_CAUSAL, ValueError),
                     (flags & ~bk.FLAG_FOLDED, RuntimeError)):
        monkeypatch.setattr(bk, "quant_flags", lambda tree, bad=bad, **kw: bad)
        for fn in (bk.block_int8, bk.layer_fused_int8):
            with pytest.raises(err):
                fn(x, layer, 50, 2)
        with pytest.raises(err):
            bk.stream_tower_int8(x, tree, 2, s=50)
    monkeypatch.undo()
    assert bk.LAUNCHES == before
    x100 = torch.randn(2 * 100, 128, device=cuda).bfloat16()
    for fn in (bk.block_int8, bk.layer_fused_int8):
        _rows_close(fn(x100, layer, 100, 2).cpu(),
                    getattr(bk, f"{fn.__name__}_plain")(x100, layer, 100, 2).cpu())
    blocks = tree_to(init_clip_params(0, CLIPConfig(vision_width=128, vision_layers=1,
                                                    text_layers=1))["visual"]["blocks"], cuda)
    unfolded = layer_slice(quantize_clip_params({"visual": {"blocks": blocks}})["visual"], 0)
    lns = tuple(bk._layer_ln(blocks, 0, n, torch.bfloat16) for n in ("ln_1", "ln_2"))
    for fn in (bk.block_int8, bk.layer_fused_int8):
        _rows_close(fn(x, unfolded, 50, 2, lns=lns).cpu(),
                    getattr(bk, f"{fn.__name__}_plain")(x, unfolded, 50, 2, lns=lns).cpu())
    before = dict(bk.LAUNCHES)
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
    # the LN rows 128 wide take the LN + quant kernel's scalar route
    scalar = {"ln_quant_rows/scalar": 1} if xb.shape[1] not in bk.LN_QUANT_VEC_WIDTHS else {}
    assert {k: bk.LAUNCHES[k] - before[k] for k in before if bk.LAUNCHES[k] != before[k]} == {
        "ln_quant_rows": 1, "quant_rows": 1, "gelu_quant_rows": 1, **scalar}


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
    context of a dynamic one, with the pair max or a calibrated shift,
    both on the tensor-core route (bf16 at head dim 64)."""
    g = torch.Generator(device=cuda).manual_seed(s)
    h, crops = 12, 9
    qkv = (torch.randn(crops * s, 3 * h * 64, device=cuda, generator=g) * 0.5).bfloat16()
    sh = None if shift is None else torch.tensor([[shift]], device=cuda)
    ctx_inv = torch.tensor([[30.0]], device=cuda)
    before = dict(bk.LAUNCHES)
    _int8_close(bk.attention(qkv, ctx_inv, s, h, sh), bk.attention_plain(qkv, ctx_inv, s, h, sh),
                1e-2)
    got, ref = bk.attention(qkv, None, s, h, sh), bk.attention_plain(qkv, None, s, h, sh)
    assert got.dtype == torch.float32
    assert bool(((got - ref).abs() <= 1e-5 + 1e-5 * ref.abs() + _ctx_slack(qkv, s, h, sh)).all())
    assert _launched(before) == {"attention": 1, "attention/mma": 1, "attention_f32": 1,
                                 "attention_f32/mma": 1}


@pytest.mark.parametrize("d,offset", [(32, 0), (64, 2)])
def test_attention_kernel_row_loop_route(cuda, d, offset):
    """K3's attention off the tensor cores' shapes takes the CUDA-core row
    loop (counted "/rowloop"): head dim 32, and qkv 4 bytes off 16-byte
    alignment (a view of a larger buffer), at the same bars as the
    tensor-core route, with the pair max and a calibrated shift."""
    g = torch.Generator(device=cuda).manual_seed(d + offset)
    s, h, crops = 50, 4, 7
    n = crops * s * 3 * h * d
    qkv = (torch.randn(n + 8, device=cuda, generator=g) * 0.5).bfloat16()[offset:offset + n]
    qkv = qkv.view(crops * s, 3 * h * d)
    assert qkv.is_contiguous() and bk.attention_route(qkv.dtype, d, qkv.data_ptr()) == "rowloop"
    ctx_inv = torch.tensor([[30.0]], device=cuda)
    before = dict(bk.LAUNCHES)
    for sh in (None, torch.tensor([[1.5]], device=cuda)):
        _int8_close(bk.attention(qkv, ctx_inv, s, h, sh),
                    bk.attention_plain(qkv, ctx_inv, s, h, sh), 1e-2)
        got, ref = bk.attention(qkv, None, s, h, sh), bk.attention_plain(qkv, None, s, h, sh)
        assert bool(((got - ref).abs() <= 1e-5 + 1e-5 * ref.abs()
                     + _ctx_slack(qkv, s, h, sh)).all())
    assert _launched(before) == {"attention": 2, "attention/rowloop": 2, "attention_f32": 2,
                                 "attention_f32/rowloop": 2}


def test_attention_c_entries_refuse_the_tensor_core_route_off_its_shapes(cuda):
    """The C entries of K3's attention and K7's forward refuse the
    tensor-core route (``cudaErrorInvalidValue``, nothing launched) for
    a shape it cannot take (head dim 32; f32 qkv for K7; an unaligned
    output), and the next launch runs clean."""
    from jcf_tpu_torch import _build

    lib = _build.load()
    stream = _build.stream_ptr(cuda)
    s, h, crops = 50, 2, 3
    qkv = torch.zeros(crops * s, 3 * h * 32, device=cuda).bfloat16()
    out = torch.empty(crops * s, h * 32 + 16, device=cuda, dtype=torch.int8)
    ctx_inv = torch.ones(1, device=cuda)
    args = (qkv.data_ptr(), ctx_inv.data_ptr(), None, out.data_ptr(), crops, s, h, 32, 1.0, 0,
            0.0, 0)
    assert lib.jcf_attention(*args, 1, stream) == 1  # cudaErrorInvalidValue
    q64 = torch.zeros(crops * s, 3 * h * 64, device=cuda).bfloat16()
    assert lib.jcf_attention(q64.data_ptr(), ctx_inv.data_ptr(), None, out.data_ptr() + 4, crops,
                             s, h, 64, 1.0, 0, 0.0, 0, 1, stream) == 1
    x32 = torch.zeros(2, s, 3 * h * 64, device=cuda)
    bias = torch.zeros(s, s, device=cuda)
    o32 = torch.empty(2, s, h * 64, device=cuda)
    assert lib.jcf_packed_attention(x32.data_ptr(), bias.data_ptr(), o32.data_ptr(), 2, s, h, 64,
                                    0.125, 0, 1, stream) == 1
    # the refusals leave no error behind for the next launches
    torch.cuda.synchronize()
    rows = (torch.randn(crops * s, 3 * h * 64, device=cuda) * 0.5).bfloat16()
    _int8_close(bk.attention(rows, ctx_inv, s, h), bk.attention_plain(rows, ctx_inv, s, h), 1e-2)
    xb = torch.randn(2, s, 3 * h * 64, device=cuda).bfloat16()
    _bf16_close(at.packed_attention_fwd(xb, h, bias), at.packed_attention_plain(xb, h, bias))
    torch.cuda.synchronize()


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
    cpu = TTAEngine(params, cfg, device="cpu", quant="int8")
    card = TTAEngine(params, cfg, device=cuda, quant="int8")
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


@pytest.mark.parametrize("m,n,k", FLOAT_GEMM_SHAPES + [(77, 24, 3072), (5, 132, 12),
                                                       (1000, 132, 12), (4097, 132, 768)])
def test_f32_gemm_epilogues(cuda, m, n, k):
    """Each epilogue vs its plain version within 1e-5 + 1e-5 |ref| + 1e-6
    sum_k |a w| (the worst case of K-term f32 sums is K u sum |a w|; the
    kernel's three TF32 products drop about 3 2^-22 |a w| a product), one
    launch each and no weight split (the planes come split); the planes
    split by the kernel and by the plain version (then copied to the card)
    give the same output bit for bit."""
    from jcf_tpu_torch.ops import f32_gemm as fg

    g = torch.Generator(device=cuda).manual_seed(m + n + k)
    a = torch.randn(m, k, device=cuda, generator=g)
    w = torch.randn(n, k, device=cuda, generator=g) * k**-0.5
    bias = torch.randn(n, device=cuda, generator=g) * 0.1
    resid = torch.randn(m, n, device=cuda, generator=g)
    slack = 1e-6 * torch.matmul(a.abs(), w.abs().T)
    p = fg.tf32_split(w)
    before = dict(fg.LAUNCHES)
    got = fg.f32_gemm_bias(a, w, bias, planes=p)
    _f32_close(got, fg.f32_gemm_bias_plain(a, w, bias), slack)
    _f32_close(fg.f32_gemm_residual(a, w, bias, resid, planes=p),
               fg.f32_gemm_residual_plain(a, w, bias, resid), slack)
    _f32_close(fg.f32_gemm_gelu(a, w, bias, planes=p), fg.f32_gemm_gelu_plain(a, w, bias), slack)
    assert {k: v - before[k] for k, v in fg.LAUNCHES.items()} == {
        "f32_gemm_bias": 1, "f32_gemm_residual": 1, "f32_gemm_gelu": 1, "tf32_split": 0}
    host = fg.tf32_split_plain(w.cpu()).to(cuda)
    assert torch.equal(fg.f32_gemm_bias(a, w, bias, planes=host).view(torch.int32),
                       got.view(torch.int32))


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


def _ln_rows_input(m, e, dtype, device, seed):
    """Seeded LayerNorm rows [m, e]: standard normal; every third row, from
    row 1, a large common offset with its mean exactly 100 (deviations in
    pairs k, -k: k / 128 in f32, std ~0.01, where a one-pass variance
    fails; k / 2 in bf16, std ~1, bf16's spacing at 100 being 0.5)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(m, e, generator=g, dtype=torch.float64)
    step, sd = (1 / 128, 1.28) if dtype == torch.float32 else (1 / 2, 2.0)
    for i in range(1, m, 3):
        k = torch.round(torch.randn(e // 2, generator=g, dtype=torch.float64) * sd)
        dev = torch.cat([k, -k, torch.zeros(e % 2, dtype=torch.float64)])
        x[i] = 100 + dev[torch.randperm(e, generator=g)] * step
    scale = 1 + 0.1 * torch.randn(e, generator=g, dtype=torch.float64)
    bias = 0.1 * torch.randn(e, generator=g, dtype=torch.float64)
    return tuple(t.to(device=device, dtype=dtype) for t in (x, scale, bias))


# the vector kernel's widths (512 and 768 with instances of their own),
# rows from one to past the grid's warps (the row loop wraps)
LN_WIDTHS = (64, 128, 192, 512, 768, 1024)
LN_ROWS = (1, 7, 9 * 77, 40000)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("e", LN_WIDTHS)
@pytest.mark.parametrize("m", LN_ROWS)
def test_ln_affine_vector_kernel(cuda, dtype, e, m):
    x, scale, bias = _ln_rows_input(m, e, dtype, cuda, seed=m + e)
    sfx = "" if dtype == torch.bfloat16 else "_f32"
    before = dict(bk.LAUNCHES)
    got = bk.ln_affine(x, scale, bias)
    ref = bk.ln_affine_plain(x, scale, bias)
    if dtype == torch.bfloat16:
        _bf16_close(got, ref)
    else:
        _f32_close(got, ref)
    assert _launched(before) == {f"ln_affine{sfx}": 1}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("e,misaligned", [(77, False), (1023, False), (512, True)])
def test_ln_affine_scalar_route(cuda, dtype, e, misaligned):
    """Rows off the vector kernel (a width not a multiple of 16 bytes, or
    rows one element off 16-byte alignment) take the scalar kernel and
    count its route."""
    m = 700
    x, scale, bias = _ln_rows_input(m, e, dtype, cuda, seed=e)
    if misaligned:
        buf = torch.empty(m * e + 1, dtype=dtype, device=cuda)
        buf[1:].copy_(x.reshape(-1))
        x = buf[1:].view(m, e)
        assert x.is_contiguous() and x.data_ptr() % 16
    sfx = "" if dtype == torch.bfloat16 else "_f32"
    before = dict(bk.LAUNCHES)
    got = bk.ln_affine(x, scale, bias)
    ref = bk.ln_affine_plain(x, scale, bias)
    if dtype == torch.bfloat16:
        _bf16_close(got, ref)
    else:
        _f32_close(got, ref)
    assert _launched(before) == {f"ln_affine{sfx}": 1, f"ln_affine{sfx}/scalar": 1}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s,h,crops", [(48, 6, 7), (50, 12, 7), (54, 12, 7), (56, 4, 7),
                                       (64, 12, 7), (82, 12, 7), (127, 2, 7), (50, 2, 7),
                                       (50, 12, 45), (54, 12, 45)])
def test_pair_attention_kernel(cuda, dtype, s, h, crops):
    """The mask-free attention vs its plain version: f32 (register-tiled
    on the CUDA cores) within 1e-5 + 1e-5 |ref|; bf16 within one ulp + 1e-3
    plus 2^-7 sum_j p_j |v_j| / l (how far a p that rounds to bf16 across
    a tie moves an element). The pair shift's floor is -inf at S = 48, 56
    and 64 and 0 at 50, 54, 82 and 127; bf16 holds up to 64 keys in one
    register tile, 82 and 127 in the larger one; f32 stages Q up to 64
    keys and reads it through L1 past 64 (45 crops x 6 pairs: 270 blocks,
    the last wave of two blocks an SM part-full)."""
    g = torch.Generator(device=cuda).manual_seed(s + h + crops)
    d = 64
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


def test_pair_attention_refuses_bf16_off_head_dim_64(cuda):
    """Pair attention runs at head dim 64 on 16-byte aligned rows only, in
    bf16 (tensor cores) and f32 (register tiles): D = 32 in either dtype,
    and f32 rows 4 bytes off alignment at D = 64, raise ``ValueError`` and
    launch nothing; the C entry refuses them too; the same rows aligned
    run."""
    from jcf_tpu_torch import _build

    g = torch.Generator(device=cuda).manual_seed(32)
    qkv = torch.randn(3 * 50, 3 * 4 * 32, device=cuda, generator=g) * 0.5
    before = dict(bk.LAUNCHES)
    for t in (qkv.bfloat16(), qkv):
        with pytest.raises(ValueError):
            bk.pair_attention(t, 50, 4)
    buf = torch.randn(3 * 50 * 3 * 4 * 64 + 1, device=cuda, generator=g) * 0.5
    with pytest.raises(ValueError):
        bk.pair_attention(buf[1:].view(3 * 50, 3 * 4 * 64), 50, 4)
    assert bk.LAUNCHES == before
    out = torch.empty(3 * 50, 4 * 32, device=cuda)
    lib = _build.load()
    for f32, t in ((0, qkv.bfloat16()), (1, qkv)):
        assert lib.jcf_pair_attention(t.data_ptr(), out.data_ptr(), 3, 50, 4, 32, 1.0, 0.0, f32,
                                      _build.stream_ptr(cuda)) != 0
    qkv = buf[:-1].view(3 * 50, 3 * 4 * 64)
    _f32_close(bk.pair_attention(qkv, 50, 4), bk.pair_attention_plain(qkv, 50, 4))
    assert bk.LAUNCHES["pair_attention_f32"] == before["pair_attention_f32"] + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [False, True])
def test_float_tower_kernels_vs_plain(cuda, dtype, causal):
    """A 2-layer full-width float tower (ViT-B/32's vision tower at S = 50
    mask-free, its text tower at 77 causal): the kernels vs the plain
    versions on the CPU; 7 launches a layer (the causal attention also
    counted by its route in bf16), no weight split (the f32 tree carries
    its TF32 planes, split before the count), nothing of K7."""
    cfg = CLIPConfig(vision_layers=2, text_layers=2)
    p = init_clip_params(0, cfg)
    blocks, s, h, e = ((p["text"]["blocks"], 77, 8, 512) if causal
                       else (p["visual"]["blocks"], 50, 12, 768))
    from jcf_tpu_torch.ops import f32_gemm as fg

    x = torch.randn(6 * s, e, generator=torch.Generator().manual_seed(1)).to(dtype)
    ref = bk.run_float_tower(x, blocks, h, s=s, causal=causal)
    on_card = tree_to(blocks, cuda)
    if dtype == torch.float32:
        on_card = fg.with_tf32_planes(on_card)
    counts = (bk.LAUNCHES, at.LAUNCHES, bg.LAUNCHES, fg.LAUNCHES)
    before = {k: v for c in counts for k, v in c.items()}
    got = bk.run_float_tower(x.to(cuda), on_card, h, s=s, causal=causal).cpu()
    after = {k: v for c in counts for k, v in c.items()}
    launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    routes = {k: v for k, v in launched.items() if k.endswith(("/mma", "/rowloop"))}
    splits = launched.get("tf32_split", 0)
    assert sum(launched.values()) - sum(routes.values()) - splits == 2 * 7
    assert splits == 0
    assert "packed_attention" not in launched
    if causal and dtype == torch.bfloat16:  # on the tensor cores; f32 has one route
        assert routes == {"causal_attention/mma": 2}
    else:
        assert routes == {}
    if causal and dtype == torch.float32:
        assert launched["causal_attention_f32"] == 2
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
    names = [f"ln_affine_quant_rows{sfx}", f"ln_quant_rows{sfx}", f"ln_quant{sfx}"]
    # rows of another width than 512 or 768 take the scalar route
    routes = [] if e in bk.LN_QUANT_VEC_WIDTHS else [n + "/scalar" for n in names]
    assert _launched(before) == dict.fromkeys(names + routes, 1)


@pytest.mark.parametrize("s", [17, 50, 64, 77, 127, 128])
@pytest.mark.parametrize("h", [3, 8])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("scaled", [True, False])
def test_masked_attention_kernel(cuda, s, h, causal, scaled):
    """Kernel B vs its plain version on bf16 qkv at head dim 64 (the
    tensor-core kernel, every output kind): the f32 context within 1e-5 +
    1e-5 |ref| + 2^-7 sum_j p_j |v_j| (a p rounding to bf16 across a tie),
    the int8 context within 1 on <= 1e-2, bf16 within 1 ulp + 1e-3 + that
    slack; f32 qkv (the register-tiled kernel, one route) within 1e-5 +
    1e-5 |ref|."""
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
                                 f"{name}_f32": 1, "masked_attention_f32/mma": 1,
                                 "masked_attention/mma": 1, f"{name}/mma": 1}


@pytest.mark.parametrize("causal", [True, False])
def test_masked_attention_row_loop_route(cuda, causal):
    """bf16 qkv at head dim 32 takes the CUDA-core row loop (counted
    "/rowloop"), to the same bars as the tensor-core kernel above; qkv off
    16-byte alignment (both routes load 16 bytes at a time) is refused
    before any launch."""
    g = torch.Generator(device=cuda).manual_seed(32)
    s, h, seqs, d = 50, 3, 7, 32
    e = d * h
    qkv = (torch.randn(seqs * s, 3 * e, device=cuda, generator=g) * 1.5).bfloat16()
    assert bk.attention_route(qkv.dtype, d, qkv.data_ptr()) == "rowloop"
    kw = dict(causal=causal, scale=d ** -0.5)
    absv = torch.cat([qkv[:, : 2 * e], qkv[:, 2 * e :].abs()], dim=1)
    slack = 2.0**-7 * bk.masked_attention_plain(absv, s, h, f32_ctx=True, **kw)
    before = dict(bk.LAUNCHES)
    got = bk.masked_attention(qkv, s, h, f32_ctx=True, **kw)
    ref = bk.masked_attention_plain(qkv, s, h, f32_ctx=True, **kw)
    assert bool(((got - ref).abs() <= 1e-5 + 1e-5 * ref.abs() + slack).all())
    ctx_inv = torch.tensor([[30.0]], device=cuda)
    _int8_close(bk.masked_attention(qkv, s, h, ctx_inv=ctx_inv, **kw),
                bk.masked_attention_plain(qkv, s, h, ctx_inv=ctx_inv, **kw), 1e-2)
    assert _launched(before) == {"masked_attention_f32": 1, "masked_attention": 1,
                                 "masked_attention_f32/rowloop": 1, "masked_attention/rowloop": 1}
    n = seqs * s * 3 * 3 * 64
    off = (torch.randn(n + 8, device=cuda, generator=g)).bfloat16()[2:2 + n].view(seqs * s, -1)
    before = dict(bk.LAUNCHES)
    with pytest.raises(ValueError):
        bk.masked_attention(off, s, 3, f32_ctx=True, **kw)
    assert bk.LAUNCHES == before


def test_masked_attention_f32_refuses_other_head_dims(cuda):
    """f32 qkv takes head dim 64 only (the register-tiled kernel; every f32
    tower's): head dim 32 raises ``ValueError`` and launches nothing, and
    so do f32 rows off 16 bytes; the next launch at head dim 64 runs."""
    g = torch.Generator(device=cuda).manual_seed(33)
    s, h = 50, 3
    before = dict(bk.LAUNCHES)
    for causal in (True, False):
        qkv = torch.randn(4 * s, 3 * h * 32, device=cuda, generator=g)
        with pytest.raises(ValueError):
            bk.masked_attention(qkv, s, h, causal=causal, scale=32 ** -0.5)
    with pytest.raises(ValueError):
        bk.causal_attention(torch.randn(4 * s, 3 * h * 32, device=cuda, generator=g), s, h)
    n = 4 * s * 3 * h * 64
    off = torch.randn(n + 4, device=cuda, generator=g)[2:2 + n].view(4 * s, -1)
    with pytest.raises(ValueError):
        bk.causal_attention(off, s, h)
    assert bk.LAUNCHES == before
    qkv = torch.randn(4 * s, 3 * h * 64, device=cuda, generator=g)
    _f32_close(bk.causal_attention(qkv, s, h), bk.causal_attention_plain(qkv, s, h))
    assert _launched(before) == {"causal_attention_f32": 1}


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
    launched = {"attention_scaled_f32": 1, "attention_scaled_f32/mma": 1}
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
                                 "masked_attention_f32/mma": 2, "quant_rows": 2,
                                 "gelu_quant_rows": 2}
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


@pytest.mark.parametrize("rows", [1, 37, 800])
def test_copy_add_one_and_its_chains(cuda, rows):
    """Probe P4's kernel: x + 1 in bf16 equal to the plain version bit for
    bit, eagerly and in a chain captured in one CUDA graph."""
    from jcf_tpu_torch.scripts import exp_boundary_cost as p4

    x = (torch.randn(rows, 768, device=cuda) * 300).to(torch.bfloat16)
    assert torch.equal(p4.copy_add_one(x), p4.copy_add_one_plain(x))
    replay, out = p4.graph_chain(x, 3)
    replay()
    torch.cuda.synchronize()
    assert torch.equal(out, p4.chain(x, 3, p4.copy_add_one_plain))
    with pytest.raises(ValueError):
        p4.copy_add_one(x.float())


@pytest.mark.parametrize("b,s", [(5, 56), (37, 17), (9, 64)])
def test_batched_dot_kernels(cuda, b, s):
    """Probe P3's kernels, tensor cores and the CUDA-core loop, against the
    plain version at K8's bf16 bar (1 ulp + 1e-3 + 2^-7 sum_j p_j |v_j|)."""
    from jcf_tpu_torch.scripts import exp_batched_dot as p3

    q, k, v = p3.inputs(b, cuda, seed=b + s, s=s)
    ref = p3.batched_dot_plain(q, k, v)
    slack = 2.0**-7 * torch.matmul(p3.probs(q, k), v.float().abs())
    for fn in (p3.batched_dot_mma, p3.batched_dot_loop):
        p3.check_close(fn(q, k, v), ref, slack)
    with pytest.raises(ValueError):
        p3.batched_dot_mma(q.float(), k, v)


@pytest.mark.parametrize("m,n,k", [(200, 72, 128), (130, 768, 3072), (1000, 3072, 768)])
def test_w4a8_gemm_and_unpack(cuda, m, n, k):
    """Probe P1's kernels: the unpack equal to the plain one, and the GEMM
    on packed weights equal bit for bit to the int8 GEMM on the unpacked
    ones, with both epilogues."""
    import numpy as np

    from jcf_tpu_torch.scripts import exp_w4a8 as p1

    rng = np.random.default_rng(m + n + k)
    w4 = p1.pack(rng.integers(-8, 8, (n, k)).astype(np.int8)).to(cuda)
    w = p1.unpack_int4(w4)
    assert torch.equal(w, p1.unpack_int4_plain(w4))
    a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8)).to(cuda)
    scale = torch.from_numpy(rng.random(n, np.float32) * 1e-3).to(cuda)
    bias = torch.from_numpy(rng.standard_normal(n, np.float32)).to(cuda)
    resid = torch.from_numpy(rng.standard_normal((m, n), np.float32)).to(cuda, torch.bfloat16)
    c = torch.tensor(0.0851, device=cuda)
    assert torch.equal(p1.w4a8_gemm_gelu_quant(a, w4, scale, bias, c),
                       ig.int8_gemm_gelu_quant(a, w, scale, bias, c))
    assert torch.equal(p1.w4a8_gemm_residual(a, w4, scale, bias, resid),
                       ig.int8_gemm_residual(a, w, scale, bias, resid))
    with pytest.raises(ValueError):
        p1.w4a8_gemm_residual(a[:, :64], w4, scale, bias, resid)


def test_w4a8_mlp_variants(cuda):
    """Probe P1's three MLP halves equal to each other bit for bit, and
    the int8 one within the int8 bars of the plain ``_mlp_math``."""
    from jcf_tpu_torch.scripts import exp_w4a8 as p1

    wfc_np, wproj_np = p1.weights(3)
    wfc, wproj = torch.from_numpy(wfc_np).to(cuda), torch.from_numpy(wproj_np).to(cuda)
    wfc4, wproj4 = p1.pack(wfc_np).to(cuda), p1.pack(wproj_np).to(cuda)
    c = p1.constants(cuda)
    x = torch.randn(1700, p1.E, device=cuda, generator=torch.Generator(device=cuda).manual_seed(3))
    x = x.to(torch.bfloat16)
    out = p1.mlp_int8(x, wfc, wproj, c)
    assert torch.equal(p1.mlp_w4_step(x, wfc4, wproj4, c), out)
    assert torch.equal(p1.mlp_w4_cache(x, wfc4, wproj4, c), out)
    ref = p1.mlp_w4a8_plain(x, wfc, wproj, c)
    g, r = out.float(), ref.float()
    d = (g - r).abs()
    assert float((d > 2.0**-7 * g.abs().maximum(r.abs()) + 1e-3).float().mean()) <= 2e-2
    assert bool((d <= 0.05 + 0.05 * r.abs()).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
@pytest.mark.parametrize("n,side,patch", [(3, 224, 32), (5, 64, 16), (2, 96, 32), (1, 224, 32),
                                          (1200, 224, 32), (10000, 64, 16)])
def test_patch_regroup_kernels(cuda, dtype, n, side, patch):
    """Probe P2's three strategies equal to the plain regroup bit for bit.
    A's persistent grid holds as many blocks as fit on the card (at most
    32 an SM); 1200 planes of 224² and 10,000 of 64² give its blocks
    several planes, and every plane has more bands (7 at 224², 4 at 64²)
    than a block's ring holds (3), so the ring wraps."""
    from jcf_tpu_torch.scripts import exp_patch_regroup as p2

    x = p2.planes(n, dtype, cuda, seed=n, side=side)
    ref = p2.patch_regroup_plain(x, patch)
    for s in p2.STRATEGIES:
        assert torch.equal(p2.patch_regroup(x, s, patch), ref), s


# ---------------------------------------------------------------------------
# K1's band kernel in both layouts, and the LN + int8 quant row kernel's
# vector and scalar routes
# ---------------------------------------------------------------------------

# (source H, W, view side, patch): the serving cell (256² -> 224, p = 32),
# ViT-B/16's p = 16, 288² from 329² sources (rows of 658 bytes: the narrow
# loads), a width off 8 (75), a 768-wide source (views of up to 7 taps) and
# a 32² view of a 256² source (past the unrolled taps: the general instance)
VIEW_SHAPES = [(256, 256, 224, 32), (256, 256, 224, 16), (329, 329, 288, 32), (80, 75, 48, 16),
               (768, 768, 224, 32), (256, 256, 32, 16)]


@pytest.mark.parametrize("h,w,out,p", VIEW_SHAPES)
def test_view_kernel_layouts(cuda, h, w, out, p):
    """K1's three modes vs their plain versions (int8 off by one on <= 0.5%,
    bf16 1 ulp + 1e-3, f32 1e-5 + 1e-5 |ref|); the int8 patch rows equal to
    ``_patchify`` of the kernel's own NCHW views bit for bit, and to the
    plain patch rows at the int8 bar."""
    from jcf_tpu_torch.models.clip import _patchify

    gen = torch.Generator(device=cuda).manual_seed(h + w + out + p)
    b, n = 3, 4
    img = torch.rand(b, 3, h, w, device=cuda, generator=gen)
    img_bf = img.bfloat16()
    geo = vk.sample_view_centers(gen, b, n, (h, w), out)
    before = dict(vk.LAUNCHES)
    views = vk.fused_views_nchw(img_bf, *geo, out, quantize=True)
    rows = vk.fused_views_nchw(img_bf, *geo, out, quantize=True, patch=p)
    _int8_close(views, vk.fused_views_nchw_plain(img_bf, *geo, out, quantize=True), 5e-3)
    assert rows.shape == (b * n * (out // p) ** 2, 3 * p * p) and rows.is_contiguous()
    assert torch.equal(rows, _patchify(views.reshape(b * n, 3, out, out), p).reshape(rows.shape))
    _int8_close(rows, vk.fused_views_nchw_plain(img_bf, *geo, out, quantize=True, patch=p), 5e-3)
    _bf16_close(vk.fused_views_nchw(img_bf, *geo, out),
                vk.fused_views_nchw_plain(img_bf, *geo, out))
    _f32_close(vk.fused_views_nchw(img, *geo, out), vk.fused_views_nchw_plain(img, *geo, out))
    assert {k: vk.LAUNCHES[k] - before[k] for k in before} == {
        "view": 2, "view/patch": 1, "view_bf16": 1, "view_f32": 1}


def test_view_kernel_refuses_patch_rows_it_cannot_write(cuda):
    img = torch.rand(1, 3, 64, 64, device=cuda)
    geo = vk.sample_view_centers(torch.Generator(device=cuda).manual_seed(0), 1, 2, (64, 64), 48)
    before = dict(vk.LAUNCHES)
    with pytest.raises(ValueError):  # float views: patch rows are int8 only
        vk.fused_views_nchw(img, *geo, 48, patch=16)
    with pytest.raises(ValueError):  # 48 is not a multiple of 32
        vk.fused_views_nchw(img.bfloat16(), *geo, 48, quantize=True, patch=32)
    assert vk.LAUNCHES == before


def _ln_quant_rows_input(m, e, dtype, device, seed):
    """``_ln_rows_input`` with each offset row's largest deviation pair made
    an odd number of steps: its z-norm is k times one number for integers
    k, and a dynamic scale maps k to 127 k / k_max, which for an even k_max
    puts the values at k_max / 2 on exact rounding ties that any f32 order
    sends either way (``tests/test_torch_ln_quant_rows.py``)."""
    x, scale, bias = _ln_rows_input(m, e, dtype, "cpu", seed)
    step = 1 / 128 if dtype == torch.float32 else 1 / 2
    for i in range(1, m, 3):
        k = torch.round((x[i].double() - 100) / step)
        k_max = float(k.abs().max())
        if k_max % 2 == 0:
            for sign in (1, -1):
                x[i, int((k == sign * k_max).nonzero()[0])] = 100 + sign * (k_max + 1) * step
    return tuple(t.to(device) for t in (x, scale, bias))


def _ln_quant_call(kind, x, scale, bias):
    """(launch-count name, kernel, plain) of the LN + quant kernel's
    instance ``kind``: "static" (the z-norm, a calibrated scale), "dynamic"
    (per-row scales) or "affine" (the f32 LN affine, per-row scales)."""
    sfx = "" if x.dtype == torch.bfloat16 else "_f32"
    if kind == "static":
        inv = torch.tensor([[127.0 / 4.5]], device=x.device)
        return "ln_quant" + sfx, (bk.ln_quant(x, inv), None), (bk.ln_quant_plain(x, inv), None)
    if kind == "dynamic":
        return "ln_quant_rows" + sfx, bk.ln_quant_rows(x), bk.ln_quant_rows_plain(x)
    g, b = scale.float(), bias.float()
    return ("ln_affine_quant_rows" + sfx, bk.ln_affine_quant_rows(x, g, b),
            bk.ln_affine_quant_rows_plain(x, g, b))


def _ln_quant_close(got, ref):
    """int8 within 1 on <= 1e-3 of the elements, scales within 1e-6
    relative."""
    (q, sc), (q_ref, sc_ref) = got, ref
    _int8_close(q, q_ref, 1e-3)
    if sc_ref is not None:
        assert bool(((sc - sc_ref).abs() <= 1e-6 * sc_ref.abs()).all())


@pytest.mark.parametrize("kind", ["static", "dynamic", "affine"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("e", [512, 768])
@pytest.mark.parametrize("m", LN_ROWS)
def test_ln_quant_vector_kernel(cuda, kind, dtype, e, m):
    """The vector instances (E 512 and 768, bf16 and f32 rows; the offset
    rows of ``_ln_rows_input``, where a one-pass variance fails) vs the
    plain versions, counted on the vector route."""
    x, scale, bias = _ln_quant_rows_input(m, e, dtype, cuda, seed=m + e)
    before = dict(bk.LAUNCHES)
    name, got, ref = _ln_quant_call(kind, x, scale, bias)
    _ln_quant_close(got, ref)
    assert _launched(before) == {name: 1}


@pytest.mark.parametrize("kind", ["static", "dynamic", "affine"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("e,misaligned", [(192, False), (1023, False), (768, True)])
def test_ln_quant_scalar_route(cuda, kind, dtype, e, misaligned):
    """Rows off the vector instances (another width, or rows one element
    off 16-byte alignment) take the scalar kernel and count its route."""
    m = 700
    x, scale, bias = _ln_quant_rows_input(m, e, dtype, cuda, seed=e)
    if misaligned:
        buf = torch.empty(m * e + 1, dtype=dtype, device=cuda)
        buf[1:].copy_(x.reshape(-1))
        x = buf[1:].view(m, e)
        assert x.is_contiguous() and x.data_ptr() % 16
    before = dict(bk.LAUNCHES)
    name, got, ref = _ln_quant_call(kind, x, scale, bias)
    _ln_quant_close(got, ref)
    assert _launched(before) == {name: 1, name + "/scalar": 1}


def _misaligned(x):
    """The same values in a tensor whose storage starts one element past a
    16-byte boundary (the wrappers' vector kernels refuse it, so the
    scalar route runs)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    buf[1:].copy_(x.reshape(-1))
    out = buf[1:].view(x.shape)
    assert out.is_contiguous() and out.data_ptr() % 16
    return out


def _quant_rows_input(m, n, device, seed):
    """Seeded f32 rows [m, n]: normal x 3, every fifth row from row 3 all
    zero, row 1 one large value among small ones."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(m, n, generator=g) * 3
    x[3::5] = 0.0
    if m > 1:
        x[1] *= 1e-3
        x[1, n // 2] = 40.0
    return x.to(device)


@pytest.mark.parametrize("gelu", [False, True], ids=["ctx", "gelu"])
@pytest.mark.parametrize("n", [768, 3072, 512, 2048, 72, 192])
@pytest.mark.parametrize("m", [1, 7, 9 * 77, 20011])
def test_quant_rows_vector_route_equals_scalar_route(cuda, gelu, n, m):
    """The vector instances (768, 3072, 512, 2048 their own; 72 and 192
    the general ones) equal the scalar kernel bit for bit, the scalar
    route forced by a misaligned copy of the same rows; both hold the
    plain version's bar (int8 within 1 on <= 1e-3, scales within 1e-6
    relative); each counted on its route. 20011 rows are no multiple of
    the card-sized grid."""
    x = _quant_rows_input(m, n, cuda, seed=m + n)
    name = "gelu_quant_rows" if gelu else "quant_rows"
    before = dict(bk.LAUNCHES)
    q, s = bk.quant_rows(x, gelu=gelu)
    assert _launched(before) == {name: 1}
    before = dict(bk.LAUNCHES)
    q_s, s_s = bk.quant_rows(_misaligned(x), gelu=gelu)
    assert _launched(before) == {name: 1, name + "/scalar": 1}
    assert torch.equal(q, q_s) and torch.equal(s.view(torch.int32), s_s.view(torch.int32))
    q_ref, s_ref = (bk.gelu_quant_rows_plain if gelu else bk.quant_rows_plain)(x)
    _int8_close(q, q_ref, 1e-3)
    assert bool(((s - s_ref).abs() <= 1e-6 * s_ref.abs()).all())
    if m > 3:
        assert int(q[3].abs().max()) == 0 and float(s[3]) == float(s_ref[3])


@pytest.mark.parametrize("gelu", [False, True], ids=["ctx", "gelu"])
@pytest.mark.parametrize("n", [130, 1, 4095])
def test_quant_rows_scalar_route_off_widths_of_four(cuda, gelu, n):
    x = _quant_rows_input(333, n, cuda, seed=n)
    name = "gelu_quant_rows" if gelu else "quant_rows"
    before = dict(bk.LAUNCHES)
    q, s = bk.quant_rows(x, gelu=gelu)
    assert _launched(before) == {name: 1, name + "/scalar": 1}
    q_ref, s_ref = (bk.gelu_quant_rows_plain if gelu else bk.quant_rows_plain)(x)
    _int8_close(q, q_ref, 1e-3)
    assert bool(((s - s_ref).abs() <= 1e-6 * s_ref.abs()).all())


def test_quant_rows_refuses_before_launch(cuda):
    before = dict(bk.LAUNCHES)
    with pytest.raises(ValueError):  # N > 4096
        bk.quant_rows(torch.zeros(4, 4100, device=cuda))
    with pytest.raises(ValueError):  # bf16 rows: the kernel takes f32
        bk.quant_rows(torch.zeros(4, 768, device=cuda).bfloat16(), gelu=True)
    assert bk.LAUNCHES == before


def _assemble_args(b, g, e, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    acc = torch.randint(-20000, 20000, (b, g, g, e), device=device, generator=gen,
                        dtype=torch.int32)
    scale = torch.rand(e, device=device, generator=gen) * 1e-4
    bias = torch.randn(e, device=device, generator=gen)
    pos = torch.randn(g * g, e, device=device, generator=gen).bfloat16()
    lns = 1 + 0.1 * torch.randn(e, device=device, generator=gen)
    lnb = 0.1 * torch.randn(e, device=device, generator=gen)
    cls = ak.make_cls_row(torch.randn(e, device=device, generator=gen), pos[0], lns, lnb)
    return acc, scale, bias, pos, cls, lns, lnb


@pytest.mark.parametrize("e,g,b", [(768, 7, 9), (768, 7, 2000), (768, 9, 33), (512, 7, 21),
                                   (1024, 7, 5), (192, 7, 17)])
def test_assemble_vector_kernel(cuda, e, g, b):
    """E = 768 (its own instance; 7 x 7 and 9 x 9 patches, the 288²
    grid) and the general instance (512, 1024, 192) vs the plain version
    at ``_bf16_close``, CLS rows equal, counted on the vector route."""
    args = _assemble_args(b, g, e, cuda, seed=e + b)
    before = dict(ak.LAUNCHES)
    got = ak.assemble_dense_rows(*args)
    assert {k: ak.LAUNCHES[k] - before[k] for k in before} == {"assemble": 1, "assemble/scalar": 0}
    ref = ak.assemble_dense_rows_plain(*args)
    _bf16_close(got, ref)
    assert torch.equal(got[:: g * g + 1], args[4].expand(b, e))


@pytest.mark.parametrize("e,misaligned", [(132, False), (768, True)])
def test_assemble_scalar_route(cuda, e, misaligned):
    """A width off multiples of 8, or misaligned accumulators, take the
    scalar kernel and count its route."""
    acc, *rest = _assemble_args(13, 7, e, cuda, seed=e)
    if misaligned:
        acc = _misaligned(acc)
    before = dict(ak.LAUNCHES)
    got = ak.assemble_dense_rows(acc, *rest)
    assert {k: ak.LAUNCHES[k] - before[k] for k in before} == {"assemble": 1, "assemble/scalar": 1}
    _bf16_close(got, ak.assemble_dense_rows_plain(acc, *rest))


def test_assemble_refuses_before_launch(cuda):
    args = _assemble_args(2, 7, 1032, cuda, seed=0)
    before = dict(ak.LAUNCHES)
    with pytest.raises(ValueError):  # E > 1024
        ak.assemble_dense_rows(*args)
    assert ak.LAUNCHES == before


@pytest.mark.parametrize("width,s,crops,nsp,dynamic", [
    (128, 17, 1, 1, False), (128, 50, 3, 2, True), (256, 100, 2, 4, False),
    (256, 33, 5, 1, True), (384, 50, 2, 1, True), (384, 66, 3, 2, True)])
def test_persistent_int8_layers(cuda, monkeypatch, width, s, crops, nsp, dynamic):
    """K9a's dense branches and K9c on the persistent kernel at narrow and
    ragged shapes (fewer rows than one 128-row tile; widths whose rows
    leave lanes idle; a dynamic hidden past 1024 columns, a block a row)
    vs their plain versions, static "full" or dynamic, at nsp chunks: one
    launch each, counted under its branch."""
    monkeypatch.setattr(bk, "_MLP_NSPLIT", nsp)
    from jcf_tpu_torch.ops.quant import quantize_clip_params

    h = width // 64
    if dynamic:
        params = init_clip_params(0, CLIPConfig(vision_layers=3, vision_width=width))
        tree = quantize_clip_params(params, fold=True, heads={"visual": h})["visual"]
    else:
        tree = _int8_tree(width, layers=3)
    tree = tree_to(tree, cuda)
    x = torch.randn(crops * s, width, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(s)).bfloat16()
    branch = "long" if s > 64 else ""
    before = dict(bk.LAUNCHES)
    _rows_close(bk.block_int8(x, layer_slice(tree, 1), s, h),
                bk.block_int8_plain(x, layer_slice(tree, 1), s, h))
    got = bk.stream_tower_int8(x, tree, h, s=s).float()
    ref = bk.stream_tower_int8_plain(x, tree, h, s=s).float()
    assert float(torch.nn.functional.cosine_similarity(got, ref).min()) >= 0.999
    want = {"block_int8": 1, "stream_tower_int8": 1}
    if branch:
        want.update({f"block_int8/{branch}": 1, f"stream_tower_int8/{branch}": 1})
    assert {k: bk.LAUNCHES[k] - before[k] for k in before if bk.LAUNCHES[k] != before[k]} == want
