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

from jcf_tpu_torch.models.clip import CLIPConfig, init_clip_params
from jcf_tpu_torch.ops import assemble_kernel as ak
from jcf_tpu_torch.ops import block_kernel as bk
from jcf_tpu_torch.ops import int8_gemm as ig
from jcf_tpu_torch.ops import view_kernel as vk

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
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
    got = vk.fused_views_nchw(images, cy, cx, inv, 48)
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


def test_tower_kernels_vs_plain(cuda):
    """A 2-layer full-width tower: the kernel route vs the same tower run
    from the plain versions (the tree moved to the CPU)."""
    from jcf_tpu_torch.ops.quant import quantize_clip_params

    cfg = CLIPConfig(vision_layers=2)
    params = init_clip_params(0, cfg)
    amax = torch.tensor([[6.0, 6.0, 3.0, 4.0]] * 2)
    tree = quantize_clip_params(params, heads={"visual": 12}, act_scales={"visual": amax})["visual"]
    x = torch.randn(16 * 50, 768, generator=torch.Generator().manual_seed(0)).bfloat16()
    ref = bk.run_fused_tower(x, tree, 12, flat_s=50)
    tree_gpu = {half: {k: (type(v)(*(t.to(cuda) for t in v)) if isinstance(v, tuple) else v.to(cuda))
                       for k, v in d.items()} for half, d in tree.items()}
    got = bk.run_fused_tower(x.to(cuda), tree_gpu, 12, flat_s=50).cpu()
    cos = torch.nn.functional.cosine_similarity(got.float(), ref.float())
    assert float(cos.min()) >= 0.999


def test_wrappers_raise_instead_of_falling_back(cuda):
    images = torch.rand(1, 3, 64, 64, device=cuda)  # f32: the kernel takes bf16
    cy = torch.zeros(1, 2, 32, device=cuda)
    inv = torch.ones(1, 2, 2, device=cuda)
    with pytest.raises(TypeError):
        vk.fused_views_nchw(images, cy, cy, inv, 32)
    with pytest.raises(ValueError):
        bk.attention(torch.zeros(65, 3 * 128, device=cuda).bfloat16(),
                     torch.ones(1, device=cuda), 65, 2)
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
