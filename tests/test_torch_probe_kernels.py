"""The port's probes P1-P3 (``jcf_tpu_torch/scripts``) on the CPU against
the TPU probes in ``scripts/``, whose kernels run through
``pl.pallas_call(..., interpret=True)`` with the scripts' BlockSpecs:

- P3 (``exp_batched_dot``): ``kernel_batched`` and ``kernel_loop`` on a
  grid of 2 steps of 96 heads, [192, 56, 64] bf16, against the port's
  plain version at K8's bf16 bar: 1 bf16 ulp + 1e-3 + 2^-7 sum_j p_j
  |v_j| (how far p's rounding to bf16 moves an output; CPU XLA may keep
  bf16 intermediates in f32).
- P1 (``exp_w4a8``): ``_unpack_int4`` over all 256 byte values and the
  script's ``pack``, equal to the port's; the three ``build(kind)``
  calls at ``JCF_W4_ROWS`` = 1600 against ``mlp_w4a8_plain``, and the
  port's K4 composition against ``_mlp_math``, at the int8 bars of
  ``tests/test_torch_masked_int8.py`` (within 1 bf16 ulp + 1e-3 on all
  but 2% of the elements, everywhere within 0.05 + 0.05 |ref|, row cos
  >= 0.999: CPU XLA's tanh and torch's differ in the last bit, which
  moves int8 ties of the hidden).
- P2 (``exp_patch_regroup``): kernels A, B and C at 4 planes, f32 and
  int8, against the port's plain regroup and the script's numpy check,
  bit for bit.
- Each script's ``main`` on the CPU at a small size (also the A/B
  scripts ``ab_attention``, ``ab_gemm``, ``ab_rows`` and ``ab_views``, run
  as files),
  and the port's modules free of JAX and ``jcf_tpu``.
"""

import contextlib
import functools
import importlib.util
import io
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from jcf_tpu_torch.scripts import exp_batched_dot as p3
from jcf_tpu_torch.scripts import exp_patch_regroup as p2
from jcf_tpu_torch.scripts import exp_w4a8 as p1
from jcf_tpu_torch.scripts.common import PEAK_BF16, PEAK_INT8, bound_ms

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def tpu_probe(monkeypatch, tmp_path):
    """Loads ``scripts/<name>.py`` as a fresh module. ``exp_w4a8`` points
    JAX's compilation cache at its directory when loaded: the cache goes to
    ``tmp_path`` and JAX's settings are restored afterwards."""
    saved = {k: getattr(jax.config, k) for k in ("jax_compilation_cache_dir",
                                                 "jax_persistent_cache_min_compile_time_secs")}
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))

    def load(name: str):
        spec = importlib.util.spec_from_file_location(f"tpu_{name}",
                                                      ROOT / "scripts" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    yield load
    for k, v in saved.items():
        jax.config.update(k, v)


def _interpret(module) -> None:
    """Routes the module's ``pl.pallas_call`` to interpret mode."""
    module.pl = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True), BlockSpec=pl.BlockSpec,
        when=pl.when, program_id=pl.program_id)


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16, as f32."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _close_bf16(got, ref, share=2e-2):
    d = np.abs(got - ref)
    over = (d > 2.0**-7 * np.maximum(np.abs(got), np.abs(ref)) + 1e-3).mean()
    assert over <= share, over
    cos = ((got * ref).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(ref, axis=-1)))
    assert cos.min() >= 0.999, cos.min()
    np.testing.assert_allclose(got, ref, atol=5e-2, rtol=5e-2)


# ---------------------------------------------------------------------------
# P3
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kernel", ["kernel_batched", "kernel_loop"])
def test_batched_dot_equals_the_tpu_probe(tpu_probe, kernel, seed):
    tpu = tpu_probe("exp_batched_dot")
    gh = tpu.GROUP * tpu.H
    shape = (2 * gh, tpu.S, tpu.D)
    vmem = functools.partial(pl.BlockSpec, memory_space=pltpu.VMEM)
    fn = pl.pallas_call(getattr(tpu, kernel), grid=(2,),
                        in_specs=[vmem((gh, tpu.S, tpu.D), lambda i: (i, 0, 0))] * 3,
                        out_specs=vmem((gh, tpu.S, tpu.D), lambda i: (i, 0, 0)),
                        out_shape=jax.ShapeDtypeStruct(shape, jnp.bfloat16), interpret=True)
    q, k, v = p3.inputs(2 * gh, "cpu", seed)
    ref = np.asarray(fn(*(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v))))
    got = p3.batched_dot_mma(q, k, v)
    assert p3.LAUNCHES == {"batched_dot_mma": 0, "batched_dot_loop": 0}
    assert torch.equal(p3.batched_dot_loop(q, k, v), got)
    slack = 2.0**-7 * torch.matmul(p3.probs(q, k), v.float().abs())
    p3.check_close(torch.from_numpy(ref.astype(np.float32)).to(torch.bfloat16), got, slack)


def test_batched_dot_work_and_bound():
    """12,288 heads of [56, 64]: 352 MB moved, 9.9 GFLOP; bound by bytes."""
    n_bytes, flops = p3.work(128 * 96, 56, 64)
    assert n_bytes == 4 * 12288 * 56 * 64 * 2 and flops == 4 * 12288 * 56 * 56 * 64
    ms, by = bound_ms(n_bytes, flops, PEAK_BF16)
    assert by == "bytes" and abs(ms - n_bytes / 3.35e12 * 1e3) < 1e-12


# ---------------------------------------------------------------------------
# P1
# ---------------------------------------------------------------------------


def test_unpack_int4_all_bytes(tpu_probe):
    tpu = tpu_probe("exp_w4a8")
    packed = np.arange(-128, 128, dtype=np.int16).astype(np.int8).reshape(16, 16)
    ref = np.asarray(tpu._unpack_int4(jnp.asarray(packed), 32))
    got = p1.unpack_int4_plain(torch.from_numpy(packed))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.dtype == torch.int8 and set(np.unique(ref)) == set(range(-8, 8))
    assert p1.LAUNCHES["unpack_int4"] == 0


def test_pack_equals_the_tpu_probe(tpu_probe):
    """The script's ``pack`` (local to its ``main``) on every int4 value."""
    tpu = tpu_probe("exp_w4a8")
    code = next(c for c in tpu.main.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == "pack")
    tpu_pack = types.FunctionType(code, vars(tpu))
    w = np.random.default_rng(0).integers(-8, 8, (24, 64)).astype(np.int8)
    np.testing.assert_array_equal(p1.pack(w).numpy(), np.asarray(tpu_pack(jnp.asarray(w))))
    np.testing.assert_array_equal(p1.unpack_int4_plain(p1.pack(w)).numpy(), w)


def _w4_inputs(rows: int, seed: int):
    wfc, wproj = p1.weights(seed)
    x = _bf16(np.random.default_rng(seed + 7).standard_normal((rows, p1.E), np.float32))
    return x, wfc, wproj


@pytest.mark.parametrize("kind", ["int8", "w4_step", "w4_cache"])
def test_w4a8_kernels_equal_the_plain_mlp(tpu_probe, monkeypatch, kind):
    monkeypatch.setenv("JCF_W4_ROWS", "1600")
    tpu = tpu_probe("exp_w4a8")
    assert tpu.ROWS == 1600 and tpu.ROWS // tpu.TILE == 2
    _interpret(tpu)
    x, wfc, wproj = _w4_inputs(tpu.ROWS, 0)
    w = (wfc, wproj) if kind == "int8" else (p1.pack(wfc).numpy(), p1.pack(wproj).numpy())
    ref = np.asarray(tpu.build(kind)(jnp.asarray(x, jnp.bfloat16),
                                     *(jnp.asarray(a) for a in w))).astype(np.float32)
    c = p1.constants("cpu")
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = p1.mlp_w4a8_plain(xt, torch.from_numpy(wfc), torch.from_numpy(wproj), c)
    _close_bf16(got.float().numpy(), ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_k4_composition_computes_mlp_math(tpu_probe, seed):
    """``mlp_int8`` (``ln_quant``, the GELU-quant c_fc epilogue, the
    residual c_proj epilogue) against the probe's ``_mlp_math``; the
    int4 variants equal to it on the CPU too."""
    tpu = tpu_probe("exp_w4a8")
    x, wfc, wproj = _w4_inputs(96, seed)
    ref = np.asarray(jax.jit(tpu._mlp_math)(jnp.asarray(x, jnp.bfloat16), jnp.asarray(wfc),
                                            jnp.asarray(wproj), jnp.float32(10.0)))
    c = p1.constants("cpu")
    xt = torch.from_numpy(x).to(torch.bfloat16)
    wfc_t, wproj_t = torch.from_numpy(wfc), torch.from_numpy(wproj)
    got = p1.mlp_int8(xt, wfc_t, wproj_t, c)
    _close_bf16(got.float().numpy(), ref.astype(np.float32))
    assert torch.equal(got, p1.mlp_w4a8_plain(xt, wfc_t, wproj_t, c))
    for fn in (p1.mlp_w4_step, p1.mlp_w4_cache):
        assert torch.equal(fn(xt, p1.pack(wfc), p1.pack(wproj), c), got)
    assert float(c["gelu_c"]) == np.float32(0.851) / np.float32(10.0)


def test_w4a8_work_and_bound():
    """409,600 rows: 3.87 T int8 operations, 1.953 ms at 1979 TOP/s."""
    n_bytes, ops = p1.work(409600)
    assert ops == 2 * 409600 * 768 * 3072 * 2
    ms, by = bound_ms(n_bytes, ops, PEAK_INT8)
    assert by == "operations" and abs(ms - 1.9534) < 1e-3


# ---------------------------------------------------------------------------
# P2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("kernel", ["kernel_a", "kernel_b", "kernel_c"])
def test_patch_regroup_equals_the_tpu_probe(tpu_probe, kernel, dtype):
    tpu = tpu_probe("exp_patch_regroup")
    n = 4
    x = p2.planes(n, p2.DTYPES[dtype], "cpu", seed=3)
    jdt = jnp.float32 if dtype == "f32" else jnp.int8
    fn = pl.pallas_call(getattr(tpu, kernel), grid=(n,),
                        in_specs=[pl.BlockSpec((1, 224, 224), lambda i: (i, 0, 0),
                                               memory_space=pltpu.VMEM)],
                        out_specs=pl.BlockSpec((1, 49, 1024), lambda i: (i, 0, 0),
                                               memory_space=pltpu.VMEM),
                        out_shape=jax.ShapeDtypeStruct((n, 49, 1024), jdt), interpret=True)
    ref = np.asarray(fn(jnp.asarray(x.numpy())))
    for s in p2.STRATEGIES:
        got = p2.patch_regroup(x, s).numpy()
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got[0], p2.numpy_reference(x[0].numpy()))
    assert all(v == 0 for v in p2.LAUNCHES.values())


# ---------------------------------------------------------------------------
# the scripts' mains, and the port's imports
# ---------------------------------------------------------------------------


def _main_lines(module, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert module.main(argv) == 0
    return out.getvalue().splitlines()


def test_batched_dot_main_runs_on_the_cpu():
    lines = _main_lines(p3, ["--device", "cpu", "--grid", "1", "--group", "1", "--iters", "1"])
    assert lines[0].startswith("device: cpu")
    assert lines[1].startswith("batched :") and "H100 bound" in lines[1]
    assert lines[2].startswith("loop    :") and lines[3].startswith("sdpa    :")


def test_w4a8_main_runs_on_the_cpu():
    lines = _main_lines(p1, ["--device", "cpu", "--rows", "48", "--iters", "1"])
    assert lines[0].startswith("device: cpu")
    sums = [re.search(r"checksum (\S+)\)", line).group(1) for line in lines[1:4]]
    assert [line.split()[0] for line in lines[1:4]] == ["int8", "w4_step", "w4_cache"]
    assert len(set(sums)) == 1 and "H100 bound" in lines[1]
    assert lines[4] == "int8, w4_step and w4_cache outputs equal bit for bit"


def test_patch_regroup_main_runs_on_the_cpu():
    lines = _main_lines(p2, ["--device", "cpu", "--planes", "2", "--iters", "1"])
    assert lines[0].startswith("device: cpu")
    assert lines[1].startswith("--- f32 (2 planes") and lines[6].startswith("--- int8")
    assert sum("ok=True" in line for line in lines) == 6
    assert sum(line.startswith("plain (view/permute/reshape copy)") for line in lines) == 2


_AB_LABELS = ["K8 blocked_attention bf16, 1 x 12 x 197", "K8 blocked_attention f32, 1 x 12 x 197",
              "K8 blocked_attention f32, 1 x 16 x 577",
              "pair_attention bf16, 4 x 50", "pair_attention f32, 4 x 50",
              "K3 attention (int8 context), 4 x 50",
              "K3 attention +score (int8 context, shift), 4 x 50",
              "K3 attention_f32 (f32 context), 4 x 50",
              "K3 attention_scaled_f32 (f32 context, unfolded), 4 x 50",
              "K3 attention (int8 context), 1 x 82",
              "batched_dot_mma, 6 heads x 56",
              "masked_attention_f32 (f32 context), 1 x 77 x 8, causal",
              "masked_attention (int8 context), 1 x 77 x 8, causal",
              "causal_attention bf16, 1 x 77 x 8", "causal_attention_f32, 1 x 77 x 8",
              "head_attention bf16, 1 x 50 x 3", "head_attention_f32, 1 x 50 x 3",
              *[f"K7 {way} {dt} {tower}, 1 x {s} x {h}"
                for tower, s, h in (("text", 77, 8), ("vision", 50, 12))
                for dt in ("bf16", "f32") for way in ("forward", "backward")]]


def test_ab_attention_runs_as_a_file_on_the_cpu():
    """The A/B script as the card runs it (a file, the checkout's root as
    ROOT), at one crop on the CPU: the device line, the package it timed,
    then one line a kernel with its checksum (the plain versions' here)."""
    script = ROOT / "jcf_tpu_torch" / "scripts" / "ab_attention.py"
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(script), str(ROOT), "--device", "cpu", "--crops",
                          "1", "--rounds", "2", "--reps", "1"], cwd=ROOT / "tests", env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("device: cpu")
    assert lines[1] == f"package: {ROOT / 'jcf_tpu_torch'}"
    assert [line.split(":")[0] for line in lines[2:]] == _AB_LABELS
    assert all("(2 x 1), checksum" in line for line in lines[2:])


def test_ab_attention_times_one_package_only():
    """Imported as a module, the script times the package already loaded
    and refuses another checkout's."""
    from jcf_tpu_torch.scripts import ab_attention

    assert ab_attention.import_package(ROOT) == str(ROOT / "jcf_tpu_torch")
    with pytest.raises(RuntimeError, match="already imported"):
        ab_attention.import_package(ROOT / "build" / "parent")


_AB_GEMM_LABELS = ["s32 patch embed, 98 x 3072 -> 768", "bf16 qkv, 100 x 768 -> 2304",
                   "bf16_rows qkv, 100 x 768 -> 2304", "residual out-proj, 100 x 768 -> 768",
                   "residual c_proj, 100 x 3072 -> 768", "residual_rows c_proj, 100 x 3072 -> 768",
                   "gelu_quant c_fc, 100 x 768 -> 3072", "f32 c_fc, 100 x 768 -> 3072",
                   "f32_rows c_fc, 100 x 768 -> 3072", "w4a8 gelu_quant c_fc, 100 x 768 -> 3072",
                   "w4a8 residual c_proj, 100 x 3072 -> 768", "rowscale qkv, 197 x 768 -> 2304",
                   "rowscale c_fc, 197 x 768 -> 3072", "residual_f32 c_proj, 77 x 2048 -> 512",
                   "residual_f32_rows c_proj, 77 x 2048 -> 512",
                   "residual_f32 out-proj, 77 x 512 -> 512",
                   "residual_f32_rows out-proj, 77 x 512 -> 512"]
_AB_GEMM_LABELS += [f"{e} on the {name} product, 100 x {k} -> {n}"
                    for name, k, n in (("qkv", 768, 2304), ("c_fc", 768, 3072),
                                       ("c_proj", 3072, 768))
                    for e in ("s32", "bf16", "f32", "gelu_quant", "residual")]
_AB_GEMM_LABELS += [f"{tag}_gemm_{epi} {tower} {name}, {rows} x {k} -> {n}"
                    for tag in ("bf16", "f32")
                    for tower, rows, e in (("text", 77, 512), ("vision", 100, 768))
                    for name, k, n, epi in (("qkv", e, 3 * e, "bias"), ("out-proj", e, e, "residual"),
                                            ("c_fc", e, 4 * e, "gelu"),
                                            ("c_proj", 4 * e, e, "residual"))]
_AB_GEMM_LABELS += ["tf32_split c_fc weights, 3072 x 768"]


def test_ab_gemm_runs_as_a_file_on_the_cpu():
    """The GEMM A/B script as the card runs it (a file, the checkout's root
    as ROOT), at two crops on the CPU: the device line, the package, then
    one line a GEMM with the SHA-256 of its output (the plain versions'
    here, which the kernels equal bit for bit)."""
    script = ROOT / "jcf_tpu_torch" / "scripts" / "ab_gemm.py"
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(script), str(ROOT), "--device", "cpu", "--crops",
                          "2", "--rounds", "1", "--reps", "1"], cwd=ROOT / "tests",
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("device: cpu")
    assert lines[1] == f"package: {ROOT / 'jcf_tpu_torch'}"
    assert [line.split(":")[0] for line in lines[2:]] == _AB_GEMM_LABELS
    assert all("(1 x 1), sha256 " in line for line in lines[2:])


_AB_ROWS_LABELS = [f"{fn} {tag} {tower}, {rows} x {e}"
                   for tag, tower, rows, e in (("bf16", "text", 77, 512), ("bf16", "vision", 100, 768),
                                               ("f32", "vision", 100, 768), ("f32", "text", 77, 512))
                   for fn in ("ln_affine", "F.layer_norm")]
_AB_ROWS_LABELS += [f"{k} {tag}, 2 planes of 224²" for tag in ("f32", "int8")
                    for k in ("patch_regroup_a", "patch_regroup_b", "patch_regroup_c",
                              "plain copy")]


def test_ab_rows_runs_as_a_file_on_the_cpu():
    """The row-kernel A/B script as the card runs it (a file, the
    checkout's root as ROOT), at two crops, one prompt and two planes on
    the CPU: the device line, the package, then one line a launch with the
    SHA-256 of its output; the regroup's strategies and its copy share
    theirs (the plain versions here, which the kernels equal bit for
    bit)."""
    script = ROOT / "jcf_tpu_torch" / "scripts" / "ab_rows.py"
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(script), str(ROOT), "--device", "cpu", "--crops",
                          "2", "--prompts", "1", "--planes", "2", "--rounds", "1", "--reps", "1"],
                         cwd=ROOT / "tests", env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("device: cpu")
    assert lines[1] == f"package: {ROOT / 'jcf_tpu_torch'}"
    assert [line.split(":")[0] for line in lines[2:]] == _AB_ROWS_LABELS
    assert all("(1 x 1), sha256 " in line for line in lines[2:])
    shas = [line.rsplit(" ", 1)[1] for line in lines[-8:]]
    assert len(set(shas[:4])) == 1 and len(set(shas[4:])) == 1


_AB_VIEWS_LABELS = [f"{k}, {tag}" for tag in ("1 x 8 views of 256² into 224²",
                                               "1 x 8 views of 329² into 288²")
                    for k in ("view int8 NCHW", "view int8 NCHW + im2col copy (p 32)",
                              "view int8 patch rows (p 32)", "view bf16 NCHW", "view f32 NCHW")
                    if "329" not in tag or "int8" in k]
_AB_VIEWS_LABELS += [f"{k} {tag}" for tag in ("bf16, 16 x 768", "f32, 39424 x 512")
                     for k in ("ln_quant (static)", "ln_quant_rows (dynamic)",
                               "ln_affine_quant_rows")]


def test_ab_views_runs_as_a_file_on_the_cpu():
    """K1's and the LN + quant rows' A/B script as the card runs it (a
    file, the checkout's root as ROOT), at one image and 16 vision rows on
    the CPU: the device line, the package, then one line a launch with the
    SHA-256 of its output; the patch rows share theirs with the NCHW views
    + the im2col copy in both cells."""
    script = ROOT / "jcf_tpu_torch" / "scripts" / "ab_views.py"
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(script), str(ROOT), "--device", "cpu", "--batch",
                          "1", "--rows", "16", "--rounds", "1", "--reps", "1"],
                         cwd=ROOT / "tests", env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("device: cpu")
    assert lines[1] == f"package: {ROOT / 'jcf_tpu_torch'}"
    assert [line.split(":")[0] for line in lines[2:]] == _AB_VIEWS_LABELS
    assert all("(1 x 1), sha256 " in line for line in lines[2:])
    sha = {line.split(":")[0]: line.rsplit(" ", 1)[1] for line in lines[2:]}
    for tag in ("1 x 8 views of 256² into 224²", "1 x 8 views of 329² into 288²"):
        assert (sha[f"view int8 patch rows (p 32), {tag}"]
                == sha[f"view int8 NCHW + im2col copy (p 32), {tag}"])


def test_no_module_of_the_port_imports_jax():
    """Every module of ``jcf_tpu_torch``, ``chip_smoke.py`` and the root
    ``profile_*.py`` scripts (the port's) import neither JAX nor
    ``jcf_tpu``."""
    pattern = re.compile(r"^\s*(import (jax|jaxlib)\b|from (jax|jaxlib)\b|import jcf_tpu\b|"
                         r"from jcf_tpu(\.| ))", re.M)
    sources = (sorted((ROOT / "jcf_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
               + sorted(ROOT.glob("profile_*.py")))
    assert {"exp_batched_dot.py", "exp_w4a8.py", "exp_patch_regroup.py", "ab_attention.py",
            "ab_gemm.py", "ab_rows.py", "ab_views.py", "profile_k9.py"} <= {p.name for p in sources}
    for path in sources:
        assert not pattern.search(path.read_text()), path


_BLOCKED = """
import sys
sys.modules["jax"] = None
sys.modules["jcf_tpu"] = None
from jcf_tpu_torch.scripts import ab_rows, ab_views, exp_batched_dot, exp_patch_regroup, exp_w4a8
assert exp_batched_dot.main(["--device", "cpu", "--grid", "1", "--group", "1", "--iters", "1"]) == 0
assert exp_w4a8.main(["--device", "cpu", "--rows", "16", "--iters", "1"]) == 0
assert exp_patch_regroup.main(["--device", "cpu", "--planes", "1", "--iters", "1"]) == 0
assert ab_rows.main(["--device", "cpu", "--crops", "1", "--prompts", "1", "--planes", "1",
                     "--rounds", "1", "--reps", "1"]) == 0
assert ab_views.main(["--device", "cpu", "--batch", "1", "--rows", "16", "--rounds", "1",
                      "--reps", "1"]) == 0
loaded = {m.split(".")[0] for m in sys.modules if sys.modules[m] is not None}
assert not loaded & {"jax", "jcf_tpu"}, loaded
print("ok")
"""


def test_probe_scripts_run_with_jax_blocked():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
