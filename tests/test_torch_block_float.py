"""K9b (``csrc/block_float.cu``) on the CPU: its f32 arithmetic and the
wrapper's chunk and operand checks.

The kernel runs only on the card. Here:
- its f32 math: ``block_f32_plain`` with every product taken as the
  kernel takes it, three TF32 products with a fresh partial per 32-deep
  stage (``_tf32_emulation.split_products``, the emulation that holds the
  f32 GEMM), against the JAX package's ``_block_kernel`` at
  ``Precision.HIGHEST`` in Pallas interpret mode (``run_fused_tower``
  under ``_FUSE = "block"``), on the same numpy weights and rows, at the
  f32 bar of the card (1e-5 + 1e-5 |ref|): S = 77 causal, S = 50 with a
  zero bias, and a 3072-wide hidden on one and two sequences (the error
  of the split through both LayerNorms and the widest product);
- the wrapper's chunk (``_chunk_seqs``): all the sequences unless a GPU
  test forces fewer, whole sequences with a partial last chunk, and
  refusals of a bad chunk; and ``_block_float``'s refusals of operands
  it does not take, before anything reaches the card;
- ``scripts/ab_block_float.py`` at a small size with JAX blocked.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jcf_tpu.ops.block_kernel as jbk
from _tf32_emulation import split_products
from jcf_tpu.ops.attention import causal_mask as j_causal_mask
from jcf_tpu_torch.ops import block_kernel as tbk
from jcf_tpu_torch.ops.attention import causal_mask

torch.set_num_threads(1)


def _layer(e, hidden, seed):
    """One f32 float block (the JAX layout, a leading layer axis of 1),
    LN affines and biases nonzero."""
    rng = np.random.default_rng(seed)

    def n(*shape, std=0.02):
        return (std * rng.standard_normal((1, *shape))).astype(np.float32)

    return {"ln_1": {"scale": 1 + n(e, std=0.1), "bias": n(e, std=0.1)},
            "ln_2": {"scale": 1 + n(e, std=0.1), "bias": n(e, std=0.1)},
            "attn": {"w_qkv": n(3 * e, e, std=0.05), "b_qkv": n(3 * e), "w_out": n(e, e),
                     "b_out": n(e)},
            "mlp": {"c_fc": {"w": n(hidden, e), "b": n(hidden)},
                    "c_proj": {"w": n(e, hidden), "b": n(e)}}}


def _emulated(a, w):
    """``matmul_plain`` as the f32 kernel computes it."""
    return split_products(a.float(), w.float())


@pytest.mark.parametrize("s,causal,e,hidden,n_seq", [
    (77, True, 128, 512, 3), (50, False, 128, 512, 3), (50, False, 128, 3072, 1),
    (77, True, 128, 3072, 2)])
def test_block_f32_split_math_matches_jax_highest(monkeypatch, s, causal, e, hidden, n_seq):
    monkeypatch.setattr(jbk, "_FUSE", "block")
    heads = e // 64
    blocks = _layer(e, hidden, s + hidden)
    x = np.random.default_rng(s + n_seq).standard_normal((n_seq * s, e)).astype(np.float32)
    mask = j_causal_mask(s) if causal else None
    want = np.asarray(jbk.run_fused_tower(jnp.asarray(x.reshape(-1, s, e)),
                                          jax.tree_util.tree_map(jnp.asarray, blocks), heads,
                                          mask, interpret=True)).reshape(-1, e)
    layer = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a[0])), blocks)
    bias = causal_mask(s) if causal else torch.zeros(s, s)
    monkeypatch.setattr(tbk, "matmul_plain", _emulated)
    got = tbk.block_f32_plain(torch.from_numpy(x), layer, s, heads, bias).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    bad = np.abs(got - want) > 1e-5 + 1e-5 * np.abs(want)
    assert not bad.any(), (float(np.abs(got - want).max()), int(bad.sum()))


def _chunk_rows(n_seq, s, chunk):
    """The rows of each chunk the kernel walks (``block_float.cu``: chunks
    of ``chunk`` sequences, the last one what is left)."""
    return [min(chunk, n_seq - q) * s for q in range(0, n_seq, chunk)]


@pytest.mark.parametrize("n_seq,chunk,want", [(9, None, 9), (1, None, 1), (9, 4, 4), (9, 20, 9),
                                              (9, 1, 1), (8192, None, 8192)])
def test_chunk_seqs_takes_whole_sequences(n_seq, chunk, want):
    """All the sequences in one chunk unless a chunk is forced; forced, at
    most all of them, the last chunk partial where it does not divide."""
    k = tbk._chunk_seqs(n_seq, chunk)
    assert k == want
    rows = _chunk_rows(n_seq, 50, k)
    assert sum(rows) == n_seq * 50 and rows[:-1] == [k * 50] * (len(rows) - 1)
    assert rows[-1] == (n_seq % k or k) * 50


@pytest.mark.parametrize("chunk", ["all", 0, -2, 2.5, True])
def test_chunk_seqs_refuses(chunk):
    with pytest.raises(ValueError, match="chunk"):
        tbk._chunk_seqs(9, chunk)


def _torch_layer(e, hidden):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a[0])), _layer(e, hidden, 0))


def _bad_operand(kind, layer, s):
    """(layer, bias) with one operand ``_block_float`` does not take (for
    "chunk", both as it takes them)."""
    bias = torch.zeros(s, s)
    if kind == "bias dtype":
        return layer, bias.bfloat16()
    if kind == "bias shape":
        return layer, torch.zeros(s, s + 1)
    if kind == "qkv shape":
        layer["attn"]["w_qkv"] = layer["attn"]["w_qkv"][:-1]
    elif kind == "ln bias":
        layer["ln_2"]["bias"] = layer["ln_2"]["bias"][:-1]
    elif kind == "c_proj shape":
        layer["mlp"]["c_proj"]["w"] = layer["mlp"]["c_proj"]["w"].T.contiguous()
    return layer, bias


@pytest.mark.parametrize("kind,match", [("bias dtype", "bias"), ("bias shape", "bias"),
                                        ("qkv shape", "operand 2"), ("ln bias", "operand 7"),
                                        ("c_proj shape", "operand 10"), ("chunk", "chunk")])
def test_block_float_refuses_before_the_launch(kind, match):
    """Each refusal comes before the kernel library is loaded (which needs
    the card), so it is seen here on CPU tensors."""
    s, e, hidden = 17, 128, 512
    layer, bias = _bad_operand(kind, _torch_layer(e, hidden), s)
    x = torch.zeros(2 * s, e)
    with pytest.raises(ValueError, match=match):
        tbk._block_float("block_f32", x, layer, s, 2, bias, torch.float32,
                         chunk=0 if kind == "chunk" else None)


_AB_BLOCKED = """
import sys
sys.modules["jax"] = None
sys.modules["jcf_tpu"] = None
from jcf_tpu_torch.scripts import ab_block_float
assert ab_block_float.main(["--device", "cpu", "--scale", "1024", "--rounds", "1", "--reps", "1"]) == 0
loaded = {m.split(".")[0] for m in sys.modules if sys.modules[m] is not None}
assert not loaded & {"jax", "jcf_tpu"}, loaded
"""


def test_ab_block_float_runs_on_the_cpu_without_jax():
    """The A/B script at 1/1024 of its shapes on the CPU with JAX blocked:
    the device line, the package, then per shape its bound, K9b's check
    against plain (the plain version itself here) and time, the halves'
    and the yardstick's."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _AB_BLOCKED], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("device: cpu")
    labels = []
    for tag, rows in (("bf16 vision", "8 x 50 x 768"), ("bf16 text", "1 x 77 x 512"),
                      ("f32 vision", "4 x 50 x 768"), ("f32 text", "1 x 77 x 512")):
        name = "block_bf16" if tag.startswith("bf16") else "block_f32"
        labels += [f"{tag}, {rows}"] + [f"{name} {tag}, {rows}"] * 2
        labels += [f"halves {tag}, {rows}", f"yardstick TransformerEncoderLayer {tag}, {rows}"]
    assert [line.split(":")[0] for line in lines[2:]] == labels
    checks = [line for line in lines if "vs plain" in line]
    assert len(checks) == 4 and all("max |diff| 0.000e+00" in line for line in checks)
