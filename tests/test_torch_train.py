"""Stage-1 LoRA training of the port against the JAX package on the CPU.

The step: three f32 steps of ``make_stage1_step`` in both packages on the
same weights, template banks, images, targets and bank indices, with the
port's dropout masks replaced by the ones JAX draws along its key path
(``split`` into text and vision keys, ``fold_in`` of the layer index,
``bernoulli`` per layer). Losses agree within 1e-5 relative; the LoRA
factors and the AdamW moments within rtol 1e-4 / atol 1e-6. A bf16 step
is held to the bars of ``tests/test_torch_text.py``. Then the pieces
around it: AdamW and the cosine schedule against optax and JAX, the
template banks and the LoRA spec from the configuration, checkpoints and
resume."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from jcf_tpu.data import templates as jtemplates
from jcf_tpu.models import clip as jclip
from jcf_tpu.peft import lora as jlora
from jcf_tpu.pipelines import train_lora as jtrain_lora
from jcf_tpu.tokenizer import tokenize as jtokenize
from jcf_tpu.train import adamw as j_adamw
from jcf_tpu.train import cosine_annealing_lr as j_cosine
from jcf_tpu.train import make_stage1_step as j_make_stage1_step
from jcf_tpu_torch import config as tconfig
from jcf_tpu_torch.data import templates as ttemplates
from jcf_tpu_torch.models import clip as tclip
from jcf_tpu_torch.peft import lora as tlora
from jcf_tpu_torch.pipelines import train_lora as ttrain_lora
from jcf_tpu_torch.train import (
    adamw,
    cosine_annealing_lr,
    make_stage1_step,
    state_from_numpy,
    state_to_numpy,
)
from jcf_tpu_torch.utils import load_pytree, save_pytree

torch.set_num_threads(1)

# tests/test_train.py's configuration without the vision prompts
CFG = dict(
    embed_dim=32, image_resolution=32, vision_layers=2, vision_width=64,
    vision_patch_size=8, context_length=77, vocab_size=49408, text_width=128,
    text_heads=2, text_layers=2,
)
SPEC = dict(r=2, alpha=1.0, dropout_rate=0.25, params=("q", "k", "v"), encoder="both",
            position="bottom", backbone="ViT-B/16")
N_CLASSES, BATCH, LR = 5, 8, 1e-3
STEPS = [(0, 0), (1, 1), (2, 0)]  # (PRNGKey seed, bank index)


def _inputs():
    params = jax.tree_util.tree_map(np.array, jclip.init_clip_params(0, jclip.CLIPConfig(**CFG)))
    lora = jax.tree_util.tree_map(np.array, jlora.init_lora_params(
        1, jlora.LoraSpec(**SPEC), CFG["text_layers"], CFG["text_width"], CFG["vision_layers"],
        CFG["vision_width"]))
    banks = np.stack([jtokenize([f"a photo of a class{i} v{b}." for i in range(N_CLASSES)])
                      for b in range(2)])
    rng = np.random.default_rng(5)
    images = rng.standard_normal((BATCH, 3, 32, 32)).astype(np.float32)
    targets = rng.integers(0, N_CLASSES, BATCH).astype(np.int32)
    return params, lora, banks, images, targets


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def _jax_masks(seed):
    """The keep masks JAX's step draws with PRNGKey(seed), in the order the
    port draws them: the text layers, then the vision layers."""
    rng_t, rng_v = jax.random.split(jax.random.PRNGKey(seed))
    s_v = (CFG["image_resolution"] // CFG["vision_patch_size"]) ** 2 + 1
    out = []
    for key, shape in ((rng_t, (3, N_CLASSES, 77, CFG["text_width"])),
                       (rng_v, (3, BATCH, s_v, CFG["vision_width"]))):
        for layer in range(2):
            out.append(np.asarray(jax.random.bernoulli(jax.random.fold_in(key, layer), 0.75, shape)))
    return out


@pytest.fixture(scope="module")
def jax_run():
    """Three f32 steps and one bf16 step of the JAX package."""
    params, lora, banks, images, targets = _inputs()
    out = {}
    for name, dtype, steps in (("f32", jnp.float32, STEPS), ("bf16", jnp.bfloat16, STEPS[:1])):
        init_state, step, frozen = j_make_stage1_step(
            params, jclip.CLIPConfig(**CFG), jlora.LoraSpec(**SPEC), jnp.asarray(banks),
            j_adamw(lr=LR), dtype=dtype, impl="xla")
        step = jax.jit(step)
        state = init_state(lora)
        losses = []
        for seed, bank in steps:
            state, m = step(frozen, state, jnp.asarray(images), jnp.asarray(targets), bank,
                            jax.random.PRNGKey(seed))
            losses.append(float(m["loss"]))
        adam = state.opt_state[0]
        out[name] = (losses, jax.tree_util.tree_map(np.asarray, state.lora),
                     jax.tree_util.tree_map(np.asarray, adam.mu),
                     jax.tree_util.tree_map(np.asarray, adam.nu))
    return out


def _port_steps(dtype, steps, monkeypatch):
    params, lora, banks, images, targets = _inputs()
    pending = []

    def jax_masks(generator, keep, shape, device):
        m = pending.pop(0)
        assert keep == 0.75 and tuple(shape) == m.shape
        return torch.from_numpy(np.array(m))

    monkeypatch.setattr(tlora, "dropout_keep_masks", jax_masks)
    init_state, step, frozen = make_stage1_step(
        _to_torch(params), tclip.CLIPConfig(**CFG), tlora.LoraSpec(**SPEC),
        torch.from_numpy(banks), adamw(lr=LR), dtype=dtype, device="cpu")
    state = init_state(_to_torch(lora))
    losses = []
    for seed, bank in steps:
        pending.extend(_jax_masks(seed))
        state, m = step(frozen, state, torch.from_numpy(images), torch.from_numpy(targets), bank,
                        torch.Generator())
        assert not pending
        losses.append(float(m["loss"]))
    return losses, state


def test_stage1_f32_steps_match_jax(jax_run, monkeypatch):
    ref_losses, ref_lora, ref_mu, ref_nu = jax_run["f32"]
    losses, state = _port_steps(torch.float32, STEPS, monkeypatch)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5, atol=0)
    tree = state_to_numpy(state)
    assert tree["step"] == len(STEPS)
    for got, ref in ((tree["lora"], ref_lora), (tree["mu"], ref_mu), (tree["nu"], ref_nu)):
        for t in ref:
            for k in ref[t]:
                np.testing.assert_allclose(got[t][k], ref[t][k], rtol=1e-4, atol=1e-6,
                                           err_msg=f"{t}/{k}")
    # B started at zero and moved
    assert np.abs(tree["lora"]["vision"]["b_qkv"]).max() > 0


def test_stage1_bf16_step_close_to_jax(jax_run, monkeypatch):
    """bf16 compute, f32 LoRA masters: the loss within 5e-2 relative (CPU
    XLA keeps bf16 intermediates in f32; the port rounds them)."""
    ref_losses = jax_run["bf16"][0]
    losses, state = _port_steps(torch.bfloat16, STEPS[:1], monkeypatch)
    np.testing.assert_allclose(losses, ref_losses, rtol=5e-2)
    assert all(v.dtype == torch.float32 for d in state.lora.values() for v in d.values())


def _small_step(dtype=torch.float32):
    params, lora, banks, images, targets = _inputs()
    init_state, step, frozen = make_stage1_step(
        _to_torch(params), tclip.CLIPConfig(**CFG), tlora.LoraSpec(**SPEC),
        torch.from_numpy(banks), adamw(lr=LR), dtype=dtype, device="cpu")
    return init_state, step, frozen, _to_torch(lora), torch.from_numpy(images), \
        torch.from_numpy(targets)


def test_stage1_step_trains():
    """Port-only, as tests/test_train.py: overfitting a fixed batch lowers
    the loss over 8 steps; only the LoRA moves."""
    init_state, step, frozen, lora, images, targets = _small_step()
    before = {k: v.clone() for k, v in tclip.tree_to(frozen[0]["visual"]["blocks"]["attn"],
                                                       "cpu").items()}
    state = init_state(lora)
    losses = []
    for i in range(8):
        state, m = step(frozen, state, images, targets, 0, torch.Generator().manual_seed(i))
        losses.append(float(m["loss"]))
        assert 0.0 <= float(m["acc"]) <= 1.0
    assert state.step == 8 and losses[-1] < losses[0]
    assert float(state.lora["vision"]["b_qkv"].detach().abs().max()) > 0
    for k, v in frozen[0]["visual"]["blocks"]["attn"].items():
        assert torch.equal(v, before[k]) and not v.requires_grad


def test_resume_gives_the_same_next_step(tmp_path):
    """save_pytree / load_pytree of the numpy state, then the next step:
    equal to the step of the run that never stopped."""
    init_state, step, frozen, lora, images, targets = _small_step()
    state = init_state(lora)
    for i in range(2):
        state, _ = step(frozen, state, images, targets, i % 2, torch.Generator().manual_seed(i))
    save_pytree({"state": state_to_numpy(state), "epoch": 3}, str(tmp_path / "ck" / "s.pkl"))
    state, m_a = step(frozen, state, images, targets, 1, torch.Generator().manual_seed(9))
    ck = load_pytree(str(tmp_path / "ck" / "s.pkl"))
    assert ck["epoch"] == 3 and isinstance(ck["state"]["lora"]["text"]["a_qkv"], torch.Tensor)
    resumed = state_from_numpy(ck["state"], init_state)
    assert resumed.step == 2
    resumed, m_b = step(frozen, resumed, images, targets, 1, torch.Generator().manual_seed(9))
    assert float(m_a["loss"]) == float(m_b["loss"])
    a, b = state_to_numpy(state), state_to_numpy(resumed)
    for part in ("lora", "mu", "nu"):
        for t in a[part]:
            for k in a[part][t]:
                np.testing.assert_array_equal(a[part][t][k], b[part][t][k])


def test_pytree_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": (torch.ones(2, dtype=torch.int32), [3, "x"]),
            "c": {"d": np.float32(1.5)}}
    save_pytree(tree, str(tmp_path / "t.pkl"))
    back = load_pytree(str(tmp_path / "t.pkl"))
    assert torch.equal(back["a"], tree["a"]) and isinstance(back["b"], tuple)
    assert torch.equal(back["b"][0], tree["b"][0]) and back["b"][1] == [3, "x"]
    assert back["c"]["d"] == np.float32(1.5)


def test_adamw_matches_optax():
    """Three AdamW updates (weight decay on every leaf, one of them with a
    zero gradient) against ``optax.adamw``: rtol 1e-6."""
    rng = np.random.default_rng(0)
    p0 = [rng.standard_normal((4, 5)).astype(np.float32), rng.standard_normal(7).astype(np.float32)]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) * 1e-2 for p in p0] for _ in range(3)]
    grads[1][1][:] = 0.0
    opt = j_adamw(lr=2e-4, weight_decay=1e-2)
    jp = [jnp.asarray(p) for p in p0]
    js = opt.init(jp)
    tp = [torch.from_numpy(p.copy()).requires_grad_(True) for p in p0]
    topt = adamw(lr=2e-4, weight_decay=1e-2)(tp)
    for g in grads:
        upd, js = opt.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        topt.step()
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)


def test_cosine_annealing_matches_jax():
    t, j = cosine_annealing_lr(2e-4, 20, 1e-6), j_cosine(2e-4, 20, 1e-6)
    for step in (0, 1, 7, 10, 20, 33, 40):
        assert t(step) == pytest.approx(float(j(step)), rel=1e-6)


def test_template_banks_and_spec_match_jax(tmp_path):
    classes = tmp_path / "classes.txt"
    classes.write_text("".join(f"Animal_Giant_panda_{i} {i}\n" for i in range(6)))
    ttemplates.synthesize_templates(str(classes), str(tmp_path / "tpl"))
    for idx in (1, 5, 8):
        assert (ttemplates.load_template_file(str(tmp_path / "tpl"), idx)
                == jtemplates.load_template_file(str(tmp_path / "tpl"), idx))
    tcfg = tconfig.PipelineConfig(data=tconfig.DataConfig(template_dir=str(tmp_path / "tpl")))
    got = ttrain_lora.tokenize_banks(tcfg)
    from jcf_tpu.config import DataConfig, PipelineConfig

    jcfg = PipelineConfig(data=DataConfig(template_dir=str(tmp_path / "tpl")))
    ref = np.asarray(jtrain_lora.tokenize_banks(jcfg))
    assert got.shape == (8, 6, 77) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (tlora.LoraSpec(**vars(ttrain_lora.lora_spec_from_config(tcfg)))
            == tlora.LoraSpec(**vars(jtrain_lora.lora_spec_from_config(jcfg))))


def test_step_without_dropout_is_deterministic():
    """generator=None: no dropout, so two steps from equal states agree."""
    init_state, step, frozen, lora, images, targets = _small_step()
    _, m_a = step(frozen, init_state(lora), images, targets, 0, None)
    state, m_b = step(frozen, init_state(lora), images, targets, 0, None)
    assert float(m_a["loss"]) == float(m_b["loss"]) and state.step == 1
