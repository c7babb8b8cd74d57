"""Stage-1 LoRA training step (``jcf_tpu/train/lora_stage1.py``).

Every step encodes all class prompts of one template bank through the
LoRA'd text tower (the gradients reach the text LoRA through it), the
image batch through the LoRA'd vision tower, and minimizes the CE over
``100 * img @ text^T``; AdamW updates the LoRA factors only. All template
banks are tokenized up front ([n_banks, C, 77]); the step picks one by
index. Both towers run the composable route, whose attention is K7
(``ops.attention.packed_attention``), forward and backward.

The JAX step recomputes each layer in the backward pass (``remat``) to fit
a 16 GB chip; on an 80 GB card the activations of both towers at bs 256
fit, so the port keeps them. The step updates the LoRA factors and the
optimizer's moments in place.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from jcf_tpu_torch.models.clip import CLIPConfig, encode_image, encode_text, tree_to
from jcf_tpu_torch.ops.f32_gemm import with_tf32_planes
from jcf_tpu_torch.ops.layers import l2_normalize
from jcf_tpu_torch.peft.lora import LoraSpec, make_lora_context


class Stage1State(NamedTuple):
    lora: dict  # the LoRA tree of f32 leaves the optimizer updates
    opt_state: torch.optim.Optimizer  # AdamW over the leaves, in tree order
    step: int


def _leaves(tree: dict) -> list:
    return [tree[t][k] for t in sorted(tree) for k in sorted(tree[t])]


def make_stage1_step(clip_params: dict, cfg: CLIPConfig, spec: LoraSpec, bank_token_ids,
                     optimizer, *, logit_scale: float = 100.0, dtype: torch.dtype = torch.float32,
                     device="cuda"):
    """Returns (init_state, step_fn, frozen).

    ``optimizer`` builds the optimizer from the leaf list (``train.adamw``).
    ``init_state(lora)`` copies a LoRA tree to ``device`` as the trained
    leaves. ``step_fn(frozen, state, images [B, 3, H, W], targets [B],
    bank_idx, generator) -> (state, {"loss", "acc"})``: ``generator`` (a
    ``torch.Generator`` on ``device``, or None for no dropout) draws the
    LoRA dropout masks. ``frozen`` is (the CLIP params on ``device``, the
    bank token ids on ``device``); no gradient reaches it.

    On the card the products follow the JAX numerics: f32 products in
    full f32 (``torch.backends.cuda.matmul.allow_tf32`` False, or the step
    raises) and bf16 products with one rounding (``ops.layers.linear``
    raises unless ``allow_bf16_reduced_precision_reduction`` is False).
    A tower that the spec gives no LoRA layer runs the fused route, whose
    f32 products read the weights' TF32 planes: in f32 ``frozen`` holds
    them for that tower, split once here.
    """
    device = torch.device(device)
    params = tree_to(clip_params, device)
    if dtype == torch.float32:
        for tower, indices in (("text", spec.text_indices(cfg.text_layers)),
                               ("visual", spec.vision_indices(cfg.vision_layers))):
            if not indices:
                params = {**params, tower: {**params[tower],
                                            "blocks": with_tf32_planes(params[tower]["blocks"])}}
    frozen = (params, torch.as_tensor(bank_token_ids).to(device).long())

    def check_precision():
        if device.type != "cuda":
            return
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("the stage-1 step needs torch.backends.cuda.matmul.allow_tf32 = "
                               "False")

    def loss_fn(lora, frozen, images, targets, bank_idx, generator):
        params, banks = frozen
        txt_ctx = make_lora_context(lora, spec, "text", cfg.text_layers, generator=generator)
        vis_ctx = make_lora_context(lora, spec, "vision", cfg.vision_layers, generator=generator)
        emb = encode_text(params, cfg, banks[bank_idx], device=device, dtype=dtype,
                          lora_ctx=txt_ctx)
        # per-template norm, mean over the single template, re-norm
        text_features = l2_normalize(l2_normalize(emb))
        img = encode_image(params, cfg, images.to(device), dtype=dtype, lora_ctx=vis_ctx)
        image_features = l2_normalize(img)
        # (scale * img) @ text^T: the scale rounds into the image features
        logits = (logit_scale * image_features) @ text_features.T
        loss = F.cross_entropy(logits.float(), targets)
        acc = (logits.argmax(dim=-1) == targets).float().mean()
        return loss, acc

    def init_state(lora: dict) -> Stage1State:
        leaves = {t: {k: v.detach().to(device, torch.float32).clone().requires_grad_(True)
                      for k, v in tower.items()} for t, tower in lora.items()}
        return Stage1State(leaves, optimizer(_leaves(leaves)), 0)

    def step_fn(frozen, state: Stage1State, images, targets, bank_idx, generator):
        check_precision()
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        loss, acc = loss_fn(state.lora, frozen, images,
                            torch.as_tensor(targets).to(device).long(), int(bank_idx), generator)
        loss.backward()
        for p in _leaves(state.lora):
            if p.grad is None:  # a leaf the masks keep out of the graph: decay still applies
                p.grad = torch.zeros_like(p)
        opt.step()
        return state._replace(step=state.step + 1), {"loss": loss.detach(), "acc": acc}

    return init_state, step_fn, frozen


def state_to_numpy(state: Stage1State) -> dict:
    """The state as plain numpy: {"lora", "mu", "nu"} trees and "step"
    (the AdamW moments are zeros before the first step)."""
    opt = state.opt_state

    def tree(fn):
        return {t: {k: fn(p).detach().cpu().numpy().copy() for k, p in tower.items()}
                for t, tower in state.lora.items()}

    return {"lora": tree(lambda p: p),
            "mu": tree(lambda p: opt.state[p]["exp_avg"] if p in opt.state else torch.zeros_like(p)),
            "nu": tree(lambda p: opt.state[p]["exp_avg_sq"] if p in opt.state
                       else torch.zeros_like(p)),
            "step": int(state.step)}


def state_from_numpy(tree: dict, init_state) -> Stage1State:
    """A state ``state_to_numpy`` wrote, rebuilt through ``init_state``
    (copies: the optimizer updates its moments in place)."""
    def tensor(a, device="cpu"):
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)

    state = init_state({t: {k: tensor(v) for k, v in tower.items()}
                        for t, tower in tree["lora"].items()})
    if tree["step"]:
        for t, tower in state.lora.items():
            for k, p in tower.items():
                state.opt_state.state[p] = {"step": torch.tensor(float(tree["step"])),
                                            "exp_avg": tensor(tree["mu"][t][k], p.device),
                                            "exp_avg_sq": tensor(tree["nu"][t][k], p.device)}
    return state._replace(step=int(tree["step"]))
