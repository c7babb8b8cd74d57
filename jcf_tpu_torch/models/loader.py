"""Checkpoint ingestion (``jcf_tpu/models/loader.py``): OpenAI / Jittor
CLIP state dicts -> the port's param trees.

Every architectural dimension comes from tensor shapes in the flat state
dict, as the reference's ``build_model`` does, so any ViT CLIP checkpoint
loads without explicit configuration: ViT-B/32, ViT-B/16 (patch 16, 197
tokens), ViT-L/14. ResNet state dicts (no ``visual.proj``) are refused.

Accepted files: pickle (the reference's ``jt.save`` / ``pth_to_pkl.py``
output), torch ``.pt`` / ``.pth`` archives and TorchScript archives (the
original OpenAI distribution). Arrays go through numpy; the params come
back as CPU f32 tensors in the ``models.clip`` layout.
"""

from __future__ import annotations

import pickle
from typing import Dict

import numpy as np
import torch

from jcf_tpu_torch.models.clip import CLIPConfig

_META_KEYS = ("input_resolution", "context_length", "vocab_size")


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return v.float().numpy() if v.dtype.is_floating_point else v.numpy()
    return np.asarray(v)


def load_state_dict_file(path: str) -> Dict[str, np.ndarray]:
    """A flat name -> array state dict from a pickle, a torch archive or a
    TorchScript archive."""
    state = None
    try:
        with open(path, "rb") as f:
            state = pickle.load(f)
    except Exception:
        pass
    if state is None:
        try:
            state = torch.load(path, map_location="cpu", weights_only=False)
        except Exception:
            state = torch.jit.load(path, map_location="cpu").state_dict()
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    if "state_dict" in state and isinstance(state["state_dict"], dict):
        state = state["state_dict"]
    return {k: _to_numpy(v) for k, v in state.items() if k not in _META_KEYS}


def is_vit_state_dict(sd: Dict[str, np.ndarray]) -> bool:
    return "visual.proj" in sd


def _layer_count(sd: Dict[str, np.ndarray], prefix: str) -> int:
    return len({k.split(".")[2] for k in sd if k.startswith(prefix)})


def config_from_state_dict(sd: Dict[str, np.ndarray], **prompt_kwargs) -> CLIPConfig:
    """The ``CLIPConfig`` a ViT state dict implies (patch size from the
    conv weight, resolution from the positional table)."""
    if not is_vit_state_dict(sd):
        raise ValueError("state dict has no visual.proj: ModifiedResNet checkpoints are not "
                         "ViT CLIP checkpoints")
    conv1 = sd["visual.conv1.weight"]
    vision_patch_size = conv1.shape[-1]
    grid_size = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
    vpt = sd.get("visual.VPT")
    return CLIPConfig(
        embed_dim=sd["text_projection"].shape[1],
        image_resolution=vision_patch_size * grid_size,
        vision_layers=len([k for k in sd if k.startswith("visual.")
                           and k.endswith(".attn.in_proj_weight")]),
        vision_width=conv1.shape[0],
        vision_patch_size=vision_patch_size,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        text_width=sd["ln_final.weight"].shape[0],
        text_heads=sd["ln_final.weight"].shape[0] // 64,
        text_layers=_layer_count(sd, "transformer.resblocks"),
        vision_prompt_tokens=(vpt.shape[0] if vpt is not None else 0),
        **prompt_kwargs,
    )


def _tensor(a) -> torch.Tensor:
    """An f32 CPU tensor holding a copy of ``a``."""
    return torch.from_numpy(np.ascontiguousarray(np.array(a, np.float32)))


# (tree path, state dict suffix) of one residual block
_BLOCK_KEYS = (
    (("ln_1", "scale"), "ln_1.weight"), (("ln_1", "bias"), "ln_1.bias"),
    (("attn", "w_qkv"), "attn.in_proj_weight"), (("attn", "b_qkv"), "attn.in_proj_bias"),
    (("attn", "w_out"), "attn.out_proj.weight"), (("attn", "b_out"), "attn.out_proj.bias"),
    (("ln_2", "scale"), "ln_2.weight"), (("ln_2", "bias"), "ln_2.bias"),
    (("mlp", "c_fc", "w"), "mlp.c_fc.weight"), (("mlp", "c_fc", "b"), "mlp.c_fc.bias"),
    (("mlp", "c_proj", "w"), "mlp.c_proj.weight"), (("mlp", "c_proj", "b"), "mlp.c_proj.bias"),
)


def _stack_blocks(sd: Dict[str, np.ndarray], prefix: str, layers: int) -> dict:
    blocks: dict = {}
    for path, suffix in _BLOCK_KEYS:
        node = blocks
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _tensor(np.stack([sd[f"{prefix}.{i}.{suffix}"] for i in range(layers)]))
    return blocks


def params_from_state_dict(sd: Dict[str, np.ndarray], cfg: CLIPConfig) -> dict:
    """The param tree of a ViT state dict (f32 CPU tensors)."""
    conv1 = np.asarray(sd["visual.conv1.weight"], np.float32)  # [W, 3, p, p]
    visual = {
        "patch_embed": {"w": _tensor(conv1.reshape(conv1.shape[0], -1))},
        "class_embedding": _tensor(sd["visual.class_embedding"]),
        "positional_embedding": _tensor(sd["visual.positional_embedding"]),
        "ln_pre": {"scale": _tensor(sd["visual.ln_pre.weight"]),
                   "bias": _tensor(sd["visual.ln_pre.bias"])},
        "blocks": _stack_blocks(sd, "visual.transformer.resblocks", cfg.vision_layers),
        "ln_post": {"scale": _tensor(sd["visual.ln_post.weight"]),
                    "bias": _tensor(sd["visual.ln_post.bias"])},
        "proj": _tensor(sd["visual.proj"]),
    }
    if "visual.VPT" in sd:
        visual["vpt"] = _tensor(sd["visual.VPT"])
    text = {
        "token_embedding": _tensor(sd["token_embedding.weight"]),
        "positional_embedding": _tensor(sd["positional_embedding"]),
        "blocks": _stack_blocks(sd, "transformer.resblocks", cfg.text_layers),
        "ln_final": {"scale": _tensor(sd["ln_final.weight"]), "bias": _tensor(sd["ln_final.bias"])},
        "text_projection": _tensor(sd["text_projection"]),
    }
    return {"visual": visual, "text": text, "logit_scale": _tensor(sd["logit_scale"]).reshape(())}


def state_dict_from_params(params: dict, cfg: CLIPConfig) -> Dict[str, np.ndarray]:
    """The inverse of ``params_from_state_dict`` (flat OpenAI names, numpy
    arrays), for checkpoints that load in the reference and in either
    package."""
    v, t = params["visual"], params["text"]
    p = cfg.vision_patch_size
    sd = {
        "visual.conv1.weight": _to_numpy(v["patch_embed"]["w"]).reshape(cfg.vision_width, 3, p, p),
        "visual.class_embedding": _to_numpy(v["class_embedding"]),
        "visual.positional_embedding": _to_numpy(v["positional_embedding"]),
        "visual.ln_pre.weight": _to_numpy(v["ln_pre"]["scale"]),
        "visual.ln_pre.bias": _to_numpy(v["ln_pre"]["bias"]),
        "visual.ln_post.weight": _to_numpy(v["ln_post"]["scale"]),
        "visual.ln_post.bias": _to_numpy(v["ln_post"]["bias"]),
        "visual.proj": _to_numpy(v["proj"]),
    }
    if "vpt" in v:
        sd["visual.VPT"] = _to_numpy(v["vpt"])
    for blocks, prefix in ((v["blocks"], "visual.transformer.resblocks"),
                           (t["blocks"], "transformer.resblocks")):
        for path, suffix in _BLOCK_KEYS:
            node = blocks
            for key in path:
                node = node[key]
            stacked = _to_numpy(node)
            for i in range(stacked.shape[0]):
                sd[f"{prefix}.{i}.{suffix}"] = stacked[i]
    sd["token_embedding.weight"] = _to_numpy(t["token_embedding"])
    sd["positional_embedding"] = _to_numpy(t["positional_embedding"])
    sd["ln_final.weight"] = _to_numpy(t["ln_final"]["scale"])
    sd["ln_final.bias"] = _to_numpy(t["ln_final"]["bias"])
    sd["text_projection"] = _to_numpy(t["text_projection"])
    sd["logit_scale"] = _to_numpy(params["logit_scale"])
    return sd


def load_clip(path: str, **prompt_kwargs):
    """(params, config) from a checkpoint file: a ViT-B/16 checkpoint gives
    ``CLIPConfig(vision_patch_size=16)`` and its weights."""
    sd = load_state_dict_file(path)
    cfg = config_from_state_dict(sd, **prompt_kwargs)
    return params_from_state_dict(sd, cfg), cfg
