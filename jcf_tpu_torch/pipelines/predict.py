"""The final prediction pipeline, ``jcf-predict`` (``jcf_tpu/pipelines/predict.py``,
the reference's ``test.py``).

1. The zs tower: the base CLIP with the stage-1 LoRA merged (the single
   checkpoint ``stage1.save_path``, or the average of the pickles in
   ``stage1.swa_dir``).
2. The prompted tower: stage 2's ``clip_model.pkl`` (with its visual
   prompt tokens) with the stage-2 LoRA merged; the prompt learner's ctx
   and the heads from their pickles; the MoCo ResNet-50.
3. The base split (``TestSetB_1.txt``): three text classifiers
   (handcrafted on the prompted tower, zero-shot on the zs tower, and
   ``l2n((handcrafted + l2n(prompt learner)) / 2)``); per batch the crop
   cloud (the center view and ``tta.n_views`` random crops of area share
   0.2-1) encoded once on the prompted tower and solved twice, once more
   on the zs tower, the channel LP on the modes, the MoCo head on the
   center view; the emitted prediction is the top 5 of ``cs1``.
4. The new split (``TestSetB_2.txt``): the pristine zero-shot CLIP's MTA
   top 5.
5. The two files merged and the paths cleaned into ``result.txt``.

The three crop engines are built as the JAX pipeline builds them:
``TTAEngine(..., quant=runtime.quant)`` in the compute dtype without
calibration, so with ``runtime.quant = "int8"`` the towers run the folded
tree with dynamic per-row scales (the int8 engine computes in bf16: with
the f32 compute dtype it raises). Under ``_FUSE`` = "block", "layer" or
"stream" (``ops.block_kernel``) their layers run K9a, K9d or K9c; under
"halves" (the default) K3 + K4 (int8) or K6a + K6b (the f32 default).

Everything runs on ``device`` (the CUDA card unless the caller asks for
the CPU; on the card f32 products need TF32 off, ``ops.layers.
require_f32_products``). The loaders decode JPEGs to PIL's pixels byte for
byte on every device (``data.decode``), and on the CPU the files equal the
JAX package's byte for byte.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import torch

from jcf_tpu_torch.config import PipelineConfig
from jcf_tpu_torch.data import (
    CLIP_MEAN,
    CLIP_STD,
    MOCO_MEAN,
    MOCO_STD,
    label_to_classname,
    read_classnames,
    read_path_list,
)
from jcf_tpu_torch.heads import channel_lp, moco_adapter
from jcf_tpu_torch.infer.engine import TTAEngine
from jcf_tpu_torch.infer.predict import (
    combine_lp_logits,
    ensemble_base_logits,
    process_result_lines,
    update_txt_file,
    write_top5,
)
from jcf_tpu_torch.models.clip import tree_to
from jcf_tpu_torch.models.loader import (
    config_from_state_dict,
    load_state_dict_file,
    params_from_state_dict,
)
from jcf_tpu_torch.models.resnet import moco_params_from_state_dict, resnet50_features
from jcf_tpu_torch.ops.layers import l2_normalize
from jcf_tpu_torch.ops.stats import logit_normalize
from jcf_tpu_torch.peft import (
    init_prompt_learner,
    load_lora,
    load_lora_swa,
    merge_lora_params,
    prompt_text_features,
)
from jcf_tpu_torch.pipelines.common import (
    build_text_weights,
    compute_dtype,
    ensure_templates,
    load_model_for_pipeline,
    serving_mesh,
    tta_loader,
)
from jcf_tpu_torch.pipelines.train_lora import lora_spec_from_config
from jcf_tpu_torch.utils import Timer, get_logger, load_pytree

logger = get_logger()

# the stage-2 loaders' crop area share (test.py's RandomResizedCrop)
PREDICT_CROP_SCALE = (0.2, 1.0)


def _stats(values, device, shape) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device).reshape(shape)


def _batches(loader, timer: Timer, phase: str):
    """The loader's batches, the wait for each counted in ``phase``."""
    it = iter(loader)
    while True:
        with timer.phase(phase):
            batch = next(it, None)
        if batch is None:
            return
        yield batch


def run_predict(cfg: PipelineConfig, results_dir: str = "final_results", *, device="cuda",
                timer: Optional[Timer] = None) -> dict:
    """The two splits' top-5 files and ``result.txt`` under ``results_dir``
    -> {"n_base", "n_new", "result"}. ``timer`` (a ``Timer``, made here when
    None) collects the phases "load" (checkpoints, towers, heads),
    "classifiers" (the four text classifiers), "engines", "decode_wait"
    (the loops waiting for decoded crops), "base_batch" and "new_batch" (a
    batch on the device, up to its top 5 on the host) and "write"."""
    device = torch.device(device)
    timer = Timer() if timer is None else timer
    if cfg.runtime.attention_impl is not None:
        raise ValueError(f"runtime.attention_impl = {cfg.runtime.attention_impl!r}: the port has "
                         "one attention route on the card; leave it None")
    spec = lora_spec_from_config(cfg)
    dtype = compute_dtype(cfg)
    out_dir = cfg.stage2.out_dir

    with timer.phase("load"):
        # the zs tower: base CLIP + the stage-1 LoRA (or its SWA average)
        params_zs, mcfg_zs = load_model_for_pipeline(cfg)
        kw = dict(n_text=mcfg_zs.text_layers, text_width=mcfg_zs.text_width,
                  n_vision=mcfg_zs.vision_layers, vision_width=mcfg_zs.vision_width)
        lora1 = (load_lora_swa(cfg.stage1.swa_dir, spec, **kw) if cfg.stage1.swa_dir
                 else load_lora(cfg.stage1.save_path, spec, **kw))
        params_zs_merged = merge_lora_params(params_zs, lora1, spec)
        # the prompted tower: stage 2's checkpoint (with VPT) + its LoRA
        sd = load_state_dict_file(os.path.join(out_dir, "clip_model.pkl"))
        mcfg = config_from_state_dict(sd)
        params = params_from_state_dict(sd, mcfg)
        lora2 = load_lora(os.path.join(out_dir, "lora_weights.pkl"), spec,
                          n_text=mcfg.text_layers, text_width=mcfg.text_width,
                          n_vision=mcfg.vision_layers, vision_width=mcfg.vision_width)
        params_merged = merge_lora_params(params, lora2, spec)
        # the pristine zero-shot CLIP of the new split
        params_ori, mcfg_ori = load_model_for_pipeline(cfg)
        channel_params = tree_to(load_pytree(os.path.join(out_dir, "channel.pkl")), device)
        adapter_params = tree_to(load_pytree(os.path.join(out_dir, "moco_adapter.pkl")), device)
        prompt_state = load_pytree(os.path.join(out_dir, "PromptLearner.pkl"))
        moco_params = tree_to(
            moco_params_from_state_dict(load_state_dict_file(cfg.stage2.moco_checkpoint)), device)
        templates = ensure_templates(cfg)
        l2c = label_to_classname(read_classnames(cfg.data.classes_file))
        classnames = [l2c[i] for i in sorted(l2c)]

    # every f32 tree from here on is split into its TF32 planes where it is
    # made (the classifier builds, the prompt learner, the engines), so the
    # planes are the split of the LoRA-merged weights
    with timer.phase("classifiers"):
        text_hand = build_text_weights(params_merged, mcfg, templates, cfg, device=device)
        text_zs = build_text_weights(params_zs_merged, mcfg_zs, templates, cfg, device=device)
        learner = init_prompt_learner(params, mcfg, classnames, cfg.stage2.ctx_init,
                                      cfg.stage2.n_ctx)
        ctx = torch.as_tensor(prompt_state["ctx"]).to(device)
        pt_feats = l2_normalize(prompt_text_features(
            {"text": tree_to(params_merged["text"], device)}, mcfg, learner, ctx, dtype=dtype))
        text_pt = l2_normalize((text_hand + pt_feats) / 2)
        text_zs_ori = build_text_weights(params_ori, mcfg_ori, templates, cfg, device=device)

    serving_mesh(cfg)
    with timer.phase("engines"):
        engines = [TTAEngine(p, m, device=device, n_views=cfg.tta.n_views, quant=cfg.runtime.quant,
                             dtype=dtype)
                   for p, m in ((params_merged, mcfg), (params_zs_merged, mcfg_zs),
                                (params_ori, mcfg_ori))]
    engine_pt, engine_zs, engine_ori = engines

    clip_mean, clip_std = (_stats(v, device, (1, 1, 3, 1, 1)) for v in (CLIP_MEAN, CLIP_STD))
    moco_mean, moco_std = (_stats(v, device, (1, 3, 1, 1)) for v in (MOCO_MEAN, MOCO_STD))
    # the ensembles take the classifiers in f32 (JAX promotes a bf16 one)
    t_hand, t_pt, t_zs = (t.float() for t in (text_hand, text_pt, text_zs))

    def clip_input(center, crops):
        stacked = torch.cat([center, crops], dim=1)  # the center view first
        return stacked, (stacked - clip_mean) / clip_std

    # ---------------- base split ----------------
    base_rows: List[Tuple[str, List[int]]] = []
    data1 = read_path_list(os.path.join(cfg.data.root, "TestSetB_1.txt"))
    loader1 = tta_loader(cfg, data1, mcfg, normalize=False, crop_scale=PREDICT_CROP_SCALE,
                         device=device)
    for center, crops, _, impaths, _ in _batches(loader1, timer, "decode_wait"):
        with timer.phase("base_batch"):
            stacked, clip_in = clip_input(center, crops)
            # the crop cloud encoded once on the prompted tower, solved twice
            feats_pt = engine_pt.crop_features(clip_in)
            mode_pt = engine_pt.mta_from_features(feats_pt, text_pt)
            mode_hand = engine_pt.mta_from_features(feats_pt, text_hand)
            mode_zs = engine_zs.features_from_crops(clip_in, text_zs)
            combine = (mode_pt + mode_hand) / 2
            lp_logits = combine_lp_logits(channel_lp(channel_params, combine),
                                          channel_lp(channel_params, mode_zs))
            moco_in = (stacked[:, 0] - moco_mean) / moco_std
            moco_feats = resnet50_features(moco_params, moco_in, dtype=dtype).float()
            moco_logits = logit_normalize(moco_adapter(adapter_params, moco_feats))
            out = ensemble_base_logits(mode_hand, mode_pt, mode_zs, t_hand, t_pt, t_zs,
                                       lp_logits, moco_logits)
            top5 = torch.topk(out["cs1"], 5, dim=-1).indices.cpu().tolist()
        base_rows.extend(zip(impaths, top5))

    # ---------------- new split ----------------
    new_rows: List[Tuple[str, List[int]]] = []
    data2 = read_path_list(os.path.join(cfg.data.root, "TestSetB_2.txt"))
    loader2 = tta_loader(cfg, data2, mcfg_ori, normalize=False, crop_scale=PREDICT_CROP_SCALE,
                         device=device)
    for center, crops, _, impaths, _ in _batches(loader2, timer, "decode_wait"):
        with timer.phase("new_batch"):
            _, clip_in = clip_input(center, crops)
            mode = engine_ori.features_from_crops(clip_in, text_zs_ori)
            logits = engine_ori.logits(mode, text_zs_ori)
            top5 = torch.topk(logits, 5, dim=-1).indices.cpu().tolist()
        new_rows.extend(zip(impaths, top5))

    # ---------------- merge + cleanup ----------------
    with timer.phase("write"):
        os.makedirs(results_dir, exist_ok=True)
        base_txt = os.path.join(results_dir, "top5_results6.txt")
        ood_txt = os.path.join(results_dir, "top5_results_ood.txt")
        write_top5(base_txt, base_rows)
        write_top5(ood_txt, new_rows)
        update_txt_file(base_txt, ood_txt)
        result_txt = os.path.join(results_dir, "result.txt")
        process_result_lines(base_txt, result_txt)
    logger.info("predict done: %d base + %d new -> %s: %s", len(base_rows), len(new_rows),
                result_txt, timer.summary())
    return {"n_base": len(base_rows), "n_new": len(new_rows), "result": result_txt}
