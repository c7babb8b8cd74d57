#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``jcf_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

1. prints the card (``nvidia-smi`` name and power limit), the torch, CUDA
   and nvcc versions, and what the host offers for JPEG decode (libjpeg,
   which the port does not use, and the g++ that builds its entropy
   decoder);
2. builds every CUDA kernel from ``jcf_tpu_torch/csrc``;
3. holds each serving kernel (K1-K5) against its plain PyTorch version on
   the card and times both, at B' = 1024 crops and at the serving path's
   own shapes (b1024 x 8 views = 8192 crops, the numbers reported), and
   each epilogue of the int8 GEMM once at a ragged shape
   (``RAGGED_GEMMS``);
4. holds each text-tower kernel (K6a, K6b) against its plain version on
   one batch of 512 prompts x 77 tokens at ViT-B/32 text widths, and the
   composed halves and the 12-layer tower;
5. builds the zero-shot classifier the way ``jcf-ood`` does
   (``synthesize_templates`` from a 403-line ``classes.txt``, then
   ``build_text_weights``: 403 x 8 prompts), counting the kernels it
   launches (every ``causal_attention`` on the tensor-core route,
   ``causal_attention/mma``), checks it against the plain-version tower, and checks that a
   second call hits the classifier cache;
5b. trains: holds the K7 forward and backward kernels against the plain
   forward and autograd through it at the stage-1 step's attention shapes
   (text 403 x 77, 8 heads, causal; vision 256 x 50, 12 heads), in f32
   and bf16; builds the stage-1 LoRA step at ViT-B/32 width (8 template
   banks of the 403 classes, LoRA r 4 on q/k/v of every layer of both
   towers, AdamW 2e-4 / wd 1e-2, bs 256 images of 224²), counts the K7
   launches of one bf16 step (every backward on the tensor-core route,
   ``packed_attention_bwd/mma``), holds a step through the kernels against a
   step through the plain K7 from the same state and dropout seed (bf16
   and f32), trains 10 steps on a fixed batch (the loss must fall), times
   the bf16 step (ms, img/s, peak memory), profiles one step by kernel
   group and saves and reloads the LoRA;
6. drives ``TTAEngine.features_from_images`` at ViT-B/32 full width with
   seed-0 weights, images and classifier (as ``bench.py`` makes them),
   b1024 x 8 views, counting the kernels it launches;
7. certifies the int8 path against the f32 engine (``quant=None``, the
   reference preset's engine on its own route: K1 in f32 and the
   unquantized tower, counted: 1 ``view_f32`` and 7 launches a layer, no
   K7) on the same crop geometry (top-1 agreement >= 0.99, top-5 overlap
   >= 0.97, the gates of ``bench.py``; printed beside the numbers
   measured against the earlier f32 path, the composable tower with
   plain K7 attention), then serves once with the built
   classifier;
8. times the slice in images/s;
6b. (run last, so the ViT-B/32 numbers above are taken as before) serves
   ViT-B/16 (``CLIPConfig(vision_patch_size=16)``: 197 tokens, full width
   and depth, seed-0 weights) at b256 x 8 views with the int8 engine, the
   route from 128 tokens on: counts one forward (12 K8, 48 row-scale int8
   GEMMs, one s32 patch GEMM, one K1, no other kernel), holds K8 against
   ``attention_plain`` in bf16 and f32 and the row-scale GEMM against its
   plain version at the qkv and c_fc shapes (on the inputs of layer 0 of
   that forward), certifies the int8 modes against the f32 engine with
   plain attention (top-5 overlap >= 0.97 and per-image mode cosine >=
   0.999 gated; the top-1 agreement printed with what bounds it on random
   weights: the logit margins, the same tower in bf16 without int8, and 8
   more random classifiers), runs the f32 engine once more on its kernels
   (K8 in f32: one K1 and 12 K8 a forward, counted; against the
   plain-attention route at phase 11's gates: per-view feature cos and
   mean mode cos >= 0.99999, top-1 and top-5 >= 0.99; img/s), logs K8 in
   f32 at 577 tokens against its plain version,
   times img/s and profiles one forward by kernel group;
9. (after 6b) the whole-layer routes on the ViT-B/32 engine of phase 6,
   its images, geometry and classifier: for ``_FUSE`` = "block" (K9a),
   "layer" (K9d) and "stream" (K9c) it counts one forward (11 K9a or 11
   K9d and the CLS-only last layer, or one K9c; no K3 attention), holds
   the kernel against its plain version on that forward's tower input
   (the whole tower for K9c), the CLS rows against the halves route's,
   certifies the modes against phase 7's f32 modes (top-1 >= 0.98, top-5
   >= 0.95, ``bench.py``'s gates for knob configurations), times the
   kernel, the plain version and the halves route per layer, and img/s;
   then builds the classifier under "block" (84 K9b launches, nothing
   else), holds it against the halves-built one and K9b against its
   plain version at 512 x 77. ``_FUSE`` is set back to "halves" after.
10. (last) the int8 engine's quantization modes below 128 tokens, on the
   ViT-B/32 images, geometry and classifier of phase 6: dynamic (no
   calibration), "ln", "hidden" and "full+score". For each it counts one
   forward against the launches ``mode_launches`` writes out, holds each
   kernel the mode adds against its plain version at 8192 crops (the
   dynamic row quantizations, the row-scale and f32 GEMM epilogues, the
   f32-context attention of K3 and K5, the calibrated shift) and the
   halves against ``plain_halves``, certifies the modes against phase
   7's f32 modes (dynamic, ``bench.py``'s default, at >= 0.99 / 0.97; the
   static-mode knobs at >= 0.98 / 0.95) and times img/s. 10b:
   ``features_from_crops`` at 8 images x 513 crops of 224² (dynamic int8:
   12 K3 + 12 K4, no K5), held to ``mta_from_features(crop_features)``
   bit for bit and certified against the f32 engine (per crop >= 0.99 /
   0.97, per-image mode cos >= 0.999), crops/s. 10c: ViT-B/32 at 288² (82
   tokens, static "full", b256 x 8 views of 329² sources): no K5 launch,
   K3's attention at S = 82 and the last layer's K3 + K4 route against
   their plain versions, the cert (top-1 >= 0.99 and top-5 >= 0.97;
   where more than 1% of the images' f32 top-1 gaps lie under the int8
   swing, top-5, the mean mode cosine and the per-view features
   instead), img/s; then the same engine under ``_FUSE`` = "block",
   "layer", "stream" (11 K9a or 11 K9d on the "long" branch, then the last
   layer's K3 + K4; or one K9c), each counted, on the fixed gates, the
   kernel against its plain version at 2048 x 82, img/s. Phases 8, 10 (each
   mode) and 10c fail if a row kernel left its vector route on ViT-B/32
   (``check_no_scalar``: the row quantization ``quant_rows`` /
   ``gelu_quant_rows``, K2 ``assemble`` and the LN row kernels launch 0
   times on "/scalar").
11. (after 10) the unquantized towers: the f32 engine of phase 7 against
   its route through the plain versions (per-view features cos >=
   0.99999, modes top-1 and top-5 >= 0.99) and img/s; its
   ``features_from_crops`` at 8 x 513 crops (84 launches, no K1), against
   the plain route (per-crop cos >= 0.99999), crops/s; the bf16 parity
   engine (``quant=None, dtype=bf16``, ``bench.py``'s ``JCF_BENCH_QUANT=none``)
   at b1024 x 8 views, counted, certified against the f32 engine (top-1
   >= 0.99, top-5 >= 0.97), img/s; under ``_FUSE`` = "block" the bf16
   engine (1 K1 + 12 K9b with an all-zero bias; cert >= 0.98 / 0.95), K9b
   at E = 768 against its plain version on the bf16 engine's layer-0
   rows, and the f32 engine on 8 images (1 K1 + 12 ``block_f32``, modes
   against the f32 halves' at cos >= 0.9999); the f32 classifier build under
   ``PipelineConfig()`` (counted: the f32 text halves and the text
   weights' TF32 planes, split once before the batches, 48 ``tf32_split``;
   against the plain f32 tower, row cos >= 0.99999); 11b' the planes of
   the text tower (``with_tf32_planes``) counted, timed, equal to the plain
   split bit for bit, with the bytes the text and vision planes hold; the
   phase's peak device memory; then each new kernel against its
   plain version: K1's f32 and bf16 views at the serving batch, on layer
   0's input rows of the f32 and bf16 engines' forwards ``ln_affine_f32``
   and ``ln_affine`` (vision),
   the f32 GEMM epilogues (bias, QuickGELU, residual), the mask-free
   attention in f32 and bf16 (SDPA on the head views as the library
   yardstick, ``matmul`` without TF32 for the GEMMs, ``F.layer_norm``),
   the bf16 c_fc and c_proj epilogues at the vision width and the
   composed halves in both dtypes, and at 512 prompts x 77 tokens the f32 text pieces,
   ``causal_attention_f32`` (SDPA ``is_causal``) and the 12-layer f32
   text tower.
12. (after 11) the masked and unfolded int8 halves: 12a each new kernel
   against its plain version at the paths' shapes (on layer 0's input
   rows of the int8 text tower, 512 prompts x 77 tokens in f32: the LN +
   affine + row quant, the causal masked attention with the f32 and the
   int8 (static) context, SDPA ``is_causal`` as yardstick, each on the
   tensor-core route, the f32 residual epilogues; on the
   unfolded vision tower's input rows at 8192 crops: the bf16 LN + affine
   + row quant, K3's and K5's attention with the score scale; the
   composed halves); 12b the int8 classifier build
   (``quant=quantize_clip_params(params)["text"]``) at 403 x 8 prompts in
   f32 and bf16, counted against ``int8_text_launches``, against the same
   build on the plain versions (rows cos >= 0.9999 in f32, 0.999 in bf16)
   and the f32
   classifier of 11b (rows cos > 0.99, the JAX certificate), the ranking
   of phase 7's f32 modes under both printed, seconds; the same build
   under ``_FUSE`` = "block" (exactly 12 K9a a text forward on the masked
   branch, no K3 / K4; the same gates; K9a against its plain version at
   512 x 77); 12c the unfolded
   int8 ViT-B/32 tower at 8192 crops, all rows and the CLS rows, counted,
   against its plain route (row cos >= 0.999) and the bf16 float tower
   (mean row cos > 0.995), ms per tower, then under each K9 route
   (counted on the "unfolded" branch, each kernel against its plain
   version, the tower against the bf16 float tower, ms per layer beside
   the unfolded halves'); 12d a 3-head and a 64-token
   tower at small width, int8 and bf16, counted, against their plain
   routes, and the float halves' per-head attention (``head_attention``)
   against its plain version on the 3-head tower's layer-0 qkv; then both
   int8 towers under "block" (12 K9a on the masked or the non-dense
   branch, against the plain route and the halves) and the int8 engines
   of the same widths (the 64-token one with 14 visual prompts; dynamic
   and static "full") on their non-assembled route under "block",
   counted, per-view features against the plain route and the halves
   (the 3-head "full" engine's halves counted too: the int8-context
   masked attention on the tensor-core route), img/s. The phases that
   run the masked attention, K3's attention or K7 (3, 5, 5b, 8, 9, 10,
   10b, 10c, 12a-d, 13d) print each kernel's route counters
   ("<kernel>/mma", "<kernel>/rowloop") beside its launches and fail
   unless bf16 at head dim 64 took the tensor cores.
13. ``jcf-ood`` end to end. 13a: every committed JPEG
   (``tests/fixtures/jpeg``: the six fixtures and the four small ones
   under ``extra/``: progressive, restart markers, 4:2:2, odd size)
   decoded on the card at every scale PIL's draft reaches, each decode's
   SHA-256 against PIL's (``libjpeg_sha256.json``), the IDCT (one launch
   an image) and upsample + color kernels against their plain versions
   bit for bit there; one IDCT launch over every committed JPEG at
   scales 1, 2, 4 and 8 and one over random coefficients past 16 bits
   (mixed sizes in each), against ``idct_plain`` per component;
   ``decode_batch`` (libjpeg's reduced scale, the resize kernel) within
   one level of the committed ``jcf_tpu.native`` output; decode img/s;
   ``decode_file`` and ``decode_batch`` counted (one IDCT a decode
   call); the IDCT timed at a --perf decode_batch (128 images, one
   launch), the upsample + color and resize at the largest fixture. 13a': the card's and the CPU's full-size
   decodes, 64 seeded PIL-exact crops each: the 384 crops equal. Then a
   TestSetB of the
   fixtures repeated (16 images; 1024 for 13d), a 403-line synthetic
   ``classes.txt`` (rotated so that seed-0 weights send images to both
   sides of the base/new boundary) and the seed-0 ViT-B/32 checkpoint
   written through ``models.loader.state_dict_from_params``, each run from
   a temporary directory with its own classifier cache. 13b:
   ``cli.ood.main`` in the default configuration (f32, 512 + 1 host
   crops), counted (the f32 text and vision halves, the text and vision
   weights' TF32 planes once each, an IDCT and an upsample + color an
   image), then on the plain versions
   (nothing launches): the split
   files byte-identical; img/s and the ``Timer`` shares of decode and
   device. 13c: the same under ``_FUSE`` = "block": 84 + 12 per batch
   ``block_f32`` launches and no K6a / K6b, the files equal to 13b's,
   ``block_f32`` against ``block_f32_plain`` at 512 x 77 causal and 4104
   x 50 zero bias (1e-5 + 1e-5 |ref|, row cos >= 0.99999), timed beside
   the f32 halves per layer. 13d: ``--perf`` on 1024 images (batches of
   128): each batch launches exactly phase 8's route, the decoder one
   IDCT a batch, one upsample + color and one resize an image; against the same
   run on the
   plain versions (scored against the same cached classifier) per-image
   top-1 agreement >= 0.99 and per-view feature cos >= 0.999 (top-5 and
   the mode cosines printed); img/s end to end and in the serving loop,
   and the share of the loop the device waits for decoded images. 13a
   also decodes 132 images in a second thread while this one keeps the
   card busy: each must equal its decode alone.

14. ``jcf-predict`` end to end, on a workspace of the names its
   defaults read: phase 13's 16 fixture images split 8 / 8 into
   ``TestSetB_1.txt`` and ``TestSetB_2.txt``, the seed-0 ViT-B/32
   checkpoint, a stage-1 LoRA (r 4 on q, k, v of both towers, seed 1, B
   drawn non-zero), stage 2's ``test_pkl`` (the checkpoint with 4 visual
   prompt tokens, so the prompted tower has 54 rows a crop; its own LoRA
   from seed 2; the channel LP and MoCo adapter heads; the prompt
   learner's ctx) and a seed-0 ResNet-50 with trained-tower BatchNorm
   statistics as a ``base_encoder.`` MoCo state dict. 14a:
   ``cli.predict.main`` in the default configuration (f32, 512 + 1 host
   crops), counted (the f32 text halves of 3 classifiers and the prompt
   learner, the f32 vision halves of 3 crop clouds, the TF32 planes of
   the 4 text and 3 vision trees, the decoder's kernels for each image;
   no K3-K5, no K9) with its peak device memory, then on the plain versions: the
   three result files byte-identical, ``cs1`` within 1e-3; img/s end to end and per
   loop. 14b: ``run_predict`` with ``runtime.quant = "int8"`` in bf16 (the
   engines built without calibration: dynamic per-row scales) under
   ``_FUSE`` = "halves", "block", "layer", "stream", each counted (the
   crop clouds run every layer on every row, as the JAX engine's
   ``_encode_cloud``: 12 K3 + K4, 12 K9a, 12 K9d or 1 K9c per cloud; the
   text tower K9b under "block"), the prompted tower's per-crop features
   against 14a's f32 ones (top-1 >= 0.99, top-5 >= 0.97, MTA modes min cos
   >= 0.999), the K9 kernel in the dynamic mode against its plain version
   on the prompted tower's input rows (4104 crops x 54 rows), timed beside
   the dynamic halves per layer; img/s. 14c: each K9 kernel in the modes
   "ln", "hidden" and "full+score" (the engine calibrated on phase 6's
   images) on ``features_from_images`` at b1024 x 8 views (8192 crops x
   50 rows), counted, against its plain version on that forward's tower
   input, timed beside the halves per layer in the same mode.

15. (last) the probes of ``jcf_tpu_torch/scripts`` at full size. P4
   (``exp_boundary_cost``): chains of 6, 12, 24 and 48 ``copy_add_one``
   launches over [204800, 768] bf16, eager and captured in one CUDA graph,
   each held to the plain chain bit for bit: ms per chain and per kernel,
   the least-squares slope and intercept, the kernel's memory bound and
   the boundary overhead; the kernel against its plain version. P5
   (``profile_halves``): K3 and K4 of the seed-0 ViT-B/32's layer 0
   (unfolded, dynamic) at b1024 x 50, each half's ms against its bound
   and split into its stages (CUDA events around each). P3
   (``exp_batched_dot``): attention over 12,288 heads of [56, 64] bf16 on
   the tensor cores and in the CUDA-core row loop, each against the plain
   version (K8's bf16 bar), SDPA as the yardstick. P1 (``exp_w4a8``): one
   MLP half at 409,600 rows with int8 weights (the K4 kernels), int4
   weights read by the w4a8 GEMM, and int4 weights unpacked once: the
   three outputs equal bit for bit; each new kernel against its plain
   version, the int8 half against the plain ``_mlp_math``. P2
   (``exp_patch_regroup``): the im2col regroup of 512 planes of 224², f32
   and int8, by strategies A, B and C, each equal to the plain copy bit
   for bit.

Every weight and input is made from seed 0 (the LoRA factors from seed
1, as ``scripts/bench_train.py``). Exits nonzero, without the
final line, when no CUDA device is present or any phase fails. Before the
last line it prints the script's wall time, the kernels JSON line
(launches on the path, error against the plain version, kernel / plain /
library-call times and the card's bound for the same work; for the
attention kernels with two routes, the path's launches on each as
``routes``; the K9 int8
kernels once more per mode phase 14 adds, as "<kernel>/<mode>", and per
branch off the folded dense route, as "<kernel>/<branch>"; the residual
GEMMs at c_proj's shape, their out-proj shape in the log; K7 at the text
tower's bf16 shape, the other three in the log; K8 in bf16 and the
row-scale GEMM at c_fc's shape, K8 in f32 and the qkv shape in the log)
and the card's name and power limit. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 1024  # images per serving batch, as bench.py
VIEWS = 8  # views per image, the center view included
ITERS = 10  # timed serving iterations
N_CLASSES = 403  # the reference's class count (DataConfig.num_classes)
TEXT_BATCH = 512  # prompts per text-tower call (encode_class_templates)
TRAIN_BATCH = 256  # stage-1 images per step (Stage1Config.batch_size)
N_BASE = 374  # stage-1 targets cover the base classes 0..373 (scripts/bench_train.py)
TRAIN_STEPS = 10  # steps of the loss-falls check
TRAIN_ITERS = 5  # timed steps
# ViT-B/16 images per serving batch: bench.py's b1024 cut to a quarter
# (each crop of 197 tokens costs about 4x the multiply-adds of 50)
B16_BATCH = 256
# crops of the K8 f32 check at ViT-L/14@336px's 577 tokens (16 heads; the
# plain version's scores take 5.5 GB)
K8_LONG_CROPS = 256

# published dense peaks of one H100 SXM at 700 W: memory bytes/s, int8
# ops/s, bf16 flop/s
PEAK_BYTES = 3.35e12
PEAK_INT8 = 1979e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12  # f32 outside the tensor cores
PEAK_TF32 = 495e12  # TF32 on the tensor cores (the f32 GEMM's three passes)

# K9a on every branch, K9c and K9d: the persistent int8 layer kernel, its
# instances built from csrc/block_int8_*.cu
K9_PERSISTENT_SRC = "jcf_tpu_torch/csrc/block_int8.cu"
# kernel -> (path, source, TPU kernel it replaces); the int8 patch-embed
# GEMM replaces an XLA convolution, not a Pallas kernel
KERNELS = {
    "view": ("serving", "jcf_tpu_torch/csrc/view.cu", "jcf_tpu/ops/view_kernel.py:60"),
    "int8_gemm_s32": ("serving", "jcf_tpu_torch/csrc/int8_gemm.cu", "jcf_tpu/infer/engine.py:593"),
    "assemble": ("serving", "jcf_tpu_torch/csrc/assemble.cu", "jcf_tpu/ops/assemble_kernel.py:44"),
    "ln_quant": ("serving", "jcf_tpu_torch/csrc/block.cu", "jcf_tpu/ops/block_kernel.py:565"),
    "int8_gemm_bf16": ("serving", "jcf_tpu_torch/csrc/int8_gemm.cu",
                       "jcf_tpu/ops/block_kernel.py:565"),
    "attention": ("serving", "jcf_tpu_torch/csrc/pair_mma.cuh", "jcf_tpu/ops/block_kernel.py:322"),
    "int8_gemm_residual": ("serving", "jcf_tpu_torch/csrc/int8_gemm.cu",
                           "jcf_tpu/ops/block_kernel.py:643"),
    "int8_gemm_gelu_quant": ("serving", "jcf_tpu_torch/csrc/int8_gemm.cu",
                             "jcf_tpu/ops/block_kernel.py:643"),
    "cls_attention": ("serving", "jcf_tpu_torch/csrc/block.cu", "jcf_tpu/ops/block_kernel.py:1508"),
    "ln_affine": ("classifier", "jcf_tpu_torch/csrc/text_block.cu",
                  "jcf_tpu/ops/block_kernel.py:528"),
    "bf16_gemm_bias": ("classifier", "jcf_tpu_torch/csrc/bf16_gemm.cu",
                       "jcf_tpu/ops/block_kernel.py:528"),
    "causal_attention": ("classifier", "jcf_tpu_torch/csrc/text_block.cu",
                         "jcf_tpu/ops/block_kernel.py:464"),
    "bf16_gemm_residual": ("classifier", "jcf_tpu_torch/csrc/bf16_gemm.cu",
                           "jcf_tpu/ops/block_kernel.py:704"),
    "bf16_gemm_gelu": ("classifier", "jcf_tpu_torch/csrc/bf16_gemm.cu",
                       "jcf_tpu/ops/block_kernel.py:704"),
    # K7's backward replaces the XLA VJP of the same function (attention.py:239-258)
    "packed_attention": ("training", "jcf_tpu_torch/csrc/packed_attn.cu",
                         "jcf_tpu/ops/attention.py:166"),
    "packed_attention_bwd": ("training", "jcf_tpu_torch/csrc/packed_attn.cu",
                             "jcf_tpu/ops/attention.py:166"),
    # the dynamic per-row int8 linear is XLA in the JAX package, not Pallas
    "blocked_attention": ("serving_b16", "jcf_tpu_torch/csrc/blocked_attn.cu",
                          "jcf_tpu/ops/attention.py:89"),
    "int8_gemm_rowscale": ("serving_b16", "jcf_tpu_torch/csrc/int8_gemm.cu",
                           "jcf_tpu/ops/quant.py:41"),
    # the whole-layer routes (_FUSE), phase 9
    "block_int8": ("serving_block", K9_PERSISTENT_SRC,
                   "jcf_tpu/ops/block_kernel.py:732"),
    "layer_fused_int8": ("serving_layer", K9_PERSISTENT_SRC,
                         "jcf_tpu/ops/block_kernel.py:1672"),
    "stream_tower_int8": ("serving_stream", K9_PERSISTENT_SRC,
                          "jcf_tpu/ops/block_kernel.py:833"),
    "block_bf16": ("classifier_block", "jcf_tpu_torch/csrc/block_float.cu",
                   "jcf_tpu/ops/block_kernel.py:948"),
    # the dynamic branches of K3, K4 and K5, phase 10 (c_fc without row
    # scales only in mode "ln": static post-LN scales, a dynamic hidden)
    "ln_quant_rows": ("serving_dynamic", "jcf_tpu_torch/csrc/block.cu",
                      "jcf_tpu/ops/block_kernel.py:565"),
    "int8_gemm_bf16_rows": ("serving_dynamic", "jcf_tpu_torch/csrc/int8_gemm.cu",
                            "jcf_tpu/ops/block_kernel.py:565"),
    "attention_f32": ("serving_dynamic", "jcf_tpu_torch/csrc/pair_mma.cuh",
                      "jcf_tpu/ops/block_kernel.py:322"),
    "quant_rows": ("serving_dynamic", "jcf_tpu_torch/csrc/block.cu", "jcf_tpu/ops/block_kernel.py:565"),
    "int8_gemm_residual_rows": ("serving_dynamic", "jcf_tpu_torch/csrc/int8_gemm.cu",
                                "jcf_tpu/ops/block_kernel.py:643"),
    "int8_gemm_f32_rows": ("serving_dynamic", "jcf_tpu_torch/csrc/int8_gemm.cu",
                           "jcf_tpu/ops/block_kernel.py:643"),
    "gelu_quant_rows": ("serving_dynamic", "jcf_tpu_torch/csrc/block.cu",
                        "jcf_tpu/ops/block_kernel.py:643"),
    "cls_attention_f32": ("serving_dynamic", "jcf_tpu_torch/csrc/block.cu",
                          "jcf_tpu/ops/block_kernel.py:1508"),
    "int8_gemm_f32": ("serving_ln", "jcf_tpu_torch/csrc/int8_gemm.cu",
                      "jcf_tpu/ops/block_kernel.py:643"),
    # the unquantized towers, phase 11: K1's float views, K6a mask-free and
    # in f32, K6b in f32 (the f32 engine; the bf16 parity engine; the f32
    # classifier build)
    "view_f32": ("serving_f32", "jcf_tpu_torch/csrc/view.cu", "jcf_tpu/ops/view_kernel.py:60"),
    "view_bf16": ("serving_bf16", "jcf_tpu_torch/csrc/view.cu", "jcf_tpu/ops/view_kernel.py:60"),
    "ln_affine_f32": ("serving_f32", "jcf_tpu_torch/csrc/text_block.cu",
                      "jcf_tpu/ops/block_kernel.py:528"),
    "f32_gemm_bias": ("serving_f32", "jcf_tpu_torch/csrc/f32_gemm.cu",
                      "jcf_tpu/ops/block_kernel.py:528"),
    "pair_attention_f32": ("serving_f32", "jcf_tpu_torch/csrc/text_block.cu",
                           "jcf_tpu/ops/block_kernel.py:322"),
    "pair_attention_bf16": ("serving_bf16", "jcf_tpu_torch/csrc/pair_mma.cuh",
                            "jcf_tpu/ops/block_kernel.py:322"),
    "f32_gemm_gelu": ("serving_f32", "jcf_tpu_torch/csrc/f32_gemm.cu",
                      "jcf_tpu/ops/block_kernel.py:704"),
    "f32_gemm_residual": ("serving_f32", "jcf_tpu_torch/csrc/f32_gemm.cu",
                          "jcf_tpu/ops/block_kernel.py:704"),
    # the f32 GEMMs' weight split (hi and lo TF32 planes), once a layer and
    # weight when an f32 tree is made (48 in the f32 classifier build): part
    # of K6a / K6b's f32 products, which the TPU splits in its HIGHEST passes
    "tf32_split": ("classifier_f32", "jcf_tpu_torch/csrc/f32_gemm.cu",
                   "jcf_tpu/ops/block_kernel.py:528"),
    "causal_attention_f32": ("classifier_f32", "jcf_tpu_torch/csrc/attn_f32.cuh",
                             "jcf_tpu/ops/block_kernel.py:464"),
    # the masked and unfolded int8 halves, phase 12: the int8 text tower
    # (the classifier build in f32) and the unfolded vision tower
    "ln_affine_quant_rows_f32": ("classifier_int8_f32", "jcf_tpu_torch/csrc/block.cu",
                                 "jcf_tpu/ops/block_kernel.py:565"),
    "masked_attention_f32": ("classifier_int8_f32", "jcf_tpu_torch/csrc/text_block.cu",
                             "jcf_tpu/ops/block_kernel.py:464"),
    # the masked attention with a static (int8) context: the 3-head int8
    # engine in the static mode "full" under the halves, 12d
    "masked_attention": ("engine_odd_heads_full_halves", "jcf_tpu_torch/csrc/text_block.cu",
                         "jcf_tpu/ops/block_kernel.py:464"),
    "int8_gemm_residual_f32_rows": ("classifier_int8_f32", "jcf_tpu_torch/csrc/int8_gemm.cu",
                                    "jcf_tpu/ops/block_kernel.py:643"),
    "ln_affine_quant_rows": ("tower_unfolded", "jcf_tpu_torch/csrc/block.cu",
                             "jcf_tpu/ops/block_kernel.py:565"),
    "attention_scaled_f32": ("tower_unfolded", "jcf_tpu_torch/csrc/pair_mma.cuh",
                             "jcf_tpu/ops/block_kernel.py:322"),
    "cls_attention_scaled_f32": ("tower_unfolded", "jcf_tpu_torch/csrc/block.cu",
                                 "jcf_tpu/ops/block_kernel.py:1508"),
    # K6a's per-head masked route (an odd head count without a mask), 12d
    "head_attention": ("tower_odd_heads_bf16", "jcf_tpu_torch/csrc/text_block.cu",
                       "jcf_tpu/ops/block_kernel.py:528"),
    # K9b in f32: jcf-ood's default configuration under _FUSE = "block", 13c
    "block_f32": ("ood_block", "jcf_tpu_torch/csrc/block_float.cu",
                  "jcf_tpu/ops/block_kernel.py:948"),
    # the JPEG decoder (jcf-ood's parity path, 13b; the --perf path, 13d):
    # host code of the JAX package's, libjpeg-turbo, not a TPU kernel
    "jpeg_idct": ("ood_parity", "jcf_tpu_torch/csrc/jpeg.cu",
                  "jcf_tpu/native/jcfnative.cpp:50-95 (libjpeg on the host; no TPU kernel)"),
    "jpeg_upsample_color": ("ood_parity", "jcf_tpu_torch/csrc/jpeg.cu",
                            "jcf_tpu/native/jcfnative.cpp:50-95 (libjpeg on the host; no TPU "
                            "kernel)"),
    "resize_crop": ("ood_perf", "jcf_tpu_torch/csrc/jpeg.cu",
                    "jcf_tpu/native/jcfnative.cpp:99-173 (host resize; no TPU kernel)"),
    # probe P4, phase 15
    "copy_add_one": ("probe_p4", "jcf_tpu_torch/csrc/copy_add_one.cu",
                     "scripts/exp_boundary_cost.py:29"),
    # probes P3, P1 and P2, phase 15c-e (P1's int8 variant, k_int8, runs the
    # K4 kernels above: ln_quant, int8_gemm_gelu_quant, int8_gemm_residual)
    "batched_dot_mma": ("probe_p3", "jcf_tpu_torch/csrc/batched_dot.cu",
                        "scripts/exp_batched_dot.py:35"),
    "batched_dot_loop": ("probe_p3", "jcf_tpu_torch/csrc/batched_dot.cu",
                         "scripts/exp_batched_dot.py:52"),
    "w4a8_gemm_gelu_quant": ("probe_p1", "jcf_tpu_torch/csrc/w4a8.cu", "scripts/exp_w4a8.py:87"),
    "w4a8_gemm_residual": ("probe_p1", "jcf_tpu_torch/csrc/w4a8.cu", "scripts/exp_w4a8.py:87"),
    "unpack_int4": ("probe_p1", "jcf_tpu_torch/csrc/w4a8.cu", "scripts/exp_w4a8.py:93"),
    "patch_regroup_a": ("probe_p2", "jcf_tpu_torch/csrc/patch_regroup.cu",
                        "scripts/exp_patch_regroup.py:28"),
    "patch_regroup_b": ("probe_p2", "jcf_tpu_torch/csrc/patch_regroup.cu",
                        "scripts/exp_patch_regroup.py:34"),
    "patch_regroup_c": ("probe_p2", "jcf_tpu_torch/csrc/patch_regroup.cu",
                        "scripts/exp_patch_regroup.py:42"),
}


T_START = time.perf_counter()


def log(msg: str) -> None:
    """Prints ``msg`` after the seconds since the script started."""
    print(f"[{time.perf_counter() - T_START:7.1f} s] {msg}", flush=True)


def cmd_output(cmd) -> str:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as exc:
        raise RuntimeError(f"{cmd[0]} failed: {exc}") from exc
    return proc.stdout.strip()


def decode_facts() -> str:
    """What the host offers a JPEG decoder: libjpeg's header and library
    (which the port does not use) and the C++ compiler that builds its
    entropy decoder."""
    include_dirs = ["/usr/include", "/usr/local/include", "/usr/include/x86_64-linux-gnu"]
    lib_dirs = ["/usr/lib", "/usr/lib64", "/usr/local/lib", "/usr/lib/x86_64-linux-gnu"]

    def any_file(dirs, names):
        return [os.path.join(d, n) for d in dirs for n in names if os.path.exists(os.path.join(d, n))]

    facts = {
        "jpeglib.h": any_file(include_dirs, ["jpeglib.h"]),
        "libjpeg": any_file(lib_dirs, ["libjpeg.so", "libjpeg.so.8", "libjpeg.so.62",
                                       "libjpeg.a", "libturbojpeg.so", "libturbojpeg.so.0"]),
        "g++": [p for p in [shutil.which("g++")] if p],
    }
    return "; ".join(f"{k}: {', '.join(v) if v else 'absent'}" for k, v in facts.items())


def time_ms(fn, reps: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 10) -> float:
    """``fn``'s device time without the host's: ``reps`` calls captured in
    one CUDA graph, replayed 5 times -> the median ms per call."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm the allocator outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return sorted(times)[2]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, ops: float, peak_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak for their type."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, ops / peak_ops * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_int8(name, got, ref, max_frac):
    """int8 outputs: |diff| <= 1 everywhere, on at most ``max_frac`` of
    the elements (rounding ties of values that differ in the last f32 bit)."""
    d = (got.int() - ref.int()).abs()
    frac = float((d > 0).float().mean())
    ok = int(d.max()) <= 1 and frac <= max_frac
    log(f"  {name}: max |diff| {int(d.max())}, differing {frac:.2e} (tol: <= 1 on <= {max_frac})")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return float(d.max())


def check_bf16(name, got, ref, slack=None):
    """bf16 outputs: within one bf16 ulp of the larger value, plus 1e-3 for
    values near zero (sums taken in another order move small outputs by
    more than their own ulp), plus ``slack`` where given (per element)."""
    g, r = got.float(), ref.float()
    d = (g - r).abs()
    tol = 2.0**-7 * g.abs().maximum(r.abs()) + 1e-3
    if slack is not None:
        log(f"  {name}: {int((d > tol).sum())} of {d.numel()} elements over 1 bf16 ulp + 1e-3")
        tol = tol + slack
    bad = d > tol
    log(f"  {name}: max |diff| {float(d.max()):.3e}, over tolerance {int(bad.sum())} "
        f"(tol: 1 bf16 ulp + 1e-3{' + slack' if slack is not None else ''})")
    if bool(bad.any()) or not bool(g.isfinite().all()):
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return float(d.max())


def check_f32(name, got, ref):
    """f32 outputs: |diff| <= 1e-5 + 1e-5 |ref| (the same f32 sums in
    another order)."""
    d = (got.float() - ref.float()).abs()
    bad = d > 1e-5 + 1e-5 * ref.float().abs()
    log(f"  {name}: max |diff| {float(d.max()):.3e}, over tolerance {int(bad.sum())} "
        f"(tol: 1e-5 + 1e-5 |ref|)")
    if bool(bad.any()) or not bool(got.isfinite().all()):
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return float(d.max())


def check_grad_bf16(name, got, ref):
    """bf16 gradients: per head-row of dQ, dK and dV, cos >= 0.999 where
    the reference row is nonzero; rows the mask leaves at zero stay zero
    (|x| <= 1e-6)."""
    e3 = got.shape[-1]
    g, r = got.float().reshape(-1, e3 // 3), ref.float().reshape(-1, e3 // 3)
    live = r.norm(dim=-1) > 0
    cos = float(cosine_rows(g[live], r[live]).min())
    dead = float(g[~live].abs().max()) if bool((~live).any()) else 0.0
    d = float((g - r).abs().max())
    log(f"  {name}: min row cos {cos:.6f} over {int(live.sum())} rows, {int((~live).sum())} zero "
        f"rows off by {dead:.1e}, max |diff| {d:.3e} (tol: cos >= 0.999, zero rows <= 1e-6)")
    if cos < 0.999 or dead > 1e-6 or not bool(got.isfinite().all()):
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return d


def cosine_rows(a, b):
    a, b = a.float(), b.float()
    return (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1) + 1e-12)


def check_composed(name, got, ref, kern, plain):
    """Composed kernels vs the same composition of plain versions: min row
    cos >= 0.999 and |diff| <= 0.05 + 0.05 |ref|; then both timed."""
    cos = float(cosine_rows(got, ref).min())
    close = bool(((got.float() - ref.float()).abs() <= 0.05 + 0.05 * ref.float().abs()).all())
    log(f"  {name}: min row cos {cos:.6f}, max |diff| {max_err(got, ref):.3e} "
        f"(tol: cos >= 0.999, |diff| <= 0.05 + 0.05 |ref|)")
    if cos < 0.999 or not close:
        raise AssertionError(f"{name}: kernels disagree with the plain composition")
    log(f"  {name}: kernels {time_ms(kern):.3f} ms, plain {time_ms(plain):.3f} ms")


class Phase:
    """Runs each kernel against its plain version and keeps, per kernel,
    its error, kernel / plain / library-call times and its bound."""

    def __init__(self):
        self.results = {}

    def run(self, name, kern, plain, check, work, library=None, reps=10):
        out = kern()
        ref = plain()
        import torch

        torch.cuda.synchronize()
        r = {"max_abs_err": check(name, out, ref), "ms": time_ms(kern, reps),
             "plain_ms": time_ms(plain, reps), **work,
             "library_ms": time_ms(library, reps) if library is not None else None}
        self.results[name] = r
        lib = "none" if library is None else f"{r['library_ms']:.3f} ms"
        log(f"  {name}: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, library {lib}, "
            f"bound {r['bound_ms']:.3f} ms ({r['bound_by']})")
        return out


def gemm_work(a, w, out_itemsize, peak, *extra):
    """The bound of a [M, K] x [N, K] product: operands and extra inputs
    read once, the [M, N] output written once."""
    m, k = a.shape
    n = w.shape[0]
    return bound(nbytes(a, w, *extra) + m * n * out_itemsize, 2.0 * m * n * k, peak)


def f32_gemm_work(name, a, w, *extra):
    """The f32 GEMM's bound: its three TF32 passes at the TF32 rate (the
    f32 FMA bound logged beside it)."""
    m, k = a.shape
    n = w.shape[0]
    fma = gemm_work(a, w, 4, PEAK_F32, *extra)
    log(f"  {name}: f32 FMA bound {fma['bound_ms']:.3f} ms ({fma['bound_by']})")
    return bound(nbytes(a, w, *extra) + m * n * 4, 3 * 2.0 * m * n * k, PEAK_TF32)


# one ragged shape per epilogue of the int8 GEMM: rows past the 128-row
# tile, N off the 256 (and 128) tile, K off the 128-byte stage
RAGGED_GEMMS = {"s32": (4097, 2304, 3072), "bf16": (129, 192, 768), "bf16_rows": (4097, 768, 192),
                "residual": (127, 2304, 3072), "residual_rows": (4097, 192, 768),
                "residual_f32": (1, 768, 192), "residual_f32_rows": (129, 2304, 3072),
                "f32": (4097, 64, 768), "f32_rows": (127, 768, 3072),
                "gelu_quant": (4097, 2304, 768), "rowscale": (129, 768, 3072)}


def ragged_gemm_checks(dev) -> None:
    """Each int8 GEMM epilogue once at its ragged shape (``RAGGED_GEMMS``)
    against its plain version, at the bar phase 3 holds it to: s32 exact,
    bf16 one ulp + 1e-3, f32 1e-5 + 1e-5 |ref|, GELU-quant off by one on at
    most 1e-3."""
    import torch

    from jcf_tpu_torch.ops import int8_gemm as ig

    g = torch.Generator(device=dev).manual_seed(17)
    for epi, (m, n, k) in RAGGED_GEMMS.items():
        a = torch.randint(-127, 128, (m, k), device=dev, generator=g, dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), device=dev, generator=g, dtype=torch.int8)
        sc = torch.rand(n, device=dev, generator=g) * 3e-5
        bi = torch.randn(n, device=dev, generator=g) * 0.1
        rows = torch.rand(m, device=dev, generator=g) + 0.5
        r = rows if epi.endswith("_rows") else None
        resid = torch.randn(m, n, device=dev, generator=g)
        resid = resid if "f32" in epi else resid.bfloat16()
        c = torch.tensor(0.851 / 30.0, device=dev)
        base = epi.replace("_rows", "").replace("_f32", "")
        got, ref, check = {
            "s32": (lambda: ig.int8_gemm_s32(a, w), lambda: ig.int8_matmul_plain(a, w),
                    lambda nm, x, y: check_int8(nm, x, y, 0.0)),
            "bf16": (lambda: ig.int8_gemm_bf16(a, w, sc, bi, r),
                     lambda: ig.int8_gemm_bf16_plain(a, w, sc, bi, r), check_bf16),
            "residual": (lambda: ig.int8_gemm_residual(a, w, sc, bi, resid, r),
                         lambda: ig.int8_gemm_residual_plain(a, w, sc, bi, resid, r),
                         check_f32 if "f32" in epi else check_bf16),
            "f32": (lambda: ig.int8_gemm_f32(a, w, sc, bi, r),
                    lambda: ig.int8_gemm_f32_plain(a, w, sc, bi, r), check_f32),
            "gelu_quant": (lambda: ig.int8_gemm_gelu_quant(a, w, sc * 30, bi * 30, c),
                           lambda: ig.int8_gemm_gelu_quant_plain(a, w, sc * 30, bi * 30, c),
                           lambda nm, x, y: check_int8(nm, x, y, 1e-3)),
            "rowscale": (lambda: ig.int8_gemm_rowscale(a, w, rows, sc, bi),
                         lambda: ig.int8_gemm_rowscale_plain(a, w, rows, sc, bi), check_bf16),
        }[base]
        before = ig.LAUNCHES[f"int8_gemm_{epi}"]
        out = got()
        torch.cuda.synchronize()
        if ig.LAUNCHES[f"int8_gemm_{epi}"] != before + 1:
            raise AssertionError(f"int8_gemm_{epi}: the ragged check did not launch the kernel")
        check(f"int8_gemm_{epi} at {m} x {k} -> {n}", out, ref())


def serving_kernel_phase(engine, images, geometry):
    """Each serving kernel against its plain version, stage by stage
    through layer 0 of the real weights (and K5 with the last layer's), at
    B' = images x views crops -> per-kernel results."""
    import torch

    from jcf_tpu_torch.models.clip import _patchify
    from jcf_tpu_torch.ops import assemble_kernel as ak
    from jcf_tpu_torch.ops import block_kernel as bk
    from jcf_tpu_torch.ops import int8_gemm as ig
    from jcf_tpu_torch.ops import view_kernel as vk
    from jcf_tpu_torch.ops.layers import layer_slice

    cfg = engine.cfg
    res, p, s, heads = cfg.image_resolution, cfg.vision_patch_size, cfg.vision_seq_len, cfg.vision_heads
    cy, cx, inv = geometry
    n_crops = cy.shape[0] * cy.shape[1]
    log(f"serving kernel checks at B' = {n_crops} crops")
    ph = Phase()

    # K1 in both layouts: the NCHW int8 views (the checks' layout), then
    # the patch rows the engine feeds the s32 GEMM ("view" in the JSON
    # line: the serving path's launch), equal to _patchify of the NCHW
    # views bit for bit
    view_work = bound(nbytes(images) + n_crops * 3 * res * res, 0.0, PEAK_INT8)
    views = ph.run("view NCHW",
                   lambda: vk.fused_views_nchw(images, cy, cx, inv, res, quantize=True),
                   lambda: vk.fused_views_nchw_plain(images, cy, cx, inv, res, quantize=True),
                   lambda n, a, b: check_int8(n, a, b, 5e-3), view_work)
    cols = ph.run("view",
                  lambda: vk.fused_views_nchw(images, cy, cx, inv, res, quantize=True, patch=p),
                  lambda: vk.fused_views_nchw_plain(images, cy, cx, inv, res, quantize=True,
                                                    patch=p),
                  lambda n, a, b: check_int8(n, a, b, 5e-3), view_work)

    def im2col(v):
        return _patchify(v.reshape(n_crops, 3, res, res), p).reshape(-1, 3 * p * p).contiguous()

    check_int8("view patch rows vs _patchify of the NCHW views", cols, im2col(views), 0.0)
    t_copy = time_ms(lambda: im2col(vk.fused_views_nchw(images, cy, cx, inv, res, quantize=True)))
    log(f"  view NCHW + the im2col copy (the parent engine's route): {t_copy:.3f} ms")
    del views
    k_q = engine._k_q
    acc = ph.run("int8_gemm_s32",
                 lambda: ig.int8_gemm_s32(cols, k_q),
                 lambda: ig.int8_matmul_plain(cols, k_q),
                 lambda n, a, b: check_int8(n, a, b, 0.0),
                 gemm_work(cols, k_q, 4, PEAK_INT8),
                 lambda: torch._int_mm(cols, k_q.T))
    g = cfg.grid_size
    asm_args = (acc.reshape(n_crops, g, g, -1), engine._k_scale, engine._k_bias,
                engine._pos_tail, engine._cls_row, engine._ln_pre["scale"], engine._ln_pre["bias"])
    rows = ph.run("assemble",
                  lambda: ak.assemble_dense_rows(*asm_args),
                  lambda: ak.assemble_dense_rows_plain(*asm_args),
                  check_bf16,
                  bound(nbytes(*asm_args) + n_crops * s * acc.shape[-1] * 2, 0.0, PEAK_BF16))
    layer = layer_slice(engine._quant, 0)
    attn, mlp = layer["attn"], layer["mlp"]
    x_q = ph.run("ln_quant",
                 lambda: bk.ln_quant(rows, attn["ln_inv"]),
                 lambda: bk.ln_quant_plain(rows, attn["ln_inv"]),
                 lambda n, a, b: check_int8(n, a, b, 1e-3),
                 bound(nbytes(rows) + rows.numel(), 0.0, PEAK_INT8))
    wq, wo = attn["w_qkv"], attn["w_out"]
    qkv = ph.run("int8_gemm_bf16",
                 lambda: ig.int8_gemm_bf16(x_q, wq.w_int8, wq.w_scale, wq.bias),
                 lambda: ig.int8_gemm_bf16_plain(x_q, wq.w_int8, wq.w_scale, wq.bias),
                 check_bf16,
                 gemm_work(x_q, wq.w_int8, 2, PEAK_INT8, wq.w_scale, wq.bias),
                 lambda: torch._int_mm(x_q, wq.w_int8.T))
    d = qkv.shape[1] // 3 // heads
    before = dict(bk.LAUNCHES)
    ctx = ph.run("attention",
                 lambda: bk.attention(qkv, attn["ctx_inv"], s, heads),
                 lambda: bk.attention_plain(qkv, attn["ctx_inv"], s, heads),
                 lambda n, a, b: check_int8(n, a, b, 1e-2),
                 bound(nbytes(qkv) + x_q.numel(), 4.0 * n_crops * heads * s * s * d, PEAK_BF16))
    check_routes("phase 3, attention", {k: v - before[k] for k, v in bk.LAUNCHES.items()},
                 {"attention": "mma"})
    # out-proj: the residual epilogue at K = E (recorded beside c_proj's)
    mid = ph.run("int8_gemm_residual (out-proj)",
                 lambda: ig.int8_gemm_residual(ctx, wo.w_int8, wo.w_scale, wo.bias, rows),
                 lambda: ig.int8_gemm_residual_plain(ctx, wo.w_int8, wo.w_scale, wo.bias, rows),
                 check_bf16,
                 gemm_work(ctx, wo.w_int8, 2, PEAK_INT8, rows, wo.w_scale, wo.bias),
                 lambda: torch._int_mm(ctx, wo.w_int8.T))
    fc, pr = mlp["c_fc"], mlp["c_proj"]
    h_inv = mlp["h_inv"].reshape(())
    fc_sc, fc_b, gelu_c = fc.w_scale * h_inv, fc.bias * h_inv, bk.GELU_TANH_COEF / h_inv
    m_q = bk.ln_quant(mid, mlp["ln_inv"])
    h_q = ph.run("int8_gemm_gelu_quant",
                 lambda: ig.int8_gemm_gelu_quant(m_q, fc.w_int8, fc_sc, fc_b, gelu_c),
                 lambda: ig.int8_gemm_gelu_quant_plain(m_q, fc.w_int8, fc_sc, fc_b, gelu_c),
                 lambda n, a, b: check_int8(n, a, b, 1e-3),
                 gemm_work(m_q, fc.w_int8, 1, PEAK_INT8, fc_sc, fc_b),
                 lambda: torch._int_mm(m_q, fc.w_int8.T))
    ph.run("int8_gemm_residual",
           lambda: ig.int8_gemm_residual(h_q, pr.w_int8, pr.w_scale, pr.bias, mid),
           lambda: ig.int8_gemm_residual_plain(h_q, pr.w_int8, pr.w_scale, pr.bias, mid),
           check_bf16,
           gemm_work(h_q, pr.w_int8, 2, PEAK_INT8, mid, pr.w_scale, pr.bias),
           lambda: torch._int_mm(h_q, pr.w_int8.T))
    log("int8 GEMM epilogues at ragged shapes")
    ragged_gemm_checks(rows.device)

    # K5 with the last layer's weights: K/V on all rows, Q on the CLS rows
    last = layer_slice(engine._quant, cfg.vision_layers - 1)["attn"]
    e = rows.shape[1]
    lw = last["w_qkv"]
    lx_q = bk.ln_quant(rows, last["ln_inv"])
    kv = ig.int8_gemm_bf16(lx_q, lw.w_int8[e:], lw.w_scale[e:], lw.bias[e:])
    q = ig.int8_gemm_bf16(lx_q[::s].contiguous(), lw.w_int8[:e], lw.w_scale[:e], lw.bias[:e])
    ph.run("cls_attention",
           lambda: bk.cls_attention(q, kv, last["ctx_inv"], s, heads),
           lambda: bk.cls_attention_plain(q, kv, last["ctx_inv"], s, heads),
           lambda n, a, b: check_int8(n, a, b, 1e-2),
           bound(nbytes(q, kv) + q.numel(), 4.0 * n_crops * heads * s * d, PEAK_BF16))

    # the composed halves against the same halves built from plain versions
    for name, kern, x in (
            ("K3 attention half", lambda x: bk.attn_half_int8(x, attn, s, heads), rows),
            ("K4 MLP half", lambda x: bk.mlp_half_int8(x, mlp), mid),
            ("K5 CLS attention half", lambda x: bk.attn_cls_int8(x, last, s, heads), rows)):
        plain = plain_version(kern)
        check_composed(name, kern(x), plain(x), lambda: kern(x), lambda: plain(x))
    return ph.results


def text_tower_plain(x, blocks, n_heads, s):
    """The text tower composed from the plain versions (on the card)."""
    from jcf_tpu_torch.ops.layers import layer_slice

    for i in range(blocks["attn"]["w_qkv"].shape[0]):
        layer = layer_slice(blocks, i)
        x = text_half_plain(text_half_plain(x, layer, s, n_heads, "attn"), layer, s, n_heads, "mlp")
    return x


def encode_text_plain(text, cfg, ids, dtype=None):
    """``encode_text`` with the plain-version tower, in ``dtype`` (bf16 by
    default)."""
    import torch

    from jcf_tpu_torch.ops.layers import layer_norm

    bf = dtype or torch.bfloat16
    b, s = ids.shape
    x = text["token_embedding"][ids].to(bf) + text["positional_embedding"].to(bf)
    x = text_tower_plain(x.reshape(b * s, -1), text["blocks"], cfg.text_heads, s).reshape(b, s, -1)
    x = x[torch.arange(b, device=x.device), ids.argmax(dim=-1)]
    x = layer_norm(x, text["ln_final"]["scale"], text["ln_final"]["bias"])
    return torch.matmul(x.float(), text["text_projection"].to(bf).float()).to(bf)


def text_kernel_phase(text, cfg, ids):
    """Each text-tower kernel against its plain version on one batch of
    prompts, stage by stage through layer 0; then the composed halves and
    the whole tower."""
    import torch
    import torch.nn.functional as F

    from jcf_tpu_torch.ops import bf16_gemm as bg
    from jcf_tpu_torch.ops import block_kernel as bk
    from jcf_tpu_torch.ops.layers import layer_slice

    bf = torch.bfloat16
    b, s = ids.shape
    heads = cfg.text_heads
    log(f"text kernel checks at {b} prompts x {s} tokens")
    ph = Phase()
    x = (text["token_embedding"][ids].to(bf) + text["positional_embedding"].to(bf)).reshape(b * s, -1)
    e = x.shape[1]
    layer = layer_slice(text["blocks"], 0)
    ln1 = (layer["ln_1"]["scale"].to(bf), layer["ln_1"]["bias"].to(bf))
    ln2 = (layer["ln_2"]["scale"].to(bf), layer["ln_2"]["bias"].to(bf))
    attn, mlp = layer["attn"], layer["mlp"]
    w_qkv, w_out = attn["w_qkv"].to(bf), attn["w_out"].to(bf)
    w_fc, w_pr = mlp["c_fc"]["w"].to(bf), mlp["c_proj"]["w"].to(bf)
    h = ph.run("ln_affine",
               lambda: bk.ln_affine(x, *ln1),
               lambda: bk.ln_affine_plain(x, *ln1),
               check_bf16,
               bound(2 * nbytes(x) + nbytes(*ln1), 0.0, PEAK_BF16),
               lambda: F.layer_norm(x, (e,), ln1[0], ln1[1], 1e-5))
    # the library call: torch.addmm (its bias in bf16: its operands share a
    # dtype); the bare product logged beside it
    b_qkv_bf = attn["b_qkv"].to(bf)
    qkv = ph.run("bf16_gemm_bias",
                 lambda: bg.bf16_gemm_bias(h, w_qkv, attn["b_qkv"]),
                 lambda: (bg.matmul_plain(h, w_qkv) + attn["b_qkv"]).to(bf),
                 check_bf16,
                 gemm_work(h, w_qkv, 2, PEAK_BF16, attn["b_qkv"]),
                 lambda: torch.addmm(b_qkv_bf, h, w_qkv.T))
    log(f"  bf16_gemm_bias: the bare product torch.matmul "
        f"{time_ms(lambda: torch.matmul(h, w_qkv.T)):.3f} ms")
    d = e // heads
    q, k, v = qkv.reshape(b, s, 3, heads, d).permute(2, 0, 3, 1, 4)
    ctx = ph.run("causal_attention",
                 lambda: bk.causal_attention(qkv, s, heads),
                 lambda: bk.causal_attention_plain(qkv, s, heads),
                 check_bf16,
                 # keys j <= i: s (s + 1) / 2 score and PV pairs per head
                 bound(nbytes(qkv) + nbytes(x), 4.0 * b * heads * (s * (s + 1) // 2) * d, PEAK_BF16),
                 lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    mid = ph.run("bf16_gemm_residual (out-proj)",
                 lambda: bg.bf16_gemm_residual(ctx, w_out, attn["b_out"], x),
                 lambda: (x.float() + (bg.matmul_plain(ctx, w_out) + attn["b_out"])).to(bf),
                 check_bf16,
                 gemm_work(ctx, w_out, 2, PEAK_BF16, x, attn["b_out"]),
                 lambda: torch.matmul(ctx, w_out.T))
    h2 = bk.ln_affine(mid, *ln2)
    hid = ph.run("bf16_gemm_gelu",
                 lambda: bg.bf16_gemm_gelu(h2, w_fc, mlp["c_fc"]["b"]),
                 lambda: bg.gelu_plain(bg.matmul_plain(h2, w_fc) + mlp["c_fc"]["b"]).to(bf),
                 check_bf16,
                 gemm_work(h2, w_fc, 2, PEAK_BF16, mlp["c_fc"]["b"]),
                 lambda: torch.matmul(h2, w_fc.T))
    ph.run("bf16_gemm_residual",
           lambda: bg.bf16_gemm_residual(hid, w_pr, mlp["c_proj"]["b"], mid),
           lambda: (mid.float() + (bg.matmul_plain(hid, w_pr) + mlp["c_proj"]["b"])).to(bf),
           check_bf16,
           gemm_work(hid, w_pr, 2, PEAK_BF16, mid, mlp["c_proj"]["b"]),
           lambda: torch.matmul(hid, w_pr.T))

    check_composed("K6a attention half", bk.attn_half(x, layer, s, heads),
                   text_half_plain(x, layer, s, heads, "attn"),
                   lambda: bk.attn_half(x, layer, s, heads),
                   lambda: text_half_plain(x, layer, s, heads, "attn"))
    check_composed("K6b MLP half", bk.mlp_half(mid, layer),
                   text_half_plain(mid, layer, s, heads, "mlp"),
                   lambda: bk.mlp_half(mid, layer),
                   lambda: text_half_plain(mid, layer, s, heads, "mlp"))
    check_composed(f"text tower ({cfg.text_layers} layers)",
                   bk.run_float_tower(x, text["blocks"], heads, s=s, causal=True),
                   text_tower_plain(x, text["blocks"], heads, s),
                   lambda: bk.run_float_tower(x, text["blocks"], heads, s=s, causal=True),
                   lambda: text_tower_plain(x, text["blocks"], heads, s))
    return ph.results


def text_half_plain(x, layer, s, n_heads, half):
    """One half of one text layer from the plain versions, in x's dtype."""
    from jcf_tpu_torch.ops import bf16_gemm as bg
    from jcf_tpu_torch.ops import block_kernel as bk

    bf = x.dtype
    if half == "attn":
        ln, attn = layer["ln_1"], layer["attn"]
        h = bk.ln_affine_plain(x, ln["scale"].to(bf), ln["bias"].to(bf))
        qkv = (bg.matmul_plain(h, attn["w_qkv"].to(bf)) + attn["b_qkv"]).to(bf)
        ctx = bk.causal_attention_plain(qkv, s, n_heads)
        return (x.float() + (bg.matmul_plain(ctx, attn["w_out"].to(bf)) + attn["b_out"])).to(bf)
    ln, mlp = layer["ln_2"], layer["mlp"]
    h = bk.ln_affine_plain(x, ln["scale"].to(bf), ln["bias"].to(bf))
    hid = bg.gelu_plain(bg.matmul_plain(h, mlp["c_fc"]["w"].to(bf)) + mlp["c_fc"]["b"]).to(bf)
    return (x.float() + (bg.matmul_plain(hid, mlp["c_proj"]["w"].to(bf))
                         + mlp["c_proj"]["b"])).to(bf)


def synthetic_classes(path: str, rotate: int = 0) -> None:
    """A 403-line ``classes.txt`` in the reference's "Domain_Class_name id"
    form, the names made from seed 0 (the real class list is not in the
    repository); with ``rotate`` line (class id) i holds name i + rotate."""
    rng = np.random.default_rng(0)
    domains = ["Animal", "Food", "Thing", "Caltech-101", "Thu-dog", "Stanford-Cars"]
    words = ["red", "giant", "small", "striped", "wild", "golden", "spotted", "panda", "eagle",
             "pie", "coupe", "terrier", "lamp", "chair", "boat", "shirt", "apple", "bridge"]
    names = [f"{domains[i % len(domains)]}_"
             f"{'_'.join(rng.choice(words, size=int(rng.integers(1, 4)))).capitalize()}_{i}"
             for i in range(N_CLASSES)]
    with open(path, "w") as f:
        for i in range(N_CLASSES):
            f.write(f"{names[(i + rotate) % N_CLASSES]} {i}\n")


def classifier_phase(params, cfg, dev, counters):
    """The classifier build of every ``jcf-ood`` run: templates from a
    403-line class list, ``build_text_weights`` at 403 x 8 prompts with its
    kernels counted, checked against the plain-version tower, then a cache
    hit. -> (weights, launches, text kernel results)."""
    import torch

    from jcf_tpu_torch.config import DataConfig, PipelineConfig, RuntimeConfig
    from jcf_tpu_torch.models.clip import encode_text, tree_to
    from jcf_tpu_torch.ops.layers import l2_normalize
    from jcf_tpu_torch.pipelines.common import build_text_weights, ensure_templates
    from jcf_tpu_torch.tokenizer import tokenize

    text = tree_to(params["text"], dev)
    tparams = {"text": text}
    with tempfile.TemporaryDirectory() as tmp:
        synthetic_classes(os.path.join(tmp, "classes.txt"))
        pc = PipelineConfig(DataConfig(os.path.join(tmp, "classes.txt"), os.path.join(tmp, "tpl"), ""),
                            RuntimeConfig("bfloat16", os.path.join(tmp, "cache")))
        templates = ensure_templates(pc)
        n_t = len(templates[0])
        prompts = [p for c in sorted(templates) for p in templates[c]]
        log(f"classifier: {len(templates)} classes x {n_t} templates = {len(prompts)} prompts")
        ids = torch.from_numpy(tokenize(prompts[:TEXT_BATCH], truncate=True)).to(dev).long()
        text_results = text_kernel_phase(text, cfg, ids)

        torch.cuda.synchronize()
        for c in counters:
            c.update(dict.fromkeys(c, 0))
        t0 = time.perf_counter()
        built = build_text_weights(tparams, cfg, templates, pc, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        launches = {k: v for c in counters for k, v in c.items()}
        log(f"classifier built in {build_s:.2f} s (cache miss); launches: {launches}")
        check_routes("classifier", launches, {"causal_attention": "mma"})
        t0 = time.perf_counter()
        hit = build_text_weights(tparams, cfg, templates, pc, device=dev)
        torch.cuda.synchronize()
        log(f"classifier cache hit in {time.perf_counter() - t0:.2f} s")
        if not torch.equal(hit, built):
            raise AssertionError("the cache hit returned other weights than the build")

    if tuple(built.shape) != (N_CLASSES, cfg.embed_dim) or not bool(built.float().isfinite().all()):
        raise AssertionError(f"bad classifier: shape {tuple(built.shape)}")
    norm_err = float((built.float().norm(dim=-1) - 1).abs().max())
    emb_k = l2_normalize(encode_text(tparams, cfg, ids, device=dev, dtype=torch.bfloat16))
    emb_p = l2_normalize(encode_text_plain(text, cfg, ids))
    cos_emb = float(cosine_rows(emb_k, emb_p).min())
    n_c = TEXT_BATCH // n_t
    ref_w = l2_normalize(emb_p.float().reshape(n_c, n_t, -1).mean(dim=1))
    cos_w = float(cosine_rows(built[:n_c], ref_w).min())
    log(f"classifier: max |row norm - 1| {norm_err:.2e} (tol 1e-2); first {TEXT_BATCH} prompts "
        f"kernel vs plain tower min row cos {cos_emb:.6f}, classifier rows of their {n_c} "
        f"classes {cos_w:.6f} (tol 0.999)")
    if norm_err > 1e-2 or cos_emb < 0.999 or cos_w < 0.999:
        raise AssertionError("the built classifier disagrees with the plain-version tower")
    return built, launches, text_results


def k7_phase(dev):
    """K7's forward and backward kernels against the plain forward and
    autograd through it, at the stage-1 step's attention shapes in f32 and
    bf16 -> {(tower, dtype): per-kernel results}."""
    import torch
    import torch.nn.functional as F

    from jcf_tpu_torch.ops import attention as at

    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for dtype, dname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        peak = PEAK_F32 if dtype == torch.float32 else PEAK_BF16
        for tower, b, s, h, causal in (("text", N_CLASSES, 77, 8, True),
                                       ("vision", TRAIN_BATCH, 50, 12, False)):
            e, d = h * 64, 64
            log(f"K7 checks, {tower} attention of the step: {b} x {s}, {h} heads, {dname}, "
                f"{'causal' if causal else 'zero'} bias")
            qkv = torch.randn(b, s, 3 * e, device=dev, generator=gen).to(dtype)
            dout = torch.randn(b, s, e, device=dev, generator=gen).to(dtype)
            bias = at.causal_mask(s, dev) if causal else torch.zeros(s, s, device=dev)
            pairs = int(bias.isfinite().sum())  # the (query, key) pairs the bias leaves open
            q, k, v = (t.detach().requires_grad_(True)
                       for t in qkv.reshape(b, s, 3, h, d).permute(2, 0, 3, 1, 4))
            ph = Phase()
            mask = bias.to(dtype)  # SDPA takes a mask of the inputs' type
            ph.run("packed_attention",
                   lambda: at.packed_attention_fwd(qkv, h, bias),
                   lambda: at.packed_attention_plain(qkv, h, bias),
                   check_f32 if dtype == torch.float32 else check_bf16,
                   # QK^T and PV over the open pairs; the output is dout's size
                   bound(nbytes(qkv, bias, dout), 4.0 * b * h * pairs * d, peak),
                   lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
            x = qkv.clone().requires_grad_(True)
            out_p = at.packed_attention_plain(x, h, bias)
            out_l = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
            dout_l = dout.reshape(b, s, h, d).transpose(1, 2)
            # recompute P, then dP, dV, dQ, dK: five products over the open pairs
            ph.run("packed_attention_bwd",
                   lambda: at.packed_attention_bwd(qkv, h, bias, dout),
                   lambda: torch.autograd.grad(out_p, x, dout, retain_graph=True)[0],
                   check_f32 if dtype == torch.float32 else check_grad_bf16,
                   bound(2 * nbytes(qkv) + nbytes(bias, dout), 10.0 * b * h * pairs * d, peak),
                   lambda: torch.autograd.grad(out_l, (q, k, v), dout_l, retain_graph=True))
            out[(tower, dname)] = ph.results
            del out_p, out_l, x
    return out


@contextlib.contextmanager
def plain_attention():
    """Routes ``multi_head_attention`` through the plain versions of K7
    (autograd through ``packed_attention_plain``) and K8
    (``attention_plain``) for the block: the references that must not run
    a kernel under test."""
    from jcf_tpu_torch.ops import attention as at

    k7, k8 = at.packed_attention, at.fused_attention
    at.packed_attention, at.fused_attention = at.packed_attention_plain, at.attention_plain
    try:
        yield
    finally:
        at.packed_attention, at.fused_attention = k7, k8


@contextlib.contextmanager
def recorded(module, name: str, calls: list, n: int, with_kwargs: bool = False):
    """Records the arguments of the first ``n`` calls of ``module.name``
    into ``calls`` for the block (the calls themselves run unchanged): the
    positional ones, or with ``with_kwargs`` (args, kwargs)."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        if len(calls) < n:
            calls.append((args, kwargs) if with_kwargs else args)
        return fn(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)


def device_profile(run, group_of) -> None:
    """Runs ``run`` once under ``torch.profiler`` and logs its wall time,
    device busy time and idle share, the largest device kernels and the
    busy time by ``group_of(kernel name)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"  {wall:.2f} ms wall, device busy {busy:.2f} ms (idle share {1 - busy / wall:.4f}), "
        f"{sum(r[1] for r in rows)} device kernels; the largest:")
    for ms_k, n, name in rows[:20]:
        log(f"  {ms_k:9.3f} ms {n:5d}x  {name[:100]}")
    groups = {}
    for ms_k, n, name in rows:
        g = group_of(name)
        groups[g] = (groups.get(g, (0.0, 0))[0] + ms_k, groups.get(g, (0.0, 0))[1] + n)
    for g, (ms_k, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"  group {g}: {ms_k:.3f} ms in {n} launches ({ms_k / busy:.4f} of busy)")


def step_kernel_group(name: str) -> str:
    """The group of a device kernel of the training step, by its name."""
    if "packed_attn" in name:
        return "K7 backward" if "bwd" in name else "K7 forward"
    if "gemm_f32" in name or "sgemm" in name:
        return "f32 GEMMs (LoRA branch)"
    if "gemm" in name or "nvjet" in name or "cutlass" in name:
        return "bf16 GEMMs (frozen weights)"
    if "reduce_kernel" in name or "softmax" in name.lower() or "norm" in name.lower():
        return "reductions"
    return "elementwise, casts and copies"


def training_phase(params, cfg, dev, counters, smi):
    """Stage-1 LoRA training at ViT-B/32 width, bs 256 -> (launches of one
    counted bf16 step, K7 results)."""
    import torch

    from jcf_tpu_torch.config import DataConfig, PipelineConfig
    from jcf_tpu_torch.data import synthesize_templates
    from jcf_tpu_torch.peft import LoraSpec, init_lora_params, load_lora, save_lora
    from jcf_tpu_torch.pipelines import tokenize_banks
    from jcf_tpu_torch.train import adamw, make_stage1_step, state_from_numpy, state_to_numpy

    k7 = k7_phase(dev)
    for (tower, dname), r in k7.items():
        log(f"K7 {tower} {dname}: forward {r['packed_attention']['ms']:.3f} ms, backward "
            f"{r['packed_attention_bwd']['ms']:.3f} ms per launch")

    bf, f32 = torch.bfloat16, torch.float32
    with tempfile.TemporaryDirectory() as tmp:
        synthetic_classes(os.path.join(tmp, "classes.txt"))
        synthesize_templates(os.path.join(tmp, "classes.txt"), os.path.join(tmp, "tpl"))
        banks = tokenize_banks(PipelineConfig(DataConfig(template_dir=os.path.join(tmp, "tpl"))))
    spec = LoraSpec()
    lora = init_lora_params(1, spec, cfg.text_layers, cfg.text_width, cfg.vision_layers,
                            cfg.vision_width)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.random((TRAIN_BATCH, 3, cfg.image_resolution,
                                          cfg.image_resolution)).astype(np.float32)).to(dev)
    targets = torch.from_numpy(rng.integers(0, N_BASE, TRAIN_BATCH)).to(dev)
    log(f"training: banks {tuple(banks.shape)}, {TRAIN_BATCH} images of "
        f"{cfg.image_resolution}², LoRA r {spec.r} on {'/'.join(spec.params)} of every layer")
    steps = {dt: make_stage1_step(params, cfg, spec, banks, adamw(2e-4, weight_decay=1e-2),
                                  dtype=dt, device=dev) for dt in (bf, f32)}

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    # one bf16 step, counted
    init_state, step, frozen = steps[bf]
    state = init_state(lora)
    torch.cuda.synchronize()
    for c in counters:
        c.update(dict.fromkeys(c, 0))
    state, m = step(frozen, state, images, targets, 0, gen(0))
    torch.cuda.synchronize()
    launches = {k: v for c in counters for k, v in c.items()}
    log(f"training step launches: {launches}")
    n_layers = cfg.text_layers + cfg.vision_layers
    if (launches["packed_attention"], launches["packed_attention_bwd"]) != (n_layers, n_layers):
        raise AssertionError(f"expected {n_layers} K7 forward and backward launches per step")
    check_routes("training step", launches, {"packed_attention": "mma",
                                             "packed_attention_bwd": "mma"})

    # a step through the kernels vs one through the plain K7 (autograd
    # through packed_attention_plain), from the same state and seed
    def compare(dtype, start):
        init_state, step, frozen = steps[dtype]
        runs = []
        for plain in (False, True):
            st = state_from_numpy(start, init_state)
            with plain_attention() if plain else contextlib.nullcontext():
                st, m = step(frozen, st, images, targets, 1, gen(1))
            grads = {t: {k: p.grad.detach().cpu() for k, p in d.items()} for t, d in st.lora.items()}
            runs.append((float(m["loss"]), grads, state_to_numpy(st)["lora"]))
        (loss_k, g_k, new_k), (loss_p, g_p, new_p) = runs
        worst = {"grad_cos": 1.0, "update_cos": 1.0, "rel_l2": 0.0, "max_diff": 0.0}
        for t in new_k:
            for key in new_k[t]:
                a, b, s0 = new_k[t][key], new_p[t][key], start["lora"][t][key]
                pair = [torch.from_numpy(x).reshape(1, -1) for x in (a - s0, b - s0)]
                worst["grad_cos"] = min(worst["grad_cos"], float(cosine_rows(
                    g_k[t][key].reshape(1, -1), g_p[t][key].reshape(1, -1))[0]))
                worst["update_cos"] = min(worst["update_cos"], float(cosine_rows(*pair)[0]))
                worst["rel_l2"] = max(worst["rel_l2"],
                                      float(np.linalg.norm(a - b) / np.linalg.norm(b)))
                worst["max_diff"] = max(worst["max_diff"], float(np.abs(a - b).max()))
        return loss_k, loss_p, worst

    start = state_to_numpy(state)  # after one step: A and B both move in the next
    # bf16: Adam divides each gradient by its own size, so a gradient near
    # zero turns bf16 noise into a whole update; the factors are held by
    # their relative L2 difference and the gradients by their cosine
    for dtype, tol in ((bf, {"loss": 1e-3, "grad_cos": 0.999, "rel_l2": 5e-2}),
                       (f32, {"loss": 1e-5, "grad_cos": 0.99999, "max_diff": 1e-5})):
        loss_k, loss_p, w = compare(dtype, start)
        rel = abs(loss_k - loss_p) / abs(loss_p)
        name = "bf16" if dtype == bf else "f32"
        log(f"{name} step, kernels vs plain K7: loss {loss_k:.6f} vs {loss_p:.6f} (rel {rel:.2e}); "
            f"per leaf: min gradient cos {w['grad_cos']:.6f}, min update cos "
            f"{w['update_cos']:.6f}, factors max rel L2 diff {w['rel_l2']:.2e}, max |diff| "
            f"{w['max_diff']:.3e} (tol: {tol})")
        if (rel > tol["loss"] or w["grad_cos"] < tol["grad_cos"]
                or w["rel_l2"] > tol.get("rel_l2", np.inf)
                or w["max_diff"] > tol.get("max_diff", np.inf)):
            raise AssertionError(f"the {name} step through the kernels disagrees with the plain K7")

    # training on a fixed batch (images, targets and template bank 0): the loss falls
    state = init_state(lora)
    losses = []
    for i in range(TRAIN_STEPS):
        state, m = step(frozen, state, images, targets, 0, gen(100 + i))
        losses.append(float(m["loss"]))
    log(f"bf16 training, {TRAIN_STEPS} steps: loss {' '.join(f'{x:.4f}' for x in losses)}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError("the stage-1 loss did not fall")

    # timing
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for i in range(TRAIN_ITERS):
        state, m = step(frozen, state, images, targets, i % banks.shape[0], gen(200 + i))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / TRAIN_ITERS * 1e3
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"stage-1 step (bf16, bs {TRAIN_BATCH}): {ms:.2f} ms/step, "
        f"{TRAIN_BATCH / ms * 1e3:.2f} img/s, peak memory {peak:.2f} GiB, loss "
        f"{float(m['loss']):.4f} on {smi}")

    # where the step's device time goes: one step under torch.profiler
    log("profiled step:")
    device_profile(lambda: step(frozen, state, images, targets, 0, gen(300)), step_kernel_group)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lora_weights.pkl")
        layers = dict(n_text=cfg.text_layers, n_vision=cfg.vision_layers)
        save_lora(state.lora, spec, path, **layers)
        back = load_lora(path, spec, text_width=cfg.text_width, vision_width=cfg.vision_width,
                         **layers)
    for t in back:
        for key in back[t]:
            if not torch.equal(back[t][key], state.lora[t][key].detach().cpu()):
                raise AssertionError(f"the saved LoRA does not load back ({t}/{key})")
    log("LoRA saved and loaded back equal")
    del steps, state, frozen
    torch.cuda.empty_cache()
    return launches, k7


def agreement(modes_q, modes_f, classifier):
    """int8 vs f32 modes scored against ``classifier`` (bench.py's cert)
    -> (top-1 agreement, top-5 overlap, mean mode cosine)."""
    top5_q = (modes_q @ classifier.float().T).topk(5, dim=-1).indices
    top5_f = (modes_f @ classifier.float().T).topk(5, dim=-1).indices
    top1 = float((top5_q[:, 0] == top5_f[:, 0]).float().mean())
    overlap = float((top5_q[:, :, None] == top5_f[:, None, :]).any(-1).float().mean())
    return top1, overlap, float(cosine_rows(modes_q, modes_f).mean())


def gap_swing(modes_q, modes_f, classifier):
    """Per row: the f32 top-1 - top-2 logit gap, and the int8 - f32
    difference of that gap (the swing)."""
    logits_f = modes_f @ classifier.float().T
    top2 = logits_f.topk(2, dim=-1)
    delta = (modes_q - modes_f) @ classifier.float().T
    idx = top2.indices
    swing = (delta.gather(1, idx[:, :1]) - delta.gather(1, idx[:, 1:])).abs()[:, 0]
    return top2.values[:, 0] - top2.values[:, 1], swing


def margins(modes_q, modes_f, classifier) -> None:
    """Logs what decides the top-1 agreement: the f32 top-1 minus top-2
    logit gap per image, the int8 - f32 logit difference on those two
    classes, the share of images whose gap is under that difference, and
    how alike the f32 modes of different images are."""
    import torch

    gap, swing = gap_swing(modes_q, modes_f, classifier)
    mf = modes_f / modes_f.norm(dim=-1, keepdim=True)
    n = mf.shape[0]
    pair_cos = float(((mf @ mf.T).sum() - n) / (n * (n - 1)))
    q = torch.tensor([0.05, 0.5], device=gap.device)
    log(f"  f32 top-1 - top-2 logit gap: 5%/50% quantiles {gap.quantile(q).tolist()}; "
        f"int8 - f32 swing of that gap: 50%/95% quantiles "
        f"{swing.quantile(torch.tensor([0.5, 0.95], device=gap.device)).tolist()}; "
        f"images whose gap is under their swing {float((gap < swing).float().mean()):.4f}; "
        f"mean cosine between different images' f32 modes {pair_cos:.6f}")


def tie_share(modes_q, modes_f, classifier) -> float:
    """The share of rows whose f32 top-1 - top-2 logit gap is under the
    int8 - f32 swing of that gap: the near-ties that top-1 agreement
    counts."""
    gap, swing = gap_swing(modes_q, modes_f, classifier)
    return float((gap < swing).float().mean())


def check_modes(modes, batch: int, dim: int) -> None:
    """MTA modes: [batch, dim], finite, unit norm."""
    if tuple(modes.shape) != (batch, dim) or not bool(modes.isfinite().all()):
        raise AssertionError(f"bad modes: shape {tuple(modes.shape)}")
    if float((modes.norm(dim=-1) - 1).abs().max()) > 1e-3:
        raise AssertionError("modes are not unit-norm")


def b16_kernel_group(name: str) -> str:
    """The group of a device kernel of the ViT-B/16 forward, by its name."""
    if "blocked_attn" in name:
        return "K8 blocked attention"
    if "int8_gemm_kernel<4>" in name:
        return "int8 GEMMs, row-scale epilogue"
    if "int8_gemm_kernel" in name:
        return "int8 patch GEMM"
    if "view_kernel" in name:
        return "K1 views"
    if "gemm" in name or "nvjet" in name or "cutlass" in name:
        return "other GEMMs (proj, MTA)"
    if "reduce_kernel" in name or "norm" in name.lower():
        return "reductions (row amax, LayerNorm statistics, MTA)"
    return "elementwise, casts and copies (row quantization, LayerNorm, QuickGELU, residuals)"


def serving_b16_phase(dev, counters, smi, text):
    """Phase 6b: ViT-B/16 int8 serving at full width and depth, b256 x 8
    views -> (launches of one counted forward, per-kernel results)."""
    import torch
    import torch.nn.functional as F

    from jcf_tpu_torch.infer.engine import TTAEngine
    from jcf_tpu_torch.models.clip import CLIPConfig, init_clip_params
    from jcf_tpu_torch.ops import attention as at
    from jcf_tpu_torch.ops import int8_gemm as ig
    from jcf_tpu_torch.ops import quant

    cfg = CLIPConfig(vision_patch_size=16)
    t0 = time.perf_counter()
    params = init_clip_params(0, cfg)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.random((B16_BATCH, 3, 256, 256)).astype(np.float32))
    images = images.to(dev, torch.bfloat16)
    engine = TTAEngine(params, cfg, device=dev, quant="int8", n_views=VIEWS - 1)
    torch.cuda.synchronize()
    log(f"ViT-B/16 serving ({cfg.vision_seq_len} tokens, {cfg.vision_layers} layers of width "
        f"{cfg.vision_width}), b{B16_BATCH} x {VIEWS} views: engine built in "
        f"{time.perf_counter() - t0:.1f} s")
    geometry = engine.sample_geometry(torch.Generator(device=dev).manual_seed(0), B16_BATCH,
                                      images.shape[2:])

    # a first forward records layer 0's K8 and row-scale GEMM inputs (qkv,
    # out-proj, c_fc); then one forward, counted
    k8_calls, gemm_calls = [], []
    with recorded(at, "fused_attention", k8_calls, 1), \
            recorded(quant, "int8_gemm_rowscale", gemm_calls, 3):
        engine.features_from_images(images, text, geometry=geometry)
    torch.cuda.synchronize()
    for c in counters:
        c.update(dict.fromkeys(c, 0))
    modes = engine.features_from_images(images, text, geometry=geometry)
    torch.cuda.synchronize()
    launches = {k: v for c in counters for k, v in c.items()}
    log(f"ViT-B/16 serving launches: {launches}")
    expected = {"view": 1, "view/patch": 1, "int8_gemm_s32": 1,
                "blocked_attention": cfg.vision_layers, "int8_gemm_rowscale": 4 * cfg.vision_layers}
    if {k: v for k, v in launches.items() if v} != expected:
        raise AssertionError(f"expected exactly the launches {expected}")
    check_modes(modes, B16_BATCH, cfg.embed_dim)

    # K8 against attention_plain at the path's shape, bf16 then f32
    ph = Phase()
    q, k, v = k8_calls[0][:3]
    b, h, s, d = q.shape
    log(f"K8 checks at the path's shape: {b} crops x {h} heads x {s} tokens x {d}, "
        f"head views of the packed qkv")
    # bf16: p rounds to bf16 before PV, and the two sides sum p's row in
    # other orders, so a p_j near a rounding tie may round the other way:
    # that moves the output by up to one bf16 ulp of p_j (2^-7 p_j) times
    # |v_j|; the slack is 2^-7 sum_j p_j |v_j|, from the plain version
    slack = 2.0**-7 * at.attention_plain(q.float(), k.float(), v.float().abs())
    for dtype, peak, check in (
            (torch.bfloat16, PEAK_BF16, lambda n, g, r: check_bf16(n, g, r, slack)),
            (torch.float32, PEAK_F32, check_f32)):
        qd, kd, vd = (t.to(dtype) for t in (q, k, v))
        r = ph.run("blocked_attention" if dtype == torch.bfloat16 else "blocked_attention (f32)",
                   lambda: at.fused_attention(qd, kd, vd),
                   lambda: at.attention_plain(qd, kd, vd),
                   check,
                   # q, k, v read once, the context written once; QK^T and PV
                   bound(4 * nbytes(qd), 4.0 * b * h * s * s * d, peak),
                   lambda: F.scaled_dot_product_attention(qd, kd, vd))
        del qd, kd, vd, r
    # K8 in f32 at ViT-L/14@336px's 577 tokens (16 heads; 128-key groups
    # streamed twice), the log only
    g = torch.Generator(device=dev).manual_seed(577)
    qkv_l = torch.randn(K8_LONG_CROPS, 577, 3 * 16 * 64, device=dev, generator=g)
    ql, kl, vl = qkv_l.unflatten(-1, (3, 16, 64)).permute(2, 0, 3, 1, 4)
    log(f"K8 f32 at {K8_LONG_CROPS} crops x 16 heads x 577 tokens x 64, head views of a packed qkv")
    ph.run("blocked_attention (f32, 577 tokens)",
           lambda: at.fused_attention(ql, kl, vl),
           lambda: at.attention_plain(ql, kl, vl),
           check_f32,
           bound(4 * nbytes(ql), 4.0 * K8_LONG_CROPS * 16 * 577 * 577 * 64, PEAK_F32),
           lambda: F.scaled_dot_product_attention(ql, kl, vl))
    del qkv_l, ql, kl, vl
    torch.cuda.empty_cache()

    # the row-scale GEMM against its plain version: qkv (log), c_fc (JSON)
    for (a, w, xs, ws, bias), name in ((gemm_calls[0][:5], "int8_gemm_rowscale (qkv)"),
                                       (gemm_calls[2][:5], "int8_gemm_rowscale")):
        log(f"row-scale GEMM at M = {a.shape[0]}, N = {w.shape[0]}, K = {a.shape[1]}")
        ph.run(name,
               lambda: ig.int8_gemm_rowscale(a, w, xs, ws, bias),
               lambda: ig.int8_gemm_rowscale_plain(a, w, xs, ws, bias),
               check_bf16,
               gemm_work(a, w, 2, PEAK_INT8, xs, ws, bias),
               lambda: torch._int_mm(a, w.T))
    del k8_calls, gemm_calls, q, k, v, slack
    torch.cuda.empty_cache()

    # int8 vs the f32 engine on the same geometry; the reference's
    # attention is attention_plain, so no kernel under test computes it
    t0 = time.perf_counter()
    ref = TTAEngine(params, cfg, device=dev, n_views=VIEWS - 1, quant=None)
    chunk = 64
    with plain_attention():
        modes_f = torch.cat([
            ref.features_from_images(images[i : i + chunk], text,
                                     geometry=tuple(t[i : i + chunk] for t in geometry))
            for i in range(0, B16_BATCH, chunk)])
    top1, overlap, cos = agreement(modes, modes_f, text)
    min_cos = float(cosine_rows(modes, modes_f).min())
    log(f"ViT-B/16 cert int8 vs f32 ({time.perf_counter() - t0:.1f} s): top1_agree {top1:.4f} "
        f"top5_overlap {overlap:.4f} mode_cos mean {cos:.6f} min {min_cos:.6f} (gates: top-5 "
        f">= 0.97, min mode cos >= 0.999; top-1 reported, see below)")
    margins(modes, modes_f, text)
    # what the top-1 agreement measures on these random weights: the f32
    # modes of different images are nearly one direction, so the best two
    # of the 403 random classes are a few 1e-4 apart for many images. Two
    # yardsticks: the same tower in bf16 without int8 (the engine with its
    # int8 tree taken out), and the int8 path against 8 more random
    # classifiers
    tree, engine._quant = engine._quant, None
    modes_bf16 = engine.features_from_images(images, text, geometry=geometry)
    engine._quant = tree
    top1_bf16, overlap_bf16, cos_bf16 = agreement(modes_bf16, modes_f, text)
    gen = torch.Generator(device=dev).manual_seed(1)
    draws = [agreement(modes, modes_f, F.normalize(
        torch.randn(N_CLASSES, cfg.embed_dim, device=dev, generator=gen), dim=-1))[0]
        for _ in range(8)]
    log(f"  the bf16 tower without int8 vs f32: top1_agree {top1_bf16:.4f} top5_overlap "
        f"{overlap_bf16:.4f} mode_cos {cos_bf16:.6f}; the int8 path's top1_agree against 8 more "
        f"random classifiers: {' '.join(f'{x:.4f}' for x in draws)}")
    if overlap < 0.97 or min_cos < 0.999:
        raise AssertionError("the ViT-B/16 int8 path fails the ranking certificate")
    del modes_bf16

    # the f32 engine on its kernels (PipelineConfig()'s f32 tower on a
    # ViT-B/16: K8 in f32), counted, against its plain-attention modes
    modes_k, launches_k = count_forward(
        counters, lambda: ref.features_from_images(images, text, geometry=geometry))
    log(f"ViT-B/16 f32 engine launches: {launches_k}")
    want = {"view_f32": 1, "blocked_attention": cfg.vision_layers}
    if launches_k != want:
        raise AssertionError(f"expected exactly the launches {want}")
    # phase 11's gates: per-view features, the modes' mean cos and ranks
    feats_k = ref._view_features(images, geometry)
    with plain_attention():
        feats_p = torch.cat([
            ref._view_features(images[i : i + chunk], tuple(t[i : i + chunk] for t in geometry))
            for i in range(0, B16_BATCH, chunk)])
    view_cos = float(cosine_rows(feats_k.reshape(-1, cfg.embed_dim),
                                 feats_p.reshape(-1, cfg.embed_dim)).min())
    top1, overlap, cos = agreement(modes_k, modes_f, text)
    min_cos = float(cosine_rows(modes_k, modes_f).min())
    log(f"ViT-B/16 f32 engine, K8 kernels vs plain attention: per-view feature cos min "
        f"{view_cos:.7f}, top1_agree {top1:.4f} top5_overlap {overlap:.4f} mode_cos mean "
        f"{cos:.7f} min {min_cos:.7f} (gates: view cos and mean mode cos >= 0.99999, top-1 and "
        f"top-5 >= 0.99)")
    if view_cos < 0.99999 or cos < 0.99999 or top1 < 0.99 or overlap < 0.99:
        raise AssertionError("the ViT-B/16 f32 engine on K8 disagrees with its plain attention")
    del feats_k, feats_p
    gen = torch.Generator(device=dev).manual_seed(3)
    time_forwards(lambda: ref.features_from_images(images, text, generator=gen), FLOAT_ITERS,
                  B16_BATCH, "img", smi, f"ViT-B/16 f32 engine (K8 f32, b{B16_BATCH} x {VIEWS} views)")
    del ref, modes_f, modes_k
    torch.cuda.empty_cache()

    # throughput: fresh geometry per iteration, sampled on the card
    gen = torch.Generator(device=dev).manual_seed(2)
    engine.features_from_images(images, text, generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(ITERS):
        out = engine.features_from_images(images, text, generator=gen)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"ViT-B/16 slice throughput: {B16_BATCH * ITERS / elapsed:.2f} img/s (b{B16_BATCH} x "
        f"{VIEWS} views, {ITERS} iters, {elapsed / ITERS * 1e3:.2f} ms/iter, peak memory "
        f"{peak:.2f} GiB) on {smi}")
    if not bool(out.isfinite().all()):
        raise AssertionError("non-finite modes in the timed ViT-B/16 run")

    log("profiled ViT-B/16 forward:")
    device_profile(lambda: engine.features_from_images(images, text, generator=gen),
                   b16_kernel_group)
    del engine, images
    torch.cuda.empty_cache()
    return launches, ph.results


FUSED_ITERS = 3  # timed forwards of each whole-layer route


def check_layer(name, got, ref, elementwise=True):
    """Whole-layer and whole-tower kernels vs their plain versions: min row
    cos >= 0.999, the composed-tower bar, and for one layer also |diff| <=
    0.05 + 0.05 |ref| (int8 values flip at ties where sums run in another
    order; over a whole tower the flips compound, so it has the cosine
    bar only); the elements over the bf16 bar (1 ulp + 1e-3) are printed,
    not gated."""
    g, r = got.float(), ref.float()
    d = (g - r).abs()
    cos = float(cosine_rows(g, r).min())
    close = bool((d <= 0.05 + 0.05 * r.abs()).all()) or not elementwise
    over = int((d > 2.0**-7 * g.abs().maximum(r.abs()) + 1e-3).sum())
    tol = "cos >= 0.999, |diff| <= 0.05 + 0.05 |ref|" if elementwise else "cos >= 0.999"
    log(f"  {name}: min row cos {cos:.6f}, max |diff| {float(d.max()):.3e}, {over} of {d.numel()} "
        f"elements over 1 bf16 ulp + 1e-3 (tol: {tol})")
    if cos < 0.999 or not close or not bool(g.isfinite().all()):
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return float(d.max())


def one_layer_tree(tree, i):
    """Layer i of a stacked int8 tree as a stacked tree of one layer."""
    out = {k: v for k, v in tree.items() if k not in ("attn", "mlp")}
    for half in ("attn", "mlp"):
        out[half] = {k: (type(v)(*(t[i:i + 1] for t in v)) if isinstance(v, tuple) else v[i:i + 1])
                     for k, v in tree[half].items()}
    return out


def layer_work(rows, e, hidden, heads, pairs, n_bytes, peak, n_layers=1):
    """The bound of ``n_layers`` whole layers on ``rows`` rows: the
    products' E (4E + 2 hidden) multiply-adds per row at ``peak``, the
    attention's QK^T and PV over ``pairs`` (query, key) pairs per head of
    all sequences in bf16, and ``n_bytes`` moved."""
    d = e // heads
    t_ops = n_layers * (2.0 * rows * e * (4 * e + 2 * hidden) / peak
                        + 4.0 * heads * pairs * d / PEAK_BF16) * 1e3
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def fused_serving_phase(engine, images, geometry, text, modes_halves, modes_f, counters, smi, dev):
    """Phase 9, serving: the int8 ViT-B/32 engine of phase 6 under
    ``_FUSE`` = "block" (K9a), "layer" (K9d) and "stream" (K9c) -> (launches
    of one counted forward per route, per-kernel results)."""
    import torch

    from jcf_tpu_torch.ops import block_kernel as bk
    from jcf_tpu_torch.ops.layers import layer_slice

    cfg = engine.cfg
    s, heads, n_layers, e = cfg.vision_seq_len, cfg.vision_heads, cfg.vision_layers, cfg.vision_width
    quant = engine._quant
    layer0 = layer_slice(quant, 0)
    hidden = quant["mlp"]["c_fc"].w_int8.shape[-2]
    w_bytes = sum(nbytes(*q) for q in (layer0["attn"]["w_qkv"], layer0["attn"]["w_out"],
                                        layer0["mlp"]["c_fc"], layer0["mlp"]["c_proj"]))
    base = {"view": 1, "view/patch": 1, "int8_gemm_s32": 1, "assemble": 1}
    # the CLS-only last layer: K5 (LN + quant, K/V and Q GEMMs, CLS
    # attention, out-proj) and K4 on the CLS rows
    cls_layer = {"ln_quant": 2, "int8_gemm_bf16": 2, "cls_attention": 1, "int8_gemm_residual": 2,
                 "int8_gemm_gelu_quant": 1}
    ph = Phase()
    launches, halves_ms = {}, None
    for fuse, name in (("block", "block_int8"), ("layer", "layer_fused_int8"),
                       ("stream", "stream_tower_int8")):
        bk._FUSE = fuse
        log(f"phase 9, _FUSE = {fuse!r}: ViT-B/32 int8 serving, b{BATCH} x {VIEWS} views")
        calls = []
        torch.cuda.synchronize()
        for c in counters:
            c.update(dict.fromkeys(c, 0))
        with recorded(bk, name, calls, 1):
            modes = engine.features_from_images(images, text, geometry=geometry)
        torch.cuda.synchronize()
        launches[fuse] = {k: v for c in counters for k, v in c.items()}
        log(f"  launches: {launches[fuse]}")
        expected = {**base, name: 1} if fuse == "stream" else {**base, **cls_layer, name: n_layers - 1}
        if {k: v for k, v in launches[fuse].items() if v} != expected:
            raise AssertionError(f"expected exactly the launches {expected}")
        check_modes(modes, BATCH, cfg.embed_dim)

        # the kernel against its plain version on the tower's input rows
        # (layer 0's), the whole tower for K9c
        rows = calls[0][0]
        n_rows = rows.shape[0]
        pairs = n_rows // s * s * s
        if fuse == "stream":
            tower = ph.run(name, lambda: bk.stream_tower_int8(rows, quant, heads, s=s),
                           lambda: bk.stream_tower_int8_plain(rows, quant, heads, s=s),
                           lambda n, g, r: check_layer(n, g, r, elementwise=False),
                           layer_work(n_rows, e, hidden, heads, pairs,
                                      2 * nbytes(rows) + n_layers * w_bytes, PEAK_INT8, n_layers),
                           reps=2)
            # K9c's layer loop against the same kernel launched layer by
            # layer on one-layer slices of the tree: one device body, so
            # equal bit for bit; and at one hidden chunk against the
            # halves layer by layer, which run the same bodies and
            # roundings (printed, not gated, where they differ)
            chain, halves = rows, rows
            for i in range(n_layers):
                chain = bk.stream_tower_int8(chain, one_layer_tree(quant, i), heads, s=s)
            same = torch.equal(chain, tower)
            log(f"  stream_tower_int8 vs {n_layers} one-layer stream_tower_int8 launches: "
                f"{'equal' if same else 'NOT equal'} (tol: bit for bit)")
            if not same:
                raise AssertionError("K9c's layer loop disagrees with its own layers one by one")
            if bk._MLP_NSPLIT == 1:
                for i in range(n_layers):
                    halves = bk._halves_int8(halves, layer_slice(quant, i), s, heads)
                diff = float((halves.float() - tower.float()).abs().max())
                log(f"  stream_tower_int8 vs {n_layers} _halves_int8 layers at 1 chunk: "
                    f"{'equal' if torch.equal(halves, tower) else 'NOT equal'}, max |diff| "
                    f"{diff:.3e}")
            del tower, chain, halves
        else:
            kern, plain = getattr(bk, name), getattr(bk, f"{name}_plain")
            ph.run(name, lambda: kern(rows, layer0, s, heads), lambda: plain(rows, layer0, s, heads),
                   check_layer,
                   layer_work(n_rows, e, hidden, heads, pairs, 2 * nbytes(rows) + w_bytes,
                              PEAK_INT8), reps=5)
        if fuse == "layer":
            # K9d is the persistent kernel's one-layer launch with K9c's
            # bf16 mid: at the same chunk count equal bit for bit to a
            # one-layer K9c launch (gated); against the halves at that
            # count, which JAX holds equal, printed
            nsp, saved = bk._LAYER_NSPLIT, bk._MLP_NSPLIT
            bk._MLP_NSPLIT = nsp
            try:
                k9d = bk.layer_fused_int8(rows, layer0, s, heads)
                k9c = bk.stream_tower_int8(rows, one_layer_tree(quant, 0), heads, s=s)
                halves = bk._halves_int8(rows, layer0, s, heads)
            finally:
                bk._MLP_NSPLIT = saved
            same = torch.equal(k9d, k9c)
            log(f"  layer_fused_int8 vs a one-layer stream_tower_int8 at {nsp} chunks: "
                f"{'equal' if same else 'NOT equal'} (tol: bit for bit)")
            if not same:
                raise AssertionError("K9d disagrees with a one-layer K9c at the same chunk count")
            diff = float((halves.float() - k9d.float()).abs().max())
            log(f"  layer_fused_int8 vs _halves_int8 at _MLP_NSPLIT = {nsp}: "
                f"{'equal' if torch.equal(halves, k9d) else 'NOT equal'}, max |diff| {diff:.3e} "
                f"(not gated)")
            del k9d, k9c, halves
        if halves_ms is None:
            halves_ms = time_ms(lambda: bk._halves_int8(rows, layer0, s, heads))
        per_layer = ph.results[name]["ms"] / (n_layers if fuse == "stream" else 1)
        log(f"  {name}: {per_layer:.3f} ms per layer; the halves route (K3 + K4, 7 launches) "
            f"{halves_ms:.3f} ms per layer on the same rows")

        # the CLS rows against the halves route's on the same rows; the
        # modes against phase 6's halves modes and phase 7's f32 modes
        cls = bk.run_fused_tower(rows, quant, heads, flat_s=s)
        bk._FUSE = "halves"
        cls_h, launches_h = count_forward(counters,
                                          lambda: bk.run_fused_tower(rows, quant, heads, flat_s=s))
        check_routes(f"phase 9 ({fuse}), the halves route", launches_h, {"attention": "mma"})
        bk._FUSE = fuse
        cos_cls = float(cosine_rows(cls, cls_h).min())
        top1_h, overlap_h, cos_h = agreement(modes, modes_halves, text)
        top1, overlap, cos = agreement(modes, modes_f, text)
        log(f"  CLS rows vs the halves route's: min row cos {cos_cls:.6f} (tol 0.999); modes vs "
            f"the halves modes: top1_agree {top1_h:.4f} top5_overlap {overlap_h:.4f} mode_cos "
            f"{cos_h:.6f}")
        log(f"  cert int8 ({fuse}) vs f32: top1_agree {top1:.4f} top5_overlap {overlap:.4f} "
            f"mode_cos {cos:.6f} (gates: >= 0.98, >= 0.95)")
        if cos_cls < 0.999:
            raise AssertionError(f"_FUSE = {fuse!r}: the CLS rows disagree with the halves route")
        if top1 < 0.98 or overlap < 0.95:
            raise AssertionError(f"_FUSE = {fuse!r} fails the ranking certificate")

        gen = torch.Generator(device=dev).manual_seed(2)
        engine.features_from_images(images, text, generator=gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(FUSED_ITERS):
            out = engine.features_from_images(images, text, generator=gen)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        log(f"  _FUSE = {fuse!r} throughput: {BATCH * FUSED_ITERS / elapsed:.2f} img/s "
            f"({elapsed / FUSED_ITERS * 1e3:.2f} ms/iter, {FUSED_ITERS} iters) on {smi}")
        if not bool(out.isfinite().all()):
            raise AssertionError(f"non-finite modes in the timed _FUSE = {fuse!r} run")
        del calls, rows, cls, cls_h, out
        torch.cuda.empty_cache()
    return launches, ph.results


def fused_classifier_phase(params, cfg, dev, counters, built):
    """Phase 9, classifier: ``build_text_weights`` under ``_FUSE`` =
    "block" (K9b on every layer) against the halves-built classifier, and
    K9b against its plain version at 512 prompts x 77 -> (launches,
    results)."""
    import torch

    from jcf_tpu_torch.config import DataConfig, PipelineConfig, RuntimeConfig
    from jcf_tpu_torch.models.clip import tree_to
    from jcf_tpu_torch.ops import block_kernel as bk
    from jcf_tpu_torch.ops.attention import causal_mask
    from jcf_tpu_torch.ops.layers import layer_slice
    from jcf_tpu_torch.pipelines.common import build_text_weights, ensure_templates
    from jcf_tpu_torch.tokenizer import tokenize

    bf = torch.bfloat16
    text = tree_to(params["text"], dev)
    bk._FUSE = "block"
    log("phase 9, _FUSE = 'block': the classifier build (K9b)")
    with tempfile.TemporaryDirectory() as tmp:
        synthetic_classes(os.path.join(tmp, "classes.txt"))
        pc = PipelineConfig(DataConfig(os.path.join(tmp, "classes.txt"), os.path.join(tmp, "tpl"), ""),
                            RuntimeConfig("bfloat16", os.path.join(tmp, "cache")))
        templates = ensure_templates(pc)
        prompts = [p for c in sorted(templates) for p in templates[c]]
        ids = torch.from_numpy(tokenize(prompts[:TEXT_BATCH], truncate=True)).to(dev).long()
        torch.cuda.synchronize()
        for c in counters:
            c.update(dict.fromkeys(c, 0))
        t0 = time.perf_counter()
        built_k = build_text_weights({"text": text}, cfg, templates, pc, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    launches = {k: v for c in counters for k, v in c.items()}
    log(f"  classifier built in {build_s:.2f} s (cache miss); launches: {launches}")
    n_batches = -(-len(prompts) // TEXT_BATCH)
    expected = {"block_bf16": n_batches * cfg.text_layers}
    if {k: v for k, v in launches.items() if v} != expected:
        raise AssertionError(f"expected exactly the launches {expected}")
    cos_w = float(cosine_rows(built_k, built).min())
    log(f"  classifier vs the halves-built one: min row cos {cos_w:.6f} (tol 0.999)")
    if cos_w < 0.999 or not bool(built_k.float().isfinite().all()):
        raise AssertionError("the K9b-built classifier disagrees with the halves-built one")

    b, s = ids.shape
    heads, e = cfg.text_heads, cfg.text_width
    x = (text["token_embedding"][ids].to(bf) + text["positional_embedding"].to(bf)).reshape(b * s, -1)
    layer = layer_slice(text["blocks"], 0)
    hidden = layer["mlp"]["c_fc"]["w"].shape[0]
    bias = causal_mask(s, dev)
    # bf16 weights, f32 biases (qkv, out-proj, c_fc, c_proj), bf16 LN scales and biases
    w_bytes = 2 * e * (4 * e + 2 * hidden) + 4 * (5 * e + hidden) + 8 * e
    ph = Phase()
    ph.run("block_bf16", lambda: bk.block_bf16(x, layer, s, heads, bias),
           lambda: bk.block_bf16_plain(x, layer, s, heads, bias), check_layer,
           layer_work(b * s, e, hidden, heads, b * s * (s + 1) // 2,
                      2 * nbytes(x) + w_bytes + nbytes(bias), PEAK_BF16))
    halves_ms = time_ms(lambda: bk.mlp_half(bk.attn_half(x, layer, s, heads), layer))
    log(f"  block_bf16: {ph.results['block_bf16']['ms']:.3f} ms per layer; the halves (K6a + K6b, "
        f"7 launches) {halves_ms:.3f} ms per layer on the same rows")
    return launches, ph.results


MODE_ITERS = 5  # timed forwards of each quantization mode
# phase 10: the int8 engine's quantization modes below 128 tokens, and the
# ranking gates each is held to (bench.py:485-495: the default config,
# dynamic, at 0.99 / 0.97; the static-mode knobs at 0.98 / 0.95)
QUANT_MODES = (("dynamic", None, (0.99, 0.97)), ("ln", "ln", (0.98, 0.95)),
               ("hidden", "hidden", (0.98, 0.95)), ("full+score", "full+score", (0.98, 0.95)))
CROP_IMAGES, CROP_VIEWS = 8, 513  # features_from_crops: TTAConfig n_views=512 + center, batch_images=8
RES_288, SRC_288, BATCH_288 = 288, 329, 256  # ViT-B/32 at 288² (82 tokens): sources 329², b256


def mode_launches(mode: str, n_layers: int, s: int) -> dict:
    """The launches of one forward of the int8 engine below 128 tokens (K1,
    the s32 patch GEMM, K2, the tower) in each quantization mode: per layer
    K3 = LN + quant, the qkv GEMM, attention (and the context's row quant
    where it is dynamic), the out-proj GEMM; K4 = LN + quant, c_fc (with
    QuickGELU + the hidden's row quant where it is dynamic), c_proj. With
    S <= 64 the last layer's attention half is K5 (two GEMMs: K/V on all
    rows, Q on the CLS rows); from 65 tokens on it is K3."""
    n, k5 = n_layers, int(s <= 64)
    static = {"ln_quant": 2 * n, "int8_gemm_bf16": n + k5, "attention": n - k5, "cls_attention": k5}
    dyn_ln = {"ln_quant_rows": 2 * n, "int8_gemm_bf16_rows": n + k5}
    dyn_ctx = {"attention_f32": n - k5, "cls_attention_f32": k5, "quant_rows": n}
    dyn_h = {"gelu_quant_rows": n}
    table = {
        "dynamic": {**dyn_ln, **dyn_ctx, **dyn_h, "int8_gemm_residual_rows": 2 * n,
                    "int8_gemm_f32_rows": n},
        "ln": {**static, **dyn_ctx, **dyn_h, "attention": 0, "cls_attention": 0,
               "int8_gemm_residual_rows": 2 * n, "int8_gemm_f32": n},
        "hidden": {**static, **dyn_ctx, "attention": 0, "cls_attention": 0,
                   "int8_gemm_residual_rows": n, "int8_gemm_residual": n, "int8_gemm_gelu_quant": n},
        "full": {**static, "int8_gemm_residual": 2 * n, "int8_gemm_gelu_quant": n},
    }
    table["full+score"] = table["full"]
    out = {"view": 1, "view/patch": 1, "int8_gemm_s32": 1, "assemble": 1, **table[mode]}
    return with_routes({k: v for k, v in out.items() if v})


@contextlib.contextmanager
def plain_halves():
    """Routes the int8 halves (K3, K4, K5) of ``ops.block_kernel`` through
    the plain versions of their kernels for the block: the composed
    reference of a half in any quantization mode, folded or unfolded,
    masked or not."""
    from jcf_tpu_torch.ops import block_kernel as bk
    from jcf_tpu_torch.ops import int8_gemm as ig

    swaps = {
        "ln_quant": bk.ln_quant_plain,
        "ln_quant_rows": bk.ln_quant_rows_plain,
        "quant_rows": lambda x, gelu=False: (bk.gelu_quant_rows_plain if gelu else bk.quant_rows_plain)(x),
        "ln_affine_quant_rows": bk.ln_affine_quant_rows_plain,
        "attention": bk.attention_plain,
        "cls_attention": bk.cls_attention_plain,
        "masked_attention": bk.masked_attention_plain,
        **{k: getattr(ig, f"{k}_plain") for k in
           ("int8_gemm_bf16", "int8_gemm_residual", "int8_gemm_f32", "int8_gemm_gelu_quant")},
    }
    saved = {k: getattr(bk, k) for k in swaps}
    for k, fn in swaps.items():
        setattr(bk, k, fn)
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(bk, k, fn)


def plain_version(fn):
    """``fn`` run under ``plain_halves``."""
    def run(x):
        with plain_halves():
            return fn(x)
    return run


def check_rows(name, got, ref):
    """A dynamic row quantization (int8 [M, N], f32 scales [M]): the int8
    values within 1 on at most 1e-3 of the elements (statistics or tanh
    rounded in another order put a value on the other side of a tie), the
    scales within 1e-6 relative."""
    err = check_int8(name, got[0], ref[0], 1e-3)
    ds = float(((got[1] - ref[1]).abs() / ref[1].abs()).max())
    log(f"  {name}: scales max rel diff {ds:.2e} (tol: 1e-6)")
    if ds > 1e-6:
        raise AssertionError(f"{name}: row scales disagree with the plain version")
    return err


def check_ctx_f32(slack):
    """The f32 context of a dynamic-ctx attention: within 1e-5 + 1e-5 |ref|
    plus ``slack`` = 2^-7 sum_j p_j |v_j| / l, how far a p that rounds to
    bf16 on the other side of a tie moves an element."""
    def check(name, got, ref):
        d = (got - ref).abs()
        bad = d > 1e-5 + 1e-5 * ref.abs() + slack
        log(f"  {name}: max |diff| {float(d.max()):.3e}, over tolerance {int(bad.sum())} "
            f"(tol: 1e-5 + 1e-5 |ref| + 2^-7 sum p|v| / l)")
        if bool(bad.any()) or not bool(got.isfinite().all()):
            raise AssertionError(f"{name}: kernel disagrees with its plain version")
        return float(d.max())
    return check


def abs_v(qkv_or_kv, e):
    """The same rows with the values (the last E columns) made |v|."""
    import torch

    return torch.cat([qkv_or_kv[:, :-e], qkv_or_kv[:, -e:].abs()], dim=1)


def mode_kernel_checks(engine, rows, mode, ph):
    """Phase 10: each kernel a quantization mode adds, against its plain
    version on layer 0's input rows of that mode's forward (K5's with the
    last layer's weights), and the composed halves against
    ``plain_halves``."""
    import torch
    import torch.nn.functional as F

    from jcf_tpu_torch.ops import block_kernel as bk
    from jcf_tpu_torch.ops import int8_gemm as ig
    from jcf_tpu_torch.ops.layers import layer_slice

    cfg = engine.cfg
    s, heads, e = cfg.vision_seq_len, cfg.vision_heads, cfg.vision_width
    n_crops = rows.shape[0] // s
    d = e // heads
    layer = layer_slice(engine._quant, 0)
    last = layer_slice(engine._quant, cfg.vision_layers - 1)["attn"]
    attn, mlp = layer["attn"], layer["mlp"]
    wq, wo, fc, pr = attn["w_qkv"], attn["w_out"], mlp["c_fc"], mlp["c_proj"]
    lw = last["w_qkv"]
    m = rows.shape[0]
    att_ops = 4.0 * n_crops * heads * s * s * d
    cls_ops = 4.0 * n_crops * heads * s * d

    def heads_view(t, parts):
        """[B' * S', parts * E] rows -> ``parts`` head views [B', H, S', D]."""
        v = t.view(-1, t.shape[0] // n_crops, parts, heads, d)
        return [v[:, :, i].transpose(1, 2) for i in range(parts)]

    if mode == "dynamic":
        x_q, x_sc = ph.run("ln_quant_rows", lambda: bk.ln_quant_rows(rows),
                           lambda: bk.ln_quant_rows_plain(rows), check_rows,
                           bound(nbytes(rows) + m * e + 4 * m, 0.0, PEAK_INT8))
        qkv = ph.run("int8_gemm_bf16_rows",
                     lambda: ig.int8_gemm_bf16(x_q, wq.w_int8, wq.w_scale, wq.bias, row_scale=x_sc),
                     lambda: ig.int8_gemm_bf16_plain(x_q, wq.w_int8, wq.w_scale, wq.bias, x_sc),
                     check_bf16, gemm_work(x_q, wq.w_int8, 2, PEAK_INT8, wq.w_scale, wq.bias, x_sc),
                     lambda: torch._int_mm(x_q, wq.w_int8.T))
        slack = 2.0**-7 * bk.attention_plain(abs_v(qkv, e), None, s, heads)
        # library: SDPA on the head views (q holds 1/sqrt(d): scale 1); the
        # f32 context is softmax(q k^T) v, the pair shift cancels
        ctx = ph.run("attention_f32", lambda: bk.attention(qkv, None, s, heads),
                     lambda: bk.attention_plain(qkv, None, s, heads), check_ctx_f32(slack),
                     bound(nbytes(qkv) + 4 * m * e, att_ops, PEAK_BF16),
                     lambda: F.scaled_dot_product_attention(*heads_view(qkv, 3), scale=1.0))
        del slack
        c_q, c_sc = ph.run("quant_rows", lambda: bk.quant_rows(ctx),
                           lambda: bk.quant_rows_plain(ctx), check_rows,
                           bound(nbytes(ctx) + m * e + 4 * m, 0.0, PEAK_INT8))
        mid = ph.run("int8_gemm_residual_rows (out-proj)",
                     lambda: ig.int8_gemm_residual(c_q, wo.w_int8, wo.w_scale, wo.bias, rows,
                                                   row_scale=c_sc),
                     lambda: ig.int8_gemm_residual_plain(c_q, wo.w_int8, wo.w_scale, wo.bias, rows,
                                                         c_sc),
                     check_bf16, gemm_work(c_q, wo.w_int8, 2, PEAK_INT8, rows, wo.w_scale, wo.bias, c_sc),
                     lambda: torch._int_mm(c_q, wo.w_int8.T))
        m_q, m_sc = bk.ln_quant_rows(mid)
        hidden = ph.run("int8_gemm_f32_rows",
                        lambda: ig.int8_gemm_f32(m_q, fc.w_int8, fc.w_scale, fc.bias, row_scale=m_sc),
                        lambda: ig.int8_gemm_f32_plain(m_q, fc.w_int8, fc.w_scale, fc.bias, m_sc),
                        check_f32,
                        gemm_work(m_q, fc.w_int8, 4, PEAK_INT8, fc.w_scale, fc.bias, m_sc),
                        lambda: torch._int_mm(m_q, fc.w_int8.T), reps=3)
        h_q, h_sc = ph.run("gelu_quant_rows", lambda: bk.quant_rows(hidden, gelu=True),
                           lambda: bk.gelu_quant_rows_plain(hidden), check_rows,
                           bound(nbytes(hidden) + hidden.numel() + 4 * m, 0.0, PEAK_INT8), reps=3)
        del hidden
        ph.run("int8_gemm_residual_rows",
               lambda: ig.int8_gemm_residual(h_q, pr.w_int8, pr.w_scale, pr.bias, mid, row_scale=h_sc),
               lambda: ig.int8_gemm_residual_plain(h_q, pr.w_int8, pr.w_scale, pr.bias, mid, h_sc),
               check_bf16, gemm_work(h_q, pr.w_int8, 2, PEAK_INT8, mid, pr.w_scale, pr.bias, h_sc),
               lambda: torch._int_mm(h_q, pr.w_int8.T))
        del h_q, h_sc, qkv, ctx, c_q
        lx_q, lx_sc = bk.ln_quant_rows(rows)
        kv = ig.int8_gemm_bf16(lx_q, lw.w_int8[e:], lw.w_scale[e:], lw.bias[e:], row_scale=lx_sc)
        q = ig.int8_gemm_bf16(lx_q[::s].contiguous(), lw.w_int8[:e], lw.w_scale[:e], lw.bias[:e],
                              row_scale=lx_sc[::s].contiguous())
        slack = 2.0**-7 * bk.cls_attention_plain(q, abs_v(kv, e), None, s, heads)
        ph.run("cls_attention_f32", lambda: bk.cls_attention(q, kv, None, s, heads),
               lambda: bk.cls_attention_plain(q, kv, None, s, heads), check_ctx_f32(slack),
               bound(nbytes(q, kv) + 4 * n_crops * e, cls_ops, PEAK_BF16),
               lambda: F.scaled_dot_product_attention(*heads_view(q, 1), *heads_view(kv, 2),
                                                      scale=1.0))
        del kv, q, lx_q, slack
    elif mode == "ln":
        mid = bk.attn_half_int8(rows, attn, s, heads)
        m_q = bk.ln_quant(mid, mlp["ln_inv"])
        ph.run("int8_gemm_f32",
               lambda: ig.int8_gemm_f32(m_q, fc.w_int8, fc.w_scale, fc.bias),
               lambda: ig.int8_gemm_f32_plain(m_q, fc.w_int8, fc.w_scale, fc.bias), check_f32,
               gemm_work(m_q, fc.w_int8, 4, PEAK_INT8, fc.w_scale, fc.bias),
               lambda: torch._int_mm(m_q, fc.w_int8.T), reps=3)
    elif mode == "full+score":
        mid = bk.attn_half_int8(rows, attn, s, heads)
        x_q = bk.ln_quant(rows, attn["ln_inv"])
        qkv = ig.int8_gemm_bf16(x_q, wq.w_int8, wq.w_scale, wq.bias)
        shift = attn["score_shift"]
        log(f"  layer 0 score shift {float(shift):.4f}, layer {cfg.vision_layers - 1} "
            f"{float(last['score_shift']):.4f}")
        ph.run("attention (score shift)", lambda: bk.attention(qkv, attn["ctx_inv"], s, heads, shift),
               lambda: bk.attention_plain(qkv, attn["ctx_inv"], s, heads, shift),
               lambda n, a, b: check_int8(n, a, b, 1e-2),
               bound(nbytes(qkv) + m * e, att_ops, PEAK_BF16))
        lx_q = bk.ln_quant(rows, last["ln_inv"])
        kv = ig.int8_gemm_bf16(lx_q, lw.w_int8[e:], lw.w_scale[e:], lw.bias[e:])
        q = ig.int8_gemm_bf16(lx_q[::s].contiguous(), lw.w_int8[:e], lw.w_scale[:e], lw.bias[:e])
        ph.run("cls_attention (score shift)",
               lambda: bk.cls_attention(q, kv, last["ctx_inv"], s, heads, last["score_shift"]),
               lambda: bk.cls_attention_plain(q, kv, last["ctx_inv"], s, heads, last["score_shift"]),
               lambda n, a, b: check_int8(n, a, b, 1e-2),
               bound(nbytes(q, kv) + n_crops * e, cls_ops, PEAK_BF16))
        del qkv, kv, q, x_q, lx_q
    else:
        mid = bk.attn_half_int8(rows, attn, s, heads)

    halves = [(f"K3 attention half ({mode})", lambda x: bk.attn_half_int8(x, attn, s, heads), rows),
              (f"K4 MLP half ({mode})", lambda x: bk.mlp_half_int8(x, mlp), mid)]
    if s <= bk.CLS_MAX_SEQ:
        halves.append((f"K5 CLS attention half ({mode})",
                       lambda x: bk.attn_cls_int8(x, last, s, heads), rows))
    for name, kern, x in halves:
        plain = plain_version(kern)
        check_composed(name, kern(x), plain(x), lambda: kern(x), lambda: plain(x))
    torch.cuda.empty_cache()


def count_forward(counters, run):
    """Runs ``run`` once with every launch count at 0 -> (its result, the
    launches it made)."""
    import torch

    torch.cuda.synchronize()
    for c in counters:
        c.update(dict.fromkeys(c, 0))
    out = run()
    torch.cuda.synchronize()
    return out, {k: v for c in counters for k, v in c.items() if v}


def check_routes(label: str, launches: dict, want: dict) -> None:
    """Logs the route counters ("<kernel>/mma", "<kernel>/rowloop": the
    attention kernels with a tensor-core and a CUDA-core route) of
    ``launches``; ``want`` {kernel: route}: the kernel launched, every
    launch on that route."""
    routes = {k: v for k, v in launches.items() if k.endswith(("/mma", "/rowloop")) and v}
    log(f"  {label}: route counters {routes}")
    for name, route in want.items():
        if not launches.get(name) or launches.get(f"{name}/{route}", 0) != launches[name]:
            raise AssertionError(f"{label}: expected every {name} launch on the {route} route, "
                                 f"got {launches.get(name)} launches, {routes}")


def check_no_scalar(label: str, launches: dict) -> None:
    """Fails unless every row kernel of ``launches`` took its vector route:
    no "<kernel>/scalar" launch (the row quantization, K2, the LN row
    kernels), ViT-B/32's widths being those of the vector instances."""
    scalar = {k: v for k, v in launches.items() if k.endswith("/scalar") and v}
    rows = {k: launches.get(k, 0) for k in ("quant_rows", "gelu_quant_rows", "assemble")}
    log(f"  {label}: row kernels {rows}, scalar-route launches {scalar}")
    if scalar:
        raise AssertionError(f"{label}: row kernels off their vector route: {scalar}")


# the kernels counted by route beside their totals that the main paths
# run on the tensor cores: K3's mask-free attention (``block_kernel.
# PAIRED_KERNELS``) and K7's forward
MMA_ROUTED = ("attention", "attention_f32", "attention_scaled", "attention_scaled_f32",
              "packed_attention")


def with_routes(launches: dict) -> dict:
    """``launches`` with each ``MMA_ROUTED`` kernel's count repeated on its
    tensor-core route counter ("<kernel>/mma")."""
    return {**launches, **{f"{k}/mma": v for k, v in launches.items() if k in MMA_ROUTED and v}}


def route_counts(launches: dict, name: str) -> dict:
    """{"routes": {route: launches}} of a kernel counted by route (the
    attention kernels' "mma" and "rowloop", the LN row kernels' "scalar",
    K1's "patch"), the routes it took in ``launches``; {} for the
    others."""
    routes = {r: launches[f"{name}/{r}"] for r in ("mma", "rowloop", "scalar", "patch")
              if launches.get(f"{name}/{r}")}
    return {"routes": routes} if routes else {}


def time_forwards(run, iters, items, unit, smi, label) -> float:
    """``iters`` timed calls of ``run`` after one warm-up -> items per s."""
    import torch

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = run()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    rate = items * iters / elapsed
    log(f"  {label} throughput: {rate:.2f} {unit}/s ({elapsed / iters * 1e3:.2f} ms/iter, {iters} "
        f"iters) on {smi}")
    if not bool(out.isfinite().all()):
        raise AssertionError(f"non-finite output in the timed {label} run")
    return rate


def quant_modes_phase(params, images_np, images, geometry, text, modes_f, counters, smi, dev):
    """Phase 10: the int8 ViT-B/32 engine below 128 tokens in each
    quantization mode, on phase 6's images, geometry and classifier ->
    (launches of each mode's counted forward, per-kernel results)."""
    import torch

    from jcf_tpu_torch.infer.engine import TTAEngine
    from jcf_tpu_torch.models.clip import VIT_B_32
    from jcf_tpu_torch.ops import block_kernel as bk

    cfg = VIT_B_32
    ph = Phase()
    launches = {}
    for name, mode, (gate1, gate5) in QUANT_MODES:
        log(f"phase 10, {name}: ViT-B/32 int8 serving, b{BATCH} x {VIEWS} views")
        t0 = time.perf_counter()
        engine = TTAEngine(params, cfg, device=dev, quant="int8", n_views=VIEWS - 1,
                           calibration_images=None if mode is None else images_np,
                           static_quant_mode=mode or "full")
        torch.cuda.synchronize()
        log(f"  engine built in {time.perf_counter() - t0:.1f} s; tree keys attn "
            f"{sorted(engine._quant['attn'])}, mlp {sorted(engine._quant['mlp'])}")
        calls = []
        with recorded(bk, "attn_half_int8", calls, 1):
            modes, launches[name] = count_forward(
                counters, lambda: engine.features_from_images(images, text, geometry=geometry))
        log(f"  launches: {launches[name]}")
        expected = mode_launches(name, cfg.vision_layers, cfg.vision_seq_len)
        if launches[name] != expected:
            raise AssertionError(f"expected exactly the launches {expected}")
        check_routes(f"phase 10, {name}", launches[name],
                     {k: "mma" for k in ("attention", "attention_f32") if k in expected})
        check_no_scalar(f"phase 10, {name}", launches[name])
        check_modes(modes, BATCH, cfg.embed_dim)
        mode_kernel_checks(engine, calls[0][0], name, ph)
        del calls
        top1, overlap, cos = agreement(modes, modes_f, text)
        log(f"  cert int8 ({name}) vs f32: top1_agree {top1:.4f} top5_overlap {overlap:.4f} "
            f"mode_cos {cos:.6f} (gates: >= {gate1}, >= {gate5})")
        if top1 < gate1 or overlap < gate5:
            raise AssertionError(f"mode {name} fails the ranking certificate")
        gen = torch.Generator(device=dev).manual_seed(2)
        time_forwards(lambda: engine.features_from_images(images, text, generator=gen), MODE_ITERS,
                      BATCH, "img", smi, f"{name} mode")
        del engine, modes
        torch.cuda.empty_cache()
    return launches, ph.results


def crops_phase(params, images, text, counters, smi, dev):
    """Phase 10b: ``features_from_crops`` at the reference's own geometry,
    8 images x 513 crops of 224² (512 random views + the center), dynamic
    int8, against the f32 engine's -> the launches of one call."""
    import torch

    from jcf_tpu_torch.infer.engine import TTAEngine
    from jcf_tpu_torch.models.clip import CLIP_MEAN, CLIP_STD, VIT_B_32
    from jcf_tpu_torch.ops import view_kernel as vk

    cfg = VIT_B_32
    log(f"phase 10b: features_from_crops, {CROP_IMAGES} images x {CROP_VIEWS} crops of "
        f"{cfg.image_resolution}², dynamic int8")
    src = images[:CROP_IMAGES].float()
    cy, cx, inv = vk.sample_view_centers(torch.Generator(device=dev).manual_seed(3), CROP_IMAGES,
                                         CROP_VIEWS, tuple(src.shape[2:]), cfg.image_resolution)
    mean = torch.tensor(CLIP_MEAN, device=dev).reshape(1, 1, 3, 1, 1)
    std = torch.tensor(CLIP_STD, device=dev).reshape(1, 1, 3, 1, 1)
    crops = (vk.fused_views_nchw_plain(src, cy, cx, inv, cfg.image_resolution) - mean) / std
    del src, cy, cx, inv
    engine = TTAEngine(params, cfg, device=dev, quant="int8")
    modes, launches = count_forward(counters, lambda: engine.features_from_crops(crops, text))
    log(f"  launches: {launches}")
    n = cfg.vision_layers
    expected = with_routes({"ln_quant_rows": 2 * n, "int8_gemm_bf16_rows": n, "attention_f32": n,
                            "quant_rows": n, "int8_gemm_residual_rows": 2 * n,
                            "int8_gemm_f32_rows": n, "gelu_quant_rows": n})
    if launches != expected:
        raise AssertionError(f"expected exactly the launches {expected}")
    check_routes("phase 10b", launches, {"attention_f32": "mma"})
    check_modes(modes, CROP_IMAGES, cfg.embed_dim)
    feats = engine.crop_features(crops)
    if not torch.equal(engine.mta_from_features(feats, text), modes):
        raise AssertionError("features_from_crops != mta_from_features(crop_features)")
    ref = TTAEngine(params, cfg, device=dev, quant=None)
    feats_f = ref.crop_features(crops)
    modes_f = ref.mta_from_features(feats_f, text)
    flat_q, flat_f = feats.reshape(-1, feats.shape[-1]), feats_f.reshape(-1, feats.shape[-1])
    top1, overlap, cos = agreement(flat_q, flat_f, text)
    min_cos = float(cosine_rows(modes, modes_f).min())
    log(f"  cert int8 vs f32 over {flat_q.shape[0]} crops: top1_agree {top1:.4f} top5_overlap "
        f"{overlap:.4f} feature cos mean {cos:.6f}; modes: min cos {min_cos:.6f} (gates: crops "
        f">= 0.99, >= 0.97; modes min cos >= 0.999)")
    if top1 < 0.99 or overlap < 0.97 or min_cos < 0.999:
        raise AssertionError("features_from_crops fails the ranking certificate")
    del ref, feats, feats_f
    torch.cuda.empty_cache()
    time_forwards(lambda: engine.features_from_crops(crops, text), 3, CROP_IMAGES * CROP_VIEWS,
                  "crops", smi, "features_from_crops")
    del engine, crops
    torch.cuda.empty_cache()
    return launches


def serving_288_phase(text, counters, smi, dev):
    """Phase 10c: ViT-B/32 at 288² (82 tokens), static "full", b256 x 8
    views: the last layer's attention half is K3 on all rows (no K5), K3's
    attention at S = 82 against its plain version, the cert, img/s ->
    (launches, results)."""
    import torch

    from jcf_tpu_torch.infer.engine import TTAEngine
    from jcf_tpu_torch.models.clip import CLIPConfig, init_clip_params
    from jcf_tpu_torch.ops import block_kernel as bk
    from jcf_tpu_torch.ops import int8_gemm as ig
    from jcf_tpu_torch.ops.layers import layer_slice

    cfg = CLIPConfig(image_resolution=RES_288)
    s, heads, e = cfg.vision_seq_len, cfg.vision_heads, cfg.vision_width
    log(f"phase 10c: ViT-B/32 at {RES_288}² ({s} tokens), static 'full', b{BATCH_288} x {VIEWS} views")
    params = init_clip_params(0, cfg)
    rng = np.random.default_rng(0)
    images_np = rng.random((BATCH_288, 3, SRC_288, SRC_288)).astype(np.float32)
    images = torch.from_numpy(images_np).to(dev, torch.bfloat16)
    engine = TTAEngine(params, cfg, device=dev, quant="int8",
                       n_views=VIEWS - 1, calibration_images=images_np)
    geometry = engine.sample_geometry(torch.Generator(device=dev).manual_seed(0), BATCH_288,
                                      images.shape[2:])
    calls = []
    with recorded(bk, "attn_half_int8", calls, 1):
        modes, launches = count_forward(
            counters, lambda: engine.features_from_images(images, text, geometry=geometry))
    log(f"  launches: {launches}")
    expected = mode_launches("full", cfg.vision_layers, s)
    if launches != expected:
        raise AssertionError(f"expected exactly the launches {expected} (no cls_attention)")
    check_routes("phase 10c", launches, {"attention": "mma"})
    check_no_scalar("phase 10c", launches)
    check_modes(modes, BATCH_288, cfg.embed_dim)

    ph = Phase()
    rows = calls[0][0]
    attn = layer_slice(engine._quant, 0)["attn"]
    wq = attn["w_qkv"]
    x_q = bk.ln_quant(rows, attn["ln_inv"])
    qkv = ig.int8_gemm_bf16(x_q, wq.w_int8, wq.w_scale, wq.bias)
    n_crops = rows.shape[0] // s
    ph.run(f"attention ({s} tokens)", lambda: bk.attention(qkv, attn["ctx_inv"], s, heads),
           lambda: bk.attention_plain(qkv, attn["ctx_inv"], s, heads),
           lambda n, a, b: check_int8(n, a, b, 1e-2),
           bound(nbytes(qkv) + x_q.numel(), 4.0 * n_crops * heads * s * s * (e // heads), PEAK_BF16))
    last = layer_slice(engine._quant, cfg.vision_layers - 1)
    route = lambda x: bk.mlp_half_int8(bk.attn_half_int8(x, last["attn"], s, heads)[::s].contiguous(),
                                       last["mlp"])
    route_plain = plain_version(route)
    check_composed(f"last layer, K3 + K4 on the CLS rows ({s} tokens)", route(rows), route_plain(rows),
                   lambda: route(rows), lambda: route_plain(rows))
    del calls, rows, x_q, qkv

    # the cert on the per-view features (the tower's output) and on the
    # MTA modes, against the f32 engine
    ref = TTAEngine(params, cfg, device=dev, n_views=VIEWS - 1, quant=None)
    feats_f = ref._view_features(images, geometry)
    modes_f = ref.mta_from_features(feats_f, text)
    feats = engine._view_features(images, geometry)
    del ref
    view_cos = cosine_rows(feats.reshape(-1, feats.shape[-1]), feats_f.reshape(-1, feats.shape[-1]))
    top1, overlap, cos = agreement(modes, modes_f, text)
    mode_cos = cosine_rows(modes, modes_f)
    log(f"  cert int8 vs f32: top1_agree {top1:.4f} top5_overlap {overlap:.4f}; mode cos mean "
        f"{cos:.6f}, 1% quantile {float(mode_cos.quantile(0.01)):.6f}, min "
        f"{float(mode_cos.min()):.6f}; per-view feature cos over {view_cos.numel()} views mean "
        f"{float(view_cos.mean()):.6f} min {float(view_cos.min()):.6f}")
    margins(modes, modes_f, text)
    # fixed gates, as phase 6b's: the f32 model's own top-1 - top-2 gaps at
    # 288² are as small as ViT-B/16's (PERF.md section 2), so top-1 counts
    # near-ties and is printed; the tower's output (the per-view features)
    # is gated, and the modes on their mean cosine (MTA can move a mode
    # between near-equal peaks)
    log("  gates: top-5 >= 0.97, mean mode cos >= 0.999, per-view feature cos mean >= 0.999 "
        "and min >= 0.999; top-1 printed")
    ok = (overlap >= 0.97 and cos >= 0.999 and float(view_cos.mean()) >= 0.999
          and float(view_cos.min()) >= 0.999)
    if not ok:
        raise AssertionError(f"ViT-B/32 at {RES_288}² fails the ranking certificate")
    del feats, view_cos
    gen = torch.Generator(device=dev).manual_seed(2)
    time_forwards(lambda: engine.features_from_images(images, text, generator=gen), MODE_ITERS,
                  BATCH_288, "img", smi, f"ViT-B/32 at {RES_288}²")
    launches_k9, results_k9 = k9_288_routes(engine, images, geometry, text, feats_f, modes_f,
                                            counters, smi)
    ph.results.update(results_k9)
    del engine, images, modes, modes_f, feats_f
    torch.cuda.empty_cache()
    return launches, ph.results, launches_k9


# phase 11: the unquantized towers. Launches of one layer of each float
# tower (K6a: LN, qkv, attention, out-proj; K6b: LN, c_fc + GELU, c_proj);
# the f32 GEMMs read the weights' TF32 planes, split once a tree
# (``tree_planes``), not once a call
FLOAT_LAYER = {
    "f32": {"ln_affine_f32": 2, "f32_gemm_bias": 1, "pair_attention_f32": 1,
            "f32_gemm_residual": 2, "f32_gemm_gelu": 1},
    "bf16": {"ln_affine": 2, "bf16_gemm_bias": 1, "pair_attention_bf16": 1,
             "bf16_gemm_residual": 2, "bf16_gemm_gelu": 1},
    "f32 text": {"ln_affine_f32": 2, "f32_gemm_bias": 1, "causal_attention_f32": 1,
                 "f32_gemm_residual": 2, "f32_gemm_gelu": 1},
    "bf16 text": {"ln_affine": 2, "bf16_gemm_bias": 1, "causal_attention": 1,
                  "causal_attention/mma": 1, "bf16_gemm_residual": 2, "bf16_gemm_gelu": 1},
}
FLOAT_ITERS = 2  # timed calls of the unquantized engines
# the int8 certificate (static "full", b1024 x 8 views) as measured
# against the earlier f32 path, the composable tower with plain K7
# attention, on an H100 80GB HBM3 at 700 W: top-1, top-5, mode cos
PLAIN_K7_CERT = (0.9980, 0.9828, 0.999133)


def views_preset(pc, n_random: int):
    """``pc`` with ``n_random`` random views per image (the center view is
    added): the serving cells' 8 views, not the preset's own count."""
    return dataclasses.replace(pc, tta=dataclasses.replace(pc.tta, n_views=n_random))


def tree_planes(n_layers: int, trees: int = 1) -> dict:
    """The launches of ``with_tf32_planes`` on ``trees`` f32 trees: one
    ``tf32_split`` a layer and GEMM weight."""
    return {"tf32_split": 4 * n_layers * trees}


def float_launches(kind: str, n_layers: int, calls: int = 1, view: bool = True) -> dict:
    """The launches of ``calls`` unquantized tower forwards (and K1 once,
    with ``view``)."""
    out = {k: v * n_layers * calls for k, v in FLOAT_LAYER[kind].items()}
    if view:
        out["view_f32" if kind == "f32" else "view_bf16"] = 1
    return out


@contextlib.contextmanager
def plain_float():
    """Routes the float halves (K6a, K6b in bf16 and f32), the weights'
    TF32 split and the engines' K1 through the plain versions of their
    kernels for the block: the composed reference of the unquantized
    towers."""
    import torch

    from jcf_tpu_torch.infer import engine as eng
    from jcf_tpu_torch.ops import bf16_gemm as bg
    from jcf_tpu_torch.ops import block_kernel as bk
    from jcf_tpu_torch.ops import f32_gemm as fg
    from jcf_tpu_torch.ops import view_kernel as vk

    def split_plain(w, out=None):
        return fg.tf32_split_plain(w) if out is None else out.copy_(fg.tf32_split_plain(w))

    swaps = [(bk, "ln_affine", bk.ln_affine_plain), (bk, "pair_attention", bk.pair_attention_plain),
             (bk, "causal_attention", bk.causal_attention_plain),
             (bk, "masked_attention", bk.masked_attention_plain),
             (eng, "fused_views_nchw", vk.fused_views_nchw_plain), (fg, "tf32_split", split_plain)]
    saved = [(m, k, getattr(m, k)) for m, k, _ in swaps]
    gemms = dict(bk._GEMMS)
    for m, k, fn in swaps:
        setattr(m, k, fn)
    # the plain GEMMs read the weights; the planes the halves hand them go unread
    bk._GEMMS[torch.float32] = tuple(
        (lambda *args, planes=None, f=f: f(*args))
        for f in (fg.f32_gemm_bias_plain, fg.f32_gemm_gelu_plain, fg.f32_gemm_residual_plain))
    bk._GEMMS[torch.bfloat16] = (bg.bf16_gemm_bias_plain, bg.bf16_gemm_gelu_plain,
                                 bg.bf16_gemm_residual_plain)
    try:
        yield
    finally:
        for m, k, fn in saved:
            setattr(m, k, fn)
        bk._GEMMS.update(gemms)


def plain_float_version(fn):
    """``fn`` run under ``plain_float``."""
    def run(*args):
        with plain_float():
            return fn(*args)
    return run


def check_f32_sum(a, w):
    """An f32 GEMM against its plain version: within 1e-5 + 1e-5 |ref| +
    1e-6 sum_k |a_k w_k| per element (K-term f32 sums in another order;
    their worst case is K u sum |a w|, 2e-4 of it at K = 3072)."""
    import torch

    def check(name, got, ref):
        d = (got - ref).abs()
        bad = d > 1e-5 + 1e-5 * ref.abs() + 1e-6 * torch.matmul(a.abs(), w.abs().T)
        log(f"  {name}: max |diff| {float(d.max()):.3e}, over tolerance {int(bad.sum())} "
            f"(tol: 1e-5 + 1e-5 |ref| + 1e-6 sum |a w|)")
        if bool(bad.any()) or not bool(got.isfinite().all()):
            raise AssertionError(f"{name}: kernel disagrees with its plain version")
        return float(d.max())
    return check


def head_views(qkv, rows_per, heads):
    """q, k, v [B, H, S, D] views of qkv [B * S, 3E] (SDPA's layout)."""
    e = qkv.shape[1] // 3
    return qkv.view(-1, rows_per, 3, heads, e // heads).permute(2, 0, 3, 1, 4)


def planes_phase(params, cfg, ref, dev, counters, smi):
    """Phase 11b': ``with_tf32_planes`` on the f32 text tower, counted (one
    ``tf32_split`` a layer and weight) and timed, the planes equal to the
    plain split bit for bit; the bytes the text planes and the f32
    engine's vision planes hold -> the text tree with its planes (phase
    11a's)."""
    import torch

    from jcf_tpu_torch.models.clip import tree_to
    from jcf_tpu_torch.ops import f32_gemm as fg

    def weights(tree):
        """(weight, planes) of the four GEMM weights of a stacked tree."""
        out = []
        for path in fg.PLANE_WEIGHTS:
            owner = tree
            for key in path[:-1]:
                owner = owner[key]
            out.append((owner[path[-1]], owner.get(fg.planes_key(path[-1]))))
        return out

    text = tree_to(params["text"], dev)
    blocks, launches = count_forward(counters, lambda: fg.with_tf32_planes(text["blocks"]))
    if launches != tree_planes(cfg.text_layers):
        raise AssertionError(f"with_tf32_planes: launches {launches}, expected "
                             f"{tree_planes(cfg.text_layers)}")
    for w, planes in weights(blocks):
        want = torch.stack([fg.tf32_split_plain(w[i]) for i in range(w.shape[0])])
        if not torch.equal(planes.view(torch.int32), want.view(torch.int32)):
            raise AssertionError("the text tower's planes differ from the plain split")
    ms = time_ms(lambda: fg.with_tf32_planes(text["blocks"]), 3)
    text_mb = sum(nbytes(p) for _, p in weights(blocks)) / 1e6
    vision_mb = sum(nbytes(p) for _, p in weights(ref._params["visual"]["blocks"])) / 1e6
    log(f"phase 11b': the f32 text tower's TF32 planes (with_tf32_planes, once a tree): "
        f"{launches['tf32_split']} tf32_split launches in {ms:.3f} ms, {text_mb:.1f} MB, bit for "
        f"bit the plain split; the f32 engine's vision planes {vision_mb:.1f} MB, on {smi}")
    return {**text, "blocks": blocks}


def float_kernel_phase(rows_f32, rows_bf16, text, cfg, ids, images, geometry):
    """Phase 11a: each new kernel against its plain version at the paths'
    shapes: K1's bf16 and f32 views at the serving batch; on layer 0's
    input rows of the f32 and bf16 engines' forwards the f32 LN, the three
    f32 GEMM epilogues, the mask-free attention in f32 and bf16, the bf16
    c_fc and c_proj epilogues at the vision width, and the composed halves
    in both dtypes; on 512 prompts x 77 tokens the f32 text pieces, the
    causal f32 attention and the 12-layer f32 text tower -> results."""
    import torch
    import torch.nn.functional as F

    from jcf_tpu_torch.ops import bf16_gemm as bg
    from jcf_tpu_torch.ops import block_kernel as bk
    from jcf_tpu_torch.ops import f32_gemm as fg
    from jcf_tpu_torch.ops import view_kernel as vk
    from jcf_tpu_torch.ops.layers import layer_slice

    res, s, heads = cfg.image_resolution, cfg.vision_seq_len, cfg.vision_heads
    cy, cx, inv = geometry
    n_crops = cy.shape[0] * cy.shape[1]
    log(f"phase 11a: unquantized kernel checks at B' = {n_crops} crops, {ids.shape[0]} prompts")
    ph = Phase()
    img32 = images.float()
    ph.run("view_f32",
           lambda: vk.fused_views_nchw(img32, cy, cx, inv, res),
           lambda: vk.fused_views_nchw_plain(img32, cy, cx, inv, res),
           check_f32,
           bound(nbytes(img32) + n_crops * 3 * res * res * 4, 0.0, PEAK_F32))
    del img32
    ph.run("view_bf16",
           lambda: vk.fused_views_nchw(images, cy, cx, inv, res),
           lambda: vk.fused_views_nchw_plain(images, cy, cx, inv, res),
           check_bf16,
           bound(nbytes(images) + n_crops * 3 * res * res * 2, 0.0, PEAK_BF16))
    torch.cuda.empty_cache()

    # the f32 vision layer, stage by stage
    x, layer = rows_f32[0], rows_f32[1]
    e = x.shape[1]
    d = e // heads
    ln1, ln2, attn, mlp = layer["ln_1"], layer["ln_2"], layer["attn"], layer["mlp"]
    h = ph.run("ln_affine_f32",
               lambda: bk.ln_affine(x, ln1["scale"], ln1["bias"]),
               lambda: bk.ln_affine_plain(x, ln1["scale"], ln1["bias"]),
               check_f32,
               bound(2 * nbytes(x) + nbytes(ln1["scale"], ln1["bias"]), 0.0, PEAK_F32),
               lambda: F.layer_norm(x, (e,), ln1["scale"], ln1["bias"], 1e-5))
    wq, bq, pq = attn["w_qkv"], attn["b_qkv"], attn["w_qkv_tf32"]
    qkv = ph.run("f32_gemm_bias",
                 lambda: fg.f32_gemm_bias(h, wq, bq, planes=pq),
                 lambda: fg.f32_gemm_bias_plain(h, wq, bq),
                 check_f32_sum(h, wq),
                 f32_gemm_work("f32_gemm_bias", h, wq, bq),
                 lambda: torch.addmm(bq, h, wq.T))
    log(f"  f32_gemm_bias: the bare product torch.matmul {time_ms(lambda: torch.matmul(h, wq.T)):.3f} ms")
    q, k, v = head_views(qkv, s, heads)
    ctx = ph.run("pair_attention_f32",
                 lambda: bk.pair_attention(qkv, s, heads),
                 lambda: bk.pair_attention_plain(qkv, s, heads),
                 check_f32,
                 bound(nbytes(qkv) + nbytes(x), 4.0 * n_crops * heads * s * s * d, PEAK_F32),
                 lambda: F.scaled_dot_product_attention(q, k, v))
    del q, k, v
    wo, bo = attn["w_out"], attn["b_out"]
    mid = ph.run("f32_gemm_residual (out-proj)",
                 lambda: fg.f32_gemm_residual(ctx, wo, bo, x, planes=attn["w_out_tf32"]),
                 lambda: fg.f32_gemm_residual_plain(ctx, wo, bo, x),
                 check_f32_sum(ctx, wo),
                 f32_gemm_work("f32_gemm_residual (out-proj)", ctx, wo, x, bo),
                 lambda: torch.matmul(ctx, wo.T))
    del h, qkv, ctx
    h2 = bk.ln_affine(mid, ln2["scale"], ln2["bias"])
    wf, bf_ = mlp["c_fc"]["w"], mlp["c_fc"]["b"]
    hid = ph.run("f32_gemm_gelu",
                 lambda: fg.f32_gemm_gelu(h2, wf, bf_, planes=mlp["c_fc"]["w_tf32"]),
                 lambda: fg.f32_gemm_gelu_plain(h2, wf, bf_),
                 check_f32_sum(h2, wf),
                 f32_gemm_work("f32_gemm_gelu", h2, wf, bf_),
                 lambda: torch.matmul(h2, wf.T))
    del h2
    torch.cuda.empty_cache()
    ph.run("tf32_split",
           lambda: fg.tf32_split(wf),
           lambda: fg.tf32_split_plain(wf),
           lambda n, g, r: check_equal(n, g.view(torch.int32), r.view(torch.int32)),
           bound(3 * nbytes(wf), 0.0, PEAK_F32))
    wp, bp = mlp["c_proj"]["w"], mlp["c_proj"]["b"]
    ph.run("f32_gemm_residual",
           lambda: fg.f32_gemm_residual(hid, wp, bp, mid, planes=mlp["c_proj"]["w_tf32"]),
           lambda: fg.f32_gemm_residual_plain(hid, wp, bp, mid),
           check_f32_sum(hid, wp),
           f32_gemm_work("f32_gemm_residual", hid, wp, mid, bp),
           lambda: torch.matmul(hid, wp.T))
    del hid
    torch.cuda.empty_cache()
    for name, kern, inp in (
            ("K6a mask-free attention half (f32)",
             lambda t: bk.attn_half(t, layer, s, heads, causal=False), x),
            ("K6b MLP half (f32)", lambda t: bk.mlp_half(t, layer), mid)):
        plain = plain_float_version(kern)
        check_composed(name, kern(inp), plain(inp), lambda: kern(inp), lambda: plain(inp))
    del mid
    torch.cuda.empty_cache()

    # the bf16 parity engine's attention
    xb, layer_b = rows_bf16[0], rows_bf16[1]
    lb, ab = layer_b["ln_1"], layer_b["attn"]
    hb = ph.run("ln_affine (vision)",
                lambda: bk.ln_affine(xb, lb["scale"], lb["bias"]),
                lambda: bk.ln_affine_plain(xb, lb["scale"], lb["bias"]),
                check_bf16,
                bound(2 * nbytes(xb) + nbytes(lb["scale"], lb["bias"]), 0.0, PEAK_BF16),
                lambda: F.layer_norm(xb, (xb.shape[1],), lb["scale"], lb["bias"], 1e-5))
    wqb, bqb = ab["w_qkv"], ab["b_qkv"].float()
    bqb_bf = bqb.to(torch.bfloat16)
    qkv_b = ph.run("bf16_gemm_bias (vision)",
                   lambda: bg.bf16_gemm_bias(hb, wqb, bqb),
                   lambda: bg.bf16_gemm_bias_plain(hb, wqb, bqb),
                   check_bf16,
                   gemm_work(hb, wqb, 2, PEAK_BF16, bqb),
                   lambda: torch.addmm(bqb_bf, hb, wqb.T))
    log(f"  bf16_gemm_bias (vision): the bare product torch.matmul "
        f"{time_ms(lambda: torch.matmul(hb, wqb.T)):.3f} ms")
    del hb
    slack = 2.0**-7 * bk.pair_attention_plain(abs_v(qkv_b, e), s, heads).float()
    q, k, v = head_views(qkv_b, s, heads)
    ctx_b = ph.run("pair_attention_bf16",
                   lambda: bk.pair_attention(qkv_b, s, heads),
                   lambda: bk.pair_attention_plain(qkv_b, s, heads),
                   lambda n, a, b: check_bf16(n, a, b, slack),
                   bound(nbytes(qkv_b) + nbytes(xb), 4.0 * n_crops * heads * s * s * d, PEAK_BF16),
                   lambda: F.scaled_dot_product_attention(q, k, v))
    del q, k, v, qkv_b, slack
    wob, bob = ab["w_out"], ab["b_out"].float()
    ph.run("bf16_gemm_residual (vision out-proj)",
           lambda: bg.bf16_gemm_residual(ctx_b, wob, bob, xb),
           lambda: bg.bf16_gemm_residual_plain(ctx_b, wob, bob, xb),
           check_bf16,
           gemm_work(ctx_b, wob, 2, PEAK_BF16, xb, bob),
           lambda: torch.matmul(ctx_b, wob.T))
    del ctx_b
    torch.cuda.empty_cache()
    kern = lambda t: bk.attn_half(t, layer_b, s, heads, causal=False)
    plain = plain_float_version(kern)
    midb = kern(xb)
    check_composed("K6a mask-free attention half (bf16)", midb, plain(xb), lambda: kern(xb),
                   lambda: plain(xb))
    # its MLP half at the vision width: c_fc 768 -> 3072, c_proj 3072 -> 768
    l2b, mb = layer_b["ln_2"], layer_b["mlp"]
    h2b = bk.ln_affine(midb, l2b["scale"], l2b["bias"])
    wfb, bfb = mb["c_fc"]["w"], mb["c_fc"]["b"].float()
    hidb = ph.run("bf16_gemm_gelu (vision)",
                  lambda: bg.bf16_gemm_gelu(h2b, wfb, bfb),
                  lambda: bg.bf16_gemm_gelu_plain(h2b, wfb, bfb),
                  check_bf16,
                  gemm_work(h2b, wfb, 2, PEAK_BF16, bfb),
                  lambda: torch.matmul(h2b, wfb.T))
    del h2b
    torch.cuda.empty_cache()
    wpb, bpb = mb["c_proj"]["w"], mb["c_proj"]["b"].float()
    ph.run("bf16_gemm_residual (vision)",
           lambda: bg.bf16_gemm_residual(hidb, wpb, bpb, midb),
           lambda: bg.bf16_gemm_residual_plain(hidb, wpb, bpb, midb),
           check_bf16,
           gemm_work(hidb, wpb, 2, PEAK_BF16, midb, bpb),
           lambda: torch.matmul(hidb, wpb.T))
    del hidb
    torch.cuda.empty_cache()
    kern = lambda t: bk.mlp_half(t, layer_b)
    plain = plain_float_version(kern)
    check_composed("K6b MLP half (bf16)", kern(midb), plain(midb), lambda: kern(midb),
                   lambda: plain(midb))
    del midb
    torch.cuda.empty_cache()

    # the f32 text tower at 512 prompts x 77 tokens
    b, st = ids.shape
    th = cfg.text_heads
    xt = (text["token_embedding"][ids] + text["positional_embedding"]).reshape(b * st, -1)
    et = xt.shape[1]
    tl = layer_slice(text["blocks"], 0)
    tp = tl["attn"]["w_qkv_tf32"]
    t1, ta = tl["ln_1"], tl["attn"]
    ht = ph.run("ln_affine_f32 (text)",
                lambda: bk.ln_affine(xt, t1["scale"], t1["bias"]),
                lambda: bk.ln_affine_plain(xt, t1["scale"], t1["bias"]),
                check_f32,
                bound(2 * nbytes(xt) + nbytes(t1["scale"], t1["bias"]), 0.0, PEAK_F32),
                lambda: F.layer_norm(xt, (et,), t1["scale"], t1["bias"], 1e-5))
    qkv_t = ph.run("f32_gemm_bias (text)",
                   lambda: fg.f32_gemm_bias(ht, ta["w_qkv"], ta["b_qkv"], planes=tp),
                   lambda: fg.f32_gemm_bias_plain(ht, ta["w_qkv"], ta["b_qkv"]),
                   check_f32_sum(ht, ta["w_qkv"]),
                   f32_gemm_work("f32_gemm_bias (text)", ht, ta["w_qkv"], ta["b_qkv"]),
                   lambda: torch.addmm(ta["b_qkv"], ht, ta["w_qkv"].T))
    log(f"  f32_gemm_bias (text): the bare product torch.matmul "
        f"{time_ms(lambda: torch.matmul(ht, ta['w_qkv'].T)):.3f} ms")
    q, k, v = head_views(qkv_t, st, th)
    ph.run("causal_attention_f32",
           lambda: bk.causal_attention(qkv_t, st, th),
           lambda: bk.causal_attention_plain(qkv_t, st, th),
           check_f32,
           # keys j <= i: s (s + 1) / 2 score and PV pairs per head
           bound(nbytes(qkv_t) + nbytes(xt), 4.0 * b * th * (st * (st + 1) // 2) * (et // th),
                 PEAK_F32),
           lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    del q, k, v, qkv_t, ht
    check_composed(f"f32 text tower ({cfg.text_layers} layers)",
                   bk.run_float_tower(xt, text["blocks"], th, s=st, causal=True),
                   text_tower_plain(xt, text["blocks"], th, st),
                   lambda: bk.run_float_tower(xt, text["blocks"], th, s=st, causal=True),
                   lambda: text_tower_plain(xt, text["blocks"], th, st))
    return ph.results


def float_classifier_phase(params, cfg, dev, counters):
    """Phase 11b: the classifier build under ``PipelineConfig()`` (f32, the
    reference preset) for 403 classes x 8 templates, counted and timed,
    held against the plain-version f32 text tower -> (launches, the token
    ids of its first 512 prompts, the classifier)."""
    import torch

    from jcf_tpu_torch.config import DataConfig, PipelineConfig, RuntimeConfig
    from jcf_tpu_torch.models.clip import encode_text, tree_to
    from jcf_tpu_torch.ops import f32_gemm as fg
    from jcf_tpu_torch.ops.layers import l2_normalize
    from jcf_tpu_torch.pipelines.common import build_text_weights, ensure_templates
    from jcf_tpu_torch.tokenizer import tokenize

    text = tree_to(params["text"], dev)
    tparams = {"text": text}
    with tempfile.TemporaryDirectory() as tmp:
        synthetic_classes(os.path.join(tmp, "classes.txt"))
        pc = PipelineConfig(DataConfig(os.path.join(tmp, "classes.txt"), os.path.join(tmp, "tpl"), ""),
                            RuntimeConfig("float32", os.path.join(tmp, "cache")))
        templates = ensure_templates(pc)
        prompts = [p for c in sorted(templates) for p in templates[c]]
        n_t = len(templates[0])
        log(f"phase 11b: the f32 classifier build (PipelineConfig()), {len(templates)} classes x "
            f"{n_t} templates")
        t0 = time.perf_counter()
        built, launches = count_forward(
            counters, lambda: build_text_weights(tparams, cfg, templates, pc, device=dev))
        log(f"  built in {time.perf_counter() - t0:.2f} s (cache miss); launches: {launches}")
    calls = -(-len(prompts) // TEXT_BATCH)
    # the text weights split once for the build, before its batches
    expected = add_launches(float_launches("f32 text", cfg.text_layers, calls, view=False),
                            tree_planes(cfg.text_layers))
    if launches != expected:
        raise AssertionError(f"expected exactly the launches {expected}")
    if built.dtype != torch.float32 or tuple(built.shape) != (N_CLASSES, cfg.embed_dim):
        raise AssertionError(f"bad f32 classifier: {built.dtype} {tuple(built.shape)}")
    ids = torch.from_numpy(tokenize(prompts[:TEXT_BATCH], truncate=True)).to(dev).long()
    planed = {"text": {**text, "blocks": fg.with_tf32_planes(text["blocks"])}}
    emb_k = l2_normalize(encode_text(planed, cfg, ids, device=dev, dtype=torch.float32))
    emb_p = l2_normalize(encode_text_plain(text, cfg, ids, torch.float32))
    cos_emb = float(cosine_rows(emb_k, emb_p).min())
    n_c = TEXT_BATCH // n_t
    ref_w = l2_normalize(emb_p.reshape(n_c, n_t, -1).mean(dim=1))
    cos_w = float(cosine_rows(built[:n_c], ref_w).min())
    log(f"  first {TEXT_BATCH} prompts, kernel vs plain f32 tower: min row cos {cos_emb:.7f}; "
        f"classifier rows of their {n_c} classes {cos_w:.7f} (tol 0.99999)")
    if cos_emb < 0.99999 or cos_w < 0.99999:
        raise AssertionError("the f32 classifier disagrees with the plain-version tower")
    return launches, ids, built


def float_engine_phase(params, ref, modes_f, images, geometry, text, counters, smi, dev):
    """Phase 11c-e: the f32 engine (the certificate reference) against the
    plain-version f32 route, img/s; its ``features_from_crops`` at 8 x 513
    crops, counted, against the plain route, crops/s; the bf16 parity
    engine at b1024 x 8 views, counted, certified against the f32 engine,
    img/s; the ``_FUSE`` = "block" routes, and K9b against its plain
    version on the bf16 engine's layer-0 rows -> (bf16 launches, bf16
    layer-0 call, results)."""
    import torch

    from jcf_tpu_torch.config import reference_preset
    from jcf_tpu_torch.models.clip import CLIP_MEAN, CLIP_STD, VIT_B_32
    from jcf_tpu_torch.ops import block_kernel as bk
    from jcf_tpu_torch.ops import view_kernel as vk
    from jcf_tpu_torch.pipelines.common import build_engine

    cfg = VIT_B_32
    dim = cfg.embed_dim
    log(f"phase 11c: the f32 engine (quant=None) vs its plain-version route, b{BATCH} x {VIEWS} views")
    feats = ref._view_features(images, geometry)
    with plain_float():
        feats_p = ref._view_features(images, geometry)
    view_cos = cosine_rows(feats.reshape(-1, dim), feats_p.reshape(-1, dim))
    top1, overlap, cos = agreement(modes_f, ref.mta_from_features(feats_p, text), text)
    log(f"  per-view feature cos over {view_cos.numel()} views: min {float(view_cos.min()):.7f}; "
        f"modes top1_agree {top1:.4f} top5_overlap {overlap:.4f} mode_cos {cos:.7f} (gates: "
        f"view cos >= 0.99999, top-1 >= 0.99, top-5 >= 0.99)")
    if float(view_cos.min()) < 0.99999 or top1 < 0.99 or overlap < 0.99:
        raise AssertionError("the f32 engine disagrees with its plain-version route")
    del feats, feats_p
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(2)
    time_forwards(lambda: ref.features_from_images(images, text, generator=gen), FLOAT_ITERS, BATCH,
                  "img", smi, "f32 engine (features_from_images)")

    log(f"phase 11d: f32 features_from_crops, {CROP_IMAGES} images x {CROP_VIEWS} crops")
    src = images[:CROP_IMAGES].float()
    cy, cx, inv = vk.sample_view_centers(torch.Generator(device=dev).manual_seed(3), CROP_IMAGES,
                                         CROP_VIEWS, tuple(src.shape[2:]), cfg.image_resolution)
    mean = torch.tensor(CLIP_MEAN, device=dev).reshape(1, 1, 3, 1, 1)
    std = torch.tensor(CLIP_STD, device=dev).reshape(1, 1, 3, 1, 1)
    crops = (vk.fused_views_nchw_plain(src, cy, cx, inv, cfg.image_resolution) - mean) / std
    del src, cy, cx, inv
    modes_c, launches_c = count_forward(counters, lambda: ref.features_from_crops(crops, text))
    log(f"  launches: {launches_c}")
    expected = float_launches("f32", cfg.vision_layers, view=False)
    if launches_c != expected:
        raise AssertionError(f"expected exactly the launches {expected}")
    check_modes(modes_c, CROP_IMAGES, dim)
    feats = ref.crop_features(crops)
    with plain_float():
        feats_p = ref.crop_features(crops)
    crop_cos = cosine_rows(feats.reshape(-1, dim), feats_p.reshape(-1, dim))
    mode_cos = cosine_rows(modes_c, ref.mta_from_features(feats_p, text))
    log(f"  per-crop feature cos min {float(crop_cos.min()):.7f}, mode cos min "
        f"{float(mode_cos.min()):.7f} (gate: crop cos >= 0.99999)")
    if float(crop_cos.min()) < 0.99999:
        raise AssertionError("f32 features_from_crops disagrees with its plain-version route")
    del feats, feats_p
    time_forwards(lambda: ref.features_from_crops(crops, text), FLOAT_ITERS,
                  CROP_IMAGES * CROP_VIEWS, "crops", smi, "f32 features_from_crops")
    del crops
    torch.cuda.empty_cache()

    log(f"phase 11e: the bf16 parity engine (quant=None, bf16), b{BATCH} x {VIEWS} views")
    # bench.py's JCF_BENCH_QUANT=none: the reference preset in bf16
    pc = reference_preset()
    pc = dataclasses.replace(pc, runtime=dataclasses.replace(pc.runtime, compute_dtype="bfloat16"))
    eb = build_engine(params, cfg, views_preset(pc, VIEWS - 1), device=dev)
    if (eb.quant, eb.dtype) != (None, torch.bfloat16):
        raise AssertionError(f"the parity config built a {eb.quant} {eb.dtype} engine")
    calls = []
    with recorded(bk, "attn_half", calls, 1):
        modes_b, launches_b = count_forward(
            counters, lambda: eb.features_from_images(images, text, geometry=geometry))
    log(f"  launches: {launches_b}")
    expected = float_launches("bf16", cfg.vision_layers)
    if launches_b != expected:
        raise AssertionError(f"expected exactly the launches {expected}")
    check_modes(modes_b, BATCH, dim)
    top1, overlap, cos = agreement(modes_b, modes_f, text)
    log(f"  cert bf16 vs f32: top1_agree {top1:.4f} top5_overlap {overlap:.4f} mode_cos {cos:.6f} "
        f"(gates: >= 0.99, >= 0.97)")
    margins(modes_b, modes_f, text)
    if top1 < 0.99 or overlap < 0.97:
        raise AssertionError("the bf16 parity engine fails the ranking certificate")
    gen = torch.Generator(device=dev).manual_seed(2)
    time_forwards(lambda: eb.features_from_images(images, text, generator=gen), FLOAT_ITERS, BATCH,
                  "img", smi, "bf16 parity engine")

    log("phase 11f: the unquantized engines under _FUSE = 'block'")
    ph = Phase()
    bk._FUSE = "block"
    try:
        modes_k, launches_k = count_forward(
            counters, lambda: eb.features_from_images(images, text, geometry=geometry))
        log(f"  bf16 launches: {launches_k}")
        expected = {"view_bf16": 1, "block_bf16": cfg.vision_layers}
        if launches_k != expected:
            raise AssertionError(f"expected exactly the launches {expected}")
        check_modes(modes_k, BATCH, dim)
        top1, overlap, cos = agreement(modes_k, modes_f, text)
        log(f"  cert bf16 'block' vs f32: top1_agree {top1:.4f} top5_overlap {overlap:.4f} "
            f"mode_cos {cos:.6f}; mode cos vs the halves {float(cosine_rows(modes_k, modes_b).mean()):.6f} "
            f"(gates: >= 0.98, >= 0.95)")
        if top1 < 0.98 or overlap < 0.95:
            raise AssertionError("the bf16 'block' route fails the ranking certificate")
        # K9b at E = 768 (its global-scratch branch) on layer 0's bf16 rows,
        # with the all-zero bias the vision tower gives it
        xb, layer_b = calls[0][0], calls[0][1]
        e, s, heads = cfg.vision_width, cfg.vision_seq_len, cfg.vision_heads
        hidden = layer_b["mlp"]["c_fc"]["w"].shape[0]
        zeros = torch.zeros((s, s), dtype=torch.float32, device=dev)
        n_seq = xb.shape[0] // s
        # bf16 weights, f32 biases (qkv, out-proj, c_fc, c_proj), bf16 LN scales and biases
        w_bytes = 2 * e * (4 * e + 2 * hidden) + 4 * (5 * e + hidden) + 8 * e
        ph.run("block_bf16 (vision)", lambda: bk.block_bf16(xb, layer_b, s, heads, zeros),
               lambda: bk.block_bf16_plain(xb, layer_b, s, heads, zeros), check_layer,
               layer_work(xb.shape[0], e, hidden, heads, n_seq * s * s,
                          2 * nbytes(xb) + w_bytes + nbytes(zeros), PEAK_BF16), reps=3)
        halves_ms = time_ms(lambda: bk.mlp_half(bk.attn_half(xb, layer_b, s, heads, causal=False),
                                                 layer_b), 3)
        log(f"  block_bf16 (vision): {n_seq} x {s} rows, kernel "
            f"{ph.results['block_bf16 (vision)']['ms']:.3f} ms per layer; the halves (K6a + K6b, "
            f"7 launches) {halves_ms:.3f} ms per layer on the same rows")
        del xb, zeros
        # the f32 engine under "block": K9b in f32 (block_f32) on every layer
        modes_fk, launches_fk = count_forward(
            counters, lambda: ref.features_from_images(images[:8], text,
                                                       geometry=tuple(t[:8] for t in geometry)))
        log(f"  f32 launches on 8 images: {launches_fk}")
        expected = {"view_f32": 1, "block_f32": cfg.vision_layers}
        if launches_fk != expected:
            raise AssertionError(f"expected exactly the launches {expected}")
        cos_f = float(cosine_rows(modes_fk, modes_f[:8]).min())
        log(f"  f32 'block' modes vs the f32 halves': min cos {cos_f:.7f} (tol 0.9999)")
        if cos_f < 0.9999:
            raise AssertionError("the f32 'block' route disagrees with the f32 halves")
    finally:
        bk._FUSE = "halves"
    del eb, modes_b, modes_k
    torch.cuda.empty_cache()
    return launches_b, calls[0], ph.results


# phase 12: the masked and unfolded int8 halves. Launches of one layer of
# the int8 text tower, the unfolded tree (K3: LN + its affine + row quant,
# qkv, the causal masked attention, the context's row quant, out-proj; K4:
# LN + quant, c_fc, QuickGELU + row quant, c_proj), bf16 rows; f32 rows
# take the f32 variants of the LN kernel and the residual epilogue
INT8_TEXT_LAYER = {"ln_affine_quant_rows": 2, "int8_gemm_bf16_rows": 1, "masked_attention_f32": 1,
                   "masked_attention_f32/mma": 1, "quant_rows": 1, "int8_gemm_residual_rows": 2,
                   "int8_gemm_f32_rows": 1, "gelu_quant_rows": 1}
F32_NAMES = {"ln_affine_quant_rows": "ln_affine_quant_rows_f32",
             "int8_gemm_residual_rows": "int8_gemm_residual_f32_rows"}
SMALL_CROPS = 1024  # crops of the odd-head and 64-token towers (12d)


def int8_text_launches(f32: bool, n_layers: int, calls: int) -> dict:
    """The launches of ``calls`` int8 text-tower forwards."""
    return {(F32_NAMES.get(k, k) if f32 else k): v * n_layers * calls
            for k, v in INT8_TEXT_LAYER.items()}


def ranking(modes, w_a, w_b):
    """Top-1 agreement and top-5 overlap of the same modes scored under
    two classifiers."""
    import torch

    la, lb = modes.float() @ w_a.float().T, modes.float() @ w_b.float().T
    top1 = float((la.argmax(-1) == lb.argmax(-1)).float().mean())
    ta, tb = la.topk(5, dim=-1).indices, lb.topk(5, dim=-1).indices
    overlap = float((ta[:, :, None] == tb[:, None, :]).any(-1).float().mean())
    return top1, overlap


def int8_classifier_phase(params, cfg, dev, counters, built_f32, modes_f, fuse="halves"):
    """Phase 12b: the int8 classifier build (``build_classifier_weights(
    quant=quantize_clip_params(params)["text"])``, the JAX package's
    ``tests/test_quant.py`` route) at 403 x 8 prompts in f32 and bf16,
    under ``_FUSE`` = ``fuse``: counted (the halves: ``int8_text_launches``;
    "block": K9a per layer, masked, and nothing else), held against the
    same build on the plain versions (rows cos >= 0.9999 in f32, >= 0.999
    in bf16: int8 ties that f32 sums in another order flip compound over
    12 layers, as in the bf16 classifier of phase 5) and, as the JAX
    certificate, against the f32 classifier (rows cos min > 0.99); the
    ranking of phase 7's f32 modes under both classifiers is printed.
    Under "block" K9a is held against its plain version on the first
    call's layer-0 rows (512 x 77) -> (launches by dtype, results)."""
    import torch

    from jcf_tpu_torch.config import DataConfig, PipelineConfig, RuntimeConfig
    from jcf_tpu_torch.models.clip import tree_to
    from jcf_tpu_torch.ops import block_kernel as bk
    from jcf_tpu_torch.ops.quant import quantize_clip_params
    from jcf_tpu_torch.pipelines.common import ensure_templates
    from jcf_tpu_torch.tta import build_classifier_weights

    tparams = {"text": tree_to(params["text"], dev)}
    quant = quantize_clip_params(tparams)["text"]
    launches = {}
    ph = Phase()
    with tempfile.TemporaryDirectory() as tmp:
        synthetic_classes(os.path.join(tmp, "classes.txt"))
        pc = PipelineConfig(DataConfig(os.path.join(tmp, "classes.txt"), os.path.join(tmp, "tpl"), ""),
                            RuntimeConfig("float32", None))
        templates = ensure_templates(pc)
    n_prompts = sum(len(v) for v in templates.values())
    calls = -(-n_prompts // TEXT_BATCH)
    tag = "" if fuse == "halves" else f" (_FUSE = {fuse!r})"
    bk._FUSE = fuse
    try:
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).replace("torch.", "")
            build = lambda: build_classifier_weights(tparams, cfg, templates, device=dev, dtype=dt,
                                                     quant=quant)
            layer_calls = []
            t0 = time.perf_counter()
            with recorded(bk, "block_int8", layer_calls, 1, with_kwargs=True):
                built, launches[name] = count_forward(counters, build)
            secs = time.perf_counter() - t0
            log(f"phase 12b{tag}: int8 classifier ({name}), {len(templates)} classes, {n_prompts} "
                f"prompts in {calls} tower calls, built in {secs:.2f} s; launches: {launches[name]}")
            if fuse == "halves":
                expected = int8_text_launches(dt == torch.float32, cfg.text_layers, calls)
            else:
                branch = "block_int8/" + ("masked_f32" if dt == torch.float32 else "masked")
                expected = {"block_int8": cfg.text_layers * calls, branch: cfg.text_layers * calls}
            if launches[name] != expected:
                raise AssertionError(f"expected exactly the launches {expected}")
            if fuse == "halves":
                check_routes(f"phase 12b ({name})", launches[name], {"masked_attention_f32": "mma"})
            if built.dtype != dt or tuple(built.shape) != (N_CLASSES, cfg.embed_dim):
                raise AssertionError(f"bad int8 classifier: {built.dtype} {tuple(built.shape)}")
            with plain_halves(), plain_k9():
                plain = build()
            cos_p = float(cosine_rows(built, plain).min())
            gate = 0.9999 if dt == torch.float32 else 0.999
            cos_f = cosine_rows(built, built_f32)
            top1, overlap = ranking(modes_f, built, built_f32)
            log(f"  rows cos vs the plain-version build min {cos_p:.7f} (gate >= {gate}); vs the "
                f"f32 classifier min {float(cos_f.min()):.6f} mean {float(cos_f.mean()):.6f} (gate "
                f"> 0.99); phase 7's f32 modes under int8 vs f32 classifier: top1_agree {top1:.4f} "
                f"top5_overlap {overlap:.4f} (not gated)")
            if cos_p < gate or float(cos_f.min()) <= 0.99:
                raise AssertionError(f"the int8 classifier ({name}) fails its gates")
            if layer_calls:
                (x, layer, s, heads), kw = layer_calls[0]
                k9_branch_check(ph, branch, "block_int8", x, layer, s, heads, **kw)
            del layer_calls
    finally:
        bk._FUSE = "halves"
    return launches, ph.results


def masked_kernel_phase(params, cfg, dev, ids, rows_v, blocks_v, quant_v):
    """Phase 12a: each new kernel and branch against its plain version at
    the paths' shapes: on layer 0's input rows of the int8 text tower (512
    prompts x 77 tokens, f32) the LN + affine + row quant, the causal
    masked attention (f32 context; SDPA ``is_causal`` as the yardstick)
    and the f32 residual epilogues; on the unfolded vision tower's input
    rows (``rows_v``, 8192 crops x 50) the bf16 LN + affine + row quant,
    K3's attention with the score scale and K5's with the last layer's
    weights; the composed halves against ``plain_halves`` -> results."""
    import torch
    import torch.nn.functional as F

    from jcf_tpu_torch.models.clip import tree_to
    from jcf_tpu_torch.ops import block_kernel as bk
    from jcf_tpu_torch.ops import int8_gemm as ig
    from jcf_tpu_torch.ops.layers import layer_slice
    from jcf_tpu_torch.ops.quant import quantize_clip_params

    ph = Phase()
    text = tree_to(params["text"], dev)
    quant_t = quantize_clip_params({"text": text})["text"]
    b, st = ids.shape
    th, et = cfg.text_heads, cfg.text_width
    dt_ = et // th
    x = (text["token_embedding"][ids] + text["positional_embedding"]).reshape(b * st, -1)
    m = x.shape[0]
    log(f"phase 12a: masked and unfolded kernel checks, text {b} x {st} rows, vision "
        f"{rows_v.shape[0]} rows")
    ln1 = bk._layer_ln(text["blocks"], 0, "ln_1", torch.float32)
    ln2 = bk._layer_ln(text["blocks"], 0, "ln_2", torch.float32)
    layer = layer_slice(quant_t, 0)
    wq, wo, fc, pr = (layer["attn"]["w_qkv"], layer["attn"]["w_out"], layer["mlp"]["c_fc"],
                      layer["mlp"]["c_proj"])
    x_q, x_sc = ph.run("ln_affine_quant_rows_f32",
                       lambda: bk.ln_affine_quant_rows(x, ln1["scale"], ln1["bias"]),
                       lambda: bk.ln_affine_quant_rows_plain(x, ln1["scale"], ln1["bias"]),
                       check_rows, bound(nbytes(x, ln1["scale"], ln1["bias"]) + m * et + 4 * m,
                                         0.0, PEAK_INT8))
    qkv = ig.int8_gemm_bf16(x_q, wq.w_int8, wq.w_scale, wq.bias, row_scale=x_sc)
    kw = dict(causal=True, scale=1.0 / dt_ ** 0.5, f32_ctx=True)
    slack = 2.0**-7 * bk.masked_attention_plain(abs_v(qkv, et), st, th, **kw)
    q, k, v = head_views(qkv, st, th)
    ctx = ph.run("masked_attention_f32",
                 lambda: bk.masked_attention(qkv, st, th, **kw),
                 lambda: bk.masked_attention_plain(qkv, st, th, **kw), check_ctx_f32(slack),
                 # keys j <= i: s (s + 1) / 2 score and PV pairs per head
                 bound(nbytes(qkv) + 4 * m * et, 4.0 * b * th * (st * (st + 1) // 2) * dt_,
                       PEAK_BF16),
                 lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    # the static (int8) context: the calibrated scale 127 / amax of this context
    ctx_inv = (127.0 / ctx.abs().amax()).reshape(1, 1)
    kw8 = dict(causal=True, scale=1.0 / dt_ ** 0.5, ctx_inv=ctx_inv)
    ph.run("masked_attention",
           lambda: bk.masked_attention(qkv, st, th, **kw8),
           lambda: bk.masked_attention_plain(qkv, st, th, **kw8),
           lambda n, a, b_: check_int8(n, a, b_, 1e-2),
           bound(nbytes(qkv) + m * et, 4.0 * b * th * (st * (st + 1) // 2) * dt_, PEAK_BF16),
           lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    before = dict(bk.LAUNCHES)
    bk.masked_attention(qkv, st, th, **kw)
    bk.masked_attention(qkv, st, th, **kw8)
    torch.cuda.synchronize()
    check_routes("phase 12a, one call each", {k: bk.LAUNCHES[k] - before[k] for k in before},
                 {"masked_attention_f32": "mma", "masked_attention": "mma"})
    del q, k, v, slack
    c_q, c_sc = bk.quant_rows(ctx)
    mid = ph.run("int8_gemm_residual_f32_rows (out-proj)",
                 lambda: ig.int8_gemm_residual(c_q, wo.w_int8, wo.w_scale, wo.bias, x, row_scale=c_sc),
                 lambda: ig.int8_gemm_residual_plain(c_q, wo.w_int8, wo.w_scale, wo.bias, x, c_sc),
                 check_f32, gemm_work(c_q, wo.w_int8, 4, PEAK_INT8, x, wo.w_scale, wo.bias, c_sc),
                 lambda: torch._int_mm(c_q, wo.w_int8.T))
    m_q, m_sc = bk.ln_affine_quant_rows(mid, ln2["scale"], ln2["bias"])
    h_q, h_sc = bk.quant_rows(ig.int8_gemm_f32(m_q, fc.w_int8, fc.w_scale, fc.bias, row_scale=m_sc),
                              gelu=True)
    ph.run("int8_gemm_residual_f32_rows",
           lambda: ig.int8_gemm_residual(h_q, pr.w_int8, pr.w_scale, pr.bias, mid, row_scale=h_sc),
           lambda: ig.int8_gemm_residual_plain(h_q, pr.w_int8, pr.w_scale, pr.bias, mid, h_sc),
           check_f32, gemm_work(h_q, pr.w_int8, 4, PEAK_INT8, mid, pr.w_scale, pr.bias, h_sc),
           lambda: torch._int_mm(h_q, pr.w_int8.T))
    xb = x.bfloat16()
    lnb = [bk._layer_ln(text["blocks"], 0, n, torch.bfloat16) for n in ("ln_1", "ln_2")]
    for name, kern, inp in (
            ("K3 masked attention half (f32, unfolded)",
             lambda t: bk.attn_half_int8(t, layer["attn"], st, th, ln=ln1, causal=True), x),
            ("K4 MLP half (f32, unfolded)", lambda t: bk.mlp_half_int8(t, layer["mlp"], ln=ln2), mid),
            ("K3 masked attention half (bf16, unfolded)",
             lambda t: bk.attn_half_int8(t, layer["attn"], st, th, ln=lnb[0], causal=True), xb)):
        plain = plain_version(kern)
        check_composed(name, kern(inp), plain(inp), lambda: kern(inp), lambda: plain(inp))
    del x, xb, mid, qkv, ctx, c_q, h_q, text, quant_t
    torch.cuda.empty_cache()

    # the unfolded vision tower's layer 0 (K3) and last layer (K5)
    s, heads, e = cfg.vision_seq_len, cfg.vision_heads, cfg.vision_width
    d = e // heads
    n_crops = rows_v.shape[0] // s
    mv = rows_v.shape[0]
    sc = 1.0 / d ** 0.5
    lv = bk._layer_ln(blocks_v, 0, "ln_1", torch.bfloat16)
    lyr = layer_slice(quant_v, 0)
    x_q, x_sc = ph.run("ln_affine_quant_rows",
                       lambda: bk.ln_affine_quant_rows(rows_v, lv["scale"], lv["bias"]),
                       lambda: bk.ln_affine_quant_rows_plain(rows_v, lv["scale"], lv["bias"]),
                       check_rows, bound(nbytes(rows_v, lv["scale"], lv["bias"]) + mv * e + 4 * mv,
                                         0.0, PEAK_INT8))
    wq = lyr["attn"]["w_qkv"]
    qkv = ig.int8_gemm_bf16(x_q, wq.w_int8, wq.w_scale, wq.bias, row_scale=x_sc)
    slack = 2.0**-7 * bk.attention_plain(abs_v(qkv, e), None, s, heads, scale=sc)
    q, k, v = head_views(qkv, s, heads)
    ph.run("attention_scaled_f32",
           lambda: bk.attention(qkv, None, s, heads, scale=sc),
           lambda: bk.attention_plain(qkv, None, s, heads, scale=sc), check_ctx_f32(slack),
           bound(nbytes(qkv) + 4 * mv * e, 4.0 * n_crops * heads * s * s * d, PEAK_BF16),
           lambda: F.scaled_dot_product_attention(q, k, v))
    del q, k, v, qkv, slack, x_q, x_sc
    last_i = cfg.vision_layers - 1
    last = layer_slice(quant_v, last_i)["attn"]
    ll = bk._layer_ln(blocks_v, last_i, "ln_1", torch.bfloat16)
    lw = last["w_qkv"]
    lx_q, lx_sc = bk.ln_affine_quant_rows(rows_v, ll["scale"], ll["bias"])
    kv = ig.int8_gemm_bf16(lx_q, lw.w_int8[e:], lw.w_scale[e:], lw.bias[e:], row_scale=lx_sc)
    qc = ig.int8_gemm_bf16(lx_q[::s].contiguous(), lw.w_int8[:e], lw.w_scale[:e], lw.bias[:e],
                           row_scale=lx_sc[::s].contiguous())
    slack = 2.0**-7 * bk.cls_attention_plain(qc, abs_v(kv, e), None, s, heads, scale=sc)
    qh = qc.view(n_crops, 1, heads, d).transpose(1, 2)
    kvh = kv.view(n_crops, s, 2, heads, d)
    ph.run("cls_attention_scaled_f32",
           lambda: bk.cls_attention(qc, kv, None, s, heads, scale=sc),
           lambda: bk.cls_attention_plain(qc, kv, None, s, heads, scale=sc), check_ctx_f32(slack),
           bound(nbytes(qc, kv) + 4 * n_crops * e, 4.0 * n_crops * heads * s * d, PEAK_BF16),
           lambda: F.scaled_dot_product_attention(qh, kvh[:, :, 0].transpose(1, 2),
                                                  kvh[:, :, 1].transpose(1, 2)))
    del kv, qc, qh, kvh, lx_q, lx_sc, slack
    lns = [bk._layer_ln(blocks_v, 0, n, torch.bfloat16) for n in ("ln_1", "ln_2")]
    mid = bk.attn_half_int8(rows_v, lyr["attn"], s, heads, ln=lns[0])
    for name, kern, inp in (
            ("K3 attention half (unfolded)",
             lambda t: bk.attn_half_int8(t, lyr["attn"], s, heads, ln=lns[0]), rows_v),
            ("K4 MLP half (unfolded)", lambda t: bk.mlp_half_int8(t, lyr["mlp"], ln=lns[1]), mid),
            ("K5 CLS attention half (unfolded)",
             lambda t: bk.attn_cls_int8(t, last, s, heads, ln=ll), rows_v)):
        plain = plain_version(kern)
        check_composed(name, kern(inp), plain(inp), lambda: kern(inp), lambda: plain(inp))
    del mid
    torch.cuda.empty_cache()
    return ph.results


def unfolded_tower_phase(cfg, counters, smi, rows_v, blocks_v, quant_v):
    """Phase 12c: the unfolded int8 ViT-B/32 tower at 8192 crops, counted
    on all rows and on the CLS rows (K5, then K4 with the f32 LN affine
    of the layer params), against its plain route (row cos >= 0.999) and,
    as ``bench.py``'s kernel smoke, against the bf16 float tower (mean row
    cos > 0.995); ms per tower -> launches."""
    import torch

    from jcf_tpu_torch.ops import block_kernel as bk

    s, heads = cfg.vision_seq_len, cfg.vision_heads
    log(f"phase 12c: the unfolded int8 tower, {rows_v.shape[0] // s} crops x {s} tokens")
    tower = lambda cls_only: bk.run_fused_tower(rows_v, quant_v, heads, flat_s=s, cls_only=cls_only,
                                                blocks=blocks_v)
    out, launches = count_forward(counters, lambda: tower(False))
    cls, launches_cls = count_forward(counters, lambda: tower(True))
    log(f"  launches, all rows: {launches}; CLS rows: {launches_cls}")
    for k, v in launches_cls.items():
        launches[k] = launches.get(k, 0) + v
    if launches_cls.get("cls_attention_scaled_f32") != 1 or launches.get("attention_scaled_f32") != 2 * cfg.vision_layers - 1:
        raise AssertionError("the unfolded tower did not take K3 / K5 with the score scale")
    check_routes("phase 12c", launches, {"attention_scaled_f32": "mma"})
    with plain_halves():
        ref = tower(False)
        ref_cls = tower(True)
    cos = cosine_rows(out, ref)
    cos_c = cosine_rows(cls, ref_cls)
    del ref, ref_cls
    flt = bk.run_float_tower(rows_v, blocks_v, heads, s=s, causal=False)
    cos_f = cosine_rows(out, flt)
    del flt
    log(f"  vs its plain route: all rows min cos {float(cos.min()):.6f}, CLS rows "
        f"{float(cos_c.min()):.6f} (gate >= 0.999); vs the bf16 float tower mean row cos "
        f"{float(cos_f.mean()):.6f}, min {float(cos_f.min()):.6f} (gate: mean > 0.995)")
    if float(cos.min()) < 0.999 or float(cos_c.min()) < 0.999 or float(cos_f.mean()) <= 0.995:
        raise AssertionError("the unfolded int8 tower fails its gates")
    del out, cls
    torch.cuda.empty_cache()
    ms = time_ms(lambda: tower(False), reps=2)
    ms_c = time_ms(lambda: tower(True), reps=2)
    log(f"  unfolded tower: {ms:.3f} ms all rows, {ms_c:.3f} ms to the CLS rows "
        f"({cfg.vision_layers} layers) on {smi}")
    return launches


def small_towers_phase(dev, counters):
    """Phase 12d: an odd-head tower (3 heads of 64, 50 tokens: the masked
    route without a mask) and a 64-token tower (2 heads: the non-dense
    mask-free route, no pair-shift floor), 12 layers, the unfolded int8
    tree and the bf16 float tower, at 1024 crops, counted, against their
    plain routes (row cos >= 0.999); the float towers' per-head attention
    against its plain version on layer 0's qkv -> (the 3-head bf16
    tower's launches, results)."""
    import torch
    import torch.nn.functional as F

    from jcf_tpu_torch.models.clip import CLIPConfig, init_clip_params, tree_to
    from jcf_tpu_torch.ops import block_kernel as bk
    from jcf_tpu_torch.ops.layers import layer_slice
    from jcf_tpu_torch.ops.quant import quantize_clip_params

    ph = Phase()
    launches_odd = None
    for width, s, attn in ((192, 50, "masked_attention_f32"), (128, 64, "attention_scaled_f32")):
        heads = width // 64
        params = init_clip_params(0, CLIPConfig(vision_width=width, text_layers=1))
        blocks = tree_to(params["visual"]["blocks"], dev, torch.bfloat16)
        quant = quantize_clip_params({"visual": tree_to(params["visual"], dev)})["visual"]
        x = torch.randn(SMALL_CROPS * s, width, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(s)).bfloat16()
        for kind, run in (
                ("int8", lambda: bk.run_fused_tower(x, quant, heads, flat_s=s, cls_only=False,
                                                    blocks=blocks)),
                ("bf16", lambda: bk.run_float_tower(x, blocks, heads, s=s, causal=False))):
            out, launches = count_forward(counters, run)
            with (plain_halves() if kind == "int8" else plain_float()):
                ref = run()
            cos = float(cosine_rows(out, ref).min())
            log(f"phase 12d: {heads} heads x {s} tokens, {kind}, {SMALL_CROPS} crops: launches "
                f"{launches}; vs plain min row cos {cos:.6f} (gate >= 0.999)")
            want = attn if kind == "int8" else ("head_attention" if heads % 2 else "pair_attention_bf16")
            if launches.get(want) != 12 or cos < 0.999:
                raise AssertionError(f"the {heads}-head {s}-token {kind} tower fails")
            if heads % 2 or kind == "int8":
                check_routes(f"phase 12d, {heads} heads, {kind}", launches, {want: "mma"})
            if kind == "bf16" and heads % 2:
                launches_odd = launches
        if heads % 2:
            # the per-head attention of the float halves on layer 0's qkv
            layer = layer_slice(blocks, 0)
            h = bk.ln_affine(x, layer["ln_1"]["scale"], layer["ln_1"]["bias"])
            qkv = bk.bf16_gemm_bias(h, layer["attn"]["w_qkv"], layer["attn"]["b_qkv"].float())
            kw = dict(causal=False, scale=1.0 / 8.0)
            slack = 2.0**-7 * bk.masked_attention_plain(abs_v(qkv, width), s, heads, **kw).float()
            q, k, v = head_views(qkv, s, heads)
            ph.run("head_attention",
                   lambda: bk.masked_attention(qkv, s, heads, **kw),
                   lambda: bk.masked_attention_plain(qkv, s, heads, **kw),
                   lambda n, a, b: check_bf16(n, a, b, slack),
                   bound(nbytes(qkv) + nbytes(x), 4.0 * SMALL_CROPS * heads * s * s * 64, PEAK_BF16),
                   lambda: F.scaled_dot_product_attention(q, k, v))
            # the same rows in f32: the register-tiled kernel (an odd-head
            # f32 tower's attention)
            q32 = qkv.float()
            q, k, v = head_views(q32, s, heads)
            ph.run("head_attention_f32",
                   lambda: bk.masked_attention(q32, s, heads, **kw),
                   lambda: bk.masked_attention_plain(q32, s, heads, **kw),
                   check_f32,
                   bound(nbytes(q32) + q32.shape[0] * width * 4,
                         4.0 * SMALL_CROPS * heads * s * s * 64, PEAK_F32),
                   lambda: F.scaled_dot_product_attention(q, k, v))
            del q, k, v, qkv, q32, h, slack
    torch.cuda.empty_cache()
    return launches_odd, ph.results


# phase 13: jcf-ood end to end (the CLI, the TestSetB walk, the JPEG
# decode, the PIL-exact crops, the loader, run_ood_split on both paths)
OOD_IMAGES = 16  # the parity path's images: the fixtures repeated, 2 batches of 8
OOD_PERF_IMAGES = 1024  # the throughput path's images: 8 batches of 128
FIXTURE_DIR = os.path.join(ROOT, "tests", "fixtures", "jpeg")
# PIL's decode of every committed JPEG at every scale its draft reaches
# (tests/fixtures/make_jpeg_hashes.py): the card's references
HASHES = os.path.join(FIXTURE_DIR, "libjpeg_sha256.json")
# the class list's rotation: seed-0 weights send the fixtures to the names
# 270, 255 and 9 (measured on one H100); rotated by 260 these sit at ids 10,
# 398 and 152, on both sides of the base/new boundary at 372
OOD_ROTATE = 260
PERF_DECODE_BATCH = 128  # images a decode_batch call on --perf (tta.batch_images)
# integer operations of the decoder kernels, counted from their source (the
# IDCT: the two passes' products, sums, shifts and wraps, the dequantization
# and the output clamp of one block; the upsampler: a sample's arithmetic by
# its plane's method, none for box replication, 3 near + far + bias >> 2 for
# h2v1 and h1v2, the two column sums and their blend for h2v2, and a
# YCbCr pixel's conversion: two offsets, three products, sums, shifts and
# clamps), against the card's 32-bit integer rate: one operation a CUDA
# core a clock, half the f32 peak (which counts an FMA as two)
IDCT_OPS = {8: 1300, 4: 560, 2: 200, 1: 8}
UPSAMPLE_OPS = {0: 0, 1: 4, 2: 4, 3: 8}
YCC_OPS = 22
PEAK_INT32 = PEAK_F32 / 2


def fixture_paths():
    return sorted(os.path.join(FIXTURE_DIR, f) for f in os.listdir(FIXTURE_DIR) if f.endswith(".jpg"))


def decoder_launches(paths, batch: int | None = None) -> dict:
    """The decoder's launches for the JPEGs ``paths``: one IDCT and one
    upsample + color a decode call (each image's ``decode_coefficients``,
    or with ``batch`` each ``decode_batch`` of that many images, which
    also makes one resize + crop launch)."""
    if batch is None:
        return {"jpeg_idct": len(paths), "jpeg_upsample_color": len(paths)}
    calls = -(-len(paths) // batch)
    return {"jpeg_idct": calls, "jpeg_upsample_color": calls, "resize_crop": calls}


def ood_image_paths(n_images: int) -> list:
    """The files ``ood_dataset`` copies, in its order."""
    fx = fixture_paths()
    return [fx[i % len(fx)] for i in range(n_images)]


def rgb_digest(img) -> tuple:
    """(shape, SHA-256) of a decode as PIL's ``convert("RGB")`` gives it."""
    import hashlib

    x = img.cpu().numpy()
    if x.shape[2] == 1:
        x = np.repeat(x, 3, axis=2)
    return list(x.shape), hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()


def check_equal(name, got, ref):
    """Integer outputs that must be equal bit for bit."""
    import torch

    same = got.shape == ref.shape and bool(torch.equal(got, ref))
    log(f"  {name}: {'equal to' if same else 'DIFFERS FROM'} its plain version bit for bit")
    if not same:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return 0.0


def check_idct_batch(label: str, images, dev) -> None:
    """``idct_batch`` of ``images`` on the card (``stage``'s one copy, one
    ``jpeg_idct`` launch) against ``idct_plain`` of each component, bit for
    bit."""
    import torch

    from jcf_tpu_torch.data import jpeg

    before = jpeg.LAUNCHES["jpeg_idct"]
    layout = jpeg.idct_layout(images)
    got = layout.views(layout.run(jpeg.stage(dev, layout.tables(images))))
    launched = jpeg.LAUNCHES["jpeg_idct"] - before
    comps = sizes = 0
    same = launched == 1
    for (coef, geo), planes in zip(images, got):
        for c, p, plane in zip(coef.components, geo, planes):
            want = jpeg.idct_plain(c.coefs.to(dev), c.quant.to(dev), p.size)
            same = same and torch.equal(plane, want)
            comps, sizes = comps + 1, sizes | (1 << p.size)
    log(f"  jpeg_idct on {label}: {len(images)} images, {comps} components, sizes "
        f"{sorted(k for k in jpeg.SCALES if sizes >> k & 1)} in {launched} launch(es): "
        f"{'equal to' if same else 'DIFFERS FROM'} idct_plain per component bit for bit")
    if not same:
        raise AssertionError(f"jpeg_idct on {label}: not one launch equal to its plain version")


def check_decode_plan(label: str, images, dev) -> None:
    """A ``DecodePlan`` of ``images`` on the card (one IDCT and one
    upsample launch) against the same plan on the CPU (their plain
    versions), every output bit for bit."""
    import torch

    from jcf_tpu_torch.data import jpeg

    before = dict(jpeg.LAUNCHES)
    plan = jpeg.DecodePlan(images, dev)
    got = plan.run(jpeg.stage(dev, plan.tables()))
    launched = {k: v - before[k] for k, v in jpeg.LAUNCHES.items() if v != before[k]}
    ref = jpeg.DecodePlan(images, "cpu")
    want = ref.run(jpeg.stage("cpu", ref.tables()))
    same = launched == {"jpeg_idct": 1, "jpeg_upsample_color": 1} and all(
        torch.equal(g.cpu(), w) for g, w in zip(got, want))
    log(f"  jpeg_upsample_color on {label}: {len(images)} images, {plan.up.ctas} CTAs, launches "
        f"{launched}: {'equal to' if same else 'DIFFERS FROM'} upsample_color_batch_plain bit for "
        f"bit")
    if not same:
        raise AssertionError(f"jpeg_upsample_color on {label}: not one launch equal to its plain "
                             f"version")


def check_upsample_batch(label: str, planes, images, dev) -> None:
    """``upsample_color_batch`` of ``images`` (``upsample_layout``'s form)
    on the packed ``planes``, one launch, against its plain version bit for
    bit (the outputs; the padding between them is not written)."""
    import torch

    from jcf_tpu_torch.data import jpeg

    layout = jpeg.upsample_layout(images)
    desc = torch.from_numpy(layout.desc)
    before = jpeg.LAUNCHES["jpeg_upsample_color"]
    got = jpeg.upsample_color_batch(planes.to(dev), desc.to(dev), layout).cpu()
    launched = jpeg.LAUNCHES["jpeg_upsample_color"] - before
    want = jpeg.upsample_color_batch_plain(planes, desc, layout.out_bytes)
    same = launched == 1 and all(torch.equal(g, w) for g, w in zip(layout.views(got),
                                                                   layout.views(want)))
    tiles = sorted({tuple(t) for t in layout.desc[:, 6:8].tolist()})
    log(f"  jpeg_upsample_color on {label}: {layout.ctas} CTAs (tiles rows x cols "
        f"{tiles[:3]}{' ...' if len(tiles) > 3 else ''}) in {launched} launch(es): "
        f"{'equal to' if same else 'DIFFERS FROM'} upsample_color_batch_plain bit for bit")
    if not same:
        raise AssertionError(f"jpeg_upsample_color on {label}: not one launch equal to its plain "
                             f"version")


def upsample_work(plan) -> dict:
    """The batched upsample's bound: each plane sample read once, each
    output byte written once; each output sample's arithmetic by its
    plane's method, and a YCbCr pixel's conversion, at the int32 rate."""
    planes = sum(p.width * p.height for _, geo, _, _ in plan.images for p in geo)
    outputs = sum(h * w * n for _, h, w, n in plan.up.outputs)
    ops = sum(out_w * out_h * (sum(UPSAMPLE_OPS[p.method] for p in geo)
                               + (YCC_OPS if coef.ycc and len(geo) == 3 else 0))
              for coef, geo, out_w, out_h in plan.images)
    return bound(planes + outputs, float(ops), PEAK_INT32)


def resize_work(sources, resize_to: int, out: int) -> dict:
    """The batched resize's bound: each source byte that the crop's
    windows reach read once (the rows and columns of nonzero weight, as
    ``resize_crop_plain`` slices them), each output byte written once; the
    two passes' f32 FMAs on the taps of nonzero weight (the horizontal pass
    on the source rows the crop's windows reach), two flops each, on each
    of the source's channels (a grayscale source's one channel is the
    output's three)."""
    from jcf_tpu_torch.data import decode as dec

    n_bytes, flops = len(sources) * out * out * 3, 0.0
    for img in sources:
        sh, sw, ch = img.shape
        rw, rh, left, top = dec._geometry(sw, sh, resize_to, out)
        wx = dec._triangle_weights(sw, rw, left, out)
        wy = dec._triangle_weights(sh, rh, top, out)
        cols, rows = np.nonzero(wx.any(axis=0))[0], np.nonzero(wy.any(axis=0))[0]
        n_bytes += (int(rows[-1]) + 1 - int(rows[0])) * (int(cols[-1]) + 1 - int(cols[0])) * ch
        flops += 2.0 * ch * (len(rows) * np.count_nonzero(wx) + out * np.count_nonzero(wy))
    return bound(n_bytes, flops, PEAK_F32)


def idct_batch_work(layout) -> dict:
    """The batched IDCT's bound: 128 bytes of coefficients read, S^2
    samples written a block, the tables and descriptors read once; its
    integer operations at the int32 rate."""
    d = layout.desc
    blocks = d[:, 2] * d[:, 3]
    n_bytes = int(blocks.sum()) * 128 + len(d) * (256 + 64) + int((blocks * d[:, 4] ** 2).sum())
    ops = float(sum(IDCT_OPS[int(size)] * int(n) for size, n in zip(d[:, 4], blocks)))
    return bound(n_bytes, ops, PEAK_INT32)


def decode_phase(dev, smi) -> dict:
    """13a: every committed JPEG (the six fixtures and the four small
    ones under ``extra/``) decoded on the card at every scale PIL's draft
    reaches, each decode's SHA-256 against PIL's, both decoder kernels
    against their plain versions bit for bit (and the IDCT on random
    coefficients past 16 bits), ``decode_batch`` against the committed
    ``jcf_tpu.native`` references, decoding under load in a second thread,
    decode img/s -> the decoder kernels' results at the largest fixture's
    full-size decode."""
    import torch

    from jcf_tpu_torch import _build
    from jcf_tpu_torch.data import decode as dec
    from jcf_tpu_torch.data import jpeg

    log("phase 13a: JPEG decode on the card (host Huffman decoding, then the IDCT and the "
        "upsample + color kernels), bit for bit libjpeg-turbo's")
    t0 = time.perf_counter()
    _build.load_entropy()
    log(f"  entropy decoder built with g++ and loaded in {time.perf_counter() - t0:.2f} s")
    with open(HASHES) as f:
        refs = json.load(f)
    n_ok = n_all = 0
    for rel, scales in sorted(refs["images"].items()):
        with open(os.path.join(FIXTURE_DIR, rel), "rb") as f:
            data = f.read()
        coef = jpeg.read_coefficients(data, rel)
        cq = [(c.coefs.to(dev), c.quant.to(dev)) for c in coef.components]
        line = []
        for scale, ref in sorted(scales.items(), key=lambda kv: int(kv[0])):
            out_w, out_h, geo = jpeg.geometry(coef, int(scale), rel)
            before = dict(jpeg.LAUNCHES)
            img = jpeg.decode_jpeg(data, dev, scale_denom=int(scale), name=rel)
            launched = {k: v - before[k] for k, v in jpeg.LAUNCHES.items() if v != before[k]}
            planes_p = [jpeg.idct_plain(c, q, p.size) for (c, q), p in zip(cq, geo)]
            img_p = jpeg.upsample_color_plain(planes_p, geo, out_w, out_h, coef.ycc)
            kernels_equal = (launched == {"jpeg_idct": 1, "jpeg_upsample_color": 1}
                             and torch.equal(img, img_p))
            ok = kernels_equal and rgb_digest(img) == (ref["shape"], ref["sha256"])
            n_all, n_ok = n_all + 1, n_ok + ok
            line.append(f"1/{scale} {'ok' if ok else 'MISMATCH'}")
        sub = "x".join(f"{c.h}{c.v}" for c in coef.components)
        log(f"  {rel} ({coef.width}x{coef.height}, sampling {sub}"
            f"{', progressive' if coef.progressive else ''}): {', '.join(line)}")
    log(f"  {n_ok} of {n_all} decodes hash to PIL's (Pillow {refs['pillow']}, libjpeg-turbo "
        f"{refs['libjpeg_turbo']}), each one IDCT and one upsample launch equal to the plain "
        f"versions' decode")
    if n_ok != n_all:
        raise AssertionError("a decode on the card differs from PIL's or a kernel from its plain "
                             "version")
    # one launch over every committed JPEG at every scale (mixed sizes in
    # one table), then over random coefficients past 16 bits
    imgs = []
    for rel in sorted(refs["images"]):
        with open(os.path.join(FIXTURE_DIR, rel), "rb") as f:
            coef = jpeg.read_coefficients(f.read(), rel)
        for d in jpeg.SCALES:
            out_w, out_h, geo = jpeg.geometry(coef, d, rel)
            imgs.append((coef, geo, out_w, out_h))
    check_idct_batch("the committed JPEGs at scales 1, 2, 4 and 8",
                     [(coef, geo) for coef, geo, _, _ in imgs], dev)
    check_idct_batch("random coefficients (|c| <= 2047, tables up to 65535: 16-bit wraps and "
                     "saturation)", jpeg.random_idct_images(np.random.default_rng(0), 24), dev)
    # one upsample launch over every committed JPEG at every scale (gray
    # among color), then over random planes: every method, planes of 1 to
    # 3 samples a side at unaligned offsets and strides, and rows too wide
    # for one CTA's shared memory
    check_decode_plan("the committed JPEGs at scales 1, 2, 4 and 8", imgs, dev)
    for label, (planes, color) in (
            ("40 random images of planes", jpeg.random_color_images(np.random.default_rng(0), 40)),
            ("12 random images up to 300 a side",
             jpeg.random_color_images(np.random.default_rng(1), 12, max_out=300)),
            ("3 random images of rows too wide for a CTA, and a tall one",
             jpeg.random_color_images(np.random.default_rng(2), 4, sizes=[
                 (14001, 3), (9000, 2), (2, 2500), (5, 4)]))):
        check_upsample_batch(label, planes, color, dev)

    # decode_batch (libjpeg's reduced scale from a 512 short side, then the
    # resize kernel) against jcf_tpu.native's committed output
    npz = np.load(os.path.join(FIXTURE_DIR, "native_minus_pil.npz"))
    worst = [0, 0.0]
    for name, delta in zip(npz["names"], npz["delta"]):
        name = str(name)
        with open(os.path.join(FIXTURE_DIR, "pil_256", name[:-4] + ".png"), "rb") as f:
            native = dec.decode_png(f.read()).astype(np.int16) + delta
        got = dec.decode_batch([os.path.join(FIXTURE_DIR, name)], device=dev, uint8=True)
        d = np.abs(got[0].cpu().numpy().astype(np.int16) - native)
        worst = [max(worst[0], int(d.max())), max(worst[1], float((d > 0).mean()))]
    log(f"  decode_batch vs jcf_tpu.native's committed output: max {worst[0]} level, "
        f"{worst[1]:.2e} of the values differ (bars: 1 level, 1e-3: the resize's f32 sums)")
    if worst[0] > 1 or worst[1] > 1e-3:
        raise AssertionError("decode_batch off jcf_tpu.native's output")

    # decoding in a second thread while this one keeps the card busy (as
    # the --perf loop does): every image as decoded alone
    paths = fixture_paths() * 22
    ref = []
    for p in paths:
        ref.append(dec.decode_batch([p], device=dev, uint8=True)[0])
        torch.cuda.synchronize()
    got = []
    worker = threading.Thread(target=lambda: got.append(dec.decode_batch(paths, device=dev,
                                                                         uint8=True)))
    a = torch.randn(4096, 4096, device=dev)
    worker.start()
    for _ in range(300):
        a = (a @ a) * 1e-4
    worker.join()
    torch.cuda.synchronize()
    bad = sum(not torch.equal(g, r) for g, r in zip(got[0], ref))
    log(f"  decode_batch of {len(paths)} images in a second thread under load: {bad} differ from "
        f"their decode alone (must be 0)")
    if bad:
        raise AssertionError("images decoded under load differ from their decode alone")
    del a, ref, got

    paths = fixture_paths() * 20
    rates = {}
    for label, run in (("decode_file (full size)", lambda: [dec.decode_file(p, dev) for p in paths]),
                       ("decode_batch (native scale + resize to 256²)",
                        lambda: dec.decode_batch(paths, device=dev))):
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        rates[label] = len(paths) / (time.perf_counter() - t0)
        log(f"  {label}: {rates[label]:.2f} img/s (the 6 fixtures x 20, one thread) on {smi}")
    for label, run, want in (
            ("decode_file", lambda: [dec.decode_file(p, dev) for p in paths],
             decoder_launches(paths)),
            ("decode_batch", lambda: dec.decode_batch(paths, device=dev),
             decoder_launches(paths, batch=len(paths)))):
        before = dict(jpeg.LAUNCHES)
        run()
        torch.cuda.synchronize()
        got = {k: v - before[k] for k, v in jpeg.LAUNCHES.items() if v != before[k]}
        log(f"  {label} of {len(paths)} images: launches {got} (one IDCT a decode call)")
        if got != want:
            raise AssertionError(f"{label}: expected the launches {want}")

    # the three kernels at a --perf decode_batch's shapes (128 images at
    # libjpeg's scale for a 256 short side, one launch each, on inputs
    # already on the card), eager (the JSON's ms) and in a CUDA graph
    import torch.nn.functional as F

    ph = Phase()
    images = []
    for p in ood_image_paths(PERF_DECODE_BATCH):
        with open(p, "rb") as f:
            coef = jpeg.read_coefficients(f.read(), p)
        out_w, out_h, geo = jpeg.geometry(coef, dec.native_scale(coef.width, coef.height, 256), p)
        images.append((coef, geo, out_w, out_h))
    plan = jpeg.DecodePlan(images, dev)
    layout = plan.idct
    coefs_d, quant_d, desc_d, up_d = jpeg.stage(dev, plan.tables())
    coefs_d, quant_d = coefs_d.view(-1, 64), quant_d.view(-1, 64)
    desc_d, up_d = desc_d.view(-1, len(jpeg.DESC_FIELDS)), up_d.view(-1, len(jpeg.UP_FIELDS))

    def planes_of(out):
        return torch.cat([out[o:o + h * w] for mine in layout.planes for o, h, w in mine])

    def outputs_of(out):
        return torch.cat([v.reshape(-1) for v in plan.up.views(out)])

    def check_resize(name, got, ref):
        d = (got.int() - ref.int()).abs()
        frac = float((d > 0).float().mean())
        log(f"  {name}: max |diff| {int(d.max())}, differing {frac:.2e} (tol: 1 level on <= 1e-3, "
            f"the f32 sums in another order)")
        if int(d.max()) > 1 or frac > 1e-3:
            raise AssertionError(f"{name}: kernel disagrees with its plain version")
        return float(d.max())

    log(f"  jpeg_idct at a --perf decode_batch: {len(images)} images, {len(layout.desc)} "
        f"components, {layout.blocks} blocks, {layout.ctas} CTAs, one launch")
    ph.run("jpeg_idct", lambda: jpeg.idct_batch(coefs_d, quant_d, desc_d, layout),
           lambda: jpeg.idct_batch_plain(coefs_d, quant_d, desc_d, layout.out_bytes),
           lambda n, g, r: check_equal(n, planes_of(g), planes_of(r)), idct_batch_work(layout))
    planes = jpeg.idct_batch(coefs_d, quant_d, desc_d, layout)
    log(f"  jpeg_upsample_color at a --perf decode_batch: {len(images)} images, {plan.up.ctas} "
        f"CTAs, one launch")
    ph.run("jpeg_upsample_color", lambda: jpeg.upsample_color_batch(planes, up_d, plan.up,
                                                                    plan.rgb),
           lambda: jpeg.upsample_color_batch_plain(planes, up_d, plan.up.out_bytes),
           lambda n, g, r: check_equal(n, outputs_of(g), outputs_of(r)), upsample_work(plan))
    pixels = plan.outputs()
    rs_layout = dec.resize_layout(pixels, 256, 256)
    rs_d = torch.from_numpy(rs_layout.desc).to(dev)
    # the yardstick: PyTorch's antialiased bilinear resize and the crop on
    # the largest source repeated (another filter: the product-alone
    # convention)
    big = max(pixels, key=lambda t: t.numel())
    sh, sw, _ = big.shape
    rw, rh, left, top = dec._geometry(sw, sh, 256, 256)
    x = big.permute(2, 0, 1).float()[None].expand(len(pixels), -1, -1, -1).contiguous()
    log(f"  resize_crop at a --perf decode_batch: {len(pixels)} images to 256², {rs_layout.ctas} "
        f"CTAs, one launch; library: F.interpolate(bilinear, antialias) + crop, {sw}x{sh} x "
        f"{len(pixels)}")
    ph.run("resize_crop", lambda: dec.resize_crop_batch(pixels, 256, 256, layout=rs_layout,
                                                        desc=rs_d),
           lambda: dec.resize_crop_batch_plain(pixels, 256, 256), check_resize,
           resize_work(pixels, 256, 256),
           library=lambda: F.interpolate(x, size=(rh, rw), mode="bilinear", antialias=True)[
               :, :, top:top + 256, left:left + 256])
    for name, fn in (("jpeg_idct", lambda: jpeg.idct_batch(coefs_d, quant_d, desc_d, layout)),
                     ("jpeg_upsample_color",
                      lambda: jpeg.upsample_color_batch(planes, up_d, plan.up, plan.rgb)),
                     ("resize_crop", lambda: dec.resize_crop_batch(pixels, 256, 256,
                                                                   layout=rs_layout, desc=rs_d))):
        r = ph.results[name]
        r["graph_ms"] = graph_ms(fn)
        log(f"  {name}, {len(images)} images: eager {r['ms']:.4f} ms, in a CUDA graph "
            f"{r['graph_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}): "
            f"{r['bound_ms'] / r['graph_ms']:.3f} of it in a graph, on {smi}")
    return ph.results


def crops_identical(dev, smi) -> None:
    """13a': the parity path's crops of the card's decode are the CPU's
    (whose decode is PIL's, ``tests/test_torch_jpeg_exact.py``): each
    fixture read at full size on the card and on the CPU (the plain
    versions), 64 seeded boxes each cropped PIL-exactly to 224²
    (``data.transforms.resample_boxes``): the 384 crops must be equal. With
    nvJPEG they were not: 2 of the 384 moved their top-1 under the f32
    engine."""
    import torch

    from jcf_tpu_torch.data import read_image
    from jcf_tpu_torch.data import transforms as tt

    rng = np.random.default_rng(0)
    n_boxes, equal, total = 64, 0, 0
    for path in fixture_paths():
        card, cpu = read_image(path, dev), read_image(path, "cpu")
        h, w = cpu.shape[:2]
        sizes = rng.integers(min(h, w) // 2, min(h, w) + 1, n_boxes)
        boxes = [(int(rng.integers(0, h - s + 1)), int(rng.integers(0, w - s + 1)), int(s),
                  int(s)) for s in sizes]
        a = tt.resample_boxes(card, boxes, (224, 224)).cpu()
        b = tt.resample_boxes(cpu, boxes, (224, 224))
        equal += int(sum(torch.equal(x, y) for x, y in zip(a, b)))
        total += len(boxes)
    log(f"phase 13a': {equal} of {total} seeded PIL-exact crops (6 fixtures x {n_boxes} boxes, "
        f"224², full-size decodes) equal between the card and the CPU on {smi}")
    if equal != total:
        raise AssertionError("the card's crops differ from the CPU's")


def ood_dataset(root: str, n_images: int) -> str:
    """A dataset directory: TestSetB holding the fixtures repeated to
    ``n_images`` files and a 403-line synthetic ``classes.txt``."""
    test = os.path.join(root, "TestSetB")
    os.makedirs(test)
    fx = fixture_paths()
    for i in range(n_images):
        src = fx[i % len(fx)]
        shutil.copy(src, os.path.join(test, f"{i:04d}_{os.path.basename(src)}"))
    synthetic_classes(os.path.join(root, "classes.txt"), OOD_ROTATE)
    return root


@contextlib.contextmanager
def first_calls(module, name: str, key, calls: dict):
    """Keeps the arguments of the first call of ``module.name`` per
    ``key(args)`` in ``calls`` for the block (the calls run unchanged)."""
    fn = getattr(module, name)

    def wrapper(*args):
        calls.setdefault(key(args), args)
        return fn(*args)

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def per_call_launches(counters, out: list, method: str = "features_from_images"):
    """Appends, per call of ``TTAEngine.<method>``, the launches it made on
    its thread (the decoder's, from the decode thread, left out) and (its
    modes, the classifier) to ``out`` for the block."""
    from jcf_tpu_torch.data import decode as dec
    from jcf_tpu_torch.infer.engine import TTAEngine

    fn = getattr(TTAEngine, method)

    def wrapper(self, images, text_weights, **kw):
        before = {k: v for c in counters for k, v in c.items()}
        modes = fn(self, images, text_weights, **kw)
        after = {k: v for c in counters for k, v in c.items()}
        out.append(({k: after[k] - before[k] for k in after
                     if after[k] != before[k] and k not in dec.LAUNCHES}, modes, text_weights))
        return modes

    setattr(TTAEngine, method, wrapper)
    try:
        yield
    finally:
        setattr(TTAEngine, method, fn)


@contextlib.contextmanager
def recorded_outputs(out: list):
    """Appends the per-view features [B, N, D] of each
    ``TTAEngine._view_features`` call to ``out`` for the block."""
    from jcf_tpu_torch.infer.engine import TTAEngine

    fn = TTAEngine._view_features

    def wrapper(self, *args):
        feats = fn(self, *args)
        out.append(feats)
        return feats

    TTAEngine._view_features = wrapper
    try:
        yield
    finally:
        TTAEngine._view_features = fn


def predictions(calls) -> "torch.Tensor":
    """The argmax classes of the recorded (launches, modes, classifier)."""
    import torch

    return torch.cat([torch.argmax(m.float() @ w.float().T, -1).cpu() for _, m, w in calls])


def prediction_counts(preds) -> str:
    ids, counts = preds.unique(return_counts=True)
    order = counts.argsort(descending=True)
    return ", ".join(f"{int(ids[i])}: {int(counts[i])}" for i in order[:8])


@contextlib.contextmanager
def plain_serving():
    """Every kernel of ``jcf-ood``'s two paths through its plain version
    for the block (the float halves and K1, the int8 halves, the int8
    patch GEMM, K2, the decoder's IDCT, upsample + color and resize):
    nothing launches."""
    from jcf_tpu_torch.data import decode as dec
    from jcf_tpu_torch.data import jpeg
    from jcf_tpu_torch.infer import engine as eng
    from jcf_tpu_torch.ops import assemble_kernel as ak
    from jcf_tpu_torch.ops import int8_gemm as ig

    swaps = [(eng, "int8_gemm_s32", ig.int8_matmul_plain),
             (eng, "assemble_dense_rows", ak.assemble_dense_rows_plain),
             (dec, "resize_crop_batch",
              lambda srcs, resize_to, out, **_: dec.resize_crop_batch_plain(srcs, resize_to, out)),
             (jpeg, "idct_batch",
              lambda c, q, d, layout: jpeg.idct_batch_plain(c, q, d, layout.out_bytes)),
             (jpeg, "upsample_color_batch",
              lambda p, d, layout, out: out.copy_(jpeg.upsample_color_batch_plain(
                  p, d, layout.out_bytes)))]
    saved = [(m, k, getattr(m, k)) for m, k, _ in swaps]
    with plain_float(), plain_halves():
        for m, k, fn in swaps:
            setattr(m, k, fn)
        try:
            yield
        finally:
            for m, k, fn in saved:
                setattr(m, k, fn)


def run_ood_cli(tmp: str, argv, counters, label: str, n_images: int, smi, dev="cuda",
                fresh_cache: bool = True):
    """``cli.ood.main(argv)`` from ``tmp`` (its templates and classifier
    cache live there; the cache emptied first unless ``fresh_cache`` is
    False), every launch count at 0 before -> (split files, launches,
    Timer summary, wall seconds)."""
    import torch

    from jcf_tpu_torch.cli import ood as cli
    from jcf_tpu_torch.utils import Timer

    if fresh_cache:
        shutil.rmtree(os.path.join(tmp, ".jcf_cache"), ignore_errors=True)
    cwd = os.getcwd()
    os.chdir(tmp)
    timer = Timer()
    try:
        torch.cuda.synchronize()
        for c in counters:
            c.update(dict.fromkeys(c, 0))
        t0 = time.perf_counter()
        out = cli.main([*argv, "--device", torch.device(dev).type], timer=timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for c in counters for k, v in c.items() if v}
    finally:
        os.chdir(cwd)
    files = tuple(open(out[k], "rb").read() for k in ("base_path", "new_path"))
    summ = timer.summary()
    wait, busy = summ["decode_wait"]["total_s"], summ["tta_batch"]["total_s"]
    if out["n_base"] + out["n_new"] != n_images or not out["n_base"] or not out["n_new"]:
        raise AssertionError(f"{label}: {out['n_base']} base + {out['n_new']} new of {n_images} "
                             f"images (both split files must fill)")
    log(f"  {label}: {out['n_base']} base / {out['n_new']} new in {wall:.2f} s end to end "
        f"({n_images / wall:.2f} img/s with the checkpoint load and the classifier build); serving "
        f"loop {n_images / (wait + busy):.2f} img/s, decode_wait {wait:.2f} s "
        f"({wait / (wait + busy):.3f} "
        f"of the loop), tta_batch {busy:.2f} s ({busy / (wait + busy):.3f}) on {smi}")
    return files, launches, summ, wall


def add_launches(*dicts) -> dict:
    out = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


def check_block_f32(name, got, ref):
    """K9b in f32 against its plain version: |diff| <= 1e-5 + 1e-5 |ref| and
    row cos >= 0.99999 (the same f32 sums in another order)."""
    cos = float(cosine_rows(got, ref).min())
    log(f"  {name}: min row cos {cos:.7f} (tol 0.99999)")
    err = check_f32(name, got, ref)
    if cos < 0.99999:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


def block_f32_work(x, layer, s, heads, bias, causal):
    """The bound of one f32 layer on x's rows as the kernel computes it:
    the products' 2E(4E + 2F) flops per row, three TF32 passes each at
    the TF32 rate, and the attention's 4 d flops per (query, key) pair
    this mask keeps at the f32 peak (the all-f32 FMA bound logged beside
    it); x read and written, f32 weights and biases and the bias read
    once."""
    rows, e = x.shape
    hidden = layer["mlp"]["c_fc"]["w"].shape[0]
    pairs = rows // s * (s * (s + 1) // 2 if causal else s * s)
    products = 2.0 * rows * e * (4 * e + 2 * hidden)
    attn = 4.0 * heads * pairs * (e // heads)
    w_bytes = 4 * (e * (4 * e + 2 * hidden) + 9 * e + hidden)
    n_bytes = 2 * nbytes(x) + w_bytes + nbytes(bias)
    fma = bound(n_bytes, products + attn, PEAK_F32)
    log(f"  {rows // s} x {s} rows: f32 FMA bound {fma['bound_ms']:.3f} ms ({fma['bound_by']})")
    t_ops = (3 * products / PEAK_TF32 + attn / PEAK_F32) * 1e3
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def ood_phase(params, cfg, counters, smi, launches_srv, launches_cls) -> tuple:
    """13a, 13a' (``crops_identical``), 13b-d: ``cli.ood.main`` on the card
    -> (launches of 13b, 13c and 13d, kernel results)."""
    import pickle

    import torch

    from jcf_tpu_torch.models.loader import state_dict_from_params
    from jcf_tpu_torch.ops import block_kernel as bk

    results = decode_phase(torch.device("cuda", 0), smi)
    crops_identical(torch.device("cuda", 0), smi)
    decodes = decoder_launches(ood_image_paths(OOD_IMAGES))
    decodes_perf = decoder_launches(ood_image_paths(OOD_PERF_IMAGES), batch=PERF_DECODE_BATCH)
    launches_srv = {k: v for k, v in launches_srv.items() if v}
    launches_cls = {k: v for k, v in launches_cls.items() if v}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ds = ood_dataset(os.path.join(tmp, "Dataset"), OOD_IMAGES)
        ds_perf = ood_dataset(os.path.join(tmp, "Dataset_perf"), OOD_PERF_IMAGES)
        ckpt = os.path.join(tmp, "ViT-B-32.pkl")
        with open(ckpt, "wb") as f:
            pickle.dump(state_dict_from_params(params, cfg), f)
        log(f"phase 13: datasets ({OOD_IMAGES} and {OOD_PERF_IMAGES} images) and the seed-0 "
            f"ViT-B/32 checkpoint ({os.path.getsize(ckpt) / 2**20:.0f} MiB) written in "
            f"{time.perf_counter() - t0:.1f} s")
        argv = ["--root_path", ds, "--clip_checkpoint", ckpt]
        n_text = -(-N_CLASSES * 8 // TEXT_BATCH)
        n_img = -(-OOD_IMAGES // 8)

        log("phase 13b: the default configuration (f32, 512 + 1 host crops) through cli.ood.main")
        calls = []
        with per_call_launches(counters, calls, "features_from_crops"):
            files, launches, _, _ = run_ood_cli(tmp, argv, counters, "kernels", OOD_IMAGES, smi)
        log(f"  predicted classes (class: images): {prediction_counts(predictions(calls))}")
        # the text and vision weights split once each, for the classifier
        # build and the engine
        expected = add_launches(float_launches("f32 text", cfg.text_layers, n_text, view=False),
                                float_launches("f32", cfg.vision_layers, n_img, view=False),
                                tree_planes(cfg.text_layers), tree_planes(cfg.vision_layers),
                                decodes)
        log(f"  launches: {launches}")
        if launches != expected:
            raise AssertionError(f"expected exactly the launches {expected}")
        with plain_serving():
            files_p, launches_p, _, _ = run_ood_cli(tmp, argv, counters, "plain versions",
                                                    OOD_IMAGES, smi)
        if launches_p:
            raise AssertionError(f"the plain route launched kernels: {launches_p}")
        if files_p != files:
            raise AssertionError("the split files differ between the kernel and plain routes")
        log("  split files byte-identical between the kernel and plain routes")

        log("phase 13c: the same under _FUSE = 'block' (K9b in f32)")
        first = {}
        bk._FUSE = "block"
        try:
            with first_calls(bk, "block_f32", lambda a: a[2], first):
                files_b, launches_b, _, _ = run_ood_cli(tmp, argv, counters, "block", OOD_IMAGES,
                                                        smi)
            log(f"  launches: {launches_b}")
            expected = {"block_f32": cfg.text_layers * n_text + cfg.vision_layers * n_img,
                        **tree_planes(cfg.text_layers + cfg.vision_layers), **decodes}
            if launches_b != expected:
                raise AssertionError(f"expected exactly the launches {expected}")
            if files_b != files:
                raise AssertionError("the split files differ between 'block' and the halves")
            log("  split files byte-identical to 13b's")
            ph = Phase()
            for name, s, causal in (("block_f32", cfg.context_length, True),
                                    ("block_f32 (vision)", cfg.vision_seq_len, False)):
                x, layer, _, heads, bias = first[s]
                ph.run(name, lambda: bk.block_f32(x, layer, s, heads, bias),
                       lambda: bk.block_f32_plain(x, layer, s, heads, bias), check_block_f32,
                       block_f32_work(x, layer, s, heads, bias, causal), reps=3)
                halves_ms = time_ms(lambda: bk.mlp_half(bk.attn_half(x, layer, s, heads,
                                                                     causal=causal), layer), 3)
                log(f"  {name}: {x.shape[0] // s} x {s} rows, kernel {ph.results[name]['ms']:.3f} "
                    f"ms per layer; the f32 halves (K6a + K6b, 7 launches) {halves_ms:.3f} ms "
                    f"per layer on the same rows")
            del first, x, layer
        finally:
            bk._FUSE = "halves"
        torch.cuda.empty_cache()

        log(f"phase 13d: --perf (bf16, static int8, device crops) on {OOD_PERF_IMAGES} images")
        argv_p = ["--root_path", ds_perf, "--clip_checkpoint", ckpt, "--perf"]
        calls, views_k = [], []
        with per_call_launches(counters, calls), recorded_outputs(views_k):
            files_k, launches_k, summ, wall = run_ood_cli(tmp, argv_p, counters, "kernels",
                                                          OOD_PERF_IMAGES, smi)
        log(f"  launches: {launches_k}")
        for i, (per_batch, _, _) in enumerate(calls):
            if per_batch != launches_srv:
                raise AssertionError(f"batch {i}: launches {per_batch}, phase 8's route "
                                     f"{launches_srv}")
        expected = add_launches(launches_cls, *(c[0] for c in calls), decodes_perf)
        if len(calls) != OOD_PERF_IMAGES // 128 or launches_k != expected:
            raise AssertionError(f"expected {OOD_PERF_IMAGES // 128} batches and the launches "
                                 f"{expected}")
        log(f"  {len(calls)} batches, each launching exactly phase 8's route")
        check_routes("phase 13d", launches_k, {"attention": "mma"})
        preds_k = predictions(calls)
        log(f"  predicted classes (class: images): {prediction_counts(preds_k)}")
        calls_p, views_p = [], []
        # the plain route scores against the kernel route's classifier (a
        # cache hit), so that the comparison is the serving path's alone
        with plain_serving(), per_call_launches(counters, calls_p), recorded_outputs(views_p):
            files_pp, launches_pp, _, _ = run_ood_cli(tmp, argv_p, counters, "plain versions",
                                                      OOD_PERF_IMAGES, smi, fresh_cache=False)
        if launches_pp:
            raise AssertionError(f"the plain route launched kernels: {launches_pp}")
        preds_p = predictions(calls_p)
        modes_k = torch.cat([m.float() for _, m, _ in calls])
        modes_p = torch.cat([m.float() for _, m, _ in calls_p])
        w = calls[0][2].float()
        if not all(torch.equal(c[2].float(), w) for c in calls + calls_p):
            raise AssertionError("the two routes scored against different classifiers")
        top1 = float((preds_k == preds_p).float().mean())
        top5_k = (modes_k @ w.T).topk(5, dim=-1).indices
        top5_p = (modes_p @ w.T).topk(5, dim=-1).indices
        top5 = float((top5_k[:, :, None] == top5_p[:, None, :]).any(-1).float().mean())
        cos = cosine_rows(modes_k, modes_p)
        view_cos = cosine_rows(torch.cat(views_k).flatten(0, 1), torch.cat(views_p).flatten(0, 1))
        log(f"  kernels vs plain versions: per-image top-1 agree {top1:.4f}, top-5 overlap "
            f"{top5:.4f}, mode cos mean {float(cos.mean()):.6f} min {float(cos.min()):.6f}; "
            f"per-view feature cos over {view_cos.numel()} views mean {float(view_cos.mean()):.6f} "
            f"min {float(view_cos.min()):.6f} (gates: top-1 >= 0.99, view cos >= 0.999); split "
            f"files {'identical' if files_pp == files_k else 'differ'}")
        if top1 < 0.99 or float(view_cos.min()) < 0.999:
            raise AssertionError("the --perf kernel route disagrees with its plain versions")
    results.update(ph.results)
    return {"ood_parity": launches, "ood_block": launches_b, "ood_perf": launches_k}, results


# phase 14: jcf-predict end to end (the prompt learner, the heads, the MoCo
# RN50, the cs ensemble, the result writers; the int8 towers under each
# _FUSE with K9a / K9d / K9c in the dynamic mode)
PREDICT_IMAGES = 16  # phase 13's fixtures repeated: 8 base + 8 new, one batch of 8 each
PREDICT_ROUTES = ("halves", "block", "layer", "stream")
# the K9 kernel of each whole-layer route
K9_OF = {"block": "block_int8", "layer": "layer_fused_int8", "stream": "stream_tower_int8"}
# 14c: the calibrated modes of the K9 kernels beside 14b's dynamic one
K9_MODES = ("ln", "hidden", "full+score")
# one layer of the dynamic int8 halves on every row: K3 (LN + row quant,
# qkv, f32-context attention, the context's row quant, out-proj), K4 (LN +
# row quant, c_fc, QuickGELU + row quant, c_proj)
DYNAMIC_LAYER = with_routes({"ln_quant_rows": 2, "int8_gemm_bf16_rows": 1, "attention_f32": 1,
                             "quant_rows": 1, "int8_gemm_residual_rows": 2,
                             "int8_gemm_f32_rows": 1, "gelu_quant_rows": 1})


def rn50_params(seed: int = 0) -> dict:
    """The seed-0 ResNet-50 (``init_resnet50_params``) with BatchNorm
    statistics of a trained tower (scales 0.2-0.6, running variances 0.5-2,
    from ``default_rng(seed + 5)``): identity BatchNorms let the random
    tower's features grow to ~1e3."""
    import torch

    from jcf_tpu_torch.models.resnet import init_resnet50_params

    params = init_resnet50_params(seed)
    rng = np.random.default_rng(seed + 5)

    def stats(bn):
        c = bn["weight"].shape[0]
        bn["weight"] = torch.from_numpy(rng.uniform(0.2, 0.6, c).astype(np.float32))
        bn["running_var"] = torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32))
        bn["bias"] = torch.from_numpy((0.05 * rng.standard_normal(c)).astype(np.float32))
        bn["running_mean"] = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32))

    stats(params["bn1"])
    for stage in params["layers"]:
        for block in stage:
            for i in (1, 2, 3):
                stats(block[f"bn{i}"])
            if "downsample" in block:
                stats(block["downsample"]["bn"])
    return params


def moco_state_dict(params: dict, prefix: str = "base_encoder.") -> dict:
    """A MoCo-v3 checkpoint (torchvision names under ``prefix``, numpy
    arrays) of an RN50 tree, with the projection head a real checkpoint
    carries beside the backbone."""
    sd = {f"{prefix}conv1.weight": params["conv1"].numpy()}
    bn_keys = ("weight", "bias", "running_mean", "running_var")
    for k in bn_keys:
        sd[f"{prefix}bn1.{k}"] = params["bn1"][k].numpy()
    for si, stage in enumerate(params["layers"], start=1):
        for b, blk in enumerate(stage):
            pre = f"{prefix}layer{si}.{b}"
            for ci in (1, 2, 3):
                sd[f"{pre}.conv{ci}.weight"] = blk[f"conv{ci}"].numpy()
                for k in bn_keys:
                    sd[f"{pre}.bn{ci}.{k}"] = blk[f"bn{ci}"][k].numpy()
            if "downsample" in blk:
                sd[f"{pre}.downsample.0.weight"] = blk["downsample"]["conv"].numpy()
                for k in bn_keys:
                    sd[f"{pre}.downsample.1.{k}"] = blk["downsample"]["bn"][k].numpy()
    sd[f"{prefix}fc.0.weight"] = np.zeros((16, 2048), np.float32)
    return sd


def predict_workspace(root: str, params: dict, cfg) -> None:
    """The files ``jcf-predict`` reads, under ``root`` by their default
    names: ``Dataset`` (phase 13's 16 fixture images, ``TestSetB_1.txt``
    the first 8, ``TestSetB_2.txt`` the last 8, its rotated 403-line
    ``classes.txt``), the seed-0 ViT-B/32 checkpoint, the stage-1 LoRA (r 4
    on q, k, v of every layer of both towers, seed 1, B factors drawn
    non-zero), stage 2's ``test_pkl`` (the checkpoint with 4 visual prompt
    tokens, its own LoRA from seed 2, the channel LP and MoCo adapter
    heads, the prompt learner's ctx) and the MoCo checkpoint of
    ``rn50_params(0)``."""
    import pickle

    import torch

    from jcf_tpu_torch.config import PipelineConfig
    from jcf_tpu_torch.heads import init_channel_lp, init_moco_adapter
    from jcf_tpu_torch.models.loader import state_dict_from_params
    from jcf_tpu_torch.peft import init_lora_params, save_lora
    from jcf_tpu_torch.pipelines.train_lora import lora_spec_from_config
    from jcf_tpu_torch.tokenizer import tokenize
    from jcf_tpu_torch.utils import save_pytree

    ds = ood_dataset(os.path.join(root, "Dataset"), PREDICT_IMAGES)
    test = os.path.join(ds, "TestSetB")
    paths = sorted(os.path.join(test, f) for f in os.listdir(test))
    half = PREDICT_IMAGES // 2
    for name, part in (("TestSetB_1.txt", paths[:half]), ("TestSetB_2.txt", paths[half:])):
        with open(os.path.join(ds, name), "w") as f:
            f.writelines(p + "\n" for p in part)
    with open(os.path.join(root, "ViT-B-32.pkl"), "wb") as f:
        pickle.dump(state_dict_from_params(params, cfg), f)
    pc = PipelineConfig()
    spec = lora_spec_from_config(pc)
    rng = np.random.default_rng(0)

    def lora(seed):
        tree = init_lora_params(seed, spec, cfg.text_layers, cfg.text_width, cfg.vision_layers,
                                cfg.vision_width)
        for tower in tree.values():
            tower["b_qkv"] = torch.from_numpy(
                (0.02 * rng.standard_normal(tuple(tower["b_qkv"].shape))).astype(np.float32))
        return tree

    kw = dict(n_text=cfg.text_layers, n_vision=cfg.vision_layers)
    save_lora(lora(1), spec, os.path.join(root, pc.stage1.save_path), **kw)
    out = os.path.join(root, pc.stage2.out_dir)
    vis = dict(params["visual"])
    vis["vpt"] = torch.from_numpy((0.02 * rng.standard_normal((4, cfg.vision_width)))
                                  .astype(np.float32))
    save_pytree(state_dict_from_params(dict(params, visual=vis), cfg),
                os.path.join(out, "clip_model.pkl"))
    save_lora(lora(2), spec, os.path.join(out, "lora_weights.pkl"), **kw)
    w = rng.standard_normal((N_CLASSES, cfg.embed_dim)).astype(np.float32)
    lp = init_channel_lp(N_CLASSES, cfg.embed_dim,
                         torch.from_numpy(w / np.linalg.norm(w, axis=-1, keepdims=True)))
    lp["scale1"] = torch.from_numpy((1 + 0.1 * rng.standard_normal(cfg.embed_dim))
                                    .astype(np.float32))
    save_pytree(lp, os.path.join(out, "channel.pkl"))
    sums = np.abs(rng.standard_normal((N_CLASSES, 2048))).astype(np.float32)
    save_pytree(init_moco_adapter(N_CLASSES, 2048, torch.from_numpy(sums)),
                os.path.join(out, "moco_adapter.pkl"))
    table = params["text"]["token_embedding"].numpy()
    ctx = table[tokenize(pc.stage2.ctx_init)[0][1 : 1 + pc.stage2.n_ctx]]
    save_pytree({"ctx": ctx + (0.01 * rng.standard_normal(ctx.shape)).astype(np.float32)},
                os.path.join(out, "PromptLearner.pkl"))
    with open(os.path.join(root, pc.stage2.moco_checkpoint), "wb") as f:
        pickle.dump(moco_state_dict(rn50_params(0)), f)


@contextlib.contextmanager
def predict_records(ensembles: list, feats: list):
    """For the block: appends the ensembles of each base batch of
    ``run_predict`` ({name: [B, C] f32}) to ``ensembles`` and the per-view
    features of every
    ``TTAEngine.crop_features`` call (the prompted tower, then the zs
    tower, per base batch; the pristine tower per new batch) to ``feats``."""
    from jcf_tpu_torch.infer.engine import TTAEngine
    from jcf_tpu_torch.pipelines import predict as pr

    ens, crop = pr.ensemble_base_logits, TTAEngine.crop_features

    def ens_wrapper(*args):
        out = ens(*args)
        ensembles.append(out)
        return out

    def crop_wrapper(self, crops):
        out = crop(self, crops)
        feats.append(out)
        return out

    pr.ensemble_base_logits, TTAEngine.crop_features = ens_wrapper, crop_wrapper
    try:
        yield
    finally:
        pr.ensemble_base_logits, TTAEngine.crop_features = ens, crop


def run_predict_counted(tmp: str, run, counters, label: str, smi):
    """``run(results_dir, timer)`` (the CLI or ``run_predict``) from
    ``tmp`` with its classifier cache emptied and every launch count at 0
    -> (the three result files, launches, Timer summary, wall seconds)."""
    import torch

    from jcf_tpu_torch.utils import Timer

    shutil.rmtree(os.path.join(tmp, ".jcf_cache"), ignore_errors=True)
    results_dir = os.path.join(tmp, f"final_{label.replace(' ', '_').replace(chr(39), '')}")
    cwd = os.getcwd()
    os.chdir(tmp)
    timer = Timer()
    try:
        torch.cuda.synchronize()
        for c in counters:
            c.update(dict.fromkeys(c, 0))
        t0 = time.perf_counter()
        out = run(results_dir, timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for c in counters for k, v in c.items() if v}
    finally:
        os.chdir(cwd)
    half = PREDICT_IMAGES // 2
    if out["n_base"] != half or out["n_new"] != half:
        raise AssertionError(f"{label}: {out['n_base']} base + {out['n_new']} new, expected "
                             f"{half} + {half}")
    files = {n: open(os.path.join(results_dir, n), "rb").read()
             for n in ("top5_results6.txt", "top5_results_ood.txt", "result.txt")}
    lines = files["result.txt"].decode().splitlines()
    if len(lines) != PREDICT_IMAGES or any(len(l.split()) != 6 or "/" in l for l in lines):
        raise AssertionError(f"{label}: result.txt is not {PREDICT_IMAGES} lines of a file name "
                             f"and 5 labels")
    summ = timer.summary()
    wait, base, new = (summ[k]["total_s"] for k in ("decode_wait", "base_batch", "new_batch"))
    log(f"  {label}: {PREDICT_IMAGES} images in {wall:.2f} s end to end "
        f"({PREDICT_IMAGES / wall:.2f} img/s with the loads, the 4 text classifiers and the "
        f"engines: load "
        f"{summ['load']['total_s']:.2f} s, classifiers {summ['classifiers']['total_s']:.2f} s, "
        f"engines {summ['engines']['total_s']:.2f} s); base loop {half / base:.2f} img/s, new loop "
        f"{half / new:.2f} img/s, decode_wait {wait:.2f} s "
        f"({wait / (wait + base + new):.3f} of the loops) on {smi}")
    return files, launches, summ, wall


def text_launches(fuse: str, dtype: str, n_layers: int, calls: int) -> dict:
    """The text tower's launches over ``calls`` forwards (the classifier
    builds' batches and the prompt learner's one): K9b per layer under
    "block" (``block_bf16``; ``block_f32`` in f32), else the float halves."""
    if fuse == "block":
        return {"block_f32" if dtype == "f32" else "block_bf16": n_layers * calls}
    return float_launches("f32 text" if dtype == "f32" else "bf16 text", n_layers, calls,
                          view=False)


def predict_phase(params, cfg, counters, text, smi, dev):
    """Phase 14a-b: ``jcf-predict`` on the card -> (launches of each 14b
    route, kernel results)."""
    import torch

    from jcf_tpu_torch.cli import predict as cli
    from jcf_tpu_torch.cli._args import build_parser, config_from_args
    from jcf_tpu_torch.models import clip as clip_module
    from jcf_tpu_torch.ops import block_kernel as bk
    from jcf_tpu_torch.ops.layers import layer_slice
    from jcf_tpu_torch.pipelines import run_predict
    from jcf_tpu_torch.tta.mta import solve_mta_batch

    ph = Phase()
    launches_routes = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        predict_workspace(tmp, params, cfg)
        log(f"phase 14: jcf-predict's workspace (16 images, ViT-B/32, the stage-1 and stage-2 "
            f"LoRAs, the prompted checkpoint, the heads, the MoCo RN50) written in "
            f"{time.perf_counter() - t0:.1f} s")
        argv = ["--root_path", "Dataset", "--clip_checkpoint", "ViT-B-32.pkl"]
        n_text = 3 * -(-N_CLASSES * 8 // TEXT_BATCH) + 1  # 3 classifiers + the prompt learner

        def cli_run(results_dir, timer):
            return cli.main([*argv, "--results_dir", results_dir, "--device",
                             torch.device(dev).type], timer=timer)

        log("phase 14a: the default configuration (f32, 512 + 1 host crops) through "
            "cli.predict.main")
        ens_k, feats_f = [], []
        torch.cuda.reset_peak_memory_stats()
        with predict_records(ens_k, feats_f):
            files_k, launches_k, _, _ = run_predict_counted(tmp, cli_run, counters, "kernels", smi)
        log(f"  launches: {launches_k}")
        log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
            f"(torch.cuda.max_memory_allocated over the run) on {smi}")
        # 3 crop clouds (the prompted and zs towers on the base batch, the
        # pristine one on the new batch), the text tower, one decode per
        # image and per loader (the center view and the crops come from
        # the same decode)
        decodes = decoder_launches(ood_image_paths(PREDICT_IMAGES))
        # the weights split once a tree: three classifier builds and the
        # prompt learner (text), three engines (vision)
        expected = add_launches(text_launches("halves", "f32", cfg.text_layers, n_text),
                                float_launches("f32", cfg.vision_layers, 3, view=False),
                                tree_planes(cfg.text_layers, 4), tree_planes(cfg.vision_layers, 3),
                                decodes)
        if launches_k != expected:
            raise AssertionError(f"expected exactly the launches {expected}")
        ens_p = []
        with plain_serving(), predict_records(ens_p, []):
            files_p, launches_p, _, _ = run_predict_counted(tmp, cli_run, counters,
                                                            "plain versions", smi)
        if launches_p:
            raise AssertionError(f"the plain route launched kernels: {launches_p}")
        d_cs1 = max(float((a["cs1"] - b["cs1"]).abs().max()) for a, b in zip(ens_k, ens_p))
        log(f"  kernels vs plain versions: cs1 max |diff| {d_cs1:.3e} (tol 1e-3); result files "
            f"{'byte-identical' if files_k == files_p else 'DIFFER'}")
        if files_k != files_p or d_cs1 > 1e-3 or len(ens_k) != len(ens_p):
            raise AssertionError("14a: the kernel route disagrees with the plain versions")

        cfg_q = config_from_args(build_parser("p", 346373).parse_args(argv))
        cfg_q = dataclasses.replace(cfg_q, runtime=dataclasses.replace(
            cfg_q.runtime, compute_dtype="bfloat16", quant="int8"))
        top5_f = torch.cat([e["cs1"] for e in ens_k]).topk(5, dim=-1).indices
        try:
            for fuse in PREDICT_ROUTES:
                bk._FUSE = fuse
                log(f"phase 14b, _FUSE = {fuse!r}: runtime.quant = 'int8', compute_dtype bf16 "
                    f"(dynamic per-row scales), through run_predict")
                ens_q, feats_q, towers = [], [], []
                with predict_records(ens_q, feats_q), recorded(clip_module, "run_fused_tower",
                                                              towers, 1):
                    _, launches, _, _ = run_predict_counted(
                        tmp, lambda r, t: run_predict(cfg_q, r, device=dev, timer=t), counters,
                        f"int8 {fuse}", smi)
                log(f"  launches: {launches}")
                n = cfg.vision_layers
                vision = ({"stream_tower_int8": 3} if fuse == "stream"
                          else {K9_OF[fuse]: 3 * n} if fuse in K9_OF
                          else {k: v * 3 * n for k, v in DYNAMIC_LAYER.items()})
                expected = add_launches(text_launches(fuse, "bf16", cfg.text_layers, n_text),
                                        vision, decodes)
                if launches != expected:
                    raise AssertionError(f"expected exactly the launches {expected}")
                launches_routes[fuse] = launches

                # the prompted tower's crops against 14a's f32 features: per
                # crop (phase 10b's bars for dynamic int8) and the MTA modes
                q, f = feats_q[0].float(), feats_f[0].float()
                flat_q, flat_f = q.reshape(-1, q.shape[-1]), f.reshape(-1, f.shape[-1])
                top1, overlap, cos = agreement(flat_q, flat_f, text)
                crop_cos = cosine_rows(flat_q, flat_f)
                modes_q, modes_f = solve_mta_batch(q, text), solve_mta_batch(f, text)
                mode_cos = float(cosine_rows(modes_q, modes_f).min())
                top5_q = torch.cat([e["cs1"] for e in ens_q]).topk(5, dim=-1).indices
                same5 = float((top5_q == top5_f).all(-1).float().mean())
                ties = tie_share(flat_q, flat_f, text)
                log(f"  prompted tower, int8 ({fuse}) vs 14a's f32 over {flat_q.shape[0]} crops: "
                    f"top1_agree {top1:.4f} top5_overlap {overlap:.4f}; feature cos mean "
                    f"{cos:.6f} min {float(crop_cos.min()):.6f}; modes min cos {mode_cos:.6f}; "
                    f"crops whose f32 top-1 - top-2 gap is under the int8 swing {ties:.4f}; cs1 "
                    f"top-5 equal to 14a's on {same5:.3f} of the base images (not gated)")
                margins(flat_q, flat_f, text)
                # phase 10b's bars; where more than 1% of the crops' f32 top-1
                # gaps lie under the int8 swing (crops of the same few photos
                # through random weights sit near one point), top-1 counts
                # near-ties and phase 10c's fixed gates hold the features
                if ties <= 0.01:
                    log("  gates: top-1 >= 0.99, top-5 >= 0.97, modes min cos >= 0.999")
                    ok = top1 >= 0.99 and overlap >= 0.97 and mode_cos >= 0.999
                else:
                    log("  gates (near-ties): top-5 >= 0.97, feature cos mean and min >= 0.999, "
                        "modes min cos >= 0.999; top-1 printed")
                    ok = (overlap >= 0.97 and cos >= 0.999 and float(crop_cos.min()) >= 0.999
                          and mode_cos >= 0.999)
                if not ok:
                    raise AssertionError(f"14b {fuse}: the int8 towers fail the certificate")

                # the K9 kernel against its plain version on the prompted
                # tower's input rows (54 tokens; layer 0, the whole tower for
                # K9c), beside the dynamic halves per layer
                rows, quant, heads = towers[0][:3]
                s = rows.shape[0] // feats_q[0].shape[0] // feats_q[0].shape[1]
                layer0 = layer_slice(quant, 0)
                halves_ms = time_ms(lambda: bk._halves_int8(rows, layer0, s, heads), 3)
                if fuse in K9_OF:
                    name = K9_OF[fuse]
                    k9_check(ph, f"{name}/dynamic", fuse, rows, quant, s, heads)
                    per_layer = ph.results[f"{name}/dynamic"]["ms"] / (n if fuse == "stream" else 1)
                    log(f"  {name} (dynamic) at {rows.shape[0] // s} x {s} rows: {per_layer:.3f} "
                        f"ms per layer; the dynamic halves (K3 + K4, 9 launches) {halves_ms:.3f} "
                        f"ms per layer on the same rows")
                else:
                    log(f"  the dynamic halves at {rows.shape[0] // s} x {s} rows: "
                        f"{halves_ms:.3f} ms per layer")
                del ens_q, feats_q, towers, rows, quant
                torch.cuda.empty_cache()
        finally:
            bk._FUSE = "halves"
    return launches_routes, ph.results


def k9_check(ph, label, fuse, rows, quant, s, heads):
    """``k9_branch_check`` of the K9 kernel of ``fuse`` on the folded tree
    ``quant``: layer 0 (K9a, K9d) or the whole tower (K9c)."""
    from jcf_tpu_torch.ops.layers import layer_slice

    name = K9_OF[fuse]
    k9_branch_check(ph, label, name, rows,
                    quant if name == "stream_tower_int8" else layer_slice(quant, 0), s, heads)


def k9_modes_phase(params, images_np, images, geometry, text, counters, smi, dev):
    """Phase 14c: each K9 kernel in the modes "ln", "hidden" and
    "full+score" (the folded tree calibrated on phase 6's images, dense
    rows), on the int8 engine's route (``features_from_images``, b1024 x 8
    views = 8192 crops of 50 rows): one counted forward per (mode, route),
    the kernel against its plain version on that forward's tower input,
    the halves per layer in the same mode -> ({path: launches},
    results)."""
    import torch

    from jcf_tpu_torch.infer import engine as engine_module
    from jcf_tpu_torch.infer.engine import TTAEngine
    from jcf_tpu_torch.models.clip import VIT_B_32
    from jcf_tpu_torch.ops import block_kernel as bk
    from jcf_tpu_torch.ops.layers import layer_slice

    cfg = VIT_B_32
    ph = Phase()
    launches = {}
    try:
        for mode in K9_MODES:
            engine = TTAEngine(params, cfg, device=dev, quant="int8", n_views=VIEWS - 1,
                               calibration_images=images_np, static_quant_mode=mode)
            for fuse, name in K9_OF.items():
                bk._FUSE = fuse
                log(f"phase 14c, {name} in mode {mode!r}: ViT-B/32 int8 serving, b{BATCH} x "
                    f"{VIEWS} views")
                towers = []
                with recorded(engine_module, "run_fused_tower", towers, 1):
                    modes, counted = count_forward(
                        counters, lambda: engine.features_from_images(images, text,
                                                                      geometry=geometry))
                check_modes(modes, BATCH, cfg.embed_dim)
                if not counted.get(name):
                    raise AssertionError(f"{name} never launched under _FUSE = {fuse!r}")
                label = f"{name}/{mode}"
                launches[f"modes_{fuse}_{mode}"] = {label: counted[name]}
                log(f"  launches: {counted}")
                rows, quant, heads = towers[0][:3]
                s = cfg.vision_seq_len
                k9_check(ph, label, fuse, rows, quant, s, heads)
                halves_ms = time_ms(lambda: bk._halves_int8(rows, layer_slice(quant, 0), s, heads),
                                    3)
                n = cfg.vision_layers if fuse == "stream" else 1
                log(f"  {label}: {ph.results[label]['ms'] / n:.3f} ms per layer; the halves in "
                    f"mode {mode!r} {halves_ms:.3f} ms per layer on the same rows")
                del towers, rows, quant, modes
            del engine
            torch.cuda.empty_cache()
    finally:
        bk._FUSE = "halves"
    return launches, ph.results


# the K9 branches: the int8 text tower under "block" (12b), the
# unfolded tower (12c) and 288² (10c) under each K9 route, the odd-head and
# 64-token towers and engines under "block" (12d)
KERNELS.update({
    "block_int8/masked_f32": ("classifier_int8_block_f32", K9_PERSISTENT_SRC,
                              "jcf_tpu/ops/block_kernel.py:732"),
    "block_int8/masked": ("classifier_int8_block_bf16", K9_PERSISTENT_SRC,
                          "jcf_tpu/ops/block_kernel.py:732"),
    "block_int8/odd_heads": ("engine_masked_block", K9_PERSISTENT_SRC,
                             "jcf_tpu/ops/block_kernel.py:732"),
    "block_int8/nondense": ("engine_nondense_block", K9_PERSISTENT_SRC,
                            "jcf_tpu/ops/block_kernel.py:732"),
    **{f"{name}/{branch}": (f"{path}_{fuse}", KERNELS[name][1], KERNELS[name][2])
       for fuse, name in K9_OF.items()
       for branch, path in (("unfolded", "tower_unfolded"), ("long", "serving_288"))},
})
# the K9 kernels in the modes phase 14 adds: jcf-predict's dynamic towers
# (14b) and the calibrated modes on the serving route (14c)
KERNELS.update({f"{name}/dynamic": (f"predict_{fuse}", KERNELS[name][1], KERNELS[name][2])
                for fuse, name in K9_OF.items()})
KERNELS.update({f"{name}/{mode}": (f"modes_{fuse}_{mode}", KERNELS[name][1], KERNELS[name][2])
                for mode in K9_MODES for fuse, name in K9_OF.items()})


# the K9 kernels off the folded dense route at 64 tokens or fewer:
# the int8 text tower (12b under "block"), the unfolded vision tower (12c
# under each K9 route), 288² (10c under each K9 route), the odd-head and
# 64-token towers and engines (12d under "block")
K9_ROUTES_ITERS = 2  # timed forwards of each K9 route at 288²


@contextlib.contextmanager
def plain_k9():
    """Routes ``run_fused_tower``'s whole-layer int8 kernels (K9a, K9d,
    K9c) through their plain versions for the block; with
    ``plain_halves`` the whole tower's plain route."""
    from jcf_tpu_torch.ops import block_kernel as bk

    saved = {n: getattr(bk, n) for n in K9_OF.values()}
    for n in saved:
        setattr(bk, n, getattr(bk, f"{n}_plain"))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(bk, n, fn)


def k9_branch_check(ph, label, name, rows, tree, s, heads, *, lns=(None, None), causal=False,
                    dense=True, reps=3):
    """``ph.run`` of the K9 kernel ``name`` against its plain version on
    ``rows`` with ``tree`` (one layer for K9a and K9d: the one-layer bars;
    the stacked tree for K9c: the cosine bar), the unfolded tree's ``lns``
    (per layer, or stacked for K9c) and the route. The bound reads each
    input once (the rows, every layer's weights and LN affines) and writes
    the rows once; the attention's (query, key) pairs are the causal
    mask's where there is one."""
    from jcf_tpu_torch.ops import block_kernel as bk

    kern, plain = getattr(bk, name), getattr(bk, f"{name}_plain")
    n_rows, e = rows.shape
    stream = name == "stream_tower_int8"
    n_layers = tree["attn"]["w_qkv"].w_int8.shape[0] if stream else 1
    hidden = tree["mlp"]["c_fc"].w_int8.shape[-2]
    w_bytes = sum(nbytes(*q) for q in (tree["attn"]["w_qkv"], tree["attn"]["w_out"],
                                        tree["mlp"]["c_fc"], tree["mlp"]["c_proj"]))
    ln_bytes = 0 if lns[0] is None else n_layers * 4 * e * rows.element_size()
    pairs = n_rows // s * (s * (s + 1) // 2 if causal else s * s)
    work = layer_work(n_rows, e, hidden, heads, pairs, 2 * nbytes(rows) + w_bytes + ln_bytes,
                      PEAK_INT8, n_layers)
    if stream:
        return ph.run(label, lambda: kern(rows, tree, heads, s=s, lns=lns),
                      lambda: plain(rows, tree, heads, s=s, lns=lns),
                      lambda n, g, r: check_layer(n, g, r, elementwise=False), work, reps=1)
    kw = dict(causal=causal, dense=dense) if name == "block_int8" else {}
    return ph.run(label, lambda: kern(rows, tree, s, heads, lns=lns, **kw),
                  lambda: plain(rows, tree, s, heads, lns=lns, **kw), check_layer, work, reps=reps)


def stacked_lns(blocks, dt):
    """The stacked (ln_1, ln_2) affines of float ``blocks`` in ``dt``."""
    return tuple({k: blocks[n][k].to(dt) for k in ("scale", "bias")} for n in ("ln_1", "ln_2"))


def k9_unfolded_phase(cfg, counters, smi, rows_v, blocks_v, quant_v):
    """Phase 12c under ``_FUSE`` = "block", "layer", "stream": the unfolded
    int8 ViT-B/32 tower at 8192 crops on every row, counted (12 K9a, 12
    K9d or 1 K9c, each on the "unfolded" branch, nothing else); each
    kernel against its plain version on the tower's input rows; the tower
    against the bf16 float tower (mean row cos > 0.995, 12c's gate); ms
    per layer beside the unfolded halves' -> (launches by path,
    results)."""
    import torch

    from jcf_tpu_torch.ops import block_kernel as bk
    from jcf_tpu_torch.ops.layers import layer_slice

    s, heads, n = cfg.vision_seq_len, cfg.vision_heads, cfg.vision_layers
    lns = stacked_lns(blocks_v, rows_v.dtype)
    lns0 = bk._lns_slice(lns, 0)
    flt = bk.run_float_tower(rows_v, blocks_v, heads, s=s, causal=False)
    halves_ms = time_ms(lambda: bk._halves_int8(rows_v, layer_slice(quant_v, 0), s, heads, lns0), 3)
    ph = Phase()
    launches = {}
    try:
        for fuse, name in K9_OF.items():
            bk._FUSE = fuse
            log(f"phase 12c, _FUSE = {fuse!r}: the unfolded int8 tower, {rows_v.shape[0] // s} crops "
                f"x {s} tokens, every row")
            out, counted = count_forward(counters, lambda: bk.run_fused_tower(
                rows_v, quant_v, heads, flat_s=s, cls_only=False, blocks=blocks_v))
            want = 1 if fuse == "stream" else n
            log(f"  launches: {counted}")
            if counted != {name: want, f"{name}/unfolded": want}:
                raise AssertionError(f"expected exactly {want} {name} on the unfolded branch")
            cos_f = cosine_rows(out, flt)
            log(f"  vs the bf16 float tower: mean row cos {float(cos_f.mean()):.6f}, min "
                f"{float(cos_f.min()):.6f} (gate: mean > 0.995)")
            if float(cos_f.mean()) <= 0.995:
                raise AssertionError(f"_FUSE = {fuse!r}: the unfolded tower fails its gate")
            del out
            label = f"{name}/unfolded"
            if fuse == "stream":
                k9_branch_check(ph, label, name, rows_v, quant_v, s, heads, lns=lns)
            else:
                k9_branch_check(ph, label, name, rows_v, layer_slice(quant_v, 0), s, heads, lns=lns0)
            per_layer = ph.results[label]["ms"] / (n if fuse == "stream" else 1)
            log(f"  {label}: {per_layer:.3f} ms per layer; the unfolded halves (K3 + K4) "
                f"{halves_ms:.3f} ms per layer on the same rows, on {smi}")
            launches[f"tower_unfolded_{fuse}"] = {label: counted[label]}
            torch.cuda.empty_cache()
    finally:
        bk._FUSE = "halves"
    return launches, ph.results


def k9_288_routes(engine, images, geometry, text, feats_f, modes_f, counters, smi):
    """Phase 10c under ``_FUSE`` = "block", "layer", "stream" (static
    "full", 82 tokens, b256 x 8 views): each route counted (11 K9a or 11
    K9d on the "long" branch, then the last layer's K3 on all rows and K4
    on the CLS rows; or one K9c), 10c's fixed gates against the f32
    engine, each kernel against its plain version on the tower's input
    rows (2048 crops x 82), img/s -> (launches by path, results)."""
    import torch

    from jcf_tpu_torch.infer import engine as engine_module
    from jcf_tpu_torch.ops import block_kernel as bk
    from jcf_tpu_torch.ops.layers import layer_slice

    cfg = engine.cfg
    s, heads, n = cfg.vision_seq_len, cfg.vision_heads, cfg.vision_layers
    base = {"view": 1, "view/patch": 1, "int8_gemm_s32": 1, "assemble": 1}
    last = with_routes({"ln_quant": 2, "int8_gemm_bf16": 1, "attention": 1,
                        "int8_gemm_residual": 2, "int8_gemm_gelu_quant": 1})
    ph = Phase()
    launches = {}
    try:
        for fuse, name in K9_OF.items():
            bk._FUSE = fuse
            log(f"phase 10c, _FUSE = {fuse!r}: ViT-B/32 at {RES_288}² ({s} tokens), static 'full'")
            towers = []
            with recorded(engine_module, "run_fused_tower", towers, 1):
                modes, counted = count_forward(
                    counters, lambda: engine.features_from_images(images, text, geometry=geometry))
            k9 = 1 if fuse == "stream" else n - 1
            expected = {**base, name: k9, f"{name}/long": k9, **({} if fuse == "stream" else last)}
            log(f"  launches: {counted}")
            if counted != expected:
                raise AssertionError(f"expected exactly the launches {expected}")
            check_modes(modes, images.shape[0], cfg.embed_dim)
            feats = engine._view_features(images, geometry)
            view_cos = cosine_rows(feats.reshape(-1, feats.shape[-1]),
                                   feats_f.reshape(-1, feats.shape[-1]))
            top1, overlap, cos = agreement(modes, modes_f, text)
            log(f"  cert int8 ({fuse}) vs f32: top1_agree {top1:.4f} top5_overlap {overlap:.4f}; "
                f"mode cos mean {cos:.6f}; per-view feature cos mean {float(view_cos.mean()):.6f} "
                f"min {float(view_cos.min()):.6f} (gates: top-5 >= 0.97, mean mode cos, per-view "
                f"mean and min >= 0.999)")
            if (overlap < 0.97 or cos < 0.999 or float(view_cos.mean()) < 0.999
                    or float(view_cos.min()) < 0.999):
                raise AssertionError(f"_FUSE = {fuse!r} at {RES_288}² fails the certificate")
            del feats, view_cos
            rows, quant = towers[0][0], towers[0][1]
            label = f"{name}/long"
            if fuse == "stream":
                k9_branch_check(ph, label, name, rows, quant, s, heads)
            else:
                k9_branch_check(ph, label, name, rows, layer_slice(quant, 0), s, heads)
            del towers, rows
            gen = torch.Generator(device=images.device).manual_seed(2)
            time_forwards(lambda: engine.features_from_images(images, text, generator=gen),
                          K9_ROUTES_ITERS, images.shape[0], "img", smi,
                          f"_FUSE = {fuse!r} at {RES_288}²")
            launches[f"serving_288_{fuse}"] = {label: counted[label]}
            torch.cuda.empty_cache()
    finally:
        bk._FUSE = "halves"
    return launches, ph.results


def k9_small_towers_phase(dev, counters, smi):
    """Phase 12d under ``_FUSE`` = "block": the odd-head tower (3 heads,
    50 tokens: K9a's masked branch without a mask) and the 64-token tower
    (2 heads: the non-dense mask-free branch), 12 layers of the unfolded
    tree at 1024 crops, counted (12 K9a on the branch, nothing else),
    against the plain route and the halves (row cos >= 0.999), K9a
    against its plain version on layer 0; then the int8 engines of the
    same widths (the 64-token one with 14 visual prompts), dynamic and
    static "full", on their non-assembled route (K1, the s32 patch GEMM,
    then the tower on every row; no K2) at 128 images x 8 views: counted,
    per-view features against the plain route and the halves (cos >=
    0.999), img/s -> (launches by path, results)."""
    import torch

    from jcf_tpu_torch.infer.engine import TTAEngine
    from jcf_tpu_torch.models.clip import CLIPConfig, init_clip_params, tree_to
    from jcf_tpu_torch.ops import block_kernel as bk
    from jcf_tpu_torch.ops.layers import layer_slice
    from jcf_tpu_torch.ops.quant import quantize_clip_params

    ph = Phase()
    launches = {}
    n_img = SMALL_CROPS // VIEWS
    rng = np.random.default_rng(3)
    images_np = rng.random((n_img, 3, 256, 256)).astype(np.float32)
    images = torch.from_numpy(images_np).to(dev, torch.bfloat16)
    try:
        for width, prompts, branch, label in ((192, 0, "masked", "block_int8/odd_heads"),
                                              (128, 14, "nondense", "block_int8/nondense")):
            heads, s = width // 64, 50 + prompts
            cfg = CLIPConfig(vision_width=width, text_layers=1, vision_prompt_tokens=prompts)
            params = init_clip_params(0, cfg)
            text = torch.nn.functional.normalize(torch.randn(
                N_CLASSES, cfg.embed_dim, device=dev, generator=torch.Generator(device=dev)
                .manual_seed(1)), dim=-1)
            blocks = tree_to(params["visual"]["blocks"], dev, torch.bfloat16)
            quant = quantize_clip_params({"visual": tree_to(params["visual"], dev)})["visual"]
            x = torch.randn(SMALL_CROPS * s, width, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(s)).bfloat16()
            tower = lambda: bk.run_fused_tower(x, quant, heads, flat_s=s, cls_only=False,
                                               blocks=blocks)
            bk._FUSE = "block"
            out, counted = count_forward(counters, tower)
            with plain_halves(), plain_k9():
                ref = tower()
            bk._FUSE = "halves"
            halves = tower()
            bk._FUSE = "block"
            cos_p, cos_h = float(cosine_rows(out, ref).min()), float(cosine_rows(out, halves).min())
            log(f"phase 12d, _FUSE = 'block': {heads} heads x {s} tokens, int8, {SMALL_CROPS} "
                f"crops: launches {counted}; vs plain min row cos {cos_p:.6f}, vs the halves "
                f"{cos_h:.6f} (gates >= 0.999)")
            if counted != {"block_int8": 12, f"block_int8/{branch}": 12} or min(cos_p, cos_h) < 0.999:
                raise AssertionError(f"the {heads}-head {s}-token tower under 'block' fails")
            lns = bk._lns_slice(stacked_lns(blocks, torch.bfloat16), 0)
            k9_branch_check(ph, label, "block_int8", x, layer_slice(quant, 0), s, heads, lns=lns,
                            dense=False)
            del out, ref, halves, x
            for mode in (None, "full"):
                engine = TTAEngine(params, cfg, device=dev, quant="int8", n_views=VIEWS - 1,
                                   calibration_images=None if mode is None else images_np,
                                   static_quant_mode=mode or "full")
                geometry = engine.sample_geometry(torch.Generator(device=dev).manual_seed(0),
                                                  n_img, images.shape[2:])
                feats, counted = count_forward(counters,
                                               lambda: engine._view_features(images, geometry))
                with plain_halves(), plain_k9():
                    feats_p = engine._view_features(images, geometry)
                bk._FUSE = "halves"
                feats_h, counted_h = count_forward(counters,
                                                   lambda: engine._view_features(images, geometry))
                bk._FUSE = "block"
                if heads % 2 and mode == "full":
                    # the masked attention with the static (int8) context
                    log(f"  the {heads}-head int8 engine (full) under the halves: launches "
                        f"{counted_h}")
                    check_routes(f"phase 12d, {heads}-head engine (full, halves)", counted_h,
                                 {"masked_attention": "mma"})
                    launches["engine_odd_heads_full_halves"] = counted_h
                flat = lambda f: f.reshape(-1, f.shape[-1])
                cos_p = float(cosine_rows(flat(feats), flat(feats_p)).min())
                cos_h = float(cosine_rows(flat(feats), flat(feats_h)).min())
                want = {"view": 1, "view/patch": 1, "int8_gemm_s32": 1, "block_int8": 12,
                        f"block_int8/{branch}": 12}
                log(f"  the {heads}-head {s}-token int8 engine ({mode or 'dynamic'}), {n_img} "
                    f"images x {VIEWS} views under 'block': launches {counted}; per-view features "
                    f"vs plain min cos {cos_p:.6f}, vs the halves {cos_h:.6f} (gates >= 0.999)")
                if counted != want or min(cos_p, cos_h) < 0.999:
                    raise AssertionError(f"the {heads}-head {s}-token engine under 'block' fails")
                time_forwards(lambda: engine.features_from_images(images, text, geometry=geometry),
                              K9_ROUTES_ITERS, n_img, "img", smi,
                              f"{heads}-head {s}-token engine ({mode or 'dynamic'}, 'block')")
                launches[f"engine_{branch}_block"] = {label: counted["block_int8"]}
                del engine, feats, feats_p, feats_h
            torch.cuda.empty_cache()
    finally:
        bk._FUSE = "halves"
    return launches, ph.results


def probes_phase(smi, dev) -> tuple:
    """15: the probes of ``jcf_tpu_torch/scripts`` at full size. P4
    (``exp_boundary_cost``): chains of 6-48 ``copy_add_one`` launches over
    [204800, 768] bf16, eager and in one CUDA graph, each chain held to the
    plain chain bit for bit, its launches counted; the kernel against its
    plain version. P5 (``profile_halves``): K3 and K4 of the seed-0
    ViT-B/32's layer 0 (unfolded, dynamic) at b1024 x 50, each half's ms
    against its bound and its stages' split -> (P4's launches, the
    kernel's results)."""
    import torch

    from jcf_tpu_torch.scripts import exp_boundary_cost as p4
    from jcf_tpu_torch.scripts import profile_halves as p5

    log("phase 15a: probe P4 (python -m jcf_tpu_torch.scripts.exp_boundary_cost)")
    torch.cuda.synchronize()
    p4.LAUNCHES.update(dict.fromkeys(p4.LAUNCHES, 0))
    r4 = p4.run(device=dev)
    torch.cuda.synchronize()
    launches = dict(p4.LAUNCHES)
    (es, ei), (gs, gi) = r4["eager_fit"], r4["graph_fit"]
    log(f"  P4: copy_add_one launched {launches['copy_add_one']} times; per kernel: eager slope "
        f"{es:.4f} ms (intercept {ei:.4f}), graph slope {gs:.4f} ms (intercept {gi:.4f}), bound "
        f"{r4['bound_ms']:.4f} ms; boundary overhead eager {es - r4['bound_ms']:.4f} ms, graph "
        f"{gs - r4['bound_ms']:.4f} ms, on {smi}")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((204800, 768), np.float32))
    x = x.to(dev, torch.bfloat16)
    ph = Phase()
    ph.run("copy_add_one", lambda: p4.copy_add_one(x), lambda: p4.copy_add_one_plain(x),
           check_equal, bound(2 * nbytes(x), x.numel(), PEAK_F32),
           library=lambda: torch.add(x, 1))
    del x
    torch.cuda.empty_cache()

    log("phase 15b: probe P5 (python -m jcf_tpu_torch.scripts.profile_halves)")
    r5 = p5.run(device=dev)
    for half in ("attn", "mlp"):
        r = r5[half]
        stages = ", ".join(f"{name} {ms:.4f}" for name, ms in r["stages"])
        log(f"  P5: {half} half {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
            f"stages (ms, one call): {stages}; on {smi}")
    torch.cuda.empty_cache()
    return launches, ph.results


def probe_kernels_phase(smi, dev) -> tuple:
    """15c-15e: the probes P3, P1 and P2 of ``jcf_tpu_torch/scripts`` at
    full size, each script's ``run`` counted (the main path), then each new
    kernel against its plain version. P3 (``exp_batched_dot``): 12,288
    heads of [56, 64] bf16 through ``batched_dot_mma`` and
    ``batched_dot_loop`` (K8's bf16 bar), SDPA as the yardstick. P1
    (``exp_w4a8``): the MLP half at 409,600 rows, int8 (the K4 kernels),
    w4_step and w4_cache, equal bit for bit inside ``run``; the w4a8 GEMMs
    at c_fc's and c_proj's shapes, ``unpack_int4``, and the int8 variant
    against the plain ``_mlp_math``. P2 (``exp_patch_regroup``): the three
    strategies over 512 planes of 224² in f32 and int8, bit for bit, the
    plain copy as the yardstick -> ({path: launches}, results)."""
    import torch

    from jcf_tpu_torch.ops import block_kernel as bk
    from jcf_tpu_torch.ops import int8_gemm as ig
    from jcf_tpu_torch.scripts import exp_batched_dot as p3
    from jcf_tpu_torch.scripts import exp_patch_regroup as p2
    from jcf_tpu_torch.scripts import exp_w4a8 as p1

    launches, ph = {}, Phase()
    log("phase 15c: probe P3 (python -m jcf_tpu_torch.scripts.exp_batched_dot)")
    r3, launches["probe_p3"] = count_forward([p3.LAUNCHES], lambda: p3.run(device=dev))
    mma, loop = r3["batched"]["ms"], r3["loop"]["ms"]
    log(f"  P3: launches {launches['probe_p3']}; tensor cores {mma:.4f} ms, CUDA-core loop "
        f"{loop:.4f} ms ({loop / mma:.1f}x), SDPA {r3['library_ms']:.4f} ms "
        f"({mma / r3['library_ms']:.2f}x of it), bound {r3['bound_ms']:.4f} ms; on {smi}")
    q, k, v = p3.inputs(p3.GRID * p3.GROUP * p3.H, dev, seed=1)
    slack = 2.0**-7 * torch.matmul(p3.probs(q, k), v.float().abs())
    work3 = bound(*p3.work(q.shape[0], p3.S, p3.D), PEAK_BF16)
    for name, fn in (("batched_dot_mma", p3.batched_dot_mma),
                     ("batched_dot_loop", p3.batched_dot_loop)):
        ph.run(name, lambda: fn(q, k, v), lambda: p3.batched_dot_plain(q, k, v),
               lambda n, a, b: check_bf16(n, a, b, slack), work3,
               library=lambda: p3.sdpa(q, k, v))
    del q, k, v, slack
    torch.cuda.empty_cache()

    log("phase 15d: probe P1 (python -m jcf_tpu_torch.scripts.exp_w4a8)")
    r1, launches["probe_p1"] = count_forward([p1.LAUNCHES, bk.LAUNCHES, ig.LAUNCHES],
                                             lambda: p1.run(device=dev))
    int8_ms = r1["int8"]["ms"]
    log(f"  P1: launches {launches['probe_p1']}; int8 {int8_ms:.4f} ms, w4_step "
        f"{r1['w4_step']['ms']:.4f} ms ({r1['w4_step']['ms'] - int8_ms:+.4f}), w4_cache "
        f"{r1['w4_cache']['ms']:.4f} ms ({r1['w4_cache']['ms'] - int8_ms:+.4f}), bound "
        f"{r1['bound_ms']:.4f} ms, _int_mm* {r1['library_ms']:.4f} ms; on {smi}")
    wfc_np, wproj_np = p1.weights(1)
    wfc, wproj = torch.from_numpy(wfc_np).to(dev), torch.from_numpy(wproj_np).to(dev)
    wfc4, wproj4 = p1.pack(wfc_np).to(dev), p1.pack(wproj_np).to(dev)
    c = p1.constants(dev)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((p1.ROWS, p1.E), np.float32))
    x = x.to(dev, torch.bfloat16)
    x_q = bk.ln_quant(x, c["ln_inv"])
    h_q = ph.run("w4a8_gemm_gelu_quant",
                 lambda: p1.w4a8_gemm_gelu_quant(x_q, wfc4, c["fc_scale"], c["fc_bias"],
                                                 c["gelu_c"]),
                 lambda: p1.w4a8_gemm_gelu_quant_plain(x_q, wfc4, c["fc_scale"], c["fc_bias"],
                                                       c["gelu_c"]),
                 lambda n, a, b: check_int8(n, a, b, 1e-3),
                 bound(nbytes(x_q, wfc4, c["fc_scale"], c["fc_bias"]) + x_q.shape[0] * p1.HID,
                       2 * x_q.shape[0] * p1.E * p1.HID, PEAK_INT8),
                 lambda: torch._int_mm(x_q, wfc.T))
    ph.run("w4a8_gemm_residual",
           lambda: p1.w4a8_gemm_residual(h_q, wproj4, c["proj_scale"], c["proj_bias"], x),
           lambda: p1.w4a8_gemm_residual_plain(h_q, wproj4, c["proj_scale"], c["proj_bias"], x),
           check_bf16,
           bound(nbytes(h_q, wproj4, c["proj_scale"], c["proj_bias"], x, x),
                 2 * h_q.shape[0] * p1.E * p1.HID, PEAK_INT8),
           lambda: torch._int_mm(h_q, wproj.T))
    wfc8, wproj8 = p1.unpack_int4(wfc4), p1.unpack_int4(wproj4)
    cost = [(name, ph.results[name]["ms"], time_ms(fn)) for name, fn in (
        ("w4a8_gemm_gelu_quant", lambda: ig.int8_gemm_gelu_quant(x_q, wfc8, c["fc_scale"],
                                                                 c["fc_bias"], c["gelu_c"])),
        ("w4a8_gemm_residual", lambda: ig.int8_gemm_residual(h_q, wproj8, c["proj_scale"],
                                                             c["proj_bias"], x)))]
    log("  P1: the unpack in the load path costs " + ", ".join(
        f"{name} {w4:.4f} ms against the int8 GEMM's {i8:.4f} ms on the unpacked weight "
        f"({w4 - i8:+.4f})" for name, w4, i8 in cost) + f"; on {smi}")
    ph.run("unpack_int4", lambda: p1.unpack_int4(wfc4), lambda: p1.unpack_int4_plain(wfc4),
           check_equal, bound(3 * nbytes(wfc4), 2 * wfc.numel(), PEAK_F32))
    for name, fn in (("w4_step", lambda: p1.mlp_w4_step(x, wfc4, wproj4, c)),
                     ("w4_cache", lambda: p1.mlp_w4_cache(x, wfc4, wproj4, c))):
        if not torch.equal(fn(), p1.mlp_int8(x, wfc, wproj, c)):
            raise AssertionError(f"P1 {name} differs from the int8 variant")
    log("  P1: w4_step and w4_cache equal to int8 bit for bit on a second input")
    check_composed("P1 int8 (K4 kernels) vs the plain _mlp_math",
                   p1.mlp_int8(x, wfc, wproj, c), p1.mlp_w4a8_plain(x, wfc, wproj, c),
                   lambda: p1.mlp_int8(x, wfc, wproj, c),
                   lambda: p1.mlp_w4a8_plain(x, wfc, wproj, c))
    del x, x_q, h_q, wfc, wproj, wfc4, wproj4, wfc8, wproj8
    torch.cuda.empty_cache()

    log("phase 15e: probe P2 (python -m jcf_tpu_torch.scripts.exp_patch_regroup)")
    r2, launches["probe_p2"] = count_forward([p2.LAUNCHES], lambda: p2.run(device=dev))
    for tag, r in r2.items():
        log(f"  P2 {tag}: " + ", ".join(f"{s.upper()} {r[s]:.4f} ms" for s in p2.STRATEGIES)
            + f", plain copy {r['plain']:.4f} ms, bound {r['bound_ms']:.4f} ms; on {smi}")
    for tag, dt in p2.DTYPES.items():
        x = p2.planes(p2.PLANES, dt, dev, seed=1)
        for s in p2.STRATEGIES:
            ph.run(f"patch_regroup_{s}" + ("" if tag == "f32" else f"_{tag}"),
                   lambda: p2.patch_regroup(x, s), lambda: p2.patch_regroup_plain(x),
                   check_equal, bound(2 * nbytes(x), 0, PEAK_F32),
                   library=lambda: p2.patch_regroup_plain(x))
        del x
    torch.cuda.empty_cache()
    return launches, ph.results


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from jcf_tpu_torch import _build
    from jcf_tpu_torch.config import reference_preset
    from jcf_tpu_torch.infer.engine import TTAEngine
    from jcf_tpu_torch.models.clip import VIT_B_32, init_clip_params, tree_to
    from jcf_tpu_torch.ops import (
        assemble_kernel,
        attention,
        bf16_gemm,
        block_kernel,
        f32_gemm,
        int8_gemm,
        view_kernel,
    )
    from jcf_tpu_torch.pipelines.common import build_engine

    counters = [m.LAUNCHES for m in (view_kernel, int8_gemm, assemble_kernel, block_kernel,
                                     bf16_gemm, f32_gemm, attention)]

    # every f32 reference and the calibration use full f32 products; bf16
    # products accumulate in f32 with one rounding (the training step)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)
    smi = cmd_output(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    smi = smi.splitlines()[0]
    log(f"card: {smi}")
    nvcc_v = cmd_output([_build.nvcc(), "--version"]).splitlines()[-1]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc: {nvcc_v}")
    log(f"decode on this host: {decode_facts()}")

    t0 = time.perf_counter()
    _build.load()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")

    cfg = VIT_B_32
    n_random = VIEWS - 1
    t0 = time.perf_counter()
    params = init_clip_params(0, cfg)
    rng = np.random.default_rng(0)
    images_np = rng.random((BATCH, 3, 256, 256)).astype(np.float32)
    text = rng.standard_normal((N_CLASSES, cfg.embed_dim)).astype(np.float32)
    text = torch.from_numpy(text / np.linalg.norm(text, axis=-1, keepdims=True)).to(dev)
    images = torch.from_numpy(images_np).to(dev, torch.bfloat16)
    engine = TTAEngine(params, cfg, device=dev, quant="int8",
                       n_views=n_random, calibration_images=images_np)
    torch.cuda.synchronize()
    log(f"engine built (weights, calibration, quantization) in {time.perf_counter() - t0:.1f} s")

    geometry = engine.sample_geometry(torch.Generator(device=dev).manual_seed(0),
                                      BATCH, images.shape[2:])
    n_small = 1024 // VIEWS
    serving_kernel_phase(engine, images[:n_small], tuple(t[:n_small] for t in geometry))
    results = serving_kernel_phase(engine, images, geometry)

    built, launches_cls, text_results = classifier_phase(params, cfg, dev, counters)
    results.update(text_results)
    launches_trn, k7 = training_phase(params, cfg, dev, counters, smi)
    # the JSON line carries the text attention in bf16 (the step's larger
    # share); the log has all four
    results.update(k7[("text", "bf16")])

    # the serving path, counted; K1 writes the patch rows (no eager im2col
    # copy: _patchify is never called) and every LN + quant row takes the
    # vector kernel
    from jcf_tpu_torch.infer import engine as engine_module

    torch.cuda.synchronize()
    for c in counters:
        c.update(dict.fromkeys(c, 0))
    patchified = []
    with recorded(engine_module, "_patchify", patchified, 1):
        modes = engine.features_from_images(images, text, geometry=geometry)
    torch.cuda.synchronize()
    launches_srv = {k: v for c in counters for k, v in c.items()}
    log(f"serving path launches: {launches_srv}")
    check_routes("serving path", launches_srv, {"attention": "mma"})
    log(f"serving path: view/patch {launches_srv['view/patch']}, _patchify calls "
        f"{len(patchified)}")
    if launches_srv["view/patch"] != 1 or patchified:
        raise AssertionError("the serving path must take K1's patch rows")
    check_no_scalar("serving path", launches_srv)
    check_modes(modes, BATCH, cfg.embed_dim)

    # int8 vs the f32 engine on the same geometry (bench.py's cert): the
    # reference preset's engine on its own route (K1 in f32, the float
    # tower: 7 launches a layer, no K7), counted; phase 11 holds it against
    # its plain-version route
    t0 = time.perf_counter()
    ref = build_engine(params, cfg, views_preset(reference_preset(), n_random), device=dev)
    rows_f32 = []
    with recorded(block_kernel, "attn_half", rows_f32, 1):
        modes_f, launches_f32 = count_forward(
            counters, lambda: ref.features_from_images(images, text, geometry=geometry))
    log(f"f32 engine launches: {launches_f32}")
    if launches_f32 != float_launches("f32", cfg.vision_layers):
        raise AssertionError(f"expected exactly the launches {float_launches('f32', cfg.vision_layers)}")
    check_modes(modes_f, BATCH, cfg.embed_dim)
    top1, overlap, cos = agreement(modes, modes_f, text)
    log(f"cert int8 vs f32 ({time.perf_counter() - t0:.1f} s): top1_agree {top1:.4f} "
        f"top5_overlap {overlap:.4f} mode_cos {cos:.6f} (gates: >= 0.99, >= 0.97; against the "
        f"composable f32 tower with plain K7: {PLAIN_K7_CERT[0]} / {PLAIN_K7_CERT[1]} / "
        f"{PLAIN_K7_CERT[2]})")
    margins(modes, modes_f, text)
    if top1 < 0.99 or overlap < 0.97:
        raise AssertionError("int8 path fails the ranking certificate")

    # one pass with the built classifier: finite unit-norm modes; the
    # agreement is printed, not gated (random-init text features may be
    # near-collinear)
    modes_b = engine.features_from_images(images, built, geometry=geometry)
    if not bool(modes_b.isfinite().all()) or float((modes_b.norm(dim=-1) - 1).abs().max()) > 1e-3:
        raise AssertionError("bad modes with the built classifier")
    top1_b, overlap_b, cos_b = agreement(
        modes_b, ref.features_from_images(images, built, geometry=geometry), built)
    log(f"built classifier, int8 vs f32 (not gated): top1_agree {top1_b:.4f} "
        f"top5_overlap {overlap_b:.4f} mode_cos {cos_b:.6f}")

    # throughput: fresh geometry per iteration, sampled on the card
    gen = torch.Generator(device=dev).manual_seed(2)
    for _ in range(2):
        engine.features_from_images(images, text, generator=gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        out = engine.features_from_images(images, text, generator=gen)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    ips = BATCH * ITERS / elapsed
    log(f"slice throughput: {ips:.2f} img/s (b{BATCH} x {VIEWS} views, "
        f"{ITERS} iters, {elapsed / ITERS * 1e3:.2f} ms/iter) on {smi}")
    if not bool(out.isfinite().all()):
        raise AssertionError("non-finite modes in the timed run")

    launches_b16, results_b16 = serving_b16_phase(dev, counters, smi, text)
    results.update(results_b16)

    # phase 9: the whole-layer routes, on the same engine, images, geometry
    # and classifier as phases 5-8
    try:
        launches_fused, results_fused = fused_serving_phase(engine, images, geometry, text, modes,
                                                            modes_f, counters, smi, dev)
        launches_cls_block, results_cls_block = fused_classifier_phase(params, cfg, dev, counters,
                                                                       built)
    finally:
        block_kernel._FUSE = "halves"
    results.update(results_fused)
    results.update(results_cls_block)

    # phase 10: the quantization modes on the same images, geometry,
    # classifier and f32 modes; features_from_crops; 82 tokens
    launches_modes, results_modes = quant_modes_phase(params, images_np, images, geometry, text,
                                                      modes_f, counters, smi, dev)
    results.update(results_modes)
    crops_phase(params, images, text, counters, smi, dev)
    _, results_288, launches_288 = serving_288_phase(text, counters, smi, dev)
    results.update(results_288)

    # phase 11: the unquantized towers (the f32 engine of phase 7, the
    # bf16 parity engine, the f32 classifier build)
    torch.cuda.reset_peak_memory_stats()
    launches_bf16, rows_bf16, results_block = float_engine_phase(params, ref, modes_f, images,
                                                                 geometry, text, counters, smi, dev)
    results.update(results_block)
    launches_cls_f32, ids, built_f32 = float_classifier_phase(params, cfg, dev, counters)
    text_f32 = planes_phase(params, cfg, ref, dev, counters, smi)
    results.update(float_kernel_phase(rows_f32[0], rows_bf16, text_f32, cfg, ids, images, geometry))
    log(f"phase 11: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
        f"(torch.cuda.max_memory_allocated over the phase) on {smi}")
    del ref, rows_f32, rows_bf16, text_f32
    torch.cuda.empty_cache()

    # phase 12: the masked and unfolded int8 halves, on phase 6's tower
    # input rows (K2's output at 8192 crops) and phase 11b's prompts
    from jcf_tpu_torch.ops.quant import quantize_clip_params

    calls = []
    with recorded(engine_module, "run_fused_tower", calls, 1):
        engine.features_from_images(images, text, geometry=geometry)
    rows_v, blocks_v = calls[0][0], engine._params["visual"]["blocks"]
    del calls, engine
    quant_v = quantize_clip_params({"visual": tree_to(params["visual"], dev)})["visual"]
    results.update(masked_kernel_phase(params, cfg, dev, ids, rows_v, blocks_v, quant_v))
    launches_cls_int8, _ = int8_classifier_phase(params, cfg, dev, counters, built_f32, modes_f)
    launches_cls_k9, results_cls_k9 = int8_classifier_phase(params, cfg, dev, counters, built_f32,
                                                            modes_f, fuse="block")
    results.update(results_cls_k9)
    launches_unf = unfolded_tower_phase(cfg, counters, smi, rows_v, blocks_v, quant_v)
    launches_unf_k9, results_unf_k9 = k9_unfolded_phase(cfg, counters, smi, rows_v, blocks_v,
                                                        quant_v)
    results.update(results_unf_k9)
    del rows_v, blocks_v, quant_v
    torch.cuda.empty_cache()
    launches_odd, results_odd = small_towers_phase(dev, counters)
    results.update(results_odd)
    launches_small_k9, results_small_k9 = k9_small_towers_phase(dev, counters, smi)
    results.update(results_small_k9)
    torch.cuda.empty_cache()

    # phase 13: jcf-ood end to end through its CLI, both paths
    from jcf_tpu_torch.data import decode as decode_module

    launches_ood, results_ood = ood_phase(params, cfg, counters + [decode_module.LAUNCHES], smi,
                                          launches_srv, launches_cls)
    results.update(results_ood)

    # phase 14: jcf-predict end to end through its CLI and
    # run_predict; the K9 kernels in the calibrated modes
    launches_pred, results_pred = predict_phase(params, cfg, counters + [decode_module.LAUNCHES],
                                                text, smi, dev)
    results.update(results_pred)
    launches_k9m, results_k9m = k9_modes_phase(params, images_np, images, geometry, text, counters,
                                               smi, dev)
    results.update(results_k9m)

    # phase 15 (last): the probes P4, P5, P3, P1 and P2 at full size
    launches_p4, results_p4 = probes_phase(smi, dev)
    results.update(results_p4)
    launches_probes, results_probes = probe_kernels_phase(smi, dev)
    results.update(results_probes)
    launches = {"serving": launches_srv, "classifier": launches_cls, "training": launches_trn,
                "serving_b16": launches_b16, "serving_block": launches_fused["block"],
                "serving_layer": launches_fused["layer"],
                "serving_stream": launches_fused["stream"], "classifier_block": launches_cls_block,
                "serving_dynamic": launches_modes["dynamic"], "serving_ln": launches_modes["ln"],
                "serving_f32": launches_f32, "serving_bf16": launches_bf16,
                "classifier_f32": launches_cls_f32,
                "classifier_int8_f32": launches_cls_int8["float32"],
                "classifier_int8_bf16": launches_cls_int8["bfloat16"],
                "tower_unfolded": launches_unf, "tower_odd_heads_bf16": launches_odd,
                **launches_ood, "probe_p4": launches_p4, **launches_probes, **launches_k9m, **launches_288, **launches_unf_k9,
                **launches_small_k9,
                "classifier_int8_block_f32": {"block_int8/masked_f32":
                                              launches_cls_k9["float32"]["block_int8"]},
                "classifier_int8_block_bf16": {"block_int8/masked":
                                               launches_cls_k9["bfloat16"]["block_int8"]},
                **{f"predict_{fuse}": {f"{name}/dynamic": launches_pred[fuse].get(name, 0)}
                   for fuse, name in K9_OF.items()}}
    missing = [k for k, (path, _, _) in KERNELS.items() if launches[path].get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels of their path never launched: {missing}")

    log(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s")
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[path][name], **results[name],
         **route_counts(launches[path], name)}
        for name, (path, src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
