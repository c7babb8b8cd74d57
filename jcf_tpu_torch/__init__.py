"""PyTorch + CUDA port of ``jcf_tpu`` for one NVIDIA H100.

The JAX package stays the reference; this package keeps its module names
so each module here has a counterpart there. It imports torch and numpy,
never jax, and nothing from ``jcf_tpu``.

What is ported so far:

- the int8 TTA serving path (``infer.engine.TTAEngine.features_from_images``):
  view sampling (K1), int8 patch embed, token assembly (K2), the int8
  attention and MLP halves of the tower (K3, K4), the CLS-query last-layer
  attention (K5), the CLS-row tail and MTA;
- the zero-shot classifier build that every ``jcf-ood`` run takes before it
  serves (``pipelines.common.build_text_weights``): templates, the
  ``regex``-free tokenizer, the bf16 text tower (K6a, K6b) and the
  content-keyed classifier cache;
- the stage-1 LoRA training step (``train.make_stage1_step``): LoRA
  (``peft``), both towers on the composable route with the packed-qkv
  attention K7 forward and backward, AdamW, the LoRA files and tree
  checkpoints (``utils``);
- serving towers of 128 tokens or more (ViT-B/16's 197): the composable
  tower with the blocked attention K8 and dynamic per-row int8 linears
  (or in f32), and the checkpoint loader (``models.loader``) that turns a
  ViT state dict into its ``CLIPConfig`` and params;
- ``jcf-ood`` end to end (``cli.ood``, ``pipelines.ood.run_ood_split``):
  the TestSetB walk, JPEG decode with nvJPEG on the card, the PIL-exact
  TTA crops (``data.transforms``), the threaded loader, both paths; and
  K9b in f32 (``ops.block_kernel.block_f32``) under ``_FUSE = "block"``;
- ``jcf-predict`` end to end (``cli.predict``,
  ``pipelines.predict.run_predict``): the zs, prompted and pristine
  towers, the prompt learner (``peft.prompt``), the heads (``heads``),
  the MoCo ResNet-50 (``models.resnet``), the cs ensembles and the result
  writers (``infer.predict``); and the whole-layer int8 kernels K9a, K9c
  and K9d in every quantization mode of the folded tree.

Every Pallas kernel on those paths has a hand-written CUDA kernel under
``csrc/`` and a plain PyTorch version beside its wrapper; a wrapper runs
the plain version only for CPU tensors. Entry points run on the CUDA card
unless the caller passes ``device="cpu"``.
"""
