"""PyTorch + CUDA port of ``jcf_tpu`` for one NVIDIA H100.

The JAX package stays the reference; this package keeps its module names
so each module here has a counterpart there. It imports torch and numpy,
never jax, and nothing from ``jcf_tpu``.

What is ported so far is the int8 TTA serving path
(``infer.engine.TTAEngine.features_from_images``): view sampling (K1),
int8 patch embed, token assembly (K2), the int8 attention and MLP halves
of the tower (K3, K4), the CLS-row tail and MTA. Every Pallas kernel on
that path has a hand-written CUDA kernel under ``csrc/`` and a plain
PyTorch version beside its wrapper; a wrapper runs the plain version only
for CPU tensors.
"""
