"""Layers, quantization and the kernel wrappers of the port (``jcf_tpu/ops``)."""
