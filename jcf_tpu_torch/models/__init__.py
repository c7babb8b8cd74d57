"""CLIP model pieces of the port (``jcf_tpu/models``)."""

from jcf_tpu_torch.models.clip import VIT_B_32, CLIPConfig, init_clip_params, params_from_numpy

__all__ = ["CLIPConfig", "VIT_B_32", "init_clip_params", "params_from_numpy"]
