"""Test-time augmentation of the port (``jcf_tpu/tta``)."""

from jcf_tpu_torch.tta.classifier import build_classifier_weights, encode_class_templates
from jcf_tpu_torch.tta.mta import MTAParams, solve_mta, solve_mta_batch

__all__ = ["MTAParams", "build_classifier_weights", "encode_class_templates", "solve_mta",
           "solve_mta_batch"]
