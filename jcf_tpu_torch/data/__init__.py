"""Data helpers of the port (``jcf_tpu/data``): the class templates, image
decode, the PIL-free transforms, the TestSetB walk and the loader."""

from jcf_tpu_torch.data.datasets import (
    Datum,
    TTADataset,
    read_classnames,
    read_image,
    walk_test_dir,
)
from jcf_tpu_torch.data.decode import decode_batch, decode_png
from jcf_tpu_torch.data.loader import DataLoader
from jcf_tpu_torch.data.templates import (
    TEMPLATE_PATTERNS,
    load_class_templates,
    load_template_file,
    synthesize_templates,
)
from jcf_tpu_torch.data.transforms import (
    CLIP_MEAN,
    CLIP_STD,
    RandomResizedCrop,
    TTACropSampler,
    center_crop,
    normalize,
    preprocess_center,
    resize_short_side,
    to_chw_array,
)

__all__ = ["CLIP_MEAN", "CLIP_STD", "DataLoader", "Datum", "RandomResizedCrop", "TEMPLATE_PATTERNS",
           "TTACropSampler", "TTADataset", "center_crop", "decode_batch", "decode_png",
           "load_class_templates", "load_template_file", "normalize", "preprocess_center",
           "read_classnames", "read_image", "resize_short_side", "synthesize_templates",
           "to_chw_array", "walk_test_dir"]
