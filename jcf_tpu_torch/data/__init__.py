"""Data helpers of the port (``jcf_tpu/data``): the class templates, image
decode, the PIL-free transforms, the TestSetB walk and the loader."""

from jcf_tpu_torch.data.datasets import (
    Datum,
    TTADataset,
    label_to_classname,
    read_classnames,
    read_image,
    read_path_list,
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
    MOCO_MEAN,
    MOCO_STD,
    RandomResizedCrop,
    TTACropSampler,
    center_crop,
    normalize,
    preprocess_center,
    resize_short_side,
    to_chw_array,
)

__all__ = ["CLIP_MEAN", "CLIP_STD", "DataLoader", "Datum", "MOCO_MEAN", "MOCO_STD",
           "RandomResizedCrop", "TEMPLATE_PATTERNS", "TTACropSampler", "TTADataset",
           "center_crop", "decode_batch", "decode_png", "label_to_classname",
           "load_class_templates", "load_template_file", "normalize", "preprocess_center",
           "read_classnames", "read_image", "read_path_list", "resize_short_side",
           "synthesize_templates", "to_chw_array", "walk_test_dir"]
