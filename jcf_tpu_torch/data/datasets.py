"""Dataset records of ``jcf_tpu/data/datasets.py`` that ``jcf-ood`` and
``jcf-predict`` read: ``Datum``, ``read_classnames``, the TestSetB walk,
the split lists and the TTA dataset. Images decode through
``data.decode`` onto an explicit device."""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List

import torch

from jcf_tpu_torch.data.decode import decode_file
from jcf_tpu_torch.data.transforms import TTACropSampler, preprocess_center


@dataclasses.dataclass
class Datum:
    impath: str
    label: int
    classname: str
    domain: str


def read_image(path: str, device="cuda") -> torch.Tensor:
    """uint8 [H, W, 3] RGB on ``device``, equal to PIL's
    ``convert("RGB")`` (``data.decode``: a JPEG decoded as libjpeg-turbo
    decodes it, a PNG through the port's decoder; a grayscale JPEG's luma
    repeated); a missing or unreadable file raises and names itself."""
    if not os.path.exists(path):
        raise IOError(f"No file exists at {path}")
    img = decode_file(path, device)
    return img if img.shape[2] == 3 else img.expand(-1, -1, 3).contiguous()


def read_classnames(classes_path: str) -> Dict[str, int]:
    """classes.txt lines '<Domain>_<name> <label>' -> name -> label."""
    out: Dict[str, int] = {}
    with open(classes_path) as f:
        for line in f:
            if not line.strip():
                continue
            classname, label = line.strip().split()
            out[classname] = int(label)
    return out


def label_to_classname(classname_to_label: Dict[str, int]) -> Dict[int, str]:
    return {v: k for k, v in classname_to_label.items()}


def read_path_list(split_path: str, image_dir: str = "") -> List[Datum]:
    """An unlabeled path-per-line list (``TestSetB_1.txt`` /
    ``TestSetB_2.txt``): the first field of each non-empty line, joined to
    ``image_dir`` where given."""
    out: List[Datum] = []
    with open(split_path) as f:
        for line in f:
            if not line.strip():
                continue
            path = line.strip().split()[0]
            full = os.path.join(image_dir, path) if image_dir else path
            out.append(Datum(full, -1, "Unknown", os.path.basename(os.path.dirname(full))))
    return out


def walk_test_dir(test_dir: str) -> List[Datum]:
    """Recursive image walk in sorted order (directories, then files),
    .jpg / .jpeg / .png by extension in any case, skipping ``__MACOSX``."""
    out: List[Datum] = []
    for root, _, files in sorted(os.walk(test_dir)):
        for fname in sorted(files):
            if not fname.lower().endswith((".jpg", ".jpeg", ".png")):
                continue
            full = os.path.join(root, fname)
            if "__MACOSX" in full:
                continue
            out.append(Datum(full, -1, "Unknown", os.path.basename(root)))
    return out


class TTADataset:
    """(center [1, 3, s, s], crops [N, 3, s, s], label, impath, index), f32
    on ``device``: the reference's test-mode sample (``ood.py:946-958``),
    the center view ``preprocess_center(size, resize_to)``, CLIP-normalized
    or, with ``center_normalize=False``, raw [0, 1] pixels (stage 2's and
    ``jcf-predict``'s loaders normalize on the device), and the crops of
    ``crop_sampler``."""

    def __init__(self, data: List[Datum], crop_sampler: TTACropSampler, *, size: int = 224,
                 resize_to: int = 256, center_normalize: bool = True, device="cuda"):
        self.data = data
        self.crop_sampler = crop_sampler
        self.size = size
        self.resize_to = resize_to
        self.center_normalize = center_normalize
        self.device = torch.device(device)

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, index: int):
        d = self.data[index]
        img = read_image(d.impath, self.device)
        center = preprocess_center(img, size=self.size, resize_to=self.resize_to,
                                   apply_normalize=self.center_normalize)
        crops = self.crop_sampler(img, index)
        return center[None], crops, d.label, d.impath, index
