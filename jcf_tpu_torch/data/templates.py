"""Class templates (``jcf_tpu/data/templates.py``).

A template directory holds ``text_template{1..8}.txt``, one line per
class: line i of every file is a prompt for class i. When the directory
is missing, ``synthesize_templates`` writes it from ``classes.txt`` with
the eight prompt patterns below, as the JAX package does.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional

TEMPLATE_PATTERNS = [
    "a photo of a {}.",
    "a photo of the {}.",
    "a sketch of a {}.",
    "a sketch of the {}.",
    "an image of a {}.",
    "an image of the {}.",
    "a bright photo of a {}.",
    "a good photo of a {}.",
]


def _clean_classname(raw: str) -> str:
    """'Animal_Giant_panda' -> 'Giant panda' (domain prefix dropped,
    underscores to spaces)."""
    parts = raw.split("_", 1)
    name = parts[1] if len(parts) == 2 else parts[0]
    return name.replace("_", " ")


def load_class_templates(template_dir: str) -> Dict[int, List[str]]:
    """All *.txt files of the directory, in name order; line i of each file
    is one template for class i."""
    out: Dict[int, List[str]] = {}
    for path in sorted(glob.glob(os.path.join(template_dir, "*.txt"))):
        with open(path) as f:
            for i, line in enumerate(f):
                out.setdefault(i, []).append(line.strip())
    return out


def load_template_file(template_dir: str, idx: int) -> Dict[int, List[str]]:
    """One bank: line i of ``text_template{idx}.txt`` is class i's prompt."""
    out: Dict[int, List[str]] = {}
    with open(os.path.join(template_dir, f"text_template{idx}.txt")) as f:
        for i, line in enumerate(f):
            out[i] = [line.strip()]
    return out


def synthesize_templates(classes_file: str, out_dir: str, captions_file: Optional[str] = None,
                         n_banks: int = 8) -> None:
    """Write text_template{1..n_banks}.txt from the class names of
    ``classes_file`` (first word of each non-empty line); bank 1 takes the
    lines of ``captions_file`` where it has them."""
    names: List[str] = []
    with open(classes_file) as f:
        for line in f:
            if line.strip():
                names.append(_clean_classname(line.strip().split()[0]))
    captions: List[str] = []
    if captions_file and os.path.exists(captions_file):
        with open(captions_file) as f:
            captions = [line.strip() for line in f if line.strip()]
    os.makedirs(out_dir, exist_ok=True)
    for bank in range(1, n_banks + 1):
        pattern = TEMPLATE_PATTERNS[(bank - 1) % len(TEMPLATE_PATTERNS)]
        with open(os.path.join(out_dir, f"text_template{bank}.txt"), "w") as f:
            for i, name in enumerate(names):
                f.write((captions[i] if bank == 1 and i < len(captions) else pattern.format(name))
                        + "\n")
