"""Test-time ensembling, the OOD split rule and the result-file writers
(``jcf_tpu/infer/predict.py``).

The formulas are the reference's ``evaluate_base`` and ``evaluate_new``;
the files are its writers', including the batch-of-1 list-repr quirk of
the image path (lines read ``['path'] l1 l2 l3 l4 l5``) that
``process_line`` later strips to the bare file name for
``final_results/result.txt``.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Iterable, List, Tuple

import torch

from jcf_tpu_torch.ops.stats import logit_normalize

OOD_BOUNDARY_PRED = 372  # pred <= 372 -> base (ood.py:880)


def ensemble_base_logits(mode_hand: torch.Tensor, mode_pt: torch.Tensor, mode_zs: torch.Tensor,
                         text_hand: torch.Tensor, text_pt: torch.Tensor, text_zs: torch.Tensor,
                         lp_logits_combined: torch.Tensor,
                         moco_logits: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Every ensemble variant cs .. cs7 from the MTA modes [B, D] against
    the handcrafted, prompted and zero-shot classifiers [C, D], the fused
    channel-LP logits and the MoCo head's; the emitted base prediction is
    ``cs1``."""
    cs = 100.0 * mode_hand @ text_hand.T
    cs1 = 100.0 * mode_pt @ text_pt.T
    cs3 = 100.0 * mode_zs @ text_zs.T
    cs2 = (cs + cs1) / 2
    cs4 = (cs2 + cs3) / 2
    cs5 = cs4 + 0.5 * lp_logits_combined
    cs6 = cs4 + 0.5 * moco_logits
    cs7 = cs4 + 0.25 * (lp_logits_combined + moco_logits)
    return {"cs": cs, "cs1": cs1, "cs2": cs2, "cs3": cs3, "cs4": cs4, "cs5": cs5, "cs6": cs6,
            "cs7": cs7}


def combine_lp_logits(logits_combined: torch.Tensor, logits_zs: torch.Tensor) -> torch.Tensor:
    """Channel-LP fusion: normalize each, average, normalize again."""
    l1 = logit_normalize(logits_combined)
    l2 = logit_normalize(logits_zs)
    return logit_normalize((l1 + l2) / 2)


def ood_side(pred: int) -> str:
    """'base' when pred <= 372, else 'new'."""
    return "base" if pred <= OOD_BOUNDARY_PRED else "new"


def format_impath(impath: str) -> str:
    """The reference's batch-of-1 stringified-list image path."""
    return f"['{impath}']"


def write_top5(path: str, rows: Iterable[Tuple[str, Iterable[int]]],
               reference_format: bool = True) -> None:
    """rows: (impath, top-5 labels). ``reference_format`` wraps the path in
    the list-repr the reference writes before its cleanup."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for impath, top5 in rows:
            key = format_impath(impath) if reference_format else impath
            f.write(f"{key} {' '.join(str(int(t)) for t in top5)}\n")


def load_txt_to_dict(path: str) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if parts:
                out[parts[0]] = parts[1:]
    return out


def update_txt_file(base_txt: str, update_txt: str) -> None:
    """Dict-merge keyed by image path, the update winning; written back to
    ``base_txt``."""
    base = load_txt_to_dict(base_txt)
    base.update(load_txt_to_dict(update_txt))
    with open(base_txt, "w") as f:
        for key, values in base.items():
            f.write(f"{key} {' '.join(values)}\n")


_LIST_RE = re.compile(r"\['(.*?)'\]")


def process_line(line: str) -> str:
    """Strip the list-repr down to the bare file name."""
    m = _LIST_RE.search(line)
    if m:
        file_name = m.group(1).split("/")[-1]
        line = line.replace(m.group(0), file_name)
    return line


def process_result_lines(input_file: str, output_file: str) -> None:
    os.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
    with open(input_file) as infile, open(output_file, "w") as outfile:
        for line in infile:
            outfile.write(process_line(line))
