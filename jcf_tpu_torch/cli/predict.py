"""``jcf-predict-torch``: the final top-5 prediction over the OOD split
(``jcf_tpu/cli/predict.py``, the reference's ``test.py``) on the card.

    python -m jcf_tpu_torch.cli.predict --root_path Dataset \
        --clip_checkpoint ViT-B-32.pkl [--results_dir final_results] [--swa_dir DIR]

The flags are the JAX CLI's; ``--device`` (the port's own, default
"cuda") runs the plain versions on the CPU instead, as the tests do. On the
card the CLI turns TF32 off for matmuls and cuDNN convolutions, so that
the f32 default configuration computes in f32 as the JAX package does, and
bf16 products to one rounding of an f32 sum (``ops.layers.linear``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from jcf_tpu_torch.cli._args import build_parser, config_from_args


def main(argv: Optional[Sequence[str]] = None, *, timer=None) -> dict:
    """Parses ``argv`` (the command line when None), seeds, and runs
    ``run_predict`` on ``--device`` with ``timer`` (a ``utils.Timer`` that
    collects its phases; one of its own when None); returns its result."""
    parser = build_parser("Final top-5 prediction over the OOD split", default_seed=346373)
    parser.add_argument("--results_dir", type=str, default="final_results")
    parser.add_argument("--swa_dir", type=str, default="",
                        help="folder of stage-1 LoRA pkls to average (SWA) instead of loading "
                             "the single stage-1 checkpoint")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    import torch

    from jcf_tpu_torch.pipelines import run_predict
    from jcf_tpu_torch.utils import set_random_seed

    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    set_random_seed(args.seed)
    cfg = config_from_args(args)
    if args.swa_dir:
        cfg = dataclasses.replace(cfg, stage1=dataclasses.replace(cfg.stage1, swa_dir=args.swa_dir))
    return run_predict(cfg, results_dir=args.results_dir, device=args.device, timer=timer)


if __name__ == "__main__":
    main()
