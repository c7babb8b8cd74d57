"""``jcf-ood-torch``: the zero-shot OOD base/new split of TestSetB
(``jcf_tpu/cli/ood.py``) on the card.

    python -m jcf_tpu_torch.cli.ood --root_path Dataset [--perf] [--device cpu]

The flags are the JAX CLI's; ``--device`` (the port's own, default
"cuda") runs the plain versions on the CPU instead, as the tests do. On the
card the CLI turns TF32 off for matmuls and cuDNN convolutions, so that
the f32 default configuration computes in f32 as the JAX package does.
"""

from __future__ import annotations

from typing import Optional, Sequence

from jcf_tpu_torch.cli._args import build_parser, config_from_args


def main(argv: Optional[Sequence[str]] = None, timer=None) -> dict:
    """Parses ``argv`` (the command line when None), seeds, and runs
    ``run_ood_split`` on ``--device`` with ``timer`` (a ``utils.Timer``
    that collects its phases; one of its own when None); returns its
    result."""
    parser = build_parser("Zero-shot OOD split of TestSetB", default_seed=1)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    import torch

    from jcf_tpu_torch.pipelines import run_ood_split
    from jcf_tpu_torch.utils import set_random_seed

    if args.device == "cuda":
        # f32 products in f32 (the engines refuse TF32, cuDNN's included),
        # bf16 products with f32 sums (ops.layers.linear refuses the
        # reduced-precision reduction)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    set_random_seed(args.seed)
    return run_ood_split(config_from_args(args), device=args.device, timer=timer)


if __name__ == "__main__":
    main()
