"""The shared argparse -> ``PipelineConfig`` builder of
``jcf_tpu/cli/_args.py``: the same flags and defaults, ``--perf`` for the
throughput preset."""

from __future__ import annotations

import argparse
import dataclasses

from jcf_tpu_torch.config import PipelineConfig, perf_preset


def build_parser(description: str, default_seed: int) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--seed", type=int, default=default_seed)
    p.add_argument("--root_path", type=str, default="Dataset")
    p.add_argument("--shots", type=int, default=4)
    p.add_argument("--backbone", type=str, default="ViT-B/32")
    p.add_argument("--clip_checkpoint", type=str, default="ViT-B-32.pkl")
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--batch_size", type=int, default=None)
    # LoRA flags (ood.py:698-706)
    p.add_argument("--position", type=str, default="all",
                   choices=["bottom", "mid", "up", "half-up", "half-bottom", "all", "top3"])
    p.add_argument("--encoder", type=str, choices=["text", "vision", "both"], default="both")
    p.add_argument("--params", type=str, nargs="+", default=["q", "k", "v"])
    p.add_argument("--r", type=int, default=4)
    p.add_argument("--alpha", type=float, default=1)
    p.add_argument("--dropout_rate", type=float, default=0.25)
    # None tells an explicit value from the default: a flag given wins
    # over the --perf preset
    p.add_argument("--n_views", type=int, default=None,
                   help="TTA crop count (reference default: 512; perf preset: 8)")
    p.add_argument("--batch_images", type=int, default=None)
    p.add_argument("--dtype", type=str, choices=["float32", "bfloat16"], default="float32")
    # accepted for the JAX CLI's flag; only None is served (one attention
    # route on the card)
    p.add_argument("--attention_impl", type=str, default=None,
                   choices=[None, "pallas", "xla"], nargs="?")
    p.add_argument("--perf", action="store_true", help="use the throughput preset")
    return p


def config_from_args(args: argparse.Namespace) -> PipelineConfig:
    perf = getattr(args, "perf", False)
    cfg = perf_preset() if perf else PipelineConfig()
    root = args.root_path
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(
            cfg.data, root=root, classes_file=f"{root}/classes.txt",
            train_split=f"{root}/train.txt", val_split=f"{root}/valid1.txt",
            test_dir=f"{root}/TestSetB", shots=args.shots,
        ),
        lora=dataclasses.replace(
            cfg.lora, r=args.r, alpha=args.alpha, dropout_rate=args.dropout_rate,
            params=tuple(args.params), encoder=args.encoder, position=args.position,
            backbone=args.backbone,
        ),
        tta=dataclasses.replace(
            cfg.tta,
            n_views=args.n_views if args.n_views is not None else cfg.tta.n_views,
            batch_images=(args.batch_images if args.batch_images is not None
                          else cfg.tta.batch_images),
        ),
        runtime=dataclasses.replace(
            cfg.runtime, clip_checkpoint=args.clip_checkpoint,
            compute_dtype=cfg.runtime.compute_dtype if perf else args.dtype,
            attention_impl=args.attention_impl,
        ),
        stage1=dataclasses.replace(cfg.stage1, seed=args.seed, lr=args.lr,
                                   batch_size=args.batch_size or cfg.stage1.batch_size),
        stage2=dataclasses.replace(cfg.stage2, lr=args.lr,
                                   batch_size=args.batch_size or cfg.stage2.batch_size),
    )
