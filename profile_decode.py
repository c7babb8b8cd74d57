#!/usr/bin/env python3
"""Times the port's image decode on one NVIDIA GPU: ``decode_batch`` on
the committed JPEG fixtures, and ``jcf-ood --perf`` (the throughput path,
which decodes the next batch in a second thread while the card serves the
current one) end to end.

    python3 profile_decode.py [ROOT]   # from the repository root

``decode_batch``: the six fixtures of ``tests/fixtures/jpeg`` x 20 at
256², one thread, img/s (two passes; the second is warm). ``--perf``:
``cli.ood.main`` on a TestSetB of the fixtures repeated to 1024 images,
403 synthetic classes and the seed-0 ViT-B/32 checkpoint (written through
``models.loader.state_dict_from_params``), twice: img/s end to end, in the
serving loop, and the loop's share spent in ``decode_wait``. Prints the
card's name and power limit on every line. ``ROOT`` (default: this
script's directory) is the checkout whose ``jcf_tpu_torch`` and
``chip_smoke.py`` helpers run: to compare two builds, run it on both
checkouts on the same card, alternating (A, B, B, A).
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PERF_IMAGES = 1024


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else ROOT
    sys.path.insert(0, root)
    import chip_smoke as cs
    from jcf_tpu_torch import _build
    from jcf_tpu_torch.cli import ood as cli
    from jcf_tpu_torch.data import decode as dec
    from jcf_tpu_torch.models.clip import VIT_B_32, init_clip_params
    from jcf_tpu_torch.models.loader import state_dict_from_params
    from jcf_tpu_torch.utils import Timer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip()
    t0 = time.perf_counter()
    _build.load()
    print(f"[{root}] kernels built in {time.perf_counter() - t0:.1f} s on {smi}", flush=True)
    dev = torch.device("cuda", 0)
    paths = cs.fixture_paths() * 20
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec.decode_batch(paths, device=dev)
        torch.cuda.synchronize()
        print(f"[{root}] decode_batch {len(paths) / (time.perf_counter() - t0):.2f} img/s on "
              f"{smi}", flush=True)
    params = init_clip_params(0, VIT_B_32)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        ds = cs.ood_dataset(os.path.join(tmp, "Dataset"), PERF_IMAGES)
        ckpt = os.path.join(tmp, "ViT-B-32.pkl")
        with open(ckpt, "wb") as f:
            pickle.dump(state_dict_from_params(params, VIT_B_32), f)
        os.chdir(tmp)  # the CLI writes its templates and classifier cache here
        try:
            for rep in range(2):
                timer = Timer()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = cli.main(["--root_path", ds, "--clip_checkpoint", ckpt, "--perf",
                                "--device", "cuda"], timer=timer)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                summ = timer.summary()
                wait, busy = summ["decode_wait"]["total_s"], summ["tta_batch"]["total_s"]
                print(f"[{root}] --perf run {rep}: {PERF_IMAGES / wall:.2f} img/s end to end, "
                      f"loop {PERF_IMAGES / (wait + busy):.2f} img/s, decode_wait {wait:.3f} s "
                      f"({wait / (wait + busy):.3f} of the loop), {out['n_base']} base / "
                      f"{out['n_new']} new, on {smi}", flush=True)
        finally:
            os.chdir(cwd)
    return 0


if __name__ == "__main__":
    sys.exit(main())
