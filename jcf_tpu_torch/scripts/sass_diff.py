"""Compares the SASS of one ``csrc`` source in two checkouts, kernel by
kernel, on a host with ``nvcc`` and ``cuobjdump``.

    python3 jcf_tpu_torch/scripts/sass_diff.py ROOT int8_gemm.cu [--ptxas]

``ROOT`` is the other checkout (a ``git archive`` under the git-ignored
``build/``); the source is compiled from both with the package's
``_build.NVCC_FLAGS`` into ``build/sass_diff/``. Each kernel's instructions
(``cuobjdump -sass``, addresses and encodings dropped) are held against
the other checkout's kernels: a kernel is "same" where the other object
has a kernel with the very same instructions, so names that differ by the
anonymous namespace's hash do not matter. With ``--ptxas`` the script also
prints ``-Xptxas -v``'s lines for this checkout's build (registers, shared
memory, spills, and any note that wgmma instructions were serialized).
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from jcf_tpu_torch import _build  # noqa: E402

_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")


def compile_object(root: str, name: str, out: str, extra=()) -> str:
    """``root``'s ``jcf_tpu_torch/csrc/<name>`` -> an object at ``out``;
    returns nvcc's output."""
    csrc = os.path.join(os.path.abspath(root), "jcf_tpu_torch", "csrc")
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, *extra, "-c", "-I", csrc, "-o", out,
           os.path.join(csrc, name)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout + proc.stderr


def kernels(obj: str) -> dict:
    """{kernel name: tuple of its SASS instructions} of an object."""
    cuobjdump = os.path.join(_build.cuda_home(), "bin", "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", obj], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            out[name] = []
        elif name is not None:
            m = _INSN.search(line)
            if m:
                out[name].append(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root", help="the other checkout")
    ap.add_argument("source", help="a file of jcf_tpu_torch/csrc, e.g. int8_gemm.cu")
    ap.add_argument("--ptxas", action="store_true", help="print -Xptxas -v for this checkout")
    args = ap.parse_args(argv)
    out_dir = os.path.join(ROOT, "build", "sass_diff")
    os.makedirs(out_dir, exist_ok=True)
    base = os.path.splitext(args.source)[0]
    mine, other = os.path.join(out_dir, f"{base}.tree.o"), os.path.join(out_dir, f"{base}.other.o")
    log = compile_object(ROOT, args.source, mine, ["-Xptxas", "-v"] if args.ptxas else [])
    if args.ptxas:
        for line in log.splitlines():
            if "ptxas" in line:
                print(line)
    compile_object(args.root, args.source, other)
    a, b = kernels(mine), kernels(other)
    pool = collections.Counter(b.values())
    same = 0
    for name, body in sorted(a.items()):
        hit = pool[body] > 0
        if hit:
            pool[body] -= 1
            same += 1
        print(f"{'same' if hit else 'DIFFERS'}: {name} ({len(body)} instructions)")
    print(f"{args.source}: {same} of {len(a)} kernels compile to the other checkout's SASS "
          f"({len(b)} there)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
