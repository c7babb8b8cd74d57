"""Times K9b in f32 (``block_f32``) built from several sources in one
process on one NVIDIA GPU, to tell what the kernel's work costs from what
the compiled code costs.

    python3 jcf_tpu_torch/scripts/probe_block_f32_build.py PARENT

``PARENT`` is a checkout whose K9b splits the weights into their TF32
planes in the launch's first phase (e50d747, unpacked with ``git archive``
under the git-ignored ``build/``). Each build is one ``csrc/block_float.cu``
compiled alone with ``_build.NVCC_FLAGS`` into ``build/probe_block_f32/``
and called through its C entry on the same rows and scratch:
- A: the parent's source: the split phase into a scratch, then the GEMMs
  read the scratch;
- B: this checkout's: the GEMMs read the tree's planes, nothing is split;
- P0-P3: B with the parent's split phase compiled in behind a run-time
  mode: 0 skips it (B's work in a build that holds A's code), 1 splits
  into a scratch the GEMMs do not read, 2 runs only its grid barrier, 3
  splits into the scratch and the GEMMs read it (A's work);
- E: B with the f32 consumer's stage release made by ``elect.sync`` (no
  lane index in the k loop).
It prints ptxas's registers and spills for each f32 kernel, its SASS
reads of ``SR_TID.X`` and local loads (``LDL``), then, at the classifier
build's text shape (512 x 77 x 512, causal) and ``jcf-ood``'s vision shape
(4104 x 50 x 768), each output's SHA-256 and its median ms in a CUDA graph
(``--rounds`` x ``--reps``) in the turns A B P0 P1 P2 P3 E E P3 P2 P1 P0
B A.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import math
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from jcf_tpu_torch import _build  # noqa: E402

SHAPES = ((512, 77, 512, True), (4104, 50, 768, False))
TURNS = ("A", "B", "P0", "P1", "P2", "P3", "E", "E", "P3", "P2", "P1", "P0", "B", "A")
_KERNEL = "block_float_kernelIfE"

# the probe build's entry: mode, the rows and scratch, the twelve layer
# operands (the weights as planes), the four f32 weights the split reads
_PROBE_ENTRY = r'''
extern "C" int jcf_block_float_probe(int mode, const void* x, void* out, void* rows_e,
                                     void* rows_b, void* mid, void* split, void* bar,
                                     const void* const* ops_in, const void* const* w32,
                                     const void* bias, int n_seq, int S, int H, int F, int chunk,
                                     float scale, void* stream) {
  const int E = 64 * H;
  const void* ops[12];
  for (int i = 0; i < 12; ++i) ops[i] = ops_in[i];
  if (mode == 3) {  // the GEMMs read the scratch, the parent's layout
    const long long n[4] = {3LL * E * E, (long long)E * E, (long long)F * E, (long long)E * F};
    const int at[4] = {2, 4, 8, 10};
    long long off = 0;
    for (int i = 0; i < 4; ++i) {
      ops[at[i]] = static_cast<float*>(split) + off;
      off += 2 * n[i];
    }
  }
  Params<float> p;
  p.x = static_cast<const float*>(x);
  p.out = static_cast<float*>(out);
  p.rows_e = static_cast<float*>(rows_e);
  p.rows_b = static_cast<float*>(rows_b);
  p.mid = static_cast<float*>(mid);
  p.ln1_s = static_cast<const float*>(ops[0]);
  p.ln1_b = static_cast<const float*>(ops[1]);
  p.b_qkv = static_cast<const float*>(ops[3]);
  p.b_out = static_cast<const float*>(ops[5]);
  p.ln2_s = static_cast<const float*>(ops[6]);
  p.ln2_b = static_cast<const float*>(ops[7]);
  p.b_fc = static_cast<const float*>(ops[9]);
  p.b_proj = static_cast<const float*>(ops[11]);
  const void* const w[4] = {ops[2], ops[4], ops[8], ops[10]};
  for (int i = 0; i < 4; ++i) p.w32[i] = static_cast<const float*>(w32[i]);
  p.split = static_cast<float*>(split);
  p.mode = mode;
  p.bias = static_cast<const float*>(bias);
  p.bar = static_cast<unsigned*>(bar);
  p.n_seq = n_seq, p.S = S, p.H = H, p.F = F, p.chunk = chunk;
  p.scale = scale;
  return launch<float>(p, w, (cudaStream_t)stream);
}
'''

_ELECT = r'''
__device__ __forceinline__ bool elect_one() {
  uint32_t elected;
  asm volatile("{\n .reg .pred p;\n elect.sync _|p, 0xffffffff;\n selp.u32 %0, 1, 0, p;\n}\n"
               : "=r"(elected));
  return elected != 0;
}
'''


def _replace_once(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"the source no longer holds exactly one {old.strip()[:60]!r}")
    return src.replace(old, new)


def probe_source(tree: str, parent: str) -> str:
    """B's source with the parent's split phase behind ``p.mode``."""
    split_fn = re.search(r"// f32: the four weights' hi and lo planes.*?\n}\n", parent, re.S)
    if split_fn is None:
        raise RuntimeError("the parent's block_float.cu has no split phase")
    src = _replace_once(tree, "  float scale;\n};",
                        "  float scale;\n  const float* w32[4];\n  float* split;\n  int mode;\n};")
    src = _replace_once(src, "template <typename T>\n__global__ void __launch_bounds__",
                        split_fn.group(0) + "\ntemplate <typename T>\n__global__ void "
                        "__launch_bounds__")
    src = _replace_once(src, "  ring_init<R>(full0, empty0);\n", """  ring_init<R>(full0, empty0);
  if constexpr (std::is_same<T, float>::value) {
    if (p.mode == 1 || p.mode == 3) {
      split_phase(p, E);
      grid_sync(p.bar, target);
    } else if (p.mode == 2) {
      grid_sync(p.bar, target);
    }
  }
""")
    return src + _PROBE_ENTRY


def elect_source(tree: str) -> str:
    """B's source with the f32 consumer's stage released by ``elect.sync``."""
    src = _replace_once(tree, "// the consumer warpgroups, f32:", _ELECT +
                        "\n// the consumer warpgroups, f32:")
    return _replace_once(src, "      if (lane == 0) mbar_arrive(empty0 + 8 * rp.stage);",
                         "      if (elect_one()) mbar_arrive(empty0 + 8 * rp.stage);")


def build(sources: dict, out_dir: str) -> dict:
    """{name: source text} -> {name: (library path, ptxas's f32 lines,
    SASS counts)}, one nvcc each, all at once."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src, lib = os.path.join(out_dir, f"{name}.cu"), os.path.join(out_dir, f"{name}.so")
        with open(src, "w") as f:
            f.write(text)
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-shared", "-Xptxas", "-v", "-I", _build.CSRC,
               "-o", lib, src]
        procs[name] = (lib, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True))
    cuobjdump = os.path.join(_build.cuda_home(), "bin", "cuobjdump")
    out = {}
    for name, (lib, cmd, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{log}")
        lines = log.splitlines()
        at = next(i for i, line in enumerate(lines) if "entry function" in line and _KERNEL in line)
        ptxas = [line.split("info    :")[-1].strip() for line in lines[at + 2:at + 4]]
        sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                              check=True).stdout
        body = sass[sass.index(_KERNEL):]
        body = body[:body.find("Function :") if "Function :" in body else len(body)]
        counts = {"SR_TID.X": body.count("SR_TID.X"), "LDL": len(re.findall(r"\bLDL\b", body))}
        out[name] = (lib, ptxas, counts)
    return out


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"_{name}", os.path.join(HERE, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(parent: str, rounds: int = 9, reps: int = 10) -> dict:
    import torch

    from jcf_tpu_torch.ops.attention import causal_mask
    from jcf_tpu_torch.scripts.common import card_line

    ab, abf = _load("ab_gemm"), _load("ab_block_float")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(dev), flush=True)
    with open(os.path.join(_build.CSRC, "block_float.cu")) as f:
        tree = f.read()
    with open(os.path.join(os.path.abspath(parent), "jcf_tpu_torch", "csrc", "block_float.cu")) as f:
        old = f.read()
    built = build({"A": old, "B": tree, "P": probe_source(tree, old), "E": elect_source(tree)},
                  os.path.join(ROOT, "build", "probe_block_f32"))
    for name, (_, ptxas, counts) in built.items():
        print(f"{name}: ptxas {' | '.join(ptxas)}; SASS {counts}", flush=True)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = {name: ctypes.CDLL(lib) for name, (lib, _, _) in built.items()}
    libs["A"].jcf_block_float.argtypes = [I, *[P] * 20, I, I, I, I, I, F, P]
    for name in "BE":
        libs[name].jcf_block_float.argtypes = [I, *[P] * 19, I, I, I, I, I, F, P]
    libs["P"].jcf_block_float_probe.argtypes = [I, *[P] * 10, I, I, I, I, I, F, P]
    res = {}
    for n_seq, s, e, causal in SHAPES:
        hidden, rows = 4 * e, n_seq * s
        layer = abf.with_planes(abf.seeded_layer(e, hidden, dev))
        attn, mlp = layer["attn"], layer["mlp"]
        ops = [layer["ln_1"]["scale"], layer["ln_1"]["bias"], attn["w_qkv"], attn["b_qkv"],
               attn["w_out"], attn["b_out"], layer["ln_2"]["scale"], layer["ln_2"]["bias"],
               mlp["c_fc"]["w"], mlp["c_fc"]["b"], mlp["c_proj"]["w"], mlp["c_proj"]["b"]]
        planes = list(ops)
        planes[2], planes[4] = attn["w_qkv_tf32"], attn["w_out_tf32"]
        planes[8], planes[10] = mlp["c_fc"]["w_tf32"], mlp["c_proj"]["w_tf32"]
        x = torch.randn(rows, e, device=dev, generator=torch.Generator(device=dev).manual_seed(1))
        bias = causal_mask(s, dev) if causal else torch.zeros(s, s, device=dev)
        out = torch.empty_like(x)
        scratch = [torch.empty(rows * e, device=dev), torch.empty(rows * max(3 * e, hidden),
                                                                   device=dev),
                   torch.empty(rows * e, device=dev)]
        split = torch.empty(2 * e * (4 * e + 2 * hidden), device=dev)
        bar = torch.empty(2, dtype=torch.int32, device=dev)
        ops_p = (P * 12)(*[t.data_ptr() for t in planes])
        w32 = (P * 4)(*[ops[i].data_ptr() for i in (2, 4, 8, 10)])
        head = (x.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in scratch))

        def tail():
            return (bias.data_ptr(), n_seq, s, e // 64, hidden, n_seq, 1.0 / math.sqrt(64),
                    torch.cuda.current_stream(dev).cuda_stream)

        def check(err):
            _build.check(err, "block_f32 probe")
            return out

        turns = {
            "A": lambda: check(libs["A"].jcf_block_float(
                1, *head, split.data_ptr(), bar.data_ptr(), *(t.data_ptr() for t in ops), *tail())),
            "B": lambda: check(libs["B"].jcf_block_float(
                1, *head, bar.data_ptr(), *(t.data_ptr() for t in planes), *tail())),
            "E": lambda: check(libs["E"].jcf_block_float(
                1, *head, bar.data_ptr(), *(t.data_ptr() for t in planes), *tail()))}
        for mode in range(4):
            turns[f"P{mode}"] = (lambda m: lambda: check(libs["P"].jcf_block_float_probe(
                m, *head, split.data_ptr(), bar.data_ptr(), ops_p, w32, *tail())))(mode)
        label = f"{n_seq} x {s} x {e}"
        for name in TURNS:
            print(f"{name} {label}: sha256 {ab.digest(turns[name]())}", flush=True)
            res.setdefault((label, name), []).append(
                ab.graph_ms(f"{name} {label}", turns[name], dev, rounds, reps))
        for name in dict.fromkeys(TURNS):
            print(f"{label} {name}: " + " / ".join(f"{t:.4f}" for t in res[(label, name)]) + " ms",
                  flush=True)
        del layer, ops, planes, x, out, scratch, split
        torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", help="checkout whose K9b splits the weights in its first phase")
    ap.add_argument("--rounds", type=int, default=9)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    run(args.parent, args.rounds, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
