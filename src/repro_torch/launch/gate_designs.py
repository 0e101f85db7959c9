"""Where ``fused_gate``'s GEMM sets the block-skip IF node's condition, and
what that costs B1 where no handle is passed, on one CUDA card.

    PYTHONPATH=src python -m repro_torch.launch.gate_designs \\
        [--out build/gate_designs.json]

Each design is ``csrc/fused_gate.cu`` with its condition code rewritten
(below), built with the port's nvcc flags into ``build/gate_designs/``;
the port's own wrapper (``fused_gate._launch``) runs each in turn, with no
handle, on every route (simt, wgmma, wgmma_split) at (8, C, 1152), C = 128
and 64, bf16, half the samples gating.  Every design must give the kept
design's outputs bit for bit.  Four rounds, the designs' order rotated each
round; device microseconds a call behind a spin (``saliency_designs``).

- ``kept``: the source as it is: the condition code (a warp vote, lane 0
  setting the handle) only in the GEMM kernels' ``kSetCond`` instances,
  so a launch with no handle runs none of it;
- ``warp_vote``: that code in every instance, skipped at run time when no
  handle is passed (this design's first form);
- ``barrier_vote``: the lanes vote through the block's first barrier
  (``__syncthreads_and``) and thread 32 sets the handle, in every instance;
- ``no_set_call``: ``barrier_vote`` without the ``cudaGraphSetConditional``
  call;
- ``no_condition``: no condition code at all: the GEMM as it was before it
  set a condition.

Beside the times: each design's GEMM kernels' SASS, counted by opcode
(``cuobjdump -sass``), the whole listing in ``build/gate_designs/``.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import statistics
import subprocess
from pathlib import Path

import torch

from repro_torch.core import statcache
from repro_torch.core.linear_approx import split_copies
from repro_torch.cuda_kernels import build, route
from repro_torch.cuda_kernels import fused_gate as fg_mod
from repro_torch.launch.saliency_designs import device_us

OUT_DIR = build.BUILD_DIR.parent / "gate_designs"
SHAPES = ((8, 128, 1152), (8, 64, 1152))
ROUNDS = 4
OPCODES = ("BAR", "BSSY", "BSYNC", "WARPSYNC", "VOTE", "CALL", "EXIT", "RET",
           "MEMBAR", "ATOM", "RED")

_GUARDED = ("  if constexpr (kSetCond)\n"
            "    set_skip_condition(cond, set_cond, sigma2, eligible, "
            "partials, n_parts,\n                       thr, nd);\n")
_VOTE = ("  const int all = __syncthreads_and(\n"
         "      skip_vote(set_cond, sigma2, eligible, partials, n_parts, thr, "
         "nd));\n")
_SET = ("  if (sets_condition(set_cond)) "
        "cudaGraphSetConditional(cond, all ? 0u : 1u);\n")
_KERNELS = ("template <typename T, bool kSetCond>\n__global__ void "
            "__launch_bounds__(kGemmThreads)")
_BARRIER_VOTE_FNS = """\
__device__ __forceinline__ bool sets_condition(int set_cond) {
  return set_cond && threadIdx.x == 32 && blockIdx.x == 0 && blockIdx.y == 0 &&
         blockIdx.z == 0;
}

__device__ __forceinline__ int skip_vote(
    int set_cond, const float* __restrict__ sigma2,
    const uint8_t* __restrict__ eligible, const float* __restrict__ partials,
    int n_parts, float thr, float nd) {
  if (!set_cond || threadIdx.x / 32 != 1 || blockIdx.x != 0 ||
      blockIdx.y != 0 || blockIdx.z != 0)
    return 1;
  int all = 1;
  for (int b = threadIdx.x % 32; b < (int)gridDim.z; b += 32)
    all &= gate_of(sample_diff(partials, n_parts, b), sigma2[b], eligible[b],
                   thr, nd);
  return all;
}

"""


def _replace(src: str, old: str, new: str, count: int) -> str:
    if src.count(old) != count:
        raise RuntimeError(f"fused_gate.cu: expected {count} of {old!r}, "
                           f"found {src.count(old)}")
    return src.replace(old, new)


def design_sources() -> dict:
    """name -> the design's source (see the module docstring)."""
    kept = (build.CSRC / "fused_gate.cu").read_text()
    barrier = _replace(kept, _GUARDED + "  __syncthreads();\n",
                       _VOTE + _SET, 2)
    barrier = _replace(barrier, _KERNELS, _BARRIER_VOTE_FNS + _KERNELS, 1)
    return {"kept": kept,
            "warp_vote": _replace(kept, "if constexpr (kSetCond)",
                                  "if constexpr (true)", 2),
            "barrier_vote": barrier,
            "no_set_call": _replace(barrier, _SET, "  (void)all;\n", 2),
            "no_condition": _replace(kept, _GUARDED, "", 2)}


def build_designs(sources: dict) -> dict:
    """Build every design at once; name -> (BuiltLibrary, ptxas lines)."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(src)
        so = OUT_DIR / f"lib{name}.so"
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for design {name}:\n{log}")
        built[name] = (build.BuiltLibrary("fused_gate", so,
                                          ctypes.CDLL(str(so)), log, 0.0),
                       build.ptxas_lines(log))
    return built


def sass_counts(so: Path, name: str) -> dict:
    """The GEMM kernels' SASS of library ``so``: instructions and the
    OPCODES' counts by kernel; the listing goes to OUT_DIR/<name>.sass."""
    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    (OUT_DIR / f"{name}.sass").write_text(text)
    out, kernel = {}, None
    for line in text.splitlines():
        head = re.match(r"\s*Function : (\S+)", line)
        if head:
            kernel = head.group(1) if "gate_gemm" in head.group(1) else None
            if kernel:
                out[kernel] = collections.Counter()
            continue
        op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                      line)
        if kernel and op:
            out[kernel]["instructions"] += 1
            base = op.group(1).split(".")[0]
            if base in OPCODES:
                out[kernel][base] += 1
    return {k: dict(v) for k, v in out.items()}


def inputs(b: int, c: int, d: int, dev: torch.device) -> dict:
    """chip_smoke.py's B1 inputs: even samples gate, every sample
    eligible; W near the identity, its bf16 and split copies."""
    gen = torch.Generator(dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    bf16 = torch.bfloat16
    x = randn(b, c, d).to(bf16)
    prev = (x.float() + randn(b, c, d, scale=0.01)).to(bf16)
    po = randn(b, c, d).to(bf16)
    w = torch.eye(d, device=dev) + randn(d, d, scale=0.01)
    nd = c * d
    thr = statcache.make_threshold(0.05, nd)
    diff64 = (x.double() - prev.double()).square().sum(dim=(1, 2))
    factor = torch.tensor([2.0, 0.5] * (b // 2), device=dev,
                          dtype=torch.float64)
    sigma2 = (diff64 / (nd * thr) * factor).float()
    return {"args": (x, prev, po, w, randn(d, scale=0.1), sigma2,
                     torch.ones(b, dtype=torch.bool, device=dev)),
            "thr": thr, "copies": {route.SIMT: None,
                                   route.WGMMA: w.to(bf16),
                                   route.WGMMA_SPLIT:
                                       split_copies(w, bf16, dev)[0]}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gate_designs needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    built = build_designs(design_sources())
    names = list(built)
    report = {"card": card, "designs": {
        n: {"ptxas": p, "sass": sass_counts(lib.path, n)}
        for n, (lib, p) in built.items()}}
    cases = [(shape, which) for shape in SHAPES
             for which in (route.SIMT, route.WGMMA, route.WGMMA_SPLIT)]
    data = {shape: inputs(*shape, dev) for shape in SHAPES}
    times = collections.defaultdict(list)
    kept_out = {}
    for r in range(ROUNDS):
        for name in names[r % len(names):] + names[:r % len(names)]:
            build._LOADED["fused_gate"] = built[name][0]
            for shape, which in cases:
                inp = data[shape]

                def call(inp=inp, which=which):
                    return fg_mod._launch(which, *inp["args"], inp["thr"],
                                          0.5, True, inp["copies"][which])

                got = call()
                torch.cuda.synchronize()
                want = kept_out.setdefault((shape, which), got)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"design {name} at {shape} on "
                                         f"{which} differs from the kept "
                                         f"design's outputs")
                times[(name, shape[1], which)].append(device_us(call))
    build._LOADED.pop("fused_gate", None)
    report["device_us"] = [
        {"design": n, "c": c, "route": w, "median": statistics.median(v),
         "runs": v} for (n, c, w), v in times.items()]
    for row in report["device_us"]:
        print(json.dumps(row), flush=True)
    print(json.dumps({"card": card, "sass": {
        n: report["designs"][n]["sass"] for n in names}}), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
