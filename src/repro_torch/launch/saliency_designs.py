"""The designs of ``saliency_delta``'s one-launch route on one CUDA card.

    PYTHONPATH=src python -m repro_torch.launch.saliency_designs \\
        [--out build/saliency_designs.json]

At the calls of the fastcache serve, (8, 256, 1152) bf16, and of the merged
serve, (8, 128, 1152), each design (``csrc/saliency_designs.cu``) runs
against the SIMT route, must give its bits, and is timed on the device: back
to back (``device_us``), and each call right after a PyTorch kernel, as in a
serve (``after_op_us``: the pair's time less the PyTorch kernel's alone).
At N = 1024, past the rows the route rule sends to onepass
(``route.SAL_MAX_ONEPASS_ROWS``), only the two routes run.

- ``simt``: the two-launch route;
- ``onepass``: the kept route, launched with programmatic stream
  serialization, and ``onepass_no_pdl`` without;
- ``launch_only``: the onepass route's grid of blocks that do nothing but
  wait for the kernel before them (not compared: what a launch costs);
- ``onepass_bulk``: the onepass kernel with each warp's rows bulk-copied
  into shared memory first;
- ``cluster_G``: G blocks a sample in a thread-block cluster, consecutive
  rows bulk-copied into shared memory, the totals added by rank 0 from the
  cluster's shared memory; with the clusters the card holds at once and
  the SMs the blocks landed on.
"""
from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import torch

from repro_torch.cuda_kernels import build, ref, route
from repro_torch.cuda_kernels import saliency_delta as sal_mod

SHAPES = ((8, 256, 1152), (8, 128, 1152), (8, 1024, 1152), (1, 1024, 1152))
CLUSTER_SIZES = (16, 8, 4)
SPIN_CYCLES = 4_000_000
_vp, _int = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = build.load_library("saliency_designs").lib
    lib.designs_onepass_launch.argtypes = [_vp] * 6 + [_int] * 4 + [_vp]
    lib.designs_empty_launch.argtypes = [_int, _vp]
    lib.designs_bulk_launch.argtypes = [_vp] * 6 + [_int] * 3 + [_vp]
    lib.designs_cluster_launch.argtypes = [_vp] * 6 + [_int] * 4 + [_vp]
    lib.designs_cluster_max_active.argtypes = [_int] * 3 + [
        ctypes.POINTER(_int)]
    return lib


def device_us(fn, iters: int = 20, attempts: int = 4) -> float:
    """Device time per call: ``iters`` calls queued behind a spin kernel
    between two CUDA events, counted only if the host stayed ahead of the
    card (as ``chip_smoke.py:device_ms``)."""
    fn()
    torch.cuda.synchronize()
    cycles = SPIN_CYCLES
    for _ in range(attempts):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters * 1e3
        cycles *= 4
        iters = max(1, iters // 2)
    raise RuntimeError("the host fell behind the card")


def _designs(lib, x, prev):
    """name -> (call, extra facts) for every design at x's shape."""
    b, n, d = x.shape
    out = torch.empty(b * n + 2 * b + 2 * route.SAL_GROUPS * b,
                      dtype=torch.float32, device=x.device)
    sal, diff = out[:b * n], out[b * n:b * n + b]
    prevsq, part = out[b * n + b:b * n + 2 * b], out[b * n + 2 * b:]
    ptrs = [x.data_ptr(), prev.data_ptr(), sal.data_ptr(), diff.data_ptr(),
            prevsq.data_ptr()]
    stream = torch.cuda.current_stream().cuda_stream
    results = (sal.view(b, n), diff, prevsq)

    def check(err):
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return results

    designs = {
        "launch_only": (lambda: check(lib.designs_empty_launch(b, stream)),
                        None),
        "simt": (lambda: sal_mod._launch("simt", x, prev), {}),
        "onepass": (lambda: sal_mod._launch("onepass", x, prev), {}),
        "onepass_no_pdl": (lambda: check(lib.designs_onepass_launch(
            *ptrs, part.data_ptr(), b, n, d, 0, stream)), {}),
        "onepass_bulk": (lambda: check(lib.designs_bulk_launch(
            *ptrs, part.data_ptr(), b, n, d, stream)), {})}
    for g in CLUSTER_SIZES:
        sm = torch.full((b * g,), -1, dtype=torch.int32, device=x.device)
        active = _int(0)
        err = lib.designs_cluster_max_active(n, d, g, ctypes.byref(active))
        if err != 0:
            raise RuntimeError(f"cudaOccupancyMaxActiveClusters: {err}")

        def run(g=g, sm=sm):
            return check(lib.designs_cluster_launch(
                *ptrs, sm.data_ptr(), b, n, d, g, stream))

        run()
        torch.cuda.synchronize()
        per_sm = torch.bincount(sm.long())
        designs[f"cluster_{g}"] = (run, {
            "max_active_clusters": active.value,
            "sms_used": int((per_sm > 0).sum()),
            "max_blocks_per_sm": int(per_sm.max())})
    return designs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("saliency_designs needs a CUDA card")
    lib = _lib()
    dev = torch.device("cuda")
    other = torch.randn((8, 256, 1152), device=dev).to(torch.bfloat16)

    def pre():                 # a PyTorch kernel before each call
        other.mul_(1.0)

    rows = []
    for i, shape in enumerate(SHAPES):
        gen = torch.Generator(dev).manual_seed(6 + i)
        x = torch.randn(shape, generator=gen, device=dev)
        prev = (x + 0.1 * torch.randn(shape, generator=gen, device=dev)
                ).to(torch.bfloat16)
        x = x.to(torch.bfloat16)
        want = [t.clone() for t in sal_mod._launch("simt", x, prev)]
        plain = ref.saliency_delta(x, prev)
        pre_us = device_us(pre)
        designs = _designs(lib, x, prev)
        if shape[1] > route.SAL_MAX_ONEPASS_ROWS:
            designs = {k: designs[k] for k in ("simt", "onepass")}
        for name, (fn, facts) in designs.items():
            compared = facts is not None
            if compared:
                got = fn()
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"{name} at {shape} differs from "
                                         f"the SIMT route")
                for g, w in zip(got, plain):
                    torch.testing.assert_close(g, w, rtol=1e-5, atol=0)
            row = {"design": name, "shape": list(shape), "dtype": "bfloat16",
                   "bitwise_equal_to_simt": True if compared else None,
                   "device_us": device_us(fn),
                   "after_op_us": device_us(lambda: (pre(), fn())) - pre_us,
                   **(facts or {})}
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({
            "device": torch.cuda.get_device_name(0), "rows": rows},
            indent=1))


if __name__ == "__main__":
    main()
