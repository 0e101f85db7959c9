"""Profile a window of serve steps of the port on one CUDA card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        --arch dit-xl2 --warmup 20 --window 10 --out build/profile_serve.json

Serves ``launch.serve_diffusion.Workload`` (the serve ``chip_smoke.py``
measures) for ``--arch`` and ``--policy``, lets ``--warmup`` engine steps
pass, then records ``--window`` engine steps with ``torch.profiler`` (CPU
and CUDA).  Reports the wall time per step, the device busy share (union
of kernel intervals over the window's wall time), the host syncs in the
window, and the kernels by total device time, with the card's
``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import DIT_IDS
from repro_torch.core.policies.base import registered_policies
from repro_torch.launch.serve_diffusion import Workload
from repro_torch.serving.scheduler import RequestQueue


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=Workload.arch, choices=DIT_IDS)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--window", type=int, default=10)
    ap.add_argument("--policy", default=Workload.policy,
                    choices=registered_policies())
    ap.add_argument("--out", default="build/profile_serve.json")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    wl = Workload(arch=args.arch, policy=args.policy)
    model = wl.build_model("cuda")
    dev = model.device
    runner, eng = wl.build_engine(model)
    queue = RequestQueue(wl.build_trace(model))

    # eng.run stops at the clock given and resumes from the queue's rest
    eng.run(queue, max_engine_steps=args.warmup)
    torch.cuda.synchronize(dev)
    syncs0 = runner.impl.host_syncs + eng.host_syncs
    kinds0 = dict(getattr(runner.impl, "step_kinds", {}))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(queue, max_engine_steps=args.warmup + args.window)
        torch.cuda.synchronize(dev)
        wall_s = time.perf_counter() - t0
    window = eng.clock - args.warmup        # fewer if the trace ran out
    syncs = runner.impl.host_syncs + eng.host_syncs - syncs0
    kinds = {k: v - kinds0[k]
             for k, v in getattr(runner.impl, "step_kinds", {}).items()}

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    busy_us = _busy_us((e.time_range.start, e.time_range.end)
                       for e in kernels)
    total_kernel_us = sum(v[0] for v in by_name.values())
    gate_us = sum(v[0] for k, v in by_name.items()
                  if "gate_gemm" in k or "gate_partials" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    report = {
        "card": card, "arch": model.cfg.name, "policy": args.policy,
        "window_engine_steps": window,
        "step_kinds": kinds, "wall_s": wall_s,
        "ms_per_engine_step": wall_s / window * 1e3,
        "device_busy_share": busy_us / (wall_s * 1e6),
        "kernel_launches": len(kernels),
        "kernel_ms_total": total_kernel_us / 1e3,
        "fused_gate_ms": gate_us / 1e3,
        "host_syncs": syncs,
        "top_kernels": [{"name": k[:120], "ms": v[0] / 1e3, "calls": v[1]}
                        for k, v in top],
    }
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(json.dumps({k: v for k, v in report.items() if k != "top_kernels"}))
    for row in report["top_kernels"]:
        print(json.dumps(row))


if __name__ == "__main__":
    main()
