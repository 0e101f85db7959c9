"""Profile a window of serve steps of the port on one CUDA card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        --arch dit-xl2 --warmup 20 --window 10 --out build/profile_serve.json

Serves ``launch.serve_diffusion.Workload`` (the serve ``chip_smoke.py``
measures) for ``--arch``, ``--policy`` and the token-merge flags, lets
``--warmup`` engine steps pass, then records ``--window`` engine steps with
``torch.profiler`` (CPU and CUDA).  Reports the wall time per step, the
device busy share (union of kernel intervals over the window's wall time),
the host syncs in the window, the device time of each of the port's DiT
kernels, and the kernels by total device time, with the card's
``nvidia-smi`` name and power limit.  A wrapper's device time is the sum
over the CUDA kernels whose names hold one of its fragments
(``KERNEL_NAMES``: both routes of ``fused_gate``, ``linear_blend``,
``knn_density`` and ``merge_assign``); a
wrapper whose launch count moved in the window while no device time was
attributed to it raises, so a renamed kernel never reads as 0 ms.
``--no-metrics`` serves with the device metrics plane off (on by default,
as in the engine), and ``--audit-fraction`` turns the audit plane on, so
two runs give the planes' launches and time per step.  ``--fit-maps``
serves fitted maps (``calibrate_dit``), whose calls run on the wgmma_split
route (W split into three bf16 terms), in place of the identity maps, whose
calls run on wgmma; ``--simt-maps`` names the SIMT route (the f32 W) for
every call on the maps, a yardstick.
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
from repro_torch.core.linear_approx import calibrate_dit
from repro_torch.core.policies.base import registered_policies
from repro_torch.cuda_kernels.fused_gate import fused_gate
from repro_torch.cuda_kernels.knn_density import knn_density
from repro_torch.cuda_kernels.linear_blend import linear_blend
from repro_torch.cuda_kernels.saliency_delta import saliency_delta
from repro_torch.cuda_kernels.token_merge import (merge_assign,
                                                  unmerge_scatter)
from repro_torch.launch.calibrate import fit_batches
from repro_torch.launch.serve_diffusion import (Workload, add_merge_args,
                                                check_merge_args)
from repro_torch.serving.scheduler import RequestQueue


# each DiT wrapper and the name fragments of the CUDA kernels it launches
# (csrc/*.cu); each fragment matches both routes' kernels: gate_gemm /
# gate_gemm_wgmma, linear_blend_kernel{,_wgmma}, knn_density_kernel{,_mma},
# merge_assign_kernel{,_mma}; saliency_delta's SIMT route launches row_sums
# and sample_totals, its onepass route saliency_delta_onepass
KERNEL_NAMES = {
    "fused_gate": (fused_gate, ("gate_partials", "gate_gemm")),
    "linear_blend": (linear_blend, ("linear_blend_kernel",)),
    "saliency_delta": (saliency_delta, ("row_sums", "sample_totals",
                                        "saliency_delta_onepass")),
    "knn_density": (knn_density, ("knn_density_kernel",)),
    "merge_assign": (merge_assign, ("merge_assign_kernel",)),
    "unmerge_scatter": (unmerge_scatter, ("unmerge_scatter_kernel",)),
}


def attribute(by_name, moved):
    """Device ms and calls per wrapper from ``by_name`` (kernel name ->
    [us, calls]); raises for a wrapper in ``moved`` (its launch count rose
    in the window) that no kernel's time was attributed to."""
    out = {}
    for key, (_, frags) in KERNEL_NAMES.items():
        hits = [v for k, v in by_name.items() if any(f in k for f in frags)]
        us = sum(v[0] for v in hits)
        if moved.get(key, 0) and not us > 0:
            raise RuntimeError(
                f"{key} launched {moved[key]} times in the window but no "
                f"device time was attributed to it: no CUDA kernel name "
                f"holds any of {frags}")
        out[key] = {"ms": us / 1e3, "kernel_calls": sum(v[1] for v in hits),
                    "launches": moved.get(key, 0)}
    return out


def _counts():
    counts = {k: fn.launches for k, (fn, _) in KERNEL_NAMES.items()}
    for k, (fn, _) in KERNEL_NAMES.items():
        for r, n in getattr(fn, "launches_by_route", {}).items():
            counts[f"{k}:{r}"] = n
    return counts


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
    ap.add_argument("--no-metrics", dest="metrics", action="store_false",
                    help="serve with the device metrics plane off")
    ap.add_argument("--audit-fraction", type=float, default=0.0,
                    help="shadow-audit this fraction of serve steps")
    ap.add_argument("--fit-maps", action="store_true",
                    help="serve the maps calibrate_dit fits on 4 batches "
                         "of 8 random latents (seed 0) in place of the "
                         "identity maps (their calls take the wgmma_split "
                         "route)")
    ap.add_argument("--simt-maps", action="store_true",
                    help="every call on the maps names the SIMT route (the "
                         "f32 W), a yardstick (default: the wrappers' rule)")
    add_merge_args(ap)
    args = check_merge_args(ap.parse_args(argv))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    wl = Workload(arch=args.arch, policy=args.policy,
                  merge_ratio=args.merge_ratio,
                  merge_window=args.merge_window,
                  audit_fraction=args.audit_fraction)
    model = wl.build_model("cuda")
    dev = model.device
    fitted = ({"fc_params": calibrate_dit(model, fit_batches(model))}
              if args.fit_maps else {})
    runner, eng = wl.build_engine(model, enable_metrics=args.metrics,
                                  simt_maps=args.simt_maps, **fitted)
    queue = RequestQueue(wl.build_trace(model))

    # eng.run stops at the clock given and resumes from the queue's rest
    eng.run(queue, max_engine_steps=args.warmup)
    torch.cuda.synchronize(dev)
    syncs0 = runner.impl.host_syncs + eng.host_syncs
    audited0 = eng.audited_steps
    kinds0 = dict(getattr(runner.impl, "step_kinds", {}))
    counts0 = _counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(queue, max_engine_steps=args.warmup + args.window)
        torch.cuda.synchronize(dev)
        wall_s = time.perf_counter() - t0
    window = eng.clock - args.warmup        # fewer if the trace ran out
    syncs = runner.impl.host_syncs + eng.host_syncs - syncs0
    moved = {k: n - counts0[k] for k, n in _counts().items()}
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
    ours = attribute(by_name, moved)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    report = {
        "card": card, "arch": model.cfg.name, "policy": args.policy,
        "token_merge": {"ratio": wl.merge_ratio, "window": wl.merge_window,
                        "active": runner.reducer is not None},
        "metrics_plane": args.metrics,
        "audit_fraction": args.audit_fraction, "fit_maps": args.fit_maps,
        "simt_maps": args.simt_maps,
        "audited_steps": eng.audited_steps - audited0,
        "window_engine_steps": window,
        "kernel_launches_per_engine_step": len(kernels) / window,
        "step_kinds": kinds, "wall_s": wall_s,
        "ms_per_engine_step": wall_s / window * 1e3,
        "device_busy_share": busy_us / (wall_s * 1e6),
        "kernel_launches": len(kernels),
        "kernel_ms_total": total_kernel_us / 1e3,
        "fused_gate_ms": ours["fused_gate"]["ms"],
        "token_merge_kernels_ms": sum(ours[k]["ms"] for k in (
            "knn_density", "merge_assign", "unmerge_scatter")),
        "saliency_delta_ms": ours["saliency_delta"]["ms"],
        "linear_blend_ms": ours["linear_blend"]["ms"],
        "fused_gate_share_of_kernel_time": (ours["fused_gate"]["ms"] * 1e3
                                            / total_kernel_us),
        "share_of_kernel_time": {k: v["ms"] * 1e3 / total_kernel_us
                                 for k, v in ours.items()},
        "port_kernels": ours,
        "window_launches": moved,
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
