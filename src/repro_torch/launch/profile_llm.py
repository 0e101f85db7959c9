"""Profile the LLM serve of the port on one CUDA card: one prefill and a
window of decode steps.

    PYTHONPATH=src python -m repro_torch.launch.profile_llm --fastcache \\
        --warmup 8 --window 8 --out build/profile_llm.json
    PYTHONPATH=src python -m repro_torch.launch.profile_llm --fastcache \\
        --arch arctic-480b --num-layers 2 --out build/profile_arctic.json
    PYTHONPATH=src python -m repro_torch.launch.profile_llm \\
        --arch jamba-v0.1-52b --num-layers 8 --out build/profile_jamba.json

Serves ``launch.serve.LLMWorkload`` (the serve ``chip_smoke.py`` measures)
after its warm-up: records the first admission (a 512-token prefill) with
``torch.profiler`` (CPU and CUDA), fills the other slots, lets ``--warmup``
decode steps pass, then records ``--window`` decode steps.  Reports, for
each window, the wall time, the device busy share (union of kernel
intervals over the window's wall time), the kernel launches and device time
per step, the host syncs, and the kernels by total device time, with the
card's ``nvidia-smi`` name and power limit.  ``--fastcache`` on a hybrid
or SSM stack profiles the exact serve, as ``launch/serve.py`` serves it.
``--reduced --device cpu`` rehearses the script on the CPU (no device
times).
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

from repro_torch.configs import LLM_IDS
from repro_torch.launch.profile_serve import _busy_us
from repro_torch.launch.serve import LLMWorkload, exact_fallback


def _window(prof, wall_s: float, steps: int) -> dict:
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    busy_us = _busy_us((e.time_range.start, e.time_range.end)
                       for e in kernels)
    flash_us = sum(v[0] for k, v in by_name.items()
                   if "flash_attention_kernel" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {"steps": steps, "wall_s": wall_s,
            "ms_per_step": wall_s / steps * 1e3,
            "device_busy_share": busy_us / (wall_s * 1e6),
            "kernel_launches_per_step": len(kernels) / steps,
            "kernel_ms_per_step": sum(v[0] for v in by_name.values())
            / steps / 1e3,
            "flash_attention_ms_per_step": flash_us / steps / 1e3,
            "top_kernels": [{"name": k[:100], "ms": v[0] / 1e3,
                             "calls": v[1]} for k, v in top]}


def _syncs(eng) -> int:
    return eng.host_syncs + (eng.decoder.host_syncs if eng.decoder else 0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fastcache", action="store_true")
    ap.add_argument("--arch", default=LLMWorkload.arch, choices=LLM_IDS)
    ap.add_argument("--num-layers", type=int, default=LLMWorkload.num_layers,
                    help="cut the config's depth at its full width "
                         "(0: the config's own)")
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--out", default="build/profile_llm.json")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    wl = LLMWorkload(arch=args.arch, num_layers=args.num_layers,
                     fastcache=args.fastcache, reduced=args.reduced)
    if args.warmup + args.window >= wl.new_tokens:
        raise SystemExit("--warmup + --window must stay below the "
                         f"{wl.new_tokens} new tokens of a request")
    model = wl.build_model(args.device)
    wl, line = exact_fallback(wl, model)
    if line is not None:
        print(line)
    dev = model.device
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    wl.warm_up(model)
    eng = wl.build_engine(model)
    reqs = wl.build_requests(model)
    sync()

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.add_request(reqs[0])
        sync()
        prefill_s = time.perf_counter() - t0
    prefill = _window(prof, prefill_s, 1)
    for req in reqs[1:wl.max_batch]:
        eng.add_request(req)
    for _ in range(args.warmup):
        eng.step()
    sync()
    syncs0 = _syncs(eng)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.window):
            eng.step()
        sync()
        decode_s = time.perf_counter() - t0
    decode = _window(prof, decode_s, args.window)
    decode["host_syncs_per_step"] = (_syncs(eng) - syncs0) / args.window
    card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, check=True, timeout=60).stdout.strip()
            if cuda else "cpu")
    report = {"card": card, "arch": model.cfg.name,
              "num_layers": model.cfg.num_layers,
              "fastcache": wl.fastcache, "max_batch": wl.max_batch,
              "prompt_len": wl.prompt_len, "prefill": prefill,
              "decode": decode}
    stats = eng.cache_stats()
    if stats:
        report["block_cache_ratio"] = stats["block_cache_ratio"]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    for name in ("prefill", "decode"):
        print(json.dumps({"card": card, "window": name,
                          "fastcache": wl.fastcache,
                          **{k: v for k, v in report[name].items()
                             if k != "top_kernels"}}))
        for row in report[name]["top_kernels"]:
            print(json.dumps(row))


if __name__ == "__main__":
    main()
