#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each printing one JSON line:

1. device   nvidia-smi name and power limit, torch and nvcc versions;
2. build    nvcc build of every kernel source (sm_90a), with ptxas's
            register / shared-memory / spill lines and the build seconds;
3. kernel   fused_gate against its plain PyTorch version at B=8, C=128,
            D=1152, bf16, blend on and off, half the samples gating: gate
            bits exact, diff/prevsq within rtol 1e-4, out within 2e-2;
            CUDA-event times of the kernel, the plain version and
            torch.addmm of (B*C, D)x(D, D) in f32, beside the bound;
4. syncs    an untimed warm-up serve (Workload.warm_up: two short requests
            on a fresh engine) under torch.cuda's sync-debug mode: the
            synchronizations it flags beside the code's own host_syncs count;
5. serve    the main path, launch.serve_diffusion.Workload's defaults:
            DiT-XL/2 at full width, bf16, random un-zeroed weights
            (torch.Generator seed 0), fastcache with the default
            FastCacheConfig, 4 slots, 8 Poisson requests (rate 0.5, seed 0),
            50 DDIM steps, guidance 4.0, through DiffusionServingEngine.run,
            timed with sync debug off; the kernels' launch counts are zeroed
            just before and read just after, and fused_gate must have
            launched 28 times per model step with a warm slot;
6. static   the same input for 6 steps through CachedDiT.step: cache ratio
            must exceed 0.4 (the gated branch firing at full width);
7. quality  relative L2 of fastcache eps against nocache eps on the same
            inputs for 6 DDIM steps.

Then the kernels line, the card's name and power limit, and as the last
line ``{"ok": true, "device": {...}}``.  Exits non-zero, with no result,
when no CUDA card is present or any phase fails.
"""
import collections
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM
F32_FLOPS_PER_S = 67e12            # H100 SXM, f32 outside the tensor cores
KERNEL_SOURCES = ("fused_gate",)      # csrc/<name>.cu


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def latent_shape(model):
    dit = model.cfg.dit
    return (dit.image_size, dit.image_size, dit.in_channels)


def cuda_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build(build):
    for name in KERNEL_SOURCES:
        lib = build.load_library(name)
        emit({"phase": "build", "source": f"src/repro_torch/csrc/{name}.cu",
              "seconds": round(lib.seconds, 3),
              "ptxas": build.ptxas_lines(lib.log)})


def phase_kernel(torch, dev, fused_gate, ref, statcache):
    gen = torch.Generator(dev).manual_seed(0)
    b, c, d = 8, 128, 1152
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x = randn(b, c, d).to(bf16)
    prev = (x.float() + randn(b, c, d, scale=0.01)).to(bf16)
    po = randn(b, c, d).to(bf16)
    w = torch.eye(d, device=dev) + randn(d, d, scale=0.01)
    bias = randn(d, scale=0.1)
    nd = c * d
    thr = statcache.make_threshold(0.05, nd)
    diff64 = (x.double() - prev.double()).square().sum(dim=(1, 2))
    factor = torch.tensor([2.0, 0.5] * (b // 2), device=dev,
                          dtype=torch.float64)     # even samples gate
    sigma2 = (diff64 / (nd * thr) * factor).to(f32)
    eligible = torch.ones(b, dtype=torch.bool, device=dev)
    args = (x, prev, po, w, bias, sigma2, eligible)

    worst, out = 0.0, {}
    for use_blend in (True, False):
        kw = dict(threshold=thr, gamma=0.5, use_blend=use_blend)
        got = fused_gate(*args, **kw)
        torch.cuda.synchronize()
        want = ref.fused_gate(*args, **kw)
        if not torch.equal(got[1], want[1]):
            raise AssertionError(f"gate bits differ: {got[1]} vs {want[1]}")
        if int(got[1].sum()) != b // 2:
            raise AssertionError(f"expected {b // 2} gated samples, got "
                                 f"{int(got[1].sum())}")
        torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0)
        torch.testing.assert_close(got[3], want[3], rtol=1e-4, atol=0)
        torch.testing.assert_close(got[0].float(), want[0].float(),
                                   rtol=2e-2, atol=2e-2)
        err = float((got[0].float() - want[0].float()).abs().max())
        worst = max(worst, err)
        kernel_ms = cuda_ms(torch, lambda: fused_gate(*args, **kw))
        plain_ms = cuda_ms(torch, lambda: ref.fused_gate(*args, **kw))
        out[use_blend] = (kernel_ms, plain_ms)
        emit({"phase": "kernel", "name": "fused_gate", "shape": [b, c, d],
              "dtype": "bfloat16", "use_blend": use_blend,
              "gated": int(got[1].sum()), "max_abs_err": err,
              "kernel_ms": kernel_ms, "plain_ms": plain_ms})

    xm = x.reshape(b * c, d).float()
    addmm_ms = cuda_ms(torch, lambda: torch.addmm(bias, xm, w))
    # bytes: x, prev_in, prev_out read and out written once each in bf16,
    # W and bias in f32, the (B,) vectors; operations: the two norms over
    # x/prev (5 per element) and, for the samples gated in this run, the
    # GEMM (2*C*D*D) and its bias + blend epilogue (4 per element)
    n_gated = b // 2
    nbytes = 4 * b * c * d * 2 + d * d * 4 + d * 4 + b * (4 + 1 + 1 + 4 + 4)
    ops = 5 * b * c * d + n_gated * (2 * c * d * d + 4 * c * d)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    kernel_ms, plain_ms = out[True]
    emit({"phase": "kernel_summary", "name": "fused_gate",
          "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "addmm_f32_ms": addmm_ms, "bound_ms": bound_ms,
          "bound_by": "operations" if t_ops >= t_bytes else "bytes",
          "bytes": nbytes, "operations": ops})
    return {"name": "fused_gate", "route": "cuda",
            "source": "src/repro_torch/csrc/fused_gate.cu",
            "replaces": "src/repro/kernels/fused_gate.py:80",
            "max_abs_err": worst, "ms": kernel_ms, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": addmm_ms,
            "library_call": "torch.addmm (B*C,D)x(D,D) f32: the GEMM alone"}


def phase_syncs(torch, wl, model):
    """Warm-up serve under sync debug: every synchronization it flags, by
    source line, beside the syncs the code counts."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            runner, eng = wl.warm_up(model)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    sources = collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    emit({"phase": "syncs", "model_steps": eng.model_steps,
          "step_kinds": dict(runner.impl.step_kinds),
          "counted": runner.impl.host_syncs + eng.host_syncs,
          "flagged": sum(sources.values()),
          "sources": dict(sources.most_common())})


def phase_serve(torch, dev, wl, model, m):
    runner, eng = wl.build_engine(model)
    trace = wl.build_trace(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    m.fused_gate.launches = 0                      # the main path starts here
    t0 = time.perf_counter()
    done = eng.run(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = m.fused_gate.launches               # ... and ends here
    kinds = dict(runner.impl.step_kinds)
    warm_steps = kinds["warm"] + kinds["mixed"]
    if len(done) != len(trace):
        raise AssertionError(f"{len(done)} of {len(trace)} requests finished")
    for r in done:
        if r.latents.shape != latent_shape(model) or not np.isfinite(r.latents).all():
            raise AssertionError(f"rid={r.rid}: latents {r.latents.shape} "
                                 "not finite")
    if launches <= 0 or launches != runner.L * warm_steps:
        raise AssertionError(f"fused_gate launches {launches} != "
                             f"{runner.L} x {warm_steps} warm model steps")
    stats = eng.cache_stats()
    lats = [r.latency_steps for r in done]
    emit({"phase": "serve", "arch": model.cfg.name, "slots": wl.slots,
          "requests": len(done), "engine_steps": eng.clock,
          "model_steps": eng.model_steps, "step_kinds": kinds,
          "wall_s": wall, "engine_steps_per_s": eng.clock / wall,
          "latency_steps_p50": m.percentile(lats, 50),
          "latency_steps_p95": m.percentile(lats, 95),
          "block_cache_ratio": stats["block_cache_ratio"],
          "fused_gate_launches": launches,
          "policy_host_syncs": runner.impl.host_syncs,
          "engine_host_syncs": eng.host_syncs,
          "host_syncs_per_model_step": (runner.impl.host_syncs
                                        + eng.host_syncs) / eng.model_steps,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev)})
    return launches


def phase_static(torch, dev, model, m):
    runner = m.CachedDiT(model, m.FastCacheConfig(), policy="fastcache")
    gen = torch.Generator(dev).manual_seed(1)
    b = 8
    x = torch.randn((b,) + latent_shape(model), generator=gen, device=dev)
    labels = torch.arange(b, device=dev)
    t = torch.full((b,), 500, device=dev)
    state = runner.init_state(b)
    for _ in range(6):
        eps, state = runner.step(state, x, t, labels)
    s = m.summarize_stats(state)
    if not torch.isfinite(eps).all():
        raise AssertionError("static drive: eps not finite")
    emit({"phase": "static", "steps": 6, "batch": b,
          "block_cache_ratio": s["block_cache_ratio"],
          "mean_motion_fraction": s["mean_motion_fraction"]})
    if not s["block_cache_ratio"] > 0.4:
        raise AssertionError(f"static drive cache ratio {s}")


def phase_quality(torch, dev, model, m):
    nc = m.CachedDiT(model, m.FastCacheConfig(), policy="nocache")
    fc = m.CachedDiT(model, m.FastCacheConfig(), policy="fastcache")
    b = 8
    gen = torch.Generator(dev).manual_seed(2)
    x = torch.randn((b,) + latent_shape(model), generator=gen, device=dev)
    labels = torch.arange(b, device=dev) * 7
    sched = m.linear_schedule(1000, device=dev)
    ts = m.ddim_timesteps(1000, 50, device=dev)
    s_nc, s_fc = nc.init_state(b), fc.init_state(b)
    rel = []
    for i in range(6):
        t = ts[i].expand(b)
        eps_nc, s_nc = nc.step(s_nc, x, t, labels)
        eps_fc, s_fc = fc.step(s_fc, x, t, labels)
        rel.append(float((eps_fc.float() - eps_nc.float()).norm()
                         / eps_nc.float().norm()))
        x = m.ddim_step(sched, x, eps_nc, t, ts[i + 1].expand(b))
    if not all(r == r for r in rel):
        raise AssertionError(f"quality: NaN relative error {rel}")
    emit({"phase": "quality", "steps": 6, "rel_l2_eps_fastcache_vs_nocache":
          rel, "block_cache_ratio":
          m.summarize_stats(s_fc)["block_cache_ratio"]})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    # every module of the port is imported before anything is printed
    from types import SimpleNamespace
    from repro_torch.configs.base import FastCacheConfig
    from repro_torch.core import statcache
    from repro_torch.core.policies.base import summarize_stats
    from repro_torch.core.runner import CachedDiT
    from repro_torch.diffusion.schedule import (ddim_step, ddim_timesteps,
                                                linear_schedule)
    from repro_torch.cuda_kernels import build, ref
    from repro_torch.cuda_kernels.fused_gate import fused_gate
    from repro_torch.launch.serve_diffusion import Workload
    from repro_torch.serving.scheduler import percentile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    emit({"phase": "settings",
          "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
          "allow_bf16_reduced_precision_reduction":
              torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction})

    card = smi()
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "torch_cuda": torch.version.cuda, "nvcc": nvcc,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    phase_build(build)
    dev = torch.device("cuda")
    kernel_row = phase_kernel(torch, dev, fused_gate, ref, statcache)

    m = SimpleNamespace(
        CachedDiT=CachedDiT, FastCacheConfig=FastCacheConfig,
        percentile=percentile, fused_gate=fused_gate,
        summarize_stats=summarize_stats, linear_schedule=linear_schedule,
        ddim_timesteps=ddim_timesteps, ddim_step=ddim_step)
    wl = Workload()
    t0 = time.perf_counter()
    model = wl.build_model(dev)
    torch.cuda.synchronize()
    emit({"phase": "model", "arch": model.cfg.name,
          "params": sum(p.numel() for p in model.parameters()),
          "dtype": str(model.dtype), "init_s": time.perf_counter() - t0})

    phase_syncs(torch, wl, model)
    kernel_row["launches"] = phase_serve(torch, dev, wl, model, m)
    phase_static(torch, dev, model, m)
    phase_quality(torch, dev, model, m)

    emit({"kernels": [kernel_row]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
