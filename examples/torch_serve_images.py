"""Serve image-generation requests through the port's continuous-batching
diffusion engine: requests arrive over time (Poisson), join the running
batch mid-flight, and each keeps its own FastCache state.  The counterpart
of examples/serve_images.py.

    PYTHONPATH=src python examples/torch_serve_images.py --steps 8 \\
        --requests 6
    PYTHONPATH=src python examples/torch_serve_images.py --device cpu
"""
import argparse
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.configs.base import FastCacheConfig
from repro_torch.core.runner import CachedDiT
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.serving import DiffusionServingEngine, poisson_trace


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dit-b2")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--rate", type=float, default=0.3)
    ap.add_argument("--policy", default="fastcache")
    ap.add_argument("--guidance", type=float, default=4.0)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_reduced(args.arch).replace(dtype="float32")
    model = build_model(cfg, device=dev).init(
        torch.Generator(dev).manual_seed(0), unzero=False)
    runner = CachedDiT(model, FastCacheConfig(), policy=args.policy)
    engine = DiffusionServingEngine(runner, max_slots=args.slots,
                                    num_steps=args.steps,
                                    guidance_scale=args.guidance)
    trace = poisson_trace(args.requests, args.rate, seed=0,
                          num_classes=cfg.dit.num_classes)
    t0 = time.perf_counter()
    done = engine.run(trace)
    dt = time.perf_counter() - t0

    print(f"{'rid':>4s} {'label':>5s} {'arrive':>6s} {'admit':>6s}"
          f" {'finish':>6s} {'latency':>7s}")
    for r in sorted(done, key=lambda r: r.rid):
        print(f"{r.rid:4d} {r.label:5d} {r.arrival_step:6d} "
              f"{r.admit_step:6d} {r.finish_step:6d} {r.latency_steps:7d}")
    print(f"{len(done)} requests in {dt:.2f}s over {engine.clock} engine "
          f"steps; cache: {engine.cache_stats()['block_cache_ratio']:.1%} "
          f"blocks skipped (active slots)")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        for r in done:
            np.save(os.path.join(args.out, f"latents_req{r.rid}.npy"),
                    r.latents)
        print(f"latents saved under {args.out}/")


if __name__ == "__main__":
    main()
