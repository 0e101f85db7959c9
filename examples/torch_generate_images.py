"""Generate class-conditional latents with every cache policy and compare,
on the PyTorch port: the counterpart of examples/generate_images.py (the
runnable version of the paper's Table 1 experiment).

    PYTHONPATH=src python examples/torch_generate_images.py --steps 20 \\
        --out build/gen
    PYTHONPATH=src python examples/torch_generate_images.py --device cpu
"""
import argparse
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.configs.base import FastCacheConfig
from repro_torch.core.policies.base import (registered_policies,
                                            summarize_stats)
from repro_torch.core.runner import CachedDiT
from repro_torch.device import resolve_device
from repro_torch.diffusion.sampler import sample
from repro_torch.models.registry import build_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dit-b2")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--guidance", type=float, default=4.0)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_reduced(args.arch).replace(dtype="float32")
    model = build_model(cfg, device=dev).init(
        torch.Generator(dev).manual_seed(0), unzero=False)
    labels = torch.arange(args.batch, device=dev) % cfg.dit.num_classes

    ref = None
    print(f"{'policy':10s} {'time_s':>8s} {'cache%':>7s} {'reused':>6s}"
          f" {'rel_err':>8s}")
    for policy in registered_policies():
        runner = CachedDiT(model, FastCacheConfig(), policy=policy)
        for _ in range(2):                  # the first call warms up
            gen = torch.Generator(dev).manual_seed(1)
            t0 = time.perf_counter()
            x, st = sample(runner, batch=args.batch, labels=labels,
                           num_steps=args.steps,
                           guidance_scale=args.guidance, generator=gen)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
        if policy == "nocache":
            ref = x
        s = summarize_stats(st)
        rel = float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))
        print(f"{policy:10s} {dt:8.3f} {s['block_cache_ratio']:7.1%}"
              f" {s['steps_reused']:6.0f} {rel:8.4f}")
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            np.save(os.path.join(args.out, f"latents_{policy}.npy"),
                    x.cpu().numpy())
    if args.out:
        print(f"latents saved under {args.out}/")


if __name__ == "__main__":
    main()
