"""Quickstart on the PyTorch port: FastCache vs exact sampling on a small
DiT, the counterpart of examples/quickstart.py.

    PYTHONPATH=src python examples/torch_quickstart.py               # card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse
import time

import torch

from repro_torch.configs import get_reduced
from repro_torch.configs.base import FastCacheConfig
from repro_torch.core.policies.base import summarize_stats
from repro_torch.core.runner import CachedDiT
from repro_torch.device import resolve_device
from repro_torch.diffusion.sampler import sample
from repro_torch.models.registry import build_model


def timed_sample(runner, dev, labels):
    """Two samples from the same noise seed (the first warms up); the
    second's result and seconds."""
    for _ in range(2):
        gen = torch.Generator(dev).manual_seed(42)
        t0 = time.perf_counter()
        x, st = sample(runner, batch=2, labels=labels, num_steps=20,
                       generator=gen)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
    return x, st, dt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_reduced("dit-b2").replace(dtype="float32")
    model = build_model(cfg, device=dev).init(
        torch.Generator(dev).manual_seed(0), unzero=False)
    labels = torch.tensor([3, 7], device=dev)

    print(f"model: {cfg.name} ({cfg.num_layers}L d={cfg.d_model})")

    # --- exact (no cache) --------------------------------------------------
    x_ref, _, t_ref = timed_sample(
        CachedDiT(model, FastCacheConfig(), policy="nocache"), dev, labels)

    # --- FastCache (paper defaults: tau_s=0.05, alpha=0.05, gamma=0.5) -----
    x_fc, st, t_fc = timed_sample(
        CachedDiT(model, FastCacheConfig(), policy="fastcache"), dev, labels)

    s = summarize_stats(st)
    rel = float(torch.linalg.norm(x_fc - x_ref) / torch.linalg.norm(x_ref))
    print(f"exact    : {t_ref:.3f}s")
    print(f"fastcache: {t_fc:.3f}s  (block cache ratio "
          f"{s['block_cache_ratio']:.1%}, motion fraction "
          f"{s['mean_motion_fraction']:.1%})")
    print(f"relative deviation from exact sampler: {rel:.4f}")


if __name__ == "__main__":
    main()
