"""Calibration recorder launcher: record per-layer per-step output deltas of
an uncached run into an ``.npz`` artifact (the reference's
``launch/calibrate.py``), on one CUDA card by default.

    PYTHONPATH=src python -m repro_torch.launch.calibrate --arch dit-b2 \\
        --reduced --device cpu --batch 2 --steps 20 --out calib.npz

Weights are random (``torch.Generator`` seeded from ``--seed``, un-zeroed
as in ``DiTModel.init``); ``--reduced`` runs the reduced config in f32.
The artifact carries ``errors_mean`` (L, T), the matrix
``smooth_schedule_from_errors`` consumes, the raw per-row deltas
(``rel_delta`` (T, L, B)) and ``ts``, in the reference's schema, so the
reference's ``load_calibration`` reads it (and the port's reads the
reference's).  ``--threshold`` prints the SmoothCache schedule the
recording implies.  ``--audit-baseline`` of ``launch/serve_diffusion.py``
takes the artifact.
"""
from __future__ import annotations

import argparse
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs import DIT_IDS, get_config, get_reduced
from repro_torch.configs.base import FastCacheConfig
from repro_torch.core.policies.smoothcache import smooth_schedule_from_errors
from repro_torch.core.runner import CachedDiT
from repro_torch.device import resolve_device
from repro_torch.models.dit import DiTModel
from repro_torch.obs import record_calibration, save_calibration


def fit_batches(model: DiTModel, n: int = 4, batch: int = 8,
                seed: int = 0) -> List[Dict[str, torch.Tensor]]:
    """``n`` batches of ``batch`` random latents, timesteps and labels on
    the model's device (one ``torch.Generator`` seeded ``seed``), as
    ``calibrate_dit`` takes them."""
    dev = model.device
    dit = model.cfg.dit
    shape = (batch, dit.image_size, dit.image_size, dit.in_channels)
    gen = torch.Generator(dev).manual_seed(seed)
    return [{"latents": torch.randn(shape, generator=gen, device=dev),
             "t": torch.randint(0, 1000, (batch,), generator=gen,
                                device=dev),
             "labels": torch.randint(0, dit.num_classes, (batch,),
                                     generator=gen, device=dev)}
            for _ in range(n)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="dit-b2", choices=DIT_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--guidance", type=float, default=4.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", required=True,
                    help="output .npz artifact path")
    ap.add_argument("--threshold", type=float, default=0.0,
                    help="if > 0, print the SmoothCache schedule this "
                         "recording implies at that error threshold")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.reduced:
        cfg = cfg.replace(dtype="float32")
    dev = resolve_device(args.device)
    model = DiTModel(cfg, device=dev).init(
        torch.Generator(dev).manual_seed(args.seed))
    runner = CachedDiT(model, FastCacheConfig(), policy="nocache")
    result = record_calibration(runner, batch=args.batch,
                                num_steps=args.steps,
                                guidance_scale=args.guidance,
                                seed=args.seed)
    save_calibration(args.out, result)
    em = result["errors_mean"]
    print(f"[calibrate] {args.arch}: recorded ({em.shape[0]} layers, "
          f"{em.shape[1]} steps) x batch {int(result['batch'])} -> "
          f"{args.out}")
    print(f"[calibrate] mean rel delta per step: "
          f"{np.round(em.mean(axis=0), 4).tolist()}")
    if args.threshold > 0.0:
        schedule = smooth_schedule_from_errors(em, args.threshold)
        frac = float(np.asarray(schedule, np.float32).mean())
        print(f"[calibrate] smoothcache schedule @ thr={args.threshold}: "
              f"{frac:.1%} of (layer, step) cells reuse the cache")


if __name__ == "__main__":
    main()
