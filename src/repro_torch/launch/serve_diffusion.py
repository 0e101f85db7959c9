"""Diffusion serving launcher for the port: continuous-batching DiT
sampling with per-slot FastCache state on one CUDA card.

    PYTHONPATH=src python -m repro_torch.launch.serve_diffusion \\
        --arch dit-xl2 --requests 8 --slots 4 --steps 50 --rate 0.5 --json

Weights are random (``torch.Generator`` seeded from ``--seed``, un-zeroed
as in ``DiTModel.init``).  After an untimed warm-up on a fresh engine,
prints p50/p95 request latency in engine steps, engine steps per second of
wall time, the block cache ratio, the steps reused and the host syncs per
model step.  ``--policy`` takes every registered cache policy (nocache,
fora, teacache, adacache, fbcache, l2c, fastcache, smoothcache; l2c with
its default empty mask).  ``--token-merge-ratio 0.5`` turns on
token compression (windows of ``--token-merge-window`` tokens merged to
half); 1.0, the default, leaves it off.  ``--device cpu --reduced`` runs
the plain PyTorch path on a toy model.

``Workload`` is the one definition of the served configuration: its
defaults are the flags' defaults, and ``chip_smoke.py`` and
``launch/profile_serve.py`` build their serve from it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Tuple

import torch

from repro_torch.configs import DIT_IDS, get_config, get_reduced
from repro_torch.configs.base import FastCacheConfig
from repro_torch.core.policies.base import registered_policies
from repro_torch.core.runner import CachedDiT
from repro_torch.device import resolve_device
from repro_torch.models.dit import DiTModel
from repro_torch.serving.diffusion_engine import DiffusionServingEngine
from repro_torch.serving.scheduler import (DiffusionRequest, percentile,
                                           poisson_trace)


@dataclass(frozen=True)
class Workload:
    """A serve: the model, the cache policy, the engine and the traffic."""
    arch: str = "dit-xl2"
    reduced: bool = False
    policy: str = "fastcache"
    slots: int = 4
    steps: int = 50                 # DDIM steps per request
    guidance: float = 4.0
    requests: int = 8
    rate: float = 0.5               # Poisson arrivals per engine step
    seed: int = 0                   # weights and arrivals
    merge_ratio: float = 1.0        # token compression: kept share, 1 = off
    merge_window: int = 16          # token compression window w
    # the policy's own constructor knobs (e.g. l2c_mask, smooth_schedule),
    # passed through CachedDiT; no flag sets them
    policy_kwargs: Mapping[str, Any] = dataclasses.field(
        default_factory=dict)

    def build_model(self, device) -> DiTModel:
        cfg = get_reduced(self.arch) if self.reduced else get_config(self.arch)
        dev = resolve_device(device)
        return DiTModel(cfg, device=dev).init(
            torch.Generator(dev).manual_seed(self.seed))

    def build_engine(self, model: DiTModel
                     ) -> Tuple[CachedDiT, DiffusionServingEngine]:
        fc = FastCacheConfig(merge_enabled=self.merge_ratio < 1.0,
                             merge_ratio=self.merge_ratio,
                             merge_window=self.merge_window)
        runner = CachedDiT(model, fc, policy=self.policy,
                           **self.policy_kwargs)
        return runner, DiffusionServingEngine(
            runner, max_slots=self.slots, num_steps=self.steps,
            guidance_scale=self.guidance)

    def build_trace(self, model: DiTModel) -> List[DiffusionRequest]:
        return poisson_trace(self.requests, self.rate, seed=self.seed,
                             num_classes=model.cfg.dit.num_classes)

    def warm_up(self, model: DiTModel
                ) -> Tuple[CachedDiT, DiffusionServingEngine]:
        """Serve two 3-step requests on a fresh engine, so that the first
        calls of the math libraries and of the kernels (their build
        included) land here and not in a timed run.  Its steps take both
        the cold and the gated branch.  Returns the runner and engine it
        used."""
        short = dataclasses.replace(self, requests=2, steps=3)
        runner, eng = short.build_engine(model)
        eng.run(short.build_trace(model))
        return runner, eng


def serve(args: argparse.Namespace) -> Dict:
    wl = Workload(**{f.name: getattr(args, f.name)
                     for f in dataclasses.fields(Workload)
                     if hasattr(args, f.name)})
    model = wl.build_model(args.device)
    dev = model.device
    wl.warm_up(model)
    runner, eng = wl.build_engine(model)
    trace = wl.build_trace(model)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    done = eng.run(trace)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    lats = [r.latency_steps for r in done]
    stats = eng.cache_stats()
    return {
        "arch": model.cfg.name, "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "policy": wl.policy, "slots": wl.slots,
        "requests": len(trace), "finished": len(done),
        "engine_steps": eng.clock, "model_steps": eng.model_steps,
        "wall_s": wall, "engine_steps_per_s": eng.clock / wall,
        "latency_steps_p50": percentile(lats, 50),
        "latency_steps_p95": percentile(lats, 95),
        "block_cache_ratio": stats["block_cache_ratio"],
        "steps_reused": stats["steps_reused"],
        "host_syncs_per_model_step": ((runner.impl.host_syncs
                                       + eng.host_syncs) / eng.model_steps),
        "blocks_skipped": stats["blocks_skipped"],
        "blocks_computed": stats["blocks_computed"],
        "token_merge": {"ratio": wl.merge_ratio, "window": wl.merge_window,
                        "active": runner.reducer is not None},
    }


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=Workload.arch, choices=DIT_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=Workload.requests)
    ap.add_argument("--slots", type=int, default=Workload.slots)
    ap.add_argument("--steps", type=int, default=Workload.steps)
    ap.add_argument("--guidance", type=float, default=Workload.guidance)
    ap.add_argument("--policy", default=Workload.policy,
                    choices=registered_policies())
    ap.add_argument("--rate", type=float, default=Workload.rate,
                    help="Poisson arrival rate, requests per engine step")
    ap.add_argument("--seed", type=int, default=Workload.seed)
    add_merge_args(ap)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", action="store_true")
    return check_merge_args(ap.parse_args(argv))


def add_merge_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--token-merge-ratio", dest="merge_ratio", type=float,
                    default=Workload.merge_ratio,
                    help="serving-path token compression: keep "
                         "ceil(ratio * window) cluster centers per window "
                         "of tokens before the cache policy runs "
                         "(core/token_reduce.py); 1.0 disables the stage "
                         "(bitwise-identical to merge-off)")
    ap.add_argument("--token-merge-window", dest="merge_window", type=int,
                    default=Workload.merge_window,
                    help="token-compression window size w; the DiT token "
                         "count must be divisible by it")


def check_merge_args(args: argparse.Namespace) -> argparse.Namespace:
    if not 0.0 < args.merge_ratio <= 1.0:
        raise SystemExit(f"--token-merge-ratio must be in (0, 1], got "
                         f"{args.merge_ratio}")
    return args


def main(argv=None) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    args = parse_args(argv)
    summary = serve(args)
    if args.json:
        print(json.dumps(summary))
    else:
        for k, v in summary.items():
            print(f"{k:>20}: {v}")


if __name__ == "__main__":
    main()
