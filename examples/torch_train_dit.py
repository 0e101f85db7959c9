"""End-to-end training on the PyTorch port: train a DiT on the synthetic
latent pipeline, checkpoint, then sample from it with FastCache.  The
counterpart of examples/train_dit.py; from the CPU smoke size (default) to
the paper's DiT-B/2 (126M params):

    PYTHONPATH=src python examples/torch_train_dit.py --steps 120 \\
        --device cpu
    PYTHONPATH=src python examples/torch_train_dit.py --size b2 --steps 300
"""
import argparse
import dataclasses

import torch

from repro_torch.checkpoint import save as save_ckpt
from repro_torch.configs import get_reduced
from repro_torch.configs.base import FastCacheConfig
from repro_torch.configs.dit import DIT_B2, DIT_S2
from repro_torch.core.policies.base import summarize_stats
from repro_torch.core.runner import CachedDiT
from repro_torch.data import latent_stream
from repro_torch.device import resolve_device
from repro_torch.diffusion.sampler import sample
from repro_torch.models.registry import build_model
from repro_torch.training import AdamW, cosine_schedule, param_tree, train


def pick_config(size: str):
    if size == "smoke":
        return get_reduced("dit-b2").replace(dtype="float32")
    base = {"s2": DIT_S2, "b2": DIT_B2}[size]
    return base.replace(dtype="float32", dit=dataclasses.replace(
        base.dit, num_classes=10, image_size=16))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="smoke", choices=["smoke", "s2", "b2"])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--save", default="build/torch_dit_ckpt")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = pick_config(args.size)
    model = build_model(cfg, device=dev).init(
        torch.Generator(dev).manual_seed(0), unzero=False)
    n = sum(p.numel() for p in model.parameters())
    print(f"[train] {cfg.name}: {n/1e6:.1f}M params, {args.steps} steps")

    it = latent_stream(args.batch, cfg.dit.image_size, cfg.dit.in_channels,
                       num_classes=cfg.dit.num_classes, seed=0, device=dev)

    def log(i, m):
        print(f"[train] step {i:4d} mse={m['loss']:.4f} "
              f"({m['elapsed_s']:.1f}s)", flush=True)

    params, _, hist = train(model, param_tree(model),
                            AdamW(weight_decay=0.01),
                            cosine_schedule(args.lr, 10, args.steps), it,
                            steps=args.steps, log_every=20, callback=log)
    print(f"[train] loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    if args.save:
        save_ckpt(args.save, params, {"arch": cfg.name, "steps": args.steps,
                                      "final_loss": hist[-1]["loss"]})
        print(f"[train] checkpoint -> {args.save}")

    # sample from the trained model with FastCache
    runner = CachedDiT(model, FastCacheConfig(), policy="fastcache")
    x, st = sample(runner, batch=2,
                   labels=torch.tensor([1, 2], device=dev), num_steps=20,
                   generator=torch.Generator(dev).manual_seed(7))
    s = summarize_stats(st)
    print(f"[sample] {tuple(x.shape)} finite={bool(torch.isfinite(x).all())}"
          f" cache_ratio={s['block_cache_ratio']:.1%}")


if __name__ == "__main__":
    main()
