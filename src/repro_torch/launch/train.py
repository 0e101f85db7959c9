"""Training launcher for the port (the reference's ``launch/train.py``):
one model on one device, random initial weights, a synthetic stream.

    PYTHONPATH=src python -m repro_torch.launch.train --arch dit-xl2 \\
        --steps 30 --batch 32 --save build/dit.npz
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --reduced --steps 50 --batch 8 --seq 128 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch arctic-480b \\
        --reduced --steps 10 --batch 4 --seq 64 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch jamba-v0.1-52b \\
        --reduced --steps 3 --batch 2 --seq 32 --device cpu

Families: the DiT, the dense LMs, the MoE LMs (the MoE's loss adds the
router's aux; arctic-480b and kimi-k2-1t-a32b name Adafactor, which factors
each stacked (L, E, D, F) expert leaf over its last two axes), the SSM
family (xlstm-1.3b: mLSTM and sLSTM blocks, AdamW), the hybrid family
(jamba-v0.1-52b: Mamba, attention and MoE layers, Adafactor), the VLM
(qwen2-vl-2b, on text-only token batches, as the reference's launcher
feeds it) and the audio encoder (hubert-xlarge, masked prediction on the
synthetic ``audio_stream``; ``--seq`` is its frame count).

Defaults and printed lines are the reference's.  ``--reduced`` trains the
smoke-scale config in f32.  Weights come from ``torch.Generator`` seeded
with ``--seed``, through the reference's initializers (the DiT's
adaLN-zero modulation and head start at zero, as the reference's
``model.init`` leaves them); batches from the ported streams with the same
seed.  ``--save`` writes the trained parameters as the reference's tree
(``checkpoint.save``, loadable by the reference's ``load`` in f32).  The
reference's ``--production-mesh`` (multi-device sharding) is not ported.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.checkpoint import save as save_ckpt
from repro_torch.configs import get_config, get_reduced
from repro_torch.data import audio_stream, latent_stream, token_stream
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.training import (cosine_schedule, make_optimizer,
                                  param_tree, train)


def data_for(cfg, batch, seq, seed=0, device="cuda"):
    if cfg.family == "audio":
        return audio_stream(batch, seq, cfg.frontend_dim, cfg.vocab_size,
                            seed=seed, device=device)
    if cfg.family == "dit":
        return latent_stream(batch, cfg.dit.image_size, cfg.dit.in_channels,
                             num_classes=cfg.dit.num_classes, seed=seed,
                             device=device)
    return token_stream(cfg.vocab_size, batch, seq, seed=seed, device=device)


def init_model(cfg, device, seed: int):
    """The model on ``device`` with the reference's initializers (no
    un-zeroing), drawn from ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    model = build_model(cfg, device=dev)
    gen = torch.Generator(dev).manual_seed(seed)
    if cfg.family == "dit":
        return model.init(gen, unzero=False)
    return model.init(gen)


def main(argv=None) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config, f32")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.reduced:
        cfg = cfg.replace(dtype="float32")
    model = init_model(cfg, args.device, args.seed)
    n = sum(p.numel() for p in model.parameters())
    print(f"[train] {cfg.name}: {n/1e6:.1f}M params, opt={cfg.optimizer}")

    params = param_tree(model)
    opt = make_optimizer(cfg.optimizer)
    lr_fn = cosine_schedule(args.lr, args.warmup, args.steps)
    it = data_for(cfg, args.batch, args.seq, args.seed, model.device)

    def log(i, m):
        print(f"[train] step {i:5d} loss={m['loss']:.4f} "
              f"lr={m['lr']:.2e} |g|={m['grad_norm']:.2f} "
              f"({m['elapsed_s']:.1f}s)", flush=True)

    params, _, hist = train(model, params, opt, lr_fn, it,
                            steps=args.steps, log_every=10, callback=log)
    if args.save:
        save_ckpt(args.save, params, {"arch": cfg.name, "steps": args.steps,
                                      "history": hist})
        print(f"[train] saved -> {args.save}")


if __name__ == "__main__":
    main()
