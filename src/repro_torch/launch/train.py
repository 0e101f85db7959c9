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
(``checkpoint.save``, loadable by the reference's ``load`` in f32).

On a mesh (``training/sharded.py``; the attention-only families: dense,
MoE, VLM, audio):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --reduced --mesh 2,2 --device cpu --steps 3
    torchrun --nproc-per-node 8 --nnodes 32 ... -m repro_torch.launch.train \
        --arch qwen3-14b --production-mesh

``--mesh D,M`` starts D x M ranks on this host (``nccl`` with a card each,
``gloo`` when they share the card, and on the CPU); ``--production-mesh``
runs as one rank of torchrun's 256 on the reference's (16, 16) mesh and is
refused in a group of any other size.  Each rank draws its blocks of the
weights the single-device run draws, takes its rows of the same global
batches, and rank 0 prints the reference's lines and writes ``--save``
(the whole tree, gathered).  An SSM or hybrid config, and a batch that
does not split over ``data``, are refused on a mesh wider than one rank.
"""
from __future__ import annotations

import argparse
import os

import torch

from repro_torch.checkpoint import save as save_ckpt
from repro_torch.configs import get_config, get_reduced
from repro_torch.data import audio_stream, latent_stream, token_stream
from repro_torch.device import resolve_device
from repro_torch.models.params import count_params
from repro_torch.models.registry import build_model
from repro_torch.training import (cosine_schedule, make_optimizer,
                                  param_tree, train)

MESH_TIMEOUT_S = 3600.0    # every rank of a --mesh run, start to save


def data_for(cfg, batch, seq, seed=0, device="cuda", shard=None):
    """The config's synthetic stream; ``shard=(index, count)`` keeps a data
    rank's rows of each global batch."""
    if cfg.family == "audio":
        return audio_stream(batch, seq, cfg.frontend_dim, cfg.vocab_size,
                            seed=seed, device=device, shard=shard)
    if cfg.family == "dit":
        if shard is not None:
            raise ValueError("the DiT trains on one device")
        return latent_stream(batch, cfg.dit.image_size, cfg.dit.in_channels,
                             num_classes=cfg.dit.num_classes, seed=seed,
                             device=device)
    return token_stream(cfg.vocab_size, batch, seq, seed=seed, device=device,
                        shard=shard)


def init_model(cfg, device, seed: int):
    """The model on ``device`` with the reference's initializers (no
    un-zeroing), drawn from ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    model = build_model(cfg, device=dev)
    gen = torch.Generator(dev).manual_seed(seed)
    if cfg.family == "dit":
        return model.init(gen, unzero=False)
    return model.init(gen)


def _numerics() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def parse_args(argv=None) -> argparse.Namespace:
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
    ap.add_argument("--production-mesh", action="store_true",
                    help="one rank of torchrun's 256 on the (16, 16) mesh")
    ap.add_argument("--mesh", default="",
                    help="D,M: start D x M ranks on a (data, model) mesh")
    args = ap.parse_args(argv)
    if args.mesh:
        try:
            dims = tuple(int(x) for x in args.mesh.split(","))
        except ValueError:
            dims = ()
        if len(dims) != 2 or min(dims) < 1:
            ap.error(f"--mesh takes D,M (two positive extents), got "
                     f"{args.mesh!r}")
        args.mesh = dims
    if args.mesh and args.production_mesh:
        ap.error("--mesh and --production-mesh exclude each other")
    return args


def config_of(args):
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    return cfg.replace(dtype="float32") if args.reduced else cfg


def check_mesh(cfg, args, dims) -> None:
    """Refuse, before any rank starts, what a mesh of ``dims`` cannot run:
    the SSM and hybrid families, a batch that does not split over the
    batch axes."""
    from repro_torch.training.sharded import (batch_axes, check_family,
                                              counting_train_mesh)
    try:
        check_family(cfg, dims[0] * dims[1])
        batch_axes(counting_train_mesh(dims, args.batch), args.batch)
    except ValueError as e:
        raise SystemExit(f"[train] refused: {e}")


def _log(i, m):
    print(f"[train] step {i:5d} loss={m['loss']:.4f} "
          f"lr={m['lr']:.2e} |g|={m['grad_norm']:.2f} "
          f"({m['elapsed_s']:.1f}s)", flush=True)


def train_on_mesh(args, cfg, device: str, device_mesh, backend: str):
    """One rank's run on ``device_mesh``: its blocks of the weights, its
    rows of the batches; rank 0 prints the reference's lines and writes
    ``--save`` (the gathered tree).  Returns rank 0's history, else
    None."""
    from repro_torch.training.sharded import (data_shard, gather_tree,
                                              init_sharded, leaf_specs,
                                              train_mesh)
    mesh = train_mesh(device_mesh, backend, args.batch)
    lead = all(c == 0 for c in mesh.coords.values())
    model = init_sharded(cfg, device, args.seed, mesh)
    if lead:
        n = count_params(model.param_defs())
        print(f"[train] {cfg.name}: {n/1e6:.1f}M params, "
              f"opt={cfg.optimizer}", flush=True)
    params = param_tree(model)
    opt = make_optimizer(cfg.optimizer)
    lr_fn = cosine_schedule(args.lr, args.warmup, args.steps)
    it = data_for(cfg, args.batch, args.seq, args.seed, model.device,
                  shard=data_shard(mesh))
    params, _, hist = train(model, params, opt, lr_fn, it, steps=args.steps,
                            log_every=10, callback=_log if lead else None,
                            mesh=mesh)
    if args.save:
        whole = gather_tree(params, leaf_specs(model, mesh), mesh)
        if lead:
            save_ckpt(args.save, whole, {"arch": cfg.name,
                                         "steps": args.steps,
                                         "history": hist})
            print(f"[train] saved -> {args.save}", flush=True)
    return hist if lead else None


def _mesh_rank(rank: int, world: int, port: int, backend: str,
               devices, args) -> None:
    """One rank of ``--mesh``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_ranks, make_mesh
    _numerics()
    if devices[rank].startswith("cuda"):
        torch.cuda.set_device(torch.device(devices[rank]))
    else:
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    init_ranks(rank, world, port=port, backend=backend)
    try:
        train_on_mesh(args, config_of(args), devices[rank],
                      make_mesh(*args.mesh), backend)
    finally:
        dist.destroy_process_group()


def run_mesh(args, *, timeout: float = MESH_TIMEOUT_S) -> None:
    """``--mesh D,M``: start D x M ranks and wait for them; a rank's
    failure raises with its traceback."""
    from repro_torch.launch.mesh import mesh_backend, run_ranks
    world = args.mesh[0] * args.mesh[1]
    backend, devices = mesh_backend(args.device, world)
    run_ranks(_mesh_rank, world, (backend, devices, args), timeout=timeout,
              label="train")


def run_production(args, cfg) -> None:
    """``--production-mesh``: this process is one of torchrun's ranks
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT`` in its environment)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_production_mesh, production_shape
    need = production_shape()[0] * production_shape()[1]
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != need:
        raise SystemExit(f"[train] refused: --production-mesh needs "
                         f"{need} ranks (WORLD_SIZE={need}, e.g. under "
                         f"torchrun); this run has WORLD_SIZE={world}")
    check_mesh(cfg, args, production_shape())
    device = args.device
    if torch.device(device).type == "cuda":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
        torch.cuda.set_device(torch.device(device))
    backend = "nccl" if device.startswith("cuda") else "gloo"
    dist.init_process_group(backend, init_method="env://")
    try:
        train_on_mesh(args, cfg, device, make_production_mesh(), backend)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    _numerics()
    args = parse_args(argv)
    cfg = config_of(args)
    if args.production_mesh:
        run_production(args, cfg)
        return
    if args.mesh:
        check_mesh(cfg, args, args.mesh)
        run_mesh(args)
        return
    model = init_model(cfg, args.device, args.seed)
    n = sum(p.numel() for p in model.parameters())
    print(f"[train] {cfg.name}: {n/1e6:.1f}M params, opt={cfg.optimizer}")

    params = param_tree(model)
    opt = make_optimizer(cfg.optimizer)
    lr_fn = cosine_schedule(args.lr, args.warmup, args.steps)
    it = data_for(cfg, args.batch, args.seq, args.seed, model.device)
    params, _, hist = train(model, params, opt, lr_fn, it,
                            steps=args.steps, log_every=10, callback=_log)
    if args.save:
        save_ckpt(args.save, params, {"arch": cfg.name, "steps": args.steps,
                                      "history": hist})
        print(f"[train] saved -> {args.save}")


if __name__ == "__main__":
    main()
