"""DDIM sampler with classifier-free guidance and cache-policy hooks.

``denoise_step`` is the single-step core shared by ``sample()`` and the
serving engine: one model evaluation + guidance + DDIM update over
per-sample ``(t, t_prev)`` vectors.  CFG doubles the batch (cond rows, then
uncond rows with the null label), so the cache state is sized 2B.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core.runner import CachedDiT
from repro_torch.diffusion import schedule as sch

F32 = torch.float32

GuidanceLike = Union[float, int, torch.Tensor]


@torch.no_grad()
def denoise_step(runner: CachedDiT, sched: sch.Schedule, state: Dict,
                 x: torch.Tensor, t: torch.Tensor, t_prev: torch.Tensor,
                 labels: torch.Tensor, *,
                 guidance_scale: GuidanceLike = 4.0
                 ) -> Tuple[torch.Tensor, Dict]:
    """One denoising step x_t -> x_{t_prev} for a (possibly heterogeneous)
    batch with per-sample integer ``t``/``t_prev``/``labels`` (B,).

    ``guidance_scale`` is a Python scalar (1.0 disables CFG and ``state``
    is sized B) or a (B,) tensor of per-sample scales, which always runs
    the doubled CFG batch; rows with scale 1.0 select the conditional eps
    outright, so they equal an unguided run of that sample exactly."""
    per_sample = isinstance(guidance_scale, torch.Tensor)
    use_cfg = per_sample or guidance_scale != 1.0
    b = x.shape[0]
    if use_cfg:
        null_label = runner.model.cfg.dit.num_classes
        x_in = torch.cat([x, x], dim=0)
        t_in = torch.cat([t, t], dim=0)
        lab = torch.cat([labels, torch.full((b,), null_label,
                                            dtype=labels.dtype,
                                            device=labels.device)])
    else:
        x_in, t_in, lab = x, t, labels
    eps, state = runner.step(state, x_in, t_in, lab)
    if use_cfg:
        eps_c, eps_u = eps.chunk(2, dim=0)
        if per_sample:
            g = guidance_scale.to(F32).reshape((b,) + (1,) * (x.ndim - 1))
            # scale 1.0 must reduce to eps_c exactly: the algebraic form
            # re-associates in float32
            eps = torch.where(g == 1.0, eps_c, eps_u + g * (eps_c - eps_u))
        else:
            eps = eps_u + guidance_scale * (eps_c - eps_u)
    return sch.ddim_step(sched, x, eps, t, t_prev), state


@torch.no_grad()
def sample(runner: CachedDiT, *, batch: int,
           labels: Optional[torch.Tensor] = None, num_steps: int = 50,
           guidance_scale: GuidanceLike = 4.0, num_train_steps: int = 1000,
           x_init: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None
           ) -> Tuple[torch.Tensor, Dict]:
    """Returns (samples (B, H, W, C) latents, final cache state).

    ``x_init`` gives the initial noise; otherwise it is drawn from
    ``generator`` (on the runner's device)."""
    cfg = runner.model.cfg
    dev = runner.device
    img, ch = cfg.dit.image_size, cfg.dit.in_channels
    if labels is None:
        labels = torch.zeros((batch,), dtype=torch.int64, device=dev)
    labels = labels.to(dev)
    use_cfg = (isinstance(guidance_scale, torch.Tensor)
               or guidance_scale != 1.0)

    sched = sch.linear_schedule(num_train_steps, device=dev)
    ts = sch.ddim_timesteps(num_train_steps, num_steps, device=dev)
    ts_prev = torch.cat([ts[1:], torch.tensor([-1], dtype=torch.int32,
                                              device=dev)])
    if x_init is not None:
        x = x_init.to(device=dev, dtype=F32)
    else:
        x = torch.randn((batch, img, img, ch), generator=generator,
                        device=dev, dtype=F32)
    state = runner.init_state(2 * batch if use_cfg else batch)
    for i in range(num_steps):
        t = ts[i].expand(batch)
        t_prev = ts_prev[i].expand(batch)
        x, state = denoise_step(runner, sched, state, x, t, t_prev, labels,
                                guidance_scale=guidance_scale)
    return x, state
