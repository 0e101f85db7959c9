"""DDPM noise schedule + DDIM step math (the paper's inference setting:
50 DDIM steps, classifier-free guidance)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import DeviceLike, resolve_device

F32 = torch.float32


class Schedule(NamedTuple):
    betas: torch.Tensor          # (T,)
    alphas_cum: torch.Tensor     # (T,) cumulative prod of (1 - beta)


def linear_schedule(num_train_steps: int = 1000, beta_start: float = 1e-4,
                    beta_end: float = 0.02,
                    device: DeviceLike = "cuda") -> Schedule:
    dev = resolve_device(device)
    betas = torch.linspace(beta_start, beta_end, num_train_steps, dtype=F32,
                           device=dev)
    return Schedule(betas=betas, alphas_cum=torch.cumprod(1.0 - betas, 0))


def ddim_timesteps(num_train_steps: int, num_inference_steps: int,
                   device: DeviceLike = "cuda") -> torch.Tensor:
    """Descending evenly-spaced timesteps (50-step default)."""
    step = num_train_steps // num_inference_steps
    return torch.arange(num_train_steps - 1, -1, -step, dtype=torch.int32,
                        device=resolve_device(device))


def ddim_step(sched: Schedule, x_t: torch.Tensor, eps: torch.Tensor,
              t: torch.Tensor, t_prev: torch.Tensor) -> torch.Tensor:
    """Deterministic DDIM update x_t -> x_{t_prev} (eta=0) with (B,)
    per-sample integer timesteps; ``t_prev < 0`` is the x0 prediction."""
    ac_t = sched.alphas_cum[t.long()]
    ac_p = torch.where(t_prev >= 0,
                       sched.alphas_cum[t_prev.clamp(min=0).long()],
                       torch.ones_like(ac_t))
    shape = (-1,) + (1,) * (x_t.ndim - 1)
    ac_t = ac_t.reshape(shape)
    ac_p = ac_p.reshape(shape)
    x_t = x_t.to(F32)
    eps = eps.to(F32)
    x0 = (x_t - torch.sqrt(1.0 - ac_t) * eps) / torch.sqrt(ac_t)
    return torch.sqrt(ac_p) * x0 + torch.sqrt(1.0 - ac_p) * eps
