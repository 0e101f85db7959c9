"""Spatial-temporal token saliency + static/motion partition (Eqs. 1-3).

The motion set has a static capacity C: tokens are ranked by temporal
saliency; the top-C that also exceed tau_s are motion, everything else
takes the learnable-linear bypass.

Ranking uses a stable descending sort, so ties go to the lower token index
exactly as the reference's ``lax.top_k`` breaks them (``torch.topk``
promises no order).  Ties are the normal case: the first warm step and any
static input give all-zero saliency.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

F32 = torch.float32


def token_saliency(x_t: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Eq. 1: per-token squared L2 temporal difference. (B,N,D) -> (B,N)."""
    d = x_t.to(F32) - x_prev.to(F32)
    return (d * d).sum(dim=-1)


class Partition(NamedTuple):
    motion_idx: torch.Tensor    # (B, C) int64 token indices, saliency-descending
    is_motion: torch.Tensor     # (B, N) bool — in top-C AND above tau_s
    saliency: torch.Tensor      # (B, N)


def partition_tokens(saliency: torch.Tensor, tau_s: float,
                     capacity: int) -> Partition:
    """Select motion tokens: top-`capacity` by saliency, gated by tau_s."""
    n = saliency.shape[-1]
    capacity = min(capacity, n)
    order = torch.sort(saliency, dim=-1, descending=True, stable=True).indices
    idx = order[:, :capacity]
    above = torch.gather(saliency, 1, idx) > tau_s
    is_motion = torch.zeros(saliency.shape, dtype=torch.bool,
                            device=saliency.device).scatter(1, idx, above)
    return Partition(motion_idx=idx, is_motion=is_motion, saliency=saliency)


def _expand(idx: torch.Tensor, d: int) -> torch.Tensor:
    return idx[..., None].expand(idx.shape[0], idx.shape[1], d)


def gather_motion(x: torch.Tensor, part: Partition) -> torch.Tensor:
    """(B,N,D) -> (B,C,D) motion-token stream (saliency-descending order)."""
    return torch.gather(x, 1, _expand(part.motion_idx, x.shape[-1]))


def scatter_motion(base: torch.Tensor, motion: torch.Tensor,
                   part: Partition) -> torch.Tensor:
    """Write the motion stream back over `base` at its token positions,
    but only where the tau_s gate marked the token as true motion."""
    idx = _expand(part.motion_idx, base.shape[-1])
    keep = torch.gather(part.is_motion, 1, part.motion_idx)
    vals = torch.where(keep[..., None], motion.to(base.dtype),
                       torch.gather(base, 1, idx))
    return base.scatter(1, idx, vals)


def motion_fraction(part: Partition) -> torch.Tensor:
    """Per-sample fraction of tokens marked motion. (B, N) -> (B,)."""
    return part.is_motion.to(F32).mean(dim=-1)
