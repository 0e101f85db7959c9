"""Transformer-level statistical cache gate (Eqs. 4-9), per sample.

A running (EMA) estimate sigma2 of the per-element no-change variance
turns the statistic into ||dH||_F^2 / sigma2 ~ chi^2_ND (the paper's
sliding-window tracker; see the reference's ``core/statcache.py``).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch.core.chi2 import cache_threshold

F32 = torch.float32


class GateState(NamedTuple):
    sigma2: torch.Tensor       # (L, B) EMA of no-change per-element variance
    initialized: torch.Tensor  # (L, B) bool


def init_gate_state(num_blocks: int, batch: int,
                    device: torch.device) -> GateState:
    """Per-(layer, sample) trackers."""
    return GateState(
        sigma2=torch.ones((num_blocks, batch), dtype=F32, device=device),
        initialized=torch.zeros((num_blocks, batch), dtype=torch.bool,
                                device=device))


def reset_gate_slot(gate: GateState, rows: Sequence[int]) -> GateState:
    """Re-arm the given samples' trackers, in place."""
    for r in rows:
        gate.sigma2[:, r].fill_(1.0)
        gate.initialized[:, r].fill_(False)
    return gate


def delta_stats_per_sample(h: torch.Tensor, h_prev: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample Frobenius stats: sums over every axis but the leading
    batch axis.  h: (B, ...) -> ((B,), (B,)) in f32."""
    dims = tuple(range(1, h.ndim))
    d = h.to(F32) - h_prev.to(F32)
    pf = h_prev.to(F32)
    return (d * d).sum(dim=dims), (pf * pf).sum(dim=dims)


def update_sigma(state_sigma2: torch.Tensor, state_init: torch.Tensor,
                 diff_sq: torch.Tensor, n_elements: int,
                 momentum: float = 0.7) -> Tuple[torch.Tensor, torch.Tensor]:
    """EMA-update the no-change variance from an observed per-element
    mean-square difference (called on recompute steps)."""
    obs = diff_sq / n_elements
    new = torch.where(state_init,
                      momentum * state_sigma2 + (1.0 - momentum) * obs, obs)
    return new, torch.ones_like(state_init) | state_init


def make_threshold(alpha: float, n_elements: int) -> float:
    return cache_threshold(alpha, n_elements)
