"""Transformer-level statistical cache gate (Eqs. 4-9), per sample.

A running (EMA) estimate sigma2 of the per-element no-change variance
turns the statistic into ||dH||_F^2 / sigma2 ~ chi^2_ND (the paper's
sliding-window tracker; see the reference's ``core/statcache.py``).  The
per-sample ||dH||_F^2 and ||H_prev||_F^2 the gates read are the totals of
the ``saliency_delta`` kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch.core.chi2 import cache_threshold

F32 = torch.float32
GATE_MODES = ("per_sample", "global")


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


def gate_decision(diff_sq: torch.Tensor, prev_sq: torch.Tensor,
                  sigma2: torch.Tensor, n_elements: int, threshold: float,
                  mode: str = "normalized") -> torch.Tensor:
    """True => cache (skip the block).  `threshold` is chi2_{ND,1-a}/ND.
    ``mode="raw"`` is the literal Eq. 7 (delta against ||H_prev||^2)."""
    if mode == "raw":
        return diff_sq / prev_sq.clamp(min=1e-12) <= threshold
    stat = diff_sq / (sigma2.clamp(min=1e-30) * n_elements)
    return stat <= threshold


def gate_decision_global(diff_sq: torch.Tensor, sigma2: torch.Tensor,
                         n_total: int, threshold: float) -> torch.Tensor:
    """Whole-batch decision from per-sample stats: the (B,) Frobenius
    deltas and trackers reduced to ONE statistic ~ chi^2_{B*ND}.
    ``threshold`` is chi2_{B*ND,1-a}/(B*ND).  Returns a 0-dim bool."""
    stat = diff_sq.sum() / (sigma2.mean().clamp(min=1e-30) * n_total)
    return stat <= threshold


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
