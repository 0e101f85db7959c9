"""CachedDiT: a thin shell around the cache-policy registry.

  init_state(batch)           -> policy.init_state
  reset_slot(state, rows)     -> policy.reset_rows (re-arm serving slot rows;
                                 stats stay cumulative)
  step(state, latents, t, labels)
                              -> tokens_in + conditioning, then
                                 policy.step(state, x, c)
  stats(state)                -> policy.stats

Gating is per sample: one moving sample never invalidates its batchmates'
caches, which the serving engine's solo-replay contract rests on.  Token
merging and the audit plane are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import FastCacheConfig
from repro_torch.core import linear_approx
from repro_torch.core import policies as _policies  # noqa: F401 (registers)
from repro_torch.core.policies.base import get_policy_class
from repro_torch.models.dit import DiTModel


class CachedDiT:
    """DiT sampling under a named cache policy."""

    def __init__(self, model: DiTModel, fc: FastCacheConfig,
                 policy: str = "fastcache",
                 fc_params: Optional[Dict[str, torch.Tensor]] = None):
        cls = get_policy_class(policy)     # ValueError on unknown names
        if fc.gate_mode != "per_sample":
            raise ValueError("the port implements gate_mode='per_sample' "
                             f"only, got {fc.gate_mode!r}")
        self.model = model
        self.fc = fc
        self.policy = policy
        self.device = model.device
        self.gate_mode = fc.gate_mode
        self.L = model.cfg.num_layers
        self.fc_params = fc_params or linear_approx.init_linear_params(
            self.L, model.cfg.d_model, model.device)
        self.impl = cls(model, fc, self.fc_params)

    def init_state(self, batch: int) -> Dict:
        return self.impl.init_state(batch)

    def reset_slot(self, state: Dict, rows: Sequence[int]) -> Dict:
        """Re-arm the given sample rows (e.g. a slot's CFG cond/uncond pair)
        for a new request, in place, without disturbing batchmates."""
        return self.impl.reset_rows(state, rows)

    @torch.no_grad()
    def step(self, state: Dict, latents: torch.Tensor, t: torch.Tensor,
             labels: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """One denoising-model evaluation under the cache policy.  ``t`` and
        ``labels`` are (B,).  Returns (eps, new_state)."""
        x_in = self.model.tokens_in(latents)
        c = self.model.conditioning(t, labels)
        eps, state = self.impl.step(state, x_in, c)
        stats = dict(state["stats"])
        stats["steps"] = stats["steps"] + 1.0
        return eps, {**state, "stats": stats}

    def stats(self, state: Dict) -> Dict[str, float]:
        return self.impl.stats(state)
