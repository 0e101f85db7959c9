"""CachedDiT: a thin shell around the cache-policy registry.

  init_state(batch)           -> policy.init_state
  reset_slot(state, rows)     -> policy.reset_rows (re-arm serving slot rows;
                                 stats stay cumulative)
  step(state, latents, t, labels)
                              -> tokens_in + conditioning, then
                                 policy.step(state, x, c)
  stats(state)                -> policy.stats

Gating is per sample: one moving sample never invalidates its batchmates'
caches, which the serving engine's solo-replay contract rests on.

Token compression (``core/token_reduce.py``) runs between ``tokens_in`` and
the policy when ``fc.merge_enabled`` asks for it: the policy sees the
reduced grid and unmerges inside ``_eps``.  Every registered policy composes
with it.  The audit plane is not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import FastCacheConfig
from repro_torch.core import linear_approx
from repro_torch.core import policies as _policies  # noqa: F401 (registers)
from repro_torch.core.policies.base import get_policy_class
from repro_torch.core.policies.l2c import l2c_mask_from_deltas  # noqa: F401
from repro_torch.core.token_reduce import STATE_KEY as TOKRED_KEY
from repro_torch.core.token_reduce import TokenReducer
from repro_torch.models.dit import DiTModel


class CachedDiT:
    """DiT sampling under a named cache policy."""

    def __init__(self, model: DiTModel, fc: FastCacheConfig,
                 policy: str = "fastcache",
                 fc_params: Optional[Dict[str, torch.Tensor]] = None,
                 fora_interval: int = 3,
                 tea_threshold: float = 0.15,
                 ada_thresholds: Tuple[float, float] = (0.05, 0.15),
                 fb_rdt: float = 0.08,
                 l2c_mask=None,
                 **policy_kwargs):
        """The per-policy knobs are the reference's front-door keywords;
        with ``**policy_kwargs`` (e.g. smoothcache's ``smooth_schedule``)
        the whole set goes to the resolved policy, which keeps the ones it
        knows.  Masks and schedules may be numpy or torch bool arrays."""
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
        # a ratio whose static M fills the window leaves the reducer inert
        # and it is dropped, so r=1.0 runs exactly the merge-off step
        self.reducer: Optional[TokenReducer] = None
        if fc.merge_enabled:
            red = TokenReducer(model, fc)
            if red.active:
                self.reducer = red
        self.impl = cls(model, fc, self.fc_params, token_reducer=self.reducer,
                        fora_interval=fora_interval,
                        tea_threshold=tea_threshold,
                        ada_thresholds=ada_thresholds, fb_rdt=fb_rdt,
                        l2c_mask=l2c_mask, **policy_kwargs)

    def init_state(self, batch: int) -> Dict:
        """The policy's state for ``batch`` samples; with token compression
        on, the reducer's per-sample rows ride it under ``tokred``."""
        state = self.impl.init_state(batch)
        if self.reducer is not None:
            state[TOKRED_KEY] = self.reducer.init_rows(batch)
        return state

    def reset_slot(self, state: Dict, rows: Sequence[int]) -> Dict:
        """Re-arm the given sample rows (e.g. a slot's CFG cond/uncond pair)
        for a new request, in place, without disturbing batchmates."""
        state = self.impl.reset_rows(state, rows)
        if self.reducer is not None:
            self.reducer.reset_rows(state[TOKRED_KEY], rows)
        return state

    @torch.no_grad()
    def step(self, state: Dict, latents: torch.Tensor, t: torch.Tensor,
             labels: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """One denoising-model evaluation under the cache policy.  ``t`` and
        ``labels`` are (B,).  Returns (eps, new_state)."""
        x_in = self.model.tokens_in(latents)
        c = self.model.conditioning(t, labels)
        if self.reducer is not None:
            x_in, tokred = self.reducer.reduce(x_in, state[TOKRED_KEY])
            state = {**state, TOKRED_KEY: tokred}
        try:
            eps, state = self.impl.step(state, x_in, c)
        finally:
            if self.reducer is not None:
                self.reducer._mm = None      # the MergeMap is per step only
        stats = dict(state["stats"])
        stats["steps"] = stats["steps"] + 1.0
        if self.reducer is not None:
            kept = float(self.reducer.reduced_tokens)
            stats["tokens_kept"] = stats["tokens_kept"] + kept
            stats["tokens_merged"] = (stats["tokens_merged"]
                                      + (self.model.num_tokens - kept))
        return eps, {**state, "stats": stats}

    def stats(self, state: Dict) -> Dict[str, float]:
        return self.impl.stats(state)
