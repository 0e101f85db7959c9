"""CachedDiT: a thin shell around the cache-policy registry.

  init_state(batch)           -> policy.init_state
  reset_slot(state, rows)     -> policy.reset_rows (re-arm serving slot rows;
                                 stats stay cumulative)
  snapshot_slot(state, rows)  -> policy.snapshot_rows (a preemption
                                 checkpoint of the rows, a copy)
  restore_slot(state, snap, rows)
                              -> policy.restore_rows (write it back, in place)
  step(state, latents, t, labels)
                              -> tokens_in + conditioning, then
                                 policy.step(state, x, c)
  stats(state)                -> policy.stats

Gating is per sample: one moving sample never invalidates its batchmates'
caches, which the serving engine's solo-replay contract rests on.
``FastCacheConfig.gate_mode="global"`` restores the whole-batch decision
(the statistic reduced over the batch) for ablations.

Token compression (``core/token_reduce.py``) runs between ``tokens_in`` and
the policy when ``fc.merge_enabled`` asks for it: the policy sees the
reduced grid and unmerges inside ``_eps``.  Every registered policy composes
with it.

The audit plane (``obs/audit.py``) reads three more: ``audit_eval`` (the
uncached full forward of the same inputs), ``audit_hidden`` (the cached
path's hidden stack) and ``audit_bound`` (the policy's claimed bound).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import FastCacheConfig
from repro_torch.core import linear_approx
from repro_torch.core import policies as _policies  # noqa: F401 (registers)
from repro_torch.core.policies.base import Rows, get_policy_class, row_index
from repro_torch.core.policies.l2c import l2c_mask_from_deltas  # noqa: F401
from repro_torch.core.statcache import GATE_MODES
from repro_torch.core.token_reduce import STATE_KEY as TOKRED_KEY
from repro_torch.core.token_reduce import TokenReducer
from repro_torch.cuda_kernels import route
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
        if fc.gate_mode not in GATE_MODES:
            raise ValueError(f"unknown gate_mode {fc.gate_mode!r}; "
                             f"expected one of {GATE_MODES}")
        self.model = model
        self.fc = fc
        self.policy = policy
        self.device = model.device
        self.gate_mode = fc.gate_mode
        self.L = model.cfg.num_layers
        # the identity maps of init_linear_params, which bf16 holds exactly,
        # get bf16 copies for the wgmma route; maps handed in (fitted by
        # calibrate_dit) get none, and every call on them names the SIMT
        # route, which multiplies the f32 W: a bf16 copy of fitted maps
        # moved the static bypass by up to 8% rel-L2 on the card (PERF.md)
        gemm = None if fc_params is None else route.SIMT
        self.fc_params = fc_params or linear_approx.init_linear_params(
            self.L, model.cfg.d_model, model.device)
        # a ratio whose static M fills the window leaves the reducer inert
        # and it is dropped, so r=1.0 runs exactly the merge-off step
        self.reducer: Optional[TokenReducer] = None
        if fc.merge_enabled:
            red = TokenReducer(model, fc)
            if red.active:
                self.reducer = red
        self.impl = cls(model, fc, self.fc_params, gate_mode=self.gate_mode,
                        gemm=gemm, token_reducer=self.reducer,
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

    def snapshot_slot(self, state: Dict, rows: Rows) -> Dict:
        """Copy ``rows`` (a list of ints, or an int64 index tensor on the
        device) out of the state: the policy's rows by its rank rule
        (``CachePolicy.snapshot_rows``), the reducer's ``tokred`` rows when
        token compression is on.  The snapshot owns its memory."""
        idx = row_index(rows, self.device)
        snap = self.impl.snapshot_rows(
            {k: v for k, v in state.items() if k != TOKRED_KEY}, idx)
        if self.reducer is not None:
            snap[TOKRED_KEY] = self.reducer.snapshot_rows(state[TOKRED_KEY],
                                                          idx)
        return snap

    def restore_slot(self, state: Dict, snap: Dict, rows: Rows) -> Dict:
        """Write a ``snapshot_slot`` checkpoint into ``rows`` of the live
        state, in place and bitwise; ``rows`` may differ from the donor
        slot's."""
        idx = row_index(rows, self.device)
        out = self.impl.restore_rows(
            {k: v for k, v in state.items() if k != TOKRED_KEY},
            {k: v for k, v in snap.items() if k != TOKRED_KEY}, idx)
        if self.reducer is not None:
            out[TOKRED_KEY] = self.reducer.restore_rows(
                state[TOKRED_KEY], snap[TOKRED_KEY], idx)
        return out

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

    # -- audit plane (obs/audit.py) ------------------------------------

    @torch.no_grad()
    def audit_eval(self, latents: torch.Tensor, t: torch.Tensor,
                   labels: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The shadow-compute twin of ``step``: the same tokens-in /
        conditioning feeding the policy's uncached full forward.  Returns
        ``(eps_true, hidden)``, hidden the (L+1, B, N, D) stack of
        ``CachePolicy.audit_forward``.  Touches no cache state or stats."""
        x_in = self.model.tokens_in(latents)
        c = self.model.conditioning(t, labels)
        return self.impl.audit_forward(x_in, c)

    def audit_hidden(self, state: Dict) -> Optional[torch.Tensor]:
        """The cached path's per-layer hidden stack for this step, or None
        when the policy keeps none.  With token compression on the stack
        lives on the reduced grid and cannot be compared layer by layer
        with the full-resolution shadow forward, so only the end-to-end eps
        error is audited."""
        if self.reducer is not None:
            return None
        return self.impl.audit_hidden(state)

    def audit_bound(self) -> Optional[float]:
        """The policy's claimed per-step relative error bound (None = no
        claim; see ``CachePolicy.predicted_error_bound``)."""
        return self.impl.predicted_error_bound()
