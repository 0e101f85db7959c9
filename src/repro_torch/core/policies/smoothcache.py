"""smoothcache: precomputed layer-schedule caching (SmoothCache-style).

A DiT layer's output changes smoothly over adjacent denoising steps, so a
schedule of (layer, step) pairs, calibrated offline from per-layer per-step
errors, says where a block's output is replaced by its input plus the
layer's cached **residual** (output minus input) from its last computed
step.  At serve time the gate is a table lookup: no statistics, no
thresholds.

State: the per-layer cached residuals (L, B, N, D), a per-sample step
counter (the schedule position, per request, so serving slots admitted
mid-flight index the schedule from their own step 0) and the warm-up flag.

``smooth_schedule`` is an (L, T) bool table (numpy or torch): True at
(l, s) reuses layer l's cached residual on that sample's step s.  Steps
beyond T clamp to the last column.  The default reuses every layer on every
other step (a 50% block-cache ratio), SmoothCache's uniform-interval
baseline.

The reference decides "every sample reuses: skip the block" per layer with
``lax.cond``.  The (L, B) mask is looked up on the device from a copy of
the schedule there; the host knows the same mask from its mirror of the
step counters and warm-up flags and its own copy of the schedule, so an
eager step decides every layer without a read, and a captured step takes
each layer's branch on the device (``branch``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.policies.base import F32, CachePolicy, register
from repro_torch.device import to_device
from repro_torch.distributed.sharding import constrain

DEFAULT_TABLE_STEPS = 1000

ScheduleLike = Union[torch.Tensor, np.ndarray]


def default_smooth_schedule(num_layers: int, *, interval: int = 2,
                            table_steps: int = DEFAULT_TABLE_STEPS
                            ) -> np.ndarray:
    """Uniform-interval schedule: every layer recomputes on step s when
    ``s % interval == 0`` and reuses its cached residual otherwise."""
    s = np.arange(table_steps)
    return np.broadcast_to(s % interval != 0, (num_layers, table_steps)).copy()


def smooth_schedule_from_errors(errors: ScheduleLike,
                                threshold: float) -> np.ndarray:
    """SmoothCache's calibration: ``errors`` (L, T) holds the relative
    change of layer l's output between steps s-1 and s measured on a
    calibration run; (l, s) is cacheable when the observed change stays
    under ``threshold``.  Column 0 always computes (nothing cached yet)."""
    if isinstance(errors, torch.Tensor):
        errors = errors.cpu().numpy()
    sched = np.asarray(errors) < threshold
    sched[:, 0] = False
    return sched


@register("smoothcache")
class SmoothCache(CachePolicy):
    def __init__(self, model, fc, fc_params, *,
                 smooth_schedule: Optional[ScheduleLike] = None, **kw):
        super().__init__(model, fc, fc_params, **kw)
        sched = (default_smooth_schedule(self.L) if smooth_schedule is None
                 else smooth_schedule)
        if isinstance(sched, torch.Tensor):
            sched = sched.cpu().numpy()
        self.schedule = np.asarray(sched, dtype=bool)
        if self.schedule.ndim != 2 or self.schedule.shape[0] != self.L:
            raise ValueError(
                f"smooth_schedule has {self.schedule.shape[0]} layer rows; "
                f"model has {self.L} layers")
        self.schedule_dev = to_device(self.schedule, self.device)

    MIRRORED = ("have_cache", "step_count")

    def init_state(self, batch: int) -> Dict:
        dev = self.device
        return {
            "prev_delta": torch.zeros(
                (self.L, batch, self.n_tokens, self.model.cfg.d_model),
                dtype=self.model.dtype, device=dev),
            "step_count": torch.zeros((batch,), dtype=torch.int32,
                                      device=dev),
            "have_cache": torch.zeros((batch,), dtype=torch.bool, device=dev),
            "stats": self.init_stats(batch),
        }

    def reset_rows(self, state: Dict, rows: Sequence[int]) -> Dict:
        for r in rows:
            state["prev_delta"][:, r].fill_(0.0)
            state["step_count"][r].fill_(0)
            state["have_cache"][r].fill_(False)
        return super().reset_rows(state, rows)

    def device_step(self, state, x_in, c, kind):
        b = x_in.shape[0]
        dev = x_in.device
        last = self.schedule.shape[1] - 1
        # the (L, B) mask on the device, and the host's copy from its mirror
        pos = state["step_count"].clamp(0, last).to(torch.int64)
        skip_dev = self.schedule_dev[:, pos] & state["have_cache"][None, :]
        host = self.host_flags(state)
        skip = (self.schedule[:, np.clip(host["step_count"], 0, last)]
                & host["have_cache"][None, :])
        x = x_in
        comp = torch.zeros((b,), dtype=F32, device=dev)
        skipped = torch.zeros((b,), dtype=F32, device=dev)
        for lidx, bp in enumerate(self.model.blocks):
            skip_l = skip_dev[lidx]
            delta = state["prev_delta"][lidx]
            # the carry holds the all-reuse side; a batch where some sample
            # recomputes runs the block once and keeps the reusing samples'
            # residual sum (the same bits as the all-reuse side for them)
            carry = x + delta

            def compute(x=x, bp=bp, carry=carry, skip_l=skip_l):
                carry.copy_(torch.where(skip_l[:, None, None], carry,
                                        self.model.block_apply(bp, x, c)))

            self.branch(skip_l, compute, known=bool(skip[lidx].all()))
            x_new = constrain(carry, "act_batch", "act_seq", "act_embed")
            delta.copy_(torch.where(skip_l[:, None, None], delta, x_new - x))
            sk = skip_l.to(F32)
            comp = comp + (1.0 - sk)
            skipped = skipped + sk
            x = x_new
        eps = self._eps(x, c)

        state["step_count"].add_(1)
        state["have_cache"].fill_(True)
        stats = state["stats"]
        stats["blocks_computed"].add_(comp)
        stats["blocks_skipped"].add_(skipped)
        stats["motion_frac_sum"].add_(1.0)
        return eps
