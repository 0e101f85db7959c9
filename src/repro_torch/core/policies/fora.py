"""fora: static-interval step cache — recompute every N-th step, else reuse
the previous step's model output (FORA).

State: the cached eps, a per-sample step counter (the interval counts from
0 for every request, so serving slots admitted mid-flight keep their own
schedule phase) and the warm-up flag.  The gate is purely positional, so
the host knows it from its mirror of the counter and the flag and reads
nothing; a captured step takes it on the device.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.core.policies.base import CachePolicy, register


@register("fora")
class FORA(CachePolicy):
    MIRRORED = ("have_cache", "step_count")

    def __init__(self, model, fc, fc_params, *, fora_interval: int = 3,
                 **kw):
        super().__init__(model, fc, fc_params, **kw)
        self.interval = fora_interval

    def init_state(self, batch: int) -> Dict:
        dev = self.device
        return {
            "prev_eps": torch.zeros(self._eps_shape(batch),
                                    dtype=self.model.dtype, device=dev),
            "step_count": torch.zeros((batch,), dtype=torch.int32,
                                      device=dev),
            "have_cache": torch.zeros((batch,), dtype=torch.bool, device=dev),
            "stats": self.init_stats(batch),
        }

    def reset_rows(self, state: Dict, rows: Sequence[int]) -> Dict:
        for r in rows:
            state["prev_eps"][r].fill_(0.0)
            state["step_count"][r].fill_(0)
            state["have_cache"][r].fill_(False)
        return super().reset_rows(state, rows)

    def device_step(self, state, x_in, c, kind):
        count = state["step_count"]
        recompute = count % self.interval == 0                    # (B,)
        skip = ~recompute & state["have_cache"]
        host = self.host_flags(state)
        known = bool(np.all((host["step_count"] % self.interval != 0)
                            & host["have_cache"]))
        eps = self.masked_step(state, x_in, c, skip, known=known)
        count.add_(1)
        return eps
