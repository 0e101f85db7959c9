"""nocache: full compute every step (the exact reference sampler)."""
from __future__ import annotations

from typing import Dict

from repro_torch.core.policies.base import CachePolicy, register


@register("nocache")
class NoCache(CachePolicy):
    def init_state(self, batch: int) -> Dict:
        return {"stats": self.init_stats(batch)}

    def step(self, state, x_in, c):
        x_out, _ = self._full_forward(x_in, c)
        eps = self._eps(x_out, c)
        stats = dict(state["stats"])
        stats["blocks_computed"] = stats["blocks_computed"] + float(self.L)
        stats["motion_frac_sum"] = stats["motion_frac_sum"] + 1.0
        return eps, {**state, "stats": stats}
