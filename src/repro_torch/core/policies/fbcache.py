"""fbcache: first-block gate — run block 0 as a probe; if its output moved
less than ``rdt`` relative to the previous step, reuse the previous step's
model output (FBCache / ParaAttention).

State: block 0's previous output (the probe reference), the cached eps and
the warm-up flag.  The relative change comes from the ``saliency_delta``
kernel's totals (``CachePolicy._rel_change``).  A recomputing step runs the
whole stack, block 0 again included, as the reference does.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from repro_torch.core.policies.base import CachePolicy, register


@register("fbcache")
class FirstBlockCache(CachePolicy):
    MIRRORED = ("have_cache",)

    def __init__(self, model, fc, fc_params, *, fb_rdt: float = 0.08, **kw):
        super().__init__(model, fc, fc_params, **kw)
        self.rdt = fb_rdt

    def init_state(self, batch: int) -> Dict:
        dt, dev = self.model.dtype, self.device
        return {
            "prev_h1": torch.zeros(
                (batch, self.n_tokens, self.model.cfg.d_model), dtype=dt,
                device=dev),
            "prev_eps": torch.zeros(self._eps_shape(batch), dtype=dt,
                                    device=dev),
            "have_cache": torch.zeros((batch,), dtype=torch.bool, device=dev),
            "stats": self.init_stats(batch),
        }

    def reset_rows(self, state: Dict, rows: Sequence[int]) -> Dict:
        for r in rows:
            state["prev_h1"][r].fill_(0.0)
            state["prev_eps"][r].fill_(0.0)
            state["have_cache"][r].fill_(False)
        return super().reset_rows(state, rows)

    def device_step(self, state, x_in, c, kind):
        prev_h1 = state["prev_h1"]
        h1 = self.model.block_apply(self.model.blocks[0], x_in, c)
        rel = self._rel_change(h1, prev_h1)
        skip = (rel < self.rdt) & state["have_cache"]

        def store(inputs, x_out):
            # block 0's output = block 1's input (or the final output when
            # the stack is a single block)
            h1_new = inputs[1] if self.L > 1 else x_out
            prev_h1.copy_(torch.where(skip[:, None, None], prev_h1, h1_new))

        return self.masked_step(state, x_in, c, skip, computed_on_skip=1.0,
                                store=store)
