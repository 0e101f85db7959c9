"""adacache: content-adaptive step-skip schedule — the input distance picks
a skip budget (large change: recompute now; small change: coast for the
next few steps on the cached output) (AdaCache).

State: the previous step's token embeddings, the cached eps, the per-sample
remaining-skip budget (int32) and the warm-up flag.  The input distance
comes from the ``saliency_delta`` kernel's totals
(``CachePolicy._rel_change``).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from repro_torch.core.policies.base import CachePolicy, register

I32 = torch.int32


@register("adacache")
class AdaCache(CachePolicy):
    MIRRORED = ("have_cache",)

    def __init__(self, model, fc, fc_params, *,
                 ada_thresholds: Tuple[float, float] = (0.05, 0.15), **kw):
        super().__init__(model, fc, fc_params, **kw)
        self.thresholds = ada_thresholds

    def init_state(self, batch: int) -> Dict:
        dt, dev = self.model.dtype, self.device
        return {
            "prev_tokens_in": torch.zeros(
                (batch, self.n_tokens, self.model.cfg.d_model), dtype=dt,
                device=dev),
            "prev_eps": torch.zeros(self._eps_shape(batch), dtype=dt,
                                    device=dev),
            "ada_skip_left": torch.zeros((batch,), dtype=I32, device=dev),
            "have_cache": torch.zeros((batch,), dtype=torch.bool, device=dev),
            "stats": self.init_stats(batch),
        }

    def reset_rows(self, state: Dict, rows: Sequence[int]) -> Dict:
        for r in rows:
            state["prev_tokens_in"][r].fill_(0.0)
            state["prev_eps"][r].fill_(0.0)
            state["ada_skip_left"][r].fill_(0)
            state["have_cache"][r].fill_(False)
        return super().reset_rows(state, rows)

    def device_step(self, state, x_in, c, kind):
        prev_in = state["prev_tokens_in"]
        rel = self._rel_change(x_in, prev_in)
        lo, hi = self.thresholds
        budget = torch.where(rel < lo, 3, torch.where(rel < hi, 1, 0)).to(I32)
        left = state["ada_skip_left"]
        skip = (left > 0) & state["have_cache"]

        def store(inputs, x_out):
            prev_in.copy_(torch.where(skip[:, None, None], prev_in, x_in))

        eps = self.masked_step(state, x_in, c, skip, store=store)
        left.copy_(torch.where(skip, left - 1, budget).to(I32))
        return eps
