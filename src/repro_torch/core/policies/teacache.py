"""teacache: accumulated input-change gate — skip whole steps while the
accumulated relative change of the token embeddings stays under a
threshold (TeaCache).

State: the previous step's token embeddings (the statistic's reference),
the cached eps, the per-sample change accumulator and the warm-up flag.
The relative change comes from the ``saliency_delta`` kernel's totals
(``CachePolicy._rel_change``).
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from repro_torch.core.policies.base import F32, CachePolicy, register


@register("teacache")
class TeaCache(CachePolicy):
    MIRRORED = ("have_cache",)

    def __init__(self, model, fc, fc_params, *, tea_threshold: float = 0.15,
                 **kw):
        super().__init__(model, fc, fc_params, **kw)
        self.threshold = tea_threshold

    def init_state(self, batch: int) -> Dict:
        dt, dev = self.model.dtype, self.device
        return {
            "prev_tokens_in": torch.zeros(
                (batch, self.n_tokens, self.model.cfg.d_model), dtype=dt,
                device=dev),
            "prev_eps": torch.zeros(self._eps_shape(batch), dtype=dt,
                                    device=dev),
            "tea_acc": torch.zeros((batch,), dtype=F32, device=dev),
            "have_cache": torch.zeros((batch,), dtype=torch.bool, device=dev),
            "stats": self.init_stats(batch),
        }

    def reset_rows(self, state: Dict, rows: Sequence[int]) -> Dict:
        for r in rows:
            state["prev_tokens_in"][r].fill_(0.0)
            state["prev_eps"][r].fill_(0.0)
            state["tea_acc"][r].fill_(0.0)
            state["have_cache"][r].fill_(False)
        return super().reset_rows(state, rows)

    def device_step(self, state, x_in, c, kind):
        prev_in = state["prev_tokens_in"]
        rel = self._rel_change(x_in, prev_in)
        acc = state["tea_acc"] + rel
        skip = (acc < self.threshold) & state["have_cache"]

        def store(inputs, x_out):
            prev_in.copy_(torch.where(skip[:, None, None], prev_in, x_in))

        eps = self.masked_step(state, x_in, c, skip, store=store)
        state["tea_acc"].copy_(torch.where(skip, acc, torch.zeros_like(acc)))
        return eps
