"""The CachePolicy protocol, registry, and shared machinery.

A cache policy owns a dict of per-sample state tensors whose batch rows are
the serving slots (see the reference's ``core/policies/base.py`` for the
full contract).  The port's protocol:

  init_state(batch) -> dict     the policy's buffers plus the ``stats`` block
  reset_rows(state, rows)       re-arm sample rows (a list of ints) in place
  step(state, x_in, c)          one model evaluation -> (eps, new state); the
                                input state's tensors are not modified
  stats(state)                  host-side summary (``summarize_stats``)

``state["stats"]`` holds per-sample (B,) f32 counters ``blocks_computed /
blocks_skipped / steps_reused / motion_frac_sum`` plus the scalar ``steps``.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple, Type

import torch

from repro_torch.models.dit import DiTModel

F32 = torch.float32

_REGISTRY: Dict[str, Type["CachePolicy"]] = {}


def register(name: str) -> Callable[[Type["CachePolicy"]],
                                    Type["CachePolicy"]]:
    """Class decorator: register a CachePolicy under ``name``."""
    def deco(cls: Type["CachePolicy"]) -> Type["CachePolicy"]:
        if name in _REGISTRY and _REGISTRY[name] is not cls:
            raise ValueError(f"cache policy {name!r} already registered "
                             f"({_REGISTRY[name].__qualname__})")
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def registered_policies() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def get_policy_class(name: str) -> Type["CachePolicy"]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown cache policy {name!r}; registered policies: "
            f"{', '.join(registered_policies()) or '(none)'}") from None


class CachePolicy:
    """Base class: holds the model and FastCache config and provides the
    shared forward / eps / statistics helpers."""

    name: str = ""

    def __init__(self, model: DiTModel, fc, fc_params):
        self.model = model
        self.fc = fc
        self.fc_params = fc_params
        self.L = model.cfg.num_layers
        self.n_tokens = model.num_tokens
        self.device = model.device
        # host syncs this policy forced (one per `.item()`-like read)
        self.host_syncs = 0

    def init_state(self, batch: int) -> Dict:
        raise NotImplementedError

    def reset_rows(self, state: Dict, rows: Sequence[int]) -> Dict:
        """Default: nothing policy-specific to re-arm."""
        return state

    def step(self, state: Dict, x_in: torch.Tensor, c: torch.Tensor
             ) -> Tuple[torch.Tensor, Dict]:
        raise NotImplementedError

    def stats(self, state: Dict) -> Dict[str, float]:
        return summarize_stats(state)

    def init_stats(self, batch: int) -> Dict[str, torch.Tensor]:
        z = lambda: torch.zeros((batch,), dtype=F32, device=self.device)
        return {"blocks_computed": z(), "blocks_skipped": z(),
                "steps_reused": z(), "motion_frac_sum": z(),
                "steps": torch.zeros((), dtype=F32, device=self.device)}

    def _full_forward(self, x: torch.Tensor, c: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full block-stack forward.  Returns ``(x_out, inputs)`` where
        ``inputs`` (L, B, N, D) stacks each block's input."""
        inputs = []
        for bp in self.model.blocks:
            inputs.append(x)
            x = self.model.block_apply(bp, x, c)
        return x, torch.stack(inputs)

    def _eps(self, hidden_final: torch.Tensor, c: torch.Tensor
             ) -> torch.Tensor:
        return self.model.eps_from_hidden(hidden_final, c)


def summarize_stats(state: Dict) -> Dict[str, float]:
    """Batch-mean view of the per-sample accumulators (host-side)."""
    s = state.get("stats", {})

    def mean(k):
        v = s.get(k)
        return 0.0 if v is None else float(v.to(F32).mean())

    steps = float(s["steps"]) if "steps" in s else 0.0
    computed = mean("blocks_computed")
    skipped = mean("blocks_skipped")
    reused = mean("steps_reused")
    total = computed + skipped
    out = {
        "steps": steps,
        "steps_reused": reused,
        "blocks_computed": computed,
        "blocks_skipped": skipped,
        "block_cache_ratio": skipped / total if total else 0.0,
        "mean_motion_fraction": (mean("motion_frac_sum")
                                 / max(1.0, steps - reused)),
    }
    out["per_sample"] = {
        k: [float(v) for v in s[k].cpu()]
        for k in ("blocks_computed", "blocks_skipped", "steps_reused",
                  "motion_frac_sum") if k in s}
    return out
