"""Graceful degradation: shed-level ladders under queue pressure.

``DegradationController`` watches the ready-queue depth each control-plane
tick and walks a ladder of ``ShedLevel``s with watermark+patience
hysteresis: sustained depth at or above ``high_watermark`` escalates one
level, sustained depth at or below ``low_watermark`` de-escalates, and
anything in between resets both streaks — so a single bursty tick never
flips the level back and forth.

Each level carries three knobs:

- ``steps_scale`` — multiply admitted requests' step budgets (the live
  knob: step budgets are per-slot plan state, so a shrunk budget is just
  a different plan row written at admission).  Applied per priority
  class: classes below ``min_priority`` are protected and keep their
  full budget.
- ``alpha`` — the chi^2 gate significance for the cache-skip threshold
  (``core/chi2.py``: SMALLER alpha -> higher threshold -> more skips ->
  larger bounded error).
- ``capacity_scale`` — multiply fastcache's STR motion capacity
  (``FastCacheConfig.motion_capacity``): a smaller motion stream routes
  more tokens through the learnable-linear static bypass every step —
  less work per model step, more approximation error — which moves
  the cache ratio even at scales where the chi^2 stat sits far above any
  reachable threshold.

``alpha`` and ``capacity_scale`` are applied per engine at construction
(``FastCacheConfig(alpha=..., motion_capacity=...)``), not flipped live,
as in the reference, whose jitted step bakes both in (the motion capacity
is a gather shape): an overload benchmark builds one engine per ladder
rung and the audit plane measures the quality cost of each.

The controller is pure host bookkeeping; its only outputs are mutated
step budgets on not-yet-admitted requests and the ``shed_level`` /
``queue_depth_ready`` gauges.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.obs import metrics as obs_metrics
from repro_torch.serving.scheduler import DiffusionRequest


@dataclasses.dataclass(frozen=True)
class ShedLevel:
    """One rung of a degradation ladder.  ``steps_scale`` shrinks admitted
    step budgets (1.0 = none); ``alpha`` is the chi^2 gate significance an
    engine serving this rung should be constructed with (None = policy
    default); ``capacity_scale`` shrinks fastcache's STR motion capacity
    at engine construction (1.0 = none); classes numbered below
    ``min_priority`` are protected from budget shedding."""
    name: str
    steps_scale: float = 1.0
    alpha: Optional[float] = None
    capacity_scale: float = 1.0
    min_priority: int = 1

    def __post_init__(self):
        if not 0.0 < self.steps_scale <= 1.0:
            raise ValueError(f"ShedLevel {self.name!r}: steps_scale must "
                             f"be in (0, 1], got {self.steps_scale}")
        if not 0.0 < self.capacity_scale <= 1.0:
            raise ValueError(f"ShedLevel {self.name!r}: capacity_scale "
                             f"must be in (0, 1], got "
                             f"{self.capacity_scale}")


DEFAULT_SHED_LEVELS = (
    ShedLevel("nominal"),
    ShedLevel("shed-1", steps_scale=0.75),
    ShedLevel("shed-2", steps_scale=0.5),
)


class DegradationController:
    """Watermark+patience hysteresis over a ``ShedLevel`` ladder."""

    def __init__(self, levels: Sequence[ShedLevel] = DEFAULT_SHED_LEVELS,
                 *, high_watermark: int = 8, low_watermark: int = 2,
                 patience: int = 4, min_steps: int = 2,
                 start_level: int = 0, collector=None):
        levels = tuple(levels)
        if not levels:
            raise ValueError("DegradationController needs >= 1 ShedLevel")
        if low_watermark >= high_watermark:
            raise ValueError(
                f"low_watermark ({low_watermark}) must be < high_watermark "
                f"({high_watermark}) or the hysteresis band is empty")
        if not 0 <= start_level < len(levels):
            raise ValueError(f"start_level {start_level} out of range for "
                             f"{len(levels)} levels")
        self.levels = levels
        self.level_idx = start_level
        self.high_watermark = int(high_watermark)
        self.low_watermark = int(low_watermark)
        self.patience = int(patience)
        self.min_steps = int(min_steps)
        self.collector = collector
        self._hi_streak = 0
        self._lo_streak = 0

    @property
    def level(self) -> ShedLevel:
        return self.levels[self.level_idx]

    def observe(self, depth: int) -> ShedLevel:
        """Fold one tick's ready-queue depth into the hysteresis state and
        return the (possibly changed) active level."""
        if depth >= self.high_watermark:
            self._hi_streak += 1
            self._lo_streak = 0
        elif depth <= self.low_watermark:
            self._lo_streak += 1
            self._hi_streak = 0
        else:
            self._hi_streak = 0
            self._lo_streak = 0
        if (self._hi_streak >= self.patience
                and self.level_idx < len(self.levels) - 1):
            self.level_idx += 1
            self._hi_streak = 0
        elif self._lo_streak >= self.patience and self.level_idx > 0:
            self.level_idx -= 1
            self._lo_streak = 0
        if self.collector is not None:
            self.collector.observe(obs_metrics.QUEUE_DEPTH, depth)
            self.collector.set_gauge("shed_level", float(self.level_idx))
        return self.level

    def scale_request(self, req: DiffusionRequest, *,
                      default_steps: int) -> None:
        """Apply the active level's budget shedding to a not-yet-admitted
        request (in place, so the engine resolves and records the shed
        plan).  Protected classes and resumed requests are left alone —
        the caller gates on ``req.snapshot`` for the latter."""
        lvl = self.level
        if req.priority < lvl.min_priority or lvl.steps_scale >= 1.0:
            return
        base = (req.num_steps if req.num_steps is not None
                else default_steps)
        req.num_steps = max(self.min_steps,
                            int(round(base * lvl.steps_scale)))
