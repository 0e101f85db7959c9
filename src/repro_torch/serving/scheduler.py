"""Request scheduling for the diffusion serving engine: per-request
``SamplingPlan``s (heterogeneous DDIM step counts + guidance scales), an
arrival-gated queue (FIFO or shortest-job-first) and Poisson arrival
traces.  Pure numpy, as in the reference; traces are seeded with ``seed=``
only and replay the reference's streams draw for draw.

Time is measured in engine steps (one ``serve_step`` = one clock tick).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SCHED_POLICIES = ("fifo", "sjf")


@dataclasses.dataclass(frozen=True)
class SamplingPlan:
    """One request's denoising schedule: DDIM step budget + CFG guidance."""
    num_steps: int
    guidance_scale: float = 4.0

    def __post_init__(self):
        if self.num_steps < 1:
            raise ValueError(f"SamplingPlan needs num_steps >= 1, got "
                             f"{self.num_steps}")

    def rows(self, max_steps: int,
             num_train_steps: int = 1000) -> Tuple[np.ndarray, np.ndarray]:
        """Padded ``(ts, ts_prev)`` rows, each ``(max_steps,)`` int32: entry
        ``i`` is the ``t`` that ``sample()`` uses on its ``i``-th step under
        the same ``num_steps``; positions past ``num_steps`` are padding
        (``t=0, t_prev=-1``) that an active slot never reads."""
        if self.num_steps > max_steps:
            raise ValueError(
                f"plan has num_steps={self.num_steps} > the engine's "
                f"max_steps={max_steps} table width")
        stride = num_train_steps // self.num_steps
        ts_full = np.arange(num_train_steps - 1, -1, -stride, dtype=np.int32)
        prev_full = np.append(ts_full[1:], np.int32(-1))
        ts = np.zeros((max_steps,), np.int32)
        prev = np.full((max_steps,), -1, np.int32)
        ts[:self.num_steps] = ts_full[:self.num_steps]
        prev[:self.num_steps] = prev_full[:self.num_steps]
        return ts, prev


@dataclasses.dataclass(eq=False)
class DiffusionRequest:
    """One image-generation request.  ``seed`` determines the initial
    noise; ``num_steps``/``guidance_scale`` of ``None`` mean the engine's
    defaults, resolved and written back at admission."""
    rid: int
    label: int
    seed: int = 0
    arrival_step: int = 0
    num_steps: Optional[int] = None
    guidance_scale: Optional[float] = None
    # filled by the engine
    latents: Optional[np.ndarray] = None
    cache: Optional[Dict] = None      # request-scoped cache counters
    admit_step: int = -1
    finish_step: int = -1
    done: bool = False

    @property
    def latency_steps(self) -> int:
        """Queueing + service latency on the engine-step clock."""
        return (self.finish_step - self.arrival_step
                if self.finish_step >= 0 else -1)


class RequestQueue:
    """Arrival-gated admission queue: requests become eligible once their
    ``arrival_step`` has passed; among them ``"fifo"`` serves the oldest
    ``(arrival_step, rid)`` first and ``"sjf"`` the smallest ``num_steps``
    (requests without a plan sort as longest), ties by ``(arrival, rid)``."""

    def __init__(self, requests: Optional[List[DiffusionRequest]] = None,
                 *, policy: str = "fifo"):
        if policy not in SCHED_POLICIES:
            raise ValueError(f"unknown scheduling policy {policy!r}; "
                             f"expected one of {SCHED_POLICIES}")
        self.policy = policy
        self._pending: List[DiffusionRequest] = sorted(
            requests or [], key=lambda r: (r.arrival_step, r.rid),
            reverse=True)
        self._ready: List[Tuple] = []
        self._seq = 0

    def _ready_key(self, req: DiffusionRequest) -> Tuple:
        if self.policy == "sjf":
            steps = (req.num_steps if req.num_steps is not None
                     else float("inf"))
            return (steps, req.arrival_step, req.rid)
        return (req.arrival_step, req.rid)

    def _drain(self, now: int) -> None:
        while self._pending and self._pending[-1].arrival_step <= now:
            req = self._pending.pop()
            heapq.heappush(self._ready,
                           self._ready_key(req) + (self._seq, req))
            self._seq += 1

    def peek_arrived(self, now: int) -> Optional[DiffusionRequest]:
        self._drain(now)
        return self._ready[0][-1] if self._ready else None

    def pop_arrived(self, now: int) -> Optional[DiffusionRequest]:
        self._drain(now)
        return heapq.heappop(self._ready)[-1] if self._ready else None

    def __bool__(self) -> bool:
        return bool(self._pending) or bool(self._ready)


def poisson_trace(num_requests: int, rate: float, *, seed: int,
                  num_classes: int,
                  steps_mix: Optional[Sequence[int]] = None,
                  guidance_mix: Optional[Sequence[float]] = None
                  ) -> List[DiffusionRequest]:
    """Poisson arrivals: exponential gaps with mean ``1 / rate`` (requests
    per engine step), floored onto the step clock.  Labels are drawn from
    ``num_classes``; ``steps_mix``/``guidance_mix`` draw each request's
    plan uniformly from the mix.  Request ``i`` gets noise seed 1000 + i."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(scale=1.0 / max(rate, 1e-9), size=num_requests)
    arrivals = np.floor(np.cumsum(gaps)).astype(np.int64)
    out = []
    for i in range(num_requests):
        label = int(rng.integers(0, num_classes))
        num_steps = (int(rng.choice(np.asarray(steps_mix)))
                     if steps_mix else None)
        guidance = (float(rng.choice(np.asarray(guidance_mix)))
                    if guidance_mix else None)
        out.append(DiffusionRequest(
            rid=i, label=label, seed=int(1000 + i),
            arrival_step=int(arrivals[i]), num_steps=num_steps,
            guidance_scale=guidance))
    return out


def percentile(values: Sequence[float], q: float) -> float:
    """``np.percentile`` that reports -1.0 for an empty sequence."""
    arr = np.asarray(values, np.float64)
    return float(np.percentile(arr, q)) if arr.size else -1.0
