"""Request scheduling for the diffusion serving engine: per-request
``SamplingPlan``s (heterogeneous DDIM step counts + guidance scales), an
arrival-gated queue (FIFO, shortest-job-first, or earliest-deadline-first
under strict priority classes) and Poisson arrival traces, optionally
rate-modulated (bursty) with priority and deadline mixes, for the SLO
control plane (``serving/slo/``).  Pure numpy, as in the reference; traces
are seeded with ``seed=`` only and replay the reference's streams draw for
draw.

Time is measured in engine steps (one ``serve_step`` = one clock tick).
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

SCHED_POLICIES = ("fifo", "sjf", "edf")


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
    # SLO metadata: scheduling class (0 = highest; served strictly in
    # order) and an absolute deadline on the engine-step clock (None =
    # best-effort, never refused by the deadline test)
    priority: int = 0
    deadline_step: Optional[int] = None
    # filled by the engine
    latents: Optional[np.ndarray] = None
    cache: Optional[Dict] = None      # request-scoped cache counters
    admit_step: int = -1
    finish_step: int = -1
    done: bool = False
    # filled by the control plane: first-admission queue wait (engine
    # steps), why admission refused the request (None = admitted), how
    # often it was preempted, and across a preempt / requeue cycle its
    # progress and the device-side snapshot it resumes from
    queue_wait_steps: int = -1
    reject_reason: Optional[str] = None
    preemptions: int = 0
    steps_done: int = 0
    snapshot: Optional[Dict] = dataclasses.field(default=None, repr=False)

    @property
    def latency_steps(self) -> int:
        """Queueing + service latency on the engine-step clock."""
        return (self.finish_step - self.arrival_step
                if self.finish_step >= 0 else -1)


def _arrival_key(req: DiffusionRequest) -> Tuple[int, int]:
    return (req.arrival_step, req.rid)


class RequestQueue:
    """Arrival-gated admission queue: requests become eligible once their
    ``arrival_step`` has passed.  Eligible requests wait in one ready heap
    per ``priority`` class, and the lowest-numbered non-empty class is
    always served first; within a class ``"fifo"`` serves the oldest
    ``(arrival_step, rid)``, ``"sjf"`` the smallest ``num_steps``
    (requests without a plan sort as longest) and ``"edf"`` the earliest
    ``deadline_step`` (best-effort requests last), ties by ``(arrival,
    rid)``.  Not-yet-arrived requests are kept sorted descending by
    ``(arrival_step, rid)``, so ``push`` is one ``bisect.insort``."""

    def __init__(self, requests: Optional[List[DiffusionRequest]] = None,
                 *, policy: str = "fifo"):
        if policy not in SCHED_POLICIES:
            raise ValueError(f"unknown scheduling policy {policy!r}; "
                             f"expected one of {SCHED_POLICIES}")
        self.policy = policy
        self._pending: List[DiffusionRequest] = sorted(
            requests or [], key=_arrival_key, reverse=True)
        # entries (key..., seq, req): the monotonic seq breaks any tie
        # before a comparison reaches the request object
        self._ready: Dict[int, List[Tuple]] = {}
        self._seq = 0

    def _ready_key(self, req: DiffusionRequest) -> Tuple:
        if self.policy == "sjf":
            steps = (req.num_steps if req.num_steps is not None
                     else float("inf"))
            return (steps, req.arrival_step, req.rid)
        if self.policy == "edf":
            deadline = (req.deadline_step if req.deadline_step is not None
                        else float("inf"))
            return (deadline, req.arrival_step, req.rid)
        return (req.arrival_step, req.rid)

    def push(self, req: DiffusionRequest) -> None:
        bisect.insort(self._pending, req,
                      key=lambda r: (-r.arrival_step, -r.rid))

    def _drain(self, now: int) -> None:
        while self._pending and self._pending[-1].arrival_step <= now:
            req = self._pending.pop()
            heapq.heappush(self._ready.setdefault(req.priority, []),
                           self._ready_key(req) + (self._seq, req))
            self._seq += 1

    def _first_class(self) -> Optional[int]:
        ready = [c for c, heap in self._ready.items() if heap]
        return min(ready) if ready else None

    def peek_arrived(self, now: int) -> Optional[DiffusionRequest]:
        self._drain(now)
        cls = self._first_class()
        return self._ready[cls][0][-1] if cls is not None else None

    def pop_arrived(self, now: int) -> Optional[DiffusionRequest]:
        self._drain(now)
        cls = self._first_class()
        return (heapq.heappop(self._ready[cls])[-1]
                if cls is not None else None)

    def ready_depth(self, now: int) -> int:
        """Eligible requests waiting now: the queue pressure the
        degradation controller watches."""
        self._drain(now)
        return sum(len(heap) for heap in self._ready.values())

    def depth_by_class(self, now: int) -> Dict[int, int]:
        """Eligible requests per priority class (non-empty classes only)."""
        self._drain(now)
        return {cls: len(heap)
                for cls, heap in sorted(self._ready.items()) if heap}

    def __len__(self) -> int:
        return (len(self._pending)
                + sum(len(heap) for heap in self._ready.values()))

    def __bool__(self) -> bool:
        return bool(self._pending) or any(self._ready.values())


def summarize_by_steps(done: List[DiffusionRequest]) -> Dict[str, Dict]:
    """Finished requests grouped by their resolved step budget: count,
    p50/p95 latency and the cache ratio of the group's request-scoped
    counters.  Unfinished requests are left out of the percentiles;
    requests whose plan was never resolved (rejected before admission)
    form a ``"rejected"`` group, so the trace total is conserved."""
    out: Dict[str, Dict] = {}
    budgets = sorted({r.num_steps for r in done
                      if r.num_steps is not None})
    for n in budgets:
        out[str(n)] = _summarize_group([r for r in done if r.num_steps == n])
    unplanned = [r for r in done if r.num_steps is None]
    if unplanned:
        out["rejected"] = _summarize_group(unplanned)
    return out


def _summarize_group(grp: List[DiffusionRequest]) -> Dict:
    """Count / latency / cache row of one request group."""
    lats = [r.latency_steps for r in grp if r.latency_steps >= 0]
    row = {"requests": len(grp),
           "finished": len(lats),
           "latency_steps_p50": percentile(lats, 50),
           "latency_steps_p95": percentile(lats, 95)}
    rejected = sum(1 for r in grp if r.reject_reason is not None)
    if rejected:
        row["rejected"] = rejected
    cached = [r for r in grp if r.cache]
    if cached:
        skipped = sum(r.cache.get("blocks_skipped", 0.0) for r in cached)
        computed = sum(r.cache.get("blocks_computed", 0.0) for r in cached)
        tot = skipped + computed
        row["cache_ratio"] = skipped / tot if tot else 0.0
        row["steps_reused"] = sum(r.cache.get("steps_reused", 0.0)
                                  for r in cached)
    return row


def summarize_by_class(done: List[DiffusionRequest]) -> Dict[str, Dict]:
    """Requests grouped by priority class: the group row plus queue-wait
    percentiles, preemptions, deadline hits and misses (finished requests
    with a deadline) and the rejection reasons."""
    out: Dict[str, Dict] = {}
    for cls in sorted({r.priority for r in done}):
        grp = [r for r in done if r.priority == cls]
        row = _summarize_group(grp)
        waits = [r.queue_wait_steps for r in grp if r.queue_wait_steps >= 0]
        row["queue_wait_p50"] = percentile(waits, 50)
        row["queue_wait_p95"] = percentile(waits, 95)
        row["preemptions"] = int(sum(r.preemptions for r in grp))
        with_deadline = [r for r in grp if r.deadline_step is not None
                         and r.finish_step >= 0]
        if with_deadline:
            met = sum(1 for r in with_deadline
                      if r.finish_step <= r.deadline_step)
            row["deadline_met"] = met
            row["deadline_missed"] = len(with_deadline) - met
        reasons: Dict[str, int] = {}
        for r in grp:
            if r.reject_reason is not None:
                reasons[r.reject_reason] = reasons.get(r.reject_reason, 0) + 1
        if reasons:
            row["reject_reasons"] = reasons
        out[str(cls)] = row
    return out


def piecewise_rate(segments: Sequence[Tuple[float, float]]
                   ) -> Callable[[float], float]:
    """``[(until_step, rate), ...] -> rate_fn`` for ``poisson_trace``: the
    rate is that of the first segment with ``t < until_step``; past the
    last boundary the last segment's rate holds."""
    segs = sorted((float(until), float(r)) for until, r in segments)
    if not segs:
        raise ValueError("piecewise_rate: need at least one segment")

    def rate_fn(t: float) -> float:
        for until, r in segs:
            if t < until:
                return r
        return segs[-1][1]

    return rate_fn


def poisson_trace(num_requests: int, rate: float, *, seed: int,
                  num_classes: int,
                  steps_mix: Optional[Sequence[int]] = None,
                  guidance_mix: Optional[Sequence[float]] = None,
                  rate_fn: Optional[Callable[[float], float]] = None,
                  priority_mix: Optional[Sequence[int]] = None,
                  deadline_slack_mix: Optional[Sequence[int]] = None
                  ) -> List[DiffusionRequest]:
    """Poisson arrivals: exponential gaps with mean ``1 / rate`` (requests
    per engine step), floored onto the step clock.  Labels are drawn from
    ``num_classes``; ``steps_mix``/``guidance_mix`` draw each request's
    plan uniformly from the mix.  Request ``i`` gets noise seed 1000 + i.

    ``rate_fn`` makes the stream inhomogeneous: each gap is a unit
    exponential over ``rate_fn(t)`` at the running arrival time (the
    positional ``rate`` is then ignored).  ``priority_mix`` draws each
    request's class, ``deadline_slack_mix`` a slack whose sum with the
    arrival is ``deadline_step``.  A knob draws only when passed, so a call
    without them replays the plain stream."""
    rng = np.random.default_rng(seed)
    if rate_fn is None:
        gaps = rng.exponential(scale=1.0 / max(rate, 1e-9),
                               size=num_requests)
        arrivals = np.floor(np.cumsum(gaps)).astype(np.int64)
    else:
        t = 0.0
        arrivals = np.empty((num_requests,), np.int64)
        for i in range(num_requests):
            t += rng.exponential() / max(float(rate_fn(t)), 1e-9)
            arrivals[i] = int(np.floor(t))
    out = []
    for i in range(num_requests):
        label = int(rng.integers(0, num_classes))
        num_steps = (int(rng.choice(np.asarray(steps_mix)))
                     if steps_mix else None)
        guidance = (float(rng.choice(np.asarray(guidance_mix)))
                    if guidance_mix else None)
        priority = (int(rng.choice(np.asarray(priority_mix)))
                    if priority_mix is not None else 0)
        deadline = None
        if deadline_slack_mix is not None:
            deadline = int(arrivals[i]) + int(
                rng.choice(np.asarray(deadline_slack_mix)))
        out.append(DiffusionRequest(
            rid=i, label=label, seed=int(1000 + i),
            arrival_step=int(arrivals[i]), num_steps=num_steps,
            guidance_scale=guidance, priority=priority,
            deadline_step=deadline))
    return out


def percentile(values: Sequence[float], q: float) -> float:
    """``np.percentile`` that reports -1.0 for an empty sequence."""
    arr = np.asarray(values, np.float64)
    return float(np.percentile(arr, q)) if arr.size else -1.0
