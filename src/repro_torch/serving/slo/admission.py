"""Deadline-aware admission control.

``CompletionPredictor`` turns the engine's host bookkeeping (per-slot step
counters and budgets — the host shadow of the device plan tables) into a
finish-step prediction: a min-heap of per-slot completion horizons,
greedily assigning work the way the engine's free-slot admission loop
does.  Predictions live on the engine-step clock; a measured
``model_step_ms`` EMA (fed by ``SLOScheduler``'s step timer: CUDA events
on the card, the host clock on the CPU) converts them to milliseconds for
wall-clock SLO reporting.  No admission decision reads it.

``AdmissionController`` sits between the ``RequestQueue`` and
``add_request``: free slots are filled in queue order, and the waiting
line behind them is triaged — a request whose predicted completion
*behind the queued-ahead work* misses its ``deadline_step`` is refused
now (rejected, or deferred a few steps in the hope the queue drains)
instead of queueing fruitlessly.  A deadline that cannot be met even
starting NOW on an idle slot is rejected as ``"deadline_expired"``.
Best-effort requests (no deadline) are never refused.  Rejection is
recorded on the request (``reject_reason``) and in
``admission_rejections_total``, so a rejected request is a first-class
outcome the summaries account for, not a silently dropped one.
"""
from __future__ import annotations

import heapq
from typing import List, Optional, Sequence

from repro_torch.obs import metrics as obs_metrics
from repro_torch.serving.scheduler import DiffusionRequest, RequestQueue

REASON_UNATTAINABLE = "deadline_unattainable"
REASON_EXPIRED = "deadline_expired"


class CompletionPredictor:
    """Finish-step prediction from host slot bookkeeping.

    The prediction model matches the engine's actual scheduling: every
    busy slot frees after its remaining budget (``slot_budget -
    slot_step``), free slots are available now, and queued-ahead work is
    assigned greedily to the earliest-freeing slot — exactly what the
    admission loop will do.  Preempted requests predict with their
    *residual* steps (``num_steps - steps_done``), so a resumed request
    is cheaper to place than a fresh one of the same plan."""

    def __init__(self, engine, *, step_ms_alpha: float = 0.2):
        if not 0.0 < step_ms_alpha <= 1.0:
            raise ValueError(f"step_ms_alpha must be in (0, 1], got "
                             f"{step_ms_alpha}")
        self.engine = engine
        self.model_step_ms: Optional[float] = None
        self._alpha = step_ms_alpha

    def observe_step_ms(self, ms: float) -> None:
        """Fold one measured engine-step time into the EMA."""
        if self.model_step_ms is None:
            self.model_step_ms = float(ms)
        else:
            self.model_step_ms += self._alpha * (float(ms)
                                                 - self.model_step_ms)

    def remaining_steps(self, req: DiffusionRequest) -> int:
        """Denoising steps the request still needs (plan resolved against
        the engine default; residual for preempted requests)."""
        n = (req.num_steps if req.num_steps is not None
             else self.engine.num_steps)
        return max(int(n) - int(req.steps_done), 0)

    def slot_horizons(self) -> List[int]:
        """Steps until each slot frees (0 for free slots)."""
        eng = self.engine
        return [0 if eng.slots[s] is None
                else max(int(eng.slot_budget[s]) - int(eng.slot_step[s]), 0)
                for s in range(eng.S)]

    def predict_finish_step(self, steps_needed: int,
                            queued_ahead: Sequence[int] = ()) -> int:
        """Absolute engine step at which a request needing
        ``steps_needed`` more steps would finish, admitted behind
        ``queued_ahead`` (step budgets that will grab slots first)."""
        horizons = self.slot_horizons()
        heapq.heapify(horizons)
        for ahead in queued_ahead:
            free_at = heapq.heappop(horizons)
            heapq.heappush(horizons, free_at + int(ahead))
        return self.engine.clock + horizons[0] + int(steps_needed)

    def predict_finish_ms(self, steps_needed: int,
                          queued_ahead: Sequence[int] = ()
                          ) -> Optional[float]:
        """Wall-clock view of ``predict_finish_step`` via the measured
        ``model_step_ms`` EMA (None until a step has been timed)."""
        if self.model_step_ms is None:
            return None
        steps = (self.predict_finish_step(steps_needed, queued_ahead)
                 - self.engine.clock)
        return steps * self.model_step_ms


class AdmissionController:
    """Deadline-aware admission: fill free slots in queue order, then
    triage the waiting line against the deadline predictor.

    ``on_miss="reject"`` refuses predicted misses immediately with
    ``reason="deadline_unattainable"``; ``on_miss="defer"`` parks the
    request for ``defer_steps`` engine steps (at most ``max_defers``
    times, in a controller-owned retry heap — the request's
    ``arrival_step``, and with it latency accounting, is never touched)
    before re-triaging.  Either way, a deadline unreachable even starting
    NOW on an idle slot is rejected as ``"deadline_expired"``.  Resumed
    (preempted) requests are re-admitted without a fresh deadline test:
    their slot investment is already sunk and their residual is by
    construction shorter than the original plan.

    ``lookahead`` bounds the triage scan per tick (default ``4 * slots``
    at construction): under a deep queue the head of the line is triaged
    every tick, the far tail only as it surfaces."""

    def __init__(self, engine, *, on_miss: str = "reject",
                 defer_steps: int = 4, max_defers: int = 8,
                 lookahead: Optional[int] = None, collector=None):
        if on_miss not in ("reject", "defer"):
            raise ValueError(f"on_miss must be 'reject' or 'defer', got "
                             f"{on_miss!r}")
        if defer_steps < 1:
            raise ValueError(f"defer_steps must be >= 1, got {defer_steps}")
        self.engine = engine
        self.on_miss = on_miss
        self.defer_steps = int(defer_steps)
        self.max_defers = int(max_defers)
        self.lookahead = (int(lookahead) if lookahead is not None
                          else 4 * engine.S)
        self.collector = collector
        self.predictor = CompletionPredictor(engine)
        self.rejected: List[DiffusionRequest] = []
        self._defers = {}
        self._deferred = []     # (retry_step, seq, req) heap
        self._defer_seq = 0

    @property
    def pending_deferred(self) -> int:
        """Requests parked in the defer heap (still owed a retry)."""
        return len(self._deferred)

    def _reject(self, req: DiffusionRequest, reason: str) -> None:
        req.reject_reason = reason
        self.rejected.append(req)
        if self.collector is not None:
            self.collector.inc(obs_metrics.REJECTIONS)

    def _defer(self, req: DiffusionRequest) -> None:
        self._defers[req.rid] = self._defers.get(req.rid, 0) + 1
        heapq.heappush(self._deferred,
                       (self.engine.clock + self.defer_steps,
                        self._defer_seq, req))
        self._defer_seq += 1

    def _requeue_deferred(self, queue: RequestQueue) -> None:
        while self._deferred and self._deferred[0][0] <= self.engine.clock:
            queue.push(heapq.heappop(self._deferred)[-1])

    def _miss(self, req: DiffusionRequest) -> None:
        """A predicted (not yet arithmetically certain) deadline miss:
        defer if the policy and budget allow, reject otherwise."""
        if (self.on_miss == "defer"
                and self._defers.get(req.rid, 0) < self.max_defers):
            self._defer(req)
        else:
            self._reject(req, REASON_UNATTAINABLE)

    def admit_ready(self, queue: RequestQueue, *, shed=None
                    ) -> List[DiffusionRequest]:
        """Fill free slots from the queue (priority classes first, then
        the queue's policy), then triage the waiting line.  ``shed`` is an
        optional ``DegradationController`` applied to fresh requests
        before their deadline test — a shrunk step budget can turn an
        unattainable deadline into an attainable one, which is the
        point."""
        eng = self.engine
        self._requeue_deferred(queue)
        admitted: List[DiffusionRequest] = []
        # phase 1: fill free slots
        while eng.free_slots():
            req = queue.peek_arrived(eng.clock)
            if req is None:
                break
            queue.pop_arrived(eng.clock)
            if req.snapshot is not None:
                eng.add_request(req)
                admitted.append(req)
                continue
            if shed is not None:
                shed.scale_request(req, default_steps=eng.num_steps)
            steps = self.predictor.remaining_steps(req)
            if (req.deadline_step is not None
                    and eng.clock + steps > req.deadline_step):
                self._reject(req, REASON_EXPIRED)
                continue
            eng.add_request(req)
            admitted.append(req)
        # phase 2: triage the line behind the (now full) slots — predict
        # each waiting request's completion behind the work queued ahead
        # of it and refuse the ones that already cannot make it
        kept: List[DiffusionRequest] = []
        ahead: List[int] = []
        scanned = 0
        while scanned < self.lookahead:
            req = queue.pop_arrived(eng.clock)
            if req is None:
                break
            scanned += 1
            steps = self.predictor.remaining_steps(req)
            if req.snapshot is not None or req.deadline_step is None:
                kept.append(req)
                ahead.append(steps)
                continue
            if shed is not None:
                shed.scale_request(req, default_steps=eng.num_steps)
                steps = self.predictor.remaining_steps(req)
            if eng.clock + steps > req.deadline_step:
                self._reject(req, REASON_EXPIRED)
                continue
            if self.predictor.predict_finish_step(steps,
                                                  ahead) > req.deadline_step:
                self._miss(req)
                continue
            kept.append(req)
            ahead.append(steps)
        for req in kept:
            queue.push(req)
        return admitted
