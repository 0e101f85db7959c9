"""``SLOScheduler``: the per-engine control-plane tick loop.

One ``tick()`` is: observe queue pressure (degradation controller +
per-class depth gauges) -> preempt for priority (a waiting
higher-priority request evicts the lowest-priority resident with the
most remaining work, via the engine's device-side snapshot/requeue) ->
deadline-aware admission (``AdmissionController``) -> one engine step
(timed, feeding the predictor's ``model_step_ms`` EMA).

Everything above the engine call is host bookkeeping; with an empty queue
a tick is exactly ``engine.step()``.  The step timer never waits for the
card: on CUDA it records an event pair around the step and folds each
pair into the EMA once ``query()`` reports it done, possibly ticks later;
on the CPU it reads the host clock.
"""
from __future__ import annotations

import collections
import time
from typing import Deque, List, Optional, Tuple, Union

import torch

from repro_torch.serving.scheduler import DiffusionRequest, RequestQueue
from repro_torch.serving.slo.admission import AdmissionController
from repro_torch.serving.slo.controller import DegradationController


class StepTimer:
    """Times engine steps without a host sync.  ``start()`` / ``stop()``
    bracket one step; ``poll()`` returns the milliseconds of every finished
    step not yet returned, oldest first.  On CUDA a step's time is the
    stream's span between two events (device idle gaps inside the step
    included), read once ``query()`` reports the second done; on the CPU,
    the host clock's."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._pending: Deque[Tuple[torch.cuda.Event, torch.cuda.Event]] = \
            collections.deque()
        self._ready: List[float] = []
        self._open = None
        self.total_ms = 0.0
        self.count = 0

    def start(self) -> None:
        if self.cuda:
            self._open = torch.cuda.Event(enable_timing=True)
            self._open.record()
        else:
            self._open = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._pending.append((self._open, end))
        else:
            self._ready.append((time.perf_counter() - self._open) * 1e3)

    def poll(self) -> List[float]:
        while self._pending and self._pending[0][1].query():
            start, end = self._pending.popleft()
            self._ready.append(start.elapsed_time(end))
        out, self._ready = self._ready, []
        self.total_ms += sum(out)
        self.count += len(out)
        return out


class SLOScheduler:
    """Drive one engine under the SLO control plane.  ``run()`` is the
    drop-in replacement for ``engine.run()``; ``tick()`` is the composable
    unit the ``ReplicaRouter`` drives."""

    def __init__(self, engine, *, sched_policy: str = "edf",
                 admission: Optional[AdmissionController] = None,
                 controller: Optional[DegradationController] = None,
                 preempt: bool = True, preempt_min_remaining: int = 2,
                 collector=None):
        self.engine = engine
        self.sched_policy = sched_policy
        self.collector = (collector if collector is not None
                          else engine.collector)
        self.admission = (admission if admission is not None
                          else AdmissionController(
                              engine, collector=self.collector))
        self.controller = controller
        self.preempt_enabled = preempt
        # never evict a resident about to finish: the snapshot/requeue
        # round trip would cost more slot-steps than it frees
        self.preempt_min_remaining = int(preempt_min_remaining)
        self.timer = StepTimer(engine.device)

    @property
    def rejected(self) -> List[DiffusionRequest]:
        return self.admission.rejected

    # -- preemption policy ----------------------------------------------

    def _maybe_preempt(self, queue: RequestQueue) -> None:
        """Evict a low-priority resident when a strictly-higher-priority
        request waits with no free slot.  Victim: the numerically largest
        priority among residents below the head's class, most remaining
        work as tie-break.  The victim requeues with its snapshot; resumed
        requests never trigger another preemption (no ping-pong)."""
        eng = self.engine
        if not self.preempt_enabled or eng.free_slots():
            return
        head = queue.peek_arrived(eng.clock)
        if head is None or head.snapshot is not None:
            return
        victims = []
        for s in range(eng.S):
            req = eng.slots[s]
            if req is None or req.priority <= head.priority:
                continue
            remaining = int(eng.slot_budget[s]) - int(eng.slot_step[s])
            if remaining < self.preempt_min_remaining:
                continue
            victims.append((req.priority, remaining, s))
        if not victims:
            return
        _, _, s = max(victims)
        queue.push(eng.preempt(s))

    # -- tick / run ------------------------------------------------------

    def tick(self, queue: RequestQueue) -> List[DiffusionRequest]:
        """One control-plane tick + one engine step.  Returns the
        requests that finished on this step."""
        eng = self.engine
        if self.controller is not None:
            self.controller.observe(queue.ready_depth(eng.clock))
        if self.collector is not None:
            for cls, depth in queue.depth_by_class(eng.clock).items():
                self.collector.set_gauge(f"queue_depth_class_{cls}",
                                         float(depth))
        self._maybe_preempt(queue)
        self.admission.admit_ready(queue, shed=self.controller)
        self.timer.start()
        finished = eng.step()
        self.timer.stop()
        for ms in self.timer.poll():
            self.admission.predictor.observe_step_ms(ms)
        return finished

    def run(self, requests: Union[List[DiffusionRequest], RequestQueue],
            *, max_engine_steps: int = 100_000
            ) -> List[DiffusionRequest]:
        """Drive a whole trace under the control plane.  Returns finished
        requests; admission-rejected ones accumulate on ``.rejected``
        (never admitted: ``reject_reason`` set, no latents)."""
        eng = self.engine
        queue = (requests if isinstance(requests, RequestQueue)
                 else RequestQueue(list(requests),
                                   policy=self.sched_policy))
        finished: List[DiffusionRequest] = []
        window = (self.collector.window_steps
                  if self.collector is not None else None)
        while (queue or self.admission.pending_deferred
               or any(r is not None for r in eng.slots)):
            if eng.clock >= max_engine_steps:
                break
            finished.extend(self.tick(queue))
            if window and eng.clock % window == 0:
                eng.harvest_metrics()
        if self.collector is not None:
            eng.harvest_metrics()
        eng.finalize_requests(finished)
        return finished
