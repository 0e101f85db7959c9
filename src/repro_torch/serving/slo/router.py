"""``ReplicaRouter``: one host driving N engine replicas.

Dispatch is join-shortest-queue on *outstanding work* (remaining steps of
every resident plus an estimate for the queued line — a better load
signal than request counts when plans are heterogeneous), with optional
priority-class affinity: a class pinned to a replica goes there unless
that replica is loaded beyond ``affinity_slack`` times the best choice —
soft affinity, so a hot replica sheds its pinned class before its latency
collapses.

Each replica is a full ``SLOScheduler`` (own queue, admission controller,
optional degradation controller), and the router drives them in lockstep
ticks — every engine's step clock advances together, so latencies across
replicas stay on one comparable clock.  Preempted requests requeue on
their OWN replica's queue (inside that replica's ``tick``), never across
replicas: a preemption snapshot is a set of tensors on its engine's
device, and the router treats it as pinned there.  The replicas may share
one model on one card.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

from repro_torch.serving.scheduler import DiffusionRequest, RequestQueue
from repro_torch.serving.slo.plane import SLOScheduler


class ReplicaRouter:
    def __init__(self, schedulers: Sequence[SLOScheduler], *,
                 affinity: Optional[Dict[int, int]] = None,
                 affinity_slack: float = 2.0):
        if not schedulers:
            raise ValueError("ReplicaRouter needs >= 1 SLOScheduler")
        self.scheds = list(schedulers)
        for i, sched in enumerate(self.scheds):
            if not isinstance(sched, SLOScheduler):
                raise TypeError(f"replica {i}: expected an SLOScheduler, "
                                f"got {type(sched).__name__} — wrap the "
                                f"engine first")
        self.queues = [RequestQueue(policy=s.sched_policy)
                       for s in self.scheds]
        self.affinity = dict(affinity or {})
        for cls, idx in self.affinity.items():
            if not 0 <= idx < len(self.scheds):
                raise ValueError(f"affinity: class {cls} -> replica {idx} "
                                 f"out of range ({len(self.scheds)} "
                                 f"replicas)")
        if affinity_slack < 1.0:
            raise ValueError(f"affinity_slack must be >= 1.0, got "
                             f"{affinity_slack}")
        self.affinity_slack = float(affinity_slack)
        self.dispatched: Dict[int, int] = {}    # rid -> replica index

    # -- load signal + dispatch -----------------------------------------

    def load(self, i: int) -> int:
        """Outstanding work (engine steps) on replica ``i``: remaining
        steps of every resident plus the queued line estimated at each
        request's plan (engine default when unset)."""
        sched = self.scheds[i]
        eng = sched.engine
        inflight = sum(int(eng.slot_budget[s]) - int(eng.slot_step[s])
                       for s in range(eng.S) if eng.slots[s] is not None)
        queued = len(self.queues[i]) * eng.num_steps
        return inflight + queued

    def dispatch(self, req: DiffusionRequest) -> int:
        """Route one request: its class's affinity replica if that stays
        within ``affinity_slack`` of the least-loaded one, else
        join-shortest-queue (deterministic index tie-break)."""
        loads = [self.load(i) for i in range(len(self.scheds))]
        best = min(range(len(loads)), key=lambda i: (loads[i], i))
        pinned = self.affinity.get(req.priority)
        if pinned is not None:
            # +default_steps keeps the comparison meaningful at zero load
            budget = self.affinity_slack * (
                loads[best] + self.scheds[best].engine.num_steps)
            if loads[pinned] <= budget:
                best = pinned
        self.queues[best].push(req)
        self.dispatched[req.rid] = best
        return best

    # -- drive -----------------------------------------------------------

    @property
    def rejected(self) -> List[DiffusionRequest]:
        out: List[DiffusionRequest] = []
        for sched in self.scheds:
            out.extend(sched.rejected)
        return out

    def _busy(self) -> bool:
        if any(self.queues):
            return True
        for sched in self.scheds:
            if sched.admission.pending_deferred:
                return True
            if any(r is not None for r in sched.engine.slots):
                return True
        return False

    def run(self, requests: Union[List[DiffusionRequest], RequestQueue],
            *, max_engine_steps: int = 100_000
            ) -> List[DiffusionRequest]:
        """Drive a whole trace across the replica fleet.  Requests are
        dispatched when they arrive on the global clock (= every engine's
        step clock; the replicas tick in lockstep), then each replica runs
        its own control-plane tick.  Returns all finished requests,
        interleaved in completion order."""
        if isinstance(requests, RequestQueue):
            raise TypeError("ReplicaRouter.run takes the raw request list "
                            "— per-replica queues are router-owned (pass "
                            "the list; the router dispatches arrivals)")
        pending = sorted(requests,
                         key=lambda r: (r.arrival_step, r.rid),
                         reverse=True)
        finished: List[DiffusionRequest] = []
        clock = 0
        while pending or self._busy():
            if clock >= max_engine_steps:
                break
            while pending and pending[-1].arrival_step <= clock:
                self.dispatch(pending.pop())
            for sched, queue in zip(self.scheds, self.queues):
                finished.extend(sched.tick(queue))
            clock += 1
        for sched in self.scheds:
            if sched.collector is not None:
                sched.engine.harvest_metrics()
            sched.engine.finalize_requests(finished)
        return finished
