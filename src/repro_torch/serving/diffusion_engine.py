"""Continuous-batching serving engine for DiT sampling with per-slot
FastCache state.

The engine owns ``max_slots`` generation slots.  Each slot holds one
request: its label, its own sampling plan (DDIM step budget + guidance
scale), its own step index, its CFG pair (cond row ``s`` and uncond row
``S + s`` of the doubled model batch) and its rows of the shared
``CachedDiT`` state.  ``step`` advances every active slot one denoising
step; finished slots emit latents and free at once; queued requests are
admitted into free slots mid-flight.

The plan is per-slot device state: ``(S, max_steps)`` ``ts``/``ts_prev``
tables plus an ``(S,)`` guidance vector, written at admission together
with the slot's reset, its initial latents and its request-scoped counters.
Admission and free reset the slot's rows, so a request admitted at engine
step k reproduces its solo ``sample()`` run, and residents are untouched.

**Static no-CFG fast path.**  ``cfg_rows=False`` opts a guidance==1.0-only
deployment out of the uncond half: slots are single state rows, the model
batch is S instead of 2S, and a request asking for any other guidance is
rejected at admission.  Its latents equal the default engine's at
guidance 1.0 (the scalar 1.0 skips CFG in ``denoise_step``, and a
per-sample 1.0 row selects the conditional eps outright), bitwise wherever
the model's GEMMs give a row the same bits at batch S and 2S.

**Preemption** (``serving/slo/``).  ``preempt(s)`` checkpoints slot ``s``'s
request out of the engine: a device-side copy of its policy-state rows
(``tokred`` included), its latents, its plan rows and its whole column of
request-scoped counters lands on ``req.snapshot`` and the slot frees.
``add_request`` of a request carrying a snapshot resumes it into any free
slot, bitwise, with its step index at ``steps_done``.  Neither reads the
device: the row index tensors are made once per slot at construction.

Headline counters (``acc``) accumulate only active slots' decisions; the
request-scoped ``slot_acc`` is zeroed at admission and harvested into
``req.cache`` at completion.  Both stay on the device as one (K,) vector
and one (K, S) matrix (the dicts hold views of their rows), updated with a
few batched ops per step; the host reads them at completion and in
``cache_stats``.

**Slot window.**  The host bookkeeping (slots, step counters, plans,
queue) always covers all ``max_slots`` slots; the device tensors cover the
window ``_slot_window()`` names, laid out as an engine of that many slots
would lay them out.  This engine's window is every slot; the sharded
engine (``serving/sharded_engine.py``) gives each data rank its own share
and leaves the rest of this class as it is.

**Step graphs.**  On the card the runner replays every warm step (no
slot just admitted) as one CUDA graph whose skipped blocks are IF nodes
(``core/step_graph.py``), so a warm step launches one graph and reads
nothing on the host, like the reference's jitted step.  ``step_graph=
False`` keeps the eager step (the card's eager path, for comparison); the
CPU has no graphs.

**Observability** (``obs/``).  With ``enable_metrics`` (the default) the
device metrics (``obs.metrics.init_device_metrics``) take one batched
update per step (``DeviceUpdate``: one copy of the host-known increments,
one ``index_add_`` of the device ones) and cross to the host only in
``harvest_metrics``, at run end and at the close of a collector's window.
``audit_fraction > 0`` turns on the shadow-compute audit plane
(``obs/audit.py``): on the steps its seeded schedule picks, the uncached
forward runs beside the cached one and the error lands in the metrics and
in each slot's ``slot_acc`` (``audit_err_sum`` ...); it needs the metrics
plane.  A ``tracer`` (``obs.tracing.TraceRecorder``) records per-request
spans and per-step slot snapshots, and opens ``torch.profiler`` ranges
around each step and the sampler's phases.  None of the three reads a
device value on the host during a step.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.policies.base import RowSet
from repro_torch.core.runner import CachedDiT
from repro_torch.device import to_device
from repro_torch.diffusion import sampler
from repro_torch.diffusion import schedule as sch
from repro_torch.obs import audit as obs_audit
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.metrics import MetricsCollector
from repro_torch.obs.tracing import TraceRecorder
from repro_torch.serving.scheduler import (DiffusionRequest, RequestQueue,
                                           SamplingPlan)

F32 = torch.float32

NoiseFn = Callable[[DiffusionRequest], torch.Tensor]

# the stat keys the device metrics count, by metric
_COUNTED = ((obs_metrics.BLOCKS_COMPUTED, "blocks_computed"),
            (obs_metrics.BLOCKS_SKIPPED, "blocks_skipped"),
            (obs_metrics.STEP_REUSES, "steps_reused"))


class DiffusionServingEngine:
    def __init__(self, runner: CachedDiT, *, max_slots: int,
                 num_steps: int = 50, guidance_scale: float = 4.0,
                 num_train_steps: int = 1000,
                 max_steps: Optional[int] = None,
                 noise_fn: Optional[NoiseFn] = None,
                 cfg_rows: bool = True,
                 collector: Optional[MetricsCollector] = None,
                 tracer: Optional[TraceRecorder] = None,
                 enable_metrics: bool = True,
                 audit_fraction: float = 0.0,
                 audit_seed: int = 0,
                 step_graph: Optional[bool] = None):
        # admission invariance needs per-sample gates: a global decision
        # would let an admission move the residents' gates
        if runner.gate_mode != "per_sample":
            raise ValueError(
                "DiffusionServingEngine requires FastCacheConfig("
                f"gate_mode='per_sample'); got {runner.gate_mode!r}")
        if not cfg_rows and guidance_scale != 1.0:
            raise ValueError(
                "cfg_rows=False is the guidance==1.0-only fast path; got "
                f"default guidance_scale={guidance_scale}")
        if not 0.0 <= audit_fraction <= 1.0:
            raise ValueError(f"audit_fraction must be in [0, 1], got "
                             f"{audit_fraction}")
        if audit_fraction > 0.0 and not enable_metrics:
            raise ValueError("audit_fraction > 0 needs the metrics plane; "
                             "enable_metrics=False has nowhere to "
                             "accumulate audit error")
        self.runner = runner
        self.device = runner.device
        # warm steps as CUDA graphs: the card's default, never on the CPU
        runner.step_graph = (self.device.type == "cuda" if step_graph is None
                             else step_graph)
        self.S = max_slots
        # the device slots: global slots [_lo, _lo + S_dev)
        self._lo, self.S_dev = self._slot_window()
        self.cfg_rows = cfg_rows
        self.rows_per_slot = 2 if cfg_rows else 1
        self.num_steps = num_steps
        self.guidance_scale = guidance_scale
        self.default_plan = SamplingPlan(num_steps, guidance_scale)
        self.max_steps = max_steps if max_steps is not None else num_steps
        if self.max_steps < num_steps:
            raise ValueError(f"max_steps={self.max_steps} < default "
                             f"num_steps={num_steps}")
        self.num_train_steps = num_train_steps
        # the request's initial latents; tests inject the reference's noise
        self.noise_fn = noise_fn or self.request_noise
        cfg = runner.model.cfg
        self.img = cfg.dit.image_size
        self.ch = cfg.dit.in_channels
        dev = self.device

        self.sched = sch.linear_schedule(num_train_steps, device=dev)
        ts_row, prev_row = self.default_plan.rows(self.max_steps,
                                                  num_train_steps)
        n_dev = self.S_dev
        self.plan = {
            "ts": to_device(np.tile(ts_row[None], (n_dev, 1)), dev),
            "ts_prev": to_device(np.tile(prev_row[None], (n_dev, 1)), dev),
            "guidance": torch.full((n_dev,), guidance_scale, dtype=F32,
                                   device=dev),
        }
        self.state = runner.init_state(self.rows_per_slot * n_dev)
        self._acc_keys = tuple(k for k, v in self.state["stats"].items()
                               if v.dim() == 1)
        self.audit_fraction = float(audit_fraction)
        self.audit_seed = int(audit_seed)
        self._audit_on = audit_fraction > 0.0
        self._audit_bound = runner.audit_bound() if self._audit_on else None
        self.x = torch.zeros((n_dev, self.img, self.img, self.ch),
                             dtype=F32, device=dev)
        self.slots: List[Optional[DiffusionRequest]] = [None] * max_slots
        self.slot_step = np.full((max_slots,), -1, np.int32)
        self.slot_budget = np.full((max_slots,), num_steps, np.int32)
        self.slot_label = np.zeros((max_slots,), np.int64)
        self.clock = 0                      # engine steps taken
        self.model_steps = 0                # steps that actually ran the DiT
        self.audited_steps = 0              # of them, shadow-audited
        self.host_syncs = 0                 # completion reads (policy's apart)
        # the active-slot counters (K,) and the request-scoped (K', S) ones,
        # the audit plane's error budget riding the latter; the dicts hold
        # views of their rows
        k = len(self._acc_keys)
        slot_keys = self._acc_keys + (obs_audit.AUDIT_ACC_KEYS
                                      if self._audit_on else ())
        self._acc_vec = torch.zeros((k,), dtype=F32, device=dev)
        self.acc = {key: self._acc_vec[i]
                    for i, key in enumerate(self._acc_keys)}
        self._slot_mat = torch.zeros((len(slot_keys), n_dev), dtype=F32,
                                     device=dev)
        self.slot_acc = {key: self._slot_mat[i]
                         for i, key in enumerate(slot_keys)}
        self.collector = collector
        self.tracer = tracer
        self._metrics_on = enable_metrics
        self.metrics = (obs_metrics.init_device_metrics(
            max_slots,
            audit_layers=(runner.L + 1) if self._audit_on else None,
            token_metrics=runner.reducer is not None, device=dev)
            if enable_metrics else {})
        if collector is not None and self._audit_on:
            collector.set_audit_context(bound=self._audit_bound,
                                        fraction=self.audit_fraction)
        # each device slot's state rows as an index tensor (with its host
        # rows), made once: the preemption pair's copies then need no
        # host-to-device copy
        self._rows_idx = [RowSet(to_device(np.asarray(self._slot_rows(s),
                                                      np.int64), dev),
                                 tuple(self._slot_rows(s)))
                          for s in range(self._lo, self._lo + n_dev)]

    def _slot_window(self) -> Tuple[int, int]:
        """(first global slot, count) of the slots whose rows live on this
        engine's device: all of them."""
        return 0, self.S

    def _owns(self, s: int) -> bool:
        return self._lo <= s < self._lo + self.S_dev

    def _slot_rows(self, s: int) -> List[int]:
        """State rows of (global) slot s on the device: its CFG
        cond/uncond pair, or its one row on the cfg_rows=False fast path."""
        ls = s - self._lo
        return [ls, self.S_dev + ls] if self.cfg_rows else [ls]

    def _fold(self, rows: torch.Tensor) -> torch.Tensor:
        """(..., rows) per-row values summed into (..., S_dev) per slot."""
        n = self.S_dev
        return rows[..., :n] + rows[..., n:] if self.cfg_rows else rows

    # -- device step ----------------------------------------------------

    @torch.no_grad()
    def _serve_step(self, step_idx: torch.Tensor, labels: torch.Tensor,
                    active: torch.Tensor, active_host: np.ndarray,
                    audit_now: bool) -> None:
        """Advance the device slots one denoising step.  ``step_idx``
        (S_dev,) is each slot's position in its own plan row; idle slots
        run through the model as padding but their latents are frozen and
        their cache decisions are left out of the counters.
        ``active_host`` is every slot's activity as the host holds it,
        ``audit_now`` the host's audit schedule bit for this step."""
        idx = step_idx.clamp(0, self.max_steps - 1)[:, None]
        t = torch.gather(self.plan["ts"], 1, idx)[:, 0]
        t_prev = torch.gather(self.plan["ts_prev"], 1, idx)[:, 0]
        keys = self._acc_keys
        # the step writes the counters in place: stack a copy first
        stats = self.state["stats"]
        before = torch.stack([stats[k] for k in keys])
        guidance = self.plan["guidance"] if self.cfg_rows else 1.0
        ranges = self.tracer is not None
        out = sampler.denoise_step(
            self.runner, self.sched, self.state, self.x, t, t_prev, labels,
            guidance_scale=guidance, return_eps=self._audit_on,
            ranges=ranges)
        x_pre = self.x
        x_new, self.state = out[0], out[1]
        self.x = torch.where(active[:, None, None, None], x_new, self.x)
        act_rows = (torch.cat([active, active]) if self.cfg_rows
                    else active).to(F32)
        after = self.state["stats"]
        delta = (torch.stack([after[k] for k in keys]) - before) * act_rows
        dsum = delta.sum(dim=1)                     # (K,) active rows
        dfold = self._fold(delta)                   # (K, S)
        self._acc_vec.add_(dsum)
        self._slot_mat[:len(keys)].add_(dfold)
        if self._metrics_on:
            self._update_metrics(active_host, dsum, dfold)
        if self._audit_on:
            obs_audit.apply_audit(
                self.runner, self.sched, self.state, x_pre, t, t_prev,
                labels, guidance, active, out[2], self.cfg_rows,
                self._audit_bound, self.metrics, self.slot_acc, audit_now,
                ranges=ranges)

    def _batch_sum(self, v: torch.Tensor) -> torch.Tensor:
        """A per-device partial of a whole-batch quantity, summed over
        every slot: the partial itself on one device."""
        return v

    def _update_metrics(self, active: np.ndarray, dsum: torch.Tensor,
                        dfold: torch.Tensor) -> None:
        """The step's device-metrics update, batched (``DeviceUpdate``):
        the host's increments (steps, active slots) in one copy, the stat
        deltas' in one ``index_add_``.  Keys the policy's stats do not carry
        are not counted.  ``active`` covers every slot, ``dsum`` and
        ``dfold`` the device slots."""
        pos = {k: i for i, k in enumerate(self._acc_keys)}
        n_act = float(active.sum())
        up = obs_metrics.DeviceUpdate(self.metrics)
        up.inc(obs_metrics.SERVE_STEPS, 1.0)
        up.inc(obs_metrics.ACTIVE_SLOT_STEPS, n_act)
        for name, key in _COUNTED:
            if key in pos:
                up.inc(name, dsum[pos[key]])
        up.observe(obs_metrics.ACTIVE_SLOTS, n_act)
        if "steps_reused" in pos:
            up.observe(obs_metrics.SKIP_FRACTION,
                       self._batch_sum(dsum[pos["steps_reused"]])
                       / max(n_act * self.rows_per_slot, 1.0))
        if "tokens_merged" in pos:
            # token compression on: per slot, the realized kept/(kept +
            # merged) ratio (idle slots add 0)
            kept = dfold[pos["tokens_kept"]]
            merged = dfold[pos["tokens_merged"]]
            up.inc(obs_metrics.TOKENS_KEPT, dsum[pos["tokens_kept"]])
            up.inc(obs_metrics.TOKENS_MERGED, dsum[pos["tokens_merged"]])
            up.slot_add(obs_metrics.SLOT_MERGE_RATIO,
                        kept / (kept + merged).clamp(min=1.0))
        lo = self._lo
        up.slot_add(obs_metrics.SLOT_ACTIVE_STEPS,
                    active[lo:lo + self.S_dev].astype(np.float32))
        up.apply()

    # -- host orchestration ---------------------------------------------

    def request_noise(self, req: DiffusionRequest) -> torch.Tensor:
        """The request's initial latents, (img, img, ch), from
        ``torch.Generator(device).manual_seed(req.seed)``."""
        gen = torch.Generator(self.device).manual_seed(req.seed)
        return torch.randn((self.img, self.img, self.ch), generator=gen,
                           dtype=F32, device=self.device)

    def free_slots(self) -> List[int]:
        return [s for s in range(self.S) if self.slots[s] is None]

    def reset_clock(self) -> None:
        """Rewind the step clock and the headline counters (e.g. after a
        warm-up trace, so a timed trace's arrival steps line up).  Needs an
        idle engine; the per-row raw counters keep their history."""
        if any(r is not None for r in self.slots):
            raise ValueError("reset_clock requires an idle engine; slots "
                             f"{[s for s, r in enumerate(self.slots) if r is not None]} "
                             "still hold requests")
        self.clock = 0
        self.model_steps = 0
        self.audited_steps = 0
        self._acc_vec.zero_()

    def resolve_plan(self, req: DiffusionRequest) -> SamplingPlan:
        """The request's own plan where set, the engine defaults otherwise;
        the resolved values are written back onto the request.  The
        cfg_rows=False engine rejects any guidance but 1.0."""
        n = req.num_steps if req.num_steps is not None else self.num_steps
        g = (req.guidance_scale if req.guidance_scale is not None
             else self.guidance_scale)
        if n > self.max_steps:
            raise ValueError(
                f"request rid={req.rid} wants num_steps={n} but this "
                f"engine's plan tables are max_steps={self.max_steps} "
                f"wide; construct the engine with max_steps>={n}")
        if not self.cfg_rows and g != 1.0:
            raise ValueError(
                f"request rid={req.rid} wants guidance_scale={g} but this "
                f"engine runs the cfg_rows=False no-CFG fast path "
                f"(guidance==1.0 only; no uncond rows are materialized)")
        req.num_steps, req.guidance_scale = n, float(g)
        return SamplingPlan(n, float(g))

    @torch.no_grad()
    def add_request(self, req: DiffusionRequest) -> bool:
        """Admit one request into a free slot (mid-flight is fine): reset
        the slot's cache rows, seed its latents, land its plan rows and zero
        its request-scoped counters.  A request carrying a preemption
        snapshot resumes from it instead (``_resume_request``).  No host
        sync."""
        free = self.free_slots()
        if not free:
            return False
        s = free[0]
        if req.snapshot is not None:
            return self._resume_request(req, s)
        plan = self.resolve_plan(req)
        if self._owns(s):
            self._admit(req, s, plan)
        self.slots[s] = req
        self.slot_step[s] = 0
        self.slot_budget[s] = plan.num_steps
        self.slot_label[s] = req.label
        req.admit_step = self.clock
        req.queue_wait_steps = max(self.clock - req.arrival_step, 0)
        if self.collector is not None:
            self.collector.inc(obs_metrics.ADMISSIONS)
            self.collector.observe(obs_metrics.QUEUE_WAIT,
                                   req.queue_wait_steps)
        if self.tracer is not None:
            self.tracer.admit(req.rid, s, label=req.label,
                              num_steps=plan.num_steps,
                              engine_step=self.clock)
        return True

    def _admit(self, req: DiffusionRequest, s: int,
               plan: SamplingPlan) -> None:
        """The device half of admission into device slot ``s``: reset its
        rows, seed its latents, land its plan rows, zero its counters."""
        ls = s - self._lo
        ts_row, prev_row = plan.rows(self.max_steps, self.num_train_steps)
        self.state = self.runner.reset_slot(self.state, self._slot_rows(s))
        self.x[ls] = self.noise_fn(req).to(device=self.device, dtype=F32)
        # through pinned buffers: a pageable host-to-device copy synchronizes
        self.plan["ts"][ls].copy_(to_device(ts_row, self.device))
        self.plan["ts_prev"][ls].copy_(to_device(prev_row, self.device))
        # fill_, not item assignment: a Python scalar assigned to a 0-dim
        # CUDA view goes through a synchronizing host copy
        self.plan["guidance"][ls].fill_(plan.guidance_scale)
        self._slot_mat[:, ls].fill_(0.0)

    # -- preemption (serving/slo/) ---------------------------------------

    def _snapshot(self, s: int) -> Dict:
        """Copy slot ``s`` out: its policy-state rows (``tokred`` too), its
        latents, its plan rows and its whole column of request-scoped
        counters (the audit plane's rows included).  Every tensor is a
        fresh device copy, so later writes into the slot never reach it."""
        ls = s - self._lo
        return {
            "state": self.runner.snapshot_slot(self.state,
                                               self._rows_idx[ls]),
            "x": self.x[ls].clone(),
            "ts": self.plan["ts"][ls].clone(),
            "ts_prev": self.plan["ts_prev"][ls].clone(),
            "guidance": self.plan["guidance"][ls].clone(),
            "slot_acc": self._slot_mat[:, ls].clone(),
        }

    def _restore(self, snap: Dict, s: int) -> None:
        """Write a ``_snapshot`` into slot ``s``, in place and bitwise; the
        other slots are untouched."""
        ls = s - self._lo
        self.state = self.runner.restore_slot(self.state, snap["state"],
                                              self._rows_idx[ls])
        self.x[ls].copy_(snap["x"])
        self.plan["ts"][ls].copy_(snap["ts"])
        self.plan["ts_prev"][ls].copy_(snap["ts_prev"])
        self.plan["guidance"][ls].copy_(snap["guidance"])
        self._slot_mat[:, ls].copy_(snap["slot_acc"])

    def _resume_request(self, req: DiffusionRequest, s: int) -> bool:
        """Re-admit a preempted request from its snapshot into free slot
        ``s``; the snapshot is consumed.  Its plan was resolved at first
        admission and is not resolved (or shed) again."""
        snap, req.snapshot = req.snapshot, None
        self._restore(snap, s)
        self.slots[s] = req
        self.slot_step[s] = req.steps_done
        self.slot_budget[s] = req.num_steps
        self.slot_label[s] = req.label
        if self.collector is not None:
            self.collector.inc(obs_metrics.RESUMES)
        if self.tracer is not None:
            self.tracer.admit(req.rid, s, label=req.label,
                              num_steps=req.num_steps,
                              engine_step=self.clock)
        return True

    @torch.no_grad()
    def preempt(self, s: int) -> DiffusionRequest:
        """Checkpoint slot ``s``'s request out of the engine: its snapshot
        lands on ``req.snapshot`` (on the device), ``steps_done`` is the
        host's step count, the slot frees and is reset as on completion.
        The caller requeues the request; ``add_request`` resumes it."""
        req = self.slots[s]
        if req is None:
            raise ValueError(f"preempt: slot {s} holds no request")
        req.snapshot = self._snapshot(s)
        req.steps_done = int(self.slot_step[s])
        req.preemptions += 1
        self.slots[s] = None
        self.slot_step[s] = -1
        if self._owns(s):
            self.state = self.runner.reset_slot(self.state,
                                                self._slot_rows(s))
        if self.collector is not None:
            self.collector.inc(obs_metrics.PREEMPTIONS)
        if self.tracer is not None:
            self.tracer.finish(req.rid, engine_step=self.clock)
        return req

    def step(self) -> List[DiffusionRequest]:
        """One engine step: advance all active slots one denoising step.
        Returns the requests that finished on this step (slots freed)."""
        active = np.array([r is not None for r in self.slots])
        self.clock += 1
        if not active.any():            # idle tick: time passes, no compute
            return []
        dev = self.device
        # the audit schedule: a host-side hash of the model-step counter
        audit_now = self._audit_on and obs_audit.audit_mask(
            self.model_steps, self.audit_fraction, self.audit_seed)
        self.audited_steps += int(audit_now)
        win = slice(self._lo, self._lo + self.S_dev)
        args = (to_device(np.where(active, self.slot_step, 0)[win]
                          .astype(np.int64), dev),
                to_device(self.slot_label[win], dev),
                to_device(active[win], dev), active, audit_now)
        if self.tracer is not None:
            with self.tracer.step_begin(self.clock,
                                        active=int(active.sum())):
                self._serve_step(*args)
            self.tracer.snapshot_slots(self.clock, active[win],
                                       self.slot_acc)
        else:
            self._serve_step(*args)
        self.model_steps += 1

        done_slots = []
        for s in np.flatnonzero(active):
            self.slot_step[s] += 1
            if self.slot_step[s] >= self.slot_budget[s]:
                done_slots.append(int(s))
        finished: List[DiffusionRequest] = []
        if done_slots:
            self._harvest(done_slots)
            for s in done_slots:
                req = self.slots[s]
                req.finish_step = self.clock
                req.done = True
                # control-plane accounting rides the harvested counters
                req.cache["queue_wait_steps"] = float(
                    max(req.queue_wait_steps, 0))
                req.cache["preemptions"] = float(req.preemptions)
                if self.collector is not None:
                    self.collector.inc(obs_metrics.REQUESTS_FINISHED)
                    self.collector.observe(obs_metrics.REQUEST_LATENCY,
                                           req.finish_step - req.arrival_step)
                    if (req.deadline_step is not None
                            and req.finish_step > req.deadline_step):
                        self.collector.inc(obs_metrics.DEADLINE_MISSES)
                if self.tracer is not None:
                    self.tracer.finish(req.rid, engine_step=self.clock)
                finished.append(req)
                # reset on free as well as on admission, so a freed slot
                # never carries stale gate/cache state
                self.slots[s] = None
                self.slot_step[s] = -1
                if self._owns(s):
                    self.state = self.runner.reset_slot(self.state,
                                                        self._slot_rows(s))
        return finished

    def _harvest(self, done_slots: List[int]) -> None:
        """Fill ``req.latents`` and ``req.cache`` for finished slots: one
        device->host read per completion step."""
        self.host_syncs += 1
        keys = list(self.slot_acc)
        flat = torch.cat([self.x.reshape(-1),
                          self._slot_mat.reshape(-1)]).cpu().numpy()
        x_host = flat[:self.x.numel()].reshape(self.x.shape)
        acc_host = flat[self.x.numel():].reshape(len(keys), self.S_dev)
        for s in done_slots:
            req, ls = self.slots[s], s - self._lo
            req.latents = x_host[ls].copy()
            req.cache = {k: float(acc_host[i, ls])
                         for i, k in enumerate(keys)}

    def run(self, requests: Union[List[DiffusionRequest], RequestQueue],
            *, lockstep: bool = False, sched_policy: str = "fifo",
            max_engine_steps: int = 100_000) -> List[DiffusionRequest]:
        """Drive a whole trace.  ``lockstep=False`` (continuous batching)
        admits arrived requests into free slots every step;
        ``lockstep=True`` admits a new wave only once every slot is free.
        With a collector, its windows close every ``window_steps`` engine
        steps and at the end."""
        queue = (requests if isinstance(requests, RequestQueue)
                 else RequestQueue(list(requests), policy=sched_policy))
        finished: List[DiffusionRequest] = []
        window = (self.collector.window_steps
                  if self.collector is not None else None)
        while queue or any(r is not None for r in self.slots):
            if self.clock >= max_engine_steps:
                break
            if not lockstep or all(r is None for r in self.slots):
                while self.free_slots() and queue.peek_arrived(self.clock):
                    self.add_request(queue.pop_arrived(self.clock))
            finished.extend(self.step())
            if window and self.clock % window == 0:
                self.harvest_metrics()      # a window's close: one read
        if self.collector is not None:
            self.harvest_metrics()          # run end
        self.finalize_requests(finished)
        return finished

    def finalize_requests(self, finished: List[DiffusionRequest]) -> None:
        """End-of-drive hook for whoever owns the loop (``run``, or the SLO
        plane's ``SLOScheduler.run`` / ``ReplicaRouter.run``): nothing to
        do here, ``_harvest`` already filled every finished request."""

    def harvest_metrics(self) -> Optional[Dict]:
        """Fetch the device metrics into the collector: the metrics plane's
        one device->host read, at run end and at a window's close."""
        if self.collector is None:
            return None
        return self.collector.harvest(self.metrics or None,
                                      at_step=self.clock)

    def _stat_view(self, row_keys) -> Tuple[Dict[str, float],
                                            Dict[str, List[float]]]:
        """The headline counters by key, and the per-row counters of
        ``row_keys`` over every state row (the cond rows of all slots, then
        the uncond rows), as host values."""
        totals = {k: float(v) for k, v in self.acc.items()}
        rows = {k: [float(x) for x in self.state["stats"][k].cpu()]
                for k in row_keys}
        return totals, rows

    def cache_stats(self) -> Dict:
        """Engine-lifetime cache counters, active slots only; raw per-row
        counters (idle padding steps included) under per_slot_*; the token
        counters when token compression is on."""
        totals, rows = self._stat_view(("blocks_skipped", "blocks_computed"))

        def acc(k):
            return totals.get(k, 0.0)

        skipped, computed = acc("blocks_skipped"), acc("blocks_computed")
        tot = computed + skipped
        out = {
            "policy": self.runner.policy,
            "engine_steps": self.clock,
            "model_steps": self.model_steps,
            "blocks_skipped": skipped,
            "blocks_computed": computed,
            "block_cache_ratio": skipped / tot if tot else 0.0,
            "steps_reused": acc("steps_reused"),
            "per_slot_blocks_skipped": rows["blocks_skipped"],
            "per_slot_blocks_computed": rows["blocks_computed"],
        }
        # token compression on: kept / merged tokens of active slots' rows
        for k in ("tokens_kept", "tokens_merged"):
            if k in totals:
                out[k] = totals[k]
        return out
