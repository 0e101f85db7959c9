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

Headline counters (``acc``) accumulate only active slots' decisions; the
request-scoped ``slot_acc`` is zeroed at admission and harvested into
``req.cache`` at completion.  Both stay on the device: the host reads them
at completion and in ``cache_stats``.  The engine updates its state
tensors in place where that saves a copy (admission, reset), since it owns
them.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core.runner import CachedDiT
from repro_torch.device import to_device
from repro_torch.diffusion import sampler
from repro_torch.diffusion import schedule as sch
from repro_torch.serving.scheduler import (DiffusionRequest, RequestQueue,
                                           SamplingPlan)

F32 = torch.float32

NoiseFn = Callable[[DiffusionRequest], torch.Tensor]


class DiffusionServingEngine:
    def __init__(self, runner: CachedDiT, *, max_slots: int,
                 num_steps: int = 50, guidance_scale: float = 4.0,
                 num_train_steps: int = 1000,
                 max_steps: Optional[int] = None,
                 noise_fn: Optional[NoiseFn] = None):
        if runner.gate_mode != "per_sample":
            raise ValueError(
                "DiffusionServingEngine requires FastCacheConfig("
                f"gate_mode='per_sample'); got {runner.gate_mode!r}")
        self.runner = runner
        self.device = runner.device
        self.S = max_slots
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
        self.plan = {
            "ts": to_device(np.tile(ts_row[None], (max_slots, 1)), dev),
            "ts_prev": to_device(np.tile(prev_row[None], (max_slots, 1)), dev),
            "guidance": torch.full((max_slots,), guidance_scale, dtype=F32,
                                   device=dev),
        }
        # CFG rows are always materialized: the state batch is 2S
        self.state = runner.init_state(2 * max_slots)
        self._acc_keys = tuple(k for k, v in self.state["stats"].items()
                               if v.dim() == 1)
        self.x = torch.zeros((max_slots, self.img, self.img, self.ch),
                             dtype=F32, device=dev)
        self.slots: List[Optional[DiffusionRequest]] = [None] * max_slots
        self.slot_step = np.full((max_slots,), -1, np.int32)
        self.slot_budget = np.full((max_slots,), num_steps, np.int32)
        self.slot_label = np.zeros((max_slots,), np.int64)
        self.clock = 0                      # engine steps taken
        self.model_steps = 0                # steps that actually ran the DiT
        self.host_syncs = 0                 # completion reads (policy's apart)
        self.acc = self._zero_acc()
        self.slot_acc = {k: torch.zeros((max_slots,), dtype=F32, device=dev)
                         for k in self._acc_keys}

    def _zero_acc(self) -> Dict[str, torch.Tensor]:
        return {k: torch.zeros((), dtype=F32, device=self.device)
                for k in self._acc_keys}

    def _slot_rows(self, s: int) -> List[int]:
        """State rows owned by slot s: its CFG cond/uncond pair."""
        return [s, self.S + s]

    # -- device step ----------------------------------------------------

    @torch.no_grad()
    def _serve_step(self, step_idx: torch.Tensor, labels: torch.Tensor,
                    active: torch.Tensor) -> None:
        """Advance all slots one denoising step.  ``step_idx`` (S,) is each
        slot's position in its own plan row; idle slots run through the
        model as padding but their latents are frozen and their cache
        decisions are left out of the counters."""
        idx = step_idx.clamp(0, self.max_steps - 1)[:, None]
        t = torch.gather(self.plan["ts"], 1, idx)[:, 0]
        t_prev = torch.gather(self.plan["ts_prev"], 1, idx)[:, 0]
        before = self.state["stats"]
        x_new, self.state = sampler.denoise_step(
            self.runner, self.sched, self.state, self.x, t, t_prev, labels,
            guidance_scale=self.plan["guidance"])
        self.x = torch.where(active[:, None, None, None], x_new, self.x)
        act_rows = torch.cat([active, active]).to(F32)
        for k in self._acc_keys:
            delta = (self.state["stats"][k] - before[k]) * act_rows
            self.acc[k] = self.acc[k] + delta.sum()
            self.slot_acc[k] = self.slot_acc[k] + (delta[:self.S]
                                                   + delta[self.S:])

    # -- host orchestration ---------------------------------------------

    def request_noise(self, req: DiffusionRequest) -> torch.Tensor:
        """The request's initial latents, (img, img, ch), from
        ``torch.Generator(device).manual_seed(req.seed)``."""
        gen = torch.Generator(self.device).manual_seed(req.seed)
        return torch.randn((self.img, self.img, self.ch), generator=gen,
                           dtype=F32, device=self.device)

    def free_slots(self) -> List[int]:
        return [s for s in range(self.S) if self.slots[s] is None]

    def resolve_plan(self, req: DiffusionRequest) -> SamplingPlan:
        """The request's own plan where set, the engine defaults otherwise;
        the resolved values are written back onto the request."""
        n = req.num_steps if req.num_steps is not None else self.num_steps
        g = (req.guidance_scale if req.guidance_scale is not None
             else self.guidance_scale)
        if n > self.max_steps:
            raise ValueError(
                f"request rid={req.rid} wants num_steps={n} but this "
                f"engine's plan tables are max_steps={self.max_steps} "
                f"wide; construct the engine with max_steps>={n}")
        req.num_steps, req.guidance_scale = n, float(g)
        return SamplingPlan(n, float(g))

    @torch.no_grad()
    def add_request(self, req: DiffusionRequest) -> bool:
        """Admit one request into a free slot (mid-flight is fine): reset
        the slot's cache rows, seed its latents, land its plan rows and zero
        its request-scoped counters.  No host sync."""
        free = self.free_slots()
        if not free:
            return False
        s = free[0]
        plan = self.resolve_plan(req)
        ts_row, prev_row = plan.rows(self.max_steps, self.num_train_steps)
        self.state = self.runner.reset_slot(self.state, self._slot_rows(s))
        self.x[s] = self.noise_fn(req).to(device=self.device, dtype=F32)
        self.plan["ts"][s].copy_(to_device(ts_row, self.device))
        self.plan["ts_prev"][s].copy_(to_device(prev_row, self.device))
        # fill_, not item assignment: a Python scalar assigned to a 0-dim
        # CUDA view goes through a synchronizing host copy
        self.plan["guidance"][s].fill_(plan.guidance_scale)
        for v in self.slot_acc.values():
            v[s].fill_(0.0)
        self.slots[s] = req
        self.slot_step[s] = 0
        self.slot_budget[s] = plan.num_steps
        self.slot_label[s] = req.label
        req.admit_step = self.clock
        return True

    def step(self) -> List[DiffusionRequest]:
        """One engine step: advance all active slots one denoising step.
        Returns the requests that finished on this step (slots freed)."""
        active = np.array([r is not None for r in self.slots])
        self.clock += 1
        if not active.any():            # idle tick: time passes, no compute
            return []
        dev = self.device
        self._serve_step(
            to_device(np.where(active, self.slot_step, 0).astype(np.int64), dev),
            to_device(self.slot_label, dev), to_device(active, dev))
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
                finished.append(req)
                # reset on free as well as on admission, so a freed slot
                # never carries stale gate/cache state
                self.slots[s] = None
                self.slot_step[s] = -1
                self.state = self.runner.reset_slot(self.state,
                                                    self._slot_rows(s))
        return finished

    def _harvest(self, done_slots: List[int]) -> None:
        """Fill ``req.latents`` and ``req.cache`` for finished slots: one
        device->host read per completion step."""
        self.host_syncs += 1
        keys = list(self.slot_acc)
        flat = torch.cat([self.x.reshape(-1)]
                         + [self.slot_acc[k] for k in keys]).cpu().numpy()
        x_host = flat[:self.x.numel()].reshape(self.x.shape)
        acc_host = flat[self.x.numel():].reshape(len(keys), self.S)
        for s in done_slots:
            req = self.slots[s]
            req.latents = x_host[s].copy()
            req.cache = {k: float(acc_host[i, s]) for i, k in enumerate(keys)}

    def run(self, requests: Union[List[DiffusionRequest], RequestQueue],
            *, lockstep: bool = False, sched_policy: str = "fifo",
            max_engine_steps: int = 100_000) -> List[DiffusionRequest]:
        """Drive a whole trace.  ``lockstep=False`` (continuous batching)
        admits arrived requests into free slots every step;
        ``lockstep=True`` admits a new wave only once every slot is free."""
        queue = (requests if isinstance(requests, RequestQueue)
                 else RequestQueue(list(requests), policy=sched_policy))
        finished: List[DiffusionRequest] = []
        while queue or any(r is not None for r in self.slots):
            if self.clock >= max_engine_steps:
                break
            if not lockstep or all(r is None for r in self.slots):
                while self.free_slots() and queue.peek_arrived(self.clock):
                    self.add_request(queue.pop_arrived(self.clock))
            finished.extend(self.step())
        return finished

    def cache_stats(self) -> Dict:
        """Engine-lifetime cache counters, active slots only; raw per-row
        counters (idle padding steps included) under per_slot_*."""
        def acc(k):
            v = self.acc.get(k)
            return 0.0 if v is None else float(v)

        def per_slot(k):
            return [float(x) for x in self.state["stats"][k].cpu()]

        skipped, computed = acc("blocks_skipped"), acc("blocks_computed")
        tot = computed + skipped
        return {
            "policy": self.runner.policy,
            "engine_steps": self.clock,
            "model_steps": self.model_steps,
            "blocks_skipped": skipped,
            "blocks_computed": computed,
            "block_cache_ratio": skipped / tot if tot else 0.0,
            "steps_reused": acc("steps_reused"),
            "per_slot_blocks_skipped": per_slot("blocks_skipped"),
            "per_slot_blocks_computed": per_slot("blocks_computed"),
        }
