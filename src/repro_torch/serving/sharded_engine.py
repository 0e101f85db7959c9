"""Mesh-parallel diffusion serving: ``DiffusionServingEngine`` past one
device, after the reference's ``serving/sharded_engine.py``.

``ShardedDiffusionEngine`` keeps the single-device engine's host
orchestration (slots, queue, plans, lockstep, stats conventions) and puts
the device runtime on a ``(data, model)`` mesh of ranks, one process each:

- **slots over data.**  Data rank ``d`` owns slots ``[d * S/data, (d+1) *
  S/data)``: their latents, both CFG rows of every policy-state leaf, their
  plan rows and request-scoped counters, laid out as a single-device engine
  of ``S/data`` slots would lay them out (the base engine's slot window).
  The reference shards the ``2S`` state rows ``P(data)``, which on
  ``data = 2`` puts every cond row on one device and every uncond row on
  the other and lets its compiler move them for the CFG blend; an eager
  port has no compiler, so each rank owns whole slots instead.  The specs
  (``serve_state_specs`` ...) are the reference's; the row layout is this
  engine's own.  When ``S`` does not divide over ``data``, the slot spec
  drops the axis, as ``spec_for`` does, and every rank runs every slot.
- **weights over model.**  Each rank cuts the DiT blocks' weights by
  ``param_specs`` of the model's ``param_defs`` (heads and ffn columns over
  ``model``, where they divide) into local shards; ``DiTModel.block_apply``
  all-reduces its sharded products over the model group.  The branches
  that skip a block agree over the group first (``sharding.agree_all``).

**Step graphs.**  As on one device, a warm step is one CUDA graph whose
skipped blocks are IF nodes (``core/step_graph.py``), so it reads nothing
on the host.  The graph holds ``CachedDiT.step``'s device work only, which
crosses no ``data`` rank; the engine's reductions over ``data``
(``_batch_sum``, completion, ``cache_stats``, ``harvest_metrics``) and the
snapshot's broadcast stay outside it.  Under a model group the skip is
agreed on the device inside the graph, which only nccl can capture
(``step_graph.capture_refusal``): ``step_graph=None`` turns graphs on
wherever they can hold the step (the card, and nccl when ``model > 1``),
``step_graph=True`` where they cannot raises ``ValueError`` naming why,
and ``False`` keeps the eager step, whose every skip is a host read.
Over gloo with ``data > 1``, ``_batch_sum``'s all-reduce of a CUDA tensor
goes through the host once per engine step (``batch_sum_round_trips``).

Every rank runs the same host loop.  Admission depends only on host
bookkeeping, so every rank schedules the same (request, slot, step)
trace; only a slot's owner touches its device rows.  Admission is async:
the owner draws the noise on its device and the plan rows land through
pinned buffers (the base engine's ``_admit``), with no host sync.
Completion is deferred: ``_harvest`` makes device-side row copies and
``finalize_requests`` fetches them once per run, reduced over ``data`` so
that every rank holds every finished request.  ``async_admission=False``
fetches at each completion instead, as the single-device engine does.

A preemption snapshot is broadcast from the slot's owner over ``data``
(``serve_snapshot_specs``: replicated), so any data rank can restore it
into any slot.  Counters stay per rank and are summed over ``data`` at read
time only (``cache_stats``, ``harvest_metrics``); the device metrics'
per-slot leaves live with their slots, and the whole-batch leaves (steps,
active slots, the skip-fraction histogram) are recorded by data rank 0,
whose skip fraction sums the steps reused over ``data`` once per step.

**Numerics self-check.**  With ``model > 1`` (or ``numerics_check=True``)
the engine runs two synthetic serve steps at construction and compares
every output leaf with a single-device engine over the unsharded weights
(rtol = atol = 1e-2, integer and bool leaves exact), raising
``RuntimeError`` on every rank if any rank disagrees.

**Backend.**  ``nccl`` when each rank has a card of its own; ``gloo`` on
the CPU and when ranks share one card (NCCL refuses two ranks on one
device).  Gloo takes CUDA tensors in ``broadcast`` and ``all_reduce``
only, so every collective here is one of those two.  ``topology()``
reports the backend.
"""
from __future__ import annotations

import contextlib
import copy
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from repro_torch.core.runner import CachedDiT
from repro_torch.core.step_graph import capture_refusal
from repro_torch.distributed.sharding import (ShardingCtx, _slot_axis,
                                              local_slice, make_rules,
                                              param_specs, spec_for,
                                              use_sharding)
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serving.diffusion_engine import DiffusionServingEngine
from repro_torch.serving.scheduler import DiffusionRequest

F32 = torch.float32

# device-metrics leaves that count the whole batch once per step: every
# rank records them alike, data rank 0's copy is the one that is summed
_BATCH_COUNTERS = (obs_metrics.SERVE_STEPS, obs_metrics.ACTIVE_SLOT_STEPS,
                   obs_metrics.AUDIT_STEPS)
_BATCH_HISTS = (obs_metrics.ACTIVE_SLOTS, obs_metrics.SKIP_FRACTION)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_rebuild(v, it) for v in tree))
    return next(it)


class ShardedDiffusionEngine(DiffusionServingEngine):
    """``DiffusionServingEngine`` on a ``(data, model)`` mesh of ranks with
    async admission and deferred completion.  The engine cuts the runner's
    model in place (its blocks then hold this rank's shards)."""

    def __init__(self, runner: CachedDiT, *, max_slots: int, mesh=None,
                 num_steps: int = 50, guidance_scale: float = 4.0,
                 num_train_steps: int = 1000,
                 max_steps: Optional[int] = None,
                 async_admission: bool = True,
                 numerics_check: Optional[bool] = None,
                 noise_fn=None, cfg_rows: bool = True, collector=None,
                 tracer=None, enable_metrics: bool = True,
                 audit_fraction: float = 0.0, audit_seed: int = 0,
                 step_graph: Optional[bool] = None):
        self.mesh = mesh if mesh is not None else make_serving_mesh()
        self.rules = make_rules("serve")
        self._ctx = ShardingCtx(self.mesh, self.rules)
        self.async_admission = async_admission
        # why a step graph cannot hold this mesh's step (None: it can)
        self.graph_refusal = why = capture_refusal(self._ctx, runner.device)
        if step_graph and why is not None:
            raise ValueError(f"step_graph=True on this mesh: {why}")
        ext = self._ctx.extents
        self._coords = dict(zip(self.mesh.mesh_dim_names,
                                self.mesh.get_coordinate()))
        self._data_group = self._ctx.group("data")
        dit = runner.model.cfg.dit
        x_spec = spec_for((max_slots, dit.image_size, dit.image_size,
                           dit.in_channels), ("slot", None, None, None),
                          self._ctx)
        # slots sharded over data: each data rank owns a window of them;
        # else every rank runs every slot and no counter is summed
        self._split = x_spec[0] is not None and ext["data"] > 1
        # gloo reduces a CUDA tensor through the host
        self._via_host = (self._split and runner.device.type == "cuda"
                          and dist.get_backend(self._data_group) == "gloo")
        self.batch_sum_round_trips = 0
        self._pending: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        super().__init__(runner, max_slots=max_slots, num_steps=num_steps,
                         guidance_scale=guidance_scale,
                         num_train_steps=num_train_steps,
                         max_steps=max_steps, noise_fn=noise_fn,
                         cfg_rows=cfg_rows, collector=collector,
                         tracer=tracer, enable_metrics=enable_metrics,
                         audit_fraction=audit_fraction,
                         audit_seed=audit_seed,
                         step_graph=(why is None if step_graph is None
                                     else step_graph))
        self._place_metrics()
        self._full_blocks = self._shard_weights()
        if numerics_check is None:
            numerics_check = ext["model"] > 1
        if numerics_check:
            self._verify_step_numerics()
        self._full_blocks = None        # the unsharded weights are not kept

    # -- placement ------------------------------------------------------

    def _slot_window(self) -> Tuple[int, int]:
        if not self._split:
            return 0, self.S
        n = self.S // self._ctx.extents["data"]
        return self._coords["data"] * n, n

    def _place_metrics(self) -> None:
        """Per-slot metrics leaves become views of this rank's slots in the
        all-slot buffer; on data ranks but 0 the whole-batch leaves are
        masked out of the read-time sum."""
        self._metrics_full = self.metrics
        if not self.metrics:
            return
        lo, n = self._lo, self.S_dev
        m = dict(self.metrics)
        m["per_slot"] = {k: v[lo:lo + n]
                         for k, v in self.metrics["per_slot"].items()}
        self.metrics = m
        flat = self._metrics_full["flat"]
        keep = torch.ones_like(flat)
        if self._split and self._coords["data"] != 0:
            batch = [m["counters"][k] for k in _BATCH_COUNTERS
                     if k in m["counters"]]
            for k in _BATCH_HISTS:
                batch += list(m["hist"][k].values())
            for leaf in batch:
                off = leaf.storage_offset() - flat.storage_offset()
                keep[off:off + leaf.numel()] = 0.0
        self._metrics_keep = keep

    def _shard_weights(self) -> List[Dict[str, torch.Tensor]]:
        """Replace each block weight that its spec shards by this rank's
        block of it; returns the unsharded tensors, per block, for the
        numerics self-check.  Top-level weights replicate under the serve
        rules."""
        model = self.runner.model
        specs = param_specs(model.param_defs(), self._ctx)
        if any(a is not None for k, sp in specs.items() if k != "blocks"
               for a in sp):
            raise ValueError("the serve rules shard no top-level DiT "
                             f"weight; got {specs}")
        ext = self._ctx.extents
        full: List[Dict[str, torch.Tensor]] = []
        for blk in model.blocks:
            kept = {}
            for name, spec in specs["blocks"].items():
                spec = spec[1:]                   # the layers axis
                if all(a is None for a in spec):
                    continue
                t = getattr(blk, name).data
                kept[name] = t
                blk._parameters[name] = nn.Parameter(
                    local_slice(t, spec, self._coords, ext),
                    requires_grad=False)
            full.append(kept)
        return full

    @contextlib.contextmanager
    def _unsharded_weights(self):
        """The blocks' unsharded weights in place for the block, the
        shards back after it."""
        blocks = self.runner.model.blocks
        local = [{k: blk._parameters[k] for k in kept}
                 for blk, kept in zip(blocks, self._full_blocks)]
        for blk, kept in zip(blocks, self._full_blocks):
            for k, t in kept.items():
                blk._parameters[k] = nn.Parameter(t, requires_grad=False)
        try:
            yield
        finally:
            for blk, params in zip(blocks, local):
                blk._parameters.update(params)

    # -- collectives ------------------------------------------------------

    def _sum_data(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data group, in place (this rank's partial
        in, every slot's total out); the identity unless slots split."""
        if self._split:
            dist.all_reduce(t, group=self._data_group)
        return t

    def _owner_rank(self, s: int) -> int:
        """The global rank that owns slot ``s`` in this rank's data group
        (the same model coordinate)."""
        d = s // self.S_dev
        return int(self.mesh.mesh[d, self._coords["model"]])

    # -- device step ------------------------------------------------------

    def _serve_step(self, *args) -> None:
        # the blocks' all-reduces and agree_all read the mesh from here
        with use_sharding(ctx=self._ctx):
            super()._serve_step(*args)

    def _batch_sum(self, v: torch.Tensor) -> torch.Tensor:
        if not self._split:
            return v
        self.batch_sum_round_trips += int(self._via_host)
        return self._sum_data(v.reshape(1).clone())[0]

    # -- preemption -------------------------------------------------------

    def _snapshot(self, s: int) -> Dict:
        """The owner's snapshot of slot ``s``, broadcast over ``data`` so
        every rank holds it (a non-owner's own slot gives the layout)."""
        if not self._split:
            return super()._snapshot(s)
        snap = super()._snapshot(s if self._owns(s) else self._lo)
        leaves = [t.contiguous() for t in _leaves(snap)]
        buf = torch.cat([t.reshape(-1).view(torch.uint8) for t in leaves])
        dist.broadcast(buf, src=self._owner_rank(s), group=self._data_group)
        out, off = [], 0
        for t in leaves:
            n = t.numel() * t.element_size()
            # a copy: a leaf's byte offset need not align to its dtype
            out.append(buf[off:off + n].clone().view(t.dtype)
                       .reshape(t.shape))
            off += n
        return _rebuild(snap, iter(out))

    def _restore(self, snap: Dict, s: int) -> None:
        if self._owns(s):
            super()._restore(snap, s)

    # -- completion -------------------------------------------------------

    def _gather_rows(self, slots: List[int]) -> np.ndarray:
        """Latents and request-scoped counters of ``slots``, one row each,
        from their owners to every rank: one device->host read."""
        self.host_syncs += 1
        width = self.x[0].numel() + self._slot_mat.shape[0]
        buf = torch.zeros((len(slots), width), dtype=F32, device=self.device)
        for i, s in enumerate(slots):
            if self._owns(s):
                ls = s - self._lo
                buf[i] = torch.cat([self.x[ls].reshape(-1),
                                    self._slot_mat[:, ls]])
        return self._sum_data(buf).cpu().numpy()

    def _fill(self, req: DiffusionRequest, row: np.ndarray) -> None:
        nx = self.x[0].numel()
        req.latents = row[:nx].reshape(tuple(self.x.shape[1:])).copy()
        cache = {k: float(row[nx + i]) for i, k in enumerate(self.slot_acc)}
        cache.update(req.cache or {})
        req.cache = cache

    def _harvest(self, done_slots: List[int]) -> None:
        if not self.async_admission:
            host = self._gather_rows(done_slots)
            for i, s in enumerate(done_slots):
                self.slots[s].cache = None
                self._fill(self.slots[s], host[i])
            return
        # deferred: device-side row copies now, one fetch at run end
        for s in done_slots:
            req = self.slots[s]
            if self._owns(s):
                ls = s - self._lo
                self._pending[req.rid] = (self.x[ls].clone(),
                                          self._slot_mat[:, ls].clone())
            req.latents, req.cache = None, {}

    def finalize_requests(self, finished: List[DiffusionRequest]) -> None:
        """The run's one completion fetch: every deferred request's latents
        and counters, reduced over ``data`` to every rank."""
        todo = [r for r in finished if r.latents is None]
        if not self.async_admission or not todo:
            return
        self.host_syncs += 1
        width = self.x[0].numel() + self._slot_mat.shape[0]
        buf = torch.zeros((len(todo), width), dtype=F32, device=self.device)
        for i, r in enumerate(todo):
            got = self._pending.pop(r.rid, None)
            if got is not None:
                buf[i] = torch.cat([got[0].reshape(-1), got[1]])
        host = self._sum_data(buf).cpu().numpy()
        for i, r in enumerate(todo):
            self._fill(r, host[i])

    # -- reporting --------------------------------------------------------

    def _stat_view(self, row_keys):
        """Counters summed over ``data`` at read time: the headline sums
        and each state row's counters placed at its row in the all-slot
        layout (cond rows, then uncond rows), in one reduction and one
        read."""
        keys = list(self.acc)
        n_rows = self.rows_per_slot * self.S
        rows = torch.zeros((len(row_keys), n_rows), dtype=F32,
                           device=self.device)
        lo, n = self._lo, self.S_dev
        for j, k in enumerate(row_keys):
            v = self.state["stats"][k].to(F32)
            for r in range(self.rows_per_slot):
                rows[j, r * self.S + lo:r * self.S + lo + n] = \
                    v[r * n:(r + 1) * n]
        flat = torch.cat([self._acc_vec, rows.reshape(-1)])
        host = self._sum_data(flat).cpu().numpy()
        totals = {k: float(host[i]) for i, k in enumerate(keys)}
        per = host[len(keys):].reshape(len(row_keys), n_rows)
        return totals, {k: [float(x) for x in per[j]]
                        for j, k in enumerate(row_keys)}

    def harvest_metrics(self) -> Optional[Dict]:
        """The device metrics summed over ``data`` (the whole-batch leaves
        from data rank 0 only), into the collector: one reduction, one
        read."""
        if self.collector is None:
            return None
        if not self.metrics:
            return self.collector.harvest(None, at_step=self.clock)
        flat = self._metrics_full["flat"]
        total = self._sum_data(flat * self._metrics_keep)
        return self.collector.harvest({**self._metrics_full, "flat": total},
                                      at_step=self.clock)

    def topology(self) -> Dict:
        ext = self._ctx.extents
        return {"data": ext.get("data", 1), "model": ext.get("model", 1),
                "devices": int(self.mesh.mesh.numel()),
                "backend": dist.get_backend()}

    # -- numerics self-check ----------------------------------------------

    def _ref_rows(self) -> torch.Tensor:
        """This rank's state rows in an all-slot engine's row layout."""
        lo, n = self._lo, self.S_dev
        rows = [r * self.S + lo + i for r in range(self.rows_per_slot)
                for i in range(n)]
        return torch.tensor(rows, dtype=torch.int64, device=self.device)

    def _verify_step_numerics(self, *, rtol: float = 1e-2,
                              atol: float = 1e-2) -> None:
        """Run two synthetic serve steps here and on a single-device engine
        over the unsharded weights, and compare every output leaf (this
        rank's rows; counters summed over ``data``).  Raises
        ``RuntimeError`` on every rank if any rank disagrees.  Both engines
        step eagerly (``CachedDiT.eager``): no graph is captured on the
        unsharded weights, whose pointers a replay would keep, and the
        runner's graph setting is left as it was.  Leaves the engine's
        device state as constructed."""
        with self.runner.eager():
            self._check_step_numerics(rtol, atol)

    def _check_step_numerics(self, rtol: float, atol: float) -> None:
        impl = self.runner.impl
        saved = (impl.host_syncs, copy.deepcopy(getattr(impl, "step_kinds",
                                                        None)))
        dev, S, lo, n = self.device, self.S, self._lo, self.S_dev
        gen = torch.Generator(dev).manual_seed(0)
        x0 = torch.randn(tuple((S,) + tuple(self.x.shape[1:])),
                         generator=gen, device=dev)
        labels = torch.zeros((S,), dtype=torch.int64, device=dev)
        active = torch.ones((S,), dtype=torch.bool, device=dev)
        active_host = np.ones((S,), bool)
        aflag = self._audit_on
        with self._unsharded_weights():
            ref = DiffusionServingEngine(
                self.runner, max_slots=S, num_steps=self.num_steps,
                guidance_scale=self.guidance_scale,
                num_train_steps=self.num_train_steps,
                max_steps=self.max_steps, cfg_rows=self.cfg_rows,
                enable_metrics=bool(self.metrics),
                audit_fraction=self.audit_fraction,
                audit_seed=self.audit_seed, step_graph=False)
            ref.x.copy_(x0)
            refs = []
            for step in range(2):
                idx = torch.full((S,), step, dtype=torch.int64, device=dev)
                ref._serve_step(idx, labels, active, active_host, aflag)
                # copies: the engine updates its counters in place
                refs.append([(k, v.clone())
                             for k, v in self._probe_leaves(ref, full=True)])
        self.x.copy_(x0[lo:lo + n])
        bad = ""
        for step in range(2):
            idx = torch.full((n,), step, dtype=torch.int64, device=dev)
            self._serve_step(idx, labels[lo:lo + n], active[lo:lo + n],
                             active_host, aflag)
            for (name, a), (_, b) in zip(refs[step],
                                         self._probe_leaves(self)):
                if a.is_floating_point():
                    a, b = a.float().cpu().numpy(), b.float().cpu().numpy()
                    if (not np.isfinite(b).all()
                            or not np.allclose(a, b, rtol=rtol, atol=atol)):
                        diff = np.abs(a - b)
                        bad = bad or (
                            f"step {step}, leaf {name}: max|diff|="
                            f"{float(np.nanmax(diff)):.3e} "
                            f"nan={bool(np.isnan(b).any())}")
                elif not torch.equal(a.cpu(), b.cpu()):
                    bad = bad or (f"step {step}, leaf {name}: "
                                  "integer/bool mismatch")
        flag = torch.tensor([1 if bad else 0], dtype=torch.int32, device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        # leave the device state as a fresh engine holds it
        self.state = self.runner.init_state(self.rows_per_slot * n)
        self.x.zero_()
        self._acc_vec.zero_()
        self._slot_mat.zero_()
        if self.metrics:
            self._metrics_full["flat"].zero_()
        impl.host_syncs = saved[0]
        if saved[1] is not None:
            impl.step_kinds = saved[1]
        if int(flag.item()):
            topo = self.topology()
            raise RuntimeError(
                f"ShardedDiffusionEngine numerics self-check failed on mesh "
                f"(data={topo['data']}, model={topo['model']}): "
                f"{bad or 'another rank disagreed'}")

    def _probe_leaves(self, eng: DiffusionServingEngine, *,
                      full: bool = False) -> List[Tuple[str, torch.Tensor]]:
        """(name, tensor) of every output leaf of a serve step: this rank's
        rows of an all-slot engine (``full``), or this engine's own with
        its counters summed over ``data``."""
        lo, n = self._lo, self.S_dev
        out: List[Tuple[str, torch.Tensor]] = []
        if full:
            rows = self._ref_rows()
            batch = self.rows_per_slot * self.S
            out.append(("x", eng.x[lo:lo + n]))
            for i, leaf in enumerate(_leaves(eng.state)):
                axis = _slot_axis(tuple(leaf.shape), batch, self.runner.L)
                out.append((f"state[{i}]", leaf if axis is None
                            else leaf.index_select(axis, rows)))
            out.append(("acc", eng._acc_vec))
            out.append(("slot_acc", eng._slot_mat[:, lo:lo + n]))
            if eng.metrics:
                out.append(("metrics", eng.metrics["flat"]))
            return out
        out.append(("x", self.x))
        for i, leaf in enumerate(_leaves(self.state)):
            out.append((f"state[{i}]", leaf))
        out.append(("acc", self._sum_data(self._acc_vec.clone())))
        out.append(("slot_acc", self._slot_mat))
        if self.metrics:
            flat = self._metrics_full["flat"]
            total = self._sum_data(flat * self._metrics_keep)
            # the all-slot engine's per-slot leaves beside this rank's
            out.append(("metrics", total))
        return out
