"""Rank processes for ``tests/test_torch_sharded_serving.py`` (and
``graph_rule_rank`` for ``tests/test_torch_sharded_graph.py``).

``MeshRun({(data, model): scenarios}, weights, noise)`` (``weights``:
the port config under ``cfg`` and a state dict of numpy arrays under
``params``; ``noise``: each request seed's initial latents) starts
``data * model`` processes per mesh (the launcher's ``RankGroup``), all
meshes at once, joins each mesh's into a ``gloo`` group on localhost and
has each rank serve its mesh's scenarios through ``ShardedDiffusionEngine``
on a ``(data, model)`` mesh, in order; ``.results()`` collects them.
This module imports only the port, never ``tests/conftest.py`` (which
imports JAX): each child imports it afresh.  Each rank runs one PyTorch
thread.  A child's exception comes back as its
traceback; a child that does not answer within the timeout is killed and
the call raises.

A scenario is a dict: ``name``, ``kind`` (``run``, ``preempt``, ``slo``,
``admit`` or ``bad_reduce``), ``policy``, ``slots``, ``steps``, ``max_steps``,
``guidance``, ``trace`` (``poisson_trace`` keywords), and optionally
``merge`` (ratio, window), ``lockstep``, ``cfg_rows``, ``async_admission``,
``collector``, ``policy_kwargs`` and ``single`` (also serve the trace on
the single-device engine in the same process and report whether the two
agree bitwise).
"""
from typing import Dict, List, Tuple

import numpy as np
import torch


def _model(weights: Dict):
    """A fresh CPU DiT of ``weights["cfg"]`` holding ``weights["params"]``
    (the engine cuts a model's blocks in place, so each serve gets its
    own)."""
    from repro_torch.models.dit import DiTModel
    model = DiTModel(weights["cfg"], device="cpu")
    model.load_state_dict({k: torch.from_numpy(v.copy())
                           for k, v in weights["params"].items()})
    return model


def _runner(sc, weights):
    from repro_torch.configs.base import FastCacheConfig
    from repro_torch.core.runner import CachedDiT
    merge = sc.get("merge")
    fc = (FastCacheConfig(merge_enabled=True, merge_ratio=merge[0],
                          merge_window=merge[1])
          if merge else FastCacheConfig())
    return CachedDiT(_model(weights), fc, policy=sc["policy"],
                     **sc.get("policy_kwargs", {}))


def _engine_kw(sc, noise):
    return dict(max_slots=sc["slots"], num_steps=sc["steps"],
                max_steps=sc["max_steps"], guidance_scale=sc["guidance"],
                cfg_rows=sc.get("cfg_rows", True),
                noise_fn=lambda r: torch.from_numpy(noise[r.seed].copy()))


def _trace(sc):
    from repro_torch.serving.scheduler import poisson_trace
    return poisson_trace(num_classes=10, **sc["trace"])


def _requests(done) -> Dict[int, Dict]:
    return {r.rid: {"latents": r.latents, "cache": dict(r.cache),
                    "admit": r.admit_step, "finish": r.finish_step,
                    "num_steps": r.num_steps,
                    "guidance": r.guidance_scale, "label": r.label,
                    "seed": r.seed}
            for r in done}


def _serve(sc, weights, noise, mesh) -> Dict:
    from repro_torch.obs.metrics import MetricsCollector
    from repro_torch.serving.sharded_engine import ShardedDiffusionEngine
    runner = _runner(sc, weights)
    collector = MetricsCollector() if sc.get("collector") else None
    eng = ShardedDiffusionEngine(
        runner, mesh=mesh, collector=collector,
        async_admission=sc.get("async_admission", True),
        **_engine_kw(sc, noise))
    done = eng.run(_trace(sc), lockstep=sc.get("lockstep", False))
    out = {"requests": _requests(done), "stats": eng.cache_stats(),
           "topology": eng.topology(), "clock": eng.clock,
           "model_steps": eng.model_steps, "engine_syncs": eng.host_syncs,
           "policy_syncs": runner.impl.host_syncs,
           "step_kinds": dict(getattr(runner.impl, "step_kinds", {})),
           "window": (eng.S_dev, eng._lo)}
    if collector is not None:
        w = collector.windows[-1]
        out["metrics"] = {k: w[k] for k in ("counters", "histograms",
                                            "per_slot")}
    if sc.get("single"):
        from repro_torch.serving.diffusion_engine import \
            DiffusionServingEngine
        base = DiffusionServingEngine(_runner(sc, weights),
                                      **_engine_kw(sc, noise))
        bdone = base.run(_trace(sc), lockstep=sc.get("lockstep", False))
        want = _requests(bdone)
        bst = base.cache_stats()
        out["single_equal"] = (
            sorted(want) == sorted(out["requests"])
            and all(np.array_equal(want[k]["latents"],
                                   out["requests"][k]["latents"])
                    and want[k]["cache"] == out["requests"][k]["cache"]
                    and want[k]["admit"] == out["requests"][k]["admit"]
                    and want[k]["finish"] == out["requests"][k]["finish"]
                    for k in want)
            and all(bst[k] == out["stats"][k] for k in bst))
    return out


def _preempt(sc, weights, noise, mesh) -> Dict:
    """Admit a and b (slots 0 and 1), preempt b after 3 steps, admit c
    into b's slot, step twice, resume b into the first free slot (slot 2,
    another data rank's on data = 2), drain."""
    from repro_torch.serving.scheduler import DiffusionRequest
    from repro_torch.serving.sharded_engine import ShardedDiffusionEngine
    eng = ShardedDiffusionEngine(_runner(sc, weights), mesh=mesh,
                                 **_engine_kw(sc, noise))
    a, b, c = (DiffusionRequest(rid=i, label=i + 1, seed=10 + i,
                                arrival_step=0, num_steps=sc["steps"],
                                guidance_scale=sc["guidance"])
               for i in range(3))
    assert eng.add_request(a) and eng.add_request(b)
    done = []
    for _ in range(3):
        done += eng.step()
    donor = eng.slots.index(b)
    eng.preempt(donor)
    assert eng.add_request(c) and eng.slots.index(c) == donor
    for _ in range(2):
        done += eng.step()
    assert eng.add_request(b)
    resumed = eng.slots.index(b)
    while len(done) < 3:
        done += eng.step()
    eng.finalize_requests(done)
    return {"requests": _requests(done), "donor": donor,
            "resumed": resumed, "window": (eng.S_dev, eng._lo)}


def _admit(sc, weights, noise, mesh) -> Dict:
    """Admit three requests (slots 0, 1, 2) with their own plans and read
    back what landed in this rank's device slots: the latents and plan
    rows of each, and which global slot each device slot is."""
    from repro_torch.serving.scheduler import DiffusionRequest
    from repro_torch.serving.sharded_engine import ShardedDiffusionEngine
    eng = ShardedDiffusionEngine(_runner(sc, weights), mesh=mesh,
                                 **_engine_kw(sc, noise))
    for i, (n, g) in enumerate(((4, 4.0), (6, 1.0), (5, 2.0))):
        assert eng.add_request(DiffusionRequest(
            rid=i, label=i + 1, seed=10 + i, num_steps=n, guidance_scale=g))
    return {"slots": list(range(eng._lo, eng._lo + eng.S_dev)),
            "x": eng.x.numpy().copy(),
            "ts": eng.plan["ts"].numpy().copy(),
            "ts_prev": eng.plan["ts_prev"].numpy().copy(),
            "guidance": eng.plan["guidance"].numpy().copy()}


def _bad_reduce(sc, weights, noise, mesh) -> Dict:
    """A block whose sharded products skip the all-reduce (a wrong
    reduction): the numerics self-check must raise."""
    from repro_torch.models import dit
    from repro_torch.serving.sharded_engine import ShardedDiffusionEngine
    real = dit.tp_all_reduce
    dit.tp_all_reduce = lambda partial: partial
    try:
        ShardedDiffusionEngine(_runner(sc, weights), mesh=mesh,
                               **_engine_kw(sc, noise))
    except RuntimeError as e:
        return {"raised": str(e)}
    finally:
        dit.tp_all_reduce = real
    return {"raised": None}


def slo_run(eng, trace):
    """The SLO plane over ``eng``: EDF, deadline-aware admission rejecting
    misses, the shed ladder (watermarks 4 / 1), preemption on.  Returns
    the finished requests, the rejected ones and the preemptions."""
    from repro_torch.serving.slo import (AdmissionController,
                                         DegradationController, SLOScheduler)
    adm = AdmissionController(eng, on_miss="reject", defer_steps=2,
                              collector=eng.collector)
    ctl = DegradationController(high_watermark=4, low_watermark=1,
                                patience=2, collector=eng.collector)
    sched = SLOScheduler(eng, sched_policy="edf", admission=adm,
                         controller=ctl)
    done = sched.run(trace)
    return done, sched.rejected


def _slo(sc, weights, noise, mesh) -> Dict:
    """The SLO plane (``slo_run``) over the sharded engine on the
    scenario's trace (``trace`` keywords of ``slo_trace``)."""
    from repro_torch.obs.metrics import MetricsCollector
    from repro_torch.serving.sharded_engine import ShardedDiffusionEngine
    eng = ShardedDiffusionEngine(_runner(sc, weights), mesh=mesh,
                                 collector=MetricsCollector(),
                                 **_engine_kw(sc, noise))
    done, rejected = slo_run(eng, slo_trace(**sc["trace"]))
    return {"requests": _requests(done),
            "preemptions": {r.rid: r.preemptions for r in done},
            "rejected": [(r.rid, r.reject_reason) for r in rejected],
            "clock": eng.clock, "model_steps": eng.model_steps}


def slo_trace(num_requests, rate, seed, segments, priority_mix,
              deadline_slack_mix):
    """A calm -> burst -> calm Poisson trace with priority classes and
    deadlines (``segments``: the piecewise rate's (until step, rate))."""
    from repro_torch.serving.scheduler import piecewise_rate, poisson_trace
    return poisson_trace(num_requests, rate, seed=seed, num_classes=10,
                         rate_fn=piecewise_rate(segments),
                         priority_mix=priority_mix,
                         deadline_slack_mix=deadline_slack_mix)


def echo_rank(rank, world, port, fail_rank=None, sleep_s=0.0):
    """A ``RankGroup`` target: (rank, world) after ``sleep_s`` seconds, or
    an error on ``fail_rank``."""
    import time
    time.sleep(sleep_s)
    if rank == fail_rank:
        raise ValueError(f"rank {rank} fails on purpose")
    return rank, world


_KINDS = {"run": _serve, "preempt": _preempt, "bad_reduce": _bad_reduce,
          "slo": _slo, "admit": _admit}


def _rank_main(rank, world, port, topo, scenarios, weights, noise):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_ranks, make_serving_mesh
    init_ranks(rank, world, port=port, backend="gloo")
    mesh = make_serving_mesh(*topo)
    res = {sc["name"]: _KINDS[sc.get("kind", "run")](sc, weights, noise, mesh)
           for sc in scenarios}
    dist.destroy_process_group()
    return res


class MeshRun:
    """Rank processes of several meshes, started at once (each mesh its
    own process group, ``launch.mesh.RankGroup``); ``results()`` waits for
    them."""

    def __init__(self, jobs: Dict[Tuple[int, int], List[Dict]],
                 weights: Dict, noise: Dict[int, np.ndarray],
                 timeout: float = 300.0):
        from repro_torch.launch.mesh import RankGroup
        self.groups = {
            topo: RankGroup(_rank_main, topo[0] * topo[1],
                            (tuple(topo), scenarios, weights, noise),
                            timeout=timeout, label=f"mesh {tuple(topo)}")
            for topo, scenarios in jobs.items()}

    def results(self) -> Dict[Tuple[int, int], List[Dict]]:
        """Every mesh's ranks' results, by mesh and rank.  Raises on a
        child's error, on a child that exits without a result, or when the
        timeout passes; no child outlives the call."""
        try:
            return {topo: g.results() for topo, g in self.groups.items()}
        finally:
            for g in self.groups.values():
                g.close()


# each rank's masks for the device agreement, and their AND over the two
# ranks: every sample caches on both / on one rank only / on neither
AGREE_MASKS = {0: [[True, True], [True, True], [True, False], [False, False]],
               1: [[True, True], [True, False], [True, True], [True, True]]}
AGREED = [True, False, False, False]


class _NoHostReads:
    """Inside the block a tensor read on the host (``item``, ``bool``,
    ``tolist``, ``numpy``, ``int``, ``float``) raises."""
    _NAMES = ("item", "__bool__", "tolist", "numpy", "__int__", "__float__")

    def __enter__(self):
        self.saved = {n: getattr(torch.Tensor, n) for n in self._NAMES}

        def refuse(*_a, **_k):
            raise AssertionError("a host read inside the agreement")
        for n in self._NAMES:
            setattr(torch.Tensor, n, refuse)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(torch.Tensor, n, fn)
        return False


def graph_rule_rank(rank, world, port):
    """A ``RankGroup`` target for ``tests/test_torch_sharded_graph.py`` on
    two gloo ranks of the CPU: the step graphs' device agreement over the
    (1, 2) mesh's model group (and the identity on (2, 1)) with host reads
    refused, the capture rule for a card on both meshes, and what the
    sharded engine and ``Workload.build_engine`` do with ``step_graph`` on
    the CPU, the self-check's handling of the runner's graph setting
    included."""
    torch.set_num_threads(1)
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import FastCacheConfig
    from repro_torch.core import step_graph
    from repro_torch.core.runner import CachedDiT
    from repro_torch.distributed.sharding import (ShardingCtx, make_rules,
                                                  use_sharding)
    from repro_torch.launch.mesh import init_ranks, make_serving_mesh
    from repro_torch.launch.serve_diffusion import Workload
    from repro_torch.models.dit import DiTModel
    from repro_torch.serving.sharded_engine import ShardedDiffusionEngine
    init_ranks(rank, world, port=port, backend="gloo")
    meshes = {(2, 1): make_serving_mesh(2, 1),
              (1, 2): make_serving_mesh(1, 2)}
    ctxs = {t: ShardingCtx(m, make_rules("serve")) for t, m in meshes.items()}
    out = {"agreed": {}, "refusal": {}, "default": {}, "explicit": {},
           "build_engine": {}}
    for topo, ctx in ctxs.items():
        masks = [torch.tensor(m) for m in AGREE_MASKS[rank]]
        with use_sharding(ctx=ctx), _NoHostReads():
            got = [step_graph.agreed_mask(m) for m in masks]
        out["agreed"][topo] = [(tuple(g.shape), str(g.dtype), g.tolist(),
                                g is m or g.data_ptr() == m.data_ptr())
                               for g, m in zip(got, masks)]
        out["refusal"][topo] = {
            dev: step_graph.capture_refusal(ctx, torch.device(dev))
            for dev in ("cpu", "cuda")}
    wl = Workload(reduced=True, slots=4, steps=4)

    def model():
        # f32: the self-check's atol 1e-2 is an f32 tolerance
        cfg = get_reduced(wl.arch).replace(dtype="float32")
        return DiTModel(cfg, device="cpu").init(
            torch.Generator().manual_seed(wl.seed))
    checks = []
    real = ShardedDiffusionEngine._verify_step_numerics

    def on_card_flag(self, **kw):
        # the runner's setting as the card's default leaves it
        self.runner._step_graph = True
        captures = self.runner.graphs.captures
        real(self, **kw)
        checks.append({"after": self.runner._step_graph,
                       "captures": self.runner.graphs.captures - captures,
                       "graphs": len(self.runner.graphs.graphs)})
        self.runner._step_graph = False
    ShardedDiffusionEngine._verify_step_numerics = on_card_flag
    try:
        for topo, mesh in meshes.items():
            runner, eng = wl.build_engine(model(), mesh=mesh)
            out["default"][topo] = runner.step_graph
            try:
                dataclasses.replace(wl, step_graph=True).build_engine(
                    model(), mesh=mesh)
                out["build_engine"][topo] = None
            except ValueError as e:
                out["build_engine"][topo] = str(e)
            try:
                ShardedDiffusionEngine(
                    CachedDiT(model(), FastCacheConfig()),
                    mesh=mesh, max_slots=4, num_steps=4, step_graph=True)
                out["explicit"][topo] = None
            except ValueError as e:
                out["explicit"][topo] = str(e)
    finally:
        ShardedDiffusionEngine._verify_step_numerics = real
    out["self_check"] = checks
    dist.destroy_process_group()
    return out
