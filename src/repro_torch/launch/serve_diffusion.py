"""Diffusion serving launcher for the port: continuous-batching DiT
sampling with per-slot FastCache state on one CUDA card.

    PYTHONPATH=src python -m repro_torch.launch.serve_diffusion \\
        --arch dit-xl2 --requests 8 --slots 4 --steps 50 --rate 0.5 --json

Weights are random (``torch.Generator`` seeded from ``--seed``, un-zeroed
as in ``DiTModel.init``).  After an untimed warm-up on a fresh engine,
prints p50/p95 request latency in engine steps, engine steps per second of
wall time, the block cache ratio, the steps reused and the host syncs per
model step.  ``--policy`` takes every registered cache policy (nocache,
fora, teacache, adacache, fbcache, l2c, fastcache, smoothcache; l2c with
its default empty mask).  ``--token-merge-ratio 0.5`` turns on
token compression (windows of ``--token-merge-window`` tokens merged to
half); 1.0, the default, leaves it off.  ``--no-cfg`` serves on the static
no-CFG fast path (guidance 1.0 only).  ``--device cpu --reduced`` runs
the plain PyTorch path on a toy model.

SLO control plane (``serving/slo/``), the reference's flags:
``--priority-mix 0,1,1,2`` and ``--deadline-slack-mix 80,120,200`` draw
per-request priority classes and deadlines (engine steps past arrival);
``--burst-rate 2.0 --burst-start 5 --burst-len 20`` makes the arrivals calm
-> burst -> calm; ``--sched edf`` orders each class by deadline.  ``--slo``
serves through ``SLOScheduler``: strict-priority queues, deadline-aware
admission (``--on-miss reject|defer``), priority preemption with a
device-side snapshot and bitwise resume (``--no-preempt`` turns it off)
and, with ``--shed``, the degradation controller's default ladder
(``--shed-high`` / ``--shed-low`` watermarks of ready-queue depth).  The
summary gains a per-class block (latency, queue wait, deadlines met and
missed, preemptions, rejection reasons) and an ``slo`` block.  On the CPU:
``--device cpu --reduced --slo --sched edf --priority-mix 0,1,1,2
--deadline-slack-mix 8,14,30 --burst-rate 2 --burst-start 4 --burst-len 8
--shed --shed-high 4 --shed-low 1``.

Observability, the reference's flags: ``--metrics-out`` (Prometheus text)
and ``--metrics-jsonl`` (JSONL windows, one every ``--metrics-window``
engine steps and one at the end), ``--trace-out`` (Chrome/Perfetto trace
JSON), ``--audit-fraction`` / ``--audit-seed`` (the shadow-compute audit
plane's schedule), ``--audit-baseline`` (a calibration ``.npz`` arming the
drift gauge) and ``--audit-out`` (the per-request error budgets).

The reference's workload and mesh flags: ``--steps-mix 20,50`` /
``--guidance-mix 1.0,4.0`` draw each request's plan (DDIM step budget,
guidance scale) from a mix, one engine batch serving them side by side
(the plan tables sized to the largest budget); ``--lockstep`` admits a new
wave only once every slot is free (the fixed-wave baseline).  ``--mesh
data,model`` serves through ``ShardedDiffusionEngine`` (slots over
``data``, DiT weights tensor-parallel over ``model``) on ``data * model``
ranks that the launcher starts itself, one process each, printing from
rank 0 only; ``--sync-admission`` fetches each completion at once instead
of once at run end.  On the card the ranks use ``nccl`` with a card each,
and ``gloo`` when they share fewer cards; on the CPU ``gloo``:

    PYTHONPATH=src python -m repro_torch.launch.serve_diffusion \\
        --mesh 2,1 --reduced --device cpu --requests 4 --slots 2 \\
        --steps 6 --json

``Workload`` is the one definition of the served configuration: its
defaults are the flags' defaults, and ``chip_smoke.py`` and
``launch/profile_serve.py`` build their serve from it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.configs import DIT_IDS, get_config, get_reduced
from repro_torch.configs.base import FastCacheConfig
from repro_torch.core.policies.base import registered_policies
from repro_torch.core.runner import CachedDiT
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import mesh_backend
from repro_torch.models.dit import DiTModel
from repro_torch.obs import audit as obs_audit
from repro_torch.obs.calibration import load_calibration
from repro_torch.obs.metrics import MetricsCollector
from repro_torch.obs.tracing import TraceRecorder, validate_trace
from repro_torch.serving.diffusion_engine import DiffusionServingEngine
from repro_torch.serving.scheduler import (SCHED_POLICIES, DiffusionRequest,
                                           percentile, piecewise_rate,
                                           poisson_trace, summarize_by_class,
                                           summarize_by_steps)
from repro_torch.serving.sharded_engine import ShardedDiffusionEngine
from repro_torch.serving.slo import (AdmissionController,
                                     DegradationController, SLOScheduler)


@dataclass(frozen=True)
class Workload:
    """A serve: the model, the cache policy, the engine and the traffic."""
    arch: str = "dit-xl2"
    reduced: bool = False
    policy: str = "fastcache"
    slots: int = 4
    steps: int = 50                 # DDIM steps per request (default plan)
    guidance: float = 4.0
    # each request draws its own plan from these (empty: the defaults)
    steps_mix: Tuple[int, ...] = ()
    guidance_mix: Tuple[float, ...] = ()
    lockstep: bool = False          # admit a wave only when all slots free
    requests: int = 8
    rate: float = 0.5               # Poisson arrivals per engine step
    seed: int = 0                   # weights and arrivals
    merge_ratio: float = 1.0        # token compression: kept share, 1 = off
    merge_window: int = 16          # token compression window w
    cfg_rows: bool = True           # False: the no-CFG fast path (g = 1)
    audit_fraction: float = 0.0     # shadow-audited share of serve steps
    audit_seed: int = 0
    # traffic for the SLO plane: classes and deadline slacks drawn per
    # request (empty: all class 0, no deadlines), a burst of burst_rate
    # over [burst_start, burst_start + burst_len) (0: no burst), and the
    # order within a class
    sched: str = "fifo"
    priority_mix: Tuple[int, ...] = ()
    deadline_slack_mix: Tuple[int, ...] = ()
    burst_rate: float = 0.0
    burst_start: int = 0
    burst_len: int = 0
    # the SLO plane itself (SLOScheduler) and its knobs
    slo: bool = False
    on_miss: str = "reject"
    preempt: bool = True
    shed: bool = False
    shed_high: int = 8
    shed_low: int = 2
    # the policy's own constructor knobs (e.g. l2c_mask, smooth_schedule),
    # passed through CachedDiT; no flag sets them
    policy_kwargs: Mapping[str, Any] = dataclasses.field(
        default_factory=dict)

    def build_model(self, device) -> DiTModel:
        cfg = get_reduced(self.arch) if self.reduced else get_config(self.arch)
        dev = resolve_device(device)
        return DiTModel(cfg, device=dev).init(
            torch.Generator(dev).manual_seed(self.seed))

    @property
    def max_steps(self) -> int:
        """The plan tables' width: the largest step budget served."""
        return max(self.steps_mix + (self.steps,))

    def build_engine(self, model: DiTModel, *,
                     collector: Optional[MetricsCollector] = None,
                     tracer: Optional[TraceRecorder] = None,
                     enable_metrics: bool = True, mesh=None,
                     async_admission: bool = True,
                     numerics_check: Optional[bool] = None, **runner_kwargs
                     ) -> Tuple[CachedDiT, DiffusionServingEngine]:
        """The runner and a fresh engine; ``runner_kwargs`` go to
        ``CachedDiT`` (e.g. ``fc_params`` of ``calibrate_dit``).  With a
        ``mesh`` (``launch.mesh.make_serving_mesh``), the engine is a
        ``ShardedDiffusionEngine`` on it (its numerics self-check as
        ``numerics_check`` says), which cuts ``model`` in place."""
        fc = FastCacheConfig(merge_enabled=self.merge_ratio < 1.0,
                             merge_ratio=self.merge_ratio,
                             merge_window=self.merge_window)
        runner = CachedDiT(model, fc, policy=self.policy,
                           **self.policy_kwargs, **runner_kwargs)
        kw = dict(max_slots=self.slots, num_steps=self.steps,
                  guidance_scale=self.guidance, max_steps=self.max_steps,
                  cfg_rows=self.cfg_rows, collector=collector,
                  tracer=tracer, enable_metrics=enable_metrics,
                  audit_fraction=self.audit_fraction,
                  audit_seed=self.audit_seed)
        if mesh is None:
            return runner, DiffusionServingEngine(runner, **kw)
        return runner, ShardedDiffusionEngine(
            runner, mesh=mesh, async_admission=async_admission,
            numerics_check=numerics_check, **kw)

    def rate_fn(self) -> Optional[Callable[[float], float]]:
        """The calm -> burst -> calm arrival rate, or None (constant)."""
        if self.burst_len <= 0:
            return None
        if self.burst_rate <= 0.0:
            raise ValueError("burst_len > 0 needs burst_rate > 0")
        return piecewise_rate([(self.burst_start, self.rate),
                               (self.burst_start + self.burst_len,
                                self.burst_rate), (10 ** 9, self.rate)])

    def build_trace(self, model: DiTModel) -> List[DiffusionRequest]:
        return poisson_trace(self.requests, self.rate, seed=self.seed,
                             num_classes=model.cfg.dit.num_classes,
                             steps_mix=self.steps_mix or None,
                             guidance_mix=self.guidance_mix or None,
                             rate_fn=self.rate_fn(),
                             priority_mix=self.priority_mix or None,
                             deadline_slack_mix=(self.deadline_slack_mix
                                                 or None))

    def build_slo(self, eng: DiffusionServingEngine,
                  collector: Optional[MetricsCollector] = None
                  ) -> SLOScheduler:
        """The SLO plane over ``eng``: deadline-aware admission, the shed
        ladder when ``shed``, preemption unless ``preempt`` is off."""
        admission = AdmissionController(eng, on_miss=self.on_miss,
                                        collector=collector)
        controller = DegradationController(
            high_watermark=self.shed_high, low_watermark=self.shed_low,
            collector=collector) if self.shed else None
        return SLOScheduler(eng, sched_policy=self.sched,
                            admission=admission, controller=controller,
                            preempt=self.preempt, collector=collector)

    def warm_up(self, model: DiTModel
                ) -> Tuple[CachedDiT, DiffusionServingEngine]:
        """Serve two 3-step requests on a fresh engine, so that the first
        calls of the math libraries and of the kernels (their build
        included) land here and not in a timed run.  Its steps take both
        the cold and the gated branch.  Returns the runner and engine it
        used."""
        short = dataclasses.replace(self, requests=2, steps=3, steps_mix=(),
                                    guidance_mix=())
        runner, eng = short.build_engine(model)
        eng.run(short.build_trace(model))
        return runner, eng


def serve(args: argparse.Namespace, *, device=None, mesh=None) -> Dict:
    """One serve of the flags' workload on ``device`` (``args.device`` by
    default), through the sharded engine on ``mesh`` when one is given."""
    wl = Workload(**{f.name: getattr(args, f.name)
                     for f in dataclasses.fields(Workload)
                     if hasattr(args, f.name)})
    model = wl.build_model(device or args.device)
    dev = model.device
    wl.warm_up(model)
    # the audit plane folds into the device metrics, so auditing implies
    # the metrics plane and a collector to harvest drift / burn
    want_metrics = bool(args.metrics_out or args.metrics_jsonl
                        or wl.audit_fraction > 0.0)
    collector = MetricsCollector(
        labels={"policy": wl.policy, "arch": wl.arch},
        window_steps=args.metrics_window or None) if want_metrics else None
    if collector is not None and args.audit_baseline:
        calib = load_calibration(args.audit_baseline)
        collector.set_audit_context(baseline=calib["errors_mean"])
    tracer = TraceRecorder() if args.trace_out else None
    runner, eng = wl.build_engine(model, collector=collector, tracer=tracer,
                                  mesh=mesh,
                                  async_admission=not args.sync_admission)
    trace = wl.build_trace(model)
    slo = wl.build_slo(eng, collector) if wl.slo else None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    done = (slo.run(trace) if slo is not None
            else eng.run(trace, lockstep=wl.lockstep, sched_policy=wl.sched))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    rejected = slo.rejected if slo is not None else []
    lats = [r.latency_steps for r in done]
    stats = eng.cache_stats()
    summary = {
        "arch": model.cfg.name, "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "policy": wl.policy, "slots": wl.slots,
        "requests": len(trace), "finished": len(done),
        "engine_steps": eng.clock, "model_steps": eng.model_steps,
        "wall_s": wall, "engine_steps_per_s": eng.clock / wall,
        "latency_steps_p50": percentile(lats, 50),
        "latency_steps_p95": percentile(lats, 95),
        "block_cache_ratio": stats["block_cache_ratio"],
        "steps_reused": stats["steps_reused"],
        "host_syncs_per_model_step": ((runner.impl.host_syncs
                                       + eng.host_syncs) / eng.model_steps),
        "blocks_skipped": stats["blocks_skipped"],
        "blocks_computed": stats["blocks_computed"],
        "token_merge": {"ratio": wl.merge_ratio, "window": wl.merge_window,
                        "active": runner.reducer is not None},
        "mode": "lockstep" if wl.lockstep else "continuous",
        "topology": (eng.topology() if mesh is not None
                     else {"data": 1, "model": 1, "devices": 1}),
        "async_admission": mesh is not None and not args.sync_admission,
        "steps_mix": list(wl.steps_mix) or [wl.steps],
        "guidance_mix": list(wl.guidance_mix) or [wl.guidance],
        "cfg_rows": wl.cfg_rows,
        "sched_policy": wl.sched,
        "latency_by_steps": summarize_by_steps(done + rejected),
        "by_class": summarize_by_class(done + rejected),
    }
    if slo is not None:
        met = sum(1 for r in done if r.deadline_step is None
                  or r.finish_step <= r.deadline_step)
        ctl = slo.controller
        slo.timer.poll()
        summary["slo"] = {
            "on_miss": wl.on_miss, "preempt": wl.preempt, "shed": wl.shed,
            "shed_level": ctl.level.name if ctl is not None else None,
            "rejected": len(rejected), "deadline_met": met,
            "goodput": met / len(trace) if trace else 0.0,
            "preemptions": sum(r.preemptions for r in done),
            "model_step_ms_ema": slo.admission.predictor.model_step_ms,
            "step_ms_mean": (slo.timer.total_ms / slo.timer.count
                             if slo.timer.count else None),
        }
    if collector is not None:
        collector.set_gauge("run_wall_seconds", wall)
        if args.metrics_out:
            with open(args.metrics_out, "w") as f:
                f.write(collector.to_prometheus())
        if args.metrics_jsonl:
            with open(args.metrics_jsonl, "w") as f:
                f.write(collector.to_jsonl())
    if wl.audit_fraction > 0.0:
        report = obs_audit.audit_report(done, fraction=wl.audit_fraction,
                                        bound=runner.audit_bound(),
                                        collector=collector)
        summary["audit"] = {k: report[k] for k in
                            ("audit_fraction", "predicted_bound",
                             "violations_total")}
        if args.audit_out:
            with open(args.audit_out, "w") as f:
                json.dump(report, f, indent=2)
    if tracer is not None:
        doc = tracer.to_json()
        validate_trace(doc)
        with open(args.trace_out, "w") as f:
            json.dump(doc, f)
    return summary


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=Workload.arch, choices=DIT_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=Workload.requests)
    ap.add_argument("--slots", type=int, default=Workload.slots)
    ap.add_argument("--steps", type=int, default=Workload.steps)
    ap.add_argument("--guidance", type=float, default=Workload.guidance)
    ap.add_argument("--policy", default=Workload.policy,
                    choices=registered_policies())
    ap.add_argument("--rate", type=float, default=Workload.rate,
                    help="Poisson arrival rate, requests per engine step")
    ap.add_argument("--seed", type=int, default=Workload.seed)
    ap.add_argument("--steps-mix", type=_int_list, default=(),
                    help="comma list of DDIM step budgets; each request "
                         "draws its own (e.g. 20,50)")
    ap.add_argument("--guidance-mix", type=_float_list, default=(),
                    help="comma list of guidance scales; each request "
                         "draws its own (e.g. 1.0,4.0)")
    ap.add_argument("--lockstep", action="store_true",
                    help="fixed-wave baseline instead of continuous "
                         "admission")
    ap.add_argument("--mesh", type=_mesh, default=None,
                    help="serve sharded on a 'data,model' mesh of ranks "
                         "(e.g. 2,1) that the launcher starts; empty = the "
                         "single-device engine")
    ap.add_argument("--sync-admission", action="store_true",
                    help="sharded engine only: fetch each completion at "
                         "once instead of once at run end")
    add_slo_args(ap)
    add_merge_args(ap)
    ap.add_argument("--no-cfg", dest="cfg_rows", action="store_false",
                    help="static no-CFG fast path for guidance==1.0-only "
                         "deployments: single-row slots, no materialized "
                         "uncond half (model batch S instead of 2S); "
                         "requires --guidance 1.0")
    ap.add_argument("--metrics-out", default="",
                    help="write the Prometheus text exposition here at "
                         "run end")
    ap.add_argument("--metrics-jsonl", default="",
                    help="write the per-window JSONL metrics trajectory "
                         "here at run end")
    ap.add_argument("--metrics-window", type=int, default=0,
                    help="harvest a metrics window every N engine steps "
                         "(each window close is one device read); 0 = one "
                         "window at run end only")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome/Perfetto trace JSON of the run "
                         "here (per-request spans, per-slot denoise "
                         "slices with cache decisions)")
    ap.add_argument("--audit-fraction", type=float,
                    default=Workload.audit_fraction,
                    help="shadow-audit this fraction of serve steps "
                         "(deterministic seeded schedule; 0 disables the "
                         "audit plane)")
    ap.add_argument("--audit-seed", type=int, default=Workload.audit_seed,
                    help="seed for the audit sampling schedule")
    ap.add_argument("--audit-baseline", default="",
                    help="calibration .npz (launch.calibrate) to arm the "
                         "audit_drift_ratio gauge: measured per-layer "
                         "cache error vs the nocache run's natural "
                         "inter-step deltas")
    ap.add_argument("--audit-out", default="",
                    help="write the audit report JSON (per-request error "
                         "budgets, windowed drift/burn summary) here at "
                         "run end")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", action="store_true")
    args = check_merge_args(ap.parse_args(argv))
    if args.audit_out and args.audit_fraction <= 0.0:
        raise SystemExit("--audit-out needs --audit-fraction > 0")
    if not args.cfg_rows and (args.guidance != 1.0
                              or any(g != 1.0 for g in args.guidance_mix)):
        raise SystemExit("--no-cfg serves guidance==1.0 only; pass "
                         "--guidance 1.0 and an all-1.0 --guidance-mix")
    if args.slo and args.lockstep:
        raise SystemExit("--slo drives continuous admission; drop "
                         "--lockstep")
    if args.burst_len > 0 and args.burst_rate <= 0.0:
        raise SystemExit("--burst-len needs --burst-rate > 0")
    return args


def _int_list(text: str) -> Tuple[int, ...]:
    return tuple(int(v) for v in text.split(",") if v.strip())


def _float_list(text: str) -> Tuple[float, ...]:
    return tuple(float(v) for v in text.split(",") if v.strip())


def _mesh(text: str) -> Optional[Tuple[int, int]]:
    """'data,model' (e.g. '2,1') -> (data, model); '' -> None."""
    if not text:
        return None
    try:
        data, model = (int(v) for v in text.split(","))
    except ValueError:
        raise SystemExit(f"--mesh expects 'data,model' ints, got {text!r}")
    return data, model


def add_slo_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--sched", default=Workload.sched, choices=SCHED_POLICIES,
                    help="admission order among arrived requests within a "
                         "priority class: FIFO, shortest-job-first, or "
                         "earliest-deadline-first")
    ap.add_argument("--priority-mix", type=_int_list, default=(),
                    help="comma list of priority classes requests draw "
                         "from uniformly (0 = most critical; empty = all "
                         "class 0)")
    ap.add_argument("--deadline-slack-mix", type=_int_list, default=(),
                    help="comma list of deadline slacks (engine steps "
                         "past arrival) requests draw from uniformly "
                         "(empty = no deadlines)")
    ap.add_argument("--burst-rate", type=float, default=Workload.burst_rate,
                    help="burst arrival rate; with --burst-len > 0 the "
                         "trace is calm (--rate) -> burst -> calm")
    ap.add_argument("--burst-start", type=int, default=Workload.burst_start,
                    help="engine step the burst begins at")
    ap.add_argument("--burst-len", type=int, default=Workload.burst_len,
                    help="burst duration in engine steps (0 = no burst)")
    ap.add_argument("--slo", action="store_true",
                    help="serve through the SLO control plane "
                         "(SLOScheduler): strict-priority queues, "
                         "deadline-aware admission, priority preemption "
                         "with device-side snapshot/resume")
    ap.add_argument("--on-miss", default=Workload.on_miss,
                    choices=("reject", "defer"),
                    help="--slo: what deadline-aware admission does with "
                         "a request predicted to miss: reject it, or "
                         "defer and re-test later")
    ap.add_argument("--no-preempt", dest="preempt", action="store_false",
                    help="--slo: disable priority preemption")
    ap.add_argument("--shed", action="store_true",
                    help="--slo: enable the degradation controller "
                         "(default shed-level ladder, watermark "
                         "hysteresis on ready-queue depth)")
    ap.add_argument("--shed-high", type=int, default=Workload.shed_high,
                    help="--shed: queue depth escalating one shed level "
                         "when sustained")
    ap.add_argument("--shed-low", type=int, default=Workload.shed_low,
                    help="--shed: queue depth de-escalating one shed "
                         "level when sustained")


def add_merge_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--token-merge-ratio", dest="merge_ratio", type=float,
                    default=Workload.merge_ratio,
                    help="serving-path token compression: keep "
                         "ceil(ratio * window) cluster centers per window "
                         "of tokens before the cache policy runs "
                         "(core/token_reduce.py); 1.0 disables the stage "
                         "(bitwise-identical to merge-off)")
    ap.add_argument("--token-merge-window", dest="merge_window", type=int,
                    default=Workload.merge_window,
                    help="token-compression window size w; the DiT token "
                         "count must be divisible by it")


def check_merge_args(args: argparse.Namespace) -> argparse.Namespace:
    if not 0.0 < args.merge_ratio <= 1.0:
        raise SystemExit(f"--token-merge-ratio must be in (0, 1], got "
                         f"{args.merge_ratio}")
    return args


# the kernels a DiT serve launches, built once before ranks start (two
# ranks building into build/kernels at first use would race each other)
SERVE_KERNELS = ("fused_gate", "linear_blend", "saliency_delta",
                 "knn_density", "token_merge")
MESH_TIMEOUT_S = 3600.0    # every rank of a --mesh serve, start to summary


def _mesh_rank(rank: int, world: int, port: int, backend: str,
               devices: List[str], args: argparse.Namespace
               ) -> Optional[Dict]:
    """One rank of ``serve_mesh``: its summary on rank 0, else None."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_ranks, make_serving_mesh
    _numerics()
    if devices[rank].startswith("cuda"):
        torch.cuda.set_device(torch.device(devices[rank]))
    init_ranks(rank, world, port=port, backend=backend)
    summary = serve(args, device=devices[rank],
                    mesh=make_serving_mesh(*args.mesh))
    dist.destroy_process_group()
    return summary if rank == 0 else None


def serve_mesh(args: argparse.Namespace, *,
               timeout: float = MESH_TIMEOUT_S) -> Dict:
    """Start ``data * model`` ranks, serve on each, return rank 0's
    summary; a rank's failure, or no summary within ``timeout`` seconds,
    raises with its traceback."""
    from repro_torch.launch.mesh import run_ranks
    world = args.mesh[0] * args.mesh[1]
    backend, devices = mesh_backend(args.device, world)
    if devices[0].startswith("cuda"):
        from concurrent.futures import ThreadPoolExecutor
        from repro_torch.cuda_kernels import build
        with ThreadPoolExecutor(len(SERVE_KERNELS)) as pool:
            list(pool.map(build.load_library, SERVE_KERNELS))
    return run_ranks(_mesh_rank, world, (backend, devices, args),
                     timeout=timeout, label="serve_diffusion")[0]


def _numerics() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def main(argv=None) -> None:
    _numerics()
    args = parse_args(argv)
    summary = serve_mesh(args) if args.mesh else serve(args)
    if args.json:
        print(json.dumps(summary))
    else:
        for k, v in summary.items():
            print(f"{k:>20}: {v}")


if __name__ == "__main__":
    main()
