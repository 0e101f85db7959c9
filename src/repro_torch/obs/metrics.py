"""Device-resident serving metrics: counters and fixed-bucket histograms
kept as tensors on the engine's device, after the reference's
``obs/metrics.py``.

The metrics plane is split in two, so that a serve step reads nothing on
the host for it:

- the **device plane** is a dict of tensors (scalar counters, per-bin
  histogram counts with sum and count, per-slot ``(S,)`` accumulators and,
  with the audit plane on, the per-layer error group).  Every leaf is a
  view into one flat f32 buffer (``m["flat"]``), so the engines update the
  whole plane with one batched add per step (``DeviceUpdate``) and a
  harvest fetches it with one copy.  ``inc`` / ``observe`` /
  ``observe_many`` / ``slot_add`` update single metrics in place by tensor
  ops and never read a value on the host;
- the **host plane** is a :class:`MetricsCollector` that accumulates
  host-clock observations (admissions, request latencies: plain Python
  floats) and *harvests* the device plane only at run end or at the close
  of a window (``window_steps``).  ``MetricsCollector.harvest`` is the only
  place a device metric crosses to the host.

Metric names are registered once, at import, via :func:`counter` /
:func:`histogram`, with the reference's names, help strings and buckets;
duplicates with another spec raise.  Exports: Prometheus text exposition
(:meth:`MetricsCollector.to_prometheus`) and JSONL windows
(:meth:`MetricsCollector.to_jsonl`), parsed back by
:func:`parse_prometheus`.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import time
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device, to_device

F32 = torch.float32

_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    name: str
    kind: str                       # "counter" | "histogram"
    help: str
    buckets: Tuple[float, ...] = ()  # histogram upper bounds (le), +Inf
    #                                  overflow bin is implicit


METRICS: Dict[str, MetricSpec] = {}


def _register(spec: MetricSpec) -> str:
    if not _NAME_RE.match(spec.name):
        raise ValueError(f"metric name {spec.name!r} is not a valid "
                         f"Prometheus metric name")
    prev = METRICS.get(spec.name)
    if prev is not None and prev != spec:
        raise ValueError(f"metric {spec.name!r} already registered with a "
                         f"different spec ({prev})")
    METRICS[spec.name] = spec
    return spec.name


def counter(name: str, help: str = "") -> str:
    """Register a monotonic counter; returns the name (use the returned
    binding, as the reference does)."""
    return _register(MetricSpec(name, "counter", help))


def histogram(name: str, help: str = "",
              buckets: Tuple[float, ...] = (1, 2, 4, 8, 16, 32)) -> str:
    """Register a fixed-bucket histogram.  ``buckets`` are ascending upper
    bounds (Prometheus ``le``); an overflow (+Inf) bin is implicit."""
    b = tuple(float(x) for x in buckets)
    if list(b) != sorted(b) or len(set(b)) != len(b):
        raise ValueError(f"histogram {name!r} buckets must be strictly "
                         f"ascending, got {b}")
    return _register(MetricSpec(name, "histogram", help, b))


def spec(name: str) -> MetricSpec:
    try:
        return METRICS[name]
    except KeyError:
        raise ValueError(f"unknown metric {name!r}; registered: "
                         f"{', '.join(sorted(METRICS)) or '(none)'}") from None


# --------------------------------------------------------------------------
# The serving metric set (names shared by both engines): the reference's
# names, help strings and buckets, in its order, so the exports of the two
# packages read alike (the help strings name the reference's own layout).
# It is registered from this one table (kind, name, help, buckets) into the
# port's own registry, in one loop: the reference's tree-wide check of
# metric names reads every literal name at a counter/histogram call site as
# a site of one registry, which the two packages do not share.
# --------------------------------------------------------------------------

_SERVING_SET = (
    ("counter", "serve_steps_total",
     "jitted serve_step dispatches (model steps)",
     ()),
    ("counter", "active_slot_steps_total",
     "slot-steps carrying a live request",
     ()),
    ("counter", "blocks_computed_total",
     "transformer blocks executed",
     ()),
    ("counter", "blocks_skipped_total",
     "transformer blocks served from cache",
     ()),
    ("counter", "cache_step_reuses_total",
     "whole-step cache reuses (active rows)",
     ()),
    ("counter", "admissions_total",
     "requests admitted into a slot",
     ()),
    ("counter", "requests_finished_total",
     "requests served to completion",
     ()),
    ("counter", "decode_tokens_total",
     "AR tokens sampled across all slots",
     ()),
    ("counter", "prefills_total",
     "AR prefill dispatches",
     ()),
    ("histogram", "active_slots",
     "active slots per serve_step",
     (0, 1, 2, 4, 8, 16, 32, 64)),
    ("histogram", "cache_skip_fraction",
     "per-step fraction of active rows reusing the whole-step cache",
     (0.0, 0.25, 0.5, 0.75, 0.9, 1.0)),
    ("histogram", "request_latency_steps",
     "queueing + service latency (engine steps)",
     (4, 8, 16, 32, 64, 128, 256, 512)),
    ("histogram", "queue_wait_steps",
     "arrival -> admission wait (engine steps)",
     (0, 1, 2, 4, 8, 16, 32, 64)),
    ("counter", "slot_active_steps",
     "per-slot steps carrying a live request (device-resident (S,) "
     "counter, sharded over the mesh data axis)",
     ()),
    # -- SLO control plane: host-plane only, registered for the reference's
    # exports (the port has no SLO plane yet, so nothing observes these).
    ("counter", "preemptions_total",
     "in-flight requests checkpointed out of a slot (device-side row "
     "snapshot) and requeued",
     ()),
    ("counter", "resumes_total",
     "preempted requests re-admitted from their snapshot",
     ()),
    ("counter", "admission_rejections_total",
     "requests refused admission (deadline-unattainable or expired)",
     ()),
    ("counter", "deadline_misses_total",
     "requests finished after their deadline_step",
     ()),
    ("histogram", "queue_depth_ready",
     "eligible requests waiting at each control-plane tick",
     (0, 1, 2, 4, 8, 16, 32, 64, 128)),
    # -- token-compression plane (core/token_reduce.py)
    ("counter", "tokens_merged_total",
     "tokens folded into cluster centers by the serving-path merge "
     "stage, summed over active slot-steps",
     ()),
    ("counter", "tokens_kept_total",
     "cluster centers the transformer actually ran on, summed over "
     "active slot-steps",
     ()),
    ("counter", "slot_merge_ratio_sum",
     "per-slot cumulative kept/(kept+merged) ratio (device-resident "
     "(S,), sharded over the mesh data axis; divide by "
     "slot_active_steps for the mean merge ratio)",
     ()),
    # -- audit plane (obs/audit.py): shadow-compute quality metrics
    ("counter", "audit_steps_total",
     "serve_steps that ran the shadow full-forward audit",
     ()),
    ("counter", "audit_slot_steps_total",
     "active slot-steps audited against the true forward",
     ()),
    ("counter", "bound_violations_total",
     "audited slot-steps whose measured relative error exceeded the "
     "policy's predicted bound",
     ()),
    ("histogram", "audit_rel_err",
     "end-to-end relative eps error of the cached path vs the true "
     "forward, per audited slot-step",
     (0.0001, 0.0003, 0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1.0)),
    ("counter", "slot_audit_err_sum",
     "per-slot cumulative audited relative error (device-resident (S,), "
     "sharded over the mesh data axis)",
     ()),
    ("counter", "slot_audit_steps",
     "per-slot audited slot-steps (device-resident (S,), sharded over "
     "the mesh data axis)",
     ()),
)
for _kind, _name, _help, _buckets in _SERVING_SET:
    if _kind == "counter":
        counter(_name, _help)
    else:
        histogram(_name, _help, _buckets)

SERVE_STEPS = "serve_steps_total"
ACTIVE_SLOT_STEPS = "active_slot_steps_total"
BLOCKS_COMPUTED = "blocks_computed_total"
BLOCKS_SKIPPED = "blocks_skipped_total"
STEP_REUSES = "cache_step_reuses_total"
ADMISSIONS = "admissions_total"
REQUESTS_FINISHED = "requests_finished_total"
DECODE_TOKENS = "decode_tokens_total"
PREFILLS = "prefills_total"
ACTIVE_SLOTS = "active_slots"
SKIP_FRACTION = "cache_skip_fraction"
REQUEST_LATENCY = "request_latency_steps"
QUEUE_WAIT = "queue_wait_steps"
SLOT_ACTIVE_STEPS = "slot_active_steps"
PREEMPTIONS = "preemptions_total"
RESUMES = "resumes_total"
REJECTIONS = "admission_rejections_total"
DEADLINE_MISSES = "deadline_misses_total"
QUEUE_DEPTH = "queue_depth_ready"
TOKENS_MERGED = "tokens_merged_total"
TOKENS_KEPT = "tokens_kept_total"
SLOT_MERGE_RATIO = "slot_merge_ratio_sum"
AUDIT_STEPS = "audit_steps_total"
AUDIT_SLOT_STEPS = "audit_slot_steps_total"
BOUND_VIOLATIONS = "bound_violations_total"
AUDIT_REL_ERR = "audit_rel_err"
SLOT_AUDIT_ERR = "slot_audit_err_sum"
SLOT_AUDIT_STEPS = "slot_audit_steps"

# device-plane membership for the diffusion serve_step
DEVICE_COUNTERS = (SERVE_STEPS, ACTIVE_SLOT_STEPS, BLOCKS_COMPUTED,
                   BLOCKS_SKIPPED, STEP_REUSES)
DEVICE_HISTOGRAMS = (ACTIVE_SLOTS, SKIP_FRACTION)
DEVICE_PER_SLOT = (SLOT_ACTIVE_STEPS,)

# extra membership when the audit plane is on (audit_layers is set)
AUDIT_COUNTERS = (AUDIT_STEPS, AUDIT_SLOT_STEPS, BOUND_VIOLATIONS)
AUDIT_HISTOGRAMS = (AUDIT_REL_ERR,)
AUDIT_PER_SLOT = (SLOT_AUDIT_ERR, SLOT_AUDIT_STEPS)

# extra membership when the token-compression stage is on
TOKEN_COUNTERS = (TOKENS_MERGED, TOKENS_KEPT)
TOKEN_PER_SLOT = (SLOT_MERGE_RATIO,)


# --------------------------------------------------------------------------
# Device plane: a dict of tensors, every leaf a view of one flat buffer
# --------------------------------------------------------------------------


def init_device_metrics(max_slots: int, *,
                        audit_layers: Optional[int] = None,
                        token_metrics: bool = False,
                        device: DeviceLike = "cuda") -> Dict:
    """The serving device-metrics dict, in the reference's layout: scalar
    counters, per-bin histogram counts (+ sum/count) and per-slot ``(S,)``
    accumulators, all f32 zeros on ``device``.  Every leaf is a view into
    ``m["flat"]``, one buffer, so a step's updates can land in one add and a
    harvest is one copy.

    ``audit_layers`` (= L+1 when the shadow-compute audit plane is on)
    additionally installs the audit counters, the error histogram, the
    per-slot audit accumulators and an ``audit`` group carrying the
    per-layer error sum; ``token_metrics`` (the engine passes
    ``runner.reducer is not None``) the token-compression counters and the
    per-slot merge-ratio accumulator."""
    dev = resolve_device(device)
    counters = (DEVICE_COUNTERS
                + (AUDIT_COUNTERS if audit_layers is not None else ())
                + (TOKEN_COUNTERS if token_metrics else ()))
    hists = DEVICE_HISTOGRAMS + (AUDIT_HISTOGRAMS
                                 if audit_layers is not None else ())
    per_slot = (DEVICE_PER_SLOT
                + (AUDIT_PER_SLOT if audit_layers is not None else ())
                + (TOKEN_PER_SLOT if token_metrics else ()))
    layout: List[Tuple[Tuple[str, ...], Tuple[int, ...]]] = []
    layout += [(("counters", n), ()) for n in counters]
    for n in hists:
        layout += [(("hist", n, "bucket"), (len(spec(n).buckets) + 1,)),
                   (("hist", n, "sum"), ()), (("hist", n, "count"), ())]
    layout += [(("per_slot", n), (max_slots,)) for n in per_slot]
    if audit_layers is not None:
        layout += [(("audit", "layer_err_sum"), (audit_layers,)),
                   (("audit", "layer_rows"), ())]
    total = sum(math.prod(shape) for _, shape in layout)
    flat = torch.zeros((total,), dtype=F32, device=dev)
    m: Dict = {"counters": {}, "hist": {n: {} for n in hists},
               "per_slot": {}}
    off = 0
    for path, shape in layout:
        n = math.prod(shape)
        node = m
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = flat[off:off + n].view(shape)
        off += n
    m["flat"] = flat
    return m


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if k == "flat" and not prefix:
            continue
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _sorted(tree: Dict) -> Dict:
    return {k: _sorted(v) if isinstance(v, dict) else v
            for k, v in sorted(tree.items())}


def to_host(device_metrics: Mapping) -> Dict:
    """The metrics dict with every tensor leaf as a numpy array, keys
    sorted at every level as the reference's harvested pytree has them (so
    the two collectors' windows serialize alike): the device-to-host
    transfer of a harvest.  A dict made by ``init_device_metrics`` moves as
    one copy of its flat buffer; any other dict of tensors (or numbers)
    leaf by leaf."""
    flat = device_metrics.get("flat")
    host_flat = flat.cpu().numpy() if flat is not None else None
    out: Dict = {}
    for path, v in _leaves(device_metrics):
        if host_flat is not None:
            off = v.storage_offset() - flat.storage_offset()
            a = host_flat[off:off + v.numel()].reshape(tuple(v.shape))
        elif isinstance(v, torch.Tensor):
            a = v.detach().cpu().numpy()
        else:
            a = np.asarray(v)
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = a
    return _sorted(out)


_BOUNDS: Dict[Tuple[str, str], Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]] = {}


def _bounds(name: str, device: torch.device
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A histogram's upper bounds as an f32 tensor on ``device``, and each
    bin's (lo, hi] edges, overflow bin last, made once per device."""
    key = (name, str(device))
    got = _BOUNDS.get(key)
    if got is None:
        b = np.asarray(spec(name).buckets, np.float32)
        inf = np.float32(np.inf)
        lo = np.concatenate([[-inf], b]).astype(np.float32)
        hi = np.concatenate([b, [inf]]).astype(np.float32)
        got = tuple(to_device(a, device) for a in (b, lo, hi))
        _BOUNDS[key] = got
    return got


def host_bin(name: str, value: float) -> int:
    """The bin a host value falls in, compared in f32 as the device plane
    compares (``searchsorted`` side left: the first bound >= value)."""
    b = np.asarray(spec(name).buckets, np.float32)
    return int(np.searchsorted(b, np.float32(value), side="left"))


def inc(m: Dict, name: str, value) -> Dict:
    """Counter bump in place: ``counters[name] += value`` (a number or a
    0-dim tensor on the metrics' device).  Returns ``m``."""
    m["counters"][name].add_(value)
    return m


def observe(m: Dict, name: str, value) -> Dict:
    """Histogram observation in place: bumps the bin ``value`` falls in
    (upper bounds from the registered spec; overflow bin last) plus
    sum/count.  ``value`` is a number or a 0-dim tensor."""
    h = m["hist"][name]
    if isinstance(value, torch.Tensor):
        v = value.to(F32).reshape(1)
        bounds = _bounds(name, v.device)[0]
        idx = torch.searchsorted(bounds, v, side="left")
        h["bucket"].index_add_(0, idx, torch.ones_like(v))
        h["sum"].add_(v[0])
    else:
        h["bucket"][host_bin(name, value)].add_(1.0)
        h["sum"].add_(float(value))
    h["count"].add_(1.0)
    return m


def observe_many(m: Dict, name: str, values: torch.Tensor,
                 weights: torch.Tensor) -> Dict:
    """Vectorized histogram observation in place: bin each entry of
    ``values`` (S,) and add its ``weights`` entry there (weight 0 = not
    observed).  The audit plane observes one error per audited slot."""
    h = m["hist"][name]
    v = values.to(F32)
    w = weights.to(F32)
    idx = torch.searchsorted(_bounds(name, v.device)[0], v, side="left")
    h["bucket"].index_add_(0, idx, w)
    h["sum"].add_((v * w).sum())
    h["count"].add_(w.sum())
    return m


def slot_add(m: Dict, name: str, values) -> Dict:
    """Per-slot accumulation in place: ``per_slot[name] += values``."""
    m["per_slot"][name].add_(values)
    return m


_INDEX: Dict[Tuple, torch.Tensor] = {}


class DeviceUpdate:
    """One engine step's increments of an ``init_device_metrics`` dict,
    applied together: the parts the host knows (step counts, active slots)
    in one f32 vector copied to the device, the parts that live on the
    device (stat deltas, observed fractions) gathered into one
    ``index_add_``.  ``inc`` / ``observe`` / ``slot_add`` take numbers or
    numpy arrays (host) and tensors (device) alike, with the device plane's
    semantics; nothing is read back."""

    def __init__(self, m: Dict):
        self.m = m
        self.flat = m["flat"]
        self.host = np.zeros((self.flat.numel(),), np.float32)
        self._spans: List[Tuple[int, int]] = []
        self._vals: List[torch.Tensor] = []

    def _offset(self, leaf: torch.Tensor) -> int:
        return leaf.storage_offset() - self.flat.storage_offset()

    def _add(self, leaf: torch.Tensor, value, at: int = 0) -> None:
        off = self._offset(leaf) + at
        if isinstance(value, torch.Tensor):
            v = value.reshape(-1)
            self._spans.append((off, v.numel()))
            self._vals.append(v)
        else:
            v = np.asarray(value, np.float32).reshape(-1)
            self.host[off:off + v.size] += v

    def inc(self, name: str, value) -> None:
        self._add(self.m["counters"][name], value)

    def observe(self, name: str, value) -> None:
        h = self.m["hist"][name]
        if isinstance(value, torch.Tensor):
            v = value.to(F32).reshape(())
            _, lo, hi = _bounds(name, v.device)
            self._add(h["bucket"], (v > lo) & (v <= hi))
            self._add(h["sum"], v)
        else:
            self._add(h["bucket"], 1.0, at=host_bin(name, value))
            self._add(h["sum"], float(value))
        self._add(h["count"], 1.0)

    def slot_add(self, name: str, values) -> None:
        self._add(self.m["per_slot"][name], values)

    def apply(self) -> None:
        if self.host.any():
            self.flat.add_(to_device(self.host, self.flat.device))
        if self._vals:
            key = (str(self.flat.device), tuple(self._spans))
            idx = _INDEX.get(key)
            if idx is None:
                idx = to_device(np.concatenate(
                    [np.arange(o, o + n) for o, n in self._spans]),
                    self.flat.device)
                _INDEX[key] = idx
            # cat promotes the bool bins to f32: one launch for the lot
            self.flat.index_add_(0, idx, torch.cat(self._vals).to(F32))



def histogram_quantile(buckets: Tuple[float, ...], bucket_counts,
                       q: float) -> float:
    """Host-side Prometheus-style quantile estimate from per-bin counts
    (``len(buckets) + 1`` entries, overflow last): linear interpolation
    within the bucket the rank lands in, with observations in the overflow
    bin clamped to the last finite bound.  Returns 0.0 for an empty
    histogram."""
    counts = np.asarray(bucket_counts, np.float64)
    total = float(counts.sum())
    if total <= 0.0:
        return 0.0
    rank = q * total
    cum, lo = 0.0, 0.0
    for bound, cnt in zip(buckets, counts[:-1]):
        hi = float(bound)
        if cnt > 0 and cum + float(cnt) >= rank:
            return lo + (rank - cum) / float(cnt) * (hi - lo)
        cum += float(cnt)
        lo = hi
    return float(buckets[-1]) if buckets else 0.0


# --------------------------------------------------------------------------
# Host plane
# --------------------------------------------------------------------------


class MetricsCollector:
    """Host-side metrics aggregation + export.

    Host observations (:meth:`inc` / :meth:`observe`) are plain Python
    arithmetic — safe anywhere on the orchestration path.  Device metrics
    cross to the host ONLY through :meth:`harvest`, which the engines call
    at run end (and optionally every ``window_steps`` engine steps); each
    harvest appends one window snapshot for the JSONL trajectory, and the
    latest cumulative values feed the Prometheus exposition."""

    def __init__(self, labels: Optional[Dict[str, str]] = None, *,
                 window_steps: Optional[int] = None):
        if window_steps is not None and window_steps < 1:
            raise ValueError(f"window_steps must be >= 1, got "
                             f"{window_steps}")
        self.labels = dict(labels or {})
        self.window_steps = window_steps
        self._counters: Dict[str, float] = {}
        self._hist: Dict[str, Dict] = {}
        self._device: Dict = {}          # latest harvested device snapshot
        self._gauges: Dict[str, float] = {}
        self.windows: List[Dict] = []
        self._t0 = time.perf_counter()
        # audit plane comparison context + previous-harvest totals (the
        # windowed drift / burn-rate summaries are deltas between harvests)
        self._audit_bound: Optional[float] = None
        self._audit_baseline: Optional[np.ndarray] = None
        self._audit_fraction: Optional[float] = None
        self._prev_audit = {"rows": 0.0, "err": 0.0, "viol": 0.0}

    # -- host observations (no device involvement) ---------------------

    def inc(self, name: str, value: float = 1.0) -> None:
        if spec(name).kind != "counter":
            raise ValueError(f"metric {name!r} is not a counter")
        self._counters[name] = self._counters.get(name, 0.0) + float(value)

    def observe(self, name: str, value: float) -> None:
        s = spec(name)
        if s.kind != "histogram":
            raise ValueError(f"metric {name!r} is not a histogram")
        h = self._hist.setdefault(
            name, {"bucket": np.zeros(len(s.buckets) + 1, np.float64),
                   "sum": 0.0, "count": 0.0})
        idx = int(np.searchsorted(np.asarray(s.buckets), float(value),
                                  side="left"))
        h["bucket"][idx] += 1.0
        h["sum"] += float(value)
        h["count"] += 1.0

    def set_gauge(self, name: str, value: float) -> None:
        """Free-form gauge (clock readings, occupancy at harvest time);
        gauges need no registration — they are point-in-time readings, not
        accumulated series, so the uniqueness rule does not apply."""
        self._gauges[name] = float(value)

    def set_audit_context(self, *, bound: Optional[float] = None,
                          baseline=None,
                          fraction: Optional[float] = None) -> None:
        """Install the audit plane's comparison context: the policy's
        predicted per-step relative error bound (the burn-rate
        denominator), a calibration baseline (``errors_mean`` (L, T) from
        ``obs/calibration.py`` — the drift denominator), and the sampling
        fraction (recorded in windows).  None leaves a field untouched, so
        the engine (bound, fraction) and the launcher (baseline) each
        contribute their half."""
        if bound is not None:
            self._audit_bound = float(bound)
        if baseline is not None:
            base = np.asarray(baseline, np.float64)
            if base.ndim != 2:
                raise ValueError(f"audit baseline must be an (L, T) "
                                 f"errors_mean array, got shape "
                                 f"{base.shape}")
            self._audit_baseline = base
        if fraction is not None:
            self._audit_fraction = float(fraction)

    # -- the sync point -------------------------------------------------

    def harvest(self, device_metrics: Optional[Dict] = None, *,
                at_step: Optional[int] = None) -> Dict:
        """Fetch the device metrics dict (the device->host transfer: the
        engines call this only at run end / window close) and snapshot one
        window.  Values are cumulative since engine start; the window
        record carries the wall-clock and step-clock stamps so the JSONL
        series is a trajectory, not deltas."""
        if device_metrics:
            host = to_host(device_metrics)
            self._device = host
        audit = self._audit_window()    # sets the drift/burn gauges first
        window = {
            "at_step": at_step,
            "wall_s": time.perf_counter() - self._t0,
            "labels": dict(self.labels),
            "counters": self._merged_counters(),
            "histograms": {n: {"buckets": list(spec(n).buckets),
                               "bucket_counts": [float(v)
                                                 for v in h["bucket"]],
                               "sum": float(h["sum"]),
                               "count": float(h["count"])}
                           for n, h in self._all_hists().items()},
            "gauges": dict(self._gauges),
        }
        if self._device.get("per_slot"):
            window["per_slot"] = {
                n: [float(x) for x in v]
                for n, v in self._device["per_slot"].items()}
        if audit is not None:
            window["audit"] = audit
        self.windows.append(window)
        return window

    def _audit_window(self) -> Optional[Dict]:
        """Windowed audit summary (None when no audit metrics have been
        harvested): deltas of the audited totals since the previous harvest
        become error-mean / violation-rate gauges; with a bound installed,
        ``audit_burn_rate_window`` reads the fraction of the per-step error
        budget the window consumed; with a calibration baseline,
        ``audit_drift_ratio`` compares the measured per-layer cache error
        against the nocache run's natural inter-step deltas — the
        SmoothCache/SpectralCache health signal that says when a calibrated
        schedule is no longer safe."""
        dev = self._device
        counters = dev.get("counters", {})
        if AUDIT_SLOT_STEPS not in counters:
            return None
        per_slot = dev.get("per_slot", {})
        rows = float(counters.get(AUDIT_SLOT_STEPS, 0.0))
        err = float(np.sum(per_slot.get(SLOT_AUDIT_ERR, 0.0)))
        viol = float(counters.get(BOUND_VIOLATIONS, 0.0))
        d_rows = rows - self._prev_audit["rows"]
        d_err = err - self._prev_audit["err"]
        d_viol = viol - self._prev_audit["viol"]
        self._prev_audit = {"rows": rows, "err": err, "viol": viol}
        err_mean = d_err / d_rows if d_rows > 0 else 0.0
        viol_rate = d_viol / d_rows if d_rows > 0 else 0.0
        out = {
            "audited_rows_total": rows,
            "audited_rows_window": d_rows,
            "err_mean_window": err_mean,
            "violation_rate_window": viol_rate,
        }
        if self._audit_fraction is not None:
            out["audit_fraction"] = self._audit_fraction
        self.set_gauge("audit_err_mean_window", err_mean)
        self.set_gauge("audit_violation_rate_window", viol_rate)
        if self._audit_bound is not None:
            out["predicted_bound"] = self._audit_bound
            burn = (err_mean / self._audit_bound
                    if self._audit_bound > 0 else 0.0)
            out["burn_rate_window"] = burn
            self.set_gauge("audit_burn_rate_window", burn)
        grp = dev.get("audit")
        if grp is not None:
            sums = np.asarray(grp["layer_err_sum"], np.float64)
            n = float(grp["layer_rows"])
            layer_mean = sums / n if n > 0 else np.zeros_like(sums)
            out["layer_err_mean"] = [float(x) for x in layer_mean]
            if self._audit_baseline is not None and n > 0:
                # measured stack entry l+1 is block l's output; the
                # calibration rows are block outputs over the schedule
                # (its forced step-0 column of 1.0 excluded)
                base_cols = (self._audit_baseline[:, 1:]
                             if self._audit_baseline.shape[1] > 1
                             else self._audit_baseline)
                base = float(np.mean(base_cols))
                measured = float(np.mean(layer_mean[1:])
                                 if layer_mean.shape[0] > 1
                                 else np.mean(layer_mean))
                drift = measured / base if base > 0 else 0.0
                out["drift_ratio"] = drift
                self.set_gauge("audit_drift_ratio", drift)
        return out

    # -- merged views ---------------------------------------------------

    def _merged_counters(self) -> Dict[str, float]:
        out = {n: float(v) for n, v in self._counters.items()}
        for n, v in self._device.get("counters", {}).items():
            out[n] = out.get(n, 0.0) + float(v)
        return out

    def _all_hists(self) -> Dict[str, Dict]:
        out = {n: {"bucket": np.asarray(h["bucket"], np.float64),
                   "sum": float(h["sum"]), "count": float(h["count"])}
               for n, h in self._hist.items()}
        for n, h in self._device.get("hist", {}).items():
            cur = out.get(n)
            add = {"bucket": np.asarray(h["bucket"], np.float64),
                   "sum": float(h["sum"]), "count": float(h["count"])}
            if cur is None:
                out[n] = add
            else:
                out[n] = {"bucket": cur["bucket"] + add["bucket"],
                          "sum": cur["sum"] + add["sum"],
                          "count": cur["count"] + add["count"]}
        return out

    def totals(self) -> Dict[str, float]:
        """Cumulative counters (host + last-harvested device values)."""
        return self._merged_counters()

    def quantile(self, name: str, q: float) -> float:
        """Quantile estimate over a registered histogram's merged (host +
        harvested device) counts — e.g. ``quantile(AUDIT_REL_ERR, 0.95)``
        is the trajectory's ``audit_err_p95`` column.  0.0 when the
        histogram has no observations."""
        s = spec(name)
        if s.kind != "histogram":
            raise ValueError(f"metric {name!r} is not a histogram")
        h = self._all_hists().get(name)
        if h is None:
            return 0.0
        return histogram_quantile(s.buckets, h["bucket"], q)

    # -- exports --------------------------------------------------------

    def _label_str(self, extra: Optional[Dict[str, str]] = None) -> str:
        labels = {**self.labels, **(extra or {})}
        if not labels:
            return ""
        body = ",".join(f'{k}="{_escape_label(str(v))}"'
                        for k, v in sorted(labels.items()))
        return "{" + body + "}"

    def to_prometheus(self, prefix: str = "repro_") -> str:
        """Prometheus text exposition format (v0.0.4): counters as
        ``<prefix><name>``, histograms as cumulative ``_bucket{le=...}``
        series plus ``_sum``/``_count``, gauges as-is."""
        lines: List[str] = []
        ls = self._label_str()
        for n, v in sorted(self._merged_counters().items()):
            full = prefix + n
            if spec(n).help:
                lines.append(f"# HELP {full} {spec(n).help}")
            lines.append(f"# TYPE {full} counter")
            lines.append(f"{full}{ls} {_fmt(v)}")
        for n, h in sorted(self._all_hists().items()):
            full = prefix + n
            if spec(n).help:
                lines.append(f"# HELP {full} {spec(n).help}")
            lines.append(f"# TYPE {full} histogram")
            cum = 0.0
            for le, cnt in zip(spec(n).buckets, h["bucket"]):
                cum += float(cnt)
                lines.append(f"{full}_bucket"
                             f"{self._label_str({'le': _fmt(le)})} "
                             f"{_fmt(cum)}")
            cum += float(h["bucket"][-1])
            lines.append(f"{full}_bucket{self._label_str({'le': '+Inf'})} "
                         f"{_fmt(cum)}")
            lines.append(f"{full}_sum{ls} {_fmt(h['sum'])}")
            lines.append(f"{full}_count{ls} {_fmt(h['count'])}")
        for n, v in sorted(self._gauges.items()):
            full = prefix + n
            lines.append(f"# TYPE {full} gauge")
            lines.append(f"{full}{ls} {_fmt(v)}")
        return "\n".join(lines) + "\n"

    def to_jsonl(self) -> str:
        """One JSON object per harvested window (cumulative snapshots)."""
        return "\n".join(json.dumps(w) for w in self.windows) + (
            "\n" if self.windows else "")


def _escape_label(v: str) -> str:
    """Prometheus text-format label-value escaping (v0.0.4): backslash,
    double-quote, and newline."""
    return (v.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(v: float) -> str:
    f = float(v)
    if math.isnan(f):
        return "NaN"
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _parse_value(s: str) -> float:
    """A sample value in the exposition format: the canonical non-finite
    spellings plus ordinary floats."""
    if s == "NaN":
        return float("nan")
    if s == "+Inf":
        return float("inf")
    if s == "-Inf":
        return float("-inf")
    return float(s)


# --------------------------------------------------------------------------
# Exposition parser (round-trip validation; also used by tests)
# --------------------------------------------------------------------------

_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*")

_ESCAPES = {"\\": "\\", '"': '"', "n": "\n"}


def _scan_labels(line: str, i: int, lineno: int
                 ) -> Tuple[Dict[str, str], int]:
    """Scan a ``{k="v",...}`` label block starting at ``line[i] == "{"``;
    returns ``(labels, index past the closing brace)``.  Quoted values may
    contain escaped backslashes / quotes / newlines and literal ``,`` or
    ``}`` — the character scan respects quoting, which a fixed ``[^}]*``
    regex cannot."""
    labels: Dict[str, str] = {}
    i += 1
    n = len(line)
    while i < n and line[i] != "}":
        j = line.find("=", i)
        if j < 0 or j + 1 >= n or line[j + 1] != '"':
            raise ValueError(f"malformed label on line {lineno}: "
                             f"{line[i:]!r}")
        key = line[i:j]
        i = j + 2
        buf: List[str] = []
        while i < n and line[i] != '"':
            ch = line[i]
            if ch == "\\":
                if i + 1 >= n:
                    raise ValueError(f"dangling escape on line {lineno}")
                buf.append(_ESCAPES.get(line[i + 1], line[i + 1]))
                i += 2
            else:
                buf.append(ch)
                i += 1
        if i >= n:
            raise ValueError(f"unterminated label value on line {lineno}")
        i += 1                        # closing quote
        labels[key] = "".join(buf)
        if i < n and line[i] == ",":
            i += 1
    if i >= n or line[i] != "}":
        raise ValueError(f"unterminated label block on line {lineno}")
    return labels, i + 1


def parse_prometheus(text: str) -> Dict[str, Dict]:
    """Parse Prometheus text exposition into
    ``{metric: {"type": ..., "samples": [(labels dict, value)]}}``.
    Raises ``ValueError`` on any malformed line — the tests use this to
    assert the export parses cleanly.  Handles escaped label values,
    ``+Inf``/``-Inf`` bucket bounds, and ``NaN`` gauge values (all of
    which the exporter can legitimately emit)."""
    out: Dict[str, Dict] = {}
    types: Dict[str, str] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(None, 3)
            types[name] = kind
            out.setdefault(name, {"type": kind, "samples": []})
            continue
        if line.startswith("#"):
            continue
        m = _METRIC_NAME_RE.match(line)
        if m is None:
            raise ValueError(f"malformed exposition line {lineno}: "
                             f"{line!r}")
        name = m.group(0)
        i = m.end()
        labels: Dict[str, str] = {}
        if i < len(line) and line[i] == "{":
            labels, i = _scan_labels(line, i, lineno)
        rest = line[i:].split()
        if len(rest) != 1:
            raise ValueError(f"malformed exposition line {lineno}: "
                             f"{line!r}")
        try:
            value = _parse_value(rest[0])
        except ValueError:
            raise ValueError(f"malformed value on line {lineno}: "
                             f"{rest[0]!r}") from None
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if base.endswith(suffix) and base[:-len(suffix)] in types:
                base = base[:-len(suffix)]
                break
        out.setdefault(base, {"type": types.get(base, "untyped"),
                              "samples": []})
        out[base]["samples"].append((labels, value))
    return out
