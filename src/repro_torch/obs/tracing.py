"""Per-request trace events exported as Chrome/Perfetto trace JSON, after
the reference's ``obs/tracing.py``.

Tracing is a **diagnostic mode**: unlike the metrics plane it keeps
host-side state per engine step (wall-clock stamps around each step) and,
for per-slot cache attribution, snapshots the engine's per-slot
accumulators.  Snapshots are device copies (``clone``), fetched only at
:meth:`TraceRecorder.finalize`.

Event model (Chrome trace-event format, ``displayTimeUnit: ms``), the
reference's:

- ``ph="X"`` complete events: one per engine step ("serve_step", with
  active-slot count), plus per-request "request" spans (admit -> finish)
  on a per-slot track;
- ``ph="i"`` instant events: "admit" / "finish" markers carrying rid,
  label, step counts;
- per-step "denoise" slices on each slot's track, annotated post-hoc with
  the policy's gate/skip decision for that step (reconstructed by
  diffing consecutive accumulator snapshots at finalize);
- ``ph="C"`` counter tracks: the running block-cache ratio and, when the
  audit plane's per-slot accumulators ride the snapshots, the running
  mean audited error.

Each step runs inside a ``torch.profiler.record_function`` range
("serve_step[k]"), and the sampler's phases (``cfg_double``,
``model_eval``, ``cfg_blend``, ``ddim_update``) open their own ranges when
a tracer is attached, so a ``torch.profiler`` trace nests under the same
names.  Without a tracer neither is entered.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_US = 1e6  # trace timestamps are microseconds


class TraceRecorder:
    """Collects trace events on the host; ``finalize()`` resolves deferred
    device snapshots and ``write()`` emits Chrome/Perfetto JSON."""

    def __init__(self, *, pid: int = 0, capture_slots: bool = True):
        self.pid = pid
        self.capture_slots = capture_slots
        self.events: List[Dict[str, Any]] = []
        self._t0 = time.perf_counter()
        self._open_steps: List[Dict[str, Any]] = []
        self._snapshots: List[Dict[str, Any]] = []  # deferred device copies
        self._requests: Dict[int, Dict[str, Any]] = {}
        self._finalized = False

    # -- clocks ---------------------------------------------------------

    def _now(self) -> float:
        return (time.perf_counter() - self._t0) * _US

    # -- request lifecycle ---------------------------------------------

    def admit(self, rid: int, slot: int, *, label: int = -1,
              num_steps: int = -1, engine_step: int = -1) -> None:
        ts = self._now()
        self._requests[rid] = {"slot": slot, "t_admit": ts,
                               "admit_step": engine_step}
        self.events.append({
            "name": "admit", "ph": "i", "ts": ts, "pid": self.pid,
            "tid": slot + 1, "cat": "request", "s": "t",
            "args": {"rid": rid, "label": label, "num_steps": num_steps,
                     "engine_step": engine_step}})

    def finish(self, rid: int, *, engine_step: int = -1,
               stats: Optional[Dict[str, float]] = None) -> None:
        ts = self._now()
        info = self._requests.pop(rid, None)
        slot = info["slot"] if info else 0
        self.events.append({
            "name": "finish", "ph": "i", "ts": ts, "pid": self.pid,
            "tid": slot + 1, "cat": "request", "s": "t",
            "args": {"rid": rid, "engine_step": engine_step,
                     **(stats or {})}})
        if info is not None:
            self.events.append({
                "name": f"request rid={rid}", "ph": "X",
                "ts": info["t_admit"], "dur": ts - info["t_admit"],
                "pid": self.pid, "tid": slot + 1, "cat": "request",
                "args": {"rid": rid, "admit_step": info["admit_step"],
                         "finish_step": engine_step, **(stats or {})}})

    # -- engine steps ---------------------------------------------------

    def step_begin(self, engine_step: int, *, active: int = -1) -> "_Span":
        """Open a "serve_step" complete event; use as a context manager
        around the step.  Also opens a ``torch.profiler.record_function``
        range, so profiles align with the exported trace."""
        return _Span(self, engine_step, active)

    def snapshot_slots(self, engine_step: int, active_rows,
                       slot_stats: Dict[str, Any]) -> None:
        """Defer a per-slot accumulator snapshot.  ``slot_stats`` holds the
        engine's live tensors, which later steps update in place, so each
        is copied on its device (queued, no sync); ``finalize`` fetches
        them all."""
        if not self.capture_slots or self._finalized:
            return
        self._snapshots.append({
            "engine_step": engine_step,
            "ts": self._now(),
            "active": np.asarray(active_rows, np.float32).copy(),
            "stats": {k: v.clone() for k, v in slot_stats.items()},
        })

    # -- finalize / export ---------------------------------------------

    def finalize(self) -> None:
        """Fetch deferred snapshots (the single sync) and turn consecutive
        diffs into per-slot per-step "denoise" slices annotated with the
        policy's skip/compute decision, plus Perfetto counter tracks
        (``ph="C"``) for the running cache ratio and — when the audit
        plane's accumulators ride the snapshots — the running mean
        audited error."""
        if self._finalized:
            return
        self._finalized = True
        snaps = [{"engine_step": s["engine_step"], "ts": s["ts"],
                  "active": s["active"],
                  "stats": {k: v.cpu().numpy()
                            for k, v in s["stats"].items()}}
                 for s in self._snapshots]
        self._snapshots = []
        self._emit_counter_tracks(snaps)
        for prev, cur in zip(snaps, snaps[1:]):
            dur = max(cur["ts"] - prev["ts"], 1.0)
            d = {k: cur["stats"][k] - prev["stats"][k]
                 for k in cur["stats"]}
            active = prev["active"]
            n_slots = active.shape[0]
            for s in range(n_slots):
                if active[s] <= 0.0:
                    continue
                args = {"engine_step": prev["engine_step"]}
                for k, v in d.items():
                    args[k] = float(v[s])
                skipped = args.get("steps_reused", 0.0) > 0.0
                self.events.append({
                    "name": "denoise (cache reuse)" if skipped
                    else "denoise (compute)",
                    "ph": "X", "ts": prev["ts"], "dur": dur,
                    "pid": self.pid, "tid": s + 1, "cat": "denoise",
                    "args": args})

    def _emit_counter_tracks(self, snaps: List[Dict[str, Any]]) -> None:
        """Counter-track events from the cumulative per-slot snapshots:
        Perfetto renders each ``args`` key of a same-named ``ph="C"``
        event series as a stacked counter plot.  The snapshots are
        running totals, so each point is a cumulative ratio — the curves
        converge to the run's headline numbers."""
        for s in snaps:
            st = s["stats"]
            if "blocks_computed" in st:
                skipped = float(np.sum(st.get("blocks_skipped", 0.0)))
                computed = float(np.sum(st["blocks_computed"]))
                total = skipped + computed
                self.events.append({
                    "name": "cache ratio (running)", "ph": "C",
                    "ts": s["ts"], "pid": self.pid, "cat": "counter",
                    "args": {"cache_ratio":
                             skipped / total if total else 0.0}})
            if "audit_err_sum" in st and "audit_steps" in st:
                err = float(np.sum(st["audit_err_sum"]))
                steps = float(np.sum(st["audit_steps"]))
                self.events.append({
                    "name": "audit error (running mean)", "ph": "C",
                    "ts": s["ts"], "pid": self.pid, "cat": "counter",
                    "args": {"audit_err_mean":
                             err / steps if steps else 0.0}})

    def to_json(self) -> Dict[str, Any]:
        self.finalize()
        meta = [{"name": "process_name", "ph": "M", "pid": self.pid,
                 "args": {"name": "repro serving engine"}},
                {"name": "thread_name", "ph": "M", "pid": self.pid,
                 "tid": 0, "args": {"name": "engine loop"}}]
        tids = sorted({e.get("tid", 0) for e in self.events} - {0})
        for tid in tids:
            meta.append({"name": "thread_name", "ph": "M", "pid": self.pid,
                         "tid": tid, "args": {"name": f"slot {tid - 1}"}})
        return {"traceEvents": meta + self.events,
                "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)


class _Span:
    def __init__(self, rec: TraceRecorder, engine_step: int, active: int):
        self.rec = rec
        self.engine_step = engine_step
        self.active = active
        self._ann = torch.profiler.record_function(
            f"serve_step[{engine_step}]")

    def __enter__(self):
        self.t0 = self.rec._now()
        self._ann.__enter__()
        return self

    def __exit__(self, *exc):
        self._ann.__exit__(*exc)
        self.rec.events.append({
            "name": "serve_step", "ph": "X", "ts": self.t0,
            "dur": max(self.rec._now() - self.t0, 0.01),
            "pid": self.rec.pid, "tid": 0, "cat": "engine",
            "args": {"engine_step": self.engine_step,
                     "active_slots": self.active}})
        return False


def validate_trace(doc: Dict[str, Any]) -> None:
    """Raise ``ValueError`` unless ``doc`` is structurally valid
    Chrome/Perfetto trace JSON (used by tests and the CLI after write)."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("trace document must carry a traceEvents array")
    for i, ev in enumerate(doc["traceEvents"]):
        for key in ("name", "ph", "pid"):
            if key not in ev:
                raise ValueError(f"event {i} missing {key!r}: {ev}")
        ph = ev["ph"]
        if ph not in ("X", "i", "B", "E", "M", "C"):
            raise ValueError(f"event {i} has unknown phase {ph!r}")
        if ph == "X" and ("ts" not in ev or "dur" not in ev):
            raise ValueError(f"complete event {i} missing ts/dur: {ev}")
        if ph in ("i", "C") and "ts" not in ev:
            raise ValueError(f"event {i} ({ph!r}) missing ts: {ev}")
        if ph == "C" and not ev.get("args"):
            raise ValueError(f"counter event {i} has no series args: {ev}")
