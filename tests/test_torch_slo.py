"""The port's SLO control plane and preempt / resume against the
reference's, on the smoke DiT (2 layers, 16 tokens, f32).

Decisions are host bookkeeping on the engine-step clock, so they must be
the reference's exactly: arrivals, classes and deadlines of the traces,
queue order, the shed ladder's walk, admissions, rejections with their
reason, deferrals, preemptions, resumes, admit and finish steps and the
collector's SLO counts.  Request-scoped counters are equal exactly;
latents within ``LATENT_REL`` (1e-4) of their scale, as in
test_torch_serving.py, and the port's own solo replay of a preempted
request (per-sample guidance rows, as the engine runs them) bitwise.

The snapshot walkers are held leaf by leaf to the reference's on the same
random state: the same rows copied out, the same rows written back, and
``restore(snapshot)`` the identity; for all eight policies merge off and at
0.5, and at the sizes where the row count equals the layer count L or
L + 1 (the rank rule's layer test first, as in the reference).
"""
import tests.torch_threads  # noqa: F401  (first: one thread)
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FastCacheConfig as JFastCacheConfig
from repro.core import CachedDiT as JCachedDiT
from repro.obs import MetricsCollector as JMetricsCollector
from repro.serving import AdmissionController as JAdmissionController
from repro.serving import DegradationController as JDegradationController
from repro.serving import DiffusionRequest as JDiffusionRequest
from repro.serving import DiffusionServingEngine as JEngine
from repro.serving import ReplicaRouter as JReplicaRouter
from repro.serving import RequestQueue as JRequestQueue
from repro.serving import ShedLevel as JShedLevel
from repro.serving import SLOScheduler as JSLOScheduler
from repro.serving import piecewise_rate as jpiecewise_rate
from repro.serving import poisson_trace as jpoisson_trace
from repro.serving import summarize_by_class as jsummarize_by_class
from repro.serving import summarize_by_steps as jsummarize_by_steps
from repro_torch.configs.base import FastCacheConfig
from repro_torch.core.policies.base import registered_policies, slot_axis
from repro_torch.core.runner import CachedDiT
from repro_torch.diffusion.sampler import sample
from repro_torch.launch import serve_diffusion
from repro_torch.obs import metrics as tm
from repro_torch.obs.metrics import MetricsCollector
from repro_torch.serving import (SCHED_POLICIES, AdmissionController,
                                 DegradationController, DiffusionRequest,
                                 DiffusionServingEngine, ReplicaRouter,
                                 RequestQueue, ShedLevel, SLOScheduler,
                                 piecewise_rate, poisson_trace,
                                 summarize_by_class, summarize_by_steps)
from repro_torch.serving.slo import (DEFAULT_SHED_LEVELS, REASON_EXPIRED,
                                     REASON_UNATTAINABLE, StepTimer)
from tests.test_torch_model import jax_dit, port_dit, t32
from tests.test_torch_policies import _kwargs
from tests.test_torch_serving import LATENT_REL

STEPS = 6
MERGES = (None, 0.5)
SLO_METRICS = (tm.ADMISSIONS, tm.REQUESTS_FINISHED, tm.PREEMPTIONS,
               tm.RESUMES, tm.REJECTIONS, tm.DEADLINE_MISSES)


def _fc(merge, jax_side=False):
    cls = JFastCacheConfig if jax_side else FastCacheConfig
    if merge is None:
        return cls()
    return cls(merge_enabled=True, merge_ratio=merge, merge_window=8)


@pytest.fixture(scope="module")
def dit():
    jcfg, jmodel, jparams = jax_dit("smoke")
    return jcfg, jmodel, jparams, port_dit(jcfg, jparams)


def _engines(dit, *, slots, merge=None, collectors=False, **kw):
    """The reference's engine and the port's on the same model, the port
    drawing the reference's initial noise."""
    jcfg, jmodel, jparams, model = dit
    jeng = JEngine(JCachedDiT(jmodel, _fc(merge, True)), jparams,
                   max_slots=slots, num_steps=STEPS, max_steps=STEPS,
                   collector=JMetricsCollector() if collectors else None,
                   **kw)

    def noise(req):
        return t32(np.asarray(jeng.request_noise(req)))

    eng = DiffusionServingEngine(
        CachedDiT(model, _fc(merge)), max_slots=slots, num_steps=STEPS,
        max_steps=STEPS, noise_fn=noise,
        collector=MetricsCollector() if collectors else None, **kw)
    return jeng, eng, noise


def _same_requests(done, jdone, *, latents=True, latent_rids=None):
    """Finished requests of the two engines, by rid: the plan, the clock
    stamps and the SLO fields equal, counters exact, latents at 1e-4 (of
    the requests in ``latent_rids``, all by default)."""
    by_rid = {r.rid: r for r in jdone}
    assert sorted(r.rid for r in done) == sorted(by_rid)
    for r in done:
        jr = by_rid[r.rid]
        got = (r.num_steps, r.guidance_scale, r.priority, r.deadline_step,
               r.admit_step, r.finish_step, r.queue_wait_steps,
               r.preemptions, r.steps_done, r.reject_reason)
        want = (jr.num_steps, jr.guidance_scale, jr.priority,
                jr.deadline_step, jr.admit_step, jr.finish_step,
                jr.queue_wait_steps, jr.preemptions, jr.steps_done,
                jr.reject_reason)
        assert got == want, r.rid
        if latents:
            assert r.cache == jr.cache, r.rid
        if latents and (latent_rids is None or r.rid in latent_rids):
            w = np.asarray(jr.latents)
            np.testing.assert_allclose(r.latents, w, rtol=0,
                                       atol=LATENT_REL * float(np.abs(w).max()),
                                       err_msg=f"rid={r.rid}")


# ---------------------------------------------------------------------------
# traces, queue order, summaries
# ---------------------------------------------------------------------------

def test_piecewise_rate_matches_reference():
    segs = [(5, 0.5), (10, 2.0), (1e9, 0.25)]
    fn, jfn = piecewise_rate(segs), jpiecewise_rate(segs)
    for t in (0.0, 4.999, 5.0, 9.0, 10.0, 1e6):
        assert fn(t) == jfn(t), t
    with pytest.raises(ValueError):
        piecewise_rate([])


_TRACE_KNOBS = {
    "plain": {},
    "mixes": dict(steps_mix=[4, 6], guidance_mix=[1.0, 4.0],
                  priority_mix=[0, 1, 1, 2],
                  deadline_slack_mix=[80, 120, 200]),
    "burst": dict(rate_fn=(5, 20, 2.0), priority_mix=[0, 1, 1, 2],
                  deadline_slack_mix=[6, 12, 30]),
}


@pytest.mark.parametrize("knobs", sorted(_TRACE_KNOBS))
@pytest.mark.parametrize("seed", [0, 7])
def test_poisson_trace_matches_reference(knobs, seed):
    kw = dict(_TRACE_KNOBS[knobs])
    jkw = dict(kw)
    if "rate_fn" in kw:
        start, length, burst = kw["rate_fn"]
        segs = [(start, 0.5), (start + length, burst), (10 ** 9, 0.5)]
        kw["rate_fn"], jkw["rate_fn"] = (piecewise_rate(segs),
                                         jpiecewise_rate(segs))
    got = poisson_trace(16, 0.5, seed=seed, num_classes=10, **kw)
    want = jpoisson_trace(16, 0.5, seed=seed, num_classes=10, **jkw)
    fields = [f.name for f in dataclasses.fields(JDiffusionRequest)
              if f.name not in ("latents", "cache", "snapshot")]
    assert [[getattr(r, f) for f in fields] for r in got] == \
        [[getattr(r, f) for f in fields] for r in want]


def _mixed_requests(cls, n=24, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n):
        out.append(cls(rid=rid, label=1, seed=rid,
                       arrival_step=int(rng.integers(0, 6)),
                       num_steps=(None if rng.random() < 0.2
                                  else int(rng.integers(2, 9))),
                       priority=int(rng.integers(0, 3)),
                       deadline_step=(None if rng.random() < 0.25
                                      else int(rng.integers(5, 40)))))
    return out


@pytest.mark.parametrize("policy", SCHED_POLICIES)
def test_queue_order_matches_reference(policy):
    """Pops, peeks, depths and per-class depths over a clock that admits
    arrivals, with pushes of requeued requests in between."""
    q = RequestQueue(_mixed_requests(DiffusionRequest), policy=policy)
    jq = JRequestQueue(_mixed_requests(JDiffusionRequest), policy=policy)
    order, jorder = [], []
    for now in range(8):
        assert q.ready_depth(now) == jq.ready_depth(now)
        assert q.depth_by_class(now) == jq.depth_by_class(now)
        assert len(q) == len(jq)
        for _ in range(3):
            r, jr = q.pop_arrived(now), jq.pop_arrived(now)
            assert (r is None) == (jr is None)
            if r is None:
                break
            order.append(r.rid)
            jorder.append(jr.rid)
            if r.rid % 5 == 0:          # a requeue, as after a preemption
                r.rid += 100
                jr.rid += 100
                q.push(r)
                jq.push(jr)
        peek, jpeek = q.peek_arrived(now), jq.peek_arrived(now)
        assert (peek and peek.rid) == (jpeek and jpeek.rid)
    assert order == jorder
    assert bool(q) == bool(jq)


def test_edf_and_strict_priority_order():
    """The reference test's two queues, on the port."""
    def req(rid, priority=0, deadline=None):
        return DiffusionRequest(rid=rid, label=1, priority=priority,
                                deadline_step=deadline)
    q = RequestQueue([req(0, deadline=30), req(1, deadline=10), req(2),
                      req(3, deadline=20)], policy="edf")
    assert [q.pop_arrived(0).rid for _ in range(4)] == [1, 3, 0, 2]
    q = RequestQueue([req(0, 2, 5), req(1, 0, 50), req(2, 1, 1)],
                     policy="edf")
    assert [q.pop_arrived(0).rid for _ in range(3)] == [1, 2, 0]


def _finished_mix(cls):
    reqs = _mixed_requests(cls, n=12, seed=5)
    for i, r in enumerate(reqs):
        if i % 4 == 3:
            r.reject_reason = (REASON_UNATTAINABLE if i % 8 == 3
                               else REASON_EXPIRED)
            r.num_steps = None
            continue
        r.num_steps = r.num_steps or 6
        r.finish_step = r.arrival_step + 4 + i
        r.queue_wait_steps = i % 3
        r.preemptions = i % 2
        r.cache = {"blocks_skipped": float(i), "blocks_computed": 10.0,
                   "steps_reused": float(i % 2)}
    return reqs


def test_summaries_match_reference():
    got, want = _finished_mix(DiffusionRequest), _finished_mix(
        JDiffusionRequest)
    assert summarize_by_class(got) == jsummarize_by_class(want)
    assert summarize_by_steps(got) == jsummarize_by_steps(want)
    assert summarize_by_class([]) == jsummarize_by_class([]) == {}


# ---------------------------------------------------------------------------
# the shed ladder
# ---------------------------------------------------------------------------

DEPTHS = (10, 10, 2, 10, 10, 10, 0, 12, 12, 12, 12, 3, 0, 0, 0, 1, 0, 9,
          9, 9, 9, 0, 0, 0, 0)


def test_shed_ladder_walk_matches_reference():
    col, jcol = MetricsCollector(), JMetricsCollector()
    ctl = DegradationController(high_watermark=4, low_watermark=1,
                                patience=2, collector=col)
    jctl = JDegradationController(high_watermark=4, low_watermark=1,
                                  patience=2, collector=jcol)
    walk, jwalk, steps, jsteps = [], [], [], []
    for i, depth in enumerate(DEPTHS):
        walk.append(ctl.observe(depth).name)
        jwalk.append(jctl.observe(depth).name)
        for prio in (0, 1, 2):
            r = DiffusionRequest(rid=i, label=1, priority=prio,
                                 num_steps=None if i % 2 else 7)
            jr = JDiffusionRequest(rid=i, label=1, priority=prio,
                                   num_steps=None if i % 2 else 7)
            ctl.scale_request(r, default_steps=50)
            jctl.scale_request(jr, default_steps=50)
            steps.append(r.num_steps)
            jsteps.append(jr.num_steps)
    assert walk == jwalk and steps == jsteps
    assert {"shed-1", "shed-2"} <= set(walk)      # the ladder was walked
    assert col._gauges == jcol._gauges
    h, jh = col._hist[tm.QUEUE_DEPTH], jcol._hist[tm.QUEUE_DEPTH]
    np.testing.assert_array_equal(h["bucket"], np.asarray(jh["bucket"]))
    assert (h["sum"], h["count"]) == (jh["sum"], jh["count"])
    assert DEFAULT_SHED_LEVELS == tuple(
        ShedLevel(lv.name, lv.steps_scale, lv.alpha, lv.capacity_scale,
                  lv.min_priority) for lv in jctl.levels)


@pytest.mark.parametrize("bad", [dict(steps_scale=0.0),
                                 dict(steps_scale=1.5),
                                 dict(capacity_scale=0.0)])
def test_shed_level_validation(bad):
    with pytest.raises(ValueError):
        JShedLevel("bad", **bad)
    with pytest.raises(ValueError):
        ShedLevel("bad", **bad)


# ---------------------------------------------------------------------------
# snapshot / restore walkers, leaf by leaf against the reference
# ---------------------------------------------------------------------------

def _port_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_leaves(v, prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _port_leaves(getattr(tree, f), prefix + (f,))
    else:
        yield "/".join(prefix), tree


def _jax_leaves(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "name", None)))
                       for p in path)
        out[key] = np.asarray(leaf)
    return out


def _random_states(tr, jr, batch, seed):
    """The same random values in the port's and the reference's state for
    ``batch`` rows: bool, int and float leaves drawn by numpy."""
    js = jr.init_state(batch)
    ts = tr.init_state(batch)
    rng = np.random.default_rng(seed)
    values = {}
    for key, leaf in _jax_leaves(js).items():
        if leaf.dtype == np.bool_:
            values[key] = rng.random(leaf.shape) < 0.5
        elif leaf.dtype.kind in "iu":
            values[key] = rng.integers(0, 50, leaf.shape).astype(leaf.dtype)
        else:
            values[key] = rng.standard_normal(leaf.shape).astype(leaf.dtype)
    flat, treedef = jax.tree_util.tree_flatten_with_path(js)
    js = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(values[k]) for k in _jax_leaves(js)])
    tleaves = dict(_port_leaves(ts))
    assert sorted(tleaves) == sorted(values)
    for key, leaf in tleaves.items():
        leaf.copy_(torch.from_numpy(np.array(values[key])).to(leaf.dtype))
    return ts, js


def _assert_same_tree(ts, js, what):
    want = _jax_leaves(js)
    got = dict(_port_leaves(ts))
    assert sorted(got) == sorted(want), what
    for key, leaf in got.items():
        np.testing.assert_array_equal(leaf.numpy(), want[key],
                                      err_msg=f"{what}: {key}")


def _clone(tree):
    return {k: v.clone() for k, v in _port_leaves(tree)}


def _walker_case(dit, policy, merge, batch, rows, other_rows):
    jcfg, jmodel, jparams, model = dit
    kw = _kwargs(policy, jcfg.num_layers)
    tr = CachedDiT(model, _fc(merge), policy=policy, **kw)
    jr = JCachedDiT(jmodel, _fc(merge, True), policy=policy, **kw)
    ts, js = _random_states(tr, jr, batch, seed=1)
    before = _clone(ts)
    snap = tr.snapshot_slot(ts, rows)
    jsnap = jr.snapshot_slot(js, jnp.asarray(rows, jnp.int32))
    _assert_same_tree(snap, jsnap, f"{policy} snapshot")
    # the snapshot owns its memory: re-arming the donor rows leaves it
    kept = _clone(snap)
    tr.reset_slot(ts, rows)
    for key, leaf in _port_leaves(snap):
        assert torch.equal(leaf, kept[key]), key
    # restore is the identity on the donor rows ...
    ts = tr.restore_slot(ts, snap, rows)
    for key, leaf in _port_leaves(ts):
        assert torch.equal(leaf, before[key]), key
    # ... and writes the same rows as the reference's into other rows
    ts2, js2 = _random_states(tr, jr, batch, seed=2)
    ts2 = tr.restore_slot(ts2, snap, other_rows)
    js2 = jr.restore_slot(js2, jsnap, jnp.asarray(other_rows, jnp.int32))
    _assert_same_tree(ts2, js2, f"{policy} restore")
    return tr


@pytest.mark.parametrize("merge", MERGES, ids=["merge_off", "merge_0.5"])
@pytest.mark.parametrize("policy", registered_policies())
def test_snapshot_walker_matches_reference(dit, policy, merge):
    """Two slots with CFG rows (4 state rows): slot 1's rows (1, 3) copied
    out and written into slot 0's (0, 2)."""
    tr = _walker_case(dit, policy, merge, 4, [1, 3], [0, 2])
    assert (tr.reducer is not None) == (merge is not None)


@pytest.mark.parametrize("extra", [0, 1], ids=["rows_eq_L", "rows_eq_L+1"])
@pytest.mark.parametrize("policy", ["fastcache", "smoothcache"])
def test_snapshot_walker_layer_collision(dit, policy, extra):
    """State rows equal to L or L + 1: the (L, B) gate trackers, the
    (L + 1, B, N, D) hidden stack and the (L, B, N, D) residuals take the
    batch on axis 1, the (B, ...) leaves on axis 0, as the reference's."""
    jcfg = dit[0]
    batch = jcfg.num_layers + extra
    assert slot_axis((jcfg.num_layers, batch), batch, jcfg.num_layers) == 1
    assert slot_axis((batch, 16, 128), batch, jcfg.num_layers) == 0
    _walker_case(dit, policy, None, batch, [batch - 1], [0])


# ---------------------------------------------------------------------------
# preempt / resume on both engines
# ---------------------------------------------------------------------------

def _preempt_script(eng, cls, on_hold=None):
    """The reference test's script with a third request: admit a and b,
    preempt b after 3 steps, let 2 steps pass, admit c (it takes b's slot),
    step once (a finishes), resume b in another slot, drain.  ``on_hold``
    runs while b is parked, after c's first step."""
    a, b, c = (cls(rid=i, label=i + 1, seed=10 + i, arrival_step=0,
                   num_steps=STEPS, guidance_scale=4.0) for i in range(3))
    assert eng.add_request(a) and eng.add_request(b)
    done = []
    for _ in range(3):
        done += eng.step()
    donor = eng.slots.index(b)
    assert eng.preempt(donor) is b
    assert b.steps_done == 3 and b.preemptions == 1
    assert eng.slots[donor] is None and b.snapshot is not None
    for _ in range(2):
        done += eng.step()
    assert eng.add_request(c) and eng.slots.index(c) == donor
    done += eng.step()
    if on_hold is not None:
        on_hold(b)
    assert eng.add_request(b) and b.snapshot is None
    assert eng.slots.index(b) != donor
    guard = 0
    while len(done) < 3:
        done += eng.step()
        guard += 1
        assert guard < 100
    eng.finalize_requests(done)
    return sorted(done, key=lambda r: r.rid)


@pytest.fixture(scope="module", params=MERGES, ids=["merge_off",
                                                    "merge_0.5"])
def preempted(dit, request):
    jeng, eng, noise = _engines(dit, slots=3, merge=request.param,
                                collectors=True)
    jdone = _preempt_script(jeng, JDiffusionRequest)
    held = {}

    def hold(b):
        held["kept"] = {k: v.clone() for k, v in _port_leaves(b.snapshot)}
        held["now"] = dict(_port_leaves(b.snapshot))

    done = _preempt_script(eng, DiffusionRequest, on_hold=hold)
    return request.param, jeng, jdone, eng, done, noise, held


# the requests whose latents are held to the reference's at LATENT_REL,
# by merge setting (see test_preempt_resume_matches_reference)
REFERENCE_LATENT_RIDS = {None: (0, 1), 0.5: (0, 1, 2)}


def test_preempt_resume_matches_reference(dit, preempted):
    """The three requests against the reference (counters and
    ``req.cache`` exact, latents at 1e-4); every request, c included,
    bitwise the port's own serve of the same three requests without a
    preemption, with the same counters and its own queue wait and
    preemption count.

    Merge off, c's latents (label 3, seed 12) miss the reference's by
    1.248e-4 of their scale, in this script and (bitwise the same) in
    the serve without a preemption, so only a and b are held to it there.
    The cause, measured op by op on the CPU with the reference's inputs
    fed to each op (the two tests below): ``timestep_embedding``'s
    frequency table ``exp(-ln(1e4) * i / 128)`` comes out of torch's
    ``exp`` and XLA's ``exp`` 1 ulp apart in 13-16 of its 128 entries
    (each within 1 ulp of the correctly rounded value); at t = 999 that
    is 3.05e-5 of the argument of cos / sin and 2.8e-5 of the embedding,
    and the cold step (t = 999) ends c 4.2e-5 of the latents' scale from
    the reference.  Fed the reference's state and latents, every later
    step agrees to 1.1e-6 (eps to 1.0e-5), but c's first warm step
    carries step 0's state error up to 1.13e-4.  With XLA's table patched
    in, the serve ends c at 4.05e-5.  At merge 0.5 c ends at 7.5e-6 and
    is held to the reference."""
    merge, jeng, jdone, eng, done, _, _ = preempted
    _same_requests(done, jdone, latent_rids=REFERENCE_LATENT_RIDS[merge])
    _, plain_eng, _ = _engines(dit, slots=3, merge=merge)
    plain = plain_eng.run([DiffusionRequest(
        rid=i, label=i + 1, seed=10 + i, arrival_step=0, num_steps=STEPS,
        guidance_scale=4.0) for i in range(3)])
    control = ("queue_wait_steps", "preemptions")
    for r, p in zip(done, sorted(plain, key=lambda q: q.rid)):
        np.testing.assert_array_equal(r.latents, p.latents,
                                      err_msg=f"rid={r.rid}")
        assert {k: v for k, v in r.cache.items() if k not in control} == \
            {k: v for k, v in p.cache.items() if k not in control}, r.rid
        assert (r.cache["queue_wait_steps"], r.cache["preemptions"]) == \
            (float(r.queue_wait_steps), float(r.preemptions)), r.rid
        assert (p.cache["queue_wait_steps"], p.cache["preemptions"]) == \
            (0.0, 0.0), r.rid
    for name in SLO_METRICS:
        assert eng.collector.totals().get(name, 0.0) == \
            jeng.collector.totals().get(name, 0.0), name
    assert eng.collector.totals()[tm.PREEMPTIONS] == 1
    assert eng.collector.totals()[tm.RESUMES] == 1


def _xla_frequency_table(half: int = 128) -> np.ndarray:
    """The reference's ``timestep_embedding`` frequency table as XLA
    computes it."""
    return np.asarray(jax.jit(lambda: jnp.exp(
        -np.log(10_000.0) * jnp.arange(half, dtype=jnp.float32) / half))())


def test_request_c_departs_at_the_frequency_table(dit, monkeypatch):
    """C1's cause, measured (ROADMAP, documented departures): torch's and
    XLA's ``exp`` give ``timestep_embedding``'s frequency table 1 ulp
    apart in some entries; with the port's own table request c of the
    three-request serve (no preemption) ends more than ``LATENT_REL``
    from the reference's latents, and with XLA's table patched into the
    port it ends within half of it."""
    from repro_torch.models import common
    xla = _xla_frequency_table()
    t = torch.tensor([999])
    own = common.timestep_embedding(t, 256)
    ulps = np.abs(torch.exp(-np.log(10_000.0) * torch.arange(
        128, dtype=torch.float32) / 128).numpy().view(np.int32)
        - xla.view(np.int32))
    assert 0 < ulps.max() <= 1

    def serve_c():
        jeng, eng, _ = _engines(dit, slots=3)
        reqs = [dict(rid=i, label=i + 1, seed=10 + i, arrival_step=0,
                     num_steps=STEPS, guidance_scale=4.0) for i in range(3)]
        want = {r.rid: r for r in jeng.run([JDiffusionRequest(**q)
                                            for q in reqs])}[2]
        got = {r.rid: r for r in eng.run([DiffusionRequest(**q)
                                          for q in reqs])}[2]
        w = np.asarray(want.latents)
        return float(np.abs(got.latents - w).max() / np.abs(w).max())

    assert serve_c() > LATENT_REL
    table = torch.from_numpy(xla)

    def xla_embedding(t, dim, max_period=10_000.0):
        args = t.to(torch.float32)[:, None] * table[None].to(t.device)
        return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)

    monkeypatch.setattr(common, "timestep_embedding", xla_embedding)
    assert float((xla_embedding(t, 256) - own).abs().max()) > 1e-5
    assert serve_c() < LATENT_REL / 2


def test_request_c_agrees_step_by_step_given_the_references_inputs(dit):
    """The three requests stepped through both packages' ``denoise_step``
    (the engine's step core; fastcache, merge off, per-sample guidance
    4.0): the cold step 0 (t = 999) ends every request within 5e-5 of the
    reference's latents' scale (4.2e-5 for c); fed the reference's state
    and latents before each later step, every step agrees within 2e-6
    (eps within 2e-5), and yet c's own chain leaves ``LATENT_REL`` (1.13e-4
    after its first warm step)."""
    from repro.diffusion import sampler as jsampler
    from repro.diffusion import schedule as jschedule
    from repro_torch.core import statcache
    from repro_torch.diffusion import sampler, schedule
    jcfg, jmodel, jparams, model = dit
    jr = JCachedDiT(jmodel, _fc(None, True))
    tr = CachedDiT(model, _fc(None))
    _, _, noise = _engines(dit, slots=3)
    x0 = np.stack([noise(DiffusionRequest(rid=i, label=i + 1,
                                          seed=10 + i)).numpy()
                   for i in range(3)])
    labels, g = np.array([1, 2, 3], np.int32), np.full(3, 4.0, np.float32)
    jsched = jschedule.linear_schedule(1000)
    tsched = schedule.linear_schedule(1000, device="cpu")
    ts = np.asarray(jschedule.ddim_timesteps(1000, STEPS))
    tp = np.concatenate([ts[1:], [-1]]).astype(np.int32)

    def rel(a, b):
        return np.abs(a - b).max(axis=(1, 2, 3)) / np.abs(b).max(
            axis=(1, 2, 3))

    def port_state(js):
        st = tr.init_state(6)
        for k in ("prev_tokens_in", "prev_hidden", "have_cache"):
            st[k] = torch.from_numpy(np.array(js[k]))
        st["gate"] = statcache.GateState(
            sigma2=torch.from_numpy(np.array(js["gate"].sigma2)),
            initialized=torch.from_numpy(np.array(js["gate"].initialized)))
        return st

    jx, js = jnp.asarray(x0), jr.init_state(6)
    x, st = torch.from_numpy(x0), tr.init_state(6)
    own, fed = [], []
    for i in range(STEPS):
        args = (np.full(3, ts[i], np.int32), np.full(3, tp[i], np.int32),
                labels)
        fx, _, feps = sampler.denoise_step(
            tr, tsched, port_state(js), torch.from_numpy(np.array(jx)),
            *map(torch.from_numpy, args), guidance_scale=torch.from_numpy(g),
            return_eps=True)
        jx, js, jeps = jsampler.denoise_step(
            jr, jparams, jsched, js, jx, *map(jnp.asarray, args),
            guidance_scale=jnp.asarray(g), return_eps=True)
        x, st = sampler.denoise_step(tr, tsched, st, x,
                                     *map(torch.from_numpy, args),
                                     guidance_scale=torch.from_numpy(g))
        want = np.asarray(jx)
        own.append(rel(x.numpy(), want))
        fed.append((rel(fx.numpy(), want),
                    rel(feps.numpy(), np.asarray(jeps))))
    assert own[0].max() < 5e-5
    for i in range(1, STEPS):
        assert fed[i][0].max() < 2e-6 and fed[i][1].max() < 2e-5, (i, fed[i])
    assert own[1][2] > LATENT_REL and own[-1][2] > LATENT_REL
    assert own[-1][:2].max() < LATENT_REL


def test_snapshot_survives_admission_into_donor_slot(preempted):
    """c was admitted into b's slot and stepped once before b resumed:
    b's snapshot still held the values it was taken with."""
    held = preempted[-1]
    assert held["kept"]
    for key, leaf in held["now"].items():
        assert torch.equal(leaf, held["kept"][key]), key


def test_preempted_requests_replay_solo_bitwise(dit, preempted):
    """a and b, the victim included, replay their solo ``sample()`` runs
    exactly under per-sample guidance rows, counters too."""
    merge, _, _, _, done, noise, _ = preempted
    model = dit[3]
    for r in done[:2]:
        solo = CachedDiT(model, _fc(merge))
        x, state = sample(solo, batch=1, labels=torch.tensor([r.label]),
                          num_steps=r.num_steps,
                          guidance_scale=torch.tensor([r.guidance_scale]),
                          x_init=noise(r)[None])
        np.testing.assert_array_equal(x[0].numpy(), r.latents,
                                      err_msg=f"rid={r.rid}")
        want = {k: float(v.sum()) for k, v in state["stats"].items()
                if v.dim() == 1}
        # a and b arrive at step 0 and are admitted at once; b is the victim
        want["queue_wait_steps"] = 0.0
        want["preemptions"] = float(r.rid == 1)
        assert r.cache == want, r.rid


def test_preempt_empty_slot_and_reset_clock_raise(dit):
    _, eng, _ = _engines(dit, slots=2)
    with pytest.raises(ValueError):
        eng.preempt(0)
    eng.add_request(DiffusionRequest(rid=0, label=1, num_steps=2))
    with pytest.raises(ValueError):
        eng.reset_clock()
    eng.step()
    eng.step()
    eng.reset_clock()
    assert (eng.clock, eng.model_steps) == (0, 0)
    assert float(eng._acc_vec.abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# the SLO scheduler and the router against the reference's
# ---------------------------------------------------------------------------

SLO_TRACE = dict(priority_mix=[0, 1, 1, 2], deadline_slack_mix=[6, 12, 30])
SEGMENTS = [(4, 0.3), (12, 2.0), (10 ** 9, 0.3)]


def _slo_run(eng, cls_adm, cls_ctl, cls_sched, trace, on_miss):
    adm = cls_adm(eng, on_miss=on_miss, defer_steps=2,
                  collector=eng.collector)
    ctl = cls_ctl(high_watermark=4, low_watermark=1, patience=2,
                  collector=eng.collector)
    sched = cls_sched(eng, sched_policy="edf", admission=adm,
                      controller=ctl)
    done = sched.run(trace)
    return sched, done


@pytest.mark.parametrize("on_miss", ["reject", "defer"])
def test_slo_scheduler_matches_reference(dit, on_miss):
    jcfg = dit[0]
    jeng, eng, _ = _engines(dit, slots=2, collectors=True)
    ncls = jcfg.dit.num_classes
    jtrace = jpoisson_trace(14, 0.3, seed=0, num_classes=ncls,
                            rate_fn=jpiecewise_rate(SEGMENTS), **SLO_TRACE)
    trace = poisson_trace(14, 0.3, seed=0, num_classes=ncls,
                          rate_fn=piecewise_rate(SEGMENTS), **SLO_TRACE)
    jsched, jdone = _slo_run(jeng, JAdmissionController,
                             JDegradationController, JSLOScheduler, jtrace,
                             on_miss)
    sched, done = _slo_run(eng, AdmissionController, DegradationController,
                           SLOScheduler, trace, on_miss)
    _same_requests(done, jdone)
    assert [(r.rid, r.reject_reason) for r in sched.rejected] == \
        [(r.rid, r.reject_reason) for r in jsched.rejected]
    _same_requests(sched.rejected, jsched.rejected, latents=False)
    assert sched.admission._defers == jsched.admission._defers
    assert sched.controller.level_idx == jsched.controller.level_idx
    assert eng.clock == jeng.clock and eng.model_steps == jeng.model_steps
    totals, jtotals = eng.collector.totals(), jeng.collector.totals()
    for name in SLO_METRICS:
        assert totals.get(name, 0.0) == jtotals.get(name, 0.0), name
    assert eng.collector._gauges.keys() >= {"shed_level",
                                            "queue_depth_class_1"}
    for k, v in eng.collector._gauges.items():
        assert jeng.collector._gauges[k] == v, k
    h, jh = (c._hist[tm.QUEUE_DEPTH] for c in (eng.collector,
                                               jeng.collector))
    np.testing.assert_array_equal(h["bucket"], np.asarray(jh["bucket"]))
    # the trace exercises every decision
    assert totals[tm.PREEMPTIONS] >= 1
    assert totals[tm.RESUMES] == totals[tm.PREEMPTIONS]
    assert sched.rejected and any(r.num_steps < STEPS for r in done)
    if on_miss == "defer":
        assert sched.admission._defers
    # the step timer folded every step into the EMA (host clock here)
    assert sched.timer.count == eng.clock
    assert sched.admission.predictor.model_step_ms > 0.0


def test_step_timer_on_cpu_reads_the_host_clock():
    timer = StepTimer(torch.device("cpu"))
    timer.start()
    timer.stop()
    timer.start()
    timer.stop()
    got = timer.poll()
    assert len(got) == 2 and all(ms >= 0.0 for ms in got)
    assert timer.poll() == [] and timer.count == 2


ROUTER_TRACE = ((0, 1, 30, 4, 1, 0), (1, 2, 31, 4, 1, 0),
                (2, 3, 32, 4, 0, 1), (3, 4, 33, 4, 0, 1))


def test_router_matches_reference(dit):
    """Two one-slot replicas, class 0 pinned to replica 1: dispatch,
    affinity and every request's clock stamps as the reference's."""
    pairs = [_engines(dit, slots=1) for _ in range(2)]

    def trace(cls):
        return [cls(rid=rid, label=label, seed=seed, arrival_step=arr,
                    num_steps=n, guidance_scale=4.0, priority=prio)
                for rid, label, seed, n, prio, arr in ROUTER_TRACE]

    jrouter = JReplicaRouter([JSLOScheduler(p[0], sched_policy="edf")
                              for p in pairs], affinity={0: 1})
    router = ReplicaRouter([SLOScheduler(p[1], sched_policy="edf")
                            for p in pairs], affinity={0: 1})
    jdone = jrouter.run(trace(JDiffusionRequest))
    with pytest.raises(TypeError):
        router.run(RequestQueue(trace(DiffusionRequest)))
    done = router.run(trace(DiffusionRequest))
    assert router.dispatched == jrouter.dispatched
    assert {router.dispatched[0], router.dispatched[1]} == {0, 1}
    assert router.dispatched[2] == router.dispatched[3] == 1
    assert [r.rid for r in done] == [r.rid for r in jdone]
    _same_requests(done, jdone)
    with pytest.raises(ValueError):
        ReplicaRouter([])
    with pytest.raises(TypeError):
        ReplicaRouter([object()])


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_serve_diffusion_slo_on_cpu(capsys):
    serve_diffusion.main([
        "--device", "cpu", "--reduced", "--requests", "12", "--slots", "2",
        "--steps", "6", "--rate", "0.3", "--slo", "--sched", "edf",
        "--priority-mix", "0,1,1,2", "--deadline-slack-mix", "8,14,30",
        "--burst-rate", "2", "--burst-start", "4", "--burst-len", "8",
        "--shed", "--shed-high", "4", "--shed-low", "1", "--json"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["sched_policy"] == "edf"
    assert set(out["by_class"]) == {"0", "1", "2"}
    for row in out["by_class"].values():
        assert {"queue_wait_p50", "preemptions", "requests"} <= set(row)
    slo = out["slo"]
    total = sum(row["requests"] for row in out["by_class"].values())
    assert total == 12 and out["finished"] + slo["rejected"] == 12
    assert slo["preemptions"] >= 1 and slo["shed"] is True
    assert slo["step_ms_mean"] > 0.0


def test_slo_modules_leave_jax_unloaded():
    """The plane imports neither JAX nor the reference package."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = ("import sys, repro_torch.serving, repro_torch.serving.slo; "
            "assert 'jax' not in sys.modules; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules)")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
