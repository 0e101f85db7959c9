"""The port's ``ShardedDiffusionEngine`` on ``gloo`` ranks on the CPU, at
the reference's reduced dit-b2 (``dit-smoke``, f32, 4 heads, d_ff 512),
after the reference's ``tests/test_sharded_serving.py``.

Each mesh is one spawn of ``data * model`` rank processes
(``tests/torch_sharded_ranks.py``) serving every scenario of the mesh in
turn; the requests draw the reference's initial noise.

- ``(1, 1)``: bitwise the port's single-device engine for all eight
  policies, CFG rows on and off; async admission bitwise sync admission;
  1 + L host syncs per warm fastcache step and one completion fetch per
  run.
- ``data = 2``, ``model = 2`` and ``(2, 2)``: the same (request, slot,
  step) trace, the same request and engine counters, exactly, and
  latents within ``LATENT_REL`` (1e-4) of their scale of the reference's
  single-device engine, for fastcache (mixed plans, a longer plan that
  skips blocks, token merging at r 0.5 / window 8, lockstep) and fora;
  the mixed plans replay solo within ``LATENT_REL``; the device metrics
  summed over ``data`` equal the port's single-device engine's; preempt
  and resume across ranks match the port's unpreempted serve.
- ``model = 2``: the numerics self-check passes, and fails on every rank
  when the blocks skip their all-reduce.
"""
import tests.torch_threads  # noqa: F401  (first: one thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FastCacheConfig as JFastCacheConfig
from repro.core import CachedDiT as JCachedDiT
from repro.serving import DiffusionServingEngine as JEngine
from repro.serving import poisson_trace as jpoisson_trace
from repro_torch.configs.base import FastCacheConfig
from repro_torch.core.policies.base import registered_policies
from repro_torch.core.runner import CachedDiT
from repro_torch.diffusion.sampler import sample
from repro_torch.obs.metrics import MetricsCollector
from repro_torch.serving.diffusion_engine import DiffusionServingEngine
from repro_torch.serving.scheduler import (DiffusionRequest, SamplingPlan,
                                           poisson_trace)
from tests.test_torch_model import jax_dit, port_dit
from tests.test_torch_serving import LATENT_REL
from tests.torch_sharded_ranks import MeshRun, slo_run, slo_trace

TRACE_MIX = dict(num_requests=5, rate=0.5, seed=3, steps_mix=(4, 6),
                 guidance_mix=(1.0, 4.0))
TRACE_LONG = dict(num_requests=5, rate=0.5, seed=3)
TRACE_NOCFG = dict(num_requests=5, rate=0.5, seed=3, steps_mix=(4, 6))
BASE = dict(kind="run", policy="fastcache", slots=4, steps=6, max_steps=6,
            guidance=4.0, trace=TRACE_MIX)
L2C_MASK = np.array([True, False])

# the multi-rank scenarios, each held to the reference's engine
REFERENCED = {
    "mixed": dict(collector=True),
    "long": dict(steps=12, max_steps=12, trace=TRACE_LONG),
    "fora": dict(policy="fora"),
    "merge": dict(merge=(0.5, 8)),
    "lockstep": dict(lockstep=True),
}
MESHES = ((2, 1), (1, 2), (2, 2))
PREEMPT_STEPS = 6
# the SLO plane's calm -> burst -> calm trace (tests/test_torch_slo.py's)
SLO_TRACE = dict(num_requests=14, rate=0.3, seed=0,
                 segments=[(4, 0.3), (12, 2.0), (10 ** 9, 0.3)],
                 priority_mix=[0, 1, 1, 2], deadline_slack_mix=[6, 12, 30])


def _sc(name, **kw):
    return dict(BASE, name=name, **kw)


def _multi_scenarios(topo):
    out = [_sc(k, **v) for k, v in REFERENCED.items()]
    out.append(_sc("sync", async_admission=False))
    out.append(_sc("preempt", kind="preempt", steps=PREEMPT_STEPS))
    out.append(_sc("admit", kind="admit"))
    if topo[0] > 1:
        out.append(_sc("slo", kind="slo", trace=SLO_TRACE))
    if topo == (1, 2):
        out.append(_sc("bad_reduce", kind="bad_reduce"))
    return out


def _one_scenarios():
    out = []
    for pol in registered_policies():
        kw = {"policy_kwargs": {"l2c_mask": L2C_MASK}} if pol == "l2c" else {}
        out.append(_sc(f"{pol}-cfg", policy=pol, single=True, **kw))
        out.append(_sc(f"{pol}-nocfg", policy=pol, single=True,
                       cfg_rows=False, guidance=1.0, trace=TRACE_NOCFG, **kw))
    out.append(_sc("mixed"))
    out.append(_sc("sync", async_admission=False))
    out.append(_sc("long", steps=12, max_steps=12, trace=TRACE_LONG,
                   single=True))
    return out


def _jax_run(jmodel, jparams, sc):
    merge = sc.get("merge")
    fc = (JFastCacheConfig(merge_enabled=True, merge_ratio=merge[0],
                           merge_window=merge[1])
          if merge else JFastCacheConfig())
    jeng = JEngine(JCachedDiT(jmodel, fc, policy=sc["policy"]), jparams,
                   max_slots=sc["slots"], num_steps=sc["steps"],
                   max_steps=sc["max_steps"],
                   guidance_scale=sc["guidance"], enable_metrics=False)
    done = jeng.run(jpoisson_trace(num_classes=10, **sc["trace"]),
                    lockstep=sc.get("lockstep", False))
    return jeng, {r.rid: r for r in done}, jeng.cache_stats()


@pytest.fixture(scope="module")
def world():
    """The port's model, the reference's runs and the port's
    single-device runs of each referenced scenario, the initial noise,
    and every mesh's ranks' results (the ranks serve while the reference
    runs)."""
    jcfg, jmodel, jparams = jax_dit("smoke")
    model = port_dit(jcfg, jparams)
    seeds = {r.seed for tr in (TRACE_MIX, TRACE_LONG)
             for r in poisson_trace(num_classes=10, **tr)} | {10, 11, 12}
    seeds |= {r.seed for r in slo_trace(**SLO_TRACE)}
    img, ch = jcfg.dit.image_size, jcfg.dit.in_channels
    noise = {s: np.asarray(jax.random.normal(jax.random.PRNGKey(s),
                                             (img, img, ch), jnp.float32))
             for s in seeds}
    weights = {"cfg": model.cfg,
               "params": {k: v.numpy().copy()
                          for k, v in model.state_dict().items()}}
    jobs = {(1, 1): _one_scenarios()}
    jobs.update({topo: _multi_scenarios(topo) for topo in MESHES})
    ranks = MeshRun(jobs, weights, noise)
    refs = {}
    try:
        for name, kw in REFERENCED.items():
            sc = _sc(name, **kw)
            jeng, jdone, jstats = _jax_run(jmodel, jparams, sc)
            assert all(np.array_equal(np.asarray(jeng.request_noise(r)),
                                      noise[r.seed]) for r in jdone.values())
            refs[name] = (jdone, jstats, _port_single(model, sc, noise))
    finally:
        results = ranks.results()       # no rank outlives the fixture
    return model, refs, noise, results


def _port_single(model, sc, noise):
    """The port's single-device engine on a scenario: {rid: request}."""
    merge = sc.get("merge")
    fc = (FastCacheConfig(merge_enabled=True, merge_ratio=merge[0],
                          merge_window=merge[1])
          if merge else FastCacheConfig())
    eng = DiffusionServingEngine(
        CachedDiT(model, fc, policy=sc["policy"]), max_slots=sc["slots"],
        num_steps=sc["steps"], max_steps=sc["max_steps"],
        guidance_scale=sc["guidance"], noise_fn=_noise_fn(noise))
    done = eng.run(poisson_trace(num_classes=10, **sc["trace"]),
                   lockstep=sc.get("lockstep", False))
    return {r.rid: r for r in done}


def _noise_fn(noise):
    return lambda r: torch.from_numpy(noise[r.seed].copy())


def _close(got, want, what):
    np.testing.assert_allclose(
        got, want, rtol=0, atol=LATENT_REL * float(np.abs(want).max()),
        err_msg=what)


# ---------------------------------------------------------------------------
# (1, 1): the single-device engine, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", ["cfg", "nocfg"])
@pytest.mark.parametrize("policy", registered_policies())
def test_one_by_one_is_the_single_device_engine(world, policy, cfg):
    res = world[3][(1, 1)][0][f"{policy}-{cfg}"]
    assert res["topology"] == {"data": 1, "model": 1, "devices": 1,
                               "backend": "gloo"}
    assert res["single_equal"], (policy, cfg)


def test_one_by_one_async_admission_is_sync(world):
    res = world[3][(1, 1)][0]
    a, b = res["mixed"]["requests"], res["sync"]["requests"]
    assert sorted(a) == sorted(b)
    for rid in a:
        np.testing.assert_array_equal(a[rid]["latents"], b[rid]["latents"])
        assert a[rid]["cache"] == b[rid]["cache"]
    assert res["mixed"]["stats"] == res["sync"]["stats"]


def test_one_by_one_host_syncs(world):
    """L host reads per warm fastcache step (one all-cache test per layer:
    the sharded engine stays eager), none per cold or mixed step (the step
    kind comes from the host mirror), and one completion fetch per run with
    async admission; sync admission fetches at each completion step."""
    res = world[3][(1, 1)][0]
    long_ = res["long"]
    kinds, L = long_["step_kinds"], world[0].cfg.num_layers
    assert kinds["warm"] > 0 and long_["stats"]["blocks_skipped"] > 0
    assert long_["policy_syncs"] == L * kinds["warm"]
    assert long_["engine_syncs"] == 1
    finishes = {r["finish"] for r in res["sync"]["requests"].values()}
    assert res["sync"]["engine_syncs"] == len(finishes)


# ---------------------------------------------------------------------------
# data = 2, model = 2, (2, 2): the reference's single-device engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(REFERENCED))
@pytest.mark.parametrize("topo", MESHES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_mesh_matches_reference(world, topo, name):
    """Every rank: the reference's schedule and counters exactly, latents
    within LATENT_REL of their scale, and of the port's single-device
    engine's.  The 12-step plan (``long``) is held to the port's engine
    only: there the port's own single-device latents are up to 3.8e-4 of
    their scale from the reference's (the x0 prediction divides eps by
    sqrt(alpha_bar), and a longer plan goes further down), which
    ``tests/test_torch_serving.py``'s 4-6-step traces do not reach."""
    jdone, jstats, single = world[1][name]
    for rank, res in enumerate(world[3][topo]):
        got = res[name]
        assert (got["topology"]["data"], got["topology"]["model"]) == topo
        assert sorted(got["requests"]) == sorted(jdone)
        for rid, r in got["requests"].items():
            jr = jdone[rid]
            what = f"{topo} rank {rank} {name} rid={rid}"
            assert (r["admit"], r["finish"], r["num_steps"],
                    r["guidance"]) == (jr.admit_step, jr.finish_step,
                                       jr.num_steps, jr.guidance_scale), what
            assert r["cache"] == jr.cache, what
            _close(r["latents"], single[rid].latents, what + " (port)")
            if name != "long":
                _close(r["latents"], np.asarray(jr.latents), what)
        for k in ("engine_steps", "model_steps", "blocks_skipped",
                  "blocks_computed", "steps_reused", "block_cache_ratio",
                  "per_slot_blocks_skipped", "per_slot_blocks_computed"):
            assert got["stats"][k] == jstats[k], (topo, rank, name, k)


@pytest.mark.parametrize("topo", MESHES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_mesh_layout(world, topo):
    """Data rank d owns slots [d * S/data, (d+1) * S/data); the model
    ranks of a data index hold the same ones; the long plan skips."""
    data, model = topo
    for rank, res in enumerate(world[3][topo]):
        n, lo = res["mixed"]["window"]
        assert (n, lo) == (4 // data, (rank // model) * (4 // data))
        assert res["mixed"]["topology"] == {"data": data, "model": model,
                                            "devices": data * model,
                                            "backend": "gloo"}
    assert world[1]["long"][1]["blocks_skipped"] > 0
    assert world[1]["fora"][1]["steps_reused"] > 0


@pytest.mark.parametrize("topo", MESHES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_mesh_async_admission_is_sync(world, topo):
    for res in world[3][topo]:
        a, b = res["mixed"]["requests"], res["sync"]["requests"]
        for rid in a:
            np.testing.assert_array_equal(a[rid]["latents"],
                                          b[rid]["latents"])
            assert a[rid]["cache"] == b[rid]["cache"]
        assert res["mixed"]["engine_syncs"] == 1


@pytest.mark.parametrize("topo", MESHES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_mesh_mixed_plans_replay_solo(world, topo):
    """Each request of the mixed-plan trace against its own solo
    ``sample()`` run under per-sample guidance rows."""
    model, _, noise, results = world
    got = results[topo][0]["mixed"]["requests"]
    assert {r["num_steps"] for r in got.values()} == {4, 6}
    assert {r["guidance"] for r in got.values()} == {1.0, 4.0}
    for rid, r in got.items():
        x, _ = sample(CachedDiT(model, FastCacheConfig()), batch=1,
                      labels=torch.tensor([r["label"]]),
                      num_steps=r["num_steps"],
                      guidance_scale=torch.tensor([r["guidance"]]),
                      x_init=torch.from_numpy(noise[r["seed"]].copy())[None])
        _close(r["latents"], x[0].numpy(), f"{topo} rid={rid}")


@pytest.mark.parametrize("topo", MESHES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_mesh_metrics_sum_over_data(world, topo):
    """The harvested device metrics (counters, histograms, per-slot
    leaves) equal the port's single-device engine's on the same trace."""
    model, _, noise, results = world
    col = MetricsCollector()
    eng = DiffusionServingEngine(CachedDiT(model, FastCacheConfig()),
                                 max_slots=4, num_steps=6, max_steps=6,
                                 noise_fn=_noise_fn(noise), collector=col)
    eng.run(poisson_trace(num_classes=10, **TRACE_MIX))
    want = col.windows[-1]
    for rank, res in enumerate(results[topo]):
        got = res["mixed"]["metrics"]
        assert got["counters"] == want["counters"], (topo, rank)
        assert got["per_slot"] == want["per_slot"], (topo, rank)
        for name, h in want["histograms"].items():
            g = got["histograms"][name]
            assert g["bucket_counts"] == h["bucket_counts"], (topo, name)
            assert g["count"] == h["count"], (topo, name)
            np.testing.assert_allclose(g["sum"], h["sum"], rtol=1e-6)


@pytest.mark.parametrize("topo", ((2, 1), (2, 2)),
                         ids=lambda t: f"{t[0]}x{t[1]}")
def test_mesh_preempt_resume_across_ranks(world, topo):
    """The victim resumes in another data rank's slot; every request
    matches the port's single-device serve of the same three requests
    without a preemption (counters exactly, but the victim's preemption
    count)."""
    model, _, noise, results = world
    eng = DiffusionServingEngine(CachedDiT(model, FastCacheConfig()),
                                 max_slots=4, num_steps=PREEMPT_STEPS,
                                 max_steps=PREEMPT_STEPS,
                                 noise_fn=_noise_fn(noise))
    reqs = [DiffusionRequest(rid=i, label=i + 1, seed=10 + i,
                             arrival_step=0, num_steps=PREEMPT_STEPS,
                             guidance_scale=4.0) for i in range(3)]
    want = {r.rid: r for r in eng.run(reqs)}
    for rank, res in enumerate(results[topo]):
        got = res["preempt"]
        n = got["window"][0]
        assert got["donor"] // n != got["resumed"] // n   # another rank's
        for rid, r in got["requests"].items():
            what = f"{topo} rank {rank} rid={rid}"
            _close(r["latents"], want[rid].latents, what)
            cache = dict(r["cache"])
            assert cache.pop("preemptions") == float(rid == 1), what
            wcache = dict(want[rid].cache)
            wcache.pop("preemptions")
            cache.pop("queue_wait_steps")
            wcache.pop("queue_wait_steps")
            assert cache == wcache, what


def test_model_axis_numerics_check(world):
    """The self-check runs by default on model > 1 and passes (the
    engines above were built); blocks that skip their all-reduce make it
    raise on every rank."""
    for res in world[3][(1, 2)]:
        msg = res["bad_reduce"]["raised"]
        assert msg is not None and "numerics self-check failed" in msg


@pytest.mark.parametrize("topo", ((2, 1), (2, 2)),
                         ids=lambda t: f"{t[0]}x{t[1]}")
def test_mesh_slo_plane(world, topo):
    """SLOScheduler over the sharded engine (EDF, deadline-aware
    admission, the shed ladder, preemption across data ranks) decides as
    over the port's single-device engine: the same admissions, finishes,
    rejections and preemptions, request counters exactly, latents within
    LATENT_REL."""
    model, _, noise, results = world
    eng = DiffusionServingEngine(CachedDiT(model, FastCacheConfig()),
                                 max_slots=4, num_steps=6, max_steps=6,
                                 noise_fn=_noise_fn(noise),
                                 collector=MetricsCollector())
    done, rejected = slo_run(eng, slo_trace(**SLO_TRACE))
    want = {r.rid: r for r in done}
    assert sum(r.preemptions for r in done) >= 1 and rejected
    for rank, res in enumerate(results[topo]):
        got = res["slo"]
        assert got["rejected"] == [(r.rid, r.reject_reason)
                                   for r in rejected]
        assert got["preemptions"] == {r.rid: r.preemptions for r in done}
        assert (got["clock"], got["model_steps"]) == (eng.clock,
                                                      eng.model_steps)
        assert sorted(got["requests"]) == sorted(want)
        for rid, r in got["requests"].items():
            what = f"{topo} rank {rank} rid={rid}"
            assert (r["admit"], r["finish"]) == (want[rid].admit_step,
                                                 want[rid].finish_step)
            assert r["cache"] == want[rid].cache, what
            _close(r["latents"], want[rid].latents, what)


@pytest.mark.parametrize("topo", MESHES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_mesh_admission_lands_in_the_owners_slot(world, topo):
    """Three requests admitted into slots 0, 1, 2 with their own plans:
    each rank's device slots hold the noise and plan rows of the requests
    in the global slots it owns, and nothing in the others."""
    _, _, noise, results = world
    plans = {0: (10, 4, 4.0), 1: (11, 6, 1.0), 2: (12, 5, 2.0)}
    for rank, res in enumerate(results[topo]):
        got = res["admit"]
        for i, s in enumerate(got["slots"]):
            what = f"{topo} rank {rank} slot {s}"
            if s not in plans:
                assert not got["x"][i].any(), what
                continue
            seed, n, g = plans[s]
            np.testing.assert_array_equal(got["x"][i], noise[seed],
                                          err_msg=what)
            ts, ts_prev = SamplingPlan(n, g).rows(6)
            np.testing.assert_array_equal(got["ts"][i], ts, err_msg=what)
            np.testing.assert_array_equal(got["ts_prev"][i], ts_prev,
                                          err_msg=what)
            assert got["guidance"][i] == g, what
