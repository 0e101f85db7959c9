"""The port's six baseline cache policies (fora, teacache, adacache,
fbcache, l2c, smoothcache) against a live run of the reference's.

Step parity: both runners see the same inputs at every step, the latents
advanced with the reference's eps (x <- x - 0.05 * eps) as in
test_torch_fastcache.py, so a divergence shows where it starts.  Per-step
counters (``steps_reused`` included) and every integer or bool leaf of the
state must be equal exactly; eps is held to the block tolerance of
test_torch_model.py (rtol 1e-4, atol 1e-3).  The float state leaves are held
to a relative L2 error of 1e-4: smoothcache's cached residuals reach ~23 on
the 3-layer config, where a block's f32 error (relative L2 ~3e-5 in
test_torch_model.py) is ~2.6e-3 absolute.  Merge off on both small configs,
and token merging at 0.5 (window 8) on the smoke DiT.

Served trace: ``tests/golden/generate.py:serving_trace`` (mid-flight
admission, mixed plans, guidance 1.0 rows) through both engines with the
reference's noise: plan rows and counters exact, latents within
``LATENT_REL`` of their scale (test_torch_serving.py).

l2c runs with a one-layer mask from ``l2c_mask_from_deltas``; smoothcache
with the default schedule and with an interval-3 one.
"""
import tests.torch_threads  # noqa: F401  (first: one thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core
from repro.configs.base import FastCacheConfig as JFastCacheConfig
from repro.core import CachedDiT as JCachedDiT
from repro.core import l2c_mask_from_deltas as jl2c_mask_from_deltas
from repro.serving import DiffusionServingEngine as JEngine
from repro_torch.configs.base import FastCacheConfig
from repro_torch.core import saliency
from repro_torch.core.policies import fastcache
from repro_torch.core.policies.base import (registered_policies,
                                            summarize_stats)
from repro_torch.core.policies.smoothcache import (
    default_smooth_schedule, smooth_schedule_from_errors)
from repro_torch.core.runner import CachedDiT, l2c_mask_from_deltas
from repro_torch.cuda_kernels.linear_blend import linear_blend
from repro_torch.cuda_kernels.saliency_delta import saliency_delta
from repro_torch.serving.diffusion_engine import DiffusionServingEngine
from repro_torch.serving.scheduler import DiffusionRequest
from tests.golden.generate import SERVE_STEPS, serving_trace
from tests.test_policies import EXPECTED_STATE
from tests.test_torch_model import (BLOCK_TOL, SMALL_CONFIGS, jax_dit, np32,
                                    port_dit, t32)
from tests.test_torch_serving import LATENT_REL

NEW = ("fora", "teacache", "adacache", "fbcache", "l2c", "smoothcache")
STEPS = 6
SHRINK = 0.05
STATE_REL_L2 = 1e-4
COUNTERS = ("blocks_computed", "blocks_skipped", "steps_reused",
            "motion_frac_sum")
# per-layer deltas for l2c's calibration: layer 1 moves the stream least
DELTAS = np.array([0.3, 0.1, 0.2], np.float32)


@pytest.fixture(scope="module", params=SMALL_CONFIGS)
def pair(request):
    jcfg, jmodel, jparams = jax_dit(request.param)
    return jcfg, jmodel, jparams, port_dit(jcfg, jparams)


def _kwargs(policy, num_layers, variant=""):
    """The same constructor knobs for both runners: numpy arrays, which
    both packages accept."""
    if policy == "l2c":
        return {"l2c_mask": np.asarray(jl2c_mask_from_deltas(
            jnp.asarray(DELTAS[:num_layers]), 1))}
    if policy == "smoothcache" and variant == "interval3":
        return {"smooth_schedule": default_smooth_schedule(num_layers,
                                                           interval=3)}
    return {}


def _fc(merge, jax_side=False):
    cls = JFastCacheConfig if jax_side else FastCacheConfig
    if merge is None:
        return cls()
    return cls(merge_enabled=True, merge_ratio=merge, merge_window=8)


def _assert_state_matches(ts, js, policy, step):
    for k, jv in js.items():
        if k in ("stats", "tokred"):
            continue
        tv, jv = ts[k], np.asarray(jv)
        got = tv.float().numpy() if tv.dtype == torch.bfloat16 else tv.numpy()
        msg = f"{policy}: state {k} at step {step}"
        if jv.dtype.kind in "biu":
            np.testing.assert_array_equal(got, jv, err_msg=msg)
        else:
            err = np.linalg.norm(got - jv.astype(np.float32))
            assert err <= STATE_REL_L2 * np.linalg.norm(jv), (msg, err)


def _drive(jcfg, jmodel, jparams, model, policy, merge, variant=""):
    kw = _kwargs(policy, jcfg.num_layers, variant)
    jr = JCachedDiT(jmodel, _fc(merge, True), policy=policy, **kw)
    tr = CachedDiT(model, _fc(merge), policy=policy, **kw)
    assert tr.impl.n_tokens == jr.impl.n_tokens
    b = 4
    rng = np.random.default_rng(0)
    img, ch = jcfg.dit.image_size, jcfg.dit.in_channels
    x = rng.standard_normal((b, img, img, ch)).astype(np.float32)
    labels = np.array([1, 2, 3, 4], np.int32)
    js, ts = jr.init_state(b), tr.init_state(b)
    jstep = jax.jit(jr.step)
    for i in range(STEPS):
        t = np.full((b,), 50 - i, np.int32)
        je, js = jstep(jparams, js, jnp.asarray(x), jnp.asarray(t),
                       jnp.asarray(labels))
        te, ts = tr.step(ts, t32(x), t32(t), t32(labels))
        for k in COUNTERS:
            np.testing.assert_array_equal(
                np32(ts["stats"][k]), np32(js["stats"][k]),
                err_msg=f"{policy}: counter {k} diverges at step {i}")
        _assert_state_matches(ts, js, policy, i)
        np.testing.assert_allclose(np32(te), np32(je), **BLOCK_TOL,
                                   err_msg=f"{policy}: eps at step {i}")
        x = x - SHRINK * np32(je)
    return tr, ts


@pytest.mark.parametrize("policy", NEW)
def test_cached_step_matches_reference(pair, policy):
    jcfg, jmodel, jparams, model = pair
    tr, ts = _drive(jcfg, jmodel, jparams, model, policy, None)
    s = summarize_stats(ts)
    assert s["steps"] == STEPS
    if policy in ("fora", "smoothcache", "l2c"):   # positional gates fire
        assert s["blocks_skipped"] > 0, s


@pytest.mark.parametrize("policy", NEW)
def test_merged_cached_step_matches_reference(policy):
    jcfg, jmodel, jparams = jax_dit("smoke")
    model = port_dit(jcfg, jparams)
    tr, ts = _drive(jcfg, jmodel, jparams, model, policy, 0.5)
    assert tr.reducer is not None
    assert float(ts["stats"]["tokens_kept"].sum()) > 0


def test_smoothcache_custom_schedule_matches_reference(pair):
    jcfg, jmodel, jparams, model = pair
    _, ts = _drive(jcfg, jmodel, jparams, model, "smoothcache", None,
                   variant="interval3")
    # interval 3: steps 1, 2, 4, 5 reuse every layer; 0 and 3 compute
    assert summarize_stats(ts)["block_cache_ratio"] == pytest.approx(4 / 6)


# ---------------------------------------------------------------------------
# registry, state, helpers
# ---------------------------------------------------------------------------

def test_registry_order_is_the_references():
    assert registered_policies() == repro.core.POLICIES


@pytest.mark.parametrize("policy", sorted(EXPECTED_STATE))
def test_init_state_matches_reference(pair, policy):
    jcfg, jmodel, _, model = pair
    kw = _kwargs(policy, jcfg.num_layers)
    state = CachedDiT(model, FastCacheConfig(), policy=policy,
                      **kw).init_state(3)
    jstate = JCachedDiT(jmodel, JFastCacheConfig(), policy=policy,
                        **kw).init_state(3)
    assert set(state) - {"stats"} == EXPECTED_STATE[policy]
    assert set(state["stats"]) == set(jstate["stats"])
    for k in EXPECTED_STATE[policy] - {"gate"}:
        assert tuple(state[k].shape) == jstate[k].shape, (policy, k)
        assert str(state[k].dtype).split(".")[-1] == str(jstate[k].dtype), \
            (policy, k)


@pytest.mark.parametrize("policy", NEW)
def test_reset_rows_rearms_only_those_rows(pair, policy):
    """After a few steps, resetting one CFG pair zeroes its payload and
    counters' inputs exactly as the reference's reset_rows."""
    jcfg, _, _, model = pair
    runner = CachedDiT(model, FastCacheConfig(), policy=policy,
                       **_kwargs(policy, jcfg.num_layers))
    img, ch = jcfg.dit.image_size, jcfg.dit.in_channels
    x = t32(np.random.default_rng(4).standard_normal(
        (4, img, img, ch)).astype(np.float32))
    state = runner.init_state(4)
    for i in range(2):
        _, state = runner.step(state, x, torch.full((4,), 30 - i),
                               torch.arange(4))
    state = runner.reset_slot(state, [1, 3])
    fresh = runner.init_state(4)
    for k, v in fresh.items():
        if k == "stats":
            continue
        rows = (slice(None), [1, 3]) if k == "prev_delta" else ([1, 3],)
        assert torch.equal(state[k][rows], v[rows]), (policy, k)
        if k == "have_cache":
            assert bool(state[k][0]) and bool(state[k][2])


def test_l2c_one_layer_mask_skips_one_block_per_step(pair):
    """tests/test_fastcache.py:test_l2c_respects_mask, in the port: a mask
    with one layer skips exactly one block per sample and step; numpy and
    torch masks are the same mask."""
    jcfg, _, _, model = pair
    img, ch = jcfg.dit.image_size, jcfg.dit.in_channels
    x = t32(np.random.default_rng(1).standard_normal(
        (2, img, img, ch)).astype(np.float32))
    mask_np = np.zeros((jcfg.num_layers,), bool)
    mask_np[0] = True
    outs = []
    for mask in (mask_np, torch.from_numpy(mask_np)):
        runner = CachedDiT(model, FastCacheConfig(), policy="l2c",
                           l2c_mask=mask)
        state = runner.init_state(2)
        for _ in range(4):
            eps, state = runner.step(state, x, torch.full((2,), 25),
                                     torch.tensor([1, 2]))
        s = summarize_stats(state)
        assert s["blocks_skipped"] == 4.0
        assert s["blocks_computed"] == 4.0 * (jcfg.num_layers - 1)
        outs.append(eps)
    assert torch.equal(outs[0], outs[1])
    with pytest.raises(ValueError, match="layers"):
        CachedDiT(model, FastCacheConfig(), policy="l2c",
                  l2c_mask=np.zeros((jcfg.num_layers + 1,), bool))


def test_l2c_mask_from_deltas_matches_reference():
    deltas = np.array([0.5, 0.1, 0.1, 0.9, 0.05, 0.1], np.float32)  # ties
    for n in range(len(deltas) + 1):
        got = l2c_mask_from_deltas(torch.from_numpy(deltas), n)
        want = np.asarray(jl2c_mask_from_deltas(jnp.asarray(deltas), n))
        np.testing.assert_array_equal(got.numpy(), want)


def test_smooth_schedule_helpers_match_reference():
    from repro.core.policies import smoothcache as jsmooth
    np.testing.assert_array_equal(
        default_smooth_schedule(3, interval=2, table_steps=8),
        np.asarray(jsmooth.default_smooth_schedule(3, interval=2,
                                                   table_steps=8)))
    err = np.array([[0.0, 0.01, 0.5], [0.0, 0.2, 0.01]], np.float32)
    np.testing.assert_array_equal(
        smooth_schedule_from_errors(torch.from_numpy(err), 0.05),
        np.asarray(jsmooth.smooth_schedule_from_errors(err, 0.05)))


def test_smoothcache_default_schedule_and_row_check(pair):
    jcfg, _, _, model = pair
    runner = CachedDiT(model, FastCacheConfig(), policy="smoothcache")
    img, ch = jcfg.dit.image_size, jcfg.dit.in_channels
    x = t32(np.random.default_rng(1).standard_normal(
        (2, img, img, ch)).astype(np.float32))
    state = runner.init_state(2)
    for _ in range(6):
        _, state = runner.step(state, x, torch.full((2,), 25),
                               torch.tensor([1, 2]))
    # steps 1, 3, 5 reuse (schedule), 0, 2, 4 compute: ratio 0.5
    assert summarize_stats(state)["block_cache_ratio"] == 0.5
    sched = default_smooth_schedule(jcfg.num_layers, interval=3)
    from_torch = CachedDiT(model, FastCacheConfig(), policy="smoothcache",
                           smooth_schedule=torch.from_numpy(sched))
    np.testing.assert_array_equal(from_torch.impl.schedule, sched)
    with pytest.raises(ValueError, match="layer rows"):
        CachedDiT(model, FastCacheConfig(), policy="smoothcache",
                  smooth_schedule=np.zeros((jcfg.num_layers + 1, 4), bool))


# ---------------------------------------------------------------------------
# host syncs and the kernel wrappers on the path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", NEW)
def test_host_syncs_per_step(pair, policy):
    """The host mirror of the warm-up flags and step counters decides what
    it can: fora's and smoothcache's schedules and every cold or mixed step
    read nothing; teacache, adacache and fbcache read their skip mask once
    per all-warm eager step (steps 1 and 3 here); l2c reads nothing."""
    jcfg, _, _, model = pair
    runner = CachedDiT(model, FastCacheConfig(), policy=policy,
                       **_kwargs(policy, jcfg.num_layers))
    img, ch = jcfg.dit.image_size, jcfg.dit.in_channels
    x = torch.zeros((2, img, img, ch))
    state = runner.init_state(2)
    t, labels = torch.full((2,), 10), torch.tensor([0, 1])
    for i in range(4):
        if i == 2:
            state = runner.reset_slot(state, [1])
        _, state = runner.step(state, x, t, labels)
    reads = 2 if policy in ("teacache", "adacache", "fbcache") else 0
    assert runner.impl.host_syncs == reads
    assert runner.impl.step_kinds == (
        {"cold": 0, "mixed": 0, "warm": 4} if policy == "l2c"
        else {"cold": 1, "mixed": 1, "warm": 2})


def _spy(monkeypatch, module, name, fn, calls):
    def spy(*args, **kw):
        calls.append(name)
        return fn(*args, **kw)
    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("policy", NEW + ("fastcache",))
def test_policies_reach_the_kernel_wrappers(pair, monkeypatch, policy):
    """Per model step: saliency_delta once for teacache, adacache, fbcache
    and every gated fastcache step, linear_blend once per masked layer for
    l2c and once per gated fastcache step, neither for fora and
    smoothcache; on the CPU the wrappers launch nothing."""
    from repro_torch.core.policies import base, l2c
    calls = []
    _spy(monkeypatch, base, "saliency_delta", saliency_delta, calls)
    _spy(monkeypatch, saliency, "saliency_delta", saliency_delta, calls)
    _spy(monkeypatch, l2c, "linear_blend", linear_blend, calls)
    _spy(monkeypatch, fastcache, "linear_blend", linear_blend, calls)
    jcfg, _, _, model = pair
    runner = CachedDiT(model, FastCacheConfig(), policy=policy,
                       **_kwargs(policy, jcfg.num_layers))
    img, ch = jcfg.dit.image_size, jcfg.dit.in_channels
    x = torch.zeros((2, img, img, ch))
    state = runner.init_state(2)
    t, labels = torch.full((2,), 10), torch.tensor([0, 1])
    launches = (saliency_delta.launches, linear_blend.launches)
    per_step = []
    for _ in range(3):
        calls.clear()
        _, state = runner.step(state, x, t, labels)
        per_step.append(sorted(calls))
    sd, lb = ["saliency_delta"], ["linear_blend"]
    want = {"fora": [[]] * 3, "smoothcache": [[]] * 3,
            "teacache": [sd] * 3, "adacache": [sd] * 3, "fbcache": [sd] * 3,
            "l2c": [lb] * 3,
            "fastcache": [[], lb + sd, lb + sd]}[policy]
    assert per_step == want
    assert (saliency_delta.launches, linear_blend.launches) == launches


# ---------------------------------------------------------------------------
# the served trace
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    jcfg, jmodel, jparams = jax_dit("smoke")
    return jcfg, jmodel, jparams, port_dit(jcfg, jparams)


@pytest.mark.parametrize("policy", NEW)
def test_served_trace_matches_reference(smoke, policy):
    jcfg, jmodel, jparams, model = smoke
    kw = _kwargs(policy, jcfg.num_layers)
    jeng = JEngine(JCachedDiT(jmodel, JFastCacheConfig(), policy=policy,
                              **kw), jparams, max_slots=2,
                   num_steps=SERVE_STEPS, max_steps=7, enable_metrics=False)
    jdone = jeng.run(serving_trace())

    def noise(req):
        return t32(np.asarray(jeng.request_noise(req)))

    eng = DiffusionServingEngine(CachedDiT(model, FastCacheConfig(),
                                           policy=policy, **kw),
                                 max_slots=2, num_steps=SERVE_STEPS,
                                 max_steps=7, noise_fn=noise)
    trace = [DiffusionRequest(rid=r.rid, label=r.label, seed=r.seed,
                              arrival_step=r.arrival_step,
                              num_steps=r.num_steps,
                              guidance_scale=r.guidance_scale)
             for r in serving_trace()]
    done = eng.run(trace)
    assert [r.rid for r in done] == [r.rid for r in jdone]
    for r, jr in zip(done, jdone):
        assert (r.num_steps, r.guidance_scale, r.admit_step,
                r.finish_step) == (jr.num_steps, jr.guidance_scale,
                                   jr.admit_step, jr.finish_step), r.rid
        assert r.cache == jr.cache, r.rid
        want = np.asarray(jr.latents)
        np.testing.assert_allclose(
            r.latents, want, rtol=0,
            atol=LATENT_REL * float(np.abs(want).max()),
            err_msg=f"{policy} rid={r.rid}")
    stats, jstats = eng.cache_stats(), jeng.cache_stats()
    for k in ("engine_steps", "model_steps", "blocks_skipped",
              "blocks_computed", "steps_reused", "per_slot_blocks_skipped",
              "per_slot_blocks_computed"):
        assert stats[k] == jstats[k], (policy, k)
