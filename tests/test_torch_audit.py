"""The port's shadow-compute audit plane (``repro_torch.obs.audit``) against
the reference's (``repro.obs.audit``): the schedule, the error measures,
and served traces audited by both engines on the same inputs.

Model: the reference's test fixture, the reduced dit-b2 in f32 with its
initial parameters perturbed by 0.02 (adaLN-zero and the zero head would
make every policy exact), copied into the port.  Both engines serve the
same requests with the same initial noise (the port takes the reference's
through ``noise_fn``).  Tolerances: the audit schedule, audited steps,
violations and bound violations exact; per-slot ``audit_err_sum`` /
``audit_err_sq_sum``, per-layer means and histogram sums at rtol 1e-4
(f32 sums in another order).
"""
import tests.torch_threads  # noqa: F401  (first: one thread)
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_reduced as jget_reduced
from repro.configs.base import FastCacheConfig as JFastCacheConfig
from repro.core import CachedDiT as JCachedDiT
from repro.core.policies import base as jpolicies_base
from repro.core.policies.fastcache import FastCache as JFastCache
from repro.models import build_model as jbuild_model
from repro.obs import audit as jaudit
from repro.obs import metrics as jm
from repro.serving import DiffusionRequest as JRequest
from repro.serving import DiffusionServingEngine as JEngine
from repro_torch.configs.base import FastCacheConfig
from repro_torch.core.policies import base as policies_base
from repro_torch.core.policies.fastcache import FastCache
from repro_torch.core.runner import CachedDiT
from repro_torch.obs import audit as taudit
from repro_torch.obs import metrics as tm
from repro_torch.serving.diffusion_engine import DiffusionServingEngine
from repro_torch.serving.scheduler import DiffusionRequest
from tests.conftest import f32_cfg
from tests.test_torch_model import port_dit, t32

RTOL = 1e-4
SLOTS = 2


@pytest.fixture(scope="module")
def dit():
    cfg = f32_cfg(jget_reduced("dit-b2"))
    model = jbuild_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    leaves, tdef = jax.tree.flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(42), len(leaves))
    leaves = [p + 0.02 * jax.random.normal(k, p.shape, p.dtype)
              for p, k in zip(leaves, keys)]
    params = jax.tree.unflatten(tdef, leaves)
    return cfg, model, params, port_dit(cfg, params)


def _requests(cls, n, num_steps, stagger):
    return [cls(rid=i, label=i + 1, seed=10 + i,
                arrival_step=stagger * i, num_steps=num_steps)
            for i in range(n)]


def _serve_both(dit, *, audit_fraction, audit_seed=0, num_steps=16,
                requests=2, stagger=0, policy="fastcache"):
    """The same requests through both engines, each with a collector;
    returns (reference (engine, done, window), port (engine, done,
    window))."""
    _, jmodel, jparams, model = dit
    jcol = jm.MetricsCollector()
    jeng = JEngine(JCachedDiT(jmodel, JFastCacheConfig(), policy=policy),
                   jparams, max_slots=SLOTS, num_steps=num_steps,
                   collector=jcol, audit_fraction=audit_fraction,
                   audit_seed=audit_seed)
    jdone = jeng.run(_requests(JRequest, requests, num_steps, stagger))
    col = tm.MetricsCollector()
    eng = DiffusionServingEngine(
        CachedDiT(model, FastCacheConfig(), policy=policy),
        max_slots=SLOTS, num_steps=num_steps, collector=col,
        audit_fraction=audit_fraction, audit_seed=audit_seed,
        noise_fn=lambda r: t32(np.asarray(jeng.request_noise(r))))
    done = eng.run(_requests(DiffusionRequest, requests, num_steps, stagger))
    return ((jeng, jdone, jcol.windows[-1]), (eng, done, col.windows[-1]))


# ---------------------------------------------------------------------------
# Schedule and error measures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 123456789])
def test_audit_mask_equals_reference(seed):
    for fraction in (1.0 / 32.0, 0.25, 0.5, 0.3, 0.0, 1.0, -1.0, 2.0):
        mine = [taudit.audit_mask(s, fraction, seed) for s in range(10_000)]
        ref = [jaudit.audit_mask(s, fraction, seed) for s in range(10_000)]
        assert mine == ref, fraction
    picks = [taudit.audit_mask(s, 0.25, seed) for s in range(4096)]
    assert all(sum(picks[w:w + 4]) == 1 for w in range(0, 4096, 4))


def test_rel_err_rows_and_layer_rel_err_equal_reference():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((3, 4, 4, 2)).astype(np.float32)
    b = (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    b[2] = 0.0                                  # clamped denominator
    np.testing.assert_allclose(
        taudit.rel_err_rows(t32(a), t32(b)).numpy(),
        np.asarray(jaudit.rel_err_rows(jnp.asarray(a), jnp.asarray(b))),
        rtol=RTOL)
    cached = rng.standard_normal((5, 3, 16, 8)).astype(np.float32)
    true = (cached + 0.05 * rng.standard_normal(cached.shape)
            ).astype(np.float32)
    got = taudit.layer_rel_err(t32(cached), t32(true))
    assert got.shape == (5, 3)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jaudit.layer_rel_err(jnp.asarray(cached),
                                                     jnp.asarray(true))),
        rtol=RTOL)


# ---------------------------------------------------------------------------
# Served traces against the reference engine
# ---------------------------------------------------------------------------

def _same_audit(ref, mine, *, expect_viol=None):
    (jeng, jdone, jw), (eng, done, w) = ref, mine
    assert eng.model_steps == jeng.model_steps
    assert [r.rid for r in done] == [r.rid for r in jdone]
    for r, jr in zip(done, jdone):
        for k in (taudit.ACC_STEPS, taudit.ACC_VIOLATIONS):
            assert r.cache[k] == jr.cache[k], (r.rid, k)
        for k in (taudit.ACC_ERR_SUM, taudit.ACC_ERR_SQ):
            np.testing.assert_allclose(r.cache[k], jr.cache[k], rtol=RTOL,
                                       err_msg=f"rid={r.rid} {k}")
        for k in ("blocks_skipped", "blocks_computed"):
            assert r.cache[k] == jr.cache[k], (r.rid, k)
    for name in (tm.AUDIT_STEPS, tm.AUDIT_SLOT_STEPS, tm.BOUND_VIOLATIONS,
                 tm.BLOCKS_SKIPPED):
        assert w["counters"][name] == jw["counters"][name], name
    h, jh = (x["histograms"][tm.AUDIT_REL_ERR] for x in (w, jw))
    assert h["bucket_counts"] == jh["bucket_counts"]
    np.testing.assert_allclose(h["sum"], jh["sum"], rtol=RTOL)
    assert w["per_slot"][tm.SLOT_AUDIT_STEPS] == \
        jw["per_slot"][tm.SLOT_AUDIT_STEPS]
    np.testing.assert_allclose(w["per_slot"][tm.SLOT_AUDIT_ERR],
                               jw["per_slot"][tm.SLOT_AUDIT_ERR], rtol=RTOL)
    assert set(w["audit"]) == set(jw["audit"])
    for k, v in jw["audit"].items():        # window means, burn, layers
        np.testing.assert_allclose(w["audit"][k], v, rtol=RTOL, atol=1e-7,
                                   err_msg=k)
    if expect_viol is not None:
        assert (w["counters"][tm.BOUND_VIOLATIONS] > 0) == expect_viol


def test_full_audit_matches_reference(dit):
    """audit_fraction 1.0: every model step audited by both engines; the
    gates fire, the error is nonzero and inside Eq. 9's bound."""
    ref, mine = _serve_both(dit, audit_fraction=1.0)
    _same_audit(ref, mine, expect_viol=False)
    eng, done, w = mine
    assert w["counters"][tm.AUDIT_STEPS] == eng.model_steps
    assert w["counters"][tm.BLOCKS_SKIPPED] > 0
    assert w["histograms"][tm.AUDIT_REL_ERR]["sum"] > 0.0
    assert len(w["audit"]["layer_err_mean"]) == eng.runner.L + 1
    assert 0.0 < w["audit"]["burn_rate_window"] < 1.0
    bound = eng.runner.audit_bound()
    assert bound == ref[0].runner.audit_bound() and 1.0 < bound < 1.1


def _seed_with_audits(fraction, steps):
    """The first audit seed whose schedule audits at least one of the
    trace's model steps."""
    return next(seed for seed in range(100)
                if any(taudit.audit_mask(s, fraction, seed)
                       for s in range(steps)))


def test_sampled_audit_matches_reference(dit):
    """audit_fraction 1/32 (the default) over a staggered 4-request trace:
    both engines audit exactly the steps the schedule picks."""
    fraction = taudit.DEFAULT_AUDIT_FRACTION
    seed = _seed_with_audits(fraction, 24)
    ref, mine = _serve_both(dit, audit_fraction=fraction, audit_seed=seed,
                            requests=4, stagger=5)
    _same_audit(ref, mine)
    eng, _, w = mine
    want = sum(taudit.audit_mask(s, fraction, seed)
               for s in range(eng.model_steps))
    assert 0 < w["counters"][tm.AUDIT_STEPS] == want < eng.model_steps


def test_nocache_audits_exactly_zero(dit):
    ref, mine = _serve_both(dit, audit_fraction=1.0, num_steps=8,
                            policy="nocache")
    _same_audit(ref, mine, expect_viol=False)
    eng, done, w = mine
    assert eng.runner.audit_bound() is None
    h = w["histograms"][tm.AUDIT_REL_ERR]
    assert h["count"] > 0 and h["sum"] == 0.0
    # nocache keeps no hidden stack: no per-layer rows were added
    assert not any(w["audit"]["layer_err_mean"])
    assert all(r.cache[taudit.ACC_ERR_SUM] == 0.0 for r in done)


def test_misthresholded_policy_trips_bound_violations(dit):
    """A fastcache claiming a 1e-6 bound racks up violations, the same
    number in both packages."""

    @jpolicies_base.register("_audit_badbound")
    class JBadBound(JFastCache):
        def predicted_error_bound(self):
            return 1e-6

    @policies_base.register("_audit_badbound")
    class BadBound(FastCache):
        def predicted_error_bound(self):
            return 1e-6

    try:
        ref, mine = _serve_both(dit, audit_fraction=1.0,
                                policy="_audit_badbound")
        _same_audit(ref, mine, expect_viol=True)
        _, done, w = mine
        assert sum(r.cache[taudit.ACC_VIOLATIONS] for r in done) == \
            w["counters"][tm.BOUND_VIOLATIONS]
        assert w["audit"]["violation_rate_window"] > 0.0
    finally:
        del jpolicies_base._REGISTRY["_audit_badbound"]
        del policies_base._REGISTRY["_audit_badbound"]


def test_audit_leaves_latents_bitwise(dit):
    """Auditing reads the cached path and never writes it: the served
    latents and cache counters with the audit on equal those with it off,
    bitwise."""
    *_, model = dit

    def serve(fraction):
        eng = DiffusionServingEngine(
            CachedDiT(model, FastCacheConfig()), max_slots=SLOTS,
            num_steps=8, audit_fraction=fraction)
        return eng.run(_requests(DiffusionRequest, 3, 8, 3))

    on, off = serve(1.0), serve(0.0)
    for a, b in zip(on, off):
        assert a.rid == b.rid
        np.testing.assert_array_equal(a.latents, b.latents)
        assert {k: v for k, v in a.cache.items()
                if k not in taudit.AUDIT_ACC_KEYS} == b.cache


def test_request_budget_and_report_equal_reference(dit):
    ref, mine = _serve_both(dit, audit_fraction=1.0, num_steps=8)
    (jeng, jdone, _), (eng, done, _) = ref, mine
    for r, jr in zip(done, jdone):
        got, want = taudit.request_budget(r.cache), \
            jaudit.request_budget(jr.cache)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL,
                                       atol=1e-7, err_msg=k)
    doc = taudit.audit_report(done, fraction=1.0,
                              bound=eng.runner.audit_bound(),
                              collector=eng.collector)
    assert doc["violations_total"] == 0.0 and "window" in doc
    assert len(doc["requests"]) == len(done)
    json.dumps(doc)
    assert taudit.request_budget({})["audited_steps"] == 0.0


def test_audit_requires_metrics_plane(dit):
    *_, model = dit
    runner = CachedDiT(model, FastCacheConfig())
    with pytest.raises(ValueError, match="metrics"):
        DiffusionServingEngine(runner, max_slots=2, num_steps=8,
                               enable_metrics=False, audit_fraction=0.5)
    with pytest.raises(ValueError, match="audit_fraction"):
        DiffusionServingEngine(runner, max_slots=2, num_steps=8,
                               audit_fraction=1.5)


def test_histogram_quantile_equals_reference():
    buckets = tm.spec(tm.AUDIT_REL_ERR).buckets
    rng = np.random.default_rng(1)
    for _ in range(20):
        counts = rng.integers(0, 5, size=len(buckets) + 1).astype(float)
        for q in (0.0, 0.5, 0.95, 1.0):
            assert tm.histogram_quantile(buckets, counts, q) == \
                jm.histogram_quantile(buckets, counts, q)
    assert tm.histogram_quantile((1.0, 2.0), (0, 0, 5), 0.9) == 2.0
