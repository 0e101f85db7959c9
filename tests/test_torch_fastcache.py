"""The port's cache core and ``CachedDiT.step`` against the reference's.

Both runners see the same inputs at every step: the latents are advanced
with the reference's eps (x <- x - 0.05 * eps), so a divergence shows up
where it starts.  Per-step block counters, motion fractions and tracker
bits must be equal exactly; eps is held to the block-level f32 tolerance
of test_torch_model.py (rtol 1e-4, atol 1e-3) and sigma2 to rtol 1e-4.
"""
import tests.torch_threads  # noqa: F401  (first: one thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FastCacheConfig as JFastCacheConfig
from repro.core import CachedDiT as JCachedDiT
from repro.core import saliency as jsaliency
from repro.core import statcache as jstatcache
from repro_torch.configs.base import FastCacheConfig
from repro_torch.core import saliency, statcache
from repro_torch.core.policies.base import summarize_stats
from repro_torch.core.runner import CachedDiT
from repro_torch.cuda_kernels.saliency_delta import saliency_delta
from tests.test_torch_model import (BLOCK_TOL, SMALL_CONFIGS, jax_dit, np32,
                                    port_dit, t32)

STEPS = 6
SHRINK = 0.05
COUNTERS = ("blocks_computed", "blocks_skipped", "steps_reused",
            "motion_frac_sum")


@pytest.fixture(scope="module", params=SMALL_CONFIGS)
def pair(request):
    jcfg, jmodel, jparams = jax_dit(request.param)
    return jcfg, jmodel, jparams, port_dit(jcfg, jparams)


@pytest.mark.parametrize("policy", ["fastcache", "nocache"])
def test_cached_step_matches_reference(pair, policy):
    jcfg, jmodel, jparams, model = pair
    jr = JCachedDiT(jmodel, JFastCacheConfig(), policy=policy)
    tr = CachedDiT(model, FastCacheConfig(), policy=policy)
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
        if policy == "fastcache":
            np.testing.assert_array_equal(
                ts["gate"].initialized.numpy(),
                np.asarray(js["gate"].initialized),
                err_msg=f"tracker bits diverge at step {i}")
            np.testing.assert_allclose(
                ts["gate"].sigma2.numpy(), np.asarray(js["gate"].sigma2),
                rtol=1e-4, err_msg=f"sigma2 diverges at step {i}")
        np.testing.assert_allclose(np32(te), np32(je), **BLOCK_TOL,
                                   err_msg=f"{policy}: eps at step {i}")
        x = x - SHRINK * np32(je)
    skipped = float(np.sum(np32(ts["stats"]["blocks_skipped"])))
    if policy == "fastcache":
        assert skipped > 0        # the gated branch really ran and fired
    assert summarize_stats(ts)["steps"] == STEPS


def test_static_drive_caches(pair):
    """Identical inputs after the warm-up: the gate must cache heavily
    (the reference's test_fastcache_skips_when_static, in the port)."""
    jcfg, _, _, model = pair
    runner = CachedDiT(model, FastCacheConfig(), policy="fastcache")
    b = 2
    img, ch = jcfg.dit.image_size, jcfg.dit.in_channels
    x = t32(np.random.default_rng(0).standard_normal(
        (b, img, img, ch)).astype(np.float32))
    state = runner.init_state(b)
    labels = torch.tensor([1, 2])
    for _ in range(6):
        _, state = runner.step(state, x, torch.full((b,), 25), labels)
    s = summarize_stats(state)
    assert s["block_cache_ratio"] > 0.4, s
    assert s["mean_motion_fraction"] < 0.5, s


def test_host_syncs_per_step(pair):
    """The step's kind comes from the host mirror of ``have_cache``: a cold
    or mixed step reads nothing, an all-warm eager step reads one skip
    decision per layer."""
    jcfg, _, _, model = pair
    runner = CachedDiT(model, FastCacheConfig(), policy="fastcache")
    impl = runner.impl
    img, ch = jcfg.dit.image_size, jcfg.dit.in_channels
    x = torch.zeros((2, img, img, ch))
    state = runner.init_state(2)
    t, labels = torch.full((2,), 10), torch.tensor([0, 1])
    _, state = runner.step(state, x, t, labels)
    assert impl.host_syncs == 0 and impl.step_kinds["cold"] == 1
    _, state = runner.step(state, x, t, labels)
    assert impl.host_syncs == runner.L and impl.step_kinds["warm"] == 1
    state = runner.reset_slot(state, [1])
    _, state = runner.step(state, x, t, labels)
    assert impl.host_syncs == runner.L and impl.step_kinds["mixed"] == 1


def test_gated_step_goes_through_the_kernel_wrapper(pair, monkeypatch):
    """Every layer of a warm step calls the ``fused_gate`` wrapper (which
    sends CPU tensors to the plain version and counts no launch); there is
    no other route to the gate."""
    from repro_torch.core.policies import fastcache
    from repro_torch.cuda_kernels.fused_gate import fused_gate

    calls = []

    def spy(*args, **kw):
        calls.append(args[0].device.type)
        return fused_gate(*args, **kw)

    monkeypatch.setattr(fastcache, "fused_gate", spy)
    jcfg, _, _, model = pair
    runner = CachedDiT(model, FastCacheConfig(), policy="fastcache")
    img, ch = jcfg.dit.image_size, jcfg.dit.in_channels
    x = torch.zeros((2, img, img, ch))
    state = runner.init_state(2)
    t, labels = torch.full((2,), 10), torch.tensor([0, 1])
    launches = fused_gate.launches
    _, state = runner.step(state, x, t, labels)
    assert calls == []                              # cold: no gate
    _, state = runner.step(state, x, t, labels)
    assert calls == ["cpu"] * runner.L
    assert fused_gate.launches == launches


def test_zero_saliency_partition_is_arange():
    sal = torch.zeros((3, 64))
    part = saliency.partition_tokens(sal, 0.05, 32)
    np.testing.assert_array_equal(
        part.motion_idx.numpy(), np.broadcast_to(np.arange(32), (3, 32)))
    assert not part.is_motion.any()


def test_partition_ties_match_top_k():
    """Heavy ties: the stable sort must break them as lax.top_k does."""
    sal = np.random.default_rng(1).integers(0, 4, size=(4, 64)).astype(
        np.float32)
    part = saliency.partition_tokens(torch.from_numpy(sal), 1.5, 32)
    jpart = jsaliency.partition_tokens(jnp.asarray(sal), 1.5, 32)
    np.testing.assert_array_equal(part.motion_idx.numpy(),
                                  np.asarray(jpart.motion_idx))
    np.testing.assert_array_equal(part.is_motion.numpy(),
                                  np.asarray(jpart.is_motion))


def test_global_gate_mode_raises(pair):
    """The global gate is ported now (its parity is in
    test_torch_leftovers.py); the serving engine still refuses it, as the
    reference's does (admissions would move residents' decisions), and an
    unknown mode raises in CachedDiT."""
    from repro_torch.serving.diffusion_engine import DiffusionServingEngine
    _, _, _, model = pair
    runner = CachedDiT(model, FastCacheConfig(gate_mode="global"))
    with pytest.raises(ValueError, match="per_sample"):
        DiffusionServingEngine(runner, max_slots=2)
    with pytest.raises(ValueError, match="per_sample"):
        CachedDiT(model, FastCacheConfig(gate_mode="batch"))


def test_delta_stats_and_sigma_update_match_reference():
    """The per-sample delta stats the port's gates read (the totals of the
    saliency_delta wrapper, on the CPU its plain version) and the sigma
    update against the reference's."""
    rng = np.random.default_rng(2)
    h = rng.standard_normal((3, 16, 8)).astype(np.float32)
    prev = (h + 0.1 * rng.standard_normal(h.shape)).astype(np.float32)
    _, diff, prevsq = saliency_delta(t32(h), t32(prev))
    jdiff, jprevsq = jstatcache.delta_stats_per_sample(jnp.asarray(h),
                                                       jnp.asarray(prev))
    np.testing.assert_allclose(diff.numpy(), np.asarray(jdiff), rtol=1e-5)
    np.testing.assert_allclose(prevsq.numpy(), np.asarray(jprevsq), rtol=1e-5)
    sig = np.array([0.5, 2.0, 1.0], np.float32)
    ini = np.array([True, False, True])
    new, flags = statcache.update_sigma(t32(sig), t32(ini), diff, 128, 0.7)
    jnew, jflags = jstatcache.update_sigma(jnp.asarray(sig), jnp.asarray(ini),
                                           jdiff, 128, 0.7)
    np.testing.assert_allclose(new.numpy(), np.asarray(jnew), rtol=1e-5)
    np.testing.assert_array_equal(flags.numpy(), np.asarray(jflags))
