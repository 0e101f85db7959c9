"""The port's token-compression stage (``core/token_merge.py``,
``core/token_reduce.py``) and the merged serving slice against the
reference's, on the same inputs.

Stage: ``merge_tokens`` / ``unmerge_tokens`` on numpy-drawn tokens —
centers and assignments exact, scores and merged tokens within f32 1e-4
(the reference's kernel tolerance), the r=1.0 short-circuit bitwise.

Slice: ``CachedDiT.step`` with merging on (window 8, r=0.5, the f32 smoke
DiT with the reference's weights through ``bridge``) for fastcache and
nocache over 6 steps, the latents advanced with the reference's eps as in
test_torch_fastcache.py: every step's assignment and every counter exact,
eps within the block tolerance of test_torch_model.py (rtol 1e-4, atol
1e-3).  Then the engine trace of test_torch_serving.py with merging on,
against a live run of the reference engine: counters exact, latents within
``LATENT_REL`` of their scale.
"""
import tests.torch_threads  # noqa: F401  (first: one thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FastCacheConfig as JFastCacheConfig
from repro.core import CachedDiT as JCachedDiT
from repro.core import token_merge as jtoken_merge
from repro.core.token_reduce import TokenReducer as JTokenReducer
from repro.serving import DiffusionServingEngine as JEngine
from repro.serving import poisson_trace as jpoisson_trace
from repro_torch.configs.base import FastCacheConfig
from repro_torch.core import token_merge
from repro_torch.core.runner import CachedDiT
from repro_torch.core.token_reduce import STATE_KEY, TokenReducer
from repro_torch.serving.diffusion_engine import DiffusionServingEngine
from repro_torch.serving.scheduler import poisson_trace
from tests.test_torch_model import BLOCK_TOL, jax_dit, np32, port_dit, t32
from tests.test_torch_serving import LATENT_REL, TRACE

STEPS = 6
SHRINK = 0.05
COUNTERS = ("blocks_computed", "blocks_skipped", "steps_reused",
            "motion_frac_sum", "tokens_kept", "tokens_merged")


def _fc(ratio, window=8, **kw):
    return FastCacheConfig(merge_enabled=True, merge_ratio=ratio,
                           merge_window=window, **kw)


def _jfc(ratio, window=8, **kw):
    return JFastCacheConfig(merge_enabled=True, merge_ratio=ratio,
                            merge_window=window, **kw)


@pytest.fixture(scope="module")
def smoke():
    jcfg, jmodel, jparams = jax_dit("smoke")
    return jcfg, jmodel, jparams, port_dit(jcfg, jparams)


# ---------------------------------------------------------------------------
# merge / unmerge (core/token_merge.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ratio", [0.25, 0.5, 0.75])
@pytest.mark.parametrize("warm", [False, True])
def test_merge_tokens_match_reference(ratio, warm):
    b, n, d, w, k = 2, 32, 16, 8, 3
    rng = np.random.default_rng(0)
    h = rng.standard_normal((b, n, d)).astype(np.float32)
    hp = (h + 0.3 * rng.standard_normal((b, n, d)).astype(np.float32)
          if warm else h)
    kw = dict(window=w, keep_ratio=ratio, k=k, lam=1.0)
    merged, mm = token_merge.merge_tokens(t32(h), t32(hp), **kw)
    jmerged, jmm = jtoken_merge.merge_tokens(jnp.asarray(h), jnp.asarray(hp),
                                             **kw)
    m = token_merge.keep_count(w, ratio)
    assert merged.shape == (b, n // w * m, d) and merged.dtype == torch.float32
    np.testing.assert_array_equal(mm.centers.numpy(), np.asarray(jmm.centers))
    np.testing.assert_array_equal(mm.assign.numpy(), np.asarray(jmm.assign))
    np.testing.assert_allclose(mm.scores.numpy(), np.asarray(jmm.scores),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(merged.numpy(), np.asarray(jmerged),
                               rtol=1e-4, atol=1e-4)
    # unmerge of the same merged grid: exact
    out = token_merge.unmerge_tokens(t32(np.asarray(jmerged)), mm, window=w,
                                     n_tokens=n)
    jout = jtoken_merge.unmerge_tokens(jmerged, jmm, window=w, n_tokens=n)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ratio_one_merge_is_bitwise_identity(dtype):
    h = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 32, 16)).astype(np.float32)).to(dtype)
    merged, mm = token_merge.merge_tokens(h, h, window=8, keep_ratio=1.0,
                                          k=3, lam=1.0)
    assert merged is h
    out = token_merge.unmerge_tokens(merged, mm, window=8, n_tokens=32)
    assert torch.equal(out, h)


def test_unmerged_tokens_are_their_cluster_means():
    b, n, d, w = 2, 32, 16, 8
    rng = np.random.default_rng(2)
    h = t32(rng.standard_normal((b, n, d)).astype(np.float32))
    hp = t32(rng.standard_normal((b, n, d)).astype(np.float32))
    merged, mm = token_merge.merge_tokens(h, hp, window=w, keep_ratio=0.5,
                                          k=3, lam=1.0)
    out = token_merge.unmerge_tokens(merged, mm, window=w, n_tokens=n)
    mg = merged.reshape(b, n // w, 4, d)
    got = out.reshape(b, n // w, w, d)
    idx = mm.assign.long()[..., None].expand(-1, -1, -1, d)
    assert torch.equal(got, torch.gather(mg, 2, idx))


def test_merge_rejects_indivisible_window():
    h = torch.zeros((1, 30, 8))
    with pytest.raises(ValueError, match="divisible"):
        token_merge.merge_tokens(h, h, window=8, keep_ratio=0.5, k=3,
                                 lam=1.0)


# ---------------------------------------------------------------------------
# TokenReducer statics, rows and errors (core/token_reduce.py)
# ---------------------------------------------------------------------------

def test_capacity_overflow_deactivates_never_reshapes(smoke):
    _, _, _, model = smoke
    red = TokenReducer(model, _fc(0.99))
    assert not red.active and red.reduced_tokens == model.num_tokens
    runner = CachedDiT(model, _fc(0.99))
    assert runner.reducer is None
    assert runner.impl.n_tokens == model.num_tokens
    assert STATE_KEY not in runner.init_state(2)


def test_reducer_follows_merge_enabled(smoke):
    _, _, _, model = smoke
    off = FastCacheConfig(merge_ratio=0.5, merge_window=8)
    runner = CachedDiT(model, off)                       # merge_enabled off
    assert runner.reducer is None
    assert STATE_KEY not in runner.init_state(2)
    on = CachedDiT(model, _fc(0.5))
    assert on.reducer is not None and on.reducer.active
    assert on.impl.n_tokens == on.reducer.reduced_tokens


def test_reducer_statics_and_state_rows(smoke):
    jcfg, jmodel, _, model = smoke
    red = TokenReducer(model, _fc(0.5))
    jred = JTokenReducer(jmodel, _jfc(0.5))
    assert (red.m, red.active, red.reduced_tokens, red.n_windows) == (
        jred.m, jred.active, jred.reduced_tokens, jred.n_windows)
    assert red.active and red.m == 4
    assert red.reduced_tokens == model.num_tokens // 2
    rows = red.init_rows(3)
    assert rows["prev_full"].shape == (3, model.num_tokens, jcfg.d_model)
    assert not bool(rows["have_prev"].any())
    merged = red.reduce(torch.ones((3, model.num_tokens, jcfg.d_model)),
                        rows)
    assert merged.shape == (3, red.reduced_tokens, jcfg.d_model)
    assert bool(rows["have_prev"].all())         # reduce writes tr in place
    assert bool((rows["prev_full"] == 1.0).all())
    cold = red.reset_rows(rows, [1])
    assert [bool(v) for v in cold["have_prev"]] == [True, False, True]
    assert not bool(cold["prev_full"][1].any())


def test_reducer_rejects_bad_window_and_k(smoke):
    _, _, _, model = smoke
    with pytest.raises(ValueError, match="divisible"):
        TokenReducer(model, _fc(0.5, window=5))
    with pytest.raises(ValueError, match="out of range"):
        TokenReducer(model, _fc(0.5, window=8, knn_k=8))
    with pytest.raises(ValueError, match=">= 2"):
        TokenReducer(model, _fc(0.5, window=1))


def test_unmerge_outside_a_step_raises(smoke):
    _, _, _, model = smoke
    runner = CachedDiT(model, _fc(0.5))
    with pytest.raises(RuntimeError, match="outside a reduce"):
        runner.reducer.unmerge(torch.zeros((1, 8, model.cfg.d_model)))


# ---------------------------------------------------------------------------
# CachedDiT.step with merging on, against the reference
# ---------------------------------------------------------------------------

def _record_maps(reducer, sink):
    orig = reducer.reduce

    def reduce(x, tr):
        out = orig(x, tr)
        sink.append(np.asarray(reducer._mm.assign))
        return out

    reducer.reduce = reduce


@pytest.mark.parametrize("policy", ["fastcache", "nocache"])
def test_merged_cached_step_matches_reference(smoke, policy):
    jcfg, jmodel, jparams, model = smoke
    jr = JCachedDiT(jmodel, _jfc(0.5), policy=policy)
    tr = CachedDiT(model, _fc(0.5), policy=policy)
    assert tr.impl.n_tokens == jr.impl.n_tokens == model.num_tokens // 2
    jmaps, tmaps = [], []
    _record_maps(jr.reducer, jmaps)
    _record_maps(tr.reducer, tmaps)
    b = 4
    rng = np.random.default_rng(0)
    img, ch = jcfg.dit.image_size, jcfg.dit.in_channels
    x = rng.standard_normal((b, img, img, ch)).astype(np.float32)
    labels = np.array([1, 2, 3, 4], np.int32)
    js, ts = jr.init_state(b), tr.init_state(b)
    for i in range(STEPS):
        t = np.full((b,), 50 - i, np.int32)
        je, js = jr.step(jparams, js, jnp.asarray(x), jnp.asarray(t),
                         jnp.asarray(labels))
        te, ts = tr.step(ts, t32(x), t32(t), t32(labels))
        assert tr.reducer._mm is None
        np.testing.assert_array_equal(tmaps[i], jmaps[i],
                                      err_msg=f"assign at step {i}")
        for k in COUNTERS:
            np.testing.assert_array_equal(
                np32(ts["stats"][k]), np32(js["stats"][k]),
                err_msg=f"{policy}: counter {k} diverges at step {i}")
        np.testing.assert_allclose(np32(te), np32(je), **BLOCK_TOL,
                                   err_msg=f"{policy}: eps at step {i}")
        x = x - SHRINK * np32(je)
    assert len(tmaps) == STEPS
    if policy == "fastcache":
        assert float(ts["stats"]["blocks_skipped"].sum()) > 0


def test_mixed_step_unmerges_both_paths_with_one_map(smoke):
    """A mixed warm/cold batch runs the full forward and the gated path on
    the reduced grid: both ``_eps`` calls unmerge, with the same map."""
    jcfg, _, _, model = smoke
    runner = CachedDiT(model, _fc(0.5))
    seen = []
    orig = runner.reducer.unmerge

    def unmerge(hidden):
        seen.append(runner.reducer._mm)
        return orig(hidden)

    runner.reducer.unmerge = unmerge
    img, ch = jcfg.dit.image_size, jcfg.dit.in_channels
    x = t32(np.random.default_rng(3).standard_normal(
        (2, img, img, ch)).astype(np.float32))
    t, labels = torch.full((2,), 20), torch.tensor([0, 1])
    state = runner.init_state(2)
    _, state = runner.step(state, x, t, labels)
    state = runner.reset_slot(state, [1])
    seen.clear()
    eps, state = runner.step(state, x, t, labels)
    assert runner.impl.step_kinds["mixed"] == 1
    assert len(seen) == 2 and seen[0] is seen[1] and seen[0] is not None
    assert eps.shape == (2, img, img, ch) and torch.isfinite(eps).all()


# ---------------------------------------------------------------------------
# The serving slice with merging on
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served_merge(smoke):
    jcfg, jmodel, jparams, model = smoke
    ncls = jcfg.dit.num_classes
    jeng = JEngine(JCachedDiT(jmodel, _jfc(0.5)), jparams, max_slots=2,
                   num_steps=6, max_steps=6, enable_metrics=False)
    jdone = jeng.run(jpoisson_trace(num_classes=ncls, **TRACE))

    def noise(req):
        return t32(np.asarray(jeng.request_noise(req)))

    def serve(fc):
        eng = DiffusionServingEngine(CachedDiT(model, fc), max_slots=2,
                                     num_steps=6, max_steps=6,
                                     noise_fn=noise)
        return eng, eng.run(poisson_trace(num_classes=ncls, **TRACE))

    return jeng, jdone, serve


def test_merged_engine_matches_reference(served_merge):
    jeng, jdone, serve = served_merge
    eng, done = serve(_fc(0.5))
    assert [r.rid for r in done] == [r.rid for r in jdone]
    for r, jr in zip(done, jdone):
        assert (r.admit_step, r.finish_step) == (jr.admit_step,
                                                 jr.finish_step)
        assert "tokens_kept" in r.cache
        assert r.cache == jr.cache, r.rid
        want = np.asarray(jr.latents)
        np.testing.assert_allclose(
            r.latents, want, rtol=0,
            atol=LATENT_REL * float(np.abs(want).max()),
            err_msg=f"rid={r.rid}")
    stats, jstats = eng.cache_stats(), jeng.cache_stats()
    for k in ("engine_steps", "model_steps", "blocks_skipped",
              "blocks_computed", "per_slot_blocks_skipped",
              "per_slot_blocks_computed"):
        assert stats[k] == jstats[k], k
    assert stats["tokens_kept"] == stats["tokens_merged"] > 0


def test_ratio_one_is_merge_off_and_half_changes_latents(served_merge):
    _, _, serve = served_merge
    _, off = serve(FastCacheConfig())
    eng_one, one = serve(_fc(1.0))
    _, half = serve(_fc(0.5))
    assert eng_one.runner.reducer is None
    assert "tokens_kept" not in eng_one.cache_stats()
    for a, b, c in zip(off, one, half):
        np.testing.assert_array_equal(a.latents, b.latents)
        assert a.cache == b.cache
        assert not np.array_equal(a.latents, c.latents)


def test_merge_serve_launcher_on_cpu():
    from repro_torch.launch.serve_diffusion import parse_args, serve
    out = serve(parse_args(["--reduced", "--device", "cpu", "--requests", "2",
                            "--slots", "2", "--steps", "3",
                            "--token-merge-ratio", "0.5",
                            "--token-merge-window", "8"]))
    assert out["finished"] == 2
    assert out["token_merge"] == {"ratio": 0.5, "window": 8, "active": True}
    with pytest.raises(SystemExit):
        parse_args(["--token-merge-ratio", "0"])
