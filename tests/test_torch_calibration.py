"""The port's calibration (``obs/calibration.py``, ``core/linear_approx.py``
``fit_linear`` / ``calibrate_dit``) against the reference's.

Model: the reduced dit-b2 in f32 with un-zeroed weights
(``tests/test_torch_model.py:jax_dit``), copied into the port.  The
recorder runs from the reference's initial noise (handed in as
``x_init``).  Tolerances: the recorder's ``rel_delta`` / ``errors_mean``
at rtol 1e-4 (f32 sums in another order).  The fitted maps are held
through their predictions ``x W + b`` on the calibration inputs and at
the inputs' mean (which fixes b): relative error 1e-4 in the Frobenius
norm over all rows.  Elementwise the two f32 fits differ by up to ~2e-4
relative on rows along the data's weakest directions: a 2x2x4 patch
embedding spans ~32 of the 128 directions, with variances from ~8e3 down
to ~0.7, so those directions of W are solved to ~1e4 * 2^-23 relative.
W itself is held to 8 * kappa * 2^-23 in relative Frobenius norm, kappa the
condition number of its ridge Gram (computed here in f64, ~1.6e5 for the
embedding: the ridge alone holds the 96 empty directions), the accuracy
to which two f32 solves of one system agree (a few ulps in the Gram's
sums).
The fastcache serve with the fitted maps: counters and gate decisions
exact, latents within 1e-4 of their scale (``tests/test_torch_serving``).
"""
import tests.torch_threads  # noqa: F401  (first: one thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FastCacheConfig as JFastCacheConfig
from repro.core import CachedDiT as JCachedDiT
from repro.core import linear_approx as jlinear
from repro.obs import calibration as jcal
from repro.serving import DiffusionServingEngine as JEngine
from repro.serving import poisson_trace as jpoisson_trace
from repro_torch import bridge
from repro_torch.configs.base import FastCacheConfig
from repro_torch.core import linear_approx
from repro_torch.core.runner import CachedDiT
from repro_torch.obs import calibration as tcal
from repro_torch.serving.diffusion_engine import DiffusionServingEngine
from repro_torch.serving.scheduler import poisson_trace
from tests.test_torch_model import jax_dit, port_dit, t32

RTOL = 1e-4
W_REL = 1e-3


@pytest.fixture(scope="module")
def dit():
    jcfg, jmodel, jparams = jax_dit("smoke")
    return jcfg, jmodel, jparams, port_dit(jcfg, jparams)


@pytest.fixture(scope="module")
def recorded(dit):
    jcfg, jmodel, jparams, model = dit
    batch, steps = 2, 5
    ref = jcal.record_calibration(
        JCachedDiT(jmodel, JFastCacheConfig(), policy="nocache"), jparams,
        batch=batch, num_steps=steps, guidance_scale=4.0, seed=0)
    img, ch = jcfg.dit.image_size, jcfg.dit.in_channels
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                         (batch, img, img, ch), jnp.float32))
    mine = tcal.record_calibration(
        CachedDiT(model, FastCacheConfig(), policy="nocache"), batch=batch,
        num_steps=steps, guidance_scale=4.0, x_init=t32(noise))
    return ref, mine


def test_recorder_equals_reference(recorded):
    ref, mine = recorded
    assert set(mine) == set(ref)
    for k in ("rel_delta", "errors_mean"):
        assert mine[k].shape == ref[k].shape and mine[k].dtype == np.float32
        np.testing.assert_allclose(mine[k], ref[k], rtol=RTOL, err_msg=k)
    np.testing.assert_array_equal(mine["ts"], ref["ts"])
    for k in ("num_steps", "guidance_scale", "layers", "batch", "policy"):
        assert mine[k] == ref[k], k
    np.testing.assert_array_equal(mine["rel_delta"][0], 1.0)
    assert np.all(mine["rel_delta"][1:] > 0.0)


def test_each_package_loads_the_others_artifact(recorded, tmp_path):
    ref, mine = recorded
    jpath, tpath = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    jcal.save_calibration(jpath, ref)
    tcal.save_calibration(tpath, mine)
    from_ref = tcal.load_calibration(jpath)
    from_port = jcal.load_calibration(tpath)
    for k in ref:
        np.testing.assert_array_equal(from_ref[k], ref[k])
        np.testing.assert_array_equal(from_port[k], mine[k])
    np.savez(str(tmp_path / "other.npz"), foo=np.zeros(3))
    with pytest.raises(ValueError, match="calibration artifact"):
        tcal.load_calibration(str(tmp_path / "other.npz"))
    with pytest.raises(ValueError, match="missing"):
        tcal.save_calibration(str(tmp_path / "x.npz"), {"ts": ref["ts"]})


def test_recorder_refuses_a_caching_runner(dit):
    *_, model = dit
    runner = CachedDiT(model, FastCacheConfig(), policy="fastcache")
    with pytest.raises(ValueError, match="uncached"):
        tcal.record_calibration(runner, batch=1, num_steps=2)


def _kappa(x: np.ndarray, ridge: float = 1e-4) -> float:
    """Condition number of ``fit_linear``'s ridge Gram for inputs x."""
    x = x.astype(np.float64)
    xc = x - x.mean(0)
    return float(np.linalg.cond(xc.T @ xc
                                + ridge * x.shape[0] * np.eye(x.shape[1])))


def _close_w(got: torch.Tensor, want, x: np.ndarray, name: str) -> None:
    """W within 8 * kappa * 2^-23 (relative Frobenius) of the
    reference's."""
    want = np.asarray(want)
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel <= 8.0 * _kappa(x) * 2.0 ** -23, (name, rel, _kappa(x))


def _close_pred(w, b, jw, jb, x: np.ndarray, name: str) -> None:
    """Predictions on the fit's own inputs, and at their mean (b), within
    1e-4 relative (Frobenius)."""
    for pts in (x, x.mean(0, keepdims=True)):
        got = (t32(pts) @ w + b).numpy()
        want = np.asarray(jnp.asarray(pts) @ jw + jb)
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= RTOL, (name, rel)


def test_fit_linear_equals_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((512, 24)).astype(np.float32)
    w_true = np.eye(24, dtype=np.float32) + 0.1 * rng.standard_normal(
        (24, 24)).astype(np.float32)
    y = (x @ w_true + 0.3 + 0.01 * rng.standard_normal((512, 24))
         ).astype(np.float32)
    w, b = linear_approx.fit_linear(t32(x), t32(y))
    jw, jb = jlinear.fit_linear(jnp.asarray(x), jnp.asarray(y))
    assert w.is_contiguous()
    _close_w(w, jw, x, "W")
    _close_pred(w, b, jw, jb, x, "fit")


def _batches(jcfg, n=4, batch=8, seed=0):
    rng = np.random.default_rng(seed)
    img, ch = jcfg.dit.image_size, jcfg.dit.in_channels
    out = []
    for _ in range(n):
        out.append({"latents": rng.standard_normal(
                        (batch, img, img, ch)).astype(np.float32),
                    "t": rng.integers(0, 1000, size=(batch,)).astype(
                        np.int32),
                    "labels": rng.integers(0, jcfg.dit.num_classes,
                                           size=(batch,)).astype(np.int32)})
    return out


@pytest.fixture(scope="module")
def fitted(dit):
    jcfg, jmodel, jparams, model = dit
    batches = _batches(jcfg)
    ref = jlinear.calibrate_dit(
        jmodel, jparams, None,
        [{k: jnp.asarray(v) for k, v in b.items()} for b in batches])
    mine = linear_approx.calibrate_dit(
        model, [{k: t32(v) for k, v in b.items()} for b in batches])
    return batches, ref, mine


def test_calibrate_dit_equals_reference(dit, fitted):
    jcfg, jmodel, jparams, model = dit
    batches, ref, mine = fitted
    assert set(mine) == set(ref)
    for k in ref:
        assert tuple(mine[k].shape) == tuple(ref[k].shape), k
        assert mine[k].dtype == torch.float32
    # each map's inputs: the tokens in, then every block's output
    acts = [[] for _ in range(jcfg.num_layers)]
    for bt in batches:
        x = model.tokens_in(t32(bt["latents"]))
        c = model.conditioning(t32(bt["t"]), t32(bt["labels"]))
        for l, bp in enumerate(model.blocks):
            acts[l].append(x.reshape(-1, jcfg.d_model).numpy())
            x = model.block_apply(bp, x, c)
    acts = [np.concatenate(a) for a in acts]
    for l in range(jcfg.num_layers):
        _close_w(mine["W_l"][l], ref["W_l"][l], acts[l], f"W_l[{l}]")
        _close_pred(mine["W_l"][l], mine["b_l"][l], ref["W_l"][l],
                    ref["b_l"][l], acts[l], f"layer {l}")
    _close_w(mine["W_c"], ref["W_c"], acts[0], "W_c")
    _close_pred(mine["W_c"], mine["b_c"], ref["W_c"], ref["b_c"], acts[0],
                "bypass")


def test_fitted_serve_matches_reference(dit, fitted):
    """A fastcache serve with the reference's fitted maps in both engines
    (the port's bridged from the reference's tree): gate decisions and
    counters exact, latents within 1e-4 of their scale; and the port's own
    fitted maps serve to the same decisions."""
    jcfg, jmodel, jparams, model = dit
    _, ref, mine = fitted
    trace = dict(num_requests=3, rate=0.5, seed=3, steps_mix=(6,),
                 guidance_mix=(4.0,), num_classes=jcfg.dit.num_classes)
    jeng = JEngine(JCachedDiT(jmodel, JFastCacheConfig(), fc_params=ref),
                   jparams, max_slots=2, num_steps=6, enable_metrics=False)
    jdone = jeng.run(jpoisson_trace(**trace))

    def serve(fc_params):
        eng = DiffusionServingEngine(
            CachedDiT(model, FastCacheConfig(), fc_params=fc_params),
            max_slots=2, num_steps=6,
            noise_fn=lambda r: t32(np.asarray(jeng.request_noise(r))))
        return eng, eng.run(poisson_trace(**trace))

    eng, done = serve(bridge.fc_params_from_jax(
        jax.tree.map(np.asarray, ref), "cpu"))
    assert [r.rid for r in done] == [r.rid for r in jdone]
    for r, jr in zip(done, jdone):
        assert r.cache == jr.cache, r.rid
        want = np.asarray(jr.latents)
        np.testing.assert_allclose(r.latents, want, rtol=0,
                                   atol=RTOL * float(np.abs(want).max()))
    stats = eng.cache_stats()
    assert stats["blocks_skipped"] == jeng.cache_stats()["blocks_skipped"]
    _, own = serve(mine)
    for r, jr in zip(own, jdone):
        for k in ("blocks_skipped", "blocks_computed"):
            assert r.cache[k] == jr.cache[k], (r.rid, k)


# ---------------------------------------------------------------------------
# fitted maps take the split route on the card
# ---------------------------------------------------------------------------

def test_only_bf16_exact_maps_get_a_bf16_copy(dit, fitted):
    """The wgmma route multiplies a single bf16 copy of W.  Only the
    identity maps of ``init_linear_params`` (the default, which bf16 holds
    exactly) get such copies; maps handed in, such as fitted ones (a bf16
    copy moved the static bypass by up to 8% rel-L2 on the card), get none:
    they get split copies, W as bf16 terms, which the wgmma_split route
    multiplies.  No call names a route either way, and the runners decide
    from where the maps came: no value is read."""
    from types import SimpleNamespace
    from repro_torch.core.policies.base import get_policy_class
    from repro_torch.cuda_kernels import route
    bf16, cuda = torch.bfloat16, torch.device("cuda")
    *_, model = dit
    _, _, mine = fitted
    ident = CachedDiT(model, FastCacheConfig()).impl
    served = CachedDiT(model, FastCacheConfig(), fc_params=mine).impl
    assert ident.gemm is None and served.gemm is None
    assert not ident.split_maps and served.split_maps
    # a bf16 CUDA model's fastcache: single copies for the identity maps,
    # split copies and no single one for maps handed in, none when the
    # calls name SIMT
    stub = SimpleNamespace(cfg=SimpleNamespace(num_layers=2, d_model=128),
                           device=cuda, dtype=bf16, num_tokens=16)
    cls = get_policy_class("fastcache")
    single = cls(stub, FastCacheConfig(), mine)
    assert all(torch.equal(c, w.to(bf16))
               for c, w in zip([single.w_c_bf16] + single.w_l_bf16,
                               [mine["W_c"]] + list(mine["W_l"])))
    split = cls(stub, FastCacheConfig(), mine, split_maps=True)
    for c, w in zip([split.w_c_bf16] + split.w_l_bf16,
                    [mine["W_c"]] + list(mine["W_l"])):
        assert c.shape != w.shape and route.is_split(c, w.shape[0])
        route.check_w_split(c, w)
        d, kp = w.shape[0], route.split_rows(w.shape[0])
        hi, mid = c[:d].float(), c[kp:kp + d].float()
        assert torch.equal(hi, w.to(bf16).float())
        assert torch.equal(mid, (w - hi).to(bf16).float())
    named = cls(stub, FastCacheConfig(), mine, split_maps=True,
                gemm=route.SIMT)
    assert named.w_c_bf16 is None and named.w_l_bf16 == [None, None]
    # ... so the served shape, bf16 and aligned, is wgmma_split by the rule
    # for a call that brings the split copy, wgmma for a single one, and
    # the split route raises without its copy
    aligned = (0, 4096, 1 << 20)
    assert route.gemm_route(bf16, 128, 128, aligned,
                            single.w_c_bf16) == "wgmma"
    assert route.gemm_route(bf16, 128, 128, aligned,
                            split.w_c_bf16) == "wgmma_split"
    with pytest.raises(ValueError, match="split"):
        route.check_w_split(named.w_c_bf16, mine["W_c"])
