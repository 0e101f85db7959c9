"""The port's serving engine against the reference's, and the port's own
solo-replay contract.

Both engines serve the same Poisson trace (2 slots, steps mix 4/6,
guidance mix 1.0/4.0) with the same initial noise: the port's engine takes
the reference's ``request_noise`` through its ``noise_fn`` hook, since a
``torch.Generator`` cannot reproduce ``jax.random``.  Block counters,
per-request counters and plan rows must be equal exactly.  Finished
latents are held to 1e-4 of their own scale (max |latent|): with random
weights and 4-6 DDIM steps the x0 prediction divides eps by sqrt(alpha_bar)
(down to ~0.006), so latents reach ~500 and carry the eps error of
test_torch_model.py (~1e-5 relative) scaled up with them.

Solo replay.  The port's CPU GEMMs are not batch-shape invariant: a single
row (M=1, a matrix-vector product) is summed in another order than the same
row inside a batch.  A request replayed with the per-sample guidance form
(a (1,) tensor, which materializes the CFG rows as the engine does) is
bitwise; one replayed with a scalar 1.0 runs a batch of one and is held to
exact gates and latents within 2e-5 of their scale instead.
"""
import numpy as np
import pytest
import torch

from repro.configs.base import FastCacheConfig as JFastCacheConfig
from repro.core import CachedDiT as JCachedDiT
from repro.serving import DiffusionServingEngine as JEngine
from repro.serving import RequestQueue as JRequestQueue
from repro.serving import SamplingPlan as JSamplingPlan
from repro.serving import poisson_trace as jpoisson_trace
from repro_torch.configs.base import FastCacheConfig
from repro_torch.core.runner import CachedDiT
from repro_torch.diffusion.sampler import sample
from repro_torch.serving.diffusion_engine import DiffusionServingEngine
from repro_torch.serving.scheduler import (RequestQueue, SamplingPlan,
                                           poisson_trace)
from tests.test_torch_model import jax_dit, port_dit, t32

STEPS_MIX = (4, 6)
LATENT_REL = 1e-4
GUIDANCE_MIX = (1.0, 4.0)
TRACE = dict(num_requests=5, rate=0.5, seed=3, steps_mix=STEPS_MIX,
             guidance_mix=GUIDANCE_MIX)


@pytest.fixture(scope="module")
def served():
    jcfg, jmodel, jparams = jax_dit("smoke")
    model = port_dit(jcfg, jparams)
    ncls = jcfg.dit.num_classes
    jeng = JEngine(JCachedDiT(jmodel, JFastCacheConfig()), jparams,
                   max_slots=2, num_steps=6, max_steps=6,
                   enable_metrics=False)
    jdone = jeng.run(jpoisson_trace(num_classes=ncls, **TRACE))

    def noise(req):
        return t32(np.asarray(jeng.request_noise(req)))

    runner = CachedDiT(model, FastCacheConfig())
    eng = DiffusionServingEngine(runner, max_slots=2, num_steps=6,
                                 max_steps=6, noise_fn=noise)
    done = eng.run(poisson_trace(num_classes=ncls, **TRACE))
    return model, jeng, jdone, eng, done, noise


def test_engine_matches_reference(served):
    _, jeng, jdone, eng, done, _ = served
    assert [r.rid for r in done] == [r.rid for r in jdone]
    for r, jr in zip(done, jdone):
        assert (r.num_steps, r.guidance_scale, r.admit_step,
                r.finish_step) == (jr.num_steps, jr.guidance_scale,
                                   jr.admit_step, jr.finish_step)
        assert r.cache == {k: jr.cache[k] for k in r.cache}, r.rid
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
    # the trace mixes plans and both guidance branches
    assert {r.num_steps for r in done} == set(STEPS_MIX)
    assert {r.guidance_scale for r in done} == set(GUIDANCE_MIX)


def _replay(model, req, noise, guidance):
    solo = CachedDiT(model, FastCacheConfig())
    x, state = sample(solo, batch=1, labels=torch.tensor([req.label]),
                      num_steps=req.num_steps, guidance_scale=guidance,
                      x_init=noise(req)[None])
    return x[0].numpy(), state["stats"]


def test_solo_replay_is_bitwise(served):
    """Every finished request replays its solo ``sample()`` run exactly,
    under its own plan, with the same request-scoped counters."""
    model, _, _, _, done, noise = served
    for r in done:
        x, stats = _replay(model, r, noise, torch.tensor([r.guidance_scale]))
        msg = (f"rid={r.rid} plan=({r.num_steps}, {r.guidance_scale}) "
               f"admit_step={r.admit_step}")
        np.testing.assert_array_equal(x, r.latents, err_msg=msg)
        assert r.cache == {k: float(v.sum()) for k, v in stats.items()
                           if v.dim() == 1}, msg


def test_unguided_scalar_replay(served):
    """Scalar guidance 1.0 replays as a batch of one: same gates as the
    CFG-row replay's cond row, latents equal up to M=1 GEMM rounding."""
    model, _, _, _, done, noise = served
    unguided = [r for r in done if r.guidance_scale == 1.0]
    assert unguided
    for r in unguided:
        x, stats = _replay(model, r, noise, 1.0)
        _, stats_rows = _replay(model, r, noise, torch.tensor([1.0]))
        for k, v in stats.items():
            if v.dim() == 1:
                assert float(v[0]) == float(stats_rows[k][0]), (r.rid, k)
        np.testing.assert_allclose(
            x, r.latents, rtol=0,
            atol=2e-5 * float(np.abs(r.latents).max()),
            err_msg=f"rid={r.rid}")


def test_trace_and_plans_match_reference():
    kw = dict(TRACE, num_classes=10)
    mine, ref = poisson_trace(**kw), jpoisson_trace(**kw)
    assert [(r.rid, r.label, r.seed, r.arrival_step, r.num_steps,
             r.guidance_scale) for r in mine] == \
        [(r.rid, r.label, r.seed, r.arrival_step, r.num_steps,
          r.guidance_scale) for r in ref]
    for n in (1, 3, 4, 6, 7):
        for a, b in zip(SamplingPlan(n).rows(8), JSamplingPlan(n).rows(8)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("policy", ["fifo", "sjf"])
def test_queue_order_matches_reference(policy):
    kw = dict(num_requests=12, rate=2.0, seed=5, num_classes=10,
              steps_mix=(2, 5, 9))
    q, jq = (RequestQueue(poisson_trace(**kw), policy=policy),
             JRequestQueue(jpoisson_trace(**kw), policy=policy))
    order, jorder = [], []
    for now in range(20):
        for queue, out in ((q, order), (jq, jorder)):
            req = queue.pop_arrived(now)
            if req is not None:
                out.append(req.rid)
    assert order == jorder and len(order) == 12


def test_serve_launcher_on_cpu():
    from repro_torch.launch.serve_diffusion import parse_args, serve
    out = serve(parse_args(["--reduced", "--device", "cpu", "--requests", "2",
                            "--slots", "2", "--steps", "3"]))
    assert out["device"] == "cpu" and out["finished"] == 2
    assert out["model_steps"] > 0 and 0.0 <= out["block_cache_ratio"] <= 1.0


def test_run_resumes_at_an_engine_clock():
    """``run(queue, max_engine_steps=k)`` stops at clock k and a second
    ``run`` on the same queue carries on (the profiler's window relies on
    it): the split serve finishes the same requests with the same latents."""
    from repro_torch.launch.serve_diffusion import Workload
    wl = Workload(reduced=True, requests=3, slots=2, steps=4)
    model = wl.build_model("cpu")
    whole = wl.build_engine(model)[1].run(wl.build_trace(model))
    _, eng = wl.build_engine(model)
    queue = RequestQueue(wl.build_trace(model))
    split = eng.run(queue, max_engine_steps=3)
    assert eng.clock == 3
    split += eng.run(queue)
    assert [r.rid for r in split] == [r.rid for r in whole]
    for a, b in zip(split, whole):
        np.testing.assert_array_equal(a.latents, b.latents)
