"""The ported modules' leftovers against the reference: ``gate_mode=
"global"`` in ``CachedDiT`` and ``CachedDecoder``, the decode gate through
the ``saliency_delta`` / ``linear_blend`` wrappers, the DiT engine's
``cfg_rows=False`` fast path, and the LLM engine's ``greedy=False`` and
``collector=``.

Models: the small DiTs of ``tests/test_torch_model.py`` and the reduced
qwen3-0.6b of ``tests/test_torch_transformer.py``, in f32, with the
reference's parameters.  Tolerances: gate bits, block counters and token
streams exact; eps at the block-level f32 tolerance (rtol 1e-4, atol
1e-3), state and logits at 1e-4 as in the files those helpers come from;
the no-CFG fast path bitwise wherever this machine's GEMMs give a row the
same bits at both batch sizes (the test checks), else within 1e-4 of the
latents' scale with exact counters.
"""
import tests.torch_threads  # noqa: F401  (first: one thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FastCacheConfig as JFastCacheConfig
from repro.core import CachedDiT as JCachedDiT
from repro.core.decode_runner import CachedDecoder as JCachedDecoder
from repro.obs import metrics as jm
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs.base import FastCacheConfig
from repro_torch.core import decode_runner
from repro_torch.core.decode_runner import CachedDecoder
from repro_torch.core.runner import CachedDiT
from repro_torch.cuda_kernels.linear_blend import linear_blend
from repro_torch.cuda_kernels.saliency_delta import saliency_delta
from repro_torch.obs import metrics as tm
from repro_torch.serving.diffusion_engine import DiffusionServingEngine
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.serving.scheduler import DiffusionRequest, poisson_trace
from tests.test_torch_llm_serving import _state_close
from tests.test_torch_model import (BLOCK_TOL, SMALL_CONFIGS, jax_dit, np32,
                                    port_dit, t32)
from tests.test_torch_policies import (COUNTERS, SHRINK, STEPS,
                                       _assert_state_matches)
from tests.test_torch_transformer import (assert_close, jax_llm, port_llm,
                                          tokens, tt)

GLOBAL = dict(gate_mode="global")


@pytest.fixture(scope="module", params=SMALL_CONFIGS)
def pair(request):
    jcfg, jmodel, jparams = jax_dit(request.param)
    return jcfg, jmodel, jparams, port_dit(jcfg, jparams)


@pytest.fixture(scope="module")
def llm():
    _, jmodel, jparams = jax_llm("float32")
    return jmodel, jparams, port_llm("float32", jparams)


# ---------------------------------------------------------------------------
# gate_mode="global"
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["fastcache", "teacache", "adacache",
                                    "fbcache"])
def test_global_gate_dit_matches_reference(pair, policy):
    """Six CachedDiT steps in global mode (the whole batch makes one
    decision): counters (gate bits) exact every step, state and eps as
    the per-sample tests hold them; the gate fires."""
    jcfg, jmodel, jparams, model = pair
    jr = JCachedDiT(jmodel, JFastCacheConfig(**GLOBAL), policy=policy)
    tr = CachedDiT(model, FastCacheConfig(**GLOBAL), policy=policy)
    assert tr.gate_mode == tr.impl.gate_mode == "global"
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
        _assert_state_matches(ts, {k: v for k, v in js.items()
                                   if k != "gate"}, policy, i)
        if "gate" in js:
            np.testing.assert_array_equal(
                ts["gate"].initialized.numpy(),
                np.asarray(js["gate"].initialized))
            np.testing.assert_allclose(
                ts["gate"].sigma2.numpy(), np.asarray(js["gate"].sigma2),
                rtol=1e-4, err_msg=f"sigma2 diverges at step {i}")
        np.testing.assert_allclose(np32(te), np32(je), **BLOCK_TOL,
                                   err_msg=f"{policy}: eps at step {i}")
        x = x - SHRINK * np32(je)
    skipped = np32(ts["stats"]["blocks_skipped"])
    # one decision for the batch: every sample skipped the same blocks
    assert np.all(skipped == skipped[0])
    if policy == "fastcache":
        assert skipped[0] > 0


def test_global_gate_decoder_matches_reference(llm):
    """Eight teacher-forced decode steps on 3 slots in global mode, slot 1
    re-armed after step 4: logits, cache and gate state every step; one
    decision per layer for the batch."""
    jmodel, jparams, tmodel = llm
    jdec = JCachedDecoder(jmodel, JFastCacheConfig(**GLOBAL))
    tdec = CachedDecoder(tmodel, FastCacheConfig(**GLOBAL))
    prompt = tokens((3, 16), 11)
    _, cj = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)}, 32)
    _, ct = tmodel.prefill({"tokens": tt(prompt)}, 32)
    sj, st = jdec.init_state(3), tdec.init_state(3)
    feed = tokens((8, 3), 12)
    for i in range(8):
        if i == 4:
            sj = jdec.reset_slot(sj, 1)
            st = tdec.reset_slot(st, 1)
        lj, cj, sj = jdec.decode_step(jparams, jnp.asarray(feed[i]), cj, sj)
        lt, ct, st = tdec.decode_step(tt(feed[i]), ct, st)
        assert_close(lt, lj, "float32")
        _state_close(st, sj)
    skipped = st["stats"]["blocks_skipped"].numpy()
    assert np.all(skipped == skipped[0])


# ---------------------------------------------------------------------------
# the decode gate through the kernel wrappers
# ---------------------------------------------------------------------------

def test_decode_gate_reaches_the_kernel_wrappers(llm, monkeypatch):
    """Every decode step calls saliency_delta on (B, 1, D) rows and
    linear_blend at gamma 1 once per layer; on the CPU the wrappers launch
    nothing."""
    _, _, tmodel = llm
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kw):
            calls.append((name, tuple(args[0].shape), kw.get("gamma")))
            return fn(*args, **kw)
        monkeypatch.setattr(decode_runner, name, wrapped)

    spy("saliency_delta", saliency_delta)
    spy("linear_blend", linear_blend)
    dec = CachedDecoder(tmodel, FastCacheConfig())
    assert dec.w_l_bf16 == [None] * tmodel.cfg.num_layers   # f32 on the CPU
    _, cache = tmodel.prefill({"tokens": tt(tokens((2, 8), 3))}, 16)
    state = dec.init_state(2)
    launches = (saliency_delta.launches, linear_blend.launches)
    d, n_layers = tmodel.cfg.d_model, tmodel.cfg.num_layers
    for i in range(3):
        calls.clear()
        _, cache, state = dec.decode_step(tt(tokens((2,), 20 + i)), cache,
                                          state)
        assert sorted(calls) == sorted(
            [("saliency_delta", (2, 1, d), None)] * n_layers
            + [("linear_blend", (2, d), 1.0)] * n_layers)
    assert (saliency_delta.launches, linear_blend.launches) == launches


TRACES = {"serve_llm": (6, 16, 12, 4, 128), "ring": (5, 24, 10, 3, 16)}


def _requests(cls, n, prompt_len, new_tokens, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, 512, prompt_len).astype(
        np.int32), max_new_tokens=new_tokens) for i in range(n)]


def _jax_draw(logits: torch.Tensor, rid: int) -> int:
    """The reference engine's draw for a sampled first token."""
    return int(jax.random.categorical(jax.random.PRNGKey(rid),
                                      jnp.asarray(logits.numpy())))


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
@pytest.mark.parametrize("gate", ["per_sample", "global"])
@pytest.mark.parametrize("trace", sorted(TRACES))
def test_decode_gate_engine_matches_reference(llm, trace, gate, greedy):
    """The FastCache engine, its gate now on the kernel wrappers, serves
    the reference's token streams exactly, in both gate modes; sampled
    (``greedy=False``) with JAX's draw handed in through ``sample_fn``;
    with a collector on both sides, equal counters and histograms."""
    jmodel, jparams, tmodel = llm
    n, prompt_len, new_tokens, max_batch, window = TRACES[trace]
    jcol, tcol = jm.MetricsCollector(), tm.MetricsCollector()
    jeng = JServingEngine(jmodel, jparams, max_batch=max_batch,
                          window=window, greedy=greedy, collector=jcol,
                          fastcache=JFastCacheConfig(gate_mode=gate))
    teng = ServingEngine(tmodel, max_batch=max_batch, window=window,
                         greedy=greedy, collector=tcol,
                         sample_fn=None if greedy else _jax_draw,
                         fastcache=FastCacheConfig(gate_mode=gate))
    jdone = jeng.run(_requests(JRequest, n, prompt_len, new_tokens))
    tdone = teng.run(_requests(Request, n, prompt_len, new_tokens))
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    for a, b in zip(tdone, jdone):
        assert a.generated == b.generated, a.rid
    js, ts = jeng.cache_stats(), teng.cache_stats()
    assert ts == js
    assert 0.0 < ts["block_cache_ratio"] < 1.0
    assert tcol.totals() == jcol.totals()
    (w,), (jw,) = tcol.windows, jcol.windows
    assert w["histograms"] == jw["histograms"] and w["at_step"] == \
        jw["at_step"]
    assert tcol.totals()[tm.BLOCKS_SKIPPED] == ts["blocks_skipped"]
    assert tcol.to_prometheus() == jcol.to_prometheus()


def test_exact_engine_collector_matches_reference(llm):
    jmodel, jparams, tmodel = llm
    jcol, tcol = jm.MetricsCollector(), tm.MetricsCollector()
    jeng = JServingEngine(jmodel, jparams, max_batch=3, window=64,
                          collector=jcol)
    teng = ServingEngine(tmodel, max_batch=3, window=64, collector=tcol)
    jdone = jeng.run(_requests(JRequest, 4, 12, 6))
    tdone = teng.run(_requests(Request, 4, 12, 6))
    assert [r.generated for r in tdone] == [r.generated for r in jdone]
    assert tcol.totals() == jcol.totals()
    assert tm.BLOCKS_SKIPPED not in tcol.totals()
    assert tcol.to_prometheus() == jcol.to_prometheus()
    assert teng.host_syncs == 4 + teng.decode_steps


def test_default_sample_fn_is_seeded_by_rid(llm):
    """The port's own draw: a torch.Generator seeded by rid, so the same
    request draws the same first token on every engine."""
    _, _, tmodel = llm

    def first_tokens():
        eng = ServingEngine(tmodel, max_batch=2, window=32, greedy=False)
        done = eng.run(_requests(Request, 3, 8, 2))
        return [r.generated[0] for r in done]

    assert first_tokens() == first_tokens()
    logits = torch.zeros(512)
    logits[7] = 50.0
    eng = ServingEngine(tmodel, max_batch=1, window=8, greedy=False)
    assert eng.sample_token(logits, rid=3) == 7


# ---------------------------------------------------------------------------
# cfg_rows=False, the static no-CFG fast path
# ---------------------------------------------------------------------------

def _unguided_trace(ncls):
    return poisson_trace(4, 0.5, seed=2, num_classes=ncls,
                         steps_mix=(4, 6), guidance_mix=(1.0,))


def _batch_invariant(model, rows: int) -> bool:
    """Whether this machine's GEMMs give a block's rows the same bits at
    batch ``rows`` and at ``2 * rows`` (PyTorch's CPU GEMMs pick kernels
    by shape; at some widths they do not)."""
    dit = model.cfg.dit
    gen = torch.Generator().manual_seed(0)
    lat = torch.randn((2 * rows, dit.image_size, dit.image_size,
                       dit.in_channels), generator=gen)
    t = torch.arange(2 * rows) * 37
    lab = torch.arange(2 * rows) % dit.num_classes
    return torch.equal(model.apply(lat, t, lab)[:rows],
                       model.apply(lat[:rows], t[:rows], lab[:rows]))


@pytest.mark.parametrize("policy", ["fastcache", "teacache"])
def test_no_cfg_fast_path_is_bitwise(pair, policy):
    """At guidance 1.0 the one-row-per-slot engine runs half the model
    batch and gives the default engine's gate counters exactly and its
    latents bitwise, wherever the GEMMs give a row the same bits at both
    batch sizes (checked first); at a width where this machine's GEMMs do
    not, the latents are held to 1e-4 of their scale
    (``tests/test_torch_serving.py``) and the counters stay exact."""
    jcfg, _, _, model = pair
    ncls = jcfg.dit.num_classes

    def serve(cfg_rows):
        eng = DiffusionServingEngine(
            CachedDiT(model, FastCacheConfig(), policy=policy), max_slots=2,
            num_steps=6, guidance_scale=1.0, cfg_rows=cfg_rows,
            collector=tm.MetricsCollector())
        return eng, eng.run(_unguided_trace(ncls))

    fast, fast_done = serve(False)
    full, full_done = serve(True)
    assert fast.state["stats"]["blocks_computed"].shape == (2,)
    assert full.state["stats"]["blocks_computed"].shape == (4,)
    bitwise = _batch_invariant(model, 2)
    assert bitwise or jcfg.name != "dit-smoke"
    for a, b in zip(fast_done, full_done):
        assert a.rid == b.rid
        if bitwise:
            np.testing.assert_array_equal(a.latents, b.latents)
        else:
            np.testing.assert_allclose(
                a.latents, b.latents, rtol=0,
                atol=1e-4 * float(np.abs(b.latents).max()))
        for k in ("blocks_skipped", "steps_reused"):
            assert 2 * a.cache[k] == b.cache[k], (a.rid, k)
    for k in (tm.SERVE_STEPS, tm.ACTIVE_SLOT_STEPS):
        assert fast.collector.totals()[k] == full.collector.totals()[k]
    assert 2 * fast.collector.totals()[tm.BLOCKS_SKIPPED] == \
        full.collector.totals()[tm.BLOCKS_SKIPPED]


def test_no_cfg_fast_path_rejects_other_guidance(pair):
    *_, model = pair
    runner = CachedDiT(model, FastCacheConfig())
    with pytest.raises(ValueError, match="guidance==1.0"):
        DiffusionServingEngine(runner, max_slots=2, guidance_scale=4.0,
                               cfg_rows=False)
    eng = DiffusionServingEngine(runner, max_slots=2, num_steps=4,
                                 guidance_scale=1.0, cfg_rows=False)
    with pytest.raises(ValueError, match="cfg_rows=False"):
        eng.add_request(DiffusionRequest(rid=0, label=1,
                                         guidance_scale=4.0))
    assert eng.add_request(DiffusionRequest(rid=1, label=1))
