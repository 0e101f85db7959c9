"""The port's LLM serving path against the live reference: the FastCache
decode gate (``CachedDecoder``), the ``ServingEngine`` and the launcher.

Models: the reduced qwen3-0.6b, arctic-480b and kimi-k2-1t-a32b in f32
with the reference's parameters (``tests/test_torch_transformer.py``),
the VLM qwen2-vl-2b (M-RoPE; text-only prompts, as the engine serves
them) for the decode gate and the ``serve_llm`` trace, and for the exact
engine traces also the hybrid jamba-v0.1-52b and the SSM xlstm-1.3b (the
decode gate refuses both, as the reference's does); the
MoE configs at their own capacity factor 1.25, so a prefill drops copies
(16 prompt tokens, 32 copies, 10 slots an expert) and the decode gate's
mixed branch routes the cached slots' tokens with the others.  Gate bits,
skip counters, tracker flags, cache positions and greedy tokens are exact;
sigma2 within 1e-6 relative (f32 EMA of sums taken in another order);
logits, hidden states and K/V rtol/atol 1e-4 (f32), of the tensor's scale
for the MoE configs (no qk-norm; ``tests/test_torch_transformer.py``
measures why).  Every greedy token of the traces below matches the
reference's, so no step needed teacher forcing.
"""
import tests.torch_threads  # noqa: F401  (first: one thread)
import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import FastCacheConfig as JFastCacheConfig
from repro.core.decode_runner import CachedDecoder as JCachedDecoder
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs.base import FastCacheConfig
from repro_torch.core.decode_runner import CachedDecoder
from repro_torch.launch import serve
from repro_torch.serving.engine import Request, ServingEngine
from tests.test_torch_transformer import (BASE_ARCH, MOE_ARCHS, Tol,
                                          assert_close, jax_llm, pair_tol,
                                          port_llm, tokens, tt)

SERVE_ARCHS = (BASE_ARCH,) + MOE_ARCHS
SSM_ARCHS = ("jamba-v0.1-52b", "xlstm-1.3b")     # served exact only
VLM_ARCH = "qwen2-vl-2b"                          # the serve_llm trace only


@functools.lru_cache(maxsize=None)
def _llm(arch: str):
    _, jm, jp = jax_llm("float32", arch=arch)
    return jm, jp, port_llm("float32", jp, arch)


@pytest.fixture(scope="module")
def llm():
    return _llm(BASE_ARCH)


def _state_close(st, sj, tol="float32"):
    for k in ("blocks_computed", "blocks_skipped"):
        assert np.array_equal(st["stats"][k].numpy(),
                              np.asarray(sj["stats"][k])), k
    assert float(st["stats"]["steps"]) == float(sj["stats"]["steps"])
    assert np.array_equal(st["gate"].initialized.numpy(),
                          np.asarray(sj["gate"].initialized))
    assert np.array_equal(st["have_cache"].numpy(),
                          np.asarray(sj["have_cache"]))
    # sigma2 sums squares of the block inputs' changes: 1e-6 where the
    # config is well conditioned, f32's 1e-4 where its hidden states carry
    # the no-qk-norm attention's rounding (the MoE configs; measured 3.9e-6)
    rtol = 1e-4 if isinstance(tol, Tol) and tol.scaled else 1e-6
    np.testing.assert_allclose(st["gate"].sigma2.numpy(),
                               np.asarray(sj["gate"].sigma2), rtol=rtol)
    assert_close(st["prev_hidden"], sj["prev_hidden"], tol)


def test_cached_decoder_steps_with_a_slot_reset(llm):
    """8 teacher-forced decode steps on 3 slots from a prefilled cache, slot
    1 re-armed after step 4: logits, cache and the whole gate state after
    every step.  Both of the reference's branches run (every sample skips;
    mixed)."""
    _decoder_steps(*llm, pair_tol(BASE_ARCH, "float32"))


@pytest.mark.parametrize("arch", MOE_ARCHS + (VLM_ARCH,))
def test_cached_decoder_steps_over_moe_blocks(arch):
    """The same 8 steps over MoE blocks: the mixed branch runs the MoE on
    the whole batch, cached slots included, the all-skip branch no MoE;
    and over the VLM's M-RoPE attention blocks, whose skipped layers write
    K rotated by the step on all three axes (``_kv_write``)."""
    _decoder_steps(*_llm(arch), pair_tol(arch, "float32"))


def _decoder_steps(jm, jp, tm, tol):
    fc_j, fc_t = JFastCacheConfig(), FastCacheConfig()
    jdec, tdec = JCachedDecoder(jm, fc_j), CachedDecoder(tm, fc_t)
    prompt = tokens((3, 16), 11)
    _, cj = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, 32)
    _, ct = tm.prefill({"tokens": tt(prompt)}, 32)
    sj, st = jdec.init_state(3), tdec.init_state(3)
    feed = tokens((8, 3), 12)
    mixed = 0
    for i in range(8):
        if i == 4:
            sj = jdec.reset_slot(sj, 1)
            st = tdec.reset_slot(st, 1)
            _state_close(st, sj, tol)
        skipped = np.asarray(sj["stats"]["blocks_skipped"])
        lj, cj, sj = jdec.decode_step(jp, jnp.asarray(feed[i]), cj, sj)
        lt, ct, st = tdec.decode_step(tt(feed[i]), ct, st)
        step_skips = np.asarray(sj["stats"]["blocks_skipped"]) - skipped
        mixed += int(step_skips.max() > step_skips.min())   # samples differ
        assert_close(lt, lj, tol)
        _state_close(st, sj, tol)
        blk = cj["blocks"]["pos0"]
        assert np.array_equal(ct["pos"].numpy(), np.asarray(blk["pos"]))
        assert_close(ct["k"], blk["k"], tol)
        assert_close(ct["v"], blk["v"], tol)
    assert float(st["stats"]["layers_skipped"]) > 0 and mixed > 0
    assert tdec.host_syncs == 8 * tm.cfg.num_layers


def test_cached_decoder_rejects_global_gate(llm):
    """The global gate is ported now (its parity is in
    test_torch_leftovers.py): the decoder takes the reference's two gate
    modes and rejects any other, as the reference's CachedDiT does."""
    _, _, tm = llm
    assert CachedDecoder(tm, FastCacheConfig(gate_mode="global")
                         ).gate_mode == "global"
    with pytest.raises(ValueError, match="per_sample"):
        CachedDecoder(tm, FastCacheConfig(gate_mode="batch"))


# (requests, prompt, new tokens, max_batch, window): the serve_llm.py-style
# trace, and one whose prompts outrun the window (the ring's rotation)
TRACES = {"serve_llm": (6, 16, 12, 4, 128), "ring": (5, 24, 10, 3, 16)}
# (arch, trace, fastcache) of the engine test, the hybrid and SSM archs
# exact only; qwen3-0.6b's ids are the mode and the trace alone
ARCH_TRACES = [(a, t, fc) for fc in (False, True)
               for a in SERVE_ARCHS + SSM_ARCHS + (VLM_ARCH,)
               for t in sorted(TRACES)
               if not (fc and a in SSM_ARCHS)
               and not (a == VLM_ARCH and t != "serve_llm")]
ARCH_TRACE_IDS = [("fastcache" if fc else "exact")
                  + ("" if a == BASE_ARCH else f"-{a}") + f"-{t}"
                  for a, t, fc in ARCH_TRACES]


def _requests(cls, n, prompt_len, new_tokens, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, 512, prompt_len).astype(
        np.int32), max_new_tokens=new_tokens) for i in range(n)]


@pytest.mark.parametrize("arch,trace,fastcache", ARCH_TRACES,
                         ids=ARCH_TRACE_IDS)
def test_engine_trace_matches_reference(arch, trace, fastcache):
    """Greedy token streams of the port's engine against the live
    reference's.  The hybrid / SSM traces catch a cache leaf the admission
    does not splice: a slot would then decode from another request's
    mixer state."""
    jm, jp, tm = _llm(arch)
    n, prompt_len, new_tokens, max_batch, window = TRACES[trace]
    jeng = JServingEngine(jm, jp, max_batch=max_batch, window=window,
                          fastcache=JFastCacheConfig() if fastcache else None)
    teng = ServingEngine(tm, max_batch=max_batch, window=window,
                         fastcache=FastCacheConfig() if fastcache else None)
    jdone = jeng.run(_requests(JRequest, n, prompt_len, new_tokens))
    tdone = teng.run(_requests(Request, n, prompt_len, new_tokens))
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    for a, b in zip(tdone, jdone):
        assert a.generated == b.generated, a.rid
        assert len(a.generated) == new_tokens and a.done
    js, ts = jeng.cache_stats(), teng.cache_stats()
    assert set(ts) == set(js)
    for k in js:
        assert ts[k] == js[k], k                   # counters: exact
    if fastcache:
        assert 0.0 < ts["block_cache_ratio"] < 1.0
    assert teng.prefills == n
    assert teng.host_syncs == n + teng.decode_steps


def test_engine_raises_on_unported_options(llm):
    """``greedy=False`` and ``collector=`` are ported now (their parity is
    in test_torch_leftovers.py): the engine takes both, and the sampled
    engine draws through its ``sample_fn`` hook."""
    from repro_torch.obs.metrics import MetricsCollector
    _, _, tm = llm
    eng = ServingEngine(tm, max_batch=2, window=16, greedy=False,
                        collector=MetricsCollector())
    assert eng.sample_fn is not None and eng.collector is not None


@pytest.mark.parametrize("extra", [[], ["--fastcache"]],
                         ids=["exact", "fastcache"])
def test_launcher_runs_on_the_cpu(capsys, extra):
    """The launcher's defaults (8 prompts of 512 tokens, 64 new tokens)
    on the reduced model."""
    serve.main(["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
                "--json", *extra])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["finished"] == out["requests"] == 8
    assert out["tokens"] == 8 * 64
    assert out["host_syncs_per_decode_step"] == (3.0 if extra else 1.0)
    assert ("block_cache_ratio" in out) == bool(extra)


@pytest.mark.parametrize("arch", ["arctic-480b", "stablelm-3b"])
def test_launcher_serves_every_llm_id(capsys, arch):
    """``--arch`` takes the registered LLM ids beyond qwen3-0.6b (an MoE
    and a dense one) and ``--num-layers`` cuts the depth at the config's
    width (here 1 layer of the reduced config)."""
    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--json",
                "--fastcache", "--num-layers", "1", "--requests", "3",
                "--new-tokens", "6"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["num_layers"] == 1 and out["arch"].endswith("-smoke")
    assert out["finished"] == 3 and out["tokens"] == 3 * 6
    assert out["host_syncs_per_decode_step"] == 2.0        # L + 1
