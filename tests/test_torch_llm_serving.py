"""The port's LLM serving path against the live reference: the FastCache
decode gate (``CachedDecoder``), the ``ServingEngine`` and the launcher.

Model: the reduced qwen3-0.6b in f32 with the reference's parameters
(``tests/test_torch_transformer.py``).  Gate bits, skip counters, tracker
flags, cache positions and greedy tokens are exact; sigma2 within 1e-6
relative (f32 EMA of sums taken in another order); logits, hidden states
and K/V rtol/atol 1e-4 (f32).  Every greedy token of the traces below
matches the reference's, so no step needed teacher forcing.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import FastCacheConfig as JFastCacheConfig
from repro.core.decode_runner import CachedDecoder as JCachedDecoder
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs.base import FastCacheConfig
from repro_torch.core.decode_runner import CachedDecoder
from repro_torch.serving.engine import Request, ServingEngine
from tests.test_torch_transformer import (assert_close, jax_llm, port_llm,
                                          tokens, tt)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def llm():
    _, jm, jp = jax_llm("float32")
    return jm, jp, port_llm("float32", jp)


def _state_close(st, sj):
    for k in ("blocks_computed", "blocks_skipped"):
        assert np.array_equal(st["stats"][k].numpy(),
                              np.asarray(sj["stats"][k])), k
    assert float(st["stats"]["steps"]) == float(sj["stats"]["steps"])
    assert np.array_equal(st["gate"].initialized.numpy(),
                          np.asarray(sj["gate"].initialized))
    assert np.array_equal(st["have_cache"].numpy(),
                          np.asarray(sj["have_cache"]))
    np.testing.assert_allclose(st["gate"].sigma2.numpy(),
                               np.asarray(sj["gate"].sigma2), rtol=1e-6)
    assert_close(st["prev_hidden"], sj["prev_hidden"], "float32")


def test_cached_decoder_steps_with_a_slot_reset(llm):
    """8 teacher-forced decode steps on 3 slots from a prefilled cache, slot
    1 re-armed after step 4: logits, cache and the whole gate state after
    every step.  Both of the reference's branches run (every sample skips;
    mixed)."""
    jm, jp, tm = llm
    fc_j, fc_t = JFastCacheConfig(), FastCacheConfig()
    jdec, tdec = JCachedDecoder(jm, fc_j), CachedDecoder(tm, fc_t)
    prompt = tokens((3, 16), 11)
    _, cj = jm.prefill(jp, {"tokens": jnp.asarray(prompt)}, 32)
    _, ct = tm.prefill(tt(prompt), 32)
    sj, st = jdec.init_state(3), tdec.init_state(3)
    feed = tokens((8, 3), 12)
    mixed = 0
    for i in range(8):
        if i == 4:
            sj = jdec.reset_slot(sj, 1)
            st = tdec.reset_slot(st, 1)
            _state_close(st, sj)
        skipped = np.asarray(sj["stats"]["blocks_skipped"])
        lj, cj, sj = jdec.decode_step(jp, jnp.asarray(feed[i]), cj, sj)
        lt, ct, st = tdec.decode_step(tt(feed[i]), ct, st)
        step_skips = np.asarray(sj["stats"]["blocks_skipped"]) - skipped
        mixed += int(step_skips.max() > step_skips.min())   # samples differ
        assert_close(lt, lj, "float32")
        _state_close(st, sj)
        blk = cj["blocks"]["pos0"]
        assert np.array_equal(ct["pos"].numpy(), np.asarray(blk["pos"]))
        assert_close(ct["k"], blk["k"], "float32")
        assert_close(ct["v"], blk["v"], "float32")
    assert tdec.skipped_layers > 0 and mixed > 0
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


def _requests(cls, n, prompt_len, new_tokens, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, 512, prompt_len).astype(
        np.int32), max_new_tokens=new_tokens) for i in range(n)]


@pytest.mark.parametrize("trace", sorted(TRACES))
@pytest.mark.parametrize("fastcache", [False, True], ids=["exact",
                                                          "fastcache"])
def test_engine_trace_matches_reference(llm, trace, fastcache):
    jm, jp, tm = llm
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
def test_launcher_runs_on_the_cpu(extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "qwen3-0.6b", "--reduced", "--device", "cpu", "--json", *extra]
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["finished"] == out["requests"] == 8
    assert out["tokens"] == 8 * 64
    assert out["host_syncs_per_decode_step"] == (3.0 if extra else 1.0)
    assert ("block_cache_ratio" in out) == bool(extra)
