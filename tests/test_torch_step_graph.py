"""The in-place steps, the host mirror and the block-skip branch that the
captured step graphs rest on (``core/step_graph.py``), on the CPU.

A captured warm step replays the policy's device work on the same state
tensors and takes each "every sample caches: skip the block" branch on the
device (an IF node).  What that needs, and what a CPU can check:

- the host mirror of ``have_cache`` / ``step_count`` equals the device
  leaves after every engine step of a serve with mid-flight admissions, a
  slot freed and reused, and a preempt / resume, without a device read;
- the in-place step functions, fed the reference's state before every
  step, give the reference's result: gate bits and counters exactly, the
  hidden stack and eps within the block-level f32 tolerance of
  ``tests/test_torch_model.py`` (rtol 1e-4, atol 1e-3: a full block forward
  in f32 moves small elements by up to 6.4e-4 against the reference, so the
  kernels' 1e-4 of ``tests/test_kernels.py`` is a kernel's, not a block
  stack's), the trackers' sigma2 within rtol 1e-4; the decode gate's
  in-place step is held to the reference in
  ``tests/test_torch_llm_serving.py`` (every step, a slot reset between);
- forcing the compute side of the branch on a layer where every sample
  caches gives the skip side's carry bitwise: that is what lets the IF
  node stand in for ``lax.cond``;
- the hook's plain version, the counters' arithmetic and the refusals off
  the card.

The graphs themselves (capture, replay, IF nodes) run only on the card:
``tests/test_torch_cuda.py -k step_graph``.
"""
import tests.torch_threads  # noqa: F401  (first: one thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FastCacheConfig as JFastCacheConfig
from repro.core import CachedDiT as JCachedDiT
from repro_torch.configs.base import FastCacheConfig
from repro_torch.core import statcache, step_graph
from repro_torch.core.decode_runner import CachedDecoder
from repro_torch.core.policies import base as policy_base
from repro_torch.core.runner import CachedDiT
from repro_torch import cuda_kernels
from repro_torch.cuda_kernels import ref
from repro_torch.cuda_kernels.cond_node import if_all
from repro_torch.launch.serve import LLMWorkload
from repro_torch.launch.serve_diffusion import Workload
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import DiffusionRequest
from tests.test_torch_model import BLOCK_TOL, jax_dit, np32, port_dit, t32
from tests.test_torch_transformer import BASE_ARCH, tt

MIRRORED_POLICIES = ("fastcache", "fora", "smoothcache", "teacache")


def _llm():
    """The reduced base LLM, its weights from a seed: the tests that need
    it hold the port against itself, so no reference is built."""
    return LLMWorkload(arch=BASE_ARCH, reduced=True).build_model("cpu")


@pytest.fixture(scope="module")
def smoke():
    jcfg, jmodel, jparams = jax_dit("smoke")
    return jcfg, jmodel, jparams, port_dit(jcfg, jparams)


# ---------------------------------------------------------------------------
# the host mirror through a served trace
# ---------------------------------------------------------------------------

def _mirror_matches(runner, state):
    impl = runner.impl
    host = impl.mirror_of(state)
    assert host is not None, "the mirror lost its state"
    for k, v in host.items():
        np.testing.assert_array_equal(v, state[k].numpy(), err_msg=k)


@pytest.mark.parametrize("policy", MIRRORED_POLICIES)
def test_host_mirror_follows_the_serve(policy):
    """Two slots, four requests: admissions mid-flight, slots freed and
    reused, one request preempted and resumed in another slot.  After every
    engine step, admission, preempt and resume the mirror equals the device
    leaves; fora's and smoothcache's never read the device."""
    wl = Workload(reduced=True, slots=2, steps=5, policy=policy)
    model = wl.build_model("cpu")
    runner, eng = wl.build_engine(model)
    assert not runner.step_graph                # no graphs off the card
    reqs = [DiffusionRequest(rid=i, label=i + 1, seed=20 + i, num_steps=5,
                             guidance_scale=4.0) for i in range(4)]
    done = []

    def check():
        _mirror_matches(runner, eng.state)

    def step():
        done.extend(eng.step())
        check()

    assert eng.add_request(reqs[0])
    check()
    step()                                          # cold
    assert eng.add_request(reqs[1])
    check()
    step()                                          # mixed
    step()                                          # warm
    parked = eng.preempt(eng.slots.index(reqs[1]))
    check()
    assert eng.add_request(reqs[2])                 # into the donor slot
    check()
    step()
    admitted = {0, 1, 2}
    for _ in range(40):
        if len(done) == len(reqs):
            break
        if eng.free_slots():
            if parked.snapshot is not None:
                assert eng.add_request(parked)      # resumed
            elif 3 not in admitted:
                assert eng.add_request(reqs[3])
                admitted.add(3)
            check()
        step()
    kinds = runner.impl.step_kinds
    assert kinds["cold"] + kinds["mixed"] >= 3 and kinds["warm"] > 0
    assert sorted(r.rid for r in done) == [0, 1, 2, 3]
    assert parked.preemptions == 1 and parked.snapshot is None
    if policy in ("fora", "smoothcache"):
        # their schedules are known on the host: nothing read at all
        assert runner.impl.host_syncs == 0


def test_mirror_rebinds_by_reading_a_foreign_state(smoke):
    """A state the mirror is not bound to (here: its leaves replaced) is
    read once, counted, and the mirror binds to it."""
    jcfg, _, _, model = smoke
    runner = CachedDiT(model, FastCacheConfig(), policy="fora")
    state = runner.init_state(2)
    assert runner.impl.mirror_of(state) is not None
    state["have_cache"] = torch.ones(2, dtype=torch.bool)
    state["step_count"] = torch.tensor([3, 4], dtype=torch.int32)
    assert runner.impl.mirror_of(state) is None
    host = runner.impl.host_flags(state)
    assert runner.impl.host_syncs == 1
    np.testing.assert_array_equal(host["step_count"], [3, 4])
    assert host["have_cache"].all()
    assert runner.impl.mirror_of(state) is host


# ---------------------------------------------------------------------------
# the in-place steps against the reference, fed the same state
# ---------------------------------------------------------------------------

def _port_state(tr, js, batch):
    """The reference's state as fresh port tensors (new identities: the
    mirror reads them once)."""
    def conv(v):
        return torch.from_numpy(np.array(v))

    ts = tr.init_state(batch)
    out = {}
    for k, v in ts.items():
        if k == "gate":
            out[k] = statcache.GateState(
                sigma2=conv(js["gate"].sigma2),
                initialized=conv(js["gate"].initialized))
        elif isinstance(v, dict):
            out[k] = {kk: conv(js[k][kk]) for kk in v}
        else:
            out[k] = conv(js[k]).to(v.dtype)
    return out


@pytest.mark.parametrize("policy", ["fastcache", "teacache", "fora"])
def test_inplace_steps_match_reference_on_the_same_state(smoke, policy):
    """Six steps of 4 rows, rows 1 and 3 re-armed before step 3 (a mixed
    step for fastcache): before each step the port's state is the
    reference's, so every step is compared on the same inputs."""
    jcfg, jmodel, jparams, model = smoke
    jr = JCachedDiT(jmodel, JFastCacheConfig(), policy=policy)
    tr = CachedDiT(model, FastCacheConfig(), policy=policy)
    b = 4
    rng = np.random.default_rng(3)
    img, ch = jcfg.dit.image_size, jcfg.dit.in_channels
    x = rng.standard_normal((b, img, img, ch)).astype(np.float32)
    labels = np.array([1, 2, 3, 4], np.int32)
    js = jr.init_state(b)
    jstep = jax.jit(jr.step)
    for i in range(6):
        if i == 3:
            js = jr.reset_slot(js, np.array([1, 3]))
        ts = _port_state(tr, js, b)
        t = np.full((b,), 40 - 3 * i, np.int32)
        je, js = jstep(jparams, js, jnp.asarray(x), jnp.asarray(t),
                       jnp.asarray(labels))
        te, ts_out = tr.step(ts, t32(x), t32(t), t32(labels))
        assert ts_out is ts                          # written in place
        for k in ("blocks_computed", "blocks_skipped", "steps_reused"):
            np.testing.assert_array_equal(
                np32(ts["stats"][k]), np32(js["stats"][k]),
                err_msg=f"{policy}: counter {k} at step {i}")
        np.testing.assert_array_equal(ts["have_cache"].numpy(),
                                      np.asarray(js["have_cache"]))
        if policy == "fastcache":
            np.testing.assert_array_equal(
                ts["gate"].initialized.numpy(),
                np.asarray(js["gate"].initialized),
                err_msg=f"tracker bits at step {i}")
            np.testing.assert_allclose(
                ts["gate"].sigma2.numpy(), np.asarray(js["gate"].sigma2),
                rtol=1e-4, err_msg=f"sigma2 at step {i}")
            np.testing.assert_allclose(
                np32(ts["prev_hidden"]), np32(js["prev_hidden"]), **BLOCK_TOL,
                err_msg=f"hidden stack at step {i}")
        elif policy == "teacache":
            np.testing.assert_allclose(np32(ts["tea_acc"]),
                                       np32(js["tea_acc"]), rtol=1e-4)
        else:
            np.testing.assert_array_equal(ts["step_count"].numpy(),
                                          np.asarray(js["step_count"]))
        np.testing.assert_allclose(np32(te), np32(je), **BLOCK_TOL,
                                   err_msg=f"{policy}: eps at step {i}")
        x = x - 0.05 * np32(je)
    if policy == "fastcache":
        assert tr.impl.step_kinds == {"cold": 1, "mixed": 1, "warm": 4}
    assert float(np.sum(np32(js["stats"]["blocks_skipped"]))) > 0


# ---------------------------------------------------------------------------
# the two sides of the branch give the same carry
# ---------------------------------------------------------------------------

def _forced(seen):
    """A ``step_graph.branch`` that records whether every sample cached and
    always takes the compute side."""
    def force(every, compute, skip=None, known=None, cond=None):
        seen.append(bool(every.all()))
        compute()
        return 0
    return force


def _recording(seen):
    real = step_graph.branch

    def rec(every, compute, skip=None, known=None, cond=None):
        seen.append(bool(every.all()))
        return real(every, compute, skip, known, cond=cond)
    return rec


def _leaves(tree):
    return step_graph._tensors(tree)


@pytest.mark.parametrize("policy", ["fastcache", "teacache", "smoothcache"])
def test_forced_compute_side_gives_the_skip_sides_carry(smoke, monkeypatch,
                                                        policy):
    """The same static drive twice, once through the branch as it is and
    once with the compute side forced: eps and every state leaf bitwise
    equal at every step, over layers (or steps) where every sample
    cached."""
    jcfg, _, _, model = smoke
    img, ch = jcfg.dit.image_size, jcfg.dit.in_channels
    x = t32(np.random.default_rng(0).standard_normal(
        (2, img, img, ch)).astype(np.float32))
    labels = torch.tensor([1, 2])
    outs, all_cached = [], []
    for patch in (_recording, _forced):
        seen = []
        monkeypatch.setattr(policy_base, "branch", patch(seen))
        runner = CachedDiT(model, FastCacheConfig(), policy=policy)
        state = runner.init_state(2)
        eps = []
        for _ in range(6):
            e, state = runner.step(state, x, torch.full((2,), 25), labels)
            eps.append(e.clone())
        outs.append((eps, [t.clone() for t in _leaves(state)]))
        all_cached.append(seen)
    assert all_cached[0] == all_cached[1] and any(all_cached[0])
    for a, b in zip(outs[0][0], outs[1][0]):
        assert torch.equal(a, b)
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)


def test_forced_compute_side_in_the_decode_gate(monkeypatch):
    """The decode gate on a repeated token: with the compute side forced
    the block writes this position's K/V itself, and the carry, the logits,
    the cache and the gate state equal the skip side's bitwise (all but
    ``layers_skipped``, which counts the skip sides taken)."""
    from repro_torch.core import decode_runner
    tm = _llm()
    prompt = np.random.default_rng(11).integers(0, 512, (2, 16))
    outs, all_cached = [], []
    for patch in (_recording, _forced):
        seen = []
        monkeypatch.setattr(decode_runner, "branch", patch(seen))
        dec = CachedDecoder(tm, FastCacheConfig())
        _, cache = tm.prefill({"tokens": tt(prompt)}, 32)
        state = dec.init_state(2)
        logits = []
        for _ in range(6):
            lg, cache, state = dec.decode_step(tt(np.array([7, 7])), cache,
                                               state)
            logits.append(lg.clone())
        stats = {k: v for k, v in state["stats"].items()
                 if k != "layers_skipped"}
        outs.append((logits, [t.clone() for t in _leaves(
            {**state, "stats": stats})], cache))
        all_cached.append(seen)
    assert all_cached[0] == all_cached[1] and any(all_cached[0])
    for a, b in zip(outs[0][0], outs[1][0]):
        assert torch.equal(a, b)
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)
    for k in outs[0][2]:
        assert torch.equal(outs[0][2][k], outs[1][2][k]), k


# ---------------------------------------------------------------------------
# the hook, its plain version, the counters, the refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mask", [[True, True], [True, False],
                                  [False, False]])
@pytest.mark.parametrize("when_all", [True, False])
def test_if_all_plain_version(mask, when_all):
    m = torch.tensor(mask)
    ran = []
    assert if_all(m, lambda: ran.append(1), when_all=when_all)
    want = all(mask) == when_all
    assert ran == ([1] if want else [])
    assert bool(ref.if_all(m, when_all)) == want
    with pytest.raises(ValueError):
        if_all(m[None], lambda: None, when_all=when_all)


def test_branch_reads_only_what_the_host_does_not_know():
    every = torch.tensor([True, True])
    sides = []
    assert step_graph.branch(every, lambda: sides.append("c"),
                             lambda: sides.append("s")) == 1
    assert step_graph.branch(every, lambda: sides.append("c"),
                             known=False) == 0
    assert step_graph.branch(~every, lambda: sides.append("c")) == 1
    assert sides == ["s", "c", "c"]


def test_counters_read_since_add():
    fn = cuda_kernels.wrappers()["fused_gate"]
    before = cuda_kernels.read_counts()
    fn.launches += 2
    fn.launches_by_route["simt"] += 2
    got = cuda_kernels.counts_since(before)
    assert got == {("fused_gate", "launches", ""): 2,
                   ("fused_gate", "launches_by_route", "simt"): 2}
    cuda_kernels.add_counts(got, 3)
    assert cuda_kernels.counts_since(before) == {k: 8 for k in got}
    cuda_kernels.add_counts(got, -4)
    assert cuda_kernels.counts_since(before) == {}


def test_graphs_are_refused_off_the_card(smoke):
    _, _, _, model = smoke
    with pytest.raises(ValueError, match="CUDA graphs"):
        CachedDiT(model, FastCacheConfig(), step_graph=True)
    runner = CachedDiT(model, FastCacheConfig())
    with pytest.raises(ValueError, match="CUDA graphs"):
        runner.step_graph = True
    tm = _llm()
    with pytest.raises(ValueError, match="CUDA graphs"):
        ServingEngine(tm, max_batch=2, window=32,
                      fastcache=FastCacheConfig(), step_graph=True)
    eng = ServingEngine(tm, max_batch=2, window=32,
                        fastcache=FastCacheConfig())
    assert eng.graphs is None


def test_step_graphs_run_eager_until_captured():
    """``StepGraphs.run`` calls the step eagerly for the key's warm-up
    calls; only then would it capture (on the card)."""
    graphs = step_graph.StepGraphs()
    calls = []
    state = {"a": torch.zeros(2)}
    for i in range(step_graph.WARMUP_CALLS):
        out = graphs.run("k", lambda x: calls.append(x) or x + 1,
                         (torch.tensor([float(i)]),), state)
        assert float(out) == i + 1
    assert len(calls) == step_graph.WARMUP_CALLS and graphs.captures == 0
