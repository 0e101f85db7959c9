"""The IF node's condition set where its mask is made, on the CPU.

In a captured warm fastcache step each block's skip is an IF node whose
condition ``fused_gate``'s GEMM sets from the gate bits it makes
(``cond=``, a handle from ``step_graph.producer_condition``); every other
branch keeps one condition kernel (``set_if_all``), which sets both IF
nodes of a two-sided branch (the decode gate's) on one read of the mask.
``if_all.launches`` counts the condition kernels and ``if_all.nodes`` the
IF nodes.  What a CPU can check:

- the CPU wrappers ignore ``cond=`` (their results are the plain
  versions', their counters do not move), and ``producer_condition`` hands
  out nothing off a capture;
- fastcache hands each layer's handle to both ``fused_gate`` and its
  branch, and its steps stay the reference's with handles handed out (the
  existing parity tests, ``tests/test_torch_step_graph.py`` and
  ``tests/test_torch_policies.py``, stay as they are); the decode gate,
  smoothcache and the step-level policies hand none;
- the counting rule, through ``step_graph.branch`` and
  ``cuda_kernels/cond_node.py`` on a stand-in for the CUDA runtime: a
  branch on a producer's handle adds one node and no kernel, a one-sided
  branch one node and one kernel, a two-sided one two nodes and one kernel
  that sets both handles (all(mask) for the skip side, !all(mask) for the
  compute side); per policy and replayed step, fastcache L nodes and no
  kernel, smoothcache L and L, the step-level policies 1 and 1, the decode
  gate 2L and L; and ``cuda_kernels.read_counts`` / ``add_counts`` /
  ``zero_counts`` carry the node count beside the launches.

The graphs themselves run only on the card: ``tests/test_torch_cuda.py -k
cond``.
"""
import tests.torch_threads  # noqa: F401  (first: one thread)
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FastCacheConfig as JFastCacheConfig
from repro.core import CachedDiT as JCachedDiT
from repro.kernels import ops as jops
from repro_torch import cuda_kernels
from repro_torch.configs.base import FastCacheConfig
from repro_torch.core import step_graph
from repro_torch.core.decode_runner import CachedDecoder
from repro_torch.core.policies import base as policy_base
from repro_torch.core.policies import fastcache as fastcache_mod
from repro_torch.core.runner import CachedDiT
from repro_torch.cuda_kernels import cond_node
from repro_torch.cuda_kernels.cond_node import if_all
from repro_torch.cuda_kernels.fused_gate import fused_gate
from tests.test_torch_kernels import _inputs as _gate_inputs
from tests.test_torch_model import BLOCK_TOL, np32, t32
from tests.test_torch_step_graph import _llm, _port_state, smoke  # noqa: F401
from tests.test_torch_transformer import tt

BF16 = torch.bfloat16


# ---------------------------------------------------------------------------
# the CPU wrappers and the producer's handle off a capture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_blend", [True, False])
def test_cpu_fused_gate_ignores_cond(use_blend):
    """On the CPU ``cond=`` is not read: the results with a handle are the
    ones without, bitwise, no counter moves, and they are the reference's
    Pallas kernel's in interpret mode (tolerances as in
    ``tests/test_torch_gemm_route.py``: gate bits exact, out 5e-2 after
    one bf16 rounding, the totals rtol 1e-5)."""
    x, prev, po, w, bias, sigma2, elig, thr, expect = _gate_inputs(
        4, 32, 64, "bfloat16")
    kw = dict(threshold=thr, gamma=0.5, use_blend=use_blend)
    targs = (torch.from_numpy(x).to(BF16), torch.from_numpy(prev).to(BF16),
             torch.from_numpy(po).to(BF16), torch.from_numpy(w),
             torch.from_numpy(bias), torch.from_numpy(sigma2),
             torch.from_numpy(elig))
    before = cuda_kernels.read_counts()
    got = fused_gate(*targs, **kw, cond=12345)
    for g, p in zip(got, fused_gate(*targs, **kw)):
        assert torch.equal(g, p)
    assert cuda_kernels.counts_since(before) == {}
    np.testing.assert_array_equal(got[1].numpy(), expect)
    j_out, j_gate, j_diff, j_prev = jops.fused_gate(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(prev, jnp.bfloat16),
        jnp.asarray(po, jnp.bfloat16), jnp.asarray(w), jnp.asarray(bias),
        jnp.asarray(sigma2), jnp.asarray(elig), interpret=True, **kw)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(j_gate))
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(j_out, np.float32),
                               rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(j_diff), rtol=1e-5)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(j_prev), rtol=1e-5)


def test_producer_condition_is_none_off_a_capture():
    """Off the card, and so outside any capture, no handle is made: the
    branch then reads the mask itself (on the host, on the CPU)."""
    assert step_graph.producer_condition(torch.device("cpu")) is None
    seen = []
    assert step_graph.branch(torch.tensor([True, False]),
                             lambda: seen.append("c"), cond=None) == 1
    assert seen == ["c"]


# ---------------------------------------------------------------------------
# who hands out a handle
# ---------------------------------------------------------------------------

def _recording(seen):
    """A ``step_graph.branch`` that records (handle, two-sided) per call,
    then branches as the real one does."""
    real = step_graph.branch

    def rec(every, compute, skip=None, known=None, cond=None):
        seen.append((cond, skip is not None))
        return real(every, compute, skip, known)
    return rec


def _handing_out(monkeypatch):
    """fastcache's producer_condition handing out a new handle a call, as
    in a capture; fused_gate recording the handles it is given.  Returns
    (handles handed out, handles fused_gate got)."""
    made, given = [], []

    def condition(device):
        made.append(1000 + len(made))
        return made[-1]

    def gate(*args, cond=None, **kw):
        given.append(cond)
        return fused_gate(*args, cond=cond, **kw)

    monkeypatch.setattr(fastcache_mod, "producer_condition", condition)
    monkeypatch.setattr(fastcache_mod, "fused_gate", gate)
    return made, given


def test_fastcache_hands_each_layer_its_handle(smoke, monkeypatch):
    """A warm fastcache step asks for one handle a layer and hands it to
    fused_gate and to that layer's branch (one-sided); the cold step asks
    for none."""
    jcfg, _, _, model = smoke
    made, given = _handing_out(monkeypatch)
    seen = []
    monkeypatch.setattr(policy_base, "branch", _recording(seen))
    runner = CachedDiT(model, FastCacheConfig(), policy="fastcache")
    state = runner.init_state(2)
    img, ch = jcfg.dit.image_size, jcfg.dit.in_channels
    x = t32(np.random.default_rng(0).standard_normal(
        (2, img, img, ch)).astype(np.float32))
    labels = torch.tensor([1, 2])
    for _ in range(4):
        _, state = runner.step(state, x, torch.full((2,), 25), labels)
    layers = runner.L
    assert runner.impl.step_kinds == {"cold": 1, "mixed": 0, "warm": 3}
    assert made == given == [1000 + i for i in range(3 * layers)]
    assert seen == [(h, False) for h in made]


def test_fastcache_with_handles_matches_reference(smoke, monkeypatch):
    """With handles handed out (as in a capture; the CPU ignores them)
    fastcache's in-place steps stay the reference's on the same state:
    counters, tracker bits exactly, sigma2 at rtol 1e-4, the hidden stack
    and eps at the block tolerance (``tests/test_torch_step_graph.py``)."""
    jcfg, jmodel, jparams, model = smoke
    made, _ = _handing_out(monkeypatch)
    jr = JCachedDiT(jmodel, JFastCacheConfig(), policy="fastcache")
    tr = CachedDiT(model, FastCacheConfig(), policy="fastcache")
    b = 3
    rng = np.random.default_rng(5)
    img, ch = jcfg.dit.image_size, jcfg.dit.in_channels
    x = rng.standard_normal((b, img, img, ch)).astype(np.float32)
    labels = np.array([1, 2, 3], np.int32)
    js = jr.init_state(b)
    jstep = jax.jit(jr.step)
    for i in range(5):
        ts = _port_state(tr, js, b)
        t = np.full((b,), 40 - 4 * i, np.int32)
        je, js = jstep(jparams, js, jnp.asarray(x), jnp.asarray(t),
                       jnp.asarray(labels))
        te, _ = tr.step(ts, t32(x), t32(t), t32(labels))
        for k in ("blocks_computed", "blocks_skipped", "steps_reused"):
            np.testing.assert_array_equal(np32(ts["stats"][k]),
                                          np32(js["stats"][k]), err_msg=k)
        np.testing.assert_array_equal(ts["gate"].initialized.numpy(),
                                      np.asarray(js["gate"].initialized))
        np.testing.assert_allclose(ts["gate"].sigma2.numpy(),
                                   np.asarray(js["gate"].sigma2), rtol=1e-4)
        np.testing.assert_allclose(np32(ts["prev_hidden"]),
                                   np32(js["prev_hidden"]), **BLOCK_TOL)
        np.testing.assert_allclose(np32(te), np32(je), **BLOCK_TOL)
        x = x - 0.05 * np32(je)
    assert len(made) == 4 * tr.L                  # steps 1 ... 4 warm


@pytest.mark.parametrize("policy", ["smoothcache", "teacache"])
def test_other_policies_hand_no_handle(smoke, monkeypatch, policy):
    """smoothcache's per-layer skips and the step-level policies' whole
    stack read their masks through a condition kernel: no handle."""
    jcfg, _, _, model = smoke
    seen = []
    monkeypatch.setattr(policy_base, "branch", _recording(seen))
    runner = CachedDiT(model, FastCacheConfig(), policy=policy)
    state = runner.init_state(2)
    img, ch = jcfg.dit.image_size, jcfg.dit.in_channels
    x = t32(np.random.default_rng(1).standard_normal(
        (2, img, img, ch)).astype(np.float32))
    for _ in range(6):
        _, state = runner.step(state, x, torch.full((2,), 25),
                               torch.tensor([1, 2]))
    assert seen and all(c == (None, False) for c in seen)


def test_decode_gate_branches_two_sided_without_a_handle(monkeypatch):
    """The decode gate's skip is two-sided (the K/V write, the block) and
    its mask comes from plain ops: one branch a layer, no handle."""
    from repro_torch.core import decode_runner
    seen = []
    monkeypatch.setattr(decode_runner, "branch", _recording(seen))
    tm = _llm()
    dec = CachedDecoder(tm, FastCacheConfig())
    prompt = np.random.default_rng(11).integers(0, 512, (2, 16))
    _, cache = tm.prefill({"tokens": tt(prompt)}, 32)
    state = dec.init_state(2)
    for _ in range(3):
        _, cache, state = dec.decode_step(tt(np.array([7, 7])), cache, state)
    assert seen == [(None, True)] * (3 * tm.cfg.num_layers)


# ---------------------------------------------------------------------------
# the counting rule, on a stand-in for the CUDA runtime
# ---------------------------------------------------------------------------

class _Mask:
    """A (B,) bool mask that says it lies on the card."""

    def __init__(self, n):
        self.n = n
        self.device = torch.device("cuda", 0)
        self.dtype = torch.bool
        self.is_cuda = True

    def dim(self):
        return 1

    def numel(self):
        return self.n

    def is_contiguous(self):
        return True

    def contiguous(self):
        return self

    def data_ptr(self):
        return 0


class _Runtime:
    """cond_node.cu's entry points as Python: the handles made, and each
    condition kernel's (handles, when_all) and each IF node's handle, in
    order."""

    def __init__(self):
        self.handles = 0
        self.kernels = []
        self.nodes = []

    def fn(self, name):
        def create(stream, out):
            self.handles += 1
            out._obj.value = self.handles
            return 0

        def set_all(mask, n, handles, when_all, count, stream):
            self.kernels.append((list(handles[:count]),
                                 list(when_all[:count])))
            return 0

        def begin(handle, stream, body):
            self.nodes.append(handle)
            return 0

        return {"cond_handle_create": create, "cond_set_all": set_all,
                "cond_if_begin": begin,
                "cond_if_end": lambda *a: 0}[name]


@pytest.fixture
def runtime(monkeypatch):
    """The capture path of step_graph.branch and cond_node on the CPU:
    the stream captures, the runtime is ``_Runtime``."""
    rt = _Runtime()
    stream = type("Stream", (), {"cuda_stream": 0})()
    monkeypatch.setattr(cond_node, "_kernel", rt.fn)
    monkeypatch.setattr(cond_node, "_capturing_stream", lambda dev: stream)
    monkeypatch.setitem(cond_node._BODY, 0, (stream, None))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "use_mem_pool",
                        lambda p: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    return rt


def _counted(fn):
    before = (if_all.launches, if_all.nodes)
    fn()
    return if_all.launches - before[0], if_all.nodes - before[1]


def test_branch_on_a_producers_handle_adds_a_node_and_no_kernel(runtime):
    bodies = []
    got = _counted(lambda: step_graph.branch(
        _Mask(8), lambda: bodies.append("compute"), cond=77))
    assert got == (0, 1)
    assert runtime.kernels == [] and runtime.nodes == [77]
    assert bodies == ["compute"]                   # captured into the node
    with pytest.raises(ValueError, match="compute side only"):
        step_graph.branch(_Mask(8), lambda: None, lambda: None, cond=77)


def test_one_sided_branch_adds_a_node_and_a_kernel(runtime):
    got = _counted(lambda: step_graph.branch(_Mask(8), lambda: None))
    assert got == (1, 1)
    assert runtime.kernels == [([1], [0])]         # !all(mask)
    assert runtime.nodes == [1]


def test_two_sided_branch_sets_both_handles_on_one_kernel(runtime):
    bodies = []
    got = _counted(lambda: step_graph.branch(
        _Mask(8), lambda: bodies.append("compute"),
        lambda: bodies.append("skip")))
    assert got == (1, 2)
    assert runtime.kernels == [([1, 2], [1, 0])]   # all, !all
    assert runtime.nodes == [1, 2] and bodies == ["skip", "compute"]


def test_if_all_sides_takes_one_or_two_sides(runtime):
    with pytest.raises(ValueError, match="1 to 2 sides"):
        cond_node.if_all_sides(_Mask(4), [])
    with pytest.raises(ValueError, match="1 to 2 sides"):
        cond_node.if_all_sides(_Mask(4), [(lambda: None, True)] * 3)


# per replayed step: (branches, handed a producer's handle, two-sided)
_STEP_BRANCHES = {"fastcache": lambda L: [(True, False)] * L,
                  "smoothcache": lambda L: [(False, False)] * L,
                  "teacache": lambda L: [(False, False)],
                  "decode": lambda L: [(False, True)] * L}


@pytest.mark.parametrize("policy,want", [
    ("fastcache", lambda L: (0, L)), ("smoothcache", lambda L: (L, L)),
    ("teacache", lambda L: (1, 1)), ("decode", lambda L: (L, 2 * L))])
def test_counts_per_replayed_step(runtime, policy, want):
    """A replayed step adds what its capture counted: (condition kernels,
    IF nodes) = fastcache (0, L), smoothcache (L, L), a step-level policy
    (1, 1), the decode gate (L, 2L); here L = 28 and the branches as each
    policy makes them (the tests above)."""
    layers = 28

    def capture():
        for handed, two_sided in _STEP_BRANCHES[policy](layers):
            skip = (lambda: None) if two_sided else None
            cond = cond_node.condition(torch.device("cuda", 0)) \
                if handed else None
            step_graph.branch(_Mask(8), lambda: None, skip, cond=cond)

    before = cuda_kernels.read_counts()
    assert _counted(capture) == want(layers)
    recorded = cuda_kernels.counts_since(before)
    cuda_kernels.add_counts(recorded, 3)           # three replays
    assert _counted(lambda: None) == (0, 0)
    got = cuda_kernels.counts_since(before)
    kernels, nodes = want(layers)
    assert got.get(("if_all", "launches", ""), 0) == 4 * kernels
    assert got.get(("if_all", "nodes", ""), 0) == 4 * nodes


def test_counters_carry_the_nodes():
    """read_counts names if_all's nodes beside its launches; add_counts and
    zero_counts move both."""
    before = cuda_kernels.read_counts()
    assert ("if_all", "nodes", "") in before
    if_all.nodes += 3
    if_all.launches += 1
    got = cuda_kernels.counts_since(before)
    assert got == {("if_all", "nodes", ""): 3, ("if_all", "launches", ""): 1}
    cuda_kernels.add_counts(got, -1)
    assert cuda_kernels.counts_since(before) == {}
    saved = cuda_kernels.read_counts()
    try:
        cuda_kernels.zero_counts()
        assert if_all.nodes == 0 and if_all.launches == 0
    finally:
        cuda_kernels.add_counts(saved)


def test_gate_designs_rewrite_the_condition_code():
    """``launch/gate_designs.py`` rewrites fused_gate.cu's condition code in
    both GEMM kernels, so each design still finds the code it rewrites:
    (setter calls, voting barriers, warp votes, guarded calls of the warp
    vote's helper, unguarded ones) by design."""
    from repro_torch.launch.gate_designs import design_sources
    src = design_sources()
    counts = {n: (s.count("cudaGraphSetConditional("),
                  s.count("__syncthreads_and("), s.count("__all_sync("),
                  s.count("if constexpr (kSetCond)"),
                  s.count("if constexpr (true)"))
              for n, s in src.items()}
    # the warp vote's helper stays defined (unused) in every design
    assert counts == {"kept": (1, 0, 1, 2, 0), "warp_vote": (1, 0, 1, 0, 2),
                      "barrier_vote": (3, 2, 1, 0, 0),
                      "no_set_call": (1, 2, 1, 0, 0),
                      "no_condition": (1, 0, 1, 0, 0)}
