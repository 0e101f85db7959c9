"""The two routes of ``linear_blend`` and ``fused_gate`` on the CPU: the
pure route rule, the policies' bf16 weight copies, and the CPU wrappers with
``w_bf16`` against the reference.

On the card a call takes the wgmma route (bf16 X against a bf16 copy of W)
or the SIMT route (f32 W); ``cuda_kernels/route.py`` decides from dtype,
shape and alignment alone, so the rule is checked here without a card.  The
policies make the bf16 copies once, at construction, and only for a bf16
model on CUDA.  On the CPU the wrappers run the plain versions and do not
read ``w_bf16``: their results are the reference's, as before (tolerances
as in ``test_torch_policy_kernels.py`` and ``test_torch_kernels.py``: bf16
5e-2, the output rounded to bf16; gate bits exact).
"""
import tests.torch_threads  # noqa: F401  (first: one thread)
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.configs.base import FastCacheConfig
from repro_torch.configs.dit import reduced
from repro_torch.core import linear_approx
from repro_torch.core.policies import fastcache, l2c
from repro_torch.core.policies.base import get_policy_class
from repro_torch.core.runner import CachedDiT
from repro_torch.cuda_kernels import ref as tref
from repro_torch.cuda_kernels import route
from repro_torch.cuda_kernels.fused_gate import fused_gate
from repro_torch.cuda_kernels.linear_blend import linear_blend
from repro_torch.models.dit import DiTModel
from tests.test_torch_kernels import _inputs as _gate_inputs

BF16, F32 = torch.bfloat16, torch.float32
ALIGNED = (0, 4096, 1 << 20)

# (dtype, D, F, base addresses, route): the served shapes and the card
# tests' eligible ragged ones take wgmma; f32, the card tests' ragged
# shapes and unaligned bases take SIMT
ROUTE_CASES = [
    (BF16, 1152, 1152, ALIGNED, "wgmma"),      # fastcache / l2c, DiT-XL/2
    (BF16, 1000, 1152, ALIGNED, "wgmma"),      # K not a multiple of 64
    (BF16, 1000, 1000, ALIGNED, "wgmma"),      # N not a multiple of 192
    (BF16, 8, 8, ALIGNED, "wgmma"),
    (F32, 1152, 1152, ALIGNED, "simt"),        # f32 is held to 1e-4
    (BF16, 100, 100, ALIGNED, "simt"),         # fused_gate (3, 40, 100)
    (BF16, 257, 129, ALIGNED, "simt"),         # linear_blend ragged shapes
    (BF16, 13, 5, ALIGNED, "simt"),
    (BF16, 1, 1, ALIGNED, "simt"),
    (BF16, 1152, 1156, ALIGNED, "simt"),       # F % 8 != 0
    (BF16, 1156, 1152, ALIGNED, "simt"),       # D % 8 != 0
    (BF16, 1152, 1152, (0, 4098, 0), "simt"),  # one base 2 bytes off
    (BF16, 1152, 1152, (8, 0, 0), "simt"),     # one base 8 bytes off
    (torch.float16, 1152, 1152, ALIGNED, "simt"),
]


@pytest.mark.parametrize("dtype,d,f,addresses,want", ROUTE_CASES)
def test_gemm_route_rule(dtype, d, f, addresses, want):
    assert route.gemm_route(dtype, d, f, addresses) == want
    assert want in route.ROUTES


def test_gemm_route_reads_tensor_alignment():
    """A view one element into its storage is 2 bytes off 16: SIMT; the
    same values copied to a fresh tensor: wgmma."""
    flat = torch.zeros(2 * 64 * 64 + 8, dtype=BF16)
    view = flat[1:1 + 64 * 64].view(64, 64)
    fresh = view.clone()
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    assert route.gemm_route(BF16, 64, 64, [view.data_ptr()]) == "simt"
    assert fresh.data_ptr() % 16 == 0
    assert route.gemm_route(BF16, 64, 64, [fresh.data_ptr()]) == "wgmma"


@pytest.mark.parametrize("bad", ["missing", "float32", "shape",
                                 "noncontiguous", "unaligned"])
def test_check_w_bf16_rejects(bad):
    w = torch.zeros((16, 8))
    w_bf16 = w.to(BF16)
    if bad == "missing":
        w_bf16 = None
    elif bad == "float32":
        w_bf16 = w.clone()
    elif bad == "shape":
        w_bf16 = w_bf16[:8].contiguous()
    elif bad == "noncontiguous":
        w_bf16 = torch.zeros((8, 16), dtype=BF16).t()
    elif bad == "unaligned":
        w_bf16 = torch.zeros(16 * 8 + 1, dtype=BF16)[1:].view(16, 8)
    with pytest.raises(ValueError, match="w_bf16"):
        route.check_w_bf16(w_bf16, w)
    route.check_w_bf16(w.to(BF16), w)


# ---------------------------------------------------------------------------
# the policies' bf16 copies
# ---------------------------------------------------------------------------

def _fc_params(num_layers=3, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"W_c": torch.from_numpy(rng.standard_normal((d, d)).astype(
                np.float32)),
            "b_c": torch.zeros(d),
            "W_l": torch.from_numpy(rng.standard_normal(
                (num_layers, d, d)).astype(np.float32)),
            "b_l": torch.zeros((num_layers, d))}


def _stub_model(device, dtype, num_layers=3, d=16):
    """What a policy's constructor reads of a model; no tensor lives on
    ``device``, so a "cuda" stub needs no card."""
    return SimpleNamespace(cfg=SimpleNamespace(num_layers=num_layers,
                                               d_model=d),
                           device=torch.device(device), dtype=dtype,
                           num_tokens=16)


def _copies(impl):
    """A policy's bf16 copies: W_c's (fastcache only), then W_l[l]'s."""
    return ([impl.w_c_bf16] if hasattr(impl, "w_c_bf16") else []) + list(
        getattr(impl, "w_l_bf16", []))


def _spy_copies(monkeypatch):
    """Record every bf16 copy that ``linear_approx.bf16_copies`` makes."""
    made = []
    make = linear_approx.bf16_copies

    def counted(w, dtype, device):
        got = make(w, dtype, device)
        made.extend(t for t in got if t is not None)
        return got

    monkeypatch.setattr(linear_approx, "bf16_copies", counted)
    return made


@pytest.mark.parametrize("policy", ["fastcache", "l2c"])
def test_policy_makes_bf16_copies_once_for_bf16_cuda(policy, monkeypatch):
    made = _spy_copies(monkeypatch)
    fcp = _fc_params()
    impl = get_policy_class(policy)(_stub_model("cuda", BF16),
                                    FastCacheConfig(), fcp)
    want = ([fcp["W_c"]] if policy == "fastcache" else []) + list(fcp["W_l"])
    got = _copies(impl)
    assert len(made) == len(got) == len(want)
    for g, w, m in zip(got, want, made):
        assert g is m                              # made at construction
        assert g.dtype == BF16 and g.is_contiguous()
        assert torch.equal(g, w.to(BF16))
    for k in ("W_c", "W_l"):
        assert fcp[k].dtype == F32                # the f32 weights stay


@pytest.mark.parametrize("device,dtype,policy", [
    ("cpu", BF16, "fastcache"), ("cpu", BF16, "l2c"),
    ("cuda", F32, "fastcache"), ("cuda", F32, "l2c"),
    ("cuda", BF16, "nocache"), ("cuda", BF16, "teacache")])
def test_policy_makes_no_bf16_copy_otherwise(device, dtype, policy,
                                             monkeypatch):
    """A CPU model, an f32 model and a policy that runs no linear
    approximator get no copy (and no copy is made)."""
    made = _spy_copies(monkeypatch)
    impl = get_policy_class(policy)(_stub_model(device, dtype),
                                    FastCacheConfig(), _fc_params())
    assert made == []
    assert all(w is None for w in _copies(impl))
    if policy in ("fastcache", "l2c"):
        assert len(impl.w_l_bf16) == 3


def test_cpu_model_policies_hold_no_copy():
    model = DiTModel(reduced().replace(dtype="bfloat16"), device="cpu")
    for policy in ("fastcache", "l2c"):
        impl = CachedDiT(model, FastCacheConfig(), policy=policy).impl
        assert _copies(impl) and all(w is None for w in _copies(impl))


@pytest.mark.parametrize("policy", ["fastcache", "l2c"])
def test_policy_passes_its_copies_to_the_wrappers(policy, monkeypatch):
    """Given its copies, a policy hands the same tensors to the wrappers at
    every call (W_c to the bypass, W_l[l] to layer l; no per-call
    conversion), and on the CPU the results are those without copies."""
    cfg = reduced().replace(dtype="bfloat16")
    model = DiTModel(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    kw = ({"l2c_mask": torch.tensor([True, False])} if policy == "l2c"
          else {})
    plain, given = (CachedDiT(model, FastCacheConfig(), policy=policy, **kw)
                    for _ in range(2))
    fcp = given.fc_params
    w_l = list(fcp["W_l"].to(BF16).contiguous().unbind(0))
    given.impl.w_l_bf16 = w_l
    if policy == "fastcache":
        given.impl.w_c_bf16 = fcp["W_c"].to(BF16)
    seen = []
    module = fastcache if policy == "fastcache" else l2c

    def spy(fn):
        def call(*args, **kwargs):
            seen.append((fn.__name__, kwargs.get("w_bf16")))
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(module, "linear_blend", spy(linear_blend))
    if policy == "fastcache":
        monkeypatch.setattr(module, "fused_gate", spy(fused_gate))
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 8, 8, 4), generator=gen)
    labels = torch.tensor([0, 1])
    states = [plain.init_state(2), given.init_state(2)]
    for i in range(3):
        t = torch.full((2,), 40 - i)
        outs = [r.step(s, x, t, labels) for r, s in zip((plain, given),
                                                        states)]
        assert torch.equal(outs[0][0], outs[1][0])
        states = [o[1] for o in outs]
    given_calls = [(n, w) for n, w in seen if w is not None]
    assert len(given_calls) == len(seen) // 2 and given_calls
    if policy == "fastcache":
        # per gated step: the bypass, then one gate per layer
        want = [("linear_blend", given.impl.w_c_bf16)] + [
            ("fused_gate", w_l[l]) for l in range(cfg.num_layers)]
        assert len(given_calls) == 2 * len(want)          # two warm steps
    else:
        want = [("linear_blend", w_l[0])]
        assert len(given_calls) == 3 * len(want)
    for (name, w), (want_name, want_w) in zip(given_calls, want * 3):
        assert name == want_name
        assert w.data_ptr() == want_w.data_ptr() and w.shape == want_w.shape


# ---------------------------------------------------------------------------
# the CPU wrappers ignore w_bf16 and match the reference
# ---------------------------------------------------------------------------

def _bf16_round(a: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("gamma", [1.0, 0.5])
def test_cpu_linear_blend_ignores_w_bf16(gamma):
    rng = np.random.default_rng(4)
    m, d, f = 128, 256, 256
    x = _bf16_round(0.5 * rng.standard_normal((m, d)).astype(np.float32))
    w = (0.05 * rng.standard_normal((d, f))).astype(np.float32)
    b = rng.standard_normal((f,)).astype(np.float32)
    prev = _bf16_round(rng.standard_normal((m, f)).astype(np.float32))
    tx, tprev = (torch.from_numpy(np.array(a)).to(BF16) for a in (x, prev))
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    before = dict(linear_blend.launches_by_route)
    got = linear_blend(tx, tw, tb, tprev, gamma=gamma,
                       w_bf16=torch.zeros((d, f), dtype=BF16))
    assert torch.equal(got, linear_blend(tx, tw, tb, tprev, gamma=gamma))
    assert torch.equal(got, tref.linear_blend(tx, tw, tb, tprev, gamma))
    assert linear_blend.launches_by_route == before
    j_kernel = jops.linear_blend(jnp.asarray(x, jnp.bfloat16),
                                 jnp.asarray(w), jnp.asarray(b),
                                 jnp.asarray(prev, jnp.bfloat16),
                                 gamma=gamma, bm=128, bf=128, bk=128,
                                 interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(j_kernel, np.float32),
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("use_blend", [True, False])
def test_cpu_fused_gate_ignores_w_bf16(use_blend):
    x, prev, po, w, bias, sigma2, elig, thr, expect = _gate_inputs(
        4, 32, 64, "bfloat16")
    kw = dict(threshold=thr, gamma=0.5, use_blend=use_blend)
    targs = (torch.from_numpy(x).to(BF16), torch.from_numpy(prev).to(BF16),
             torch.from_numpy(po).to(BF16), torch.from_numpy(w),
             torch.from_numpy(bias), torch.from_numpy(sigma2),
             torch.from_numpy(elig))
    before = dict(fused_gate.launches_by_route)
    got = fused_gate(*targs, w_bf16=torch.zeros((64, 64), dtype=BF16), **kw)
    for g, p in zip(got, fused_gate(*targs, **kw)):
        assert torch.equal(g, p)
    assert fused_gate.launches_by_route == before
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


def test_profile_serve_attributes_both_routes_and_raises_on_a_lost_kernel():
    """``launch/profile_serve.py`` sums a wrapper's device time over both
    routes' kernels, and raises when a wrapper launched in the window but no
    kernel name matched it (a renamed kernel must not read as 0 ms)."""
    from repro_torch.launch import profile_serve

    by_name = {
        "void (anonymous namespace)::gate_gemm_wgmma(CUtensorMap_st...)":
            [30.0, 2],
        "void (anonymous namespace)::gate_partials<__nv_bfloat16>(...)":
            [4.0, 2],
        "void (anonymous namespace)::linear_blend_kernel<float>(...)":
            [5.0, 1],
        "void (anonymous namespace)::linear_blend_kernel_wgmma(...)":
            [7.0, 1],
        "ampere_bf16_s16816gemm_bf16_128x128": [100.0, 9]}
    got = profile_serve.attribute(by_name, {"fused_gate": 2,
                                            "linear_blend": 2})
    assert got["fused_gate"] == {"ms": 0.034, "kernel_calls": 4,
                                 "launches": 2}
    assert got["linear_blend"] == {"ms": 0.012, "kernel_calls": 2,
                                   "launches": 2}
    assert got["saliency_delta"]["ms"] == 0.0
    with pytest.raises(RuntimeError, match="saliency_delta launched 1"):
        profile_serve.attribute(by_name, {"saliency_delta": 1})
    # saliency_delta: the onepass route's one kernel and the SIMT route's two
    by_name.update({
        "void (anonymous namespace)::saliency_delta_onepass<__nv_bfloat16>"
        "(...)": [3.5, 2],
        "void (anonymous namespace)::row_sums<float, true>(...)": [5.0, 1],
        "void (anonymous namespace)::sample_totals(...)": [1.5, 1]})
    got = profile_serve.attribute(by_name, {"saliency_delta": 3})
    assert got["saliency_delta"] == {"ms": 0.01, "kernel_calls": 4,
                                     "launches": 3}
    onepass_only = {k: v for k, v in by_name.items()
                    if "row_sums" not in k and "sample_totals" not in k}
    assert profile_serve.attribute(onepass_only, {"saliency_delta": 2})[
        "saliency_delta"]["ms"] == 0.0035
    renamed = {k.replace("gate_", "g_"): v for k, v in by_name.items()}
    with pytest.raises(RuntimeError, match="fused_gate"):
        profile_serve.attribute(renamed, {"fused_gate": 2})
