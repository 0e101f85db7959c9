"""The wgmma_split route of ``linear_blend`` and ``fused_gate`` on the CPU:
the split copies, the route rule, which maps get which copies, and the
copies the policies and the decode runner hand the wrappers.

On the card, maps handed in (fitted by ``calibrate_dit``) are multiplied
on the tensor cores as three bf16 terms, W_hi = bf16(W), W_mid = bf16(W -
W_hi) and W_lo = bf16(W - W_hi - W_mid), stacked along K
(``core/linear_approx.py:split_copies``,
``cuda_kernels/route.py:check_w_split``).  The kernel runs only on the
card; here the copies, the rule and the plumbing are checked, and the
split's arithmetic is emulated in float64 and float32:

- X W_hi + X W_mid + X W_lo misses X W by at most 2^-24 of |X| |W|
  elementwise (one bf16 rounding of what W_hi and W_mid leave, itself at
  most 2^-16 of |W|); the test holds it to 2^-22, since float64 sums of the
  products add their own few ulps.
- At a W with a fitted map's cancellation (a large diagonal, columns that
  sum to about 0, inputs with a large common part), one bf16 copy of W
  misses the plain f32 product by more than 2e-2 rel-L2 after the bf16
  output rounding, and the split, summed in float32 as the kernel sums it,
  stays within 1e-3 (the card tests' bound on the kernel itself).
"""
import tests.torch_threads  # noqa: F401  (first: one thread)
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs.base import FastCacheConfig
from repro_torch.configs.dit import reduced
from repro_torch.core import decode_runner, linear_approx
from repro_torch.core.decode_runner import CachedDecoder
from repro_torch.core.policies import fastcache, l2c
from repro_torch.core.policies.base import get_policy_class
from repro_torch.core.runner import CachedDiT
from repro_torch.cuda_kernels import ref as tref
from repro_torch.cuda_kernels import route
from repro_torch.cuda_kernels.fused_gate import fused_gate
from repro_torch.cuda_kernels.linear_blend import linear_blend
from repro_torch.models.dit import DiTModel
from tests.test_torch_gemm_route import (ROUTE_CASES, _fc_params,
                                         _spy_copies, _stub_model)
from tests.test_torch_kernels import _inputs as _gate_inputs

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

BF16, F32, F64 = torch.bfloat16, torch.float32, torch.float64
SPLIT_REL = 2.0 ** -22      # of |X| |W|: the split's residual, see above
CANCEL_SINGLE_MISS = 2e-2   # a single bf16 copy misses at least this
SPLIT_REL_L2 = 1e-3         # the split must stay within this


def _terms(copy: torch.Tensor, d: int):
    """The SPLIT_TERMS (D, F) terms of a split copy and its padding rows."""
    kp = route.split_rows(d)
    return ([copy[t * kp:t * kp + d] for t in range(route.SPLIT_TERMS)],
            [copy[t * kp + d:(t + 1) * kp]
             for t in range(route.SPLIT_TERMS)])


# ---------------------------------------------------------------------------
# split_copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,f,kp", [(1152, 1152, 1152), (1000, 1152, 1024),
                                    (1024, 1024, 1024), (64, 8, 64),
                                    (8, 16, 64), (100, 100, 128)])
def test_split_copies_shape_and_padding(d, f, kp):
    """(3 Kp, F) bf16, contiguous, 16-byte aligned, Kp = D rounded up to 64
    rows; rows [t Kp, t Kp + D) term t (the bf16 rounding of what the terms
    before it leave of W), the rest zero; one copy per matrix of a
    stack."""
    assert route.split_rows(d) == kp
    rng = np.random.default_rng(d + f)
    w = torch.from_numpy(rng.standard_normal((3, d, f)).astype(np.float32))
    copies = linear_approx.split_copies(w, BF16, torch.device("cuda"))
    assert len(copies) == 3
    for c, wm in zip(copies, w):
        assert c.shape == (route.SPLIT_TERMS * kp, f) and c.dtype == BF16
        assert c.is_contiguous() and c.data_ptr() % route.ALIGN == 0
        route.check_w_split(c, wm)
        terms, pads = _terms(c, d)
        rest = wm
        for term in terms:
            assert torch.equal(term, rest.to(BF16))
            rest = rest - term.float()
        assert all(not bool(p.any()) for p in pads)
    single = linear_approx.split_copies(w[0], BF16, torch.device("cuda"))
    assert len(single) == 1 and torch.equal(single[0], copies[0])


@pytest.mark.parametrize("dtype,device", [(F32, "cuda"), (BF16, "cpu"),
                                          (F32, "cpu")])
def test_split_copies_none_off_a_bf16_cuda_model(dtype, device):
    w = torch.ones((2, 16, 8))
    assert linear_approx.split_copies(w, dtype,
                                      torch.device(device)) == [None] * 2


@settings(max_examples=60, deadline=None)
@given(scale=st.floats(min_value=1e-30, max_value=1e4),
       seed=st.integers(min_value=0, max_value=2 ** 31 - 1),
       d=st.sampled_from([8, 64, 100, 1000]))
def test_split_terms_sum_to_w_within_2_pow_minus_22(scale, seed, d):
    """Over magnitudes from 1e-30 to 1e4: bf16 X times each term, summed in
    float64, within 2^-22 of |X| |W| of X W; one bf16 copy alone within 2^-8
    (its own bound, for scale)."""
    rng = np.random.default_rng(seed)
    f = 16
    w = torch.from_numpy((scale * rng.standard_normal((d, f))).astype(
        np.float32))
    x = torch.from_numpy(rng.standard_normal((4, d)).astype(
        np.float32)).to(BF16)
    (copy,) = linear_approx.split_copies(w, BF16, torch.device("cuda"))
    terms, _ = _terms(copy, d)
    x64 = x.to(F64)
    exact = x64 @ w.to(F64)
    split = sum(x64 @ t.to(F64) for t in terms)
    scale_of = x64.abs() @ w.to(F64).abs()
    assert bool(((split - exact).abs() <= SPLIT_REL * scale_of).all())
    single = x64 @ terms[0].to(F64)
    assert bool(((single - exact).abs() <= 2.0 ** -8 * scale_of).all())


def _cancelling(d=1152, f=1152, m=256, seed=0):
    """bf16 X with a large common part, f32 W = 600 (I - 1 1^T / D) plus
    noise (columns summing to about 0), f32 bias: a fitted map's
    cancellation, X W far smaller than |X| |W|."""
    rng = np.random.default_rng(seed)
    x = (3.0 + 0.05 * rng.standard_normal((m, d))).astype(np.float32)
    w = (600.0 * (np.eye(d, f) - 1.0 / d)
         + rng.standard_normal((d, f))).astype(np.float32)
    b = (0.1 * rng.standard_normal(f)).astype(np.float32)
    return (torch.from_numpy(x).to(BF16), torch.from_numpy(w),
            torch.from_numpy(b))


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def test_split_holds_a_cancelling_map_where_one_bf16_copy_does_not():
    """At the cancelling W: the plain version (f32 W) against a single bf16
    copy (misses 2e-2 rel-L2) and against the split summed in f32 as the
    kernel sums it, X W_hi, X W_mid, then X W_lo into one accumulator, then
    the bias and the bf16 rounding (within 1e-3)."""
    x, w, b = _cancelling()
    want = tref.linear_blend(x, w, b, x, 1.0)
    xf = x.float()
    single = (xf @ w.to(BF16).float() + b).to(BF16)
    assert _rel_l2(single, want) > CANCEL_SINGLE_MISS
    (copy,) = linear_approx.split_copies(w, BF16, torch.device("cuda"))
    terms, _ = _terms(copy, w.shape[0])
    acc = torch.zeros_like(want, dtype=F32)
    for term in terms:
        acc = acc + xf @ term.float()
    split = (acc + b).to(BF16)
    assert _rel_l2(split, want) <= SPLIT_REL_L2


# ---------------------------------------------------------------------------
# the route rule and the checks
# ---------------------------------------------------------------------------

def _copy(rows: int, f: int) -> torch.Tensor:
    return torch.empty((rows, max(f, 1)), dtype=BF16)


@pytest.mark.parametrize("dtype,d,f,addresses,want", ROUTE_CASES)
def test_gemm_route_rule_with_a_split_copy(dtype, d, f, addresses, want):
    """A call that brings a split copy takes wgmma_split exactly where a
    call with a single copy takes wgmma (``ROUTE_CASES``, held without a
    copy in ``test_torch_gemm_route.py``), and SIMT elsewhere (f32 models,
    ragged shapes, unaligned bases); the copy's row count tells the two
    apart."""
    split = _copy(route.SPLIT_TERMS * route.split_rows(d), f)
    got = route.gemm_route(dtype, d, f, addresses, split)
    assert got == ("wgmma_split" if want == "wgmma" else want)
    assert got in route.ROUTES
    assert route.gemm_route(dtype, d, f, addresses, _copy(d, f)) == want


@pytest.mark.parametrize("d", [8, 64, 100, 1000, 1152])
def test_is_split_reads_the_row_count(d):
    """A copy of SPLIT_TERMS * split_rows(D) rows is split; one of D rows,
    of the unpadded SPLIT_TERMS * D rows, None, or a stack of copies is
    not."""
    rows = route.SPLIT_TERMS * route.split_rows(d)
    assert route.is_split(_copy(rows, 16), d)
    assert not route.is_split(_copy(d, 16), d)
    assert not route.is_split(None, d)
    assert not route.is_split(torch.empty((2, rows, 16), dtype=BF16), d)
    if d % route.TC_CHUNK:
        assert not route.is_split(_copy(route.SPLIT_TERMS * d, 16), d)


def test_routes_and_counters_name_the_split_route():
    """Both wrappers count the split route; linear_blend also the gemv
    route, which fused_gate does not take."""
    assert route.ROUTES == ("wgmma", "wgmma_split", "simt")
    assert route.BLEND_ROUTES == route.ROUTES + ("gemv",)
    assert set(fused_gate.launches_by_route) == set(route.ROUTES)
    assert set(linear_blend.launches_by_route) == set(route.BLEND_ROUTES)


@pytest.mark.parametrize("bad", ["missing", "float32", "unpadded", "single",
                                 "transposed", "noncontiguous", "unaligned",
                                 "device"])
def test_check_w_split_rejects(bad):
    d, f = 100, 16
    w = torch.zeros((d, f))
    (good,) = linear_approx.split_copies(w, BF16, torch.device("cuda"))
    route.check_w_split(good, w)
    rows = route.SPLIT_TERMS * route.split_rows(d)
    copy = {
        "missing": None,
        "float32": good.float(),
        "unpadded": torch.zeros((route.SPLIT_TERMS * d, f), dtype=BF16),
        "single": w.to(BF16),
        "transposed": torch.zeros((f, rows), dtype=BF16),
        "noncontiguous": torch.zeros((f, rows), dtype=BF16).t(),
        "unaligned": torch.zeros(rows * f + 1, dtype=BF16)[1:].view(rows, f),
        "device": torch.zeros((rows, f), dtype=BF16, device="meta"),
    }[bad]
    with pytest.raises(ValueError, match="split"):
        route.check_w_split(copy, w)


# ---------------------------------------------------------------------------
# which maps get which copies
# ---------------------------------------------------------------------------

def _spy_split(monkeypatch):
    """Record every split copy that ``linear_approx.split_copies`` makes."""
    made = []
    make = linear_approx.split_copies

    def counted(w, dtype, device):
        got = make(w, dtype, device)
        made.extend(t for t in got if t is not None)
        return got

    monkeypatch.setattr(linear_approx, "split_copies", counted)
    return made


@pytest.mark.parametrize("policy", ["fastcache", "l2c"])
def test_maps_handed_in_get_split_copies_and_no_single_copy(policy,
                                                            monkeypatch):
    """A bf16 CUDA model (a stub: no tensor lives on the card) served with
    maps handed in: the runner makes the policy split each map once, makes
    no single copy, and names no route."""
    single = _spy_copies(monkeypatch)
    split = _spy_split(monkeypatch)
    fcp = _fc_params()
    impl = CachedDiT(_stub_model("cuda", BF16), FastCacheConfig(),
                     policy=policy, fc_params=fcp).impl
    assert impl.split_maps and impl.gemm is None
    want = ([fcp["W_c"]] if policy == "fastcache" else []) + list(fcp["W_l"])
    got = ([impl.w_c_bf16] if policy == "fastcache" else []) + list(
        impl.w_l_bf16)
    assert single == [] and len(split) == len(got) == len(want)
    for g, w, m in zip(got, want, split):
        assert g is m                              # made at construction
        assert route.is_split(g, w.shape[0])
        route.check_w_split(g, w)
        terms, _ = _terms(g, w.shape[0])
        assert torch.equal(terms[0], w.to(BF16))
    for k in ("W_c", "W_l"):
        assert fcp[k].dtype == F32                # the f32 weights stay


@pytest.mark.parametrize("policy", ["fastcache", "l2c"])
def test_identity_maps_get_single_copies_only(policy, monkeypatch):
    split = _spy_split(monkeypatch)
    impl = get_policy_class(policy)(_stub_model("cuda", BF16),
                                    FastCacheConfig(), _fc_params())
    assert not impl.split_maps and split == []
    copies = list(impl.w_l_bf16) + (
        [impl.w_c_bf16] if policy == "fastcache" else [])
    assert len(copies) == 3 + (policy == "fastcache")
    for c in copies:
        assert c.shape == (16, 16) and not route.is_split(c, 16)


@pytest.mark.parametrize("device,dtype", [("cpu", BF16), ("cuda", F32),
                                          ("cpu", F32)])
@pytest.mark.parametrize("policy", ["fastcache", "l2c"])
def test_f32_and_cpu_models_get_no_copy(device, dtype, policy, monkeypatch):
    single, split = _spy_copies(monkeypatch), _spy_split(monkeypatch)
    for split_maps in (False, True):
        impl = get_policy_class(policy)(_stub_model(device, dtype),
                                        FastCacheConfig(), _fc_params(),
                                        split_maps=split_maps)
        copies = list(impl.w_l_bf16)
        if policy == "fastcache":
            copies.append(impl.w_c_bf16)
        assert copies and all(c is None for c in copies)
    assert single == [] and split == []


def test_a_named_route_gets_no_copy(monkeypatch):
    single, split = _spy_copies(monkeypatch), _spy_split(monkeypatch)
    impl = CachedDiT(_stub_model("cuda", BF16), FastCacheConfig(),
                     fc_params=_fc_params(), simt_maps=True).impl
    assert impl.gemm == route.SIMT and single == [] and split == []
    assert impl.w_c_bf16 is None and impl.w_l_bf16 == [None] * 3


def _stub_decoder_model(device, dtype, num_layers=3, d=16):
    return SimpleNamespace(cfg=SimpleNamespace(num_layers=num_layers,
                                               d_model=d),
                           period=1, kinds=("attn",),
                           device=torch.device(device), dtype=dtype)


def test_decoder_splits_maps_handed_in(monkeypatch):
    single, split = _spy_copies(monkeypatch), _spy_split(monkeypatch)
    fcp = _fc_params()
    dec = CachedDecoder(_stub_decoder_model("cuda", BF16), FastCacheConfig(),
                        fc_params=fcp)
    assert dec.split_maps and single == [] and len(split) == 3
    for c, w, m in zip(dec.w_l_bf16, fcp["W_l"], split):
        assert c is m
        route.check_w_split(c, w)
    cpu = CachedDecoder(_stub_decoder_model("cpu", BF16), FastCacheConfig(),
                        fc_params=fcp)
    assert cpu.w_l_bf16 == [None] * 3


# ---------------------------------------------------------------------------
# the same copies on every call; the CPU wrappers ignore them
# ---------------------------------------------------------------------------

def _spy(seen, fn):
    def call(*args, **kwargs):
        seen.append((fn.__name__, kwargs.get("w_bf16"), kwargs.get("gemm")))
        return fn(*args, **kwargs)
    return call


@pytest.mark.parametrize("policy", ["fastcache", "l2c"])
def test_policy_passes_its_split_copies_on_every_call(policy, monkeypatch):
    """Given split copies, a policy hands the same tensors to the wrappers
    at every call (W_c's to the bypass, W_l[l]'s to layer l), with no
    single copy and no named route; on the CPU the results are those
    without copies."""
    cfg = reduced().replace(dtype="bfloat16")
    model = DiTModel(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    kw = ({"l2c_mask": torch.tensor([True, False])} if policy == "l2c"
          else {})
    plain, given = (CachedDiT(model, FastCacheConfig(), policy=policy, **kw)
                    for _ in range(2))
    fcp = given.fc_params
    dev = torch.device("cuda")
    w_l = linear_approx.split_copies(fcp["W_l"], BF16, dev)
    given.impl.w_l_bf16 = w_l
    if policy == "fastcache":
        (given.impl.w_c_bf16,) = linear_approx.split_copies(fcp["W_c"],
                                                            BF16, dev)
    seen = []
    module = fastcache if policy == "fastcache" else l2c
    monkeypatch.setattr(module, "linear_blend", _spy(seen, linear_blend))
    if policy == "fastcache":
        monkeypatch.setattr(module, "fused_gate", _spy(seen, fused_gate))
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
    given_calls = [(n, c) for n, c, g in seen if c is not None]
    assert all(g is None for _, _, g in seen)
    assert len(given_calls) == len(seen) // 2 and given_calls
    if policy == "fastcache":
        want = [("linear_blend", given.impl.w_c_bf16)] + [
            ("fused_gate", w_l[l]) for l in range(cfg.num_layers)]
        assert len(given_calls) == 2 * len(want)          # two warm steps
    else:
        want = [("linear_blend", w_l[0])]
        assert len(given_calls) == 3 * len(want)
    for (name, w), (want_name, want_w) in zip(given_calls, want * 3):
        assert name == want_name and w is want_w


def test_decoder_passes_its_split_copies_on_every_call(monkeypatch):
    """The decode gate hands layer l's split copy to linear_blend at every
    step, with no single copy and no named route; on the CPU the logits are
    those without copies."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import TransformerModel

    cfg = get_reduced("qwen3-0.6b").replace(dtype="float32")
    model = TransformerModel(cfg, device="cpu")
    model.init(torch.Generator().manual_seed(0))
    plain, given = (CachedDecoder(model, FastCacheConfig())
                    for _ in range(2))
    w_l = linear_approx.split_copies(given.fc_params["W_l"], BF16,
                                     torch.device("cuda"))
    given.w_l_bf16 = w_l
    seen = []
    monkeypatch.setattr(decode_runner, "linear_blend",
                        _spy(seen, linear_blend))
    rng = np.random.default_rng(3)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
    caches = [model.prefill({"tokens": prompt}, 16)[1] for _ in range(2)]
    states = [plain.init_state(2), given.init_state(2)]
    for i in range(3):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2,)))
        outs = [dec.decode_step(tok, c, s) for dec, c, s in
                zip((plain, given), caches, states)]
        assert torch.equal(outs[0][0], outs[1][0])
    given_calls = [c for _, c, g in seen if c is not None]
    assert all(g is None for _, _, g in seen)
    assert len(given_calls) == 3 * cfg.num_layers == len(seen) // 2
    for i, w in enumerate(given_calls):
        assert w is w_l[i % cfg.num_layers]


@pytest.mark.parametrize("gamma", [1.0, 0.5])
def test_cpu_linear_blend_ignores_a_split_copy(gamma):
    rng = np.random.default_rng(5)
    m, d, f = 64, 100, 48
    x = torch.from_numpy(rng.standard_normal((m, d)).astype(
        np.float32)).to(BF16)
    w = torch.from_numpy((0.1 * rng.standard_normal((d, f))).astype(
        np.float32))
    b = torch.from_numpy(rng.standard_normal(f).astype(np.float32))
    prev = torch.from_numpy(rng.standard_normal((m, f)).astype(
        np.float32)).to(BF16)
    (copy,) = linear_approx.split_copies(w, BF16, torch.device("cuda"))
    before = dict(linear_blend.launches_by_route)
    got = linear_blend(x, w, b, prev, gamma=gamma, w_bf16=copy)
    assert torch.equal(got, tref.linear_blend(x, w, b, prev, gamma))
    assert linear_blend.launches_by_route == before


@pytest.mark.parametrize("use_blend", [True, False])
def test_cpu_fused_gate_ignores_a_split_copy(use_blend):
    x, prev, po, w, bias, sigma2, elig, thr, expect = _gate_inputs(
        4, 32, 64, "bfloat16")
    kw = dict(threshold=thr, gamma=0.5, use_blend=use_blend)
    targs = (torch.from_numpy(x).to(BF16), torch.from_numpy(prev).to(BF16),
             torch.from_numpy(po).to(BF16), torch.from_numpy(w),
             torch.from_numpy(bias), torch.from_numpy(sigma2),
             torch.from_numpy(elig))
    (copy,) = linear_approx.split_copies(targs[3], BF16,
                                         torch.device("cuda"))
    before = dict(fused_gate.launches_by_route)
    got = fused_gate(*targs, w_bf16=copy, **kw)
    for g, p in zip(got, tref.fused_gate(*targs, **kw)):
        assert torch.equal(g, p)
    np.testing.assert_array_equal(got[1].numpy(), expect)
    assert fused_gate.launches_by_route == before
