"""Card-only tests of the port's CUDA kernels against their plain PyTorch
versions.  They skip without a CUDA card.  This file imports neither JAX
nor the reference, so it also runs on a machine with no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda.py

Tolerances: gate bits exact (the kernel rebuilds the gate in the plain
version's operation order and the decisions sit a factor 2 from the
threshold); diff/prevsq rtol 1e-4 (f32 sums in another order); out rtol and
atol 1e-4 in f32, 2e-2 in bf16 (one bf16 rounding of a value near 4).
Token merge: knn_density rtol/atol 1e-4 (f32 arithmetic on the same
inputs); merge_assign's centers and assign exact, merged 1e-4 in f32 and
5e-2 in bf16 (one bf16 rounding); unmerge_scatter bitwise.
saliency_delta: rtol 1e-5 (f32 sums in another order), repeats bitwise.
It has two routes (``route.saliency_route``): rows of a multiple of 16 bytes
at 16-byte aligned bases take the onepass route (one launch), the rest the
SIMT route (two); the onepass route reduces each row and each sample in the
SIMT route's order, so wherever it takes an input the two agree bitwise.
linear_blend: rtol/atol 1e-4 in f32 (the same products summed in another
order over K up to 1152), 2e-2 in bf16 (one bf16 rounding of values up to
~4); repeats bitwise.
fused_gate and linear_blend have three routes (cuda_kernels/route.py): bf16
inputs of eligible shape take the wgmma route, which multiplies a bf16 copy
of W (``w_bf16=``, W = I + 0.01 noise rounded by at most 2^-9 relative:
~1e-3 in the outputs, inside 2e-2), or, where that copy is a split one
(three bf16 terms of W, the fitted maps' route), the wgmma_split route,
held to the plain version at 2e-2 elementwise and 1e-3 rel-L2 (``-k
split``: the terms miss W by 2^-24 of |W|, so only the f32 summation order
and the bf16 output rounding of the values it moved are left; a copy of
three independent planted terms shows every term is read); the rest, and
calls that name it
(``gemm="simt"``), the SIMT route.  linear_blend's calls of M <=
``route.GEMV_MAX_ROWS`` rows that would take wgmma take its gemv route
(split K over every SM, ``-k gemv``), held to the plain version at 2e-2 as
wgmma is.  Each route is
also reached through the module's launcher for a named route (``_launch``),
and at W = I (exact in bf16) wgmma, gemv and SIMT agree bitwise.
knn_density and merge_assign have two routes too (``route.window_route``):
bf16 windows of eligible shape take the mma route (the Gram on the tensor
cores), the rest the SIMT route; the two differ only in the Gram's summation
order, so on the same bf16 windows they give the same centers and
assignments, bitwise merged tokens, and rho within 1e-4 (bitwise on
integer-valued windows, whose Gram is exact in any order).
"""
import dataclasses
import importlib
import math

import pytest
import torch

from repro_torch.core.statcache import make_threshold
from repro_torch.cuda_kernels import ref
from repro_torch.cuda_kernels.flash_attention import flash_attention
from repro_torch.cuda_kernels.fused_gate import fused_gate
from repro_torch.cuda_kernels.knn_density import knn_density
from repro_torch.cuda_kernels.linear_blend import linear_blend
from repro_torch.cuda_kernels.saliency_delta import saliency_delta
from repro_torch.cuda_kernels.token_merge import merge_assign, unmerge_scatter

fg_mod = importlib.import_module("repro_torch.cuda_kernels.fused_gate")
lb_mod = importlib.import_module("repro_torch.cuda_kernels.linear_blend")
knn_mod = importlib.import_module("repro_torch.cuda_kernels.knn_density")
tm_mod = importlib.import_module("repro_torch.cuda_kernels.token_merge")
sal_mod = importlib.import_module("repro_torch.cuda_kernels.saliency_delta")
fa_mod = importlib.import_module("repro_torch.cuda_kernels.flash_attention")
BF16 = torch.bfloat16


def _plain_gate(*args, w_bf16=None, gemm=None, cond=None, **kw):
    """ref.fused_gate in the wrapper's signature (w_bf16, gemm and cond are
    not read)."""
    return ref.fused_gate(*args, **kw)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _gate_inputs(dev, dtype, b, c, d, seed=0):
    gen = torch.Generator(dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x = randn(b, c, d).to(dtype)
    prev = (x.float() + randn(b, c, d, scale=0.01)).to(dtype)
    po = randn(b, c, d).to(dtype)
    w = torch.eye(d, device=dev) + randn(d, d, scale=0.01)
    bias = randn(d, scale=0.1)
    thr = make_threshold(0.05, c * d)
    diff = (x.double() - prev.double()).square().sum(dim=(1, 2))
    factor = torch.tensor([2.0, 0.5] * b, device=dev,
                          dtype=torch.float64)[:b]      # even samples gate
    sigma2 = (diff / (c * d * thr) * factor).float()
    eligible = torch.arange(b, device=dev) != b - 1       # last ineligible
    return (x, prev, po, w, bias, sigma2, eligible), thr


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_blend", [True, False])
@pytest.mark.parametrize("shape", [(8, 128, 1152), (3, 40, 100)])
def test_fused_gate_kernel_matches_plain(cuda_device, dtype, use_blend,
                                         shape):
    args, thr = _gate_inputs(cuda_device, dtype, *shape)
    kw = dict(threshold=thr, gamma=0.5, use_blend=use_blend)
    before = fused_gate.launches
    got = fused_gate(*args, **kw, w_bf16=args[3].to(BF16))
    torch.cuda.synchronize(cuda_device)
    assert fused_gate.launches == before + 1
    want = ref.fused_gate(*args, **kw)
    assert got[0].dtype == dtype and got[1].dtype == torch.bool
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    assert 0 < int(got[1].sum()) < shape[0]
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0)
    torch.testing.assert_close(got[3], want[3], rtol=1e-4, atol=0)


@pytest.mark.cuda
def test_fused_gate_kernel_is_deterministic(cuda_device):
    args, thr = _gate_inputs(cuda_device, torch.bfloat16, 8, 128, 1152)
    w_bf16 = args[3].to(BF16)
    first = fused_gate(*args, threshold=thr, w_bf16=w_bf16)
    for _ in range(3):
        again = fused_gate(*args, threshold=thr, w_bf16=w_bf16)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_fused_gate_raises_on_bad_cuda_input(cuda_device):
    args, thr = _gate_inputs(cuda_device, torch.float16, 2, 8, 16)
    with pytest.raises(TypeError):
        fused_gate(*args, threshold=thr)


@pytest.mark.cuda
def test_cached_step_kernel_matches_plain_path(cuda_device, monkeypatch):
    """The fastcache step on the card with the kernel and, with the plain
    version patched in, without it: the same gates at every step, eps
    within f32 rounding."""
    from repro_torch.configs.base import FastCacheConfig
    from repro_torch.configs.dit import reduced
    from repro_torch.core.policies import fastcache
    from repro_torch.core.runner import CachedDiT
    from repro_torch.models.dit import DiTModel

    cfg = reduced().replace(dtype="float32")
    model = DiTModel(cfg, device=cuda_device)
    model.init(torch.Generator(cuda_device).manual_seed(0))
    kernel, plain = (CachedDiT(model, FastCacheConfig()) for _ in range(2))
    states = [kernel.init_state(4), plain.init_state(4)]
    gen = torch.Generator(cuda_device).manual_seed(1)
    x = torch.randn((4, 8, 8, 4), generator=gen, device=cuda_device)
    labels = torch.arange(4, device=cuda_device)
    before = fused_gate.launches
    for i in range(6):
        t = torch.full((4,), 50 - i, device=cuda_device)
        outs = [kernel.step(states[0], x, t, labels)]
        with monkeypatch.context() as m:
            m.setattr(fastcache, "fused_gate", _plain_gate)
            outs.append(plain.step(states[1], x, t, labels))
        states = [o[1] for o in outs]
        for k in ("blocks_computed", "blocks_skipped", "motion_frac_sum"):
            assert torch.equal(states[0]["stats"][k], states[1]["stats"][k])
        torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-4,
                                   atol=1e-4)
        x = x - 0.02 * outs[1][0]
    assert fused_gate.launches - before == cfg.num_layers * 5
    assert float(states[0]["stats"]["blocks_skipped"].sum()) > 0


# ---------------------------------------------------------------------------
# token merge: knn_density, merge_assign, unmerge_scatter
# ---------------------------------------------------------------------------

# (W, w, D, K, M): the DiT-XL/2 slice's shapes, then odd ones
MERGE_SHAPES = [(128, 16, 1152, 5, 8), (5, 8, 100, 7, 3), (3, 32, 200, 3, 1),
                (2, 2, 33, 1, 2)]


def _windows(dev, dtype, nw, w, d, seed=0):
    gen = torch.Generator(dev).manual_seed(seed)
    h = torch.randn((nw, w, d), generator=gen, device=dev).to(dtype)
    s = torch.rand((nw, w), generator=gen, device=dev)
    return h, s / s.amax(dim=-1, keepdim=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", MERGE_SHAPES)
def test_knn_density_kernel_matches_plain(cuda_device, dtype, shape):
    nw, w, d, k, _ = shape
    h, _ = _windows(cuda_device, dtype, nw, w, d)
    before = knn_density.launches
    got = knn_density(h, k=k)
    torch.cuda.synchronize(cuda_device)
    assert knn_density.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (nw, w)
    torch.testing.assert_close(got, ref.knn_density(h, k), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", MERGE_SHAPES)
def test_merge_assign_kernel_matches_plain(cuda_device, dtype, shape):
    nw, w, d, _, m = shape
    h, s = _windows(cuda_device, dtype, nw, w, d)
    before = merge_assign.launches
    merged, assign, centers = merge_assign(h, s, m=m)
    torch.cuda.synchronize(cuda_device)
    assert merge_assign.launches == before + 1
    want = ref.merge_assign(h, s, m)
    assert merged.dtype == dtype
    assert torch.equal(centers, want[2])
    assert torch.equal(assign, want[1])
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(merged.float(), want[0].float(), rtol=tol,
                               atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1152, 100, 7, 3])
@pytest.mark.parametrize("offset", [0, 1])
def test_unmerge_scatter_kernel_is_bitwise(cuda_device, dtype, d, offset):
    """Every copy unit (16, 4 and 2 bytes, picked from the row width and
    the pointers' alignment) reproduces the gather bitwise."""
    nw, w, m = 16, 16, 8
    gen = torch.Generator(cuda_device).manual_seed(4)
    flat = torch.randn((nw * m * d + offset,), generator=gen,
                       device=cuda_device).to(dtype)
    merged = flat[offset:].view(nw, m, d)
    assign = torch.randint(0, m, (nw, w), generator=gen, device=cuda_device,
                           dtype=torch.int32)
    before = unmerge_scatter.launches
    got = unmerge_scatter(merged, assign)
    torch.cuda.synchronize(cuda_device)
    assert unmerge_scatter.launches == before + 1
    assert torch.equal(got, ref.unmerge_scatter(merged, assign))


@pytest.mark.cuda
@pytest.mark.parametrize("bad_id", [-1, 8, 1 << 30])
def test_unmerge_scatter_out_of_range_id_gives_zero_row(cuda_device, bad_id):
    """An id outside [0, M) matches no cluster: its token gets a zero row,
    as the TPU kernel's one-hot product gives, never a remapped cluster."""
    nw, w, m, d = 4, 16, 8, 1152
    gen = torch.Generator(cuda_device).manual_seed(5)
    merged = torch.randn((nw, m, d), generator=gen,
                         device=cuda_device).to(torch.bfloat16) + 3.0
    assign = torch.randint(0, m, (nw, w), generator=gen, device=cuda_device,
                           dtype=torch.int32)
    assign[1, 5] = bad_id
    got = unmerge_scatter(merged, assign)
    torch.cuda.synchronize(cuda_device)
    assert torch.equal(got[1, 5], torch.zeros_like(got[1, 5]))
    good = assign.clone()
    good[1, 5] = 0
    want = ref.unmerge_scatter(merged, good)
    want[1, 5] = 0
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_token_merge_kernels_are_deterministic(cuda_device):
    h, s = _windows(cuda_device, torch.bfloat16, 128, 16, 1152)
    first = (knn_density(h, k=5), *merge_assign(h, s, m=8))
    first += (unmerge_scatter(first[1], first[2]),)
    for _ in range(3):
        again = (knn_density(h, k=5), *merge_assign(h, s, m=8))
        again += (unmerge_scatter(again[1], again[2]),)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_token_merge_kernels_raise_on_bad_cuda_input(cuda_device):
    h, s = _windows(cuda_device, torch.float16, 2, 8, 16)
    with pytest.raises(TypeError):
        knn_density(h, k=3)
    with pytest.raises(TypeError):
        merge_assign(h, s, m=4)
    wide, ws = _windows(cuda_device, torch.float32, 2, 64, 16)
    with pytest.raises(ValueError, match="at most 32"):
        knn_density(wide, k=5)
    with pytest.raises(ValueError, match="at most 32"):
        merge_assign(wide, ws, m=8)
    with pytest.raises(ValueError, match="share one device"):
        merge_assign(wide, ws.cpu(), m=8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", ["fastcache", "nocache"])
def test_merged_cached_step_kernels_match_plain_path(cuda_device,
                                                     monkeypatch, policy,
                                                     dtype):
    """The merged step on the card through the kernels and, with the plain
    versions patched in, without them: the same assignment, centers and
    counters at every step, eps within f32 rounding (f32; in bf16 within
    5e-2, one bf16 rounding of the merged tokens carried through the
    blocks).  The window kernels run the SIMT route in f32 and the mma
    route in bf16."""
    from repro_torch.configs.base import FastCacheConfig
    from repro_torch.configs.dit import reduced
    from repro_torch.core import token_merge
    from repro_torch.core.policies import fastcache
    from repro_torch.core.runner import CachedDiT
    from repro_torch.models.dit import DiTModel

    cfg = reduced().replace(dtype=dtype)
    model = DiTModel(cfg, device=cuda_device)
    model.init(torch.Generator(cuda_device).manual_seed(0))
    fc = FastCacheConfig(merge_enabled=True, merge_ratio=0.5, merge_window=8)
    kernel, plain = (CachedDiT(model, fc, policy=policy) for _ in range(2))
    maps = ([], [])
    for runner, sink in zip((kernel, plain), maps):
        orig = runner.reducer.reduce

        def reduce(x, tr, orig=orig, runner=runner, sink=sink):
            out = orig(x, tr)
            sink.append(runner.reducer._mm)
            return out

        runner.reducer.reduce = reduce
    states = [kernel.init_state(4), plain.init_state(4)]
    gen = torch.Generator(cuda_device).manual_seed(1)
    x = torch.randn((4, 8, 8, 4), generator=gen, device=cuda_device)
    labels = torch.arange(4, device=cuda_device)
    counts = (knn_density.launches, merge_assign.launches,
              unmerge_scatter.launches)
    by_route = (dict(knn_density.launches_by_route),
                dict(merge_assign.launches_by_route))
    tol = 1e-4 if dtype == "float32" else 5e-2
    for i in range(6):
        t = torch.full((4,), 50 - i, device=cuda_device)
        outs = [kernel.step(states[0], x, t, labels)]
        with monkeypatch.context() as m:
            m.setattr(fastcache, "fused_gate", _plain_gate)
            m.setattr(token_merge, "_knn_kernel",
                      lambda h, k: ref.knn_density(h, k))
            m.setattr(token_merge, "merge_assign",
                      lambda h, s, m: ref.merge_assign(h, s, m))
            m.setattr(token_merge, "unmerge_scatter", ref.unmerge_scatter)
            outs.append(plain.step(states[1], x, t, labels))
        states = [o[1] for o in outs]
        assert torch.equal(maps[0][i].centers, maps[1][i].centers)
        assert torch.equal(maps[0][i].assign, maps[1][i].assign)
        for k in ("blocks_computed", "blocks_skipped", "tokens_kept",
                  "tokens_merged"):
            assert torch.equal(states[0]["stats"][k], states[1]["stats"][k])
        torch.testing.assert_close(outs[0][0], outs[1][0], rtol=tol,
                                   atol=tol)
        x = x - 0.02 * outs[1][0]
    launched = (knn_density.launches - counts[0],
                merge_assign.launches - counts[1],
                unmerge_scatter.launches - counts[2])
    mixed = getattr(kernel.impl, "step_kinds", {}).get("mixed", 0)
    assert launched == (6, 6, 6 + mixed)
    which = "simt" if dtype == "float32" else "mma"
    for fn, before in zip((knn_density, merge_assign), by_route):
        assert fn.launches_by_route[which] - before[which] == 6


# ---------------------------------------------------------------------------
# the two routes of knn_density and merge_assign
# ---------------------------------------------------------------------------

# MERGE_SHAPES and two more: w = 32 at the served width (two m-tiles), and
# D % 16 == 8 (the last k-step reads the zeroed row padding)
WINDOW_SHAPES = MERGE_SHAPES + [(4, 32, 1152, 5, 8), (6, 16, 1000, 5, 8)]


def _int_windows(dev, nw, w, d, seed=0):
    """bf16 windows of small integers with every second token a copy of the
    one before, and scores in {1/3, 2/3, 1}: every Gram entry is an exact
    integer in f32 whatever the summation order, so distances tie exactly
    (duplicated tokens, and by chance) and scores tie often."""
    gen = torch.Generator(dev).manual_seed(seed)
    h = torch.randint(-3, 4, (nw, w, d), generator=gen, device=dev)
    h[:, 1::2] = h[:, 0:w - w % 2:2]
    s = torch.randint(1, 4, (nw, w), generator=gen, device=dev) / 3.0
    return h.to(BF16), s


def _route_counts():
    return (dict(knn_density.launches_by_route),
            dict(merge_assign.launches_by_route))


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["mma", "simt"])
@pytest.mark.parametrize("shape", WINDOW_SHAPES)
def test_window_route_matches_plain(cuda_device, which, shape):
    """Each route against the plain versions on bf16 windows; the mma route
    raises on a shape it does not take (ragged D)."""
    nw, w, d, k, m = shape
    h, s = _windows(cuda_device, BF16, nw, w, d)
    if which == "mma" and d % 8:
        with pytest.raises(ValueError, match="mma route does not take"):
            knn_mod._launch(which, h, k)
        with pytest.raises(ValueError, match="mma route does not take"):
            tm_mod._launch(which, h, s, m)
        return
    before = _route_counts()
    rho = knn_mod._launch(which, h, k)
    merged, assign, centers = tm_mod._launch(which, h, s, m)
    torch.cuda.synchronize(cuda_device)
    assert knn_density.launches_by_route[which] == before[0][which] + 1
    assert merge_assign.launches_by_route[which] == before[1][which] + 1
    torch.testing.assert_close(rho, ref.knn_density(h, k), rtol=1e-4,
                               atol=1e-4)
    want = ref.merge_assign(h, s, m)
    assert merged.dtype == BF16 and merged.shape == want[0].shape
    assert torch.equal(centers, want[2])
    assert torch.equal(assign, want[1])
    torch.testing.assert_close(merged.float(), want[0].float(), rtol=5e-2,
                               atol=5e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(128, 16, 1152, 5, 8),
                                   (4, 32, 1152, 5, 8), (3, 32, 200, 3, 1),
                                   (6, 16, 1000, 5, 8), (9, 5, 64, 4, 2)])
def test_window_routes_agree_on_bf16_windows(cuda_device, shape):
    """Same bf16 windows, both routes: centers and assign exact, merged
    bitwise (the weighted means' arithmetic is shared), rho within 1e-4
    (only the Gram's summation order differs)."""
    nw, w, d, k, m = shape
    h, s = _windows(cuda_device, BF16, nw, w, d, seed=7)
    mma = tm_mod._launch("mma", h, s, m)
    simt = tm_mod._launch("simt", h, s, m)
    assert torch.equal(mma[2], simt[2])
    assert torch.equal(mma[1], simt[1])
    assert torch.equal(mma[0], simt[0])
    torch.testing.assert_close(knn_mod._launch("mma", h, k),
                               knn_mod._launch("simt", h, k), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(128, 16, 1152, 5, 8),
                                   (4, 32, 1152, 5, 8), (5, 15, 1000, 6, 7)])
def test_window_routes_break_exact_ties_by_first_occurrence(cuda_device,
                                                           shape):
    """Duplicated tokens and integer values give exact distance and score
    ties: both routes pick the plain version's centers (lax.top_k order)
    and first-occurrence argmins, and their rho and merged tokens are
    bitwise equal."""
    nw, w, d, k, m = shape
    h, s = _int_windows(cuda_device, nw, w, d)
    want = ref.merge_assign(h, s, m)
    got = {r: tm_mod._launch(r, h, s, m) for r in ("mma", "simt")}
    rho = {r: knn_mod._launch(r, h, k) for r in ("mma", "simt")}
    for r in ("mma", "simt"):
        assert torch.equal(got[r][2], want[2])
        assert torch.equal(got[r][1], want[1])
        torch.testing.assert_close(got[r][0].float(), want[0].float(),
                                   rtol=5e-2, atol=5e-2)
        torch.testing.assert_close(rho[r], ref.knn_density(h, k), rtol=1e-4,
                                   atol=1e-4)
    assert torch.equal(got["mma"][0], got["simt"][0])
    assert torch.equal(rho["mma"], rho["simt"])


@pytest.mark.cuda
@pytest.mark.parametrize("w", [16, 32])
def test_window_mma_route_is_deterministic(cuda_device, w):
    h, s = _windows(cuda_device, BF16, 128, w, 1152)
    first = (knn_mod._launch("mma", h, 5), *tm_mod._launch("mma", h, s, 8))
    for _ in range(3):
        again = (knn_mod._launch("mma", h, 5),
                 *tm_mod._launch("mma", h, s, 8))
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_window_wrappers_pick_the_route(cuda_device):
    """The served windows go to mma; f32, ragged D and an unaligned base to
    SIMT; a named mma launch on an unaligned base raises."""
    before = _route_counts()
    h, s = _windows(cuda_device, BF16, 128, 16, 1152)
    knn_density(h, k=5)
    merge_assign(h, s, m=8)
    knn_density(h.float(), k=5)
    merge_assign(h.float(), s, m=8)
    ragged, rs = _windows(cuda_device, BF16, 5, 8, 100)
    knn_density(ragged, k=7)
    merge_assign(ragged, rs, m=3)
    flat = torch.zeros(4 * 16 * 1152 + 1, dtype=BF16, device=cuda_device)
    off = flat[1:].view(4, 16, 1152)
    off.copy_(h[:4])
    assert off.data_ptr() % 16 != 0
    knn_density(off, k=5)
    merge_assign(off, s[:4].contiguous(), m=8)
    torch.cuda.synchronize(cuda_device)
    for fn, b in zip((knn_density, merge_assign), before):
        assert fn.launches_by_route == {"mma": b["mma"] + 1,
                                        "simt": b["simt"] + 3}
    with pytest.raises(ValueError, match="mma route does not take"):
        knn_mod._launch("mma", off, 5)
    with pytest.raises(ValueError, match="mma route does not take"):
        tm_mod._launch("mma", off, s[:4].contiguous(), 8)
    with pytest.raises(ValueError, match="mma route does not take"):
        knn_mod._launch("mma", h.float(), 5)
    with pytest.raises(ValueError, match="unknown route"):
        knn_mod._launch("wgmma", h, 5)


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

# (B, H, KVH, Sq, Skv, causal, window): the serve's prefill, ragged
# lengths, end alignment (Sq < Skv), a window that skips tiles on both
# sides, bidirectional with and without a window, a single query against a
# long cache, the diagonal alone (window 1), a batch of 4 at the serve's
# width, and a long sliding window
FLASH_SHAPES = [(1, 16, 8, 512, 512, True, 1024), (2, 4, 2, 100, 100, True, 0),
                (1, 4, 1, 64, 576, True, 0), (1, 4, 2, 700, 700, True, 128),
                (2, 4, 4, 37, 141, False, 50), (1, 8, 8, 130, 130, False, 0),
                (1, 4, 2, 1, 300, True, 0), (1, 4, 2, 130, 130, True, 1),
                (4, 16, 8, 512, 512, True, 1024),
                (1, 8, 4, 4096, 4096, True, 512)]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _qkv(dev, dtype, b, h, kvh, sq, skv, dh, seed=0):
    gen = torch.Generator(dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((b, h, sq, dh), (b, kvh, skv, dh),
                          (b, kvh, skv, dh))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [64, 128, 16, 32, 48, 80, 96, 112])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_attention_kernel_matches_plain(cuda_device, dtype, dh, shape):
    """Tolerances: the reference's (tests/test_kernels.py:106), 2e-5 in
    f32 (online softmax against a full softmax, both f32) and 2e-2 in bf16
    (the output is rounded to bf16).  Head dims below an instance's (16-48
    on the 64 instance, 80-112 on the 128 one) read zero columns past dh,
    and the output's columns stop at dh."""
    b, h, kvh, sq, skv, causal, window = shape
    q, k, v = _qkv(cuda_device, dtype, b, h, kvh, sq, skv, dh)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize(cuda_device)
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 128, 80, 112])
def test_flash_attention_bf16_and_f32_instances_each_launch(cuda_device, dh):
    """bf16 runs the wgmma instance and f32 the SIMT one: one launch each,
    each within its dtype's tolerance of the plain version."""
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _qkv(cuda_device, dtype, 1, 4, 2, 200, 200, dh, seed=5)
        before = flash_attention.launches
        got = flash_attention(q, k, v, causal=True, window=96)
        torch.cuda.synchronize(cuda_device)
        assert flash_attention.launches == before + 1
        want = ref.flash_attention(q, k, v, causal=True, window=96)
        tol = FLASH_TOL[dtype]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.cuda
def test_flash_attention_kernel_reads_strided_views(cuda_device):
    """(B, S, H, dh) activations passed as transposed views give the
    contiguous inputs' result bitwise, in the views' layout."""
    q, k, v = _qkv(cuda_device, torch.bfloat16, 2, 16, 8, 96, 96, 128)
    want = flash_attention(q, k, v, causal=True, window=40)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    got = flash_attention(*views, causal=True, window=40)
    torch.cuda.synchronize(cuda_device)
    assert got.stride() == views[0].stride()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_flash_attention_kernel_is_deterministic(cuda_device):
    q, k, v = _qkv(cuda_device, torch.bfloat16, 1, 16, 8, 512, 512, 128)
    before = flash_attention.launches
    first = flash_attention(q, k, v, causal=True, window=1024)
    for _ in range(3):
        assert torch.equal(flash_attention(q, k, v, causal=True,
                                           window=1024), first)
    assert flash_attention.launches == before + 4


@pytest.mark.cuda
def test_flash_attention_raises_on_bad_cuda_input(cuda_device):
    q, k, v = _qkv(cuda_device, torch.float16, 1, 4, 2, 16, 16, 64)
    with pytest.raises(TypeError):
        flash_attention(q, k, v, causal=True)
    q, k, v = _qkv(cuda_device, torch.float32, 1, 4, 2, 16, 16, 40)
    with pytest.raises(ValueError, match="head_dim"):    # not a multiple
        flash_attention(q, k, v, causal=True)            # of 16
    q, k, v = _qkv(cuda_device, torch.float32, 1, 4, 2, 16, 16, 64)
    padded = torch.zeros((1, 2, 16, 65), device=cuda_device)[..., :64]
    with pytest.raises(ValueError, match="aligned"):      # rows of 260 B
        flash_attention(q, padded, v, causal=True)
    with pytest.raises(ValueError, match="share one device"):
        flash_attention(q, k.cpu(), v, causal=True)
    q, k, v = _qkv(cuda_device, torch.bfloat16, 1, 4, 1, 16, 16, 64)
    with pytest.raises(ValueError, match="broadcast"):
        flash_attention(q, k.expand(1, 2, 16, 64), v.expand(1, 2, 16, 64),
                        causal=True)


@pytest.mark.cuda
def test_full_width_prefill_kernel_matches_plain_path(cuda_device,
                                                      monkeypatch):
    """qwen3-0.6b at full width (28 layers, bf16, random weights), one
    512-token prefill through the kernel and, with the plain twin patched
    into models/attention.py, without it: the cache positions exact, the
    last-position logits within a relative L2 of 2e-2 (bf16 activations
    through 28 layers; a bf16 rounding is 4e-3 relative), 28 launches."""
    from repro_torch.launch.serve import LLMWorkload
    from repro_torch.models import attention

    wl = LLMWorkload()
    model = wl.build_model(cuda_device)
    prompt = torch.from_numpy(wl.build_requests(model)[0].prompt).long()
    tokens = prompt[None].to(cuda_device)
    before = flash_attention.launches
    logits, cache = model.prefill({"tokens": tokens}, wl.window)
    torch.cuda.synchronize(cuda_device)
    assert flash_attention.launches - before == model.cfg.num_layers
    with monkeypatch.context() as m:
        m.setattr(attention, "flash_attention", ref.flash_attention)
        plain_logits, plain_cache = model.prefill({"tokens": tokens}, wl.window)
    assert flash_attention.launches - before == model.cfg.num_layers
    assert torch.equal(cache["pos"], plain_cache["pos"])
    a, b = logits.float(), plain_logits.float()
    assert torch.isfinite(a).all()
    rel = float((a - b).norm() / b.norm())
    assert rel < 2e-2, rel


@pytest.mark.cuda
def test_llm_prefill_and_decode_make_no_host_sync(cuda_device):
    """The model's prefill and exact decode step queue device work only:
    under sync debug "error" any host synchronization raises (the engine's
    greedy-token read and the decode gate's per-layer test are the path's
    only syncs, and they lie outside these calls)."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import TransformerModel

    model = TransformerModel(get_reduced("qwen3-0.6b"), device=cuda_device)
    model.init(torch.Generator(cuda_device).manual_seed(0))
    gen = torch.Generator(cuda_device).manual_seed(1)
    tokens = torch.randint(0, model.cfg.vocab_size, (2, 40), generator=gen,
                           device=cuda_device)
    _, warm = model.prefill({"tokens": tokens[:, :8]}, 16)     # first calls of each op
    model.decode_step(tokens[:, 8], warm)
    torch.cuda.synchronize(cuda_device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, cache = model.prefill({"tokens": tokens}, 16)
        for i in range(3):
            model.decode_step(tokens[:, i], cache)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(cuda_device)
    assert cache["step"].tolist() == [43, 43]


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [80, 112])
def test_flash_attention_new_head_dims_write_only_their_columns(cuda_device,
                                                                 dh):
    """At dh 80 and 112 (the 128 instance) the kernel writes the dh true
    columns of a strided output and nothing past them: a (B, S, H, 128)
    buffer's columns dh..127 keep their fill, in both dtypes."""
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _qkv(cuda_device, dtype, 1, 4, 2, 130, 130, dh, seed=7)
        want = ref.flash_attention(q, k, v, causal=True, window=0)
        got = flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize(cuda_device)
        tol = FLASH_TOL[dtype]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        # the output as a (B, H, S, dh) view of a (B, S, H, 128) buffer
        wide = torch.full((1, 130, 4, 128), 7.0, dtype=dtype,
                          device=cuda_device)
        out = wide[..., :dh].transpose(1, 2)
        b, h, sq, _ = q.shape
        err = fa_mod._kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            2, sq, sq, dh, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], 1, 0, dh ** -0.5,
            fa_mod._DTYPE_CODE[dtype], None, None, 0, 0, 0, 0,
            torch.cuda.current_stream(cuda_device).cuda_stream)
        torch.cuda.synchronize(cuda_device)
        assert err == 0
        assert torch.equal(out, got)
        assert bool((wide[..., dh:] == 7.0).all())


# ---------------------------------------------------------------------------
# flash_attention's position mode
# ---------------------------------------------------------------------------

def layout_t(n_text: int, grid: int, n_after: int) -> torch.Tensor:
    """The t axis of the reference's M-RoPE layout of an image prompt:
    text at 0 .. n_text - 1, the grid x grid image at n_text, text from
    n_text + grid."""
    return torch.cat([torch.arange(n_text),
                      torch.full((grid * grid,), n_text),
                      torch.arange(n_text + grid, n_text + grid + n_after)])


def _positions(case: str, b: int, s: int, seed: int) -> torch.Tensor:
    """(b, s) int32 self-attention positions (CPU)."""
    gen = torch.Generator().manual_seed(seed)
    if case == "layout":
        n_text = max(1, (s - 256) // 2)
        t = layout_t(n_text, 16, s - n_text - 256) if s > 256 + 1 else \
            layout_t(s // 4, 4, s - s // 4 - 16)
        return t[None].expand(b, s).to(torch.int32)
    if case == "repeats":
        return torch.sort(torch.randint(0, max(1, s // 3), (b, s),
                                        generator=gen), dim=1).values.to(
                                            torch.int32)
    if case == "permutation":
        return torch.stack([torch.randperm(s, generator=gen)
                            for _ in range(b)]).to(torch.int32)
    if case == "empty_slots":            # -1 keys, and rows with no live key
        pos = torch.arange(s).repeat(b, 1)
        pos[torch.rand((b, s), generator=gen) < 0.25] = -1
        return pos.to(torch.int32)
    raise KeyError(case)


# (B, H, KVH, S, dh): Qwen2-VL-2B's prefill (12 / 2 heads of 128, S 512),
# ragged lengths, GQA 4:1 at dh 64 and MHA at dh 80
POS_SHAPES = [(1, 12, 2, 512, 128), (2, 4, 2, 200, 64), (1, 4, 4, 130, 80)]
POS_MASKS = [(True, 1024), (True, 0), (True, 48), (False, 0), (False, 48)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask", POS_MASKS)
@pytest.mark.parametrize("case", ["layout", "repeats", "permutation",
                                  "empty_slots"])
@pytest.mark.parametrize("shape", POS_SHAPES)
def test_flash_attention_position_mode_matches_plain(cuda_device, dtype,
                                                     mask, case, shape):
    """Position mode on both routes (bf16: wgmma, f32: SIMT) against the
    plain version on the same positions: the reference's M-RoPE layout,
    repeated positions, a permutation (tiles in no order of position) and
    -1 slots (rows with no live key: the uniform mean of the values).
    Tolerances as the implicit mode's: 2e-5 in f32, 2e-2 in bf16."""
    b, h, kvh, s, dh = shape
    causal, window = mask
    q, k, v = _qkv(cuda_device, dtype, b, h, kvh, s, s, dh, seed=s)
    pos = _positions(case, b, s, seed=dh).to(cuda_device)
    kw = dict(causal=causal, window=window, q_pos=pos, kv_pos=pos)
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize(cuda_device)
    assert flash_attention.launches == before + 1
    want = ref.flash_attention(q, k, v, **kw)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(flash_attention(q, k, v, **kw), got)   # repeats


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_attention_arange_positions_equal_implicit(cuda_device,
                                                         dtype, shape):
    """Position mode fed q_pos = i + Skv - Sq and kv_pos = j (one row,
    broadcast over the batch) gives the implicit mode's output bit for
    bit, on both routes, at every shape of the implicit mode's tests."""
    b, h, kvh, sq, skv, causal, window = shape
    q, k, v = _qkv(cuda_device, dtype, b, h, kvh, sq, skv, 128, seed=1)
    want = flash_attention(q, k, v, causal=causal, window=window)
    got = flash_attention(
        q, k, v, causal=causal, window=window,
        q_pos=(torch.arange(sq, device=cuda_device) + skv - sq)[None],
        kv_pos=torch.arange(skv, device=cuda_device)[None])
    torch.cuda.synchronize(cuda_device)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_position_mode_queries_a_ring(cuda_device, dtype):
    """Sq = 64 queries against a ring of 1,024 key slots in rotated order
    with empty (-1) slots, a batch stride of 0 on the positions (one row
    for both samples), causal with a window of 300: tiles skipped on the
    positions' test alone."""
    q, k, v = _qkv(cuda_device, dtype, 2, 8, 2, 64, 1024, 128, seed=3)
    kv = torch.roll(torch.arange(1024), 300)
    kv[torch.rand(1024, generator=torch.Generator().manual_seed(0))
       < 0.1] = -1
    qp = torch.arange(960, 1024)
    kw = dict(causal=True, window=300, q_pos=qp[None].to(cuda_device),
              kv_pos=kv[None].to(cuda_device))
    got = flash_attention(q, k, v, **kw)
    want = ref.flash_attention(q, k, v, **kw)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_vlm_image_prompt_prefill_makes_no_host_sync(cuda_device):
    """A reduced Qwen2-VL (bf16) prefill of an image prompt in the
    reference's M-RoPE layout (t positions shared by the image) and 3
    decode steps queue device work only (sync debug "error"); every
    attention layer launches the kernel in position mode, and the cache's
    positions are the t axis."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import TransformerModel

    model = TransformerModel(get_reduced("qwen2-vl-2b"), device=cuda_device)
    model.init(torch.Generator(cuda_device).manual_seed(0))
    n_text, grid = 12, 4                        # 16 embeddings, S = 40
    t = layout_t(n_text, grid, 12)
    s = t.numel()
    r = torch.arange(grid).repeat_interleave(grid)
    c = torch.arange(grid).repeat(grid)
    h, w = t.clone(), t.clone()
    h[n_text:n_text + 16] = n_text + r
    w[n_text:n_text + 16] = n_text + c
    mask = torch.zeros((2, s), dtype=torch.bool)
    mask[:, n_text:n_text + 16] = True
    gen = torch.Generator(cuda_device).manual_seed(1)
    batch = {"tokens": torch.randint(0, model.cfg.vocab_size, (2, s),
                                     generator=gen, device=cuda_device),
             "vision_embeds": 0.02 * torch.randn(
                 (2, 16, model.cfg.d_model), generator=gen,
                 device=cuda_device).to(model.dtype),
             "vision_mask": mask.to(cuda_device),
             "positions": torch.stack([t, h, w], -1)[None].expand(
                 2, s, 3).to(torch.int32).to(cuda_device)}
    _, warm = model.prefill(batch, 64)          # first calls of each op
    model.decode_step(batch["tokens"][:, 0], warm)
    torch.cuda.synchronize(cuda_device)
    before = flash_attention.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, cache = model.prefill(batch, 64)
        for i in range(3):
            model.decode_step(batch["tokens"][:, i], cache)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(cuda_device)
    assert flash_attention.launches - before == model.cfg.num_layers
    assert torch.equal(cache["pos"][:, :, :s].cpu(),
                       t.to(torch.int32).expand(model.cfg.num_layers, 2, s))
    assert cache["step"].tolist() == [s + 3, s + 3]


@pytest.mark.cuda
@pytest.mark.parametrize("length", [64, 256])
def test_mamba_scans_are_bitwise_equal_on_the_card(cuda_device, length):
    """The Mamba chunk scan on the card at Jamba's full width (d_inner
    8,192, d_state 16), called as a no_grad prefill calls it and as
    training does (autograd recording): the same bits, and within f32's
    1e-4 of the same scan on the CPU."""
    from repro_torch.models import mamba

    gen = torch.Generator(cuda_device).manual_seed(length)
    da = torch.rand((1, length, 8192, 16), generator=gen, device=cuda_device)
    dbx, c, h0 = (torch.randn(shape, generator=gen, device=cuda_device)
                  for shape in ((1, length, 8192, 16), (1, length, 16),
                                (1, 8192, 16)))
    with torch.no_grad():
        a = mamba._chunk_scan(da, dbx, c, h0)
    b = mamba._chunk_scan(da, dbx.requires_grad_(True), c, h0)
    assert b[0].requires_grad
    assert all(torch.equal(x, y.detach()) for x, y in zip(a, b))
    with torch.no_grad():
        want = mamba._chunk_scan(*(t.cpu() for t in (da, dbx, c, h0)))
    for got, w in zip(a, want):
        torch.testing.assert_close(got.cpu(), w, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["xlstm-1.3b", "jamba-v0.1-52b"])
def test_ssm_train_step_on_the_card(cuda_device, arch):
    """One train step of the reduced config (f32) on the card beside the
    same step on the CPU from the same weights and batch: the loss within
    1e-4 relative, and no host sync in the step."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import TransformerModel
    from repro_torch.training import loop, optimizer

    cfg = get_reduced(arch).replace(dtype="float32")
    out = {}
    toks = torch.randint(0, cfg.vocab_size, (2, 32),
                         generator=torch.Generator().manual_seed(2))
    weights = TransformerModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(0)).state_dict()
    for dev in ("cpu", cuda_device):
        model = TransformerModel(cfg, device=dev)
        model.load_state_dict(weights)
        params = loop.param_tree(model)
        opt = optimizer.make_optimizer(cfg.optimizer)
        state = opt.init(params)
        step = loop.make_train_step(model, opt,
                                    optimizer.cosine_schedule(1e-3, 1, 2))
        batch = {"tokens": toks.to(dev)}
        step(params, state, batch)                 # first calls of each op
        if dev != "cpu":
            torch.cuda.synchronize(cuda_device)
            torch.cuda.set_sync_debug_mode("error")
        try:
            _, _, met = step(params, state, batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        out[str(dev)] = float(met["loss"])
    assert all(math.isfinite(x) for x in out.values())
    assert math.isclose(out[str(cuda_device)], out["cpu"], rel_tol=1e-4), out


# ---------------------------------------------------------------------------
# the MoE layer (no kernel of its own: plain PyTorch, as the reference
# leaves it to XLA)
# ---------------------------------------------------------------------------

def _moe_model(dev, arch="arctic-480b", num_layers=2):
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import TransformerModel
    cfg = get_reduced(arch).replace(num_layers=num_layers)   # bf16
    return TransformerModel(cfg, device=dev).init(
        torch.Generator(dev).manual_seed(0))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["arctic-480b", "kimi-k2-1t-a32b"])
def test_moe_capacity_and_gather_paths_agree_on_the_card(cuda_device, arch):
    """At a decode batch (T * k <= E, capacity min_capacity: no copy
    dropped) the capacity path and the gather path (``MOE_GATHER_DECODE``)
    choose the same experts and agree within bf16's 2e-2 of the output's
    scale; neither reads anything back to the host (sync debug "error")."""
    from repro_torch.models import layers
    model = _moe_model(cuda_device, arch)
    p, cfg = model.blocks[0].moe, model.cfg
    gen = torch.Generator(cuda_device).manual_seed(3)
    x = torch.randn((2, 1, cfg.d_model), generator=gen,
                    device=cuda_device).to(BF16)
    layers.moe_apply(p, x, cfg)                   # first calls of each op
    layers.moe_gather_apply(p, x, cfg)
    torch.cuda.synchronize(cuda_device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        y_cap, a_cap = layers.moe_apply(p, x, cfg)
        y_gat, a_gat = layers.moe_gather_apply(p, x, cfg)
        h = layers.common.rms_norm(x, p.norm, cfg.norm_eps).reshape(2, -1)
        top_i = layers._route(p, h, cfg.moe.top_k)[2]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(cuda_device)
    assert top_i.shape == (2, cfg.moe.top_k)
    scale = max(1.0, float(y_gat.float().abs().max()))
    torch.testing.assert_close(y_cap.float(), y_gat.float(), rtol=2e-2,
                               atol=2e-2 * scale)
    torch.testing.assert_close(a_cap, a_gat, rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_moe_gated_decode_makes_one_sync_a_step(cuda_device):
    """The reduced arctic-480b (bf16) served with the decode gate: after
    the eager warm-up steps and the capture, every decode step is a replay
    of the step graph and makes one host sync (the greedy tokens), in the
    port's counted place; the gate's per-layer skips are IF nodes and the
    MoE blocks inside them add none."""
    import warnings
    from repro_torch.configs.base import FastCacheConfig
    from repro_torch.serving.engine import Request, ServingEngine
    model = _moe_model(cuda_device)
    eng = ServingEngine(model, max_batch=2, window=64,
                        fastcache=FastCacheConfig())
    gen = torch.Generator().manual_seed(0)
    for rid in range(2):
        eng.add_request(Request(rid=rid, prompt=torch.randint(
            0, model.cfg.vocab_size, (24,), generator=gen).numpy(),
            max_new_tokens=12))
    for _ in range(3):
        eng.step()                         # first calls, trackers, capture
    assert eng.graphs.captures == 1
    torch.cuda.synchronize(cuda_device)
    counted = eng.host_syncs + eng.decoder.host_syncs
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(4):
                eng.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the process's first set_sync_debug_mode also warns that the mode is
    # a prototype: not a synchronization
    flagged = [w for w in caught if "synchroniz" in str(w.message)
               and "prototype" not in str(w.message)]
    want = 4
    assert eng.graphs.replays == 5
    assert eng.host_syncs + eng.decoder.host_syncs - counted == want
    assert len(flagged) == want, [f"{w.filename}:{w.lineno}"
                                  for w in flagged]


# ---------------------------------------------------------------------------
# saliency_delta and linear_blend, and the baseline policies that run them
# ---------------------------------------------------------------------------

# (B, N, D): fastcache/teacache at 4 slots, merged, then ragged ones; a
# None batch is the reference's (N, D) pair
SAL_SHAPES = [(8, 256, 1152), (8, 128, 1152), (3, 37, 100), (2, 5, 7),
              (None, 1001, 24), (1, 1, 1)]


def _sal_pair(dev, dtype, shape, seed=0):
    shape = shape[1:] if shape[0] is None else shape
    gen = torch.Generator(dev).manual_seed(seed)
    x = torch.randn(shape, generator=gen, device=dev)
    prev = x + 0.1 * torch.randn(shape, generator=gen, device=dev)
    return x.to(dtype), prev.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SAL_SHAPES)
def test_saliency_delta_kernel_matches_plain(cuda_device, dtype, shape):
    x, prev = _sal_pair(cuda_device, dtype, shape)
    before = saliency_delta.launches
    got = saliency_delta(x, prev)
    torch.cuda.synchronize(cuda_device)
    assert saliency_delta.launches == before + 1
    want = ref.saliency_delta(x, prev)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_saliency_delta_kernel_reads_unaligned_rows(cuda_device):
    """Rows that are not 16-byte aligned take the one-element loads: the
    same result as the plain version."""
    n, d = 256, 1152
    flat = torch.randn((2, 2 * n * d + 1), device=cuda_device).to(
        torch.bfloat16)
    x, prev = (flat[i, 1:].view(2, n, d) for i in range(2))
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    got = saliency_delta(x, prev)
    torch.cuda.synchronize(cuda_device)
    for g, w in zip(got, ref.saliency_delta(x, prev)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_saliency_delta_kernel_is_deterministic(cuda_device):
    x, prev = _sal_pair(cuda_device, torch.bfloat16, (8, 256, 1152))
    first = saliency_delta(x, prev)
    for _ in range(3):
        for a, b in zip(first, saliency_delta(x, prev)):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_saliency_delta_raises_on_bad_cuda_input(cuda_device):
    x, prev = _sal_pair(cuda_device, torch.float16, (2, 8, 16))
    with pytest.raises(TypeError):
        saliency_delta(x, prev)
    x, prev = _sal_pair(cuda_device, torch.float32, (2, 8, 16))
    with pytest.raises(ValueError, match="share one device"):
        saliency_delta(x, prev.cpu())
    with pytest.raises(ValueError, match="x_prev must match"):
        saliency_delta(x, prev[:, :4].contiguous())


# the onepass route against the SIMT route: N below, at and above the 32
# blocks of a sample and the 256 slots of its totals (N = 1000: four rows a
# warp)
SAL_ROUTE_NS = [1, 7, 128, 255, 256, 257, 1000]


def _sal_route_counts():
    return dict(saliency_delta.launches_by_route)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 1152, 1160])
@pytest.mark.parametrize("b", [1, 3, 8])
def test_saliency_routes_are_bitwise_equal(cuda_device, dtype, d, b):
    """At every N (N = 1 and 7 leave blocks of a sample with no row; N >
    256 gives a warp several rows), the onepass kernel's sal, diff and
    prevsq are the SIMT route's bits and within rtol 1e-5 of the plain
    version; the wrapper picks onepass up to N = 256 and SIMT beyond."""
    for n in SAL_ROUTE_NS:
        x, prev = _sal_pair(cuda_device, dtype, (b, n, d), seed=n)
        before = _sal_route_counts()
        got = saliency_delta(x, prev)
        torch.cuda.synchronize(cuda_device)
        which = "onepass" if n <= 256 else "simt"
        after = dict(before, **{which: before[which] + 1})
        assert saliency_delta.launches_by_route == after
        onepass = sal_mod._launch("onepass", x, prev)
        simt = sal_mod._launch("simt", x, prev)
        for g, o, s in zip(got, onepass, simt):
            assert torch.equal(o, s), (n, d, b)
            assert torch.equal(g, s), (n, d, b)
        for g, w in zip(onepass, ref.saliency_delta(x, prev)):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_saliency_onepass_route_is_deterministic(cuda_device, dtype):
    """Repeated calls, queued back to back (each may start while the one
    before drains), give the same bits: the tickets are left at zero."""
    x, prev = _sal_pair(cuda_device, dtype, (8, 1000, 1160))
    first = sal_mod._launch("onepass", x, prev)
    again = [sal_mod._launch("onepass", x, prev) for _ in range(20)]
    for outs in again:
        for a, b in zip(first, outs):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_saliency_onepass_route_reads_what_the_kernel_before_wrote(
        cuda_device):
    """The kernel may start while the one before it drains: it must still
    read that kernel's output and leave that kernel's inputs alone.  Each
    call's x is written by a PyTorch kernel just before it, and each call's
    outputs land in memory the caching allocator just freed."""
    x, prev = _sal_pair(cuda_device, BF16, (8, 256, 1152))
    want = sal_mod._launch("simt", x, prev)
    for scale in (2.0, 3.0, 1.0):
        xs = x * scale          # written by the kernel before the call
        got = sal_mod._launch("onepass", xs, prev)
        del xs
        wanted = sal_mod._launch("simt", x * scale, prev)
        for g, w in zip(got, wanted):
            assert torch.equal(g, w)
    for g, w in zip(sal_mod._launch("onepass", x, prev), want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_saliency_wrapper_picks_the_route(cuda_device):
    """Ragged rows (bf16 D = 100: 200 bytes) and unaligned bases go to
    SIMT, f32 D = 100 (400 bytes) to onepass; a named onepass launch on
    either SIMT input raises, as does an unknown route."""
    before = _sal_route_counts()
    x, prev = _sal_pair(cuda_device, BF16, (2, 5, 100))
    saliency_delta(x, prev)
    saliency_delta(x.float(), prev.float())
    n, d = 256, 1152
    flat = torch.randn((2, 2 * n * d + 1), device=cuda_device).to(BF16)
    ux, up = (flat[i, 1:].view(2, n, d) for i in range(2))
    saliency_delta(ux, up)
    torch.cuda.synchronize(cuda_device)
    assert saliency_delta.launches_by_route == {
        "onepass": before["onepass"] + 1, "simt": before["simt"] + 2}
    for a, b in ((x, prev), (ux, up)):
        with pytest.raises(ValueError, match="onepass route does not take"):
            sal_mod._launch("onepass", a, b)
    with pytest.raises(ValueError, match="unknown route"):
        sal_mod._launch("mma", x, prev)


@pytest.mark.cuda
def test_saliency_onepass_route_holds_the_serve_in_one_wave(cuda_device):
    """The serve's 8 samples, 256 blocks, fit on the card at once."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert sal_mod.onepass_blocks_per_sm(BF16) * sms >= 8 * 32


# (M, D, F): 4 slots x CFG x 256 tokens, merged, then ragged edges
BLEND_SHAPES = [(2048, 1152, 1152), (1024, 1152, 1152), (1000, 1000, 1000),
                (130, 257, 129), (37, 13, 5), (1, 1, 1)]
BLEND_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _blend_args(dev, dtype, m, d, f, seed=0):
    gen = torch.Generator(dev).manual_seed(seed)
    x = torch.randn((m, d), generator=gen, device=dev).to(dtype)
    w = torch.eye(d, f, device=dev) + 0.01 * torch.randn(
        (d, f), generator=gen, device=dev)
    b = 0.1 * torch.randn((f,), generator=gen, device=dev)
    prev = torch.randn((m, f), generator=gen, device=dev).to(dtype)
    return x, w, b, prev


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gamma", [1.0, 0.5, 0.0])
@pytest.mark.parametrize("shape", BLEND_SHAPES)
def test_linear_blend_kernel_matches_plain(cuda_device, dtype, gamma, shape):
    args = _blend_args(cuda_device, dtype, *shape)
    before = linear_blend.launches
    got = linear_blend(*args, gamma=gamma, w_bf16=args[1].to(BF16))
    torch.cuda.synchronize(cuda_device)
    assert linear_blend.launches == before + 1
    assert got.dtype == dtype and got.shape == (shape[0], shape[2])
    want = ref.linear_blend(*args, gamma)
    tol = BLEND_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_linear_blend_kernel_is_deterministic(cuda_device):
    args = _blend_args(cuda_device, torch.bfloat16, 2048, 1152, 1152)
    w_bf16 = args[1].to(BF16)
    for gamma in (1.0, 0.5):
        first = linear_blend(*args, gamma=gamma, w_bf16=w_bf16)
        for _ in range(2):
            assert torch.equal(linear_blend(*args, gamma=gamma,
                                            w_bf16=w_bf16), first)


@pytest.mark.cuda
def test_linear_blend_raises_on_bad_cuda_input(cuda_device):
    x, w, b, prev = _blend_args(cuda_device, torch.float16, 8, 16, 16)
    with pytest.raises(TypeError):
        linear_blend(x, w, b, prev, gamma=0.5)
    x, w, b, prev = _blend_args(cuda_device, torch.float32, 8, 16, 16)
    with pytest.raises(ValueError, match="share one device"):
        linear_blend(x, w.cpu(), b, prev, gamma=0.5)
    with pytest.raises(ValueError, match="w must be"):
        linear_blend(x, w.to(torch.bfloat16), b, prev, gamma=0.5)


BASELINES = ("fora", "teacache", "adacache", "fbcache", "l2c", "smoothcache")


@pytest.mark.cuda
@pytest.mark.parametrize("policy", BASELINES)
def test_policy_step_kernels_match_plain_path(cuda_device, monkeypatch,
                                              policy):
    """Six steps of each baseline policy on the card through the kernels
    and, with the plain versions patched in, without them: every counter
    and every integer or bool state leaf exact at every step (the step-level
    gates take the same decisions), eps within f32 rounding; saliency_delta
    launched once per step for teacache, adacache and fbcache, linear_blend
    once per masked layer and step for l2c, neither for fora and
    smoothcache."""
    from repro_torch.configs.base import FastCacheConfig
    from repro_torch.configs.dit import reduced
    from repro_torch.core import saliency
    from repro_torch.core.policies import base, l2c
    from repro_torch.core.runner import CachedDiT
    from repro_torch.models.dit import DiTModel

    cfg = reduced().replace(dtype="float32")
    model = DiTModel(cfg, device=cuda_device)
    model.init(torch.Generator(cuda_device).manual_seed(0))
    mask = torch.zeros(cfg.num_layers, dtype=torch.bool)
    mask[0] = True
    kw = {"l2c_mask": mask} if policy == "l2c" else {}
    kernel, plain = (CachedDiT(model, FastCacheConfig(), policy=policy, **kw)
                     for _ in range(2))
    states = [kernel.init_state(4), plain.init_state(4)]
    gen = torch.Generator(cuda_device).manual_seed(1)
    x = torch.randn((4, 8, 8, 4), generator=gen, device=cuda_device)
    labels = torch.arange(4, device=cuda_device)
    counts = (saliency_delta.launches, linear_blend.launches)
    for i in range(6):
        t = torch.full((4,), 50 - i, device=cuda_device)
        outs = [kernel.step(states[0], x, t, labels)]
        with monkeypatch.context() as m:
            m.setattr(base, "saliency_delta", ref.saliency_delta)
            m.setattr(saliency, "saliency_delta", ref.saliency_delta)
            m.setattr(l2c, "linear_blend",
                      lambda x, w, b, prev, *, gamma, w_bf16=None, gemm=None:
                      ref.linear_blend(x, w, b, prev, gamma))
            outs.append(plain.step(states[1], x, t, labels))
        states = [o[1] for o in outs]
        for k in ("blocks_computed", "blocks_skipped", "steps_reused",
                  "motion_frac_sum"):
            assert torch.equal(states[0]["stats"][k], states[1]["stats"][k])
        for k, v in states[0].items():
            if k != "stats" and not v.is_floating_point():
                assert torch.equal(v, states[1][k]), (k, i)
        torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-4,
                                   atol=1e-4)
        x = x - 0.02 * outs[1][0]
    launched = (saliency_delta.launches - counts[0],
                linear_blend.launches - counts[1])
    want = {"teacache": (6, 0), "adacache": (6, 0), "fbcache": (6, 0),
            "l2c": (0, 6), "fora": (0, 0), "smoothcache": (0, 0)}[policy]
    assert launched == want


# ---------------------------------------------------------------------------
# the two routes of linear_blend and fused_gate
# ---------------------------------------------------------------------------

# (M, D, F): ragged but eligible for the wgmma route (rows past a 128-row
# tile, K past a 64 chunk, one row)
WGMMA_BLEND_SHAPES = [(130, 1152, 1152), (2048, 1000, 1152), (1, 1152, 1152)]


def _counts(fn):
    return fn.launches, dict(fn.launches_by_route)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["wgmma", "simt"])
@pytest.mark.parametrize("gamma", [1.0, 0.5])
@pytest.mark.parametrize("shape", WGMMA_BLEND_SHAPES)
def test_linear_blend_route_matches_plain(cuda_device, which, gamma, shape):
    x, w, b, prev = _blend_args(cuda_device, BF16, *shape)
    launches, by_route = _counts(linear_blend)
    got = lb_mod._launch(which, x, w, b, prev, gamma, w.to(BF16))
    torch.cuda.synchronize(cuda_device)
    assert linear_blend.launches == launches + 1
    by_route[which] += 1
    assert linear_blend.launches_by_route == by_route
    want = ref.linear_blend(x, w, b, prev, gamma)
    assert got.dtype == BF16 and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    again = lb_mod._launch(which, x, w, b, prev, gamma, w.to(BF16))
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2048, 1152, 1152), (130, 1152, 1152),
                                   (1000, 1000, 1000)])
@pytest.mark.parametrize("gamma", [1.0, 0.5])
def test_linear_blend_routes_agree_bitwise_at_identity(cuda_device, shape,
                                                       gamma):
    """The served approximators are the identity, exact in bf16: both routes
    give the same bits, so the serve's outputs do not move."""
    m, d, f = shape
    x, _, b, prev = _blend_args(cuda_device, BF16, m, d, f)
    w = torch.eye(d, f, device=cuda_device)
    tc = lb_mod._launch("wgmma", x, w, b, prev, gamma, w.to(BF16))
    simt = lb_mod._launch("simt", x, w, b, prev, gamma, None)
    assert torch.equal(tc, simt)


@pytest.mark.cuda
def test_linear_blend_wrapper_picks_the_route(cuda_device):
    """The served shape goes to wgmma, and without w_bf16 it raises; named
    (``gemm="simt"``, as the runners name it for fitted maps) it takes the
    SIMT route with the f32 W; f32 and ragged bf16 go to SIMT and need no
    copy; a malformed copy raises."""
    x, w, b, prev = _blend_args(cuda_device, BF16, 2048, 1152, 1152)
    _, by_route = _counts(linear_blend)
    linear_blend(x, w, b, prev, gamma=1.0, w_bf16=w.to(BF16))
    by_route["wgmma"] += 1
    with pytest.raises(ValueError, match="w_bf16"):
        linear_blend(x, w, b, prev, gamma=1.0)
    named = linear_blend(x, w, b, prev, gamma=1.0, gemm="simt")
    torch.testing.assert_close(named.float(), ref.linear_blend(
        x, w, b, prev, 1.0).float(), rtol=2e-2, atol=2e-2)
    linear_blend(x.float(), w, b, prev.float(), gamma=1.0)
    linear_blend(*_blend_args(cuda_device, BF16, 130, 257, 129), gamma=1.0)
    by_route["simt"] += 3
    torch.cuda.synchronize(cuda_device)
    assert linear_blend.launches_by_route == by_route
    with pytest.raises(ValueError, match="w_bf16"):
        linear_blend(x, w, b, prev, gamma=1.0, w_bf16=w.to(BF16)[:, :8])
    with pytest.raises(ValueError, match="wgmma route does not take"):
        lb_mod._launch("wgmma", *_blend_args(cuda_device, BF16, 130, 257,
                                             129), 1.0, None)


def _gate_pattern(dev, c, pattern, seed=0):
    """_gate_inputs at (8, c, 1152) with every sample eligible and the
    gated samples chosen: "all", "none" or "one" (sample 3)."""
    (x, prev, po, w, bias, sigma2, _), thr = _gate_inputs(
        dev, BF16, 8, c, 1152, seed)
    diff = (x.double() - prev.double()).square().sum(dim=(1, 2))
    gates = {"all": [True] * 8, "none": [False] * 8,
             "one": [i == 3 for i in range(8)]}[pattern]
    factor = torch.tensor([2.0 if g else 0.5 for g in gates], device=dev,
                          dtype=torch.float64)
    sigma2 = (diff / (c * 1152 * thr) * factor).float()
    eligible = torch.ones(8, dtype=torch.bool, device=dev)
    return (x, prev, po, w, bias, sigma2, eligible), thr, gates


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["wgmma", "simt"])
@pytest.mark.parametrize("pattern", ["all", "none", "one"])
@pytest.mark.parametrize("c", [128, 64])
@pytest.mark.parametrize("use_blend", [True, False])
def test_fused_gate_route_matches_plain(cuda_device, which, pattern, c,
                                        use_blend):
    args, thr, gates = _gate_pattern(cuda_device, c, pattern)
    launches, by_route = _counts(fused_gate)
    got = fg_mod._launch(which, *args, thr, 0.5, use_blend,
                         args[3].to(BF16))
    torch.cuda.synchronize(cuda_device)
    assert fused_gate.launches == launches + 1
    by_route[which] += 1
    assert fused_gate.launches_by_route == by_route
    want = ref.fused_gate(*args, threshold=thr, gamma=0.5,
                          use_blend=use_blend)
    assert got[1].tolist() == gates
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0)
    torch.testing.assert_close(got[3], want[3], rtol=1e-4, atol=0)
    x = args[0]
    for i, g in enumerate(gates):
        if not g:                          # pass-through is exact
            assert torch.equal(got[0][i], x[i])
    again = fg_mod._launch(which, *args, thr, 0.5, use_blend,
                           args[3].to(BF16))
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [128, 64])
@pytest.mark.parametrize("use_blend", [True, False])
def test_fused_gate_routes_agree_bitwise_at_identity(cuda_device, c,
                                                     use_blend):
    (x, prev, po, _, bias, sigma2, eligible), thr, _ = _gate_pattern(
        cuda_device, c, "one")
    w = torch.eye(1152, device=cuda_device)
    args = (x, prev, po, w, bias, sigma2, eligible)
    tc = fg_mod._launch("wgmma", *args, thr, 0.5, use_blend, w.to(BF16))
    simt = fg_mod._launch("simt", *args, thr, 0.5, use_blend, None)
    for a, b in zip(tc, simt):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_fused_gate_wrapper_picks_the_route(cuda_device):
    args, thr = _gate_inputs(cuda_device, BF16, 8, 128, 1152)
    _, by_route = _counts(fused_gate)
    fused_gate(*args, threshold=thr, w_bf16=args[3].to(BF16))
    by_route["wgmma"] += 1
    with pytest.raises(ValueError, match="w_bf16"):
        fused_gate(*args, threshold=thr)
    fused_gate(*args, threshold=thr, gemm="simt")       # named: the f32 W
    small, thr_small = _gate_inputs(cuda_device, BF16, 3, 40, 100)
    fused_gate(*small, threshold=thr_small)
    f32, thr_f32 = _gate_inputs(cuda_device, torch.float32, 8, 128, 1152)
    fused_gate(*f32, threshold=thr_f32)
    by_route["simt"] += 3
    with pytest.raises(ValueError, match="w_bf16"):
        fused_gate(*args, threshold=thr, w_bf16=args[3][:, :8].to(BF16))
    torch.cuda.synchronize(cuda_device)
    assert fused_gate.launches_by_route == by_route


# ---------------------------------------------------------------------------
# saliency_delta and linear_blend at the observability slice's call sites
# ---------------------------------------------------------------------------

# (B, N, D) bf16: the decode gate's rows (batch <= 4 of one 1024-wide
# token), the audit's per-layer stacks at full width ((L+1) x 8 CFG rows
# of DiT-XL/2) and the calibration recorder's (L x 4 rows at batch 2)
OBS_SAL_SHAPES = [(1, 1, 1024), (4, 1, 1024), (232, 256, 1152),
                  (112, 256, 1152)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", OBS_SAL_SHAPES)
def test_saliency_new_call_sites_onepass_bitwise(cuda_device, shape):
    """At each new call site's shape the wrapper takes the onepass route,
    whose outputs are the SIMT route's bits and within rtol 1e-5 of the
    plain version; the tickets of every sample are back at zero after the
    call."""
    x, prev = _sal_pair(cuda_device, BF16, shape, seed=shape[0])
    before = _sal_route_counts()
    got = saliency_delta(x, prev)
    torch.cuda.synchronize(cuda_device)
    assert saliency_delta.launches_by_route == dict(
        before, onepass=before["onepass"] + 1)
    assert sal_mod.tickets(shape[0]) == [0] * shape[0]
    simt = sal_mod._launch("simt", x, prev)
    for g, s in zip(got, simt):
        assert torch.equal(g, s), shape
    for g, w in zip(got, ref.saliency_delta(x, prev)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4])
def test_linear_blend_decode_gate_shape_matches_plain(cuda_device, m):
    """The decode gate's approximation: M = batch <= 4 rows, D = F = 1024,
    bf16, gamma 1, on the route the rule gives (gemv: split K over every
    SM), against the plain version; bitwise at W = I against the SIMT
    route, as the wgmma route is."""
    args = _blend_args(cuda_device, BF16, m, 1024, 1024, seed=m)
    _, by_route = _counts(linear_blend)
    got = linear_blend(*args, gamma=1.0, w_bf16=args[1].to(BF16))
    torch.cuda.synchronize(cuda_device)
    by_route["gemv"] += 1
    assert linear_blend.launches_by_route == by_route
    assert got.shape == (m, 1024) and got.dtype == BF16
    want = ref.linear_blend(*args, 1.0)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    x, _, b, prev = args
    eye = torch.eye(1024, device=cuda_device)
    simt = lb_mod._launch("simt", x, eye, b, prev, 1.0, None)
    for which in ("gemv", "wgmma"):
        tc = lb_mod._launch(which, x, eye, b, prev, 1.0, eye.to(BF16))
        assert torch.equal(tc, simt), which


# ---------------------------------------------------------------------------
# linear_blend's gemv route (M <= route.GEMV_MAX_ROWS: the decode gate)
# ---------------------------------------------------------------------------

# the decode gates' widths (qwen3-0.6b, qwen3-14b, the MoE configs, yi-9b,
# stablelm-3b, qwen2-vl-2b) and a ragged one (a column tile part full, K
# not a multiple of a split)
GEMV_WIDTHS = [1024, 5120, 7168, 4096, 2560, 1536, 1000]


def _gemv_ticket_count(m, d, f):
    from repro_torch.cuda_kernels import route
    plan = route.gemv_plan(m, d, f)
    return plan.tiles * plan.groups


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 3, 4])
@pytest.mark.parametrize("d", GEMV_WIDTHS)
def test_linear_blend_gemv_route_matches_plain(cuda_device, m, d):
    """At every decode width and M = 1 ... 4 the wrapper takes the gemv
    route: within 2e-2 of the plain version (W = I + 0.01 noise rounded to
    bf16: ~1e-3), a repeat bitwise, the tickets back at 0; at W = I bitwise
    the SIMT route's."""
    args = _blend_args(cuda_device, BF16, m, d, d, seed=d + m)
    _, by_route = _counts(linear_blend)
    got = linear_blend(*args, gamma=1.0, w_bf16=args[1].to(BF16))
    torch.cuda.synchronize(cuda_device)
    by_route["gemv"] += 1
    assert linear_blend.launches_by_route == by_route
    want = ref.linear_blend(*args, 1.0)
    assert got.shape == want.shape and got.dtype == BF16
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    again = linear_blend(*args, gamma=1.0, w_bf16=args[1].to(BF16))
    assert torch.equal(got, again)
    assert lb_mod.gemv_tickets(_gemv_ticket_count(m, d, d)) == \
        [0] * _gemv_ticket_count(m, d, d)
    x, _, b, prev = args
    eye = torch.eye(d, device=cuda_device)
    gemv = lb_mod._launch("gemv", x, eye, b, prev, 1.0, eye.to(BF16))
    simt = lb_mod._launch("simt", x, eye, b, prev, 1.0, None)
    assert torch.equal(gemv, simt)


@pytest.mark.cuda
@pytest.mark.parametrize("gamma", [0.5, 0.0])
@pytest.mark.parametrize("m", [1, 4, 8, 17, 64])
def test_linear_blend_gemv_blends_and_takes_row_groups(cuda_device, gamma,
                                                       m):
    """Named, the gemv route takes any M in row groups of 4 (the crossover
    measurement's M up to 64) and blends with prev: within 2e-2 of the
    plain version, a repeat bitwise."""
    args = _blend_args(cuda_device, BF16, m, 1152, 1000, seed=m)
    copy = args[1].to(BF16)
    got = lb_mod._launch("gemv", *args, gamma, copy)
    torch.testing.assert_close(got.float(),
                               ref.linear_blend(*args, gamma).float(),
                               rtol=2e-2, atol=2e-2)
    assert torch.equal(got, lb_mod._launch("gemv", *args, gamma, copy))


@pytest.mark.cuda
def test_linear_blend_gemv_replays_bitwise_in_a_cuda_graph(cuda_device):
    """Captured (the decode gate runs in the gated decode step's graph):
    each replay gives the eager call's bits, also after X is rewritten in
    place, and leaves the tickets at 0."""
    x, w, b, prev = _blend_args(cuda_device, BF16, 4, 1024, 1024)
    copy = w.to(BF16)
    linear_blend(x, w, b, prev, gamma=1.0, w_bf16=copy)
    torch.cuda.synchronize(cuda_device)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        captured = linear_blend(x, w, b, prev, gamma=1.0, w_bf16=copy)
    for scale in (1.0, 0.5, 2.0):
        x.mul_(scale)
        g.replay()
        torch.cuda.synchronize(cuda_device)
        eager = linear_blend(x, w, b, prev, gamma=1.0, w_bf16=copy)
        assert torch.equal(captured, eager), scale
    assert lb_mod.gemv_tickets(4) == [0] * 4


@pytest.mark.cuda
def test_linear_blend_gemv_wrapper_picks_and_refuses(cuda_device):
    """M = GEMV_MAX_ROWS takes gemv, one row more wgmma; a split copy at M
    = 4 stays on wgmma_split; f32 and ragged bf16 go to SIMT; without a
    copy, with a split copy named gemv, or named on a shape the route does
    not take, gemv raises."""
    from repro_torch.cuda_kernels import route
    lim = route.GEMV_MAX_ROWS
    _, by_route = _counts(linear_blend)
    for m, which in ((lim, "gemv"), (lim + 1, "wgmma")):
        x, w, b, prev = _blend_args(cuda_device, BF16, m, 1024, 1024)
        linear_blend(x, w, b, prev, gamma=1.0, w_bf16=w.to(BF16))
        by_route[which] += 1
    x, w, b, prev = _blend_args(cuda_device, BF16, 4, 1024, 1024)
    linear_blend(x, w, b, prev, gamma=1.0, w_bf16=_split(w))
    by_route["wgmma_split"] += 1
    linear_blend(x.float(), w, b, prev.float(), gamma=1.0)
    ragged = _blend_args(cuda_device, BF16, 4, 257, 129)
    linear_blend(*ragged, gamma=1.0, w_bf16=ragged[1].to(BF16))
    by_route["simt"] += 2
    torch.cuda.synchronize(cuda_device)
    assert linear_blend.launches_by_route == by_route
    with pytest.raises(ValueError, match="w_bf16"):
        linear_blend(x, w, b, prev, gamma=1.0)
    with pytest.raises(ValueError, match="w_bf16"):
        linear_blend(x, w, b, prev, gamma=1.0, w_bf16=_split(w),
                     gemm="gemv")
    with pytest.raises(ValueError, match="gemv route does not take"):
        lb_mod._launch("gemv", *ragged, 1.0, ragged[1].to(BF16))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fused_gate", "linear_blend"])
def test_simt_route_bf16_x_far_from_identity(cuda_device, kernel):
    """Named SIMT with bf16 X at the served shape and a W far from the
    identity (entries of a fitted map's size: ||W - I|| / ||I|| ~ 10), as
    the runners serve fitted maps: within 2e-2 rel-L2 of the plain
    version, gate bits exact."""
    gen = torch.Generator(cuda_device).manual_seed(7)
    d = 1152
    w = torch.eye(d, device=cuda_device) + 10.0 * torch.randn(
        (d, d), generator=gen, device=cuda_device)
    if kernel == "fused_gate":
        args, thr = _gate_inputs(cuda_device, BF16, 8, 128, d)
        args = args[:3] + (w,) + args[4:]
        got = fused_gate(*args, threshold=thr, gemm="simt")
        want = ref.fused_gate(*args, threshold=thr)
        assert torch.equal(got[1], want[1]) and bool(got[1].any())
        got, want = got[0], want[0]
    else:
        x, _, b, prev = _blend_args(cuda_device, BF16, 2048, d, d)
        got = linear_blend(x, w, b, prev, gamma=1.0, gemm="simt")
        want = ref.linear_blend(x, w, b, prev, 1.0)
    torch.cuda.synchronize(cuda_device)
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    assert rel <= 2e-2, rel


# ---------------------------------------------------------------------------
# the wgmma_split route of linear_blend and fused_gate (fitted maps)
# ---------------------------------------------------------------------------

SPLIT_REL_L2 = 1e-3        # the split route against the plain version
# fused_gate (B, C, D): the served slice merge off and on, and D % 64 != 0
SPLIT_GATE_SHAPES = [(8, 128, 1152), (8, 64, 1152), (8, 128, 1000)]
# linear_blend (M, D, F): the bypass, D % 64 != 0 (the padding), the
# decode gate's M = 4, ragged rows and columns
SPLIT_BLEND_SHAPES = [(2048, 1152, 1152), (2048, 1000, 1152),
                      (4, 1024, 1024), (130, 1000, 1000)]


def _split(w):
    from repro_torch.core.linear_approx import split_copies
    return split_copies(w, BF16, w.device)[0]


def _cancelling_w(dev, d, f, seed=0):
    """A fitted map's cancellation: 600 (I - 1 1^T / D) plus noise, whose
    columns sum to about 0, met by inputs with a large common part
    (``_cancelling_x``): X W is far smaller than |X| |W|, and one bf16 copy
    of W misses it by more than 2e-2 rel-L2."""
    gen = torch.Generator(dev).manual_seed(seed)
    return (600.0 * (torch.eye(d, f, device=dev) - 1.0 / d)
            + torch.randn((d, f), generator=gen, device=dev))


def _cancelling_x(dev, shape, seed=1):
    gen = torch.Generator(dev).manual_seed(seed)
    return (3.0 + 0.05 * torch.randn(shape, generator=gen,
                                     device=dev)).to(BF16)


def _rel_l2(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def _split_gate_args(dev, shape, w_kind):
    """``_gate_pattern``'s inputs at ``shape`` (every sample eligible,
    samples 0, 2, 4, 6 gating) with W near the identity ("near") or
    cancelling ("cancel", X moved onto a large common part)."""
    b, c, d = shape
    (x, prev, po, w, bias, _, eligible), thr = _gate_inputs(dev, BF16, b, c,
                                                            d)
    if w_kind == "cancel":
        x = _cancelling_x(dev, (b, c, d))
        prev = (x.float() + 0.01 * torch.randn_like(x.float())).to(BF16)
        w = _cancelling_w(dev, d, d)
    diff = (x.double() - prev.double()).square().sum(dim=(1, 2))
    factor = torch.tensor([2.0, 0.5] * (b // 2), device=dev,
                          dtype=torch.float64)
    sigma2 = (diff / (c * d * thr) * factor).float()
    eligible = torch.ones(b, dtype=torch.bool, device=dev)
    return (x, prev, po, w, bias, sigma2, eligible), thr


@pytest.mark.cuda
@pytest.mark.parametrize("w_kind", ["near", "cancel"])
@pytest.mark.parametrize("use_blend", [True, False])
@pytest.mark.parametrize("shape", SPLIT_GATE_SHAPES)
def test_fused_gate_split_route_matches_plain(cuda_device, shape, use_blend,
                                              w_kind):
    """The split route against the plain version in f32: gate bits,
    diff_sq and prev_sq exactly the SIMT route's (gate_partials is shared),
    gate bits the plain version's, outputs within 2e-2 elementwise and
    1e-3 rel-L2, pass-through exact, bitwise repeatable."""
    args, thr = _split_gate_args(cuda_device, shape, w_kind)
    copy = _split(args[3])
    launches, by_route = _counts(fused_gate)
    got = fused_gate(*args, threshold=thr, gamma=0.5, use_blend=use_blend,
                     w_bf16=copy)
    torch.cuda.synchronize(cuda_device)
    by_route["wgmma_split"] += 1
    assert fused_gate.launches == launches + 1
    assert fused_gate.launches_by_route == by_route
    simt = fg_mod._launch("simt", *args, thr, 0.5, use_blend, None)
    want = ref.fused_gate(*args, threshold=thr, gamma=0.5,
                          use_blend=use_blend)
    for g, s in zip(got[1:], simt[1:]):
        assert torch.equal(g, s)
    assert torch.equal(got[1], want[1])
    assert got[1].tolist() == [i % 2 == 0 for i in range(shape[0])]
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0)
    torch.testing.assert_close(got[3], want[3], rtol=1e-4, atol=0)
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=2e-2,
                               atol=2e-2)
    assert _rel_l2(got[0], want[0]) <= SPLIT_REL_L2
    for i, g in enumerate(got[1].tolist()):
        if not g:
            assert torch.equal(got[0][i], args[0][i])
    again = fused_gate(*args, threshold=thr, gamma=0.5, use_blend=use_blend,
                       w_bf16=copy)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("w_kind", ["near", "cancel"])
@pytest.mark.parametrize("gamma", [1.0, 0.5])
@pytest.mark.parametrize("shape", SPLIT_BLEND_SHAPES)
def test_linear_blend_split_route_matches_plain(cuda_device, shape, gamma,
                                                w_kind):
    """The split route against the plain version in f32: within 2e-2
    elementwise and 1e-3 rel-L2, bitwise repeatable; D = 1000 reads the
    padded terms (without the padding, a term's first rows would land in
    the last chunk of the term before it)."""
    m, d, f = shape
    x, w, b, prev = _blend_args(cuda_device, BF16, m, d, f)
    if w_kind == "cancel":
        x, w = _cancelling_x(cuda_device, (m, d)), _cancelling_w(
            cuda_device, d, f)
    copy = _split(w)
    launches, by_route = _counts(linear_blend)
    got = linear_blend(x, w, b, prev, gamma=gamma, w_bf16=copy)
    torch.cuda.synchronize(cuda_device)
    by_route["wgmma_split"] += 1
    assert linear_blend.launches == launches + 1
    assert linear_blend.launches_by_route == by_route
    want = ref.linear_blend(x, w, b, prev, gamma)
    assert got.dtype == BF16 and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    assert _rel_l2(got, want) <= SPLIT_REL_L2
    assert torch.equal(got, linear_blend(x, w, b, prev, gamma=gamma,
                                         w_bf16=copy))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fused_gate", "linear_blend"])
def test_split_route_holds_a_map_one_bf16_copy_misses(cuda_device, kernel):
    """At the cancelling W, the wgmma route with one bf16 copy misses the
    plain version by more than 2e-2 rel-L2 and the split route stays
    within 1e-3."""
    d = 1152
    if kernel == "fused_gate":
        args, thr = _split_gate_args(cuda_device, (8, 128, d), "cancel")
        w = args[3]
        want = ref.fused_gate(*args, threshold=thr)[0]
        single = fg_mod._launch("wgmma", *args, thr, 0.5, True,
                                w.to(BF16))[0]
        split = fg_mod._launch("wgmma_split", *args, thr, 0.5, True,
                               _split(w))[0]
    else:
        x = _cancelling_x(cuda_device, (2048, d))
        w = _cancelling_w(cuda_device, d, d)
        _, _, b, prev = _blend_args(cuda_device, BF16, 2048, d, d)
        want = ref.linear_blend(x, w, b, prev, 1.0)
        single = lb_mod._launch("wgmma", x, w, b, prev, 1.0, w.to(BF16))
        split = lb_mod._launch("wgmma_split", x, w, b, prev, 1.0, _split(w))
    torch.cuda.synchronize(cuda_device)
    assert _rel_l2(single, want) > 2e-2
    assert _rel_l2(split, want) <= SPLIT_REL_L2


def _planted(dev, d, f, seed=7):
    """A split copy of a (D, F) map whose terms are independent N(0, 1)
    bf16 matrices, each followed by its zero padding rows: (copy, the f32
    sum of the terms, the sum without the last term).  Against their sum, a
    kernel that drops a term, or reads one a row off, misses by that
    term's whole share of the product (about 0.58 rel-L2)."""
    from repro_torch.cuda_kernels import route
    kp = route.split_rows(d)
    gen = torch.Generator(dev).manual_seed(seed)
    copy = torch.zeros((route.SPLIT_TERMS * kp, f), dtype=BF16, device=dev)
    for t in range(route.SPLIT_TERMS):
        copy[t * kp:t * kp + d] = torch.randn((d, f), generator=gen,
                                              device=dev)
    terms = copy.float().reshape(route.SPLIT_TERMS, kp, f)[:, :d]
    return copy, terms.sum(0), terms[:-1].sum(0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SPLIT_BLEND_SHAPES)
def test_linear_blend_split_route_reads_every_planted_term(cuda_device,
                                                           shape):
    """On a copy of three independent terms the kernel is within 2e-2
    elementwise and 1e-3 rel-L2 of the plain version on their sum, which
    the plain version without the last term misses by more than 0.1: a
    kernel that dropped or misplaced a term (D = 1000: the padding) would
    fail, where the fitted maps' tiny last term would not show it."""
    m, d, f = shape
    x, _, b, prev = _blend_args(cuda_device, BF16, m, d, f)
    copy, w, two = _planted(cuda_device, d, f)
    got = linear_blend(x, w, b, prev, gamma=1.0, w_bf16=copy)
    torch.cuda.synchronize(cuda_device)
    want = ref.linear_blend(x, w, b, prev, 1.0)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    assert _rel_l2(got, want) <= SPLIT_REL_L2
    assert _rel_l2(ref.linear_blend(x, two, b, prev, 1.0), want) > 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("use_blend", [True, False])
@pytest.mark.parametrize("shape", SPLIT_GATE_SHAPES)
def test_fused_gate_split_route_reads_every_planted_term(cuda_device, shape,
                                                         use_blend):
    """As for linear_blend: gate bits the plain version's, outputs within
    2e-2 and 1e-3 rel-L2 of it on the terms' sum, which the plain version
    without the last term misses by more than 0.1."""
    args, thr = _split_gate_args(cuda_device, shape, "near")
    copy, w, two = _planted(cuda_device, shape[2], shape[2])
    args = args[:3] + (w,) + args[4:]
    kw = dict(threshold=thr, gamma=0.5, use_blend=use_blend)
    got = fused_gate(*args, **kw, w_bf16=copy)
    torch.cuda.synchronize(cuda_device)
    want = ref.fused_gate(*args, **kw)
    assert torch.equal(got[1], want[1]) and bool(want[1].any())
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=2e-2,
                               atol=2e-2)
    assert _rel_l2(got[0], want[0]) <= SPLIT_REL_L2
    dropped = ref.fused_gate(*args[:3], two, *args[4:], **kw)[0]
    assert _rel_l2(dropped, want[0]) > 0.1


@pytest.mark.cuda
def test_split_route_replays_bitwise_in_a_cuda_graph(cuda_device):
    """Both kernels captured with their split copies: every replay gives
    the eager calls' bits, also after the inputs are rewritten in place."""
    args, thr = _split_gate_args(cuda_device, (8, 128, 1152), "cancel")
    gate_copy = _split(args[3])
    x, w, b, prev = _blend_args(cuda_device, BF16, 2048, 1152, 1152)
    w = _cancelling_w(cuda_device, 1152, 1152)
    blend_copy = _split(w)

    def run():
        return (fused_gate(*args, threshold=thr, w_bf16=gate_copy),
                linear_blend(x, w, b, prev, gamma=1.0, w_bf16=blend_copy))

    run()                                    # built and opted in eagerly
    torch.cuda.synchronize(cuda_device)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        captured = run()
    for scale in (1.0, 0.5, 1.0):
        args[0].mul_(scale)
        x.mul_(scale)
        g.replay()
        torch.cuda.synchronize(cuda_device)
        eager = run()
        for a, e in zip(captured[0] + (captured[1],), eager[0] + (eager[1],)):
            assert torch.equal(a, e), scale


@pytest.mark.cuda
def test_split_wrappers_pick_the_route(cuda_device):
    """A call that brings a split copy takes wgmma_split where the wgmma
    rule holds and SIMT elsewhere (f32, ragged bf16); the split route named
    on a shape it does not take, without its copy or with a malformed one,
    raises."""
    args, thr = _gate_inputs(cuda_device, BF16, 8, 128, 1152)
    copy = _split(args[3])
    x, w, b, prev = _blend_args(cuda_device, BF16, 2048, 1152, 1152)
    gate_before, blend_before = (dict(fused_gate.launches_by_route),
                                 dict(linear_blend.launches_by_route))
    fused_gate(*args, threshold=thr, w_bf16=copy)
    linear_blend(x, w, b, prev, gamma=1.0, w_bf16=_split(w))
    f32, thr_f32 = _gate_inputs(cuda_device, torch.float32, 8, 128, 1152)
    fused_gate(*f32, threshold=thr_f32, w_bf16=copy)
    small, thr_small = _gate_inputs(cuda_device, BF16, 3, 40, 100)
    fused_gate(*small, threshold=thr_small, w_bf16=_split(small[3]))
    ragged = _blend_args(cuda_device, BF16, 130, 257, 129)
    linear_blend(*ragged, gamma=1.0, w_bf16=_split(ragged[1]))
    torch.cuda.synchronize(cuda_device)
    assert fused_gate.launches_by_route == dict(
        gate_before, wgmma_split=gate_before["wgmma_split"] + 1,
        simt=gate_before["simt"] + 2)
    assert linear_blend.launches_by_route == dict(
        blend_before, wgmma_split=blend_before["wgmma_split"] + 1,
        simt=blend_before["simt"] + 1)
    with pytest.raises(ValueError, match="wgmma_split route does not take"):
        fg_mod._launch("wgmma_split", *small, thr_small, 0.5, True,
                       _split(small[3]))
    with pytest.raises(ValueError, match="wgmma_split route does not take"):
        lb_mod._launch("wgmma_split", *ragged, 1.0, _split(ragged[1]))
    with pytest.raises(ValueError, match="needs w_bf16"):
        fused_gate(*args, threshold=thr, gemm="wgmma_split")
    with pytest.raises(ValueError, match="split w_bf16"):
        linear_blend(x, w, b, prev, gamma=1.0, w_bf16=w.to(BF16),
                     gemm="wgmma_split")
    with pytest.raises(ValueError, match="split w_bf16"):
        fused_gate(*args, threshold=thr, w_bf16=copy[:, :8].contiguous())
    with pytest.raises(ValueError, match="w_bf16 must be"):
        fused_gate(*args, threshold=thr, gemm="wgmma", w_bf16=copy)


# ---------------------------------------------------------------------------
# preempt / resume (the SLO plane's device-side snapshot)
# ---------------------------------------------------------------------------

def _preempt_resume(eng, preempt):
    """Admit a and b, run 3 steps; with ``preempt``, park b, let 2 steps
    pass, admit c into b's slot, step once and resume b in another slot
    (``preempt`` and the resuming ``add_request`` under sync debug
    "error"); without, the same requests served straight through."""
    from repro_torch.serving.scheduler import DiffusionRequest

    a, b, c = (DiffusionRequest(rid=i, label=i + 1, seed=10 + i,
                                num_steps=6, guidance_scale=4.0)
               for i in range(3))
    assert eng.add_request(a) and eng.add_request(b)
    done = []
    for _ in range(3):
        done += eng.step()
    if preempt:
        donor = eng.slots.index(b)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.preempt(donor)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for _ in range(2):
        done += eng.step()
    assert eng.add_request(c)
    done += eng.step()
    if preempt:
        assert eng.slots.index(c) == donor
        torch.cuda.set_sync_debug_mode("error")
        try:
            assert eng.add_request(b)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert eng.slots.index(b) != donor
    while len(done) < 3:
        done += eng.step()
    return sorted(done, key=lambda r: r.rid)


@pytest.mark.cuda
@pytest.mark.parametrize("merge_ratio", [1.0, 0.5])
def test_preempt_resume_is_sync_free_and_bitwise(cuda_device, merge_ratio):
    """At the smoke size in bf16 on the kernels: preempt and resume make
    no host sync, and every request's latents and counters, the resumed
    one's included, equal an un-preempted serve's bitwise."""
    from repro_torch.launch.serve_diffusion import Workload

    wl = Workload(reduced=True, slots=3, steps=6, merge_ratio=merge_ratio,
                  merge_window=8)
    model = wl.build_model(cuda_device)
    _, plain = wl.build_engine(model)
    want = _preempt_resume(plain, False)
    _, eng = wl.build_engine(model)
    got = _preempt_resume(eng, True)
    assert got[1].preemptions == 1 and got[1].steps_done == 3
    for r, w in zip(got, want):
        assert torch.equal(torch.from_numpy(r.latents),
                           torch.from_numpy(w.latents)), r.rid
        control = ("queue_wait_steps", "preemptions")
        assert {k: v for k, v in r.cache.items() if k not in control} == \
            {k: v for k, v in w.cache.items() if k not in control}, r.rid
        assert (r.cache["queue_wait_steps"], r.cache["preemptions"]) == \
            (float(r.queue_wait_steps), float(r.preemptions)), r.rid


# ---------------------------------------------------------------------------
# training on the card
# ---------------------------------------------------------------------------

def _train_pair(arch, dev):
    """The reduced f32 model of ``arch`` on the CPU and a copy on ``dev``,
    from the launcher's initializers (the DiT adaLN-zero), and a seeded
    batch for each."""
    import numpy as np
    from repro_torch.configs import get_reduced
    from repro_torch.launch.train import init_model
    from repro_torch.models.registry import build_model

    cfg = get_reduced(arch).replace(dtype="float32")
    cpu = init_model(cfg, "cpu", 0)
    card = build_model(cfg, device=dev)
    with torch.no_grad():
        for p, q in zip(card.parameters(), cpu.parameters()):
            p.copy_(q)
    rng = np.random.default_rng(0)
    if cfg.family == "dit":
        img, ch = cfg.dit.image_size, cfg.dit.in_channels
        batch = {"latents": rng.standard_normal((4, img, img, ch)),
                 "t": rng.integers(0, 1000, 4),
                 "labels": rng.integers(0, cfg.dit.num_classes, 4),
                 "noise": rng.standard_normal((4, img, img, ch))}
        batch = {k: torch.from_numpy(v.astype(np.float32 if v.dtype.kind
                                                == "f" else np.int32))
                 for k, v in batch.items()}
    elif cfg.family == "audio":
        batch = {"features": torch.from_numpy(rng.standard_normal(
                     (3, 24, cfg.frontend_dim)).astype(np.float32)),
                 "targets": torch.from_numpy(rng.integers(
                     0, cfg.vocab_size, (3, 24)).astype(np.int32)),
                 "mask_indices": torch.from_numpy(rng.random((3, 24))
                                                  < 0.3)}
    else:
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (3, 24)).astype(np.int32))}
    return cpu, card, batch


def _trainer(model):
    from repro_torch.training import loop, optimizer
    params = loop.param_tree(model)
    opt = optimizer.AdamW()
    step = loop.make_train_step(model, opt,
                                optimizer.cosine_schedule(1e-3, 2, 10))
    return params, opt.init(params), step


@pytest.mark.parametrize("arch", ["dit-xl2", "qwen3-0.6b"])
def test_train_step_on_the_card_matches_the_cpu(cuda_device, arch):
    """One train step of the reduced f32 model on the card against the
    same step on the CPU: loss, gradient norm and every gradient within
    rtol 1e-4 (the card's embedding backward sums in another order).
    AdamW's first move is g / (|g| + eps) per element, so an element with
    a gradient near eps takes a different step from gradients 1e-9 apart:
    the card's parameters are held, at rtol 1e-4, to AdamW replayed on the
    CPU from the same start with the card's gradients."""
    from repro_torch import tree
    from repro_torch.training import optimizer
    cpu, card, batch = _train_pair(arch, cuda_device)
    results = []
    for model, dev in ((cpu, "cpu"), (card, cuda_device)):
        params, state, step = _trainer(model)
        start = tree.map(lambda t: t.detach().cpu().clone(), params)
        params, state, met = step(params, state,
                                  {k: v.to(dev) for k, v in batch.items()})
        results.append((start, params, step.grads, met))
    (_, pc, gc, mc), (start, pg, gg, mg) = results
    for k in ("loss", "grad_norm"):
        torch.testing.assert_close(mg[k].cpu(), mc[k], rtol=1e-4, atol=1e-6)
    for a, b in zip(tree.leaves(gg), tree.leaves(gc)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-6)
    opt = optimizer.AdamW()
    replay, _ = opt.update(tree.map(lambda t: t.cpu(), gg), opt.init(start),
                           start, float(mg["lr"]))
    for a, b in zip(tree.leaves(pg), tree.leaves(replay)):
        torch.testing.assert_close(a.detach().cpu(), b, rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("arch", ["dit-xl2", "qwen3-0.6b", "qwen2-vl-2b",
                                  "hubert-xlarge"])
def test_train_steps_sync_free_without_flash_attention(cuda_device, arch):
    """Training on the card: a step after warm-up makes no host sync (sync
    debug "error"), flash_attention (no autograd) is never launched, and
    every parameter has a nonzero gradient by the third step."""
    _, card, batch = _train_pair(arch, cuda_device)
    batch = {k: v.to(cuda_device) for k, v in batch.items()}
    params, state, step = _trainer(card)
    before = flash_attention.launches
    params, state, _ = step(params, state, batch)
    params, state, _ = step(params, state, batch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        params, state, met = step(params, state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert flash_attention.launches == before
    assert torch.isfinite(met["loss"]).item()
    zero = [n for n, p in card.named_parameters()
            if not bool(p.grad.abs().amax() > 0)]
    assert not zero, zero


# ---------------------------------------------------------------------------
# The hybrid (Jamba) and SSM (xLSTM) families
# ---------------------------------------------------------------------------

SSM_ARCHS = ("jamba-v0.1-52b", "xlstm-1.3b")


@pytest.mark.cuda
def test_flash_attention_at_jambas_prefill_shape(cuda_device):
    """Jamba's prefill (32 heads of 128 on 8 KV heads, S 512, causal,
    window 1024) in bf16: one launch, within 2e-2 of the plain version."""
    q, k, v = _qkv(cuda_device, BF16, 1, 32, 8, 512, 512, 128)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True, window=1024)
    torch.cuda.synchronize(cuda_device)
    assert flash_attention.launches == before + 1
    want = ref.flash_attention(q, k, v, causal=True, window=1024)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def _ssm_model(dev, arch):
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import TransformerModel
    model = TransformerModel(get_reduced(arch), device=dev)
    return model.init(torch.Generator(dev).manual_seed(0))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_exact_decode_makes_one_sync_a_step(cuda_device, arch):
    """The reduced hybrid / SSM model (bf16) prefills and decodes with no
    host sync (sync debug "error"), and the exact engine makes one sync a
    decode step and one an admission."""
    from repro_torch.serving.engine import Request, ServingEngine
    model = _ssm_model(cuda_device, arch)
    gen = torch.Generator(cuda_device).manual_seed(1)
    tokens = torch.randint(0, model.cfg.vocab_size, (2, 40), generator=gen,
                           device=cuda_device)
    _, warm = model.prefill({"tokens": tokens[:, :8]}, 16)     # first calls of each op
    model.decode_step(tokens[:, 8], warm)
    torch.cuda.synchronize(cuda_device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, cache = model.prefill({"tokens": tokens}, 16)
        for i in range(3):
            model.decode_step(tokens[:, i], cache)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert cache["step"].tolist() == [43, 43]
    eng = ServingEngine(model, max_batch=2, window=16)
    reqs = [Request(rid=i, prompt=tokens[i % 2, i:i + 12].cpu().numpy(),
                    max_new_tokens=5) for i in range(3)]
    done = eng.run(reqs)
    assert len(done) == 3 and all(len(r.generated) == 5 for r in done)
    assert eng.host_syncs == eng.prefills + eng.decode_steps


@pytest.mark.cuda
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_engine_splices_every_leaf_in_place(cuda_device, arch):
    """An admission on the card writes the prefill's state into its slot of
    every cache leaf in place (the leaves keep their storage), bitwise the
    standalone prefill's, and leaves the other slots' rows alone; a decode
    step updates every leaf in place."""
    import numpy as np
    from repro_torch.serving.engine import ServingEngine
    model = _ssm_model(cuda_device, arch)
    eng = ServingEngine(model, max_batch=3, window=16)
    ptrs = {k: t.data_ptr() for k, t in eng.cache.items()}
    before = {k: t.clone() for k, t in eng.cache.items()}
    prompt = np.arange(12, dtype=np.int32) * 7 % model.cfg.vocab_size
    eng._prefill(prompt, 1)
    _, one = model.prefill({"tokens": torch.as_tensor(
        prompt, device=cuda_device).long()[None]}, 16)
    for key, leaf in eng.cache.items():
        if key == "step":
            continue
        assert torch.equal(leaf[:, 1], one[key][:, 0]), key
        assert torch.equal(leaf[:, 0], before[key][:, 0]), key
        assert torch.equal(leaf[:, 2], before[key][:, 2]), key
    eng.step()
    assert {k: t.data_ptr() for k, t in eng.cache.items()} == ptrs
    assert eng.cache["step"].tolist() == [1, 13, 1]


# ---------------------------------------------------------------------------
# The VLM (Qwen2-VL-2B) and audio (HuBERT-XLarge) families
# ---------------------------------------------------------------------------

# (H, KVH, S, dh, causal, window): HuBERT-XLarge's attention (16 heads of
# 80, MHA, bidirectional) at its 500 frames (the last query and key tiles
# hold 52 of their 64 rows) and at 512, and Qwen2-VL-2B's prefill (12
# heads of 128 on 2 KV heads, GQA 6:1)
VLM_AUDIO_FLASH = [(16, 16, 500, 80, False, 0), (16, 16, 512, 80, False, 0),
                   (12, 2, 512, 128, True, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", VLM_AUDIO_FLASH)
def test_flash_attention_at_hubert_and_qwen2_vl_shapes(cuda_device, dtype,
                                                       shape):
    """Batch 4 (HuBERT's encode) and 1, one launch each, within the
    tolerances of test_flash_attention_kernel_matches_plain."""
    h, kvh, s, dh, causal, window = shape
    for b in (4, 1):
        q, k, v = _qkv(cuda_device, dtype, b, h, kvh, s, s, dh, seed=b)
        before = flash_attention.launches
        got = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize(cuda_device)
        assert flash_attention.launches == before + 1
        want = ref.flash_attention(q, k, v, causal=causal, window=window)
        tol = FLASH_TOL[dtype]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.cuda
def test_vlm_and_audio_make_no_host_sync(cuda_device):
    """The reduced Qwen2-VL's prefill with vision embeddings and its decode
    steps, and the reduced HuBERT's encode, queue device work only (sync
    debug "error"; the 3-axis prefill's sync-free run, in the reference's
    layout, is ``test_vlm_image_prompt_prefill_makes_no_host_sync``);
    the encode launches flash_attention once a layer, bidirectionally:
    moving the last frames moves the first ones' hidden states."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.transformer import TransformerModel

    gen = torch.Generator(cuda_device).manual_seed(1)
    vlm = TransformerModel(get_reduced("qwen2-vl-2b"), device=cuda_device)
    vlm.init(torch.Generator(cuda_device).manual_seed(0))
    s = 32
    t = torch.arange(s, device=cuda_device)
    hw = t.clone()
    hw[1:17] = 1 + torch.arange(16, device=cuda_device) // 4
    mask = torch.zeros((2, s), dtype=torch.bool, device=cuda_device)
    mask[:, 1:17] = True
    batch = {"tokens": torch.randint(0, 512, (2, s), generator=gen,
                                     device=cuda_device),
             "vision_embeds": torch.randn((2, 16, 256), generator=gen,
                                          device=cuda_device).to(BF16),
             "vision_mask": mask}
    grid = dict(batch, positions=torch.stack([t, hw, hw], -1)[None].expand(
        2, s, 3))
    enc = TransformerModel(get_reduced("hubert-xlarge"), device=cuda_device)
    enc.init(torch.Generator(cuda_device).manual_seed(0))
    feats = torch.randn((2, 40, 64), generator=gen, device=cuda_device)
    _, warm = vlm.prefill(batch, 48)                # first calls of each op
    vlm.decode_step(batch["tokens"][:, 0], warm)
    enc.apply({"features": feats})
    torch.cuda.synchronize(cuda_device)
    before = flash_attention.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        text_logits, cache = vlm.prefill(batch, 48)
        for i in range(3):
            vlm.decode_step(batch["tokens"][:, i], cache)
        h1 = enc.apply({"features": feats})
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert flash_attention.launches == before + 2 + 2
    assert cache["step"].tolist() == [s + 3, s + 3]
    logits, grid_cache = vlm.prefill(grid, 48)
    assert flash_attention.launches == before + 6
    assert torch.isfinite(logits.float()).all()
    assert not torch.equal(logits, text_logits)     # the grid's angles
    assert torch.equal(grid_cache["pos"][..., :s],
                       torch.arange(s, device=cuda_device).int().expand(
                           2, 2, s))
    moved = feats.clone()
    moved[:, 30:] += 1.0
    h2 = enc.apply({"features": moved})
    assert not torch.allclose(h1[:, :10].float(), h2[:, :10].float(),
                              atol=1e-3)


# ---------------------------------------------------------------------------
# step graphs: the warm DiT step and the gated decode step, IF nodes for
# the skipped blocks (core/step_graph.py, csrc/cond_node.cu)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("mask", [[True] * 8, [True] * 7 + [False],
                                  [False] * 8, [True], [False] * 300])
@pytest.mark.parametrize("when_all", [True, False])
def test_cond_node_condition_matches_plain(cuda_device, mask, when_all):
    """A graph of one IF node whose body writes a flag: the body runs at a
    replay exactly when the plain condition holds, for the mask the graph
    reads at that replay."""
    from repro_torch.cuda_kernels import cond_node
    cond_node.prepare(cuda_device)
    m = torch.tensor(mask, device=cuda_device)
    flag = torch.zeros((), device=cuda_device)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        cond_node.if_all(m, lambda: flag.add_(1.0), when_all=when_all)
    for flip in (False, True, False):
        if flip:
            m.logical_not_()
        flag.zero_()
        g.replay()
        torch.cuda.synchronize()
        want = ref.if_all(m, when_all).float()
        assert float(flag) == float(want), (mask, when_all, flip)
    with pytest.raises(RuntimeError, match="capture"):
        cond_node.if_all(m, lambda: None, when_all=when_all)


@pytest.mark.cuda
@pytest.mark.parametrize("mask", [[True] * 8, [True] * 7 + [False],
                                  [False] * 8, [False] * 300])
def test_cond_node_two_sides_one_kernel(cuda_device, mask):
    """A two-sided branch (the decode gate's): one condition kernel sets
    both IF nodes' conditions; at each replay exactly the side the plain
    condition picks runs, for the mask the graph reads then.  Counted: 1
    condition kernel, 2 IF nodes."""
    from repro_torch.cuda_kernels import cond_node
    cond_node.prepare(cuda_device)
    m = torch.tensor(mask, device=cuda_device)
    flags = torch.zeros(2, device=cuda_device)
    launches, nodes = cond_node.if_all.launches, cond_node.if_all.nodes
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        cond_node.if_all_sides(m, [(lambda: flags[0].add_(1.0), True),
                                   (lambda: flags[1].add_(1.0), False)])
    assert cond_node.if_all.launches == launches + 1
    assert cond_node.if_all.nodes == nodes + 2
    for flip in (False, True, False):
        if flip:
            m.logical_not_()
        flags.zero_()
        g.replay()
        torch.cuda.synchronize()
        every = bool(ref.if_all(m, True))
        assert flags.tolist() == [float(every), float(not every)], flip


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["wgmma", "wgmma_split", "simt"])
@pytest.mark.parametrize("pattern", ["all", "one", "none"])
def test_fused_gate_sets_the_skip_condition(cuda_device, which, pattern):
    """A graph of B1 then an IF node on the handle B1 sets: at each replay
    the body runs exactly when the plain !all(gate) says, for all, one and
    no samples gating, on every route, and B1's gate bits are the eager
    call's.  The node costs no condition kernel."""
    from repro_torch.cuda_kernels import cond_node
    cond_node.prepare(cuda_device)
    args, thr, gates = _gate_pattern(cuda_device, 128, pattern)
    copy = {"wgmma": args[3].to(BF16), "wgmma_split": _split(args[3]),
            "simt": None}[which]
    eager = fg_mod._launch(which, *args, thr, 0.5, True, copy)
    torch.cuda.synchronize(cuda_device)
    flag = torch.zeros((), device=cuda_device)
    launches, nodes = cond_node.if_all.launches, cond_node.if_all.nodes
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        handle = cond_node.condition(cuda_device)
        got = fg_mod._launch(which, *args, thr, 0.5, True, copy, handle)
        cond_node.if_set(handle, lambda: flag.add_(1.0), cuda_device)
    assert cond_node.if_all.launches == launches
    assert cond_node.if_all.nodes == nodes + 1
    for _ in range(2):
        flag.zero_()
        g.replay()
        torch.cuda.synchronize(cuda_device)
        assert got[1].tolist() == gates
        assert torch.equal(got[1], eager[1]) and torch.equal(got[0], eager[0])
        assert float(flag) == float(not all(gates)), (which, pattern)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fastcache", "decode"])
def test_step_graph_counts_condition_kernels_apart(cuda_device, kind):
    """Each replay adds what its capture recorded: a warm fastcache step L
    IF nodes and no condition kernel (B1 sets them), a gated decode step
    2L IF nodes and L condition kernels (one a two-sided branch)."""
    from repro_torch.cuda_kernels.cond_node import if_all
    if kind == "fastcache":
        from repro_torch.launch.serve_diffusion import Workload
        wl = Workload(reduced=True, slots=3, steps=10)
        model = wl.build_model(cuda_device)
        before = (if_all.launches, if_all.nodes)
        runner, eng = wl.build_engine(model)
        eng.run(wl.build_trace(model))
        replays, layers = runner.graphs.replays, runner.L
        want = (0, layers * replays)
    else:
        from repro_torch.launch.serve import LLMWorkload
        wl = LLMWorkload(reduced=True, requests=3, prompt_len=24,
                         new_tokens=10, max_batch=2, window=64,
                         fastcache=True)
        model = wl.build_model(cuda_device)
        before = (if_all.launches, if_all.nodes)
        eng = wl.build_engine(model)
        eng.run(wl.build_requests(model))
        replays, layers = eng.graphs.replays, model.cfg.num_layers
        want = (layers * replays, 2 * layers * replays)
    assert replays > 0
    assert (if_all.launches - before[0], if_all.nodes - before[1]) == want


def _dit_graph_serve(wl, model, step_graph, sync_steps=()):
    """Two 10-step requests admitted at once, then a third after step 2:
    cold, mixed and warm steps.  Engine steps in ``sync_steps`` run under
    sync debug "error" (warm steps after the capture).  Returns the
    finished requests, the engine's per-row stats and the runner."""
    from repro_torch.serving.scheduler import DiffusionRequest
    runner, eng = dataclasses.replace(wl, step_graph=step_graph
                                      ).build_engine(model)
    reqs = [DiffusionRequest(rid=i, label=i + 1, seed=30 + i, num_steps=10,
                             guidance_scale=4.0) for i in range(3)]
    assert eng.add_request(reqs[0]) and eng.add_request(reqs[1])
    done, step = [], 0
    while len(done) < 3:
        if step == 2:
            assert eng.add_request(reqs[2])
        step += 1
        if step in sync_steps:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                done += eng.step()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        else:
            done += eng.step()
    stats = {k: v.clone() for k, v in eng.state["stats"].items()}
    return sorted(done, key=lambda r: r.rid), stats, runner


@pytest.mark.cuda
@pytest.mark.parametrize("policy,merge", [("fastcache", 1.0),
                                          ("fastcache", 0.5),
                                          ("teacache", 1.0)])
def test_step_graph_dit_serve_matches_eager(cuda_device, policy, merge):
    """A 2-layer DiT serve whose warm steps are graph replays against the
    same serve stepped eagerly: latents bitwise, every request's counters
    and every row's stats (the gate's decisions) equal; the replayed warm
    steps make no host sync (sync debug "error"), and the policy counted
    none."""
    from repro_torch.launch.serve_diffusion import Workload
    wl = Workload(reduced=True, slots=3, steps=10, policy=policy,
                  merge_ratio=merge, merge_window=8)
    model = wl.build_model(cuda_device)
    want, want_stats, eager = _dit_graph_serve(wl, model, False)
    assert eager.graphs.replays == 0
    # steps 1 (cold), 3 (mixed) eager, then warm-up, capture, replays;
    # steps 6..9 are replays and complete nothing
    got, got_stats, runner = _dit_graph_serve(wl, model, None,
                                              sync_steps=range(6, 10))
    assert runner.graphs.captures == 1 and runner.graphs.replays > 4
    for r, w in zip(got, want):
        assert torch.equal(torch.from_numpy(r.latents),
                           torch.from_numpy(w.latents)), r.rid
        assert r.cache == w.cache, r.rid
    for k in want_stats:
        assert torch.equal(got_stats[k], want_stats[k]), k
    # an eager warm step reads L decisions (fastcache) or 1 (teacache); a
    # replay reads none, and cold and mixed steps none (the host mirror)
    reads = runner.L if policy == "fastcache" else 1
    kinds = runner.impl.step_kinds
    assert runner.impl.host_syncs == reads * (kinds["warm"]
                                              - runner.graphs.replays)


@pytest.mark.cuda
def test_step_graph_gated_decode_matches_eager(cuda_device):
    """A 2-layer gated decode serve replayed as a graph against the same
    serve stepped eagerly: tokens and K/V caches bitwise, the gate state
    equal; after the capture a decode step makes one sync (the tokens)."""
    import warnings
    from repro_torch.launch.serve import LLMWorkload
    outs = []
    for step_graph in (False, None):
        wl = LLMWorkload(reduced=True, requests=3, prompt_len=24,
                         new_tokens=10, max_batch=2, window=64,
                         fastcache=True, step_graph=step_graph)
        model = wl.build_model(cuda_device)
        eng = wl.build_engine(model)
        reqs = wl.build_requests(model)
        for r in reqs[:2]:
            assert eng.add_request(r)
        for _ in range(4):
            eng.step()
        counted = eng.host_syncs + eng.decoder.host_syncs
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                for _ in range(3):
                    eng.step()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        flagged = [w for w in caught if "synchroniz" in str(w.message)
                   and "prototype" not in str(w.message)]
        per_step = (eng.host_syncs + eng.decoder.host_syncs - counted) / 3
        assert len(flagged) == 3 * per_step
        eng.run(reqs[2:])
        outs.append(([list(r.generated) for r in reqs],
                     {k: v.clone() for k, v in eng.cache.items()},
                     [t.clone() for t in (eng.fc_state["gate"].sigma2,
                                          eng.fc_state["gate"].initialized,
                                          eng.fc_state["prev_hidden"])],
                     per_step, eng.graphs))
    (tok_e, kv_e, st_e, sync_e, g_e), (tok_g, kv_g, st_g, sync_g, g_g) = outs
    assert g_e is None and g_g.captures == 1 and g_g.replays > 3
    assert sync_e == model.cfg.num_layers + 1 and sync_g == 1
    assert tok_e == tok_g
    for k in kv_e:
        assert torch.equal(kv_e[k], kv_g[k]), k
    for a, b in zip(st_e, st_g):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_step_graph_capture_failure_raises(cuda_device):
    """A step that cannot be captured (it reads a value on the host) makes
    the capture raise; nothing falls back to the eager step, and the
    kernels' launch counts are left as they were."""
    from repro_torch import cuda_kernels
    from repro_torch.core import step_graph
    graphs = step_graph.StepGraphs()
    x = torch.ones(4, device=cuda_device)

    def bad(t):
        saliency_delta(t[None, None], t[None, None])
        return t * float(t.sum())           # a host read: not capturable

    for _ in range(step_graph.WARMUP_CALLS):    # the eager warm-up
        graphs.run(("bad", 0), bad, (x,), {})
    before = cuda_kernels.read_counts()
    with pytest.raises(RuntimeError, match="capturing the step graph"):
        graphs.run(("bad", 0), bad, (x,), {})
    assert cuda_kernels.counts_since(before) == {}
    assert graphs.replays == 0


# ---------------------------------------------------------------------------
# the sharded engine's step graphs on a one-rank nccl world
# (serving/sharded_engine.py, core/step_graph.py)
# ---------------------------------------------------------------------------

@pytest.fixture
def nccl_world(cuda_device):
    """A one-rank nccl process group on the card for the test's span."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import free_port, init_ranks
    init_ranks(0, 1, port=free_port(), backend="nccl")
    yield cuda_device
    dist.destroy_process_group()


def _sharded_serve(wl, model, mesh, step_graph):
    """A serve of ``wl`` on a fresh (1, 1) sharded engine; the runner,
    the engine and the finished requests by rid."""
    runner, eng = dataclasses.replace(wl, step_graph=step_graph
                                      ).build_engine(model, mesh=mesh)
    done = eng.run(wl.build_trace(model))
    return runner, eng, {r.rid: r for r in done}


@pytest.mark.cuda
def test_sharded_graph_serve_matches_eager(nccl_world):
    """The (1, 1) sharded engine on nccl takes the graph path by default:
    once its key is warm, every warm step is a replay with no policy sync,
    and the latents and request counters are bitwise the eager sharded
    serve's (L syncs a warm step) and the single-device graph serve's."""
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.launch.serve_diffusion import Workload
    wl = Workload(reduced=True, slots=3, steps=10, requests=5)
    model = wl.build_model(nccl_world)
    mesh = make_serving_mesh(1, 1)
    eager_runner, _, want = _sharded_serve(wl, model, mesh, False)
    assert not eager_runner.step_graph and eager_runner.graphs.replays == 0
    kinds = eager_runner.impl.step_kinds
    assert eager_runner.impl.host_syncs == eager_runner.L * kinds["warm"] > 0
    _sharded_serve(wl, model, mesh, None)         # the key's eager warm-up
    runner, eng, got = _sharded_serve(wl, model, mesh, None)
    _, plain = wl.build_engine(model)
    single = {r.rid: r for r in plain.run(wl.build_trace(model))}
    assert runner.step_graph and eng.graph_refusal is None
    assert runner.graphs.replays == runner.impl.step_kinds["warm"] > 0
    assert runner.impl.host_syncs == 0 and eng.host_syncs == 1
    for other in (want, single):
        assert sorted(got) == sorted(other)
        for rid, r in got.items():
            assert torch.equal(torch.from_numpy(r.latents),
                               torch.from_numpy(other[rid].latents)), rid
            assert r.cache == other[rid].cache, rid


@pytest.mark.cuda
def test_sharded_graph_slo_serve(nccl_world):
    """The SLO plane (EDF, deadline-aware admission, the shed ladder,
    preemption) over the (1, 1) sharded engine on the graph path decides
    as over the single-device engine on it, with at least one preemption
    and warm steps replayed: the same admissions, finishes, rejections and
    preemptions, latents and request counters bitwise."""
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.launch.serve_diffusion import Workload
    from repro_torch.obs.metrics import MetricsCollector
    from repro_torch.serving.scheduler import piecewise_rate, poisson_trace
    from repro_torch.serving.slo import (AdmissionController,
                                         DegradationController, SLOScheduler)
    wl = Workload(reduced=True, slots=4, steps=6)
    model = wl.build_model(nccl_world)
    mesh = make_serving_mesh(1, 1)
    out = []
    for sharded in (False, True):
        runner, eng = wl.build_engine(model, collector=MetricsCollector(),
                                      mesh=mesh if sharded else None)
        # tests/test_torch_sharded_serving.py's SLO plane and trace
        sched = SLOScheduler(
            eng, sched_policy="edf",
            admission=AdmissionController(eng, on_miss="reject",
                                          defer_steps=2,
                                          collector=eng.collector),
            controller=DegradationController(high_watermark=4,
                                             low_watermark=1, patience=2,
                                             collector=eng.collector))
        done = sched.run(poisson_trace(
            14, 0.3, seed=0, num_classes=10,
            rate_fn=piecewise_rate([(4, 0.3), (12, 2.0), (10 ** 9, 0.3)]),
            priority_mix=[0, 1, 1, 2], deadline_slack_mix=[6, 12, 30]))
        assert runner.step_graph and runner.graphs.replays > 0
        out.append(({r.rid: r for r in done},
                    [(r.rid, r.reject_reason) for r in sched.rejected],
                    (eng.clock, eng.model_steps)))
    (want, want_rej, want_clock), (got, got_rej, got_clock) = out
    assert sum(r.preemptions for r in want.values()) >= 1
    assert got_rej == want_rej and got_clock == want_clock
    assert sorted(got) == sorted(want)
    for rid, r in got.items():
        w = want[rid]
        assert (r.admit_step, r.finish_step, r.preemptions) == \
            (w.admit_step, w.finish_step, w.preemptions), rid
        assert torch.equal(torch.from_numpy(r.latents),
                           torch.from_numpy(w.latents)), rid
        assert r.cache == w.cache, rid


def _one_rank_model_group():
    """The (1, 1) mesh's sharding context with the one-rank world as its
    model group: it stands in, in this test only, for a group of ranks on
    cards of their own, which one card cannot hold (NCCL refuses two ranks
    on a card)."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import ShardingCtx, make_rules
    from repro_torch.launch.mesh import make_serving_mesh
    ctx = ShardingCtx(make_serving_mesh(1, 1), make_rules("serve"))
    ctx.group = lambda axis: dist.group.WORLD if axis == "model" else None
    return ctx


@pytest.mark.cuda
def test_sharded_graph_model_group_branch(nccl_world):
    """The block skip under a model group inside a capture: the agreement
    all-reduce on the capturing stream feeds the IF nodes, whose bodies
    all-reduce over the group.  Two integer-valued blocks (exact sums): for
    a mask of every row caching, one layer mixed, and none caching, the
    replay equals the eager step bitwise and reads nothing on the host
    (sync debug "error"); the eager step reads once a layer."""
    from repro_torch.core import step_graph
    from repro_torch.distributed.sharding import use_sharding
    from repro_torch.models.dit import tp_all_reduce
    dev = nccl_world
    torch.backends.cuda.matmul.allow_tf32 = False
    ctx = _one_rank_model_group()
    assert step_graph.capture_refusal(ctx, dev) is None
    gen = torch.Generator(dev).manual_seed(0)
    x = torch.randint(-4, 5, (4, 16, 64), generator=gen, device=dev).float()
    ws = [torch.randint(-1, 2, (64, 64), generator=gen, device=dev).float()
          for _ in range(2)]
    masks = {"all": [[True] * 4] * 2,
             "mixed": [[True] * 4, [True, True, False, True]],
             "none": [[False] * 4] * 2}
    masks = {k: torch.tensor(v, device=dev) for k, v in masks.items()}
    reads = []

    def step(xin, every):
        y = xin.clone()
        for i, w in enumerate(ws):
            def compute(w=w, m=every[i]):
                h = tp_all_reduce(torch.matmul(y, w))
                y.copy_(torch.where(m[:, None, None], y, y + h))
            reads.append(step_graph.branch(every[i], compute))
        return y

    with use_sharding(ctx=ctx):
        eager = {k: step(x, m).clone() for k, m in masks.items()}
        assert reads == [1] * 2 * len(masks)
        del reads[:]
        g = step_graph.StepGraph(step, (x, masks["mixed"]), ())
        assert reads == [0, 0]
    for k, m in masks.items():
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = g.replay((x, m))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.equal(got, eager[k]), k
