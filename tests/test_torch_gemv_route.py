"""linear_blend's gemv route on the CPU: the route rule with M, the split
of K (``route.gemv_plan``), and the kernel's summation order emulated in
float32.

On the card a (M, D) x (D, F) call that the wgmma rule takes with a single
bf16 copy of W goes to the gemv route when M <= ``route.GEMV_MAX_ROWS``
(the decode gate's M = batch): column tiles of 256 times splits of K over
every SM, each block's 8 K lanes summing their rows in order, the lanes
added in order, and the last block of a tile adding the splits in order
(``csrc/linear_blend.cu``).  A split copy stays on wgmma_split at any M,
and ``fused_gate`` never takes the route.  What a CPU can check:

- the rule, a pure function of dtype, shape, alignment, the copy and M,
  on every case of ``ROUTE_CASES`` and M at and around the limit;
- the plan: every row of K in exactly one split, each a whole number of
  lanes' rows within the kernel's limits, the blocks at most two an SM
  where K allows, the ticket count within the kernel's array;
- the kernel's arithmetic, emulated in float32 in its exact order (bf16
  times bf16 is exact in float32, so each of its fmaf steps is one float32
  add here): under hypothesis over M <= 4 and D, F up to 7168, within
  BLEND_TOL (2e-2, bf16 outputs, W = I + 0.01 noise rounded to bf16) of
  the plain version; at W = I bitwise the plain version, which is what
  lets the served decode gate keep its tokens;
- the CPU wrapper at the decode gate's shape ignores the copy: the plain
  version's bits, no counter moved.

The kernel itself runs only on the card: ``tests/test_torch_cuda.py -k
gemv``.
"""
import tests.torch_threads  # noqa: F401  (first: one thread)
import numpy as np
import pytest
import torch

from repro_torch.cuda_kernels import ref as tref
from repro_torch.cuda_kernels import route
from repro_torch.cuda_kernels.linear_blend import linear_blend
from tests.test_torch_gemm_route import ALIGNED, ROUTE_CASES

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

BF16 = torch.bfloat16
BLEND_TOL = 2e-2
LIMIT = route.GEMV_MAX_ROWS
# the decode gates' widths: qwen3-0.6b, qwen3-14b, the MoE configs, yi-9b,
# stablelm-3b, qwen2-vl-2b
DECODE_WIDTHS = (1024, 5120, 7168, 4096, 2560, 1536)


def _copy(rows: int, f: int) -> torch.Tensor:
    return torch.empty((rows, max(f, 1)), dtype=BF16)


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 2, LIMIT, LIMIT + 1, 64, 2048])
@pytest.mark.parametrize("dtype,d,f,addresses,want", ROUTE_CASES)
def test_gemm_route_rule_with_m(dtype, d, f, addresses, want, m):
    """Where the wgmma rule takes a call with a single copy, M <= LIMIT
    goes to gemv and more rows stay on wgmma; a split copy goes to
    wgmma_split at any M; SIMT stays SIMT."""
    got = route.gemm_route(dtype, d, f, addresses, _copy(d, f), m=m)
    if want == "wgmma":
        assert got == ("gemv" if m <= LIMIT else "wgmma")
    else:
        assert got == want
    assert got in route.BLEND_ROUTES
    split = _copy(route.SPLIT_TERMS * route.split_rows(d), f)
    assert route.gemm_route(dtype, d, f, addresses, split, m=m) == (
        "wgmma_split" if want == "wgmma" else want)


@pytest.mark.parametrize("dtype,d,f,addresses,want", ROUTE_CASES)
def test_gemm_route_without_m_never_takes_gemv(dtype, d, f, addresses,
                                               want):
    """``fused_gate`` names no M: its calls keep the three routes."""
    assert route.gemm_route(dtype, d, f, addresses) == want
    assert route.gemm_route(dtype, d, f, addresses, _copy(d, f)) == want


def test_limit_is_the_decode_batch():
    """The limit holds the decode gate's batch of 4 (LLMWorkload's
    max_batch), the widest M the card showed the route faster than wgmma
    at every decode width (PERF.md)."""
    from repro_torch.launch.serve import LLMWorkload
    assert route.GEMV_MAX_ROWS == 4 == LLMWorkload().max_batch
    assert route.gemm_route(BF16, 1024, 1024, ALIGNED, _copy(1024, 1024),
                            m=LLMWorkload().max_batch) == route.GEMV


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@settings(max_examples=200, deadline=None)
@given(m=st.integers(1, 64), d8=st.integers(1, 4096),
       f8=st.integers(1, 4096))
def test_gemv_plan_covers_k_once_within_limits(m, d8, f8):
    d, f = 8 * d8, 8 * f8
    plan = route.gemv_plan(m, d, f)
    assert plan.tiles == -(-f // route.GEMV_COLS)
    assert plan.groups == -(-m // route.GEMV_ROWS)
    assert plan.k_rows % route.GEMV_LANES == 0
    assert plan.k_rows <= route.GEMV_MAX_K
    # every row of K in one split: the last split starts inside K
    assert (plan.splits - 1) * plan.k_rows < d <= plan.splits * plan.k_rows
    if d >= route.GEMV_MIN_K and plan.splits > -(-d // route.GEMV_MAX_K):
        # split further than K's size forces: no split under GEMV_MIN_K
        # rows, and at most two blocks an SM
        assert plan.k_rows >= route.GEMV_MIN_K - route.GEMV_LANES
        assert plan.tiles * plan.splits <= route.GEMV_BLOCKS
    assert plan.workspace == (plan.groups * plan.tiles * plan.splits
                              * route.GEMV_ROWS * route.GEMV_COLS)


def test_gemv_plan_at_the_decode_widths():
    """The splits at the decode gates' widths, M = 4: one wave of at most
    two blocks an SM, or one an SM where two would reach few SMs."""
    got = {d: tuple(route.gemv_plan(4, d, d)) for d in DECODE_WIDTHS}
    assert got == {1024: (4, 16, 64, 1), 5120: (20, 13, 400, 1),
                   7168: (28, 9, 800, 1), 4096: (16, 16, 256, 1),
                   2560: (10, 25, 104, 1), 1536: (6, 22, 72, 1)}
    for d, (tiles, splits, _, groups) in got.items():
        assert tiles * splits <= route.GEMV_BLOCKS
        assert not (route.GEMV_SMS < tiles * splits
                    < route.GEMV_SMS * 3 // 2), d
        assert tiles * groups <= route.GEMV_MAX_TICKETS


@pytest.mark.parametrize("blocks", [route.GEMV_SMS, route.GEMV_BLOCKS])
@pytest.mark.parametrize("d", DECODE_WIDTHS)
def test_gemv_plan_aimed_at_a_block_count(d, blocks):
    """A plan aimed at ``blocks`` (the ones chip_smoke.py times beside the
    rule's) covers K as the rule's does and stays within that many blocks;
    aimed at GEMV_BLOCKS it is the rule's wherever no correction applied."""
    plan = route.gemv_plan(4, d, d, blocks)
    rule = route.gemv_plan(4, d, d)
    assert plan.tiles == rule.tiles and plan.groups == rule.groups
    assert plan.k_rows % route.GEMV_LANES == 0
    assert (plan.splits - 1) * plan.k_rows < d <= plan.splits * plan.k_rows
    assert plan.tiles * plan.splits <= blocks
    if blocks == route.GEMV_BLOCKS and d != 1536:
        assert plan == rule


# ---------------------------------------------------------------------------
# the kernel's order, emulated in float32
# ---------------------------------------------------------------------------

def _bf16(a: np.ndarray) -> np.ndarray:
    """Rounded to bfloat16 (nearest even), as float32."""
    return torch.from_numpy(a).to(BF16).float().numpy()


def gemv_emulated(x, w, b, prev, gamma):
    """The gemv kernel's result for bf16 values x (M, D), w (D, F), prev
    (M, F) held as float32 and b (F,) float32, in its order: lane l of a
    split adds x[:, k] w[k] for k = k0 + l, k0 + l + 8, ... (each product
    exact in float32, each add one rounding, as the kernel's fmaf), the
    lanes added in order, the splits added in order, then the bias, the
    blend (gamma != 1) and the rounding to bf16."""
    m, d = x.shape
    f = w.shape[1]
    plan = route.gemv_plan(m, d, f)
    lanes = route.GEMV_LANES
    total = None
    for s in range(plan.splits):
        k0 = s * plan.k_rows
        k1 = min(d, k0 + plan.k_rows)
        rows = k1 - k0
        n_i = -(-rows // lanes)
        # (n_i, lanes) rows of K; a missing row adds an exact +0
        xs = np.zeros((n_i * lanes, m), np.float32)
        ws = np.zeros((n_i * lanes, f), np.float32)
        xs[:rows] = x[:, k0:k1].T
        ws[:rows] = w[k0:k1]
        xs = xs.reshape(n_i, lanes, m)
        ws = ws.reshape(n_i, lanes, f)
        acc = np.zeros((lanes, m, f), np.float32)
        for i in range(n_i):
            acc = acc + xs[i][:, :, None] * ws[i][:, None, :]
        part = acc[0]
        for lane in range(1, lanes):
            part = part + acc[lane]
        total = part if total is None else total + part
    v = total + b.astype(np.float32)
    if gamma != 1.0:
        g = np.float32(gamma)
        v = g * v + np.float32(1.0 - gamma) * prev
    return torch.from_numpy(v.astype(np.float32)).to(BF16)


def _args(m, d, f, seed, identity=False):
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((m, d)).astype(np.float32))
    w = np.eye(d, f, dtype=np.float32)
    if not identity:
        w = w + 0.01 * rng.standard_normal((d, f)).astype(np.float32)
    b = (0.1 * rng.standard_normal(f)).astype(np.float32)
    prev = _bf16(rng.standard_normal((m, f)).astype(np.float32))
    return x, w, b, prev


def _plain(x, w, b, prev, gamma):
    return tref.linear_blend(torch.from_numpy(x).to(BF16),
                             torch.from_numpy(w), torch.from_numpy(b),
                             torch.from_numpy(prev).to(BF16), gamma)


@settings(max_examples=30, deadline=None)
@given(m=st.integers(1, 4), d8=st.integers(1, 896), f8=st.integers(1, 896),
       gamma=st.sampled_from([1.0, 0.5]), seed=st.integers(0, 2 ** 16))
def test_emulated_order_matches_plain(m, d8, f8, gamma, seed):
    """The kernel's order on W rounded to bf16 (the copy it multiplies)
    against the plain version with the f32 W, at BLEND_TOL."""
    d, f = 8 * d8, 8 * f8
    x, w, b, prev = _args(m, d, f, seed)
    got = gemv_emulated(x, _bf16(w), b, prev, gamma)
    want = _plain(x, w, b, prev, gamma)
    torch.testing.assert_close(got.float(), want.float(), rtol=BLEND_TOL,
                               atol=BLEND_TOL)


@pytest.mark.parametrize("d", DECODE_WIDTHS + (1000,))
def test_emulated_order_at_the_decode_widths(d):
    """At every decode width, M = 4, gamma 1 (the decode gate's call):
    within BLEND_TOL of the plain version; at W = I the plain version's
    bits (each partial is exact there)."""
    x, w, b, prev = _args(4, d, d, seed=d)
    torch.testing.assert_close(
        gemv_emulated(x, _bf16(w), b, prev, 1.0).float(),
        _plain(x, w, b, prev, 1.0).float(), rtol=BLEND_TOL, atol=BLEND_TOL)
    x, w, b, prev = _args(4, d, d, seed=d, identity=True)
    assert torch.equal(gemv_emulated(x, w, b, prev, 1.0),
                       _plain(x, w, b, prev, 1.0))


@settings(max_examples=20, deadline=None)
@given(m=st.integers(1, 4), d8=st.integers(1, 300),
       gamma=st.sampled_from([1.0, 0.5]), seed=st.integers(0, 2 ** 16))
def test_emulated_order_is_exact_at_identity(m, d8, gamma, seed):
    d = 8 * d8
    x, w, b, prev = _args(m, d, d, seed, identity=True)
    assert torch.equal(gemv_emulated(x, w, b, prev, gamma),
                       _plain(x, w, b, prev, gamma))


# ---------------------------------------------------------------------------
# the CPU wrapper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, LIMIT])
def test_cpu_linear_blend_ignores_the_copy_at_decode_shapes(m):
    x, w, b, prev = (torch.from_numpy(a) for a in _args(m, 1024, 1024, 3))
    x, prev = x.to(BF16), prev.to(BF16)
    before = dict(linear_blend.launches_by_route)
    got = linear_blend(x, w, b, prev, gamma=1.0, w_bf16=w.to(BF16))
    assert torch.equal(got, tref.linear_blend(x, w, b, prev, 1.0))
    assert torch.equal(got, linear_blend(x, w, b, prev, gamma=1.0,
                                         gemm="gemv"))
    assert linear_blend.launches_by_route == before
