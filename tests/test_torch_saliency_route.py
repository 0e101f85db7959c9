"""The two routes of ``saliency_delta`` on the CPU: the pure route rule, the
onepass route's split of the rows and its summation order, the CPU wrapper
against the reference, and the launch counters.

On the card a call takes the onepass route (one launch: 32 blocks a sample,
the last block of a sample adding the others' partials) or the SIMT route
(two launches); ``cuda_kernels/route.py:saliency_route`` decides from dtype,
shape and alignment alone, so the rule is checked here without a card.  On
the CPU the wrapper runs the plain version and counts no launch.  The
onepass route's claim to the SIMT route's bits rests on its summation order,
which is emulated here in float32 and compared bitwise.  Tolerance against
the reference: its rtol 1e-5 on the f32 sums (bf16 inputs are rounded once
in numpy and cast exactly by both frameworks).
"""
import tests.torch_threads  # noqa: F401  (first: one thread)
import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.cuda_kernels import ref as tref
from repro_torch.cuda_kernels import route
from repro_torch.cuda_kernels.saliency_delta import saliency_delta

BF16, F32 = torch.bfloat16, torch.float32
CSRC = Path(route.__file__).resolve().parent.parent / "csrc"
sal_mod = importlib.import_module("repro_torch.cuda_kernels.saliency_delta")


@pytest.mark.parametrize("aligned", ["both", "x_off", "prev_off"])
@pytest.mark.parametrize("d", [8, 100, 1152, 1160, 7])
@pytest.mark.parametrize("dtype", [BF16, F32, torch.float16])
def test_saliency_route_rule(dtype, d, aligned):
    """f32 and bf16 rows of a multiple of 16 bytes at 16-byte aligned bases
    take the onepass route; ragged rows (bf16 D = 100: 200 bytes; D = 7),
    an unaligned base of either input and other dtypes take SIMT."""
    esize = {BF16: 2, F32: 4, torch.float16: 2}[dtype]
    addresses = {"both": (0, 4096), "x_off": (2, 4096),
                 "prev_off": (4096, 4104)}[aligned]
    want = ("onepass" if dtype in (BF16, F32) and d * esize % 16 == 0
            and aligned == "both" else "simt")
    assert route.saliency_route(dtype, 256, d, addresses) == want
    assert want in route.SAL_ROUTES


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1000])
def test_saliency_route_takes_onepass_up_to_a_row_a_warp(n):
    """The onepass kernel takes any N; the rule picks it up to N = 256 (one
    row a warp) and the SIMT route beyond."""
    assert route.onepass_takes(BF16, n, 1152, (0, 0))
    want = "onepass" if n <= route.SAL_MAX_ONEPASS_ROWS else "simt"
    assert route.saliency_route(BF16, n, 1152, (0, 0)) == want
    assert route.SAL_MAX_ONEPASS_ROWS == route.SAL_TOTAL_THREADS


@pytest.mark.parametrize("n,want", [
    (256, (32, 8, 1)),        # the serve: a row per warp
    (128, (32, 4, 1)),        # merged: half the warps idle
    (1000, (32, 32, 4)),
    (257, (32, 9, 2)),
    (7, (32, 1, 1)),          # N < 32: 25 blocks own no row
    (1, (32, 1, 1))])
def test_saliency_plan(n, want):
    """Groups, the most rows a block owns and the most a warp walks."""
    plan = route.saliency_plan(n)
    assert tuple(plan) == want
    owned = [len(range(j, n, plan.groups)) for j in range(plan.groups)]
    assert max(owned) == plan.block_rows and sum(owned) == n
    slots = [len(range(t, n, route.SAL_TOTAL_THREADS))
             for t in range(route.SAL_TOTAL_THREADS)]
    assert max(slots) == plan.warp_rows


def test_saliency_plan_mirrors_the_kernel_source():
    """The route's constants are saliency_delta.cu's, and its rule is the
    launcher's."""
    src = (CSRC / "saliency_delta.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kGroups") == route.SAL_GROUPS
    assert const("kTotalThreads") == route.SAL_TOTAL_THREADS
    assert const("kMaxBatch") == sal_mod.MAX_BATCH
    assert "(long long)D * esize % 16 == 0 &&" in src
    assert "reinterpret_cast<uintptr_t>(x) % 16 == 0 &&" in src
    assert "reinterpret_cast<uintptr_t>(prev) % 16 == 0;" in src


def _simt_total(vals: np.ndarray) -> np.float32:
    """sample_totals' order: 256 strided sums, then the tree."""
    n, t_n = len(vals), route.SAL_TOTAL_THREADS
    sa = np.zeros(t_n, np.float32)
    for t in range(t_n):
        a = np.float32(0)
        for i in range(t, n, t_n):
            a = np.float32(a + vals[i])
        sa[t] = a
    st = t_n // 2
    while st:
        sa[:st] = sa[:st] + sa[st:2 * st]
        st //= 2
    return sa[0]


def _onepass_total(vals: np.ndarray) -> np.float32:
    """The onepass kernel's order: block j's warp w adds the rows j + 32 (w
    + 8 p) in order; thread 0 folds the block's 8 slot sums in three levels
    (k + 4, k + 2, k + 1); the last block folds the 32 partials with
    shuffles (lane t adds lane t + st)."""
    n, g = len(vals), route.SAL_GROUPS
    warps = route.SAL_TOTAL_THREADS // g
    part = np.zeros(g, np.float32)
    for j in range(g):
        s = np.zeros(warps, np.float32)
        for w in range(warps):
            a = np.float32(0)
            for r in range(j + g * w, n, g * warps):
                a = np.float32(a + vals[r])
            s[w] = a
        st = warps // 2
        while st:
            s[:st] = s[:st] + s[st:2 * st]
            st //= 2
        part[j] = s[0]
    st = g // 2
    while st:
        part = part + np.concatenate([part[st:], part[:st]])  # lane t + st
        st //= 2
    return part[0]


@pytest.mark.parametrize("n", [1, 7, 31, 32, 128, 255, 256, 257, 511, 1000])
def test_saliency_onepass_order_is_sample_totals_order(n):
    """On values whose sums round differently in other orders (full
    mantissas over 17 octaves), the onepass route's order gives
    sample_totals' bits: the two kernels add the same pairs in the same
    sequence."""
    rng = np.random.default_rng(n)
    other_order_differs = False
    for _ in range(12):
        vals = ((1 + rng.random(n)) * 2.0 ** rng.integers(-8, 9, n)).astype(
            np.float32)
        want = _simt_total(vals)
        assert _onepass_total(vals).tobytes() == want.tobytes()
        seq = np.float32(0)
        for v in vals[::-1]:
            seq = np.float32(seq + v)
        other_order_differs |= seq.tobytes() != want.tobytes()
    # the data can tell orders apart: a plain sum in reverse differs
    assert other_order_differs or n < 128


def test_saliency_route_reads_tensor_alignment():
    """A view one element into its storage is 2 bytes off 16: SIMT; the
    same values copied to a fresh tensor: onepass."""
    flat = torch.zeros(2 * 16 * 64 + 8, dtype=BF16)
    view = flat[1:1 + 2 * 16 * 64].view(2, 16, 64)
    fresh = view.clone()
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    assert sal_mod._route(view, fresh) == "simt"
    assert fresh.data_ptr() % 16 == 0
    assert sal_mod._route(fresh, fresh.clone()) == "onepass"


def test_saliency_launch_counters_start_at_zero_and_cpu_counts_none():
    """The per-route counters exist for both routes, start at zero in a
    process that launched no kernel, and a CPU call adds to neither."""
    assert set(saliency_delta.launches_by_route) == set(route.SAL_ROUTES)
    assert saliency_delta.launches_by_route == {"onepass": 0, "simt": 0}
    assert saliency_delta.launches == 0
    x = torch.randn(2, 16, 8)
    saliency_delta(x, x + 1)
    assert saliency_delta.launches_by_route == {"onepass": 0, "simt": 0}
    assert saliency_delta.launches == 0


def test_saliency_named_launch_rejects_an_unknown_route():
    x = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="unknown route"):
        sal_mod._launch("mma", x, x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,bd", [((2, 256, 1152), 128),
                                      ((3, 7, 1160), 1160)])
def test_cpu_wrapper_matches_reference_kernel(dtype, shape, bd):
    """The CPU wrapper (the plain version) against the reference's Pallas
    kernel in interpret mode, sample by sample, at the served row width and
    at a shape with fewer rows than the onepass route has blocks."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    xp = (x + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x, xp = (np.array(jnp.asarray(a, jdt).astype(jnp.float32))
             for a in (x, xp))
    tdt = BF16 if dtype == "bfloat16" else F32
    sal, diff, prev = saliency_delta(torch.from_numpy(x).to(tdt),
                                     torch.from_numpy(xp).to(tdt))
    assert sal.shape == shape[:2] and diff.shape == prev.shape == shape[:1]
    for i in range(shape[0]):
        js, jd, jp = jops.saliency_delta(jnp.asarray(x[i], jdt),
                                         jnp.asarray(xp[i], jdt), bn=128,
                                         bd=bd, interpret=True)
        np.testing.assert_allclose(sal[i].numpy(), np.asarray(js),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(diff[i]), float(jd), rtol=1e-5)
        np.testing.assert_allclose(float(prev[i]), float(jp), rtol=1e-5)
    want = tref.saliency_delta(torch.from_numpy(x).to(tdt),
                               torch.from_numpy(xp).to(tdt))
    for g, w in zip((sal, diff, prev), want):
        assert torch.equal(g, w)


def test_saliency_designs_needs_a_card():
    """The design comparison measures on a CUDA card or not at all."""
    from repro_torch.launch import saliency_designs
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would measure")
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        saliency_designs.main([])
