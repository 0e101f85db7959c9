"""The two routes of ``knn_density`` and ``merge_assign`` on the CPU: the
pure route rule, the CPU wrappers against the reference at the served
window shape, and the rank rule the mma route picks its centers by.

On the card a call takes the mma route (bf16 windows bulk-copied into
shared memory, the Gram on the tensor cores) or the SIMT route (the rest);
``cuda_kernels/route.py:window_route`` decides from dtype, shape and
alignment alone, so the rule is checked here without a card.  On the CPU
the wrappers run the plain versions and count no launch.  Tolerances are
the reference's: rho within 1e-4 (f32 arithmetic on the same values; bf16
inputs are rounded once in numpy and cast exactly by both frameworks),
merged 1e-4 in f32 and 5e-2 in bf16 (one bf16 rounding of the output),
centers and assign exact.
"""
import tests.torch_threads  # noqa: F401  (first: one thread)
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.cuda_kernels import ref as tref
from repro_torch.cuda_kernels import route
from repro_torch.cuda_kernels.knn_density import knn_density
from repro_torch.cuda_kernels.token_merge import merge_assign

BF16, F32 = torch.bfloat16, torch.float32
CSRC = Path(route.__file__).resolve().parent.parent / "csrc"


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("d", [1152, 100, 1000])
@pytest.mark.parametrize("w", [2, 16, 32, 33])
@pytest.mark.parametrize("dtype", [BF16, F32, torch.float16])
def test_window_route_rule(dtype, w, d, aligned):
    """bf16 with w <= 32, D % 8 == 0 and a 16-byte aligned base takes mma
    (every such window at these widths fits in shared memory); f32 (held
    to 1e-4), ragged D and unaligned bases take SIMT."""
    addresses = (0, 4096) if aligned else (4096, 2 * 1152 + 2)
    want = ("mma" if dtype == BF16 and w <= 32 and d % 8 == 0 and aligned
            else "simt")
    assert route.window_route(dtype, w, d, addresses) == want
    assert want in route.WINDOW_ROUTES


def test_window_route_needs_the_window_to_fit_in_shared_memory():
    """At w = 32 the padded window fits up to D = 3072 and not beyond."""
    assert route.window_smem_bytes(32, 3072) <= route.SMEM_LIMIT
    assert route.window_route(BF16, 32, 3072, [0]) == "mma"
    assert route.window_smem_bytes(32, 3080) > route.SMEM_LIMIT
    assert route.window_route(BF16, 32, 3080, [0]) == "simt"
    assert route.window_route(BF16, 16, 3080, [0]) == "mma"


@pytest.mark.parametrize("d", [8, 16, 1000, 1152, 3072])
def test_window_pitch_is_padded_and_odd(d):
    """Each row is padded by at least the 16 bytes a ragged last k-step
    reads, and the pitch is an odd number of 16-byte units (ldmatrix reads
    eight rows without a bank conflict)."""
    p = route.window_pitch(d)
    assert p % 16 == 0 and (p // 16) % 2 == 1
    assert 2 * d + 16 <= p <= 2 * d + 32


def test_window_route_mirrors_the_kernel_header():
    """The rule's shared-memory sizes are window_mma.cuh's."""
    src = (CSRC / "window_mma.cuh").read_text()
    gram = (CSRC / "window_gram.cuh").read_text()
    warps = int(re.search(r"constexpr int kWarps = (\d+);", src).group(1))
    max_w = int(re.search(r"constexpr int kMaxW = (\d+);", gram).group(1))
    assert max_w == route.MAX_WINDOW
    assert route.WINDOW_EXTRA_BYTES == (warps * max_w * (max_w + 1) * 4
                                        + 4 * max_w * 4 + 16)
    assert "return ((D / 8 + 1) | 1) * 16;" in src
    assert f"kSmemLimit = {route.SMEM_LIMIT};" in src


def test_window_route_reads_tensor_alignment():
    """A view one element into its storage is 2 bytes off 16: SIMT; the
    same values copied to a fresh tensor: mma."""
    flat = torch.zeros(2 * 16 * 64 + 8, dtype=BF16)
    view = flat[1:1 + 2 * 16 * 64].view(2, 16, 64)
    fresh = view.clone()
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    assert route.window_route(BF16, 16, 64, [view.data_ptr()]) == "simt"
    assert fresh.data_ptr() % 16 == 0
    assert route.window_route(BF16, 16, 64, [fresh.data_ptr()]) == "mma"


# ---------------------------------------------------------------------------
# the CPU wrappers at the served window shape
# ---------------------------------------------------------------------------

def _windows(nw, w, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((nw, w, d)).astype(np.float32)
    if dtype == "bfloat16":
        h = np.asarray(jnp.asarray(h, jnp.bfloat16).astype(jnp.float32))
    s = rng.random((nw, w)).astype(np.float32)
    return h, s / s.max(axis=1, keepdims=True)


def _torch(a, dtype="float32"):
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(BF16) if dtype == "bfloat16" else t


def _jax(a, dtype="float32"):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else None)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_window_wrappers_match_reference_at_the_served_shape(dtype):
    """The served windows (w=16, D=1152, K=5, M=8): the CPU wrappers run
    the plain versions, count no launch on either route, and agree with the
    reference's Pallas kernels in interpret mode."""
    nw, w, d, k, m = 8, 16, 1152, 5, 8
    h, s = _windows(nw, w, d, dtype)
    th, ts = _torch(h, dtype), _torch(s)
    before = (dict(knn_density.launches_by_route),
              dict(merge_assign.launches_by_route))
    rho = knn_density(th, k=k)
    merged, assign, centers = merge_assign(th, ts, m=m)
    assert (knn_density.launches_by_route,
            merge_assign.launches_by_route) == before
    assert torch.equal(rho, tref.knn_density(th, k))
    for a, b in zip((merged, assign, centers), tref.merge_assign(th, ts, m)):
        assert torch.equal(a, b)
    j_rho = jops.knn_density(_jax(h, dtype), k=k, interpret=True)
    np.testing.assert_allclose(rho.numpy(), np.asarray(j_rho), rtol=1e-4,
                               atol=1e-4)
    jm, ja, jc = jops.merge_assign(_jax(h, dtype), _jax(s), m=m,
                                   interpret=True)
    np.testing.assert_array_equal(centers.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(assign.numpy(), np.asarray(ja))
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(merged.float().numpy(),
                               np.asarray(jm, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# the rank rule of the mma route's centers
# ---------------------------------------------------------------------------

def rank_centers(s: torch.Tensor, m: int) -> torch.Tensor:
    """The mma route's rule in plain PyTorch: token j's rank is the number
    of scores that beat s_j (greater, or equal at a lower index), and the
    token of rank r is center r.  s: (W, w) -> (W, m) int32."""
    w = s.shape[-1]
    idx = torch.arange(w)
    si, sj = s[..., :, None], s[..., None, :]
    beats = (si > sj) | ((si == sj) & (idx[:, None] < idx[None, :]))
    rank = beats.sum(dim=-2)                               # (W, w)
    centers = torch.empty_like(rank)
    centers.scatter_(-1, rank, idx.expand_as(rank))
    return centers[..., :m].to(torch.int32)


@pytest.mark.parametrize("levels", [1, 2, 3, 16])
@pytest.mark.parametrize("w,m", [(16, 8), (32, 8), (5, 5), (16, 1)])
def test_rank_rule_is_lax_top_k_order(levels, w, m):
    """On heavily tied scores (``levels`` distinct values, 1: all equal)
    the rank rule's centers are ``lax.top_k``'s indices, the plain
    version's and the reference kernel's, and the ranks are a permutation."""
    rng = np.random.default_rng(levels * 100 + w)
    s = (rng.integers(0, levels, (64, w)) / max(levels - 1, 1)
         ).astype(np.float32)
    ts = torch.from_numpy(s)
    got = rank_centers(ts, m)
    _, top = jax.lax.top_k(jnp.asarray(s), m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(top))
    h = np.random.default_rng(1).standard_normal((64, w, 8)).astype(
        np.float32)
    assert torch.equal(got, tref.merge_assign(torch.from_numpy(h), ts,
                                              m)[2])
    _, _, jc = jops.merge_assign(jnp.asarray(h), jnp.asarray(s), m=m,
                                 interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jc))
    full = rank_centers(ts, w)
    assert torch.equal(full.sort(dim=-1).values,
                       torch.arange(w, dtype=torch.int32).expand(64, w))


def test_profile_serve_attributes_both_window_routes():
    """``launch/profile_serve.py`` sums knn_density's and merge_assign's
    device time over both routes' kernels and counts their launches by
    route."""
    from repro_torch.launch import profile_serve

    by_name = {
        "void (anonymous namespace)::knn_density_kernel_mma<1>(...)":
            [4.7, 2],
        "void (anonymous namespace)::knn_density_kernel<float>(...)":
            [34.0, 1],
        "void (anonymous namespace)::merge_assign_kernel_mma<1>(...)":
            [6.0, 2],
        "void (anonymous namespace)::merge_assign_kernel<__nv_bfloat16>(...)":
            [58.0, 1]}
    got = profile_serve.attribute(by_name, {"knn_density": 3,
                                            "merge_assign": 3})
    assert got["knn_density"] == {"ms": pytest.approx(0.0387),
                                  "kernel_calls": 3, "launches": 3}
    assert got["merge_assign"] == {"ms": pytest.approx(0.064),
                                   "kernel_calls": 3, "launches": 3}
    counts = profile_serve._counts()
    for name in ("knn_density", "merge_assign"):
        for r in route.WINDOW_ROUTES:
            assert f"{name}:{r}" in counts
