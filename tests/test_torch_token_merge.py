"""The port's token-merge kernels' plain versions against the reference's,
on the same inputs.

Inputs are drawn with numpy from a seed and handed to the reference's
Pallas kernels (in interpret mode), their pure-jnp twins and the port's
plain PyTorch versions, over the grid of the reference's own kernel tests.
bf16 inputs are rounded once in numpy's f32 and cast exactly by both
frameworks.  Tolerances are the reference's: ``knn_density`` 1e-4 in f32,
6e-2 in bf16; ``merged`` 1e-4 in f32, 5e-2 in bf16 (one bf16 rounding of
the output); ``assign`` / ``centers`` and ``unmerge_scatter`` exact.
"""
import tests.torch_threads  # noqa: F401  (first: one thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.cuda_kernels import ref as tref
from repro_torch.cuda_kernels.knn_density import knn_density
from repro_torch.cuda_kernels.token_merge import merge_assign, unmerge_scatter


def _normal(shape, dtype, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        a = np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    return a


def _scores(nw, w, seed=1):
    z = np.random.default_rng(seed).standard_normal((nw, w))
    e = np.exp(z - z.max(axis=1, keepdims=True))
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


def _torch(a, dtype="float32"):
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _jax(a, dtype="float32"):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else None)


def _np(t):
    return t.float().numpy() if t.is_floating_point() else t.numpy()


@pytest.mark.parametrize("nw,w,d,k", [(4, 16, 32, 5), (2, 32, 64, 3),
                                      (8, 8, 16, 7), (128, 16, 64, 5)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_knn_density_plain_matches_reference(nw, w, d, k, dtype):
    h = _normal((nw, w, d), dtype)
    got = tref.knn_density(_torch(h, dtype), k)
    assert got.dtype == torch.float32 and got.shape == (nw, w)
    tol = 1e-4 if dtype == "float32" else 6e-2
    for want in (jops.knn_density(_jax(h, dtype), k=k, interpret=True),
                 jref.knn_density(_jax(h, dtype), k)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("nw,w,d,m", [(4, 16, 32, 8), (2, 32, 64, 8),
                                      (8, 8, 16, 3), (3, 16, 48, 1),
                                      (128, 16, 64, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_assign_plain_matches_reference(nw, w, d, m, dtype):
    h = _normal((nw, w, d), dtype)
    s = _scores(nw, w)
    merged, assign, centers = tref.merge_assign(_torch(h, dtype),
                                                _torch(s), m)
    assert merged.dtype == _torch(h, dtype).dtype
    assert merged.shape == (nw, m, d)
    assert assign.dtype == centers.dtype == torch.int32
    tol = 1e-4 if dtype == "float32" else 5e-2
    for jm, ja, jc in (jops.merge_assign(_jax(h, dtype), _jax(s), m=m,
                                         interpret=True),
                       jref.merge_assign(_jax(h, dtype), _jax(s), m)):
        np.testing.assert_array_equal(centers.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(assign.numpy(), np.asarray(ja))
        np.testing.assert_allclose(_np(merged), np.asarray(jm, np.float32),
                                   rtol=tol, atol=tol)


def test_merge_assign_tied_scores_follow_top_k_order():
    """Heavy ties: the centers come out in lax.top_k order (descending
    score, ties to the lower index), not sorted by index."""
    nw, w, d, m = 6, 16, 8, 8
    h = _normal((nw, w, d), "float32")
    s = np.random.default_rng(2).integers(0, 4, size=(nw, w)).astype(
        np.float32)
    _, assign, centers = tref.merge_assign(_torch(h), _torch(s), m)
    _, ja, jc = jops.merge_assign(_jax(h), _jax(s), m=m, interpret=True)
    np.testing.assert_array_equal(centers.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(assign.numpy(), np.asarray(ja))
    first = centers.numpy()[0]
    assert list(first) != sorted(first)       # selection order, not index
    assert np.all(np.diff(s[0][first]) <= 0)


@pytest.mark.parametrize("nw,w,d,m", [(4, 16, 32, 8), (2, 8, 64, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unmerge_scatter_plain_matches_reference(nw, w, d, m, dtype):
    merged = _normal((nw, m, d), dtype)
    assign = np.random.default_rng(3).integers(0, m, size=(nw, w)).astype(
        np.int32)
    got = tref.unmerge_scatter(_torch(merged, dtype), torch.from_numpy(assign))
    assert got.dtype == _torch(merged, dtype).dtype
    for want in (jops.unmerge_scatter(_jax(merged, dtype), jnp.asarray(assign),
                                      interpret=True),
                 jref.unmerge_scatter(_jax(merged, dtype),
                                      jnp.asarray(assign))):
        np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


def test_merge_unmerge_identity_at_full_m():
    """m == w keeps every token a center: unmerge(merge) is the identity up
    to the f32 cluster mean of one token."""
    h = _torch(_normal((2, 16, 32), "float32"))
    s = torch.full((2, 16), 1.0 / 16.0)
    merged, assign, centers = tref.merge_assign(h, s, 16)
    np.testing.assert_array_equal(np.sort(centers.numpy(), axis=1),
                                  np.tile(np.arange(16), (2, 1)))
    out = tref.unmerge_scatter(merged, assign)
    torch.testing.assert_close(out, h, rtol=0, atol=1e-5)


@pytest.mark.parametrize("k", [0, 16, 20])
def test_knn_density_k_bounds_raise_as_reference(k):
    h = _normal((2, 16, 8), "float32")
    msgs = []
    for fn in (lambda: jref.knn_density(_jax(h), k),
               lambda: tref.knn_density(_torch(h), k),
               lambda: knn_density(_torch(h), k=k)):
        with pytest.raises(ValueError, match="out of range for window") as e:
            fn()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == msgs[2]


@pytest.mark.parametrize("m", [0, 17])
def test_merge_assign_m_bounds_raise_as_reference(m):
    h = _normal((2, 16, 8), "float32")
    s = np.ones((2, 16), np.float32)
    msgs = []
    for fn in (lambda: jops.merge_assign(_jax(h), _jax(s), m=m,
                                         interpret=True),
               lambda: tref.merge_assign(_torch(h), _torch(s), m),
               lambda: merge_assign(_torch(h), _torch(s), m=m)):
        with pytest.raises(ValueError, match="out of range") as e:
            fn()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == msgs[2]


def test_wrappers_send_cpu_tensors_to_plain_versions():
    h = _torch(_normal((4, 16, 32), "float32"))
    s = _torch(_scores(4, 16))
    counts = (knn_density.launches, merge_assign.launches,
              unmerge_scatter.launches)
    assert torch.equal(knn_density(h, k=5), tref.knn_density(h, 5))
    got = merge_assign(h, s, m=8)
    for g, w in zip(got, tref.merge_assign(h, s, 8)):
        assert torch.equal(g, w)
    assert torch.equal(unmerge_scatter(got[0], got[1]),
                       tref.unmerge_scatter(got[0], got[1]))
    assert (knn_density.launches, merge_assign.launches,
            unmerge_scatter.launches) == counts


@pytest.mark.parametrize("fn", ["knn", "merge", "unmerge"])
def test_wrappers_reject_bad_dtype(fn):
    h = torch.zeros((2, 8, 16), dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        if fn == "knn":
            knn_density(h, k=3)
        elif fn == "merge":
            merge_assign(h, torch.ones((2, 8)), m=4)
        else:
            unmerge_scatter(h[:, :4].contiguous(),
                            torch.zeros((2, 8), dtype=torch.int32))


@pytest.mark.parametrize("bad", ["knn_rank", "knn_noncontiguous",
                                 "merge_s_shape", "merge_s_dtype",
                                 "merge_rank", "unmerge_assign_dtype",
                                 "unmerge_assign_rows", "unmerge_rank"])
def test_wrappers_reject_bad_inputs(bad):
    h = _torch(_normal((2, 8, 16), "float32"))
    s = torch.ones((2, 8))
    merged, assign = h[:, :4].contiguous(), torch.zeros((2, 8),
                                                        dtype=torch.int32)
    with pytest.raises(ValueError):
        if bad == "knn_rank":
            knn_density(h.reshape(16, 16), k=3)
        elif bad == "knn_noncontiguous":
            knn_density(h.transpose(0, 1), k=1)
        elif bad == "merge_s_shape":
            merge_assign(h, s[:, :4], m=4)
        elif bad == "merge_s_dtype":
            merge_assign(h, s.double(), m=4)
        elif bad == "merge_rank":
            merge_assign(h.reshape(16, 16), s, m=4)
        elif bad == "unmerge_assign_dtype":
            unmerge_scatter(merged, assign.long())
        elif bad == "unmerge_assign_rows":
            unmerge_scatter(merged, assign[:1])
        else:
            unmerge_scatter(merged.reshape(8, 16), assign)
