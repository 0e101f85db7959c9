"""The port's ``saliency_delta`` and ``linear_blend`` against the
reference's, on the same inputs, and their wrappers on the CPU.

Inputs are drawn with numpy and handed to the reference's Pallas kernels
(in interpret mode), their pure-jnp twins and the port's plain PyTorch
versions, on the shapes of the reference's own sweep
(``tests/test_kernels.py``).  Tolerances are the reference's: f32 1e-4,
bf16 5e-2 (bf16 inputs are rounded once, the same way in both frameworks;
the blend's output is rounded to bf16).  W and b are f32, as every caller
of the port passes them.
"""
import tests.torch_threads  # noqa: F401  (first: one thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import linear_approx
from repro_torch.cuda_kernels import ref as tref
from repro_torch.cuda_kernels.linear_blend import linear_blend
from repro_torch.cuda_kernels.saliency_delta import saliency_delta

TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _round(a: np.ndarray, dtype: str) -> np.ndarray:
    if dtype == "bfloat16":   # round once; both frameworks round to nearest even
        return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    return a


def _torch(a, dtype):
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _jax(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else None)


def _pair(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    xp = rng.standard_normal(shape).astype(np.float32)
    return _round(x, dtype), _round(xp, dtype)


# ---------------------------------------------------------------------------
# saliency_delta (B5)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d", [(128, 512), (256, 1024), (384, 768)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_saliency_delta_plain_matches_reference(n, d, dtype):
    x, xp = _pair((n, d), dtype)
    j_kernel = jops.saliency_delta(_jax(x, dtype), _jax(xp, dtype), bn=128,
                                   bd=256, interpret=True)
    j_plain = jref.saliency_delta(_jax(x, dtype), _jax(xp, dtype))
    sal, diff, prev = tref.saliency_delta(_torch(x, dtype), _torch(xp, dtype))
    assert sal.shape == (n,) and diff.shape == () and prev.shape == ()
    assert sal.dtype == diff.dtype == prev.dtype == torch.float32
    tol = TOL[dtype]
    for j_sal, j_diff, j_prev in (j_kernel, j_plain):
        np.testing.assert_allclose(sal.numpy(), np.asarray(j_sal), rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(diff.numpy(), np.asarray(j_diff),
                                   rtol=tol)
        np.testing.assert_allclose(prev.numpy(), np.asarray(j_prev),
                                   rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_saliency_delta_batch_is_per_sample(dtype):
    """A (B, N, D) batch gives each sample's (N, D) result: the per-token
    sums and totals of the reference's kernel, sample by sample."""
    x, xp = _pair((3, 40, 24), dtype, seed=1)
    sal, diff, prev = tref.saliency_delta(_torch(x, dtype), _torch(xp, dtype))
    assert sal.shape == (3, 40) and diff.shape == prev.shape == (3,)
    for i in range(3):
        j_sal, j_diff, j_prev = jref.saliency_delta(_jax(x[i], dtype),
                                                    _jax(xp[i], dtype))
        np.testing.assert_allclose(sal[i].numpy(), np.asarray(j_sal),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(diff[i]), float(j_diff), rtol=1e-5)
        np.testing.assert_allclose(float(prev[i]), float(j_prev), rtol=1e-5)
    # the totals are the per-sample sums the gates read
    np.testing.assert_array_equal(diff.numpy(), sal.sum(dim=-1).numpy())


def test_saliency_delta_wrapper_sends_cpu_tensors_to_plain_version():
    x, xp = _pair((2, 16, 8), "float32")
    tx, txp = torch.from_numpy(x), torch.from_numpy(xp)
    before = saliency_delta.launches
    for args in ((tx, txp), (tx[0], txp[0])):
        got, want = saliency_delta(*args), tref.saliency_delta(*args)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert saliency_delta.launches == before


@pytest.mark.parametrize("bad", ["rank1", "rank4", "float16", "shape",
                                 "dtype", "noncontiguous", "empty"])
def test_saliency_delta_wrapper_rejects_bad_inputs(bad):
    x, xp = (torch.from_numpy(a) for a in _pair((2, 16, 8), "float32"))
    err = ValueError
    if bad == "rank1":
        x, xp = x.reshape(-1), xp.reshape(-1)
    elif bad == "rank4":
        x, xp = x[None], xp[None]
    elif bad == "float16":
        x, xp, err = x.half(), xp.half(), TypeError
    elif bad == "shape":
        xp = xp[:, :8].contiguous()
    elif bad == "dtype":
        xp = xp.to(torch.bfloat16)
    elif bad == "noncontiguous":
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "empty":
        x, xp = x[:, :0], xp[:, :0]
    with pytest.raises(err):
        saliency_delta(x, xp)


# ---------------------------------------------------------------------------
# linear_blend (B6)
# ---------------------------------------------------------------------------

def _blend_inputs(m, d, f, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = _round((0.5 * rng.standard_normal((m, d))).astype(np.float32), dtype)
    w = (0.05 * rng.standard_normal((d, f))).astype(np.float32)
    b = rng.standard_normal((f,)).astype(np.float32)
    prev = _round(rng.standard_normal((m, f)).astype(np.float32), dtype)
    return x, w, b, prev


@pytest.mark.parametrize("m,d,f", [(128, 256, 256), (256, 512, 256),
                                   (128, 768, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gamma", [0.5, 1.0])
def test_linear_blend_plain_matches_reference(m, d, f, dtype, gamma):
    x, w, b, prev = _blend_inputs(m, d, f, dtype)
    jin = (_jax(x, dtype), jnp.asarray(w), jnp.asarray(b), _jax(prev, dtype))
    j_kernel = jops.linear_blend(*jin, gamma=gamma, bm=128, bf=128, bk=128,
                                 interpret=True)
    j_plain = jref.linear_blend(*jin, gamma)
    out = tref.linear_blend(_torch(x, dtype), torch.from_numpy(w),
                            torch.from_numpy(b), _torch(prev, dtype), gamma)
    assert out.shape == (m, f)
    assert out.dtype == (torch.bfloat16 if dtype == "bfloat16"
                         else torch.float32)
    tol = TOL[dtype]
    for j_out in (j_kernel, j_plain):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(j_out, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_blend_at_gamma_one_is_apply_linear(dtype):
    """The callers' form (l2c's replaced layers, fastcache's bypass): the
    wrapper at gamma = 1 on the (B*N, D) view gives apply_linear's bits."""
    rng = np.random.default_rng(3)
    bsz, n, d = 3, 16, 32
    x = torch.from_numpy(rng.standard_normal((bsz, n, d)).astype(
        np.float32)).to(dtype)
    w = torch.from_numpy((np.eye(d) + 0.05 * rng.standard_normal(
        (d, d))).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.standard_normal(d)).astype(np.float32))
    flat = x.reshape(bsz * n, d)
    got = linear_blend(flat, w, b, flat, gamma=1.0).reshape(bsz, n, d)
    assert torch.equal(got, linear_approx.apply_linear(w, b, x))


def test_linear_blend_wrapper_sends_cpu_tensors_to_plain_version():
    x, w, b, prev = (torch.from_numpy(a)
                     for a in _blend_inputs(8, 16, 12, "float32"))
    before = linear_blend.launches
    for gamma in (0.5, 1.0):
        assert torch.equal(linear_blend(x, w, b, prev, gamma=gamma),
                           tref.linear_blend(x, w, b, prev, gamma))
    assert linear_blend.launches == before


@pytest.mark.parametrize("bad", ["rank3", "float16", "w_dtype", "w_rows",
                                 "b_shape", "prev_shape", "prev_dtype",
                                 "noncontiguous", "empty"])
def test_linear_blend_wrapper_rejects_bad_inputs(bad):
    x, w, b, prev = (torch.from_numpy(a)
                     for a in _blend_inputs(8, 16, 12, "float32"))
    err = ValueError
    if bad == "rank3":
        x = x[None]
    elif bad == "float16":
        x, prev, err = x.half(), prev.half(), TypeError
    elif bad == "w_dtype":
        w = w.to(torch.bfloat16)
    elif bad == "w_rows":
        w = w[:8].contiguous()
    elif bad == "b_shape":
        b = b[:4]
    elif bad == "prev_shape":
        prev = prev[:, :4].contiguous()
    elif bad == "prev_dtype":
        prev = prev.to(torch.bfloat16)
    elif bad == "noncontiguous":
        w = w.t().contiguous().t()
    elif bad == "empty":
        x, prev = x[:0], prev[:0]
    with pytest.raises(err):
        linear_blend(x, w, b, prev, gamma=0.5)
