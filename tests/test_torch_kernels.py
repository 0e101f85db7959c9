"""The port's ``fused_gate`` against the reference's, on the same inputs.

Inputs are drawn with numpy and handed to the reference's Pallas kernel (in
interpret mode), its pure-jnp twin and the port's plain PyTorch version.
Tolerances: f32 rtol/atol 1e-5 (two f32 implementations, different
summation order); bf16 5e-2 (the reference's own in test_kernels.py: the
output is rounded to bf16); gate bits exact.  sigma2 is set per sample from
the float64 statistic so that each gate decision sits a factor 2 from the
threshold.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import statcache as jstatcache
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.cuda_kernels import ref as tref
from repro_torch.cuda_kernels.fused_gate import fused_gate

# per-sample role: moved (large diff, no gate) / gates / stat above the
# threshold / would gate but ineligible
ROLES = ("moved", "gate", "above", "ineligible")


def _inputs(b, c, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    roles = ("gate",) if b == 1 else ROLES[:b]
    x = rng.standard_normal((b, c, d)).astype(np.float32)
    prev = (x + 0.01 * rng.standard_normal((b, c, d))).astype(np.float32)
    if "moved" in roles:
        prev[roles.index("moved")] += 5.0
    po = rng.standard_normal((b, c, d)).astype(np.float32)
    w = (np.eye(d) + 0.01 * rng.standard_normal((d, d))).astype(np.float32)
    bias = (0.1 * rng.standard_normal((d,))).astype(np.float32)
    if dtype == "bfloat16":    # round once; both frameworks round to nearest even
        x, prev, po = (np.asarray(jnp.asarray(a, jnp.bfloat16).astype(
            jnp.float32)) for a in (x, prev, po))
    nd = c * d
    thr = jstatcache.make_threshold(0.05, nd)
    diff = ((x.astype(np.float64) - prev) ** 2).sum(axis=(1, 2))
    base = diff / (nd * thr)                     # sigma2 putting stat on thr
    factor = {"moved": 1e-3, "gate": 2.0, "above": 0.5, "ineligible": 2.0}
    sigma2 = np.array([base[i] * factor[r] for i, r in enumerate(roles)],
                      np.float32)
    eligible = np.array([r != "ineligible" for r in roles])
    expect_gate = np.array([r == "gate" for r in roles])
    return x, prev, po, w, bias, sigma2, eligible, thr, expect_gate


def _torch(a, dtype):
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _jax(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else None)


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("c", [8, 32])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_blend", [True, False])
def test_fused_gate_plain_matches_reference(b, c, d, dtype, use_blend):
    x, prev, po, w, bias, sigma2, elig, thr, expect = _inputs(b, c, d, dtype)
    kw = dict(threshold=thr, gamma=0.5, use_blend=use_blend)
    jin = (_jax(x, dtype), _jax(prev, dtype), _jax(po, dtype),
           jnp.asarray(w), jnp.asarray(bias), jnp.asarray(sigma2),
           jnp.asarray(elig))
    j_kernel = jops.fused_gate(*jin, interpret=True, **kw)
    j_plain = jref.fused_gate(*jin, **kw)
    out, gate, diff, prevsq = tref.fused_gate(
        _torch(x, dtype), _torch(prev, dtype), _torch(po, dtype),
        torch.from_numpy(w), torch.from_numpy(bias),
        torch.from_numpy(sigma2), torch.from_numpy(elig), **kw)
    assert out.dtype == (torch.bfloat16 if dtype == "bfloat16"
                         else torch.float32)
    np.testing.assert_array_equal(gate.numpy(), expect)
    tol = 1e-5 if dtype == "float32" else 5e-2
    for j_out, j_gate, j_diff, j_prev in (j_kernel, j_plain):
        np.testing.assert_array_equal(gate.numpy(), np.asarray(j_gate))
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(j_out, np.float32),
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(diff.numpy(), np.asarray(j_diff),
                                   rtol=1e-5)
        np.testing.assert_allclose(prevsq.numpy(), np.asarray(j_prev),
                                   rtol=1e-5)


def _cpu_args(dtype=torch.float32, b=2, c=8, d=16):
    x, prev, po, w, bias, sigma2, elig, thr, _ = _inputs(b, c, d, "float32")
    return ((torch.from_numpy(x).to(dtype), torch.from_numpy(prev).to(dtype),
             torch.from_numpy(po).to(dtype), torch.from_numpy(w),
             torch.from_numpy(bias), torch.from_numpy(sigma2),
             torch.from_numpy(elig)), thr)


def test_wrapper_sends_cpu_tensors_to_plain_version():
    args, thr = _cpu_args()
    before = fused_gate.launches
    got = fused_gate(*args, threshold=thr)
    want = tref.fused_gate(*args, threshold=thr)
    assert fused_gate.launches == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_wrapper_rejects_bad_dtype():
    args, thr = _cpu_args(dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_gate(*args, threshold=thr)


@pytest.mark.parametrize("bad", ["w_shape", "w_dtype", "prev_shape",
                                 "sigma_shape", "eligible_dtype", "rank",
                                 "noncontiguous"])
def test_wrapper_rejects_bad_inputs(bad):
    (x, prev, po, w, bias, sig, elig), thr = _cpu_args()
    if bad == "w_shape":
        w = w[:, :8].contiguous()
    elif bad == "w_dtype":
        w = w.to(torch.bfloat16)
    elif bad == "prev_shape":
        prev = prev[:, :4].contiguous()
    elif bad == "sigma_shape":
        sig = sig[:1]
    elif bad == "eligible_dtype":
        elig = elig.to(torch.float32)
    elif bad == "rank":
        x = x.reshape(-1, x.shape[-1])
    elif bad == "noncontiguous":
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError):
        fused_gate(x, prev, po, w, bias, sig, elig, threshold=thr)
