"""The port's ``flash_attention`` plain twin against the reference's Pallas
kernel (interpret mode) and its pure-jnp twin, on the same inputs, and the
wrapper's dispatch and input checks on the CPU.

Inputs are drawn with numpy and handed to both frameworks (bf16 rounded
once, to nearest even, in both).  Tolerances are the reference's own
(``tests/test_kernels.py:106``): rtol/atol 2e-5 in f32 (two f32
implementations, other summation orders), 2e-2 in bf16 (the output is
rounded to bf16).  The grid is ``tests/test_kernels.py``'s: MHA, GQA and
Sq < Skv, each causal, windowed and bidirectional, plus the head dims 80
(StableLM-3B) and 112 (Kimi-K2), which the card runs on its 128 instance.  The Pallas kernel needs
lengths that divide its blocks, so a ragged length is held against the jnp
twin only.
"""
import tests.torch_threads  # noqa: F401  (first: one thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.cuda_kernels import ref as tref
from repro_torch.cuda_kernels import flash_attention as fa_mod
from repro_torch.cuda_kernels.flash_attention import flash_attention

GRID = [(1, 4, 4, 128, 128, 64),     # MHA square
        (2, 8, 2, 128, 128, 64),     # GQA
        (1, 4, 1, 64, 256, 32),      # cross / decode-ish (Sq < Skv)
        (1, 4, 4, 128, 128, 80),     # StableLM-3B's head dim (MHA)
        (1, 8, 1, 128, 128, 112)]    # Kimi-K2's head dim (GQA 8:1)
MASKS = [(True, 0), (True, 96), (False, 0)]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(b, h, kvh, sq, skv, dh, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, sq, dh), (b, kvh, skv, dh), (b, kvh, skv, dh))]
    if dtype == "bfloat16":
        arrs = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                for a in arrs]
    jx = [jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else None)
          for a in arrs]
    tt = [torch.from_numpy(np.array(a)).to(getattr(torch, dtype)) for a in arrs]
    return jx, tt


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("b,h,kvh,sq,skv,dh", GRID)
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_twin_matches_reference(b, h, kvh, sq, skv, dh, causal, window,
                                      dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(b, h, kvh, sq, skv, dh, dtype)
    got = tref.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    kernel = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                  bq=64, bk=64, interpret=True)
    oracle = jref.flash_attention(jq, jk, jv, causal=causal, window=window)
    _close(got, kernel, TOL[dtype])
    _close(got, oracle, TOL[dtype])


@pytest.mark.parametrize("sq,skv", [(100, 100), (37, 141)])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_twin_ragged_lengths(sq, skv, causal, window, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(2, 4, 2, sq, skv, 64, dtype, seed=1)
    got = tref.flash_attention(tq, tk, tv, causal=causal, window=window)
    oracle = jref.flash_attention(jq, jk, jv, causal=causal, window=window)
    _close(got, oracle, TOL[dtype])


def test_wrapper_sends_cpu_tensors_to_the_plain_twin():
    _, (tq, tk, tv) = _inputs(2, 8, 2, 64, 96, 64, "float32", seed=2)
    before = flash_attention.launches
    got = flash_attention(tq, tk, tv, causal=True, window=40)
    assert flash_attention.launches == before == 0
    want = tref.flash_attention(tq, tk, tv, causal=True, window=40)
    assert torch.equal(got, want)
    # strided (B, S, H, dh) views, as models/attention.py passes them
    got_t = flash_attention(tq.transpose(1, 2).contiguous().transpose(1, 2),
                            tk, tv, causal=True, window=40)
    assert torch.equal(got_t, want)


@pytest.mark.parametrize("case,exc", [
    ("dtype", TypeError), ("mixed_dtype", TypeError), ("rank", ValueError),
    ("heads", ValueError), ("head_dim", ValueError), ("long_q", ValueError),
    ("batch", ValueError), ("empty", ValueError)])
def test_wrapper_rejects_bad_inputs(case, exc):
    _, (q, k, v) = _inputs(2, 4, 2, 16, 32, 64, "float32", seed=3)
    if case == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "mixed_dtype":
        k = k.to(torch.bfloat16)
    elif case == "rank":
        q = q[0]
    elif case == "heads":
        k, v = k.repeat(1, 2, 1, 1)[:, :3], v.repeat(1, 2, 1, 1)[:, :3]
    elif case == "head_dim":
        q = q[..., :32]
    elif case == "long_q":
        q = q.repeat(1, 1, 3, 1)
    elif case == "batch":
        k, v = k[:1], v[:1]
    elif case == "empty":
        q = q[:, :, :0]
    with pytest.raises(exc):
        flash_attention(q, k, v, causal=True)
    assert flash_attention.launches == 0


@pytest.mark.parametrize("dtype,shape,raises", [
    (torch.bfloat16, (2, 2, 16, 64), True),    # zero batch and head strides
    (torch.bfloat16, (1, 2, 16, 64), True),    # zero head stride
    (torch.bfloat16, (1, 1, 16, 64), False),   # zero strides on extent 1 only
    (torch.float32, (2, 2, 16, 64), False)])   # the SIMT route reads them
def test_layout_check_refuses_broadcast_bf16(dtype, shape, raises):
    """The bf16 kernel's tensor maps take no zero stride along a dimension
    of extent > 1; the check runs on the host, before any launch."""
    t = torch.zeros(16 * 64, dtype=dtype).as_strided(shape, (0, 0, 64, 1))
    if raises:
        with pytest.raises(ValueError, match="broadcast"):
            fa_mod._check_layout(t, "k")
    else:
        fa_mod._check_layout(t, "k")


def test_head_dims_and_instances():
    """Every multiple of 16 up to 128 runs on the card, on the 64 instance
    up to 64 and on the 128 instance above; any other head dim raises (on
    the card, before a launch)."""
    assert fa_mod.HEAD_DIMS == (16, 32, 48, 64, 80, 96, 112, 128)
    assert [fa_mod.instance_dh(d) for d in (16, 48, 64, 80, 112, 128)] == [
        64, 64, 64, 128, 128, 128]
    for bad in (8, 40, 72, 120, 144, 256):
        with pytest.raises(ValueError, match="head_dim"):
            fa_mod.instance_dh(bad)
