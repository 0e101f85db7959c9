"""The port's SSM mixers (``models/mamba.py``, ``models/ssm.py``) and
``common.causal_conv1d`` against the live reference (``repro.models.mamba``,
``repro.models.ssm``, ``repro.models.common``), on inputs drawn with numpy
import tests.torch_threads  # noqa: F401  (first: one thread)
from fixed seeds.

Parameters are the reference's ``init_params`` of each mixer's ParamDefs at
the reduced configs (jamba-v0.1-52b's Mamba: d 256, d_inner 512, d_state 8,
dt_rank 16, conv 4; xlstm-1.3b's mLSTM: inner 512 in 2 heads of 256, conv
4, chunk 16, and sLSTM: 2 heads of 128), copied into the port's
``ParamGroup``.  The activations are scaled up (x 4) so the gates leave
their linear range.

Tolerances: f32 rtol/atol 1e-4 (other summation orders: the doubling scan
against ``lax.associative_scan``, torch's matmuls against XLA's); the
chunkwise mLSTM against the reference's recurrence at the reference's own
atol 1e-5; bf16 rtol 5e-2 and atol 5e-2 of the compared tensor's scale.
The decode steps run the port's in-place state update (the mLSTM's
``baddbmm_`` on C) from the prefill's state, fed the same tokens on both
sides; states are compared raw and, for the mLSTM, also as C·exp(m), as
the reference's own test compares them (``tests/test_ssm_oracles.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import common as jcommon
from repro.models import mamba as jmamba
from repro.models import ssm as jssm
from repro.models.params import init_params
from repro_torch import bridge
from repro_torch.configs import get_reduced
from repro_torch.models import common, mamba, ssm
from repro_torch.models.layers import ParamGroup
from tests.test_torch_transformer import Tol, assert_close

F32_TOL = Tol(1e-4, 1e-4, False)
BF16_TOL = Tol(5e-2, 5e-2, True)
TOLS = {"float32": F32_TOL, "bfloat16": BF16_TOL}
DTYPES = ("float32", "bfloat16")
JAMBA, XLSTM = "jamba-v0.1-52b", "xlstm-1.3b"
# mixer kind -> (arch, reference defs, reference state defs, reference
# apply, port defs, port apply)
MIXERS = {
    "mamba": (JAMBA, jmamba.mamba_defs, jmamba.mamba_state_defs,
              jmamba.mamba_apply, mamba.mamba_defs, mamba.mamba_apply),
    "mlstm": (XLSTM, jssm.mlstm_defs, jssm.mlstm_state_defs,
              jssm.mlstm_apply, ssm.mlstm_defs, ssm.mlstm_apply),
    "slstm": (XLSTM, jssm.slstm_defs, jssm.slstm_state_defs,
              jssm.slstm_apply, ssm.slstm_defs, ssm.slstm_apply),
}


def rng_normal(shape, seed: int, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def t32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def jx(a: np.ndarray, dtype: str = "float32"):
    return jnp.asarray(a).astype(jnp.dtype(dtype))


def tx(a: np.ndarray, dtype: str = "float32") -> torch.Tensor:
    return torch.from_numpy(a).to(getattr(torch, dtype))


def mixer_pair(kind: str, dtype: str, seed: int = 0):
    """(cfg, reference params, the port's ParamGroup) of one mixer."""
    arch, jdefs, _, _, tdefs, _ = MIXERS[kind]
    jcfg = jget_reduced(arch).replace(dtype=dtype)
    jp = init_params(jdefs(jcfg), jax.random.PRNGKey(seed), dtype)
    cfg = get_reduced(arch).replace(dtype=dtype)
    group = ParamGroup(tdefs(cfg), getattr(torch, dtype),
                       torch.device("cpu"))
    for name, a in jax.tree.map(np.asarray, jp).items():
        getattr(group, name).copy_(bridge.tensor_from_numpy(a, "cpu"))
    return jcfg, cfg, jp, group


# --------------------------------------------------------------------------
# causal_conv1d
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_state", [False, True], ids=["pad", "state"])
def test_causal_conv1d(dtype, with_state):
    """Prefill (zero pad in x's dtype) and decode (the f32 state cast to
    x's dtype), over several lengths."""
    for s in (1, 3, 9):
        x = rng_normal((2, s, 24), 1 + s)
        w = rng_normal((4, 24), 2, 0.5)
        st = rng_normal((2, 3, 24), 3) if with_state else None
        want = jcommon.causal_conv1d(jx(x, dtype), jx(w, dtype),
                                     None if st is None else jx(st))
        got = common.causal_conv1d(tx(x, dtype), tx(w, dtype),
                                   None if st is None else tx(st))
        assert got.dtype == getattr(torch, dtype)
        assert_close(got, want, TOLS[dtype])


# --------------------------------------------------------------------------
# Mamba
# --------------------------------------------------------------------------

@pytest.mark.parametrize("length", [1, 5, 12, 16, 33])
def test_mamba_chunk_scan(length):
    """The doubling scan against ``lax.associative_scan`` (and a plain
    loop), at lengths that are and are not powers of two."""
    b, di, ds = 2, 8, 4
    da = 1 / (1 + np.exp(-rng_normal((b, length, di, ds), 10))) * 0.9
    dbx = rng_normal((b, length, di, ds), 11, 0.1)
    c = rng_normal((b, length, ds), 12)
    h0 = rng_normal((b, di, ds), 13)
    y_j, h_j = jmamba._chunk_scan(jx(da), jx(dbx), jx(c), jx(h0))
    y_t, h_t = mamba._chunk_scan(t32(da), t32(dbx), t32(c), t32(h0))
    assert_close(y_t, y_j, F32_TOL)
    assert_close(h_t, h_j, F32_TOL)
    h = h0.astype(np.float64)
    for t in range(length):
        h = da[:, t] * h + dbx[:, t]
    np.testing.assert_allclose(h_t.numpy(), h, rtol=1e-4, atol=1e-5)


def test_mamba_ssm_params():
    jcfg, cfg, jp, p = mixer_pair("mamba", "float32")
    xc = rng_normal((2, 6, 512), 14)
    for got, want in zip(mamba._ssm_params(p, t32(xc), cfg),
                         jmamba._ssm_params(jp, jx(xc), jcfg)):
        assert_close(got, want, F32_TOL)


def _prefill_then_decode(kind, dtype, s, steps, seed, **kw):
    """The mixer over s positions from a zero state, then ``steps`` decode
    steps from the state it leaves, on both sides: every output and the
    final state."""
    _, _, _, japply, _, tapply = MIXERS[kind]
    jcfg, cfg, jp, p = mixer_pair(kind, dtype)
    tol = TOLS[dtype]
    x = rng_normal((2, s + steps, cfg.d_model), seed, 4.0)
    y_j, st_j = japply(jp, jx(x[:, :s], dtype), cfg=jcfg, **kw)
    y_t, st_t = tapply(p, tx(x[:, :s], dtype), cfg=cfg, **kw)
    assert y_t.dtype == getattr(torch, dtype)
    assert_close(y_t, y_j, tol)
    assert set(st_t) == set(st_j)
    for key in st_j:
        assert st_t[key].dtype == torch.float32
        assert_close(st_t[key], st_j[key], tol)
    st_t = {k: v.clone() for k, v in st_t.items()}     # the cache's leaves
    held = {k: v.data_ptr() for k, v in st_t.items()}
    for i in range(s, s + steps):
        y_j, st_j = japply(jp, jx(x[:, i:i + 1], dtype), cfg=jcfg,
                           state=st_j, decode=True)
        y_t, st_t = tapply(p, tx(x[:, i:i + 1], dtype), cfg=cfg,
                           state=st_t, decode=True)
        assert_close(y_t, y_j, tol)
    assert {k: v.data_ptr() for k, v in st_t.items()} == held   # in place
    for key in st_j:
        assert_close(st_t[key], st_j[key], tol)
    return st_t, st_j


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,chunk", [(24, 256), (24, 8), (20, 8)],
                         ids=["one-chunk", "3-chunks", "divisor-5"])
def test_mamba_apply_prefill_and_decode(dtype, s, chunk):
    """``mamba_apply`` over a prompt (one chunk; three; 20 at chunk 8, so
    the largest divisor 5) and 4 decode steps from its state."""
    _prefill_then_decode("mamba", dtype, s, 4, 20, chunk=chunk)


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------

def _mlstm_inputs(b, s, h, dh, seed):
    q, k, v = (rng_normal((b, s, h, dh), seed + i) for i in range(3))
    li = rng_normal((b, s, h), seed + 3, 0.5)
    lf = -np.log1p(np.exp(-(rng_normal((b, s, h), seed + 4) + 2.0)))
    return q, k, v, li, lf.astype(np.float32)


def _zero_state(b, h, dh, lib):
    zeros = jnp.zeros if lib is jnp else torch.zeros
    return (zeros((b, h, dh, dh)), zeros((b, h, dh)), zeros((b, h)))


@pytest.mark.parametrize("chunk", [1, 3, 4, 12])
def test_mlstm_sequence(chunk):
    """Chunkwise mLSTM at the reference test's chunks: outputs and final
    state against the reference's, outputs at its own 1e-5."""
    b, s, h, dh = 2, 12, 2, 8
    ins = _mlstm_inputs(b, s, h, dh, 30)
    hs_j, st_j = jssm.mlstm_sequence(*map(jx, ins), _zero_state(b, h, dh, jnp),
                                     chunk)
    hs_t, st_t = ssm.mlstm_sequence(*map(t32, ins),
                                    _zero_state(b, h, dh, torch), chunk)
    np.testing.assert_allclose(hs_t.numpy(), np.asarray(hs_j), atol=1e-5)
    for got, want in zip(st_t, st_j):
        assert_close(got, want, F32_TOL)


def test_mlstm_step():
    """Eight recurrent steps from the chunkwise state of 8 positions, on
    both sides; the port's step updates the given tensors in place.  States
    raw and as C·exp(m)."""
    b, s, h, dh = 2, 16, 2, 8
    ins = _mlstm_inputs(b, s, h, dh, 40)
    first = [a[:, :8] for a in ins]
    _, st_j = jssm.mlstm_sequence(*map(jx, first), _zero_state(b, h, dh, jnp),
                                  4)
    _, st_t = ssm.mlstm_sequence(*map(t32, first),
                                 _zero_state(b, h, dh, torch), 4)
    st_t = tuple(t.clone() for t in st_t)
    ptrs = [t.data_ptr() for t in st_t]
    for t in range(8, s):
        step = [a[:, t] for a in ins]
        o_j, st_j = jssm.mlstm_step(*map(jx, step), st_j)
        o_t, st_t = ssm.mlstm_step(*map(t32, step), st_t)
        assert_close(o_t, o_j, F32_TOL)
    assert [t.data_ptr() for t in st_t] == ptrs
    for got, want in zip(st_t, st_j):
        assert_close(got, want, F32_TOL)
    unstab = st_t[0] * torch.exp(st_t[2])[..., None, None]
    assert_close(unstab, st_j[0] * jnp.exp(st_j[2])[..., None, None],
                 Tol(1e-4, 1e-4, True))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [32, 24, 7], ids=["2-chunks", "divisor-12",
                                                "prime"])
def test_mlstm_apply_prefill_and_decode(dtype, s):
    """``mlstm_apply`` over a prompt (chunk 16: two chunks; 24 -> chunks of
    12; 7 -> chunks of 7) and 4 in-place decode steps from its state."""
    st_t, st_j = _prefill_then_decode("mlstm", dtype, s, 4, 50)
    unstab = st_t["C"] * torch.exp(st_t["m"])[..., None, None]
    assert_close(unstab, st_j["C"] * jnp.exp(st_j["m"])[..., None, None],
                 Tol(TOLS[dtype].rtol, TOLS[dtype].atol, True))


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_slstm_apply_prefill_and_decode(dtype):
    """``slstm_apply`` over 10 positions token by token and 4 decode steps
    from its state, against the reference."""
    _prefill_then_decode("slstm", dtype, 10, 4, 60)


def test_slstm_sequence_matches_steps():
    """The port's sequence scan equals its own decode steps (the reference
    test's check, ``test_ssm_oracles.py``), at its 1e-4."""
    _, cfg, _, p = mixer_pair("slstm", "float32")
    x = t32(rng_normal((2, 6, cfg.d_model), 61))
    out_seq, st_seq = ssm.slstm_apply(p, x, cfg=cfg)
    st = {k: torch.zeros_like(v) for k, v in st_seq.items()}
    outs = [ssm.slstm_apply(p, x[:, t:t + 1], cfg=cfg, state=st,
                            decode=True)[0] for t in range(6)]
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), out_seq.numpy(),
                               atol=1e-4)
    for k in ("c", "n", "m", "h"):
        np.testing.assert_allclose(st[k].numpy(), st_seq[k].numpy(),
                                   atol=1e-4)


def test_slstm_gate_order_is_per_head():
    """The gates z, i, f, o are split per head (``xw.reshape(b, H,
    4 dh)``): a bias on head 1's forget slot moves head 1's state only."""
    _, cfg, _, p = mixer_pair("slstm", "float32")
    x = t32(rng_normal((1, 3, cfg.d_model), 62))
    _, base = ssm.slstm_apply(p, x, cfg=cfg)
    dh = cfg.d_model // cfg.num_heads
    p.b_gates[4 * dh + 2 * dh:4 * dh + 3 * dh] += 3.0   # head 1, f
    _, moved = ssm.slstm_apply(p, x, cfg=cfg)
    assert torch.equal(moved["c"][:, 0], base["c"][:, 0])
    assert not torch.equal(moved["c"][:, 1], base["c"][:, 1])


def test_state_defs_match_the_references():
    """Every mixer's decode state: the reference's leaves and shapes, f32."""
    for kind, (arch, _, jstate, _, _, _) in MIXERS.items():
        jdefs = jstate(jget_reduced(arch), 3)
        tdefs = {"mamba": mamba.mamba_state_defs,
                 "mlstm": ssm.mlstm_state_defs,
                 "slstm": ssm.slstm_state_defs}[kind](get_reduced(arch), 3)
        assert set(tdefs) == set(jdefs), kind
        for name, d in jdefs.items():
            assert tdefs[name].shape == d.shape, (kind, name)
            assert tdefs[name].dtype == d.dtype == "float32", (kind, name)
