"""The port's MoE layer (``repro_torch.models.layers.moe_apply`` /
``moe_gather_apply``) against the reference's, on the reduced arctic-480b
(4 experts of 512, top-2, a parallel dense FFN of 512) and kimi-k2-1t-a32b
(4 experts of 256, top-2, one shared expert), with the reference's
parameters (``init_params(moe_defs(cfg), PRNGKey(0))``) and inputs drawn by
numpy.

Cases: ``ample`` (``f32_cfg``'s capacity factor 8: no copy dropped),
``overflow`` (capacity factor 0.1, min capacity 1: 3 slots an expert for
128 copies, most dropped) and ``uniform`` (the router zeroed: every
probability ties, so the reference's ``lax.top_k`` takes experts 0 and 1
for every token and the port's stable sort must too).  Tolerances: f32
rtol/atol 1e-4 on outputs and aux (two f32 implementations, other
summation orders; measured <= 2.7e-6); bf16 5e-2 of the output's scale,
the reference's own; the experts chosen (``top_i``) exact in both.
"""
import tests.torch_threads  # noqa: F401  (first: one thread)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import common as jcommon
from repro.models import layers as jlayers
from repro.models.params import init_params
from repro_torch.configs import get_reduced
from repro_torch.models import flags, layers
from tests.conftest import f32_cfg

MOE_ARCHS = ("arctic-480b", "kimi-k2-1t-a32b")
CASES = ("ample", "overflow", "uniform")
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def configs(arch: str, case: str, dtype: str = "float32"):
    """(reference cfg, port cfg) of the case."""
    out = []
    for get in (jget_reduced, get_reduced):
        cfg = f32_cfg(get(arch), big_capacity=case != "overflow")
        if case == "overflow":
            cfg = cfg.replace(moe=dataclasses.replace(
                cfg.moe, capacity_factor=0.1, min_capacity=1))
        out.append(cfg.replace(dtype=dtype))
    return out


def moe_pair(arch: str, case: str, dtype: str = "float32"):
    """(reference cfg, reference params, port cfg, port ParamGroup)."""
    jcfg, cfg = configs(arch, case, dtype)
    jp = dict(init_params(jlayers.moe_defs(jcfg), jax.random.PRNGKey(0),
                          dtype))
    if case == "uniform":
        jp["router"] = jnp.zeros_like(jp["router"])
    group = layers.ParamGroup(layers.moe_defs(cfg), getattr(torch, dtype),
                              torch.device("cpu"))
    for name, a in jp.items():
        a = np.asarray(a, np.float32)
        getattr(group, name).copy_(torch.from_numpy(a.copy()))
    return jcfg, jp, cfg, group


def inputs(shape, dtype: str, seed: int = 1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))


def reference_top_i(jp, jx, jcfg) -> np.ndarray:
    """The reference's expert choices, its own ops (``moe_apply``'s)."""
    d = jx.shape[-1]
    h = jcommon.rms_norm(jx, jp["norm"], jcfg.norm_eps).reshape(-1, d)
    probs = jax.nn.softmax(jnp.matmul(h.astype(jnp.float32), jp["router"]),
                           axis=-1)
    return np.asarray(jax.lax.top_k(probs, jcfg.moe.top_k)[1])


def port_top_i(group, x, cfg) -> np.ndarray:
    h = layers.common.rms_norm(x, group.norm, cfg.norm_eps)
    return layers._route(group, h.reshape(-1, x.shape[-1]),
                         cfg.moe.top_k)[2].numpy()


def check(got, want, dtype: str) -> None:
    want = np.asarray(want, np.float32)
    tol = TOL[dtype]
    atol = tol if dtype == "float32" else tol * max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_reference(arch, case, dtype):
    jcfg, jp, cfg, group = moe_pair(arch, case, dtype)
    jx, x = inputs((2, 32, cfg.d_model), dtype)
    want_i = reference_top_i(jp, jx, jcfg)
    got_i = port_top_i(group, x, cfg)
    assert np.array_equal(got_i, want_i)
    if case == "uniform":
        assert (want_i == np.array([0, 1])).all()
    yj, aj = jlayers.moe_apply(jp, jx, jcfg)
    yt, at = layers.moe_apply(group, x, cfg)
    assert yt.dtype == x.dtype and yt.shape == x.shape
    check(yt, yj, dtype)
    check(at, aj, "float32" if dtype == "float32" else dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_gather_apply_matches_reference(arch, dtype):
    """Decode shapes: 2 tokens x top-2 <= 4 experts."""
    jcfg, jp, cfg, group = moe_pair(arch, "ample", dtype)
    jx, x = inputs((2, 1, cfg.d_model), dtype, seed=2)
    assert np.array_equal(port_top_i(group, x, cfg),
                          reference_top_i(jp, jx, jcfg))
    yj, aj = jlayers.moe_gather_apply(jp, jx, jcfg)
    yt, at = layers.moe_gather_apply(group, x, cfg)
    check(yt, yj, dtype)
    check(at, aj, dtype)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_capacity_and_gather_paths_agree_at_decode(arch, monkeypatch):
    """At T * k <= E and capacity min_capacity (no copy dropped) the two
    paths compute the same function; ``MOE_GATHER_DECODE`` picks the
    gather path there, as the reference's flag does, and only there."""
    _, _, cfg, group = moe_pair(arch, "ample")
    _, x = inputs((2, 1, cfg.d_model), "float32", seed=3)
    assert layers.moe_capacity(cfg.moe, 2) * cfg.moe.num_experts >= 4
    y_cap, a_cap = layers.moe_apply(group, x, cfg)
    y_gat, a_gat = layers.moe_gather_apply(group, x, cfg)
    check(y_cap, y_gat.numpy(), "float32")
    check(a_cap, a_gat.numpy(), "float32")
    monkeypatch.setattr(flags, "MOE_GATHER_DECODE", True)
    calls = []
    real = layers.moe_gather_apply
    monkeypatch.setattr(layers, "moe_gather_apply",
                        lambda *a: calls.append(1) or real(*a))
    layers.moe_apply(group, x, cfg)
    assert calls == [1]
    _, x_long = inputs((2, 8, cfg.d_model), "float32", seed=4)
    layers.moe_apply(group, x_long, cfg)            # T * k > E: capacity
    assert calls == [1]


def _kept_by_rule(top_i: np.ndarray, cap: int) -> np.ndarray:
    """The copies (token, choice), in that flat order, that keep a slot:
    the first ``cap`` of each expert's copies in flat order (plain
    numpy)."""
    flat = top_i.reshape(-1)
    kept = np.zeros(flat.shape, bool)
    seen = {}
    for i, e in enumerate(flat):
        kept[i] = seen.get(e, 0) < cap
        seen[e] = seen.get(e, 0) + 1
    return kept


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_overflow_keeps_the_earliest_copies(arch):
    """With 3 slots an expert, the output equals the reference's only if
    the same copies are kept: check the rule itself too, by zeroing every
    expert weight but one expert's and reading which tokens it served."""
    jcfg, jp, cfg, group = moe_pair(arch, "overflow")
    _, x = inputs((2, 32, cfg.d_model), "float32")
    cap = layers.moe_capacity(cfg.moe, 64)
    assert cap == 3
    top_i = port_top_i(group, x, cfg)
    kept = _kept_by_rule(top_i, cap)
    assert 0 < kept.sum() < kept.size                 # some copies dropped
    e0 = int(top_i[0, 0])
    mask = torch.zeros(cfg.moe.num_experts, 1, 1)
    mask[e0] = 1.0
    for name in ("we_gate", "we_up", "we_down"):
        getattr(group, name).mul_(mask)
    for name in ("wd_gate", "ws_gate"):
        if name in group.defs:
            getattr(group, name).zero_()
    y, _ = layers.moe_apply(group, x, cfg)
    served = (y - x).reshape(64, -1).abs().sum(-1) > 0
    want = np.zeros(64, bool)
    for i, (t, e) in enumerate(np.ndindex(*top_i.shape)):
        if top_i[t, e] == e0 and kept[i]:
            want[t] = True
    assert want.sum() == cap
    assert np.array_equal(served.numpy(), want)


def test_capacity_formula_is_the_references():
    from repro.configs.base import MoEConfig as JMoEConfig
    from repro_torch.configs.base import MoEConfig
    for kw in (dict(num_experts=8, top_k=2, d_ff_expert=64),
               dict(num_experts=128, top_k=2, d_ff_expert=4864),
               dict(num_experts=384, top_k=8, d_ff_expert=2048,
                    capacity_factor=1.0, min_capacity=2)):
        for tokens in (1, 4, 8, 512, 1024):
            assert layers.moe_capacity(MoEConfig(**kw), tokens) == \
                jlayers.moe_capacity(JMoEConfig(**kw), tokens)
    assert dataclasses.asdict(MoEConfig(4, 2, 8)) == dataclasses.asdict(
        JMoEConfig(4, 2, 8))


def test_moe_defs_raise_without_moe():
    cfg = get_reduced("qwen3-0.6b")
    with pytest.raises(ValueError, match="cfg.moe is None"):
        layers.moe_defs(cfg)
