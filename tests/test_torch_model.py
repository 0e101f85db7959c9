"""The port's DiT against the reference's, with the reference's parameters
copied through ``repro_torch.bridge``.

Two small configs: the reference's ``dit-smoke`` reduced config and a
3-layer, 96-wide DiT in the shape of ``benchmarks/common.py``, both in f32
with the adaLN modulation and output head un-zeroed (under adaLN-zero every
block is the identity and eps is 0).

Tolerances.  Embeddings and conditioning: f32 rtol/atol 1e-5 (same
arithmetic, another summation order).  Through a block: f32 rtol 1e-4,
atol 1e-3.  The reference's fan-in init draws ``wq``/``wk`` with std
1/sqrt(heads), so attention logits reach ~140 and the softmax turns a
1-ulp difference in LayerNorm into ~1e-4 absolute on outputs of size ~3
(relative L2 error stays below 3e-5).  bf16: 5e-2, the reference's own.

The helpers here are shared by the other ``test_torch_*`` files.
"""
import tests.torch_threads  # noqa: F401  (first: one thread)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.configs.base import DiTConfig as JDiTConfig
from repro.configs.dit import _dit as jdit
from repro.models import build_model
from repro_torch import bridge
from repro_torch.configs.base import DiTConfig, ModelConfig
from repro_torch.models.dit import DiTModel
from tests.conftest import f32_cfg

SMALL_CONFIGS = ("smoke", "bench3")
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BLOCK_TOL = dict(rtol=1e-4, atol=1e-3)


def jax_config(kind: str, dtype: str = "float32"):
    if kind == "smoke":
        cfg = f32_cfg(jget_reduced("dit-b2"))
    else:   # benchmarks/common.py's ladder shape: 3 layers, 96 wide, 4 heads
        cfg = jdit("bench-dit-s2", 3, 96, 4).replace(
            dit=JDiTConfig(patch_size=2, in_channels=4, num_classes=10,
                           image_size=16))
    return cfg.replace(dtype=dtype)


def jax_dit(kind: str, dtype: str = "float32", seed: int = 0):
    """(cfg, model, params) of the reference with un-zeroed weights, as
    ``benchmarks/common.py:build_dit`` makes them."""
    cfg = jax_config(kind, dtype)
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(seed))
    k = jax.random.PRNGKey(seed + 1)
    blocks = params["blocks"]
    blocks["ada_w"] = (0.05 * jax.random.normal(
        k, blocks["ada_w"].shape)).astype(blocks["ada_w"].dtype)
    blocks["ada_b"] = (0.2 * jax.random.normal(
        jax.random.fold_in(k, 1), blocks["ada_b"].shape)).astype(
        blocks["ada_b"].dtype)
    params["final_w"] = (jax.random.normal(
        jax.random.fold_in(k, 2), params["final_w"].shape)
        / cfg.d_model ** 0.5).astype(params["final_w"].dtype)
    return cfg, model, params


def port_config(jcfg) -> ModelConfig:
    return ModelConfig(
        name=jcfg.name, family=jcfg.family, num_layers=jcfg.num_layers,
        d_model=jcfg.d_model, num_heads=jcfg.num_heads, d_ff=jcfg.d_ff,
        head_dim=jcfg.head_dim,
        dit=DiTConfig(**dataclasses.asdict(jcfg.dit)), dtype=jcfg.dtype)


def port_dit(jcfg, jparams) -> DiTModel:
    model = DiTModel(port_config(jcfg), device="cpu")
    return bridge.params_from_jax(jax.tree.map(np.asarray, jparams), model)


def t32(a) -> torch.Tensor:
    """numpy / jax array -> CPU tensor (bf16 arrays keep their bits)."""
    return bridge.tensor_from_numpy(np.asarray(a), torch.device("cpu"))


def np32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def inputs(cfg, batch: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    img, ch = cfg.dit.image_size, cfg.dit.in_channels
    lat = rng.standard_normal((batch, img, img, ch)).astype(np.float32)
    t = rng.integers(0, 1000, size=(batch,)).astype(np.int32)
    labels = rng.integers(0, cfg.dit.num_classes + 1,
                          size=(batch,)).astype(np.int32)
    return lat, t, labels


@pytest.fixture(scope="module", params=SMALL_CONFIGS)
def pair(request):
    jcfg, jmodel, jparams = jax_dit(request.param)
    return jcfg, jmodel, jparams, port_dit(jcfg, jparams)


def test_apply_matches_reference(pair):
    jcfg, jmodel, jparams, model = pair
    lat, t, labels = inputs(jcfg, 3)
    want, _ = jmodel.apply(jparams, {"latents": jnp.asarray(lat),
                                     "t": jnp.asarray(t),
                                     "labels": jnp.asarray(labels)})
    got = model.apply(t32(lat), t32(t), t32(labels))
    assert got.shape == want.shape
    assert float(np.abs(np32(want)).max()) > 1e-2       # eps is not trivially 0
    np.testing.assert_allclose(np32(got), np32(want), **BLOCK_TOL)


def test_apply_matches_reference_bf16():
    jcfg, jmodel, jparams = jax_dit("smoke", dtype="bfloat16")
    model = port_dit(jcfg, jparams)
    lat, t, labels = inputs(jcfg, 2, seed=1)
    want, _ = jmodel.apply(jparams, {"latents": jnp.asarray(lat),
                                     "t": jnp.asarray(t),
                                     "labels": jnp.asarray(labels)})
    got = model.apply(t32(lat), t32(t), t32(labels))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(np32(got), np32(want), rtol=5e-2, atol=5e-2)


def test_tokens_in_matches_reference(pair):
    jcfg, jmodel, jparams, model = pair
    lat, _, _ = inputs(jcfg, 2, seed=2)
    np.testing.assert_allclose(
        np32(model.tokens_in(t32(lat))),
        np32(jmodel.tokens_in(jparams, jnp.asarray(lat))), **F32_TOL)


def test_conditioning_matches_reference(pair):
    jcfg, jmodel, jparams, model = pair
    _, t, labels = inputs(jcfg, 4, seed=3)
    np.testing.assert_allclose(
        np32(model.conditioning(t32(t), t32(labels))),
        np32(jmodel.conditioning(jparams, jnp.asarray(t),
                                 jnp.asarray(labels))), **F32_TOL)


def test_block_apply_matches_reference(pair):
    jcfg, jmodel, jparams, model = pair
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 24, jcfg.d_model)).astype(np.float32)
    c = rng.standard_normal((2, jcfg.d_model)).astype(np.float32)
    layer = jcfg.num_layers - 1
    bp = jax.tree.map(lambda a: a[layer], jparams["blocks"])
    want = jmodel.block_apply(bp, jnp.asarray(x), jnp.asarray(c))
    got = model.block_apply(model.blocks[layer], t32(x), t32(c))
    np.testing.assert_allclose(np32(got), np32(want), **BLOCK_TOL)


def test_model_defaults_to_cuda_and_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiTModel(port_config(jax_config("smoke")))


def test_init_unzeroes_modulation_and_head():
    model = DiTModel(port_config(jax_config("smoke")), device="cpu")
    model.init(torch.Generator("cpu").manual_seed(0))
    assert float(model.blocks[0].ada_w.abs().max()) > 0
    assert float(model.final_w.abs().max()) > 0
    lat, t, labels = inputs(model.cfg, 2)
    eps = model.apply(t32(lat), t32(t), t32(labels))
    assert torch.isfinite(eps).all() and float(eps.abs().max()) > 1e-3


def test_fc_params_bridge_matches_reference():
    from repro.core import linear_approx as jlinear
    from repro_torch.core import linear_approx
    tree = jax.tree.map(np.asarray, jlinear.init_linear_params(3, 16))
    got = bridge.fc_params_from_jax(tree, device="cpu")
    want = linear_approx.init_linear_params(3, 16, device="cpu")
    for k in ("W_c", "b_c", "W_l", "b_l"):
        assert got[k].dtype == torch.float32
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
