"""The port's dense transformer against the reference's, with the
reference's parameters (``model.init(PRNGKey(0))``) copied through
``repro_torch.bridge.transformer_params_from_jax``.

Config: ``get_reduced("qwen3-0.6b")`` (2 layers, d 256, 4 query and 2 KV
heads of 64, SwiGLU 512, vocab 512, qk-norm, RoPE 1e6, tied embeddings), in
f32 and in bf16.  Tolerances: f32 rtol/atol 1e-4 (two f32 implementations,
other summation orders; measured ~2e-6 on hidden states of size ~3); bf16
rtol 5e-2 and atol 5e-2 of the compared tensor's scale (max |x|, at least
1), the reference's own 5e-2.  The scale matters for the hidden states and
V: the reference's fan-in init makes them reach ~40 after one block, where
a bf16 ulp is 0.25 and a residual sum that cancels keeps ~0.1 of absolute
error (measured 0.086); logits and K are of size ~1.  Cache positions and
the token ids fed in are exact.

The helpers here are shared by ``tests/test_torch_llm_serving.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import build_model as jbuild_model
from repro_torch import bridge
from repro_torch.configs import get_reduced
from repro_torch.models.transformer import TransformerModel

DTYPES = ("float32", "bfloat16")
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def jax_llm(dtype: str = "float32", seed: int = 0):
    """(cfg, model, params) of the reference's reduced qwen3-0.6b."""
    cfg = jget_reduced("qwen3-0.6b").replace(dtype=dtype)
    model = jbuild_model(cfg)
    return cfg, model, model.init(jax.random.PRNGKey(seed))


def port_llm(dtype: str, jparams) -> TransformerModel:
    model = TransformerModel(get_reduced("qwen3-0.6b").replace(dtype=dtype),
                             device="cpu")
    return bridge.transformer_params_from_jax(
        jax.tree.map(np.asarray, jparams), model)


def assert_close(got: torch.Tensor, want, dtype: str) -> None:
    want = np.asarray(want, np.float32)
    tol = TOL[dtype]
    atol = tol if dtype == "float32" else tol * max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=atol)


def tokens(shape, seed: int, vocab: int = 512) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def tt(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.int64))


@pytest.fixture(scope="module", params=DTYPES)
def pair(request):
    dtype = request.param
    jcfg, jm, jp = jax_llm(dtype)
    return dtype, jm, jp, port_llm(dtype, jp)


def test_init_matches_param_defs():
    """Shapes, dtypes and init kinds of the port's own init against the
    reference's ParamDefs (and spreads against the reference's draws)."""
    jcfg, jm, jp = jax_llm("bfloat16")
    model = TransformerModel(get_reduced("qwen3-0.6b"), device="cpu")
    model.init(torch.Generator().manual_seed(0))
    defs = jm.param_defs()
    pairs = [(f"top.{k}", defs[k], jp[k]) for k in ("embed", "final_norm")]
    assert "lm_head" not in defs and "lm_head" not in model.top.defs
    for sub in ("attn", "ffn"):
        for name, d in defs["blocks"]["pos0"][sub].items():
            pairs += [(f"blocks.{l}.{sub}.{name}", d,
                       jp["blocks"]["pos0"][sub][name][l])
                      for l in range(jcfg.num_layers)]
    params = dict(model.named_parameters())
    assert set(params) == {name for name, _, _ in pairs}
    for name, d, ja in pairs:
        p = params[name]
        shape = d.shape[1:] if name.startswith("blocks") else d.shape
        assert tuple(p.shape) == tuple(shape), name
        want_dtype = torch.float32 if d.dtype == "float32" else torch.bfloat16
        assert p.dtype == want_dtype, name
        if d.init == "ones":
            assert torch.equal(p, torch.ones_like(p)), name
        else:
            std, jstd = float(p.float().std()), float(np.std(np.asarray(
                ja, np.float32)))
            assert abs(std / jstd - 1.0) < 0.1, (name, std, jstd)


def test_embed_and_unembed(pair):
    dtype, jm, jp, tm = pair
    toks = tokens((2, 24), 1)
    x_j = jm.embed(jp, {"tokens": jnp.asarray(toks)})
    x_t = tm.embed(tt(toks))
    assert torch.equal(x_t.float(), torch.from_numpy(
        np.array(x_j, np.float32)))
    assert_close(tm.unembed(x_t[:, -1]), jm.unembed(jp, x_j[:, -1]), dtype)


def test_block_apply(pair):
    dtype, jm, jp, tm = pair
    toks = tokens((2, 24), 2)
    x_j = jm.embed(jp, {"tokens": jnp.asarray(toks)})
    bp0 = jax.tree.map(lambda a: a[0], jp["blocks"])["pos0"]
    y_j, _, _ = jm.block_apply(0, bp0, x_j)
    y_t, cache = tm.block_apply(tm.blocks[0], tm.embed(tt(toks)))
    assert cache is None
    assert_close(y_t, y_j, dtype)


def test_apply(pair):
    dtype, jm, jp, tm = pair
    toks = tokens((2, 40), 3)
    h_j, _ = jm.apply(jp, {"tokens": jnp.asarray(toks)})
    assert_close(tm.apply(tt(toks)), h_j, dtype)


# (S, window): S < w pads; S >= w rotates (shift = (S - w) % w: 8 on 16
# slots, where the reference's order gives slot == pos % w, and 4 on 12,
# where it does not); S == w
PREFILL_CASES = [(24, 32), (40, 16), (40, 12), (16, 16)]


def _cache_close(ct, cj, dtype):
    blk = cj["blocks"]["pos0"]
    assert np.array_equal(ct["pos"].numpy(), np.asarray(blk["pos"]))
    assert np.array_equal(ct["step"].numpy(), np.asarray(cj["step"]))
    assert_close(ct["k"], blk["k"], dtype)
    assert_close(ct["v"], blk["v"], dtype)


@pytest.mark.parametrize("s,w", PREFILL_CASES)
def test_prefill_logits_and_cache(pair, s, w):
    dtype, jm, jp, tm = pair
    toks = tokens((2, s), 4)
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, w)
    lt, ct = tm.prefill(tt(toks), w)
    assert lt.shape == (2, 512)
    assert_close(lt, lj, dtype)
    _cache_close(ct, cj, dtype)


def test_prefill_ring_order_is_the_references():
    """With S >= w the reference keeps the last w entries but rotates them
    by the inverse of the slot == pos % w permutation (``layers.py:124-
    128``), so at S=40, w=12 slot j holds position 28 + (j + 4) % 12 and
    the first decode write (slot 40 % 12 = 4) evicts position 36, not the
    oldest, 28.  The port keeps the reference's order (ROADMAP §C)."""
    _, jm, jp = jax_llm("float32")
    tm = port_llm("float32", jp)
    toks = tokens((1, 40), 5)
    _, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 12)
    _, ct = tm.prefill(tt(toks), 12)
    want = 28 + (np.arange(12) + 4) % 12
    assert np.array_equal(np.asarray(cj["blocks"]["pos0"]["pos"][0, 0]), want)
    assert np.array_equal(ct["pos"][0, 0].numpy(), want)
    assert not np.array_equal(want % 12, np.arange(12))


@pytest.mark.parametrize("s,w", [(24, 32), (40, 12)])
def test_decode_steps_teacher_forced(pair, s, w):
    """Six decode steps from the prefill's cache, fed the same tokens on
    both sides: logits every step, the cache after the last."""
    dtype, jm, jp, tm = pair
    toks = tokens((2, s), 6)
    _, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, w)
    _, ct = tm.prefill(tt(toks), w)
    feed = tokens((6, 2), 7)
    for i in range(6):
        lj, cj = jm.decode_step(jp, jnp.asarray(feed[i]), cj)
        lt, ct = tm.decode_step(tt(feed[i]), ct)
        assert_close(lt, lj, dtype)
    _cache_close(ct, cj, dtype)


def test_unported_configs_raise():
    cfg = get_reduced("qwen3-0.6b")
    with pytest.raises(NotImplementedError):
        TransformerModel(cfg.replace(family="moe"), device="cpu")
    with pytest.raises(NotImplementedError):
        TransformerModel(cfg.replace(block_pattern=("attn", "mamba")),
                         device="cpu")
    with pytest.raises(NotImplementedError):
        TransformerModel(cfg.replace(rope_kind="mrope"), device="cpu")
    tm = TransformerModel(cfg.replace(dtype="float32"), device="cpu")
    with pytest.raises(NotImplementedError, match="arange"):
        tm.apply(tt(tokens((1, 8), 8)), positions=torch.arange(8) + 3)


def test_bridge_rejects_mismatched_trees():
    _, _, jp = jax_llm("float32")
    tree = jax.tree.map(np.asarray, jp)
    model = TransformerModel(get_reduced("qwen3-0.6b").replace(
        dtype="float32"), device="cpu")
    extra = dict(tree, lm_head=np.zeros((256, 512), np.float32))
    with pytest.raises(ValueError, match="top-level keys"):
        bridge.transformer_params_from_jax(extra, model)
    short = jax.tree.map(lambda a: a, tree)
    short["blocks"]["pos0"]["ffn"]["w_up"] = tree["blocks"]["pos0"]["ffn"][
        "w_up"][:1]
    with pytest.raises(ValueError, match="1 layers, model has 2"):
        bridge.transformer_params_from_jax(short, model)
    moe = jax.tree.map(lambda a: a, tree)
    moe["blocks"]["pos0"]["moe"] = moe["blocks"]["pos0"].pop("ffn")
    with pytest.raises(ValueError, match="attn \\+ ffn"):
        bridge.transformer_params_from_jax(moe, model)
