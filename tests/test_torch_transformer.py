"""The port's transformer against the reference's, with the reference's
parameters (``model.init(PRNGKey(0))``) copied through
``repro_torch.bridge.transformer_params_from_jax``.

Configs: the reduced config of each of the nine LLM ids, in f32 and in bf16
(the ``pair`` fixture; the qwen3-0.6b cases keep their plain dtype ids);
the VLM qwen2-vl-2b here on text (M-RoPE with its three axes equal; its
vision inputs and 3-axis positions are ``tests/test_torch_vlm.py``'s).
``get_reduced("qwen3-0.6b")`` is 2 layers, d 256, 4 query and 2 KV heads of
64, SwiGLU 512, vocab 512, qk-norm, RoPE 1e6, tied embeddings; the others
are the same size with their own heads, norms, RoPE base and untied heads,
stablelm-3b with 4 KV heads, and the two MoE configs with 4 experts of 512
(arctic-480b, beside a dense 512 branch) or 256 (kimi, one shared expert),
top-2, at the configs' own capacity factor 1.25, so the prefills drop
copies (the reference's stable rank rule decides which). The hybrid
jamba-v0.1-52b is 4 layers of period (mamba, attn, mamba, mamba), d 256, no
RoPE, 4 experts of 512 top-2 on the odd positions and SwiGLU 512 on the
even ones; the SSM xlstm-1.3b is 2 layers (mlstm, slstm), d 256, 2 heads.
Their caches are compared leaf by leaf in the port's layout
(``port_cache``).

Tolerances: f32 rtol/atol 1e-4 (two f32 implementations, other summation
orders; measured ~2e-6 on hidden states of size ~3); bf16 rtol 5e-2 and
atol 5e-2 of the compared tensor's scale (max |x|, at least 1), the
reference's own 5e-2.

The configs without qk-norm (yi-9b, stablelm-3b, the two MoE configs and
the hybrid and SSM ones) are held in f32 only, at rtol 1e-4 and atol
``NO_QK_NORM_ATOL`` = 5e-4 of the compared tensor's scale.  The
reference's fan-in init reads the heads axis of the (d, h, dh)
projections as the fan-in (std 1/2 here), so without qk-norm the
attention logits reach ~64 and rounding is amplified: measured
in f32, up to 3.6e-4 absolute (1.2e-4 of scale, relative L2 9.4e-5) on
stablelm's decode logits of scale 3.1, 2.8e-4 to 4.8e-4 on hidden states
of scale 57-76; in bf16 the same configs move by 8e-3 to 6.7e-2 in
relative L2 (a 1-ulp change of a bf16 q or k moves a logit by ~0.25, and in
the MoE configs a routing choice with it), so bf16 is compared only for the
two qk-norm configs (the SSM mixers' bf16 cases are in
``tests/test_torch_ssm.py``).  A changed routing choice moves a token by
far more than either tolerance.  The MoE's expert choices (``top_i``) are
held exactly in ``tests/test_torch_moe.py``; here they show through the
outputs.  The scale matters for the hidden states and
V: the reference's fan-in init makes them reach ~40 after one block, where
a bf16 ulp is 0.25 and a residual sum that cancels keeps ~0.1 of absolute
error (measured 0.086); logits and K are of size ~1.  Cache positions and
the token ids fed in are exact.

The helpers here are shared by ``tests/test_torch_llm_serving.py``.
"""
import tests.torch_threads  # noqa: F401  (first: one thread)
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import build_model as jbuild_model
from repro_torch import bridge
from repro_torch.configs import ENCODER_IDS, LLM_IDS, get_reduced
from repro_torch.models.transformer import TransformerModel

DTYPES = ("float32", "bfloat16")
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
BASE_ARCH = "qwen3-0.6b"
MOE_ARCHS = ("arctic-480b", "kimi-k2-1t-a32b")
# (arch, dtype) of the pair fixture: every config in f32, the two with
# qk-norm in bf16 too; qwen3-0.6b's ids are the dtype alone
BF16_ARCHS = (BASE_ARCH, "qwen3-14b")
PAIRS = [(a, d) for a in LLM_IDS for d in DTYPES
         if d == "float32" or a in BF16_ARCHS]
PAIR_IDS = [d if a == BASE_ARCH else f"{a}-{d}" for a, d in PAIRS]


def jax_llm(dtype: str = "float32", seed: int = 0, arch: str = BASE_ARCH):
    """(cfg, model, params) of the reference's reduced ``arch``."""
    cfg = jget_reduced(arch).replace(dtype=dtype)
    model = jbuild_model(cfg)
    return cfg, model, model.init(jax.random.PRNGKey(seed))


def port_llm(dtype: str, jparams, arch: str = BASE_ARCH) -> TransformerModel:
    model = TransformerModel(get_reduced(arch).replace(dtype=dtype),
                             device="cpu")
    return bridge.transformer_params_from_jax(
        jax.tree.map(np.asarray, jparams), model)


class Tol(NamedTuple):
    rtol: float
    atol: float
    scaled: bool       # atol in units of the compared tensor's scale


# f32 atol, in units of scale, of the configs without qk-norm (see above)
NO_QK_NORM_ATOL = 5e-4


def pair_tol(arch: str, dtype: str) -> Tol:
    if dtype == "bfloat16":
        return Tol(TOL[dtype], TOL[dtype], True)
    if get_reduced(arch).qk_norm:
        return Tol(TOL[dtype], TOL[dtype], False)
    return Tol(TOL[dtype], NO_QK_NORM_ATOL, True)


def assert_close(got: torch.Tensor, want, dtype) -> None:
    """``dtype``: "float32" (atol absolute), "bfloat16" (atol scaled), or a
    ``Tol``."""
    rule = dtype if isinstance(dtype, Tol) else pair_tol(BASE_ARCH, dtype)
    want = np.asarray(want, np.float32)
    atol = rule.atol * (max(1.0, np.abs(want).max()) if rule.scaled else 1.0)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rule.rtol,
                               atol=atol)


def tokens(shape, seed: int, vocab: int = 512) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def tt(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.int64))


@pytest.fixture(scope="module", params=PAIRS, ids=PAIR_IDS)
def pair(request):
    """(tolerance rule, reference model, its params, the port's model)."""
    arch, dtype = request.param
    jcfg, jm, jp = jax_llm(dtype, arch=arch)
    return pair_tol(arch, dtype), jm, jp, port_llm(dtype, jp, arch)


def port_cache(jcache, model: TransformerModel) -> dict:
    """The reference's decode cache (``blocks/pos{i}/<leaf>`` with leaves
    (n_super, B, ...), and ``step``) in the port's layout, as numpy: each
    attention leaf stacked over the attention layers, each mixer leaf as
    ``<kind>_<leaf>`` over that kind's layers, in layer order."""
    blocks = jcache["blocks"]
    out = {"step": np.asarray(jcache["step"])}
    for l, kind in enumerate(model.layer_kinds):
        pos = blocks[f"pos{l % model.period}"]
        for leaf, a in pos.items():
            key = leaf if kind == "attn" else f"{kind}_{leaf}"
            out.setdefault(key, []).append(np.asarray(a[l // model.period]))
    return {k: v if k == "step" else np.stack(v) for k, v in out.items()}


def _check_init(arch: str) -> None:
    """Shapes, dtypes and init kinds of the port's own init against the
    reference's ParamDefs (and spreads against the reference's draws)."""
    jcfg, jm, jp = jax_llm("bfloat16", arch=arch)
    model = TransformerModel(get_reduced(arch), device="cpu")
    model.init(torch.Generator().manual_seed(0))
    defs = jm.param_defs()
    top = [k for k in defs if k != "blocks"]
    assert set(top) == set(model.top.defs)
    pairs = [(f"top.{k}", defs[k], jp[k]) for k in top]
    period = model.period
    assert sorted(defs["blocks"]) == [f"pos{i}" for i in range(period)]
    for i in range(period):
        pos = defs["blocks"][f"pos{i}"]
        assert sorted(pos) == sorted(model.blocks[i].subs)
        for sub in pos:
            for name, d in pos[sub].items():
                pairs += [(f"blocks.{s * period + i}.{sub}.{name}", d,
                           jp["blocks"][f"pos{i}"][sub][name][s])
                          for s in range(jcfg.num_layers // period)]
    params = dict(model.named_parameters())
    assert set(params) == {name for name, _, _ in pairs}
    for name, d, ja in pairs:
        p = params[name]
        shape = d.shape[1:] if name.startswith("blocks") else d.shape
        assert tuple(p.shape) == tuple(shape), name
        want_dtype = torch.float32 if d.dtype == "float32" else torch.bfloat16
        assert p.dtype == want_dtype, name
        if d.init in ("ones", "zeros"):
            assert torch.equal(p, torch.full_like(
                p, 1.0 if d.init == "ones" else 0.0)), name
        else:
            std, jstd = float(p.float().std()), float(np.std(np.asarray(
                ja, np.float32)))
            assert abs(std / jstd - 1.0) < 0.1, (name, std, jstd)


def test_init_matches_param_defs():
    """qwen3-0.6b's tied embeddings: no ``lm_head`` on either side."""
    _check_init(BASE_ARCH)
    assert "lm_head" not in jax_llm(arch=BASE_ARCH)[1].param_defs()
    assert "lm_head" not in TransformerModel(get_reduced(BASE_ARCH),
                                             device="cpu").top.defs


@pytest.mark.parametrize("arch", [a for a in LLM_IDS + ENCODER_IDS
                                  if a != BASE_ARCH])
def test_init_matches_param_defs_of_each_config(arch):
    """As above for the other LLM configs and the audio encoder (untied
    heads; the MoE family's router in f32 and its (E, D, F) expert leaves;
    the Mamba, mLSTM and sLSTM mixers' leaves, f32 where the reference's
    are; the encoder's frontend, LayerNorm biases and GELU FFN)."""
    _check_init(arch)


def test_embed_and_unembed(pair):
    tol, jm, jp, tm = pair
    toks = tokens((2, 24), 1)
    x_j = jm.embed(jp, {"tokens": jnp.asarray(toks)})
    x_t = tm.embed({"tokens": tt(toks)})
    assert torch.equal(x_t.float(), torch.from_numpy(
        np.array(x_j, np.float32)))
    assert_close(tm.unembed(x_t[:, -1]), jm.unembed(jp, x_j[:, -1]), tol)


def test_block_apply(pair):
    tol, jm, jp, tm = pair
    toks = tokens((2, 24), 2)
    x_j = jm.embed(jp, {"tokens": jnp.asarray(toks)})
    bp0 = jax.tree.map(lambda a: a[0], jp["blocks"])["pos0"]
    y_j, st_j, aux_j = jm.block_apply(0, bp0, x_j)
    y_t, cache, aux_t = tm.block_apply(tm.blocks[0],
                                     tm.embed({"tokens": tt(toks)}))
    if tm.kinds[0] == "attn":
        assert cache is None
    else:                       # a mixer returns its state after the prompt
        assert set(cache) == set(st_j)
        for key in st_j:
            assert_close(cache[key], st_j[key], tol)
    assert_close(y_t, y_j, tol)
    assert_close(torch.as_tensor(aux_t), aux_j, tol)


def test_apply(pair):
    tol, jm, jp, tm = pair
    toks = tokens((2, 40), 3)
    h_j, _ = jm.apply(jp, {"tokens": jnp.asarray(toks)})
    assert_close(tm.apply({"tokens": tt(toks)}), h_j, tol)


# (S, window): S < w pads; S >= w rotates (shift = (S - w) % w: 8 on 16
# slots, where the reference's order gives slot == pos % w, and 4 on 12,
# where it does not); S == w
PREFILL_CASES = [(24, 32), (40, 16), (40, 12), (16, 16)]


def _cache_close(ct, cj, tol, model):
    """Every leaf of the port's cache against the reference's, in the
    port's layout: positions and steps exact, the rest within ``tol``."""
    want = port_cache(cj, model)
    assert set(ct) == set(want)
    for key, a in want.items():
        if key in ("pos", "step"):
            assert np.array_equal(ct[key].numpy(), a), key
        else:
            assert_close(ct[key], a, tol)


@pytest.mark.parametrize("s,w", PREFILL_CASES)
def test_prefill_logits_and_cache(pair, s, w):
    tol, jm, jp, tm = pair
    toks = tokens((2, s), 4)
    lj, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, w)
    lt, ct = tm.prefill({"tokens": tt(toks)}, w)
    assert lt.shape == (2, 512)
    assert_close(lt, lj, tol)
    _cache_close(ct, cj, tol, tm)


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
    _, ct = tm.prefill({"tokens": tt(toks)}, 12)
    want = 28 + (np.arange(12) + 4) % 12
    assert np.array_equal(np.asarray(cj["blocks"]["pos0"]["pos"][0, 0]), want)
    assert np.array_equal(ct["pos"][0, 0].numpy(), want)
    assert not np.array_equal(want % 12, np.arange(12))


@pytest.mark.parametrize("s,w", [(24, 32), (40, 12)])
def test_decode_steps_teacher_forced(pair, s, w):
    """Six decode steps from the prefill's cache, fed the same tokens on
    both sides: logits every step, the cache after the last."""
    tol, jm, jp, tm = pair
    toks = tokens((2, s), 6)
    _, cj = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, w)
    _, ct = tm.prefill({"tokens": tt(toks)}, w)
    feed = tokens((6, 2), 7)
    for i in range(6):
        lj, cj = jm.decode_step(jp, jnp.asarray(feed[i]), cj)
        lt, ct = tm.decode_step(tt(feed[i]), ct)
        assert_close(lt, lj, tol)
    _cache_close(ct, cj, tol, tm)


def test_unported_configs_raise():
    """A family or a rope kind the reference does not have raises as not
    ported (the VLM family and M-RoPE build since they were ported); an
    unknown block kind and a depth that is not a multiple of the pattern's
    period raise ``ValueError``, as in the reference.  (Positions other
    than ``arange(S)`` are ported: ``tests/test_torch_positions.py``.)"""
    cfg = get_reduced("qwen3-0.6b")
    with pytest.raises(NotImplementedError):
        TransformerModel(cfg.replace(family="vit"), device="cpu")
    with pytest.raises(ValueError, match="unknown block kind"):
        TransformerModel(cfg.replace(block_pattern=("attn", "conv")),
                         device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        TransformerModel(cfg.replace(block_pattern=("attn",) * 3),
                         device="cpu")
    with pytest.raises(NotImplementedError):
        TransformerModel(cfg.replace(rope_kind="yarn"), device="cpu")


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
    mamba = jax.tree.map(lambda a: a, tree)
    mamba["blocks"]["pos0"]["mamba"] = mamba["blocks"]["pos0"].pop("ffn")
    with pytest.raises(ValueError,
                       match="blocks/pos0 holds .*; expected attn \\+ ffn"):
        bridge.transformer_params_from_jax(mamba, model)
