"""Full-sequence attention masked by explicit positions, port against
reference, on the CPU: the plain version of the ``flash_attention`` kernel
(``cuda_kernels/ref.py``) with ``q_pos`` / ``kv_pos`` against the
reference's ``attend_direct``, its ``arange`` positions against its
implicit mode, the port's ``prefix_grouped_causal`` against the
reference's, an image prompt of the reduced qwen2-vl-2b in the reference's
M-RoPE layout (``apply``, ``prefill`` with every cache leaf, 4 decode
steps), the reduced qwen3-0.6b on shifted positions, ``prefix_groups``
models, and ``configs/shapes.py`` / ``stack_defs`` against the
reference's.

The reference's M-RoPE layout of an image prompt (Qwen2-VL): text tokens
at t = h = w = 0 .. n - 1, then the image's g x g embeddings at t = n, h = n
+ row, w = n + column, then text again from n + g.  So tokens share t
positions, and the t axis, which masks the attention (the reference's
``pos1d``), is not ``arange(S)``.

Tolerances: f32 rtol / atol 1e-4 for the attention alone (one f32 softmax
on the same scores, summed in another order: measured ~1e-6); the models'
as ``tests/test_torch_vlm.py`` and ``tests/test_torch_transformer.py``
hold them (qwen2-vl-2b has no qk-norm: f32 atol 5e-4 of the tensor's
scale); positions and integer outputs exact; ``arange`` positions against
the implicit mode bit for bit.
"""
import tests.torch_threads  # noqa: F401  (first: one thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_reduced as jget_reduced
from repro.models import attention as jattention
from repro.models import build_model as jbuild_model
from repro.models import layers as jlayers
from repro_torch import bridge
from repro_torch.configs import SHAPES, InputShape, get_reduced
from repro_torch.cuda_kernels.flash_attention import flash_attention
from repro_torch.models import attention, layers
from repro_torch.models.transformer import TransformerModel
from tests.test_torch_transformer import (assert_close, jax_llm, pair_tol,
                                          port_llm, tokens, tt)

ATTN_TOL = dict(rtol=1e-4, atol=1e-4)
VLM = "qwen2-vl-2b"
S = 80                  # the attention tests' sequence (a ragged last tile)


def layout_positions(n_text: int, grid: int, n_after: int) -> np.ndarray:
    """(S, 3) int32 M-RoPE positions of text, an image of grid x grid
    embeddings, text, in the reference's layout."""
    t = list(range(n_text))
    h, w = list(t), list(t)
    for r in range(grid):
        for c in range(grid):
            t.append(n_text)
            h.append(n_text + r)
            w.append(n_text + c)
    after = range(n_text + grid, n_text + grid + n_after)
    t += after
    h += after
    w += after
    return np.stack([t, h, w], axis=-1).astype(np.int32)


def case_positions(case: str, b: int, s: int, seed: int) -> np.ndarray:
    """(b, s) int32 self-attention positions of one test case."""
    rng = np.random.default_rng(seed)
    if case == "layout":                       # 24 text, 6 x 6 image, 20
        pos = layout_positions(24, 6, s - 60)[:, 0]
        return np.broadcast_to(pos, (b, s)).copy()
    if case == "repeats":                      # non-decreasing, repeated
        return np.sort(rng.integers(0, s // 2, (b, s)), axis=1).astype(
            np.int32)
    if case == "permutation":
        return np.stack([rng.permutation(s) for _ in range(b)]).astype(
            np.int32)
    if case == "empty_slots":                  # -1: keys that never count
        pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
        pos[rng.random((b, s)) < 0.25] = -1
        return pos
    raise KeyError(case)


def _qkv(b, h, kvh, sq, skv, dh, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, h, sq, dh), (b, kvh, skv, dh),
                             (b, kvh, skv, dh)))
    return tuple(torch.from_numpy(a).to(dtype) for a in (q, k, v))


def _direct(q, k, v, q_pos, kv_pos, causal, window):
    """The reference's ``attend_direct`` on (B, H, S, dh) tensors."""
    out = jattention.attend_direct(
        *(jnp.asarray(t.transpose(1, 2).numpy()) for t in (q, k, v)),
        jnp.asarray(q_pos), jnp.asarray(kv_pos), causal=causal,
        window=window)
    return np.asarray(out).transpose(0, 2, 1, 3)


# --------------------------------------------------------------------------
# the plain version of B7 with positions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [1, 2, 6])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("case", ["layout", "repeats", "permutation",
                                  "empty_slots"])
def test_plain_positions_match_attend_direct(case, window, causal, groups):
    """Self-attention (q_pos == kv_pos) over S = 80 positions of each case,
    2 KV heads, ``groups`` query heads each, through the wrapper on CPU
    tensors (the plain version).  ``empty_slots`` has rows with no live
    key (a query at -1): both give the uniform mean there."""
    pos = case_positions(case, 2, S, seed=groups)
    q, k, v = _qkv(2, 2 * groups, 2, S, S, 32, seed=window + groups)
    got = flash_attention(q, k, v, causal=causal, window=window,
                          q_pos=torch.from_numpy(pos),
                          kv_pos=torch.from_numpy(pos))
    want = _direct(q, k, v, pos, pos, causal, window)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)


@pytest.mark.parametrize("window", [0, 24])
def test_plain_positions_queries_against_a_ring_of_keys(window):
    """Sq = 16 queries at positions 70-85 against 80 key slots holding
    positions in ring order with empty (-1) slots, the decode cache's
    shape; one row of positions broadcast over the batch."""
    rng = np.random.default_rng(window)
    kv = np.roll(np.arange(80, dtype=np.int32), 17)
    kv[rng.random(80) < 0.2] = -1
    qp = np.arange(70, 86, dtype=np.int32)
    q, k, v = _qkv(2, 4, 2, 16, 80, 32, seed=3)
    got = flash_attention(q, k, v, causal=True, window=window,
                          q_pos=torch.from_numpy(qp[None]),
                          kv_pos=torch.from_numpy(kv))
    want = _direct(q, k, v, qp[None], kv[None], True, window)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv,causal,window", [
    (80, 80, True, 0), (80, 80, True, 32), (80, 80, False, 0),
    (16, 80, True, 0), (16, 80, True, 24)])
def test_arange_positions_equal_the_implicit_mode(dtype, sq, skv, causal,
                                                  window):
    """Positions i + Skv - Sq and j give the implicit mode's end-aligned
    result bit for bit (int32 and int64 positions alike)."""
    q, k, v = _qkv(2, 4, 2, sq, skv, 32, seed=sq + window, dtype=dtype)
    want = flash_attention(q, k, v, causal=causal, window=window)
    for idt in (torch.int32, torch.int64):
        got = flash_attention(
            q, k, v, causal=causal, window=window,
            q_pos=(torch.arange(sq, dtype=idt) + skv - sq)[None],
            kv_pos=torch.arange(skv, dtype=idt)[None])
        assert torch.equal(got, want)


@pytest.mark.parametrize("window", [0, 8, 1024])
@pytest.mark.parametrize("causal", [True, False])
def test_the_layout_leaves_no_row_without_a_live_key(causal, window):
    """The kernel's rows with no live key take the uniform mean of all
    values (the reference's ``attend_direct``; the plain version gives it,
    held above by ``empty_slots``).  No prompt in the reference's layout
    makes such a row: each query's own key (the same position, >= 0) is
    live under every causal / window mask, so self-attention over any
    non-negative positions has one in every row."""
    for pos in (layout_positions(128, 16, 128)[:, 0],
                case_positions("repeats", 1, S, 0)[0],
                case_positions("permutation", 1, S, 0)[0]):
        qp, kp = pos[:, None], pos[None, :]
        live = np.broadcast_to(kp >= 0, (pos.size, pos.size)).copy()
        if causal:
            live &= kp <= qp
        if window > 0:
            live &= kp > qp - window
        assert live.any(axis=1).all()
        assert np.diagonal(live).all()


def test_a_row_without_a_live_key_is_the_mean_of_the_values():
    q, k, v = _qkv(1, 2, 2, 4, 6, 16, seed=0)
    got = flash_attention(q, k, v, causal=True,
                          q_pos=torch.tensor([[-1, 0, 1, 2]]),
                          kv_pos=torch.tensor([[0, 1, 2, 3, -1, 5]]))
    torch.testing.assert_close(got[0, :, 0], v[0].mean(dim=1), rtol=1e-6,
                               atol=1e-6)


def test_positions_are_checked():
    q, k, v = _qkv(2, 4, 2, 8, 8, 16, seed=0)
    pos = torch.arange(8)[None]
    with pytest.raises(ValueError, match="together"):
        flash_attention(q, k, v, causal=True, q_pos=pos)
    with pytest.raises(ValueError, match=r"\(B or 1, 8\)"):
        flash_attention(q, k, v, causal=True, q_pos=pos[:, :4], kv_pos=pos)
    with pytest.raises(TypeError, match="int32 or int64"):
        flash_attention(q, k, v, causal=True, q_pos=pos.float(),
                        kv_pos=pos)
    # position mode takes Sq > Skv (the implicit mode refuses it)
    q2 = _qkv(2, 4, 2, 12, 8, 16, seed=1)[0]
    with pytest.raises(ValueError, match="Sq=12 > Skv=8"):
        flash_attention(q2, k, v, causal=True)
    out = flash_attention(q2, k, v, causal=True,
                          q_pos=torch.arange(12)[None], kv_pos=pos)
    assert out.shape == q2.shape


# --------------------------------------------------------------------------
# prefix_grouped_causal
# --------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [1, 2, 4, 5])
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("case", ["arange", "layout"])
def test_prefix_grouped_causal_matches_reference(case, window, groups):
    """The port's against the reference's ``prefix_grouped_causal``
    (called directly: at test sizes the reference's dispatch takes the
    direct path), S = 96: groups of 48 and 24 rows; 1, and 5, which does
    not divide 96, are one call of the whole.  Positions implicit (arange)
    or the layout's t axis.  The groups cut the keys by index, as the
    reference's: with arange positions that is the whole causal attention;
    in the layout, image tokens of a group's last rows lose the image's
    later tokens, which share their t position, so there it is not."""
    s = 96
    rng = np.random.default_rng(groups + window)
    q, k, v = (rng.standard_normal((2, s, h, 32)).astype(np.float32)
               for h in (4, 2, 2))
    pos = (np.arange(s, dtype=np.int32) if case == "arange"
           else layout_positions(32, 6, s - 68)[:, 0])[None]
    want = jattention.prefix_grouped_causal(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(pos), window=window, groups=groups)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tpos = None if case == "arange" else torch.from_numpy(pos)
    got = attention.prefix_grouped_causal(tq, tk, tv, tpos, tpos,
                                          window=window, groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)
    if case == "arange":
        whole = attention.attention(tq, tk, tv, tpos, causal=True,
                                    window=window)
        np.testing.assert_allclose(got.numpy(), whole.numpy(), **ATTN_TOL)


def test_attention_dispatches_prefix_groups_and_counts_calls(monkeypatch):
    """``attention(..., prefix_groups=4)`` makes one kernel call a group
    (causal), one call when bidirectional, and never reads the host."""
    calls = []
    real = attention.flash_attention

    def counting(*a, **kw):
        calls.append(kw.get("q_pos") is not None)
        return real(*a, **kw)

    monkeypatch.setattr(attention, "flash_attention", counting)
    q = torch.randn(1, 64, 4, 16)
    k = v = torch.randn(1, 64, 2, 16)
    pos = torch.from_numpy(layout_positions(16, 4, 32)[:, 0])[None]
    attention.attention(q, k, v, pos, causal=True, prefix_groups=4)
    attention.attention(q, k, v, pos, causal=False, prefix_groups=4)
    attention.attention(q, k, v, None, causal=True, prefix_groups=4)
    assert calls == [True] * 4 + [True] + [False] * 4


# --------------------------------------------------------------------------
# models
# --------------------------------------------------------------------------

def _vlm_pair():
    jm = jbuild_model(jget_reduced(VLM).replace(dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = TransformerModel(get_reduced(VLM).replace(dtype="float32"),
                          device="cpu")
    return jm, jp, bridge.transformer_params_from_jax(
        jax.tree.map(np.asarray, jp), tm)


def image_prompt(b: int, seed: int):
    """(reference batch, port batch) of a prompt in the reference's layout:
    8 text tokens, the 4 x 4 image's 16 vision embeddings, 8 text tokens
    (S = 32, t positions 0-19)."""
    rng = np.random.default_rng(seed)
    pos = np.broadcast_to(layout_positions(8, 4, 8), (b, 32, 3)).copy()
    mask = np.zeros((b, 32), bool)
    mask[:, 8:24] = True
    arrs = {"tokens": rng.integers(0, 512, (b, 32)).astype(np.int32),
            "vision_embeds": rng.standard_normal((b, 16, 256)).astype(
                np.float32),
            "vision_mask": mask, "positions": pos}
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v) for k, v in arrs.items()})


@pytest.mark.parametrize("window", [48, 24])
def test_vlm_image_prompt_in_the_references_layout(window):
    """Reduced qwen2-vl-2b in f32 on an image prompt in the reference's
    layout: ``apply``'s hidden states, ``prefill``'s logits and every
    cache leaf (positions exact: the t axis, in the ring's order when S >=
    the window), then 4 decode steps (positions S, S + 1, ... on every
    axis, as the reference's ``step``) and the cache after them."""
    jm, jp, tm = _vlm_pair()
    tol = pair_tol(VLM, "float32")
    jb, tb = image_prompt(2, window)
    assert_close(tm.apply(tb), jm.apply(jp, jb)[0], tol)
    lj, cj = jm.prefill(jp, jb, window)
    lt, ct = tm.prefill(tb, window)
    assert_close(lt, lj, tol)

    def cache_close():
        blk = cj["blocks"]["pos0"]
        np.testing.assert_array_equal(ct["pos"].numpy(),
                                      np.asarray(blk["pos"]))
        np.testing.assert_array_equal(ct["step"].numpy(),
                                      np.asarray(cj["step"]))
        for leaf in ("k", "v"):
            assert_close(ct[leaf], blk[leaf], tol)

    cache_close()
    t_axis = tb["positions"][..., 0].to(torch.int32)
    if window > 32:
        assert torch.equal(ct["pos"][:, :, :32], t_axis.expand(2, 2, 32))
        assert (ct["pos"][:, :, 32:] == -1).all()
    feed = tokens((4, 2), 11)
    for i in range(4):
        lj, cj = jm.decode_step(jp, jnp.asarray(feed[i]), cj)
        lt, ct = tm.decode_step(tt(feed[i]), ct)
        assert_close(lt, lj, tol)
    cache_close()


def test_shifted_positions_on_a_dense_model():
    """Reduced qwen3-0.6b (f32) with positions arange(S) + 3: ``apply``,
    ``prefill``'s logits, cache positions and a decode step against the
    reference.  RoPE and the mask see relative positions alone, so the
    hidden states are the implicit positions' (within f32 rounding); the
    cache's positions are the shifted ones."""
    _, jm, jp = jax_llm("float32")
    tm = port_llm("float32", jp)
    toks = tokens((2, 24), 12)
    pos = np.tile(np.arange(24, dtype=np.int32) + 3, (2, 1))
    jb = {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)}
    tb = {"tokens": tt(toks), "positions": torch.from_numpy(pos)}
    tol = pair_tol("qwen3-0.6b", "float32")
    h_t = tm.apply(tb)
    assert_close(h_t, jm.apply(jp, jb)[0], tol)
    assert_close(h_t, tm.apply({"tokens": tt(toks)}).numpy(), tol)
    lj, cj = jm.prefill(jp, jb, 32)
    lt, ct = tm.prefill(tb, 32)
    assert_close(lt, lj, tol)
    np.testing.assert_array_equal(ct["pos"].numpy(),
                                  np.asarray(cj["blocks"]["pos0"]["pos"]))
    assert int(ct["pos"].max()) == 26
    lj, _ = jm.decode_step(jp, jnp.asarray([5, 6], jnp.int32), cj)
    lt, _ = tm.decode_step(tt(np.array([5, 6])), ct)
    assert_close(lt, lj, tol)


@pytest.mark.parametrize("groups", [2, 4])
def test_prefix_groups_model_matches_reference(groups):
    """``TransformerModel(..., prefix_groups=g)`` against the reference's
    model of the same ``prefix_groups`` (reduced qwen3-0.6b, f32):
    ``apply`` and ``prefill``; and against the port's own ungrouped
    model."""
    cfg = jget_reduced("qwen3-0.6b").replace(dtype="float32")
    jm = jbuild_model(cfg)
    jm.prefix_groups = groups
    jp = jm.init(jax.random.PRNGKey(0))
    tm = TransformerModel(get_reduced("qwen3-0.6b").replace(
        dtype="float32"), device="cpu", prefix_groups=groups)
    bridge.transformer_params_from_jax(jax.tree.map(np.asarray, jp), tm)
    toks = tokens((2, 32), 13)
    tol = pair_tol("qwen3-0.6b", "float32")
    h_t = tm.apply({"tokens": tt(toks)})
    assert_close(h_t, jm.apply(jp, {"tokens": jnp.asarray(toks)})[0], tol)
    lj, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, 16)
    lt, _ = tm.prefill({"tokens": tt(toks)}, 16)
    assert_close(lt, lj, tol)
    plain = port_llm("float32", jp)
    assert_close(h_t, plain.apply({"tokens": tt(toks)}).numpy(), tol)


# --------------------------------------------------------------------------
# configs/shapes.py, stack_defs
# --------------------------------------------------------------------------

def test_shapes_are_the_references():
    assert list(SHAPES) == list(JSHAPES)
    for name, shape in SHAPES.items():
        want = JSHAPES[name]
        assert isinstance(shape, InputShape)
        assert (shape.name, shape.seq_len, shape.global_batch,
                shape.kind) == (want.name, want.seq_len, want.global_batch,
                                want.kind)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "jamba-v0.1-52b",
                                  "xlstm-1.3b"])
def test_stack_defs_is_the_references(arch):
    """``stack_defs`` of a layer's defs (attention and FFN or MoE, or a
    mixer): the reference's shapes, init kinds, scales and dtypes, with
    the stacking dim in front."""
    from repro.models import mamba as jmamba
    from repro.models import ssm as jssm
    from repro_torch.models import mamba, ssm
    cfg, jcfg = get_reduced(arch), jget_reduced(arch)
    pairs = {"attn": (layers.attn_defs(cfg), jlayers.attn_defs(jcfg))}
    if cfg.moe is not None:
        pairs["moe"] = (layers.moe_defs(cfg), jlayers.moe_defs(jcfg))
    if arch == "jamba-v0.1-52b":
        pairs["mamba"] = (mamba.mamba_defs(cfg), jmamba.mamba_defs(jcfg))
    if arch == "xlstm-1.3b":
        pairs["mlstm"] = (ssm.mlstm_defs(cfg), jssm.mlstm_defs(jcfg))
        pairs["slstm"] = (ssm.slstm_defs(cfg), jssm.slstm_defs(jcfg))
    got = layers.stack_defs({k: v[0] for k, v in pairs.items()}, 3)
    want = jlayers.stack_defs({k: v[1] for k, v in pairs.items()}, 3)
    assert set(got) == set(want)
    for sub in got:
        assert set(got[sub]) == set(want[sub])
        for name, d in got[sub].items():
            w = want[sub][name]
            assert (tuple(d.shape), d.init, d.scale, d.dtype) == (
                tuple(w.shape), w.init, w.scale, w.dtype), (sub, name)
            assert d.shape[0] == 3
