"""The port's VLM family (Qwen2-VL-2B's language backbone) against the
reference's, on the CPU: M-RoPE (``apply_mrope``, ``rope_dispatch``), the
vision-embedding stub in ``embed``, ``apply`` / ``prefill`` /
teacher-forced ``decode_step`` with vision embeddings and with explicit
3-axis positions, the loss and its gradients, the launchers and the
checkpoints.  The decode gate's steps and the engine's token streams are
cases of ``tests/test_torch_llm_serving.py``.

Model: ``get_reduced("qwen2-vl-2b")``: 2 layers, d 256, 4 query and 2 KV
heads of 64, SwiGLU 512, vocab 512, 16 vision embeddings, M-RoPE sections
(8, 12, 12) over theta 1e6, tied embeddings, no qk-norm, with the
reference's parameters (``model.init(PRNGKey(0))``) copied through
``repro_torch.bridge``; inputs drawn with numpy from a seed.  Image tokens
sit at positions 1.. of the prompt; their 3-axis positions here keep t =
arange(S) and put h and w on a 4 x 4 grid, so the three axes differ there
and M-RoPE differs from RoPE (the reference's layout, whose image tokens
share a t position, is ``tests/test_torch_positions.py``'s).

Tolerances: M-RoPE rtol/atol 1e-4 in f32 and 5e-2 of the tensor's scale
in bf16.  The config has no qk-norm, so its model outputs take
``tests/test_torch_transformer.py``'s rule for such configs: f32 atol
5e-4 of the tensor's scale (measured 3.1e-4 on hidden states of scale
4.1), and bf16 in relative L2 within 5e-2 (measured 1.5e-2: a 1-ulp change
of a bf16 q or k moves a logit by ~0.25 at the reference's init, and the
whole model's elementwise bf16 outputs by up to 4.6e-2 of their scale).
Loss rtol 1e-4, gradients within 5e-4 of each leaf's scale, as
``tests/test_torch_training.py`` holds the no-qk-norm MoE.
"""
import tests.torch_threads  # noqa: F401  (first: one thread)
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load as jload
from repro.checkpoint import save as jsave
from repro.configs import get_reduced as jget_reduced
from repro.models import build_model as jbuild_model
from repro.models import common as jcommon
from repro_torch import bridge, tree
from repro_torch.checkpoint import load, save
from repro_torch.configs import get_reduced
from repro_torch.launch import profile_llm, serve, train
from repro_torch.models import common
from repro_torch.models.transformer import TransformerModel
from repro_torch.training import loop
from tests.test_torch_transformer import Tol, assert_close, pair_tol, tt

ARCH = "qwen2-vl-2b"
DTYPES = ("float32", "bfloat16")
SECTIONS = (8, 12, 12)
THETA = 1_000_000.0
GRID = 4                # the image's h x w grid (16 vision embeddings)
GRAD_SCALE = 5e-4       # gradients, of a leaf's scale (no qk-norm)
REL_L2_BF16 = 5e-2


@functools.lru_cache(maxsize=None)
def _reference(dtype: str):
    jm = jbuild_model(jget_reduced(ARCH).replace(dtype=dtype))
    return jm, jm.init(jax.random.PRNGKey(0))


def _port(dtype: str) -> TransformerModel:
    """A fresh port model holding the reference's parameters."""
    tm = TransformerModel(get_reduced(ARCH).replace(dtype=dtype),
                          device="cpu")
    return bridge.transformer_params_from_jax(
        jax.tree.map(np.asarray, _reference(dtype)[1]), tm)


@functools.lru_cache(maxsize=None)
def _pair(dtype: str):
    return _reference(dtype) + (_port(dtype),)


def _rel_l2(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got.float().numpy() - want)
                 / np.linalg.norm(want))


def _model_close(got: torch.Tensor, want, dtype: str) -> None:
    if dtype == "float32":
        assert_close(got, want, pair_tol(ARCH, dtype))
    else:
        assert _rel_l2(got, want) < REL_L2_BF16


def grid_positions(b: int, s: int, start: int = 1) -> np.ndarray:
    """(b, s, 3) int32 positions: t = arange(s); h and w equal t except at
    the GRID x GRID image tokens from ``start``, which take the grid's row
    and column (offset by ``start``)."""
    t = np.arange(s)
    h, w = t.copy(), t.copy()
    img = np.arange(GRID * GRID)
    h[start:start + img.size] = start + img // GRID
    w[start:start + img.size] = start + img % GRID
    pos = np.stack([t, h, w], axis=-1).astype(np.int32)
    return np.broadcast_to(pos, (b, s, 3)).copy()


def vision_batch(b: int, s: int, n_masked: int, seed: int, *,
                 positions: bool = False):
    """(reference batch, port batch): tokens, 16 vision embeddings and a
    mask over positions 1 .. n_masked (more than 16 reuse the last)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, (b, s)).astype(np.int32)
    emb = rng.standard_normal((b, 16, 256)).astype(np.float32)
    mask = np.zeros((b, s), bool)
    mask[:, 1:1 + n_masked] = True
    arrs = {"tokens": toks, "vision_embeds": emb, "vision_mask": mask}
    if positions:
        arrs["positions"] = grid_positions(b, s)
    jb = {k: jnp.asarray(v) for k, v in arrs.items()}
    tb = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                              else v) for k, v in arrs.items()}
    return jb, tb


# --------------------------------------------------------------------------
# M-RoPE
# --------------------------------------------------------------------------

def _rope_inputs(dtype: str, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 24, 4, 64)).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return jx, tx


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_mrope_matches_reference(dtype):
    """Three axes that differ (t, and h / w on the image's grid): each
    section rotates with its own axis, as the reference's."""
    jx, tx = _rope_inputs(dtype, 1)
    pos = grid_positions(2, 24)
    want = jcommon.apply_mrope(jx, jnp.asarray(pos), SECTIONS, THETA)
    got = common.apply_mrope(tx, torch.from_numpy(pos), SECTIONS, THETA)
    assert got.dtype == tx.dtype
    rule = Tol(1e-4, 1e-4, False) if dtype == "float32" else \
        Tol(5e-2, 5e-2, True)
    assert_close(got, want, rule)
    rope = common.apply_rope(tx, torch.from_numpy(pos[..., 0]), THETA)
    assert not torch.equal(got, rope)          # the grid moved the angles
    assert torch.equal(got[:, 17:], rope[:, 17:])   # text: the three agree


@pytest.mark.parametrize("dtype", DTYPES)
def test_text_only_mrope_is_rope(dtype):
    """2-d (text-only) positions repeated over the three axes give
    ``apply_rope``'s angles: bitwise the same rotation."""
    _, tx = _rope_inputs(dtype, 2)
    pos = torch.from_numpy(np.random.default_rng(3).integers(
        0, 4096, (2, 24)))
    got = common.rope_dispatch(tx, pos, "mrope", THETA, SECTIONS)
    assert torch.equal(got, common.apply_rope(tx, pos, THETA))
    assert torch.equal(common.rope_dispatch(tx, pos, "default", THETA,
                                            SECTIONS), got)
    assert common.rope_dispatch(tx, pos, "none", THETA, SECTIONS) is tx


def test_mrope_sections_must_sum_to_half_the_head_dim():
    _, tx = _rope_inputs("float32", 4)
    pos = torch.from_numpy(grid_positions(2, 24))
    with pytest.raises(ValueError, match="must sum to half the head dim"):
        common.apply_mrope(tx, pos, (8, 12, 8), THETA)
    with pytest.raises(ValueError):
        jcommon.apply_mrope(jnp.zeros((2, 24, 4, 64)), jnp.asarray(pos),
                            (8, 12, 8), THETA)


# --------------------------------------------------------------------------
# The vision stub, the model
# --------------------------------------------------------------------------

def test_embed_with_vision():
    """20 masked positions for 16 embeddings: positions 1-16 take
    embeddings 0-15 and 17-20 the last again (the reference's clip);
    position 0 and the text keep their token embeddings; bitwise the
    reference's."""
    jm, jp, tm = _pair("float32")
    jb, tb = vision_batch(2, 32, 20, 5)
    got = tm.embed(tb)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jm.embed(jp, jb)))
    emb = tb["vision_embeds"]
    assert torch.equal(got[:, 1:17], emb)
    assert torch.equal(got[:, 17:21], emb[:, 15:16].expand(2, 4, 256))
    text = tm.embed({"tokens": tb["tokens"]})
    assert torch.equal(got[:, 0], text[:, 0])
    assert torch.equal(got[:, 21:], text[:, 21:])


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_prefill_and_decode_with_vision(dtype):
    """The reference's ``test_decode_matches_full_forward`` batch (16
    vision embeddings at positions 1-16 of a 24-token prompt), port against
    reference: the full forward over 28 tokens, the prefill's logits and
    cache, 4 teacher-forced decode steps' logits; and the port's own
    decode against its full forward, as the reference's test holds it."""
    jm, jp, tm = _pair(dtype)
    jfull, tfull = vision_batch(2, 28, 16, 6)
    jpre = {k: v[:, :24] if k != "vision_embeds" else v
            for k, v in jfull.items()}
    tpre = {k: v[:, :24] if k != "vision_embeds" else v
            for k, v in tfull.items()}
    h_j, _ = jm.apply(jp, jfull)
    h_t = tm.apply(tfull)
    _model_close(h_t, h_j, dtype)
    ref_logits = tm.unembed(h_t)
    lj, cj = jm.prefill(jp, jpre, 48)
    lt, ct = tm.prefill(tpre, 48)
    _model_close(lt, lj, dtype)
    np.testing.assert_array_equal(
        ct["pos"].numpy(), np.asarray(cj["blocks"]["pos0"]["pos"]))
    _model_close(ct["k"], cj["blocks"]["pos0"]["k"], dtype)
    for t in range(4):
        feed = tfull["tokens"][:, 24 + t]
        lj, cj = jm.decode_step(jp, jnp.asarray(feed.numpy(), jnp.int32),
                                cj)
        lt, ct = tm.decode_step(feed, ct)
        _model_close(lt, lj, dtype)
        if dtype == "float32":
            np.testing.assert_allclose(lt.numpy(),
                                       ref_logits[:, 24 + t].numpy(),
                                       atol=2e-3)


def test_explicit_three_axis_positions():
    """``positions`` (B, S, 3) with h and w on the image grid: ``apply`` and
    ``prefill`` (logits, K, the cache's positions from the t axis) against
    the reference; they differ from the same batch without positions."""
    jm, jp, tm = _pair("float32")
    jb, tb = vision_batch(2, 32, 16, 7, positions=True)
    h_t = tm.apply(tb)
    assert_close(h_t, jm.apply(jp, jb)[0], pair_tol(ARCH, "float32"))
    plain = {k: v for k, v in tb.items() if k != "positions"}
    assert not torch.allclose(h_t, tm.apply(plain), atol=1e-3)
    lj, cj = jm.prefill(jp, jb, 24)
    lt, ct = tm.prefill(tb, 24)
    assert_close(lt, lj, pair_tol(ARCH, "float32"))
    blk = cj["blocks"]["pos0"]
    np.testing.assert_array_equal(ct["pos"].numpy(), np.asarray(blk["pos"]))
    assert_close(ct["k"], blk["k"], pair_tol(ARCH, "float32"))
    lj, _ = jm.decode_step(jp, jnp.asarray([3, 4], jnp.int32), cj)
    lt, _ = tm.decode_step(tt(np.array([3, 4])), ct)
    assert_close(lt, lj, pair_tol(ARCH, "float32"))


def test_loss_and_grads_match_reference():
    """Next-token loss over a batch with vision embeddings and a
    ``loss_mask`` that drops the image's positions, and every parameter's
    gradient."""
    jm, jp = _reference("float32")
    tm = _port("float32")
    jb, tb = vision_batch(2, 24, 16, 8)
    mask = np.ones((2, 24), np.float32)
    mask[:, :17] = 0.0
    jb["loss_mask"], tb["loss_mask"] = jnp.asarray(mask), \
        torch.from_numpy(mask)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(jp, jb)
    loop.param_tree(tm)
    grads = loop.grad_tree(tm)
    loss, met = tm.loss(tb)
    loss.backward()
    assert set(met) == set(jmet)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-4)
    assert float(met["tokens"]) == float(jmet["tokens"]) == 2 * 6
    for (path, g), w in zip(tree.flatten_with_path(grads),
                            jax.tree.leaves(jgrads)):
        w = np.asarray(w)
        assert float(g.abs().max()) > 0, tree.keystr(path)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0, atol=GRAD_SCALE * np.abs(w).max(),
            err_msg=tree.keystr(path))


# --------------------------------------------------------------------------
# Launchers, checkpoints
# --------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [[], ["--fastcache"]],
                         ids=["exact", "fastcache"])
def test_serve_launcher_serves_qwen2_vl(capsys, extra):
    """``launch/serve.py --arch qwen2-vl-2b``, exact and under the decode
    gate (a period-1 attention stack: L + 1 syncs a decode step)."""
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--json",
                "--requests", "3", "--prompt-len", "24", "--new-tokens", "6",
                *extra])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["arch"] == "qwen2-vl-2b-smoke" and out["fastcache"] == bool(
        extra)
    assert out["finished"] == 3 and out["tokens"] == 3 * 6
    assert out["host_syncs_per_decode_step"] == (3.0 if extra else 1.0)
    assert ("block_cache_ratio" in out) == bool(extra)


def test_profile_llm_runs_qwen2_vl(tmp_path):
    """``launch/profile_llm.py --arch qwen2-vl-2b --fastcache`` rehearsed on
    the CPU: a prefill window and a gated decode window."""
    out = tmp_path / "profile.json"
    profile_llm.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--fastcache", "--warmup", "1", "--window", "2",
                      "--out", str(out)])
    report = json.loads(out.read_text())
    assert report["arch"] == "qwen2-vl-2b-smoke" and report["fastcache"]
    assert report["decode"]["steps"] == 2
    assert report["decode"]["host_syncs_per_step"] == 3.0


def test_train_launcher_trains_on_tokens(tmp_path, capsys):
    """``launch/train.py`` trains the VLM on ``token_stream`` (text only, as
    the reference's launcher feeds it) and saves a tree that the
    reference's ``load`` reads."""
    ckpt = str(tmp_path / "vlm.npz")
    train.main(["--arch", ARCH, "--reduced", "--steps", "3", "--batch", "2",
                "--seq", "16", "--device", "cpu", "--save", ckpt])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[train] qwen2-vl-2b-smoke: ")
    assert lines[-1] == f"[train] saved -> {ckpt}"
    like = _reference("float32")[1]
    got = jload(ckpt, like)
    assert jax.tree.structure(got) == jax.tree.structure(like)
    assert all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree.leaves(got))


def test_checkpoints_cross_both_ways(tmp_path):
    """An f32 tree written by the port loads bitwise in the reference and
    the reference's in the port; the bridge round-trips."""
    jm, jp = _reference("float32")
    tm = _port("float32")
    want = jax.tree.map(np.asarray, jp)
    jax.tree.map(np.testing.assert_array_equal, bridge.params_to_jax(tm),
                 want)
    path = str(tmp_path / "port.npz")
    save(path, loop.param_tree(tm), {"arch": ARCH})
    jax.tree.map(lambda g, w: np.testing.assert_array_equal(
        np.asarray(g), w), jload(path, jp), want)
    ref_path = str(tmp_path / "ref.npz")
    moved = jax.tree.map(lambda a: a * 0.5, jp)
    jsave(ref_path, moved, {"arch": ARCH})
    fresh = TransformerModel(get_reduced(ARCH).replace(dtype="float32"),
                             device="cpu")
    got = load(ref_path, loop.param_tree(fresh))
    for (kp, g), w in zip(tree.flatten_with_path(got),
                          jax.tree.leaves(moved)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=tree.keystr(kp))
