"""The port's audio family (HuBERT-XLarge's encoder) against the reference's,
on the CPU: LayerNorm, the tanh-GELU FFN, the LayerNorm attention sublayer
(bidirectional), the feature frontend stub (projection and 15-tap
positional conv), the encoder's ``apply``, its masked-prediction ``loss``
and gradients, three train steps, the launchers and the checkpoints; and
the plain ``flash_attention`` at HuBERT's head layout (MHA, dh 80,
``causal=False``) against the reference's Pallas kernel in interpret mode.

Model: ``get_reduced("hubert-xlarge")``: 2 layers, d 256, 4 heads of 64
(MHA), GELU FFN 512, frontend 64, vocab 504, LayerNorm eps 1e-5, no RoPE,
with the reference's parameters (``model.init(PRNGKey(0))``) copied
through ``repro_torch.bridge``; inputs drawn with numpy from a seed.

Tolerances: LayerNorm, the FFN and the frontend rtol/atol 1e-4 in f32 and
5e-2 of the tensor's scale in bf16 (``tests/test_torch_transformer.py``'s
rules). The encoder has no qk-norm, so its attention sublayer and
whole-model outputs take that file's rule for such configs: f32 atol 5e-4
of the tensor's scale (measured 3.2e-4 on a sublayer output of scale 16,
2.2e-4 on hidden states of scale 4), and for the whole model bf16 in
relative L2 within 5e-2 (measured 1.8e-2; a 1-ulp change of a bf16 q or k
moves a logit by ~0.25 at the reference's init, so elementwise bf16 outputs
move by up to 6e-2 of their scale, while the GELU FFN is bitwise and the
attention sublayer within 2e-3 in relative L2). Losses and gradients as
``tests/test_torch_training.py`` holds the LM's no-qk-norm MoE: loss rtol
1e-4, gradients within 5e-4 of each leaf's scale.
"""
import tests.torch_threads  # noqa: F401  (first: one thread)
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load as jload
from repro.checkpoint import save as jsave
from repro.configs import get_reduced as jget_reduced
from repro.data import audio_stream as jaudio_stream
from repro.kernels import ops as jops
from repro.models import build_model as jbuild_model
from repro.models import common as jcommon
from repro.models import layers as jlayers
from repro.training import loop as jloop
from repro.training import optimizer as jopt
from repro_torch import bridge, tree
from repro_torch.checkpoint import load, save
from repro_torch.configs import get_reduced
from repro_torch.cuda_kernels import ref as tref
from repro_torch.data import audio_stream
from repro_torch.launch import serve, train
from repro_torch.models import common, layers
from repro_torch.models.transformer import TransformerModel
from repro_torch.training import loop, optimizer as topt
from tests.test_torch_transformer import Tol, assert_close, pair_tol

ARCH = "hubert-xlarge"
DTYPES = ("float32", "bfloat16")
GRAD_SCALE = 5e-4       # gradients, of a leaf's scale (no qk-norm)
REL_L2_BF16 = 5e-2
GRAD_NORM_RTOL = 1e-3   # a train step's gradient norm after an update


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
    """(reference model, its params, the port's model with them), shared by
    the tests that only run forward passes."""
    return _reference(dtype) + (_port(dtype),)


def _tol(dtype: str) -> Tol:
    return Tol(1e-4, 1e-4, False) if dtype == "float32" else \
        Tol(5e-2, 5e-2, True)


def _features(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _batch(feats: np.ndarray):
    return ({"features": jnp.asarray(feats)},
            {"features": torch.from_numpy(feats)})


def _rel_l2(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got.float().numpy() - want)
                 / np.linalg.norm(want))


def _block(jp):
    return jax.tree.map(lambda a: a[0], jp["blocks"])["pos0"]


def _hidden(dtype: str, seed: int):
    """A (2, 24, 256) hidden state of the model's dtype, in both packages."""
    x = _features((2, 24, 256), seed)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_norm_matches_reference(dtype):
    jx, tx = _hidden(dtype, 1)
    w, b = _features((256,), 2), _features((256,), 3)
    want = jcommon.layer_norm(jx, jnp.asarray(w), jnp.asarray(b), 1e-5)
    got = common.layer_norm(tx, torch.from_numpy(w), torch.from_numpy(b),
                            1e-5)
    assert got.dtype == tx.dtype
    assert_close(got, want, _tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_gelu_ffn_matches_reference(dtype):
    """LayerNorm, then ``w_in`` + ``b_in``, tanh GELU, ``w_out`` + ``b_out``
    and the residual; the biases drawn nonzero."""
    jm, jp, tm = _pair(dtype)
    p = dict(_block(jp)["ffn"])
    rng = np.random.default_rng(4)
    for name in ("norm_b", "b_in", "b_out"):
        p[name] = jnp.asarray(0.1 * rng.standard_normal(p[name].shape),
                              p[name].dtype)
    group = layers.ParamGroup(layers.ffn_defs(tm.cfg, "gelu"), tm.dtype,
                              tm.device)
    for name in group.defs:
        getattr(group, name).copy_(bridge.tensor_from_numpy(
            np.asarray(p[name]), tm.device))
    jx, tx = _hidden(dtype, 5)
    assert_close(layers.ffn_apply(group, tx, tm.cfg),
                 jlayers.ffn_apply(p, jx, jm.cfg), _tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_layernorm_attention_matches_reference(dtype):
    """The encoder's attention sublayer: LayerNorm (its ``norm_b`` drawn
    nonzero), bidirectional full-sequence attention, the residual."""
    jm, jp, tm = _pair(dtype)
    p = dict(_block(jp)["attn"])
    p["norm_b"] = jnp.asarray(0.1 * _features((256,), 6))
    grp = tm.blocks[0].attn
    saved = grp.norm_b.clone()
    grp.norm_b.copy_(torch.from_numpy(np.asarray(p["norm_b"])))
    try:
        jx, tx = _hidden(dtype, 7)
        want, _ = jlayers.attn_apply(p, jx, cfg=jm.cfg, positions=None)
        got, cache = layers.attn_apply(grp, tx, cfg=tm.cfg)
    finally:
        grp.norm_b.copy_(saved)
    assert cache is None
    assert_close(got, want, pair_tol(ARCH, dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_embed_features(dtype):
    """The frontend stub: features cast to the model dtype, projected, the
    positional conv's taps in f32, ``x + gelu(pos)`` (tanh GELU)."""
    jm, jp, tm = _pair(dtype)
    jb, tb = _batch(_features((2, 24, 64), 8))
    got = tm.embed(tb)
    assert got.dtype == tm.dtype and got.shape == (2, 24, 256)
    assert_close(got, jm.embed(jp, jb), _tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_matches_reference(dtype):
    jm, jp, tm = _pair(dtype)
    jb, tb = _batch(_features((2, 40, 64), 9))
    want, _ = jm.apply(jp, jb)
    got = tm.apply(tb)
    if dtype == "float32":
        assert_close(got, want, pair_tol(ARCH, dtype))
    else:
        assert _rel_l2(got, want) < REL_L2_BF16


def test_encoder_is_bidirectional():
    """The reference's ``test_encoder_is_bidirectional``: changing late
    frames changes early hidden states; the port agrees with the
    reference on both inputs."""
    jm, jp, tm = _pair("float32")
    feats = _features((1, 16, 64), 10)
    feats2 = feats.copy()
    feats2[:, 12:] += 1.0
    h1 = tm.apply(_batch(feats)[1])
    h2 = tm.apply(_batch(feats2)[1])
    assert not torch.allclose(h1[:, :8], h2[:, :8], atol=1e-5)
    assert_close(h2, jm.apply(jp, _batch(feats2)[0])[0],
                 pair_tol(ARCH, "float32"))


def _audio_batch(b: int, s: int, seed: int):
    return next(jaudio_stream(b, s, 64, 504, seed=seed))


def test_loss_and_grads_with_mask_indices():
    """The masked-prediction loss over ``targets`` at ``mask_indices``
    and every parameter's gradient (the frontend's included)."""
    jm, jp = _reference("float32")
    tm = _port("float32")
    batch = jax.tree.map(np.array, _audio_batch(2, 24, 11))
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(jp, jax.tree.map(jnp.asarray, batch))
    loop.param_tree(tm)
    grads = loop.grad_tree(tm)
    loss, met = tm.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert set(met) == set(jmet)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-4)
    assert float(met["tokens"]) == float(jmet["tokens"]) == \
        batch["mask_indices"].sum()
    for (path, g), w in zip(tree.flatten_with_path(grads),
                            jax.tree.leaves(jgrads)):
        w = np.asarray(w)
        assert float(g.abs().max()) > 0, tree.keystr(path)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=0, atol=GRAD_SCALE * np.abs(w).max(),
            err_msg=tree.keystr(path))


def _snap(t):
    """A port tree (tensors) as the reference's tree of jnp copies."""
    return jax.tree.map(jnp.asarray, tree.map(
        lambda x: np.array(x.detach().float().numpy()), t))


def test_three_train_steps_match_reference():
    """Three ``make_train_step`` AdamW steps on the ported
    ``audio_stream`` (the reference's batches, drawn from the same seed).
    Each step starts the reference's step from the port's parameters and
    optimizer state: its metrics (rtol 1e-4; the gradients' global norm
    within ``GRAD_NORM_RTOL``: after the first update the gradients grow
    from a norm of 45 to 169 and one ulp of the input features moves the
    port's own norm by 4.4e-4 of itself, the reference's lies 5.7e-4 away;
    measured), and the
    port's parameters and moments equal (rtol 1e-5) to the reference's
    AdamW replayed on the port's clipped gradients.  (Left to run apart,
    the two trajectories part after the first update: AdamW moves an
    element whose gradient lies in the no-qk-norm noise by +-lr in either
    package, as ``tests/test_torch_training.py`` measures for the DiT.)"""
    jm, _ = _reference("float32")
    tm = _port("float32")
    jopt_ = jopt.AdamW()
    jstep = jax.jit(jloop.make_train_step(
        jm, jopt_, jopt.cosine_schedule(1e-3, 2, 3)))
    jreplay = jax.jit(jopt_.update)
    params = loop.param_tree(tm)
    to = topt.AdamW()
    ts = to.init(params)
    step = loop.make_train_step(tm, to, topt.cosine_schedule(1e-3, 2, 3))
    jit, it = (jaudio_stream(2, 16, 64, 504, seed=12),
               audio_stream(2, 16, 64, 504, seed=12, device="cpu"))
    for i in range(3):
        jb, tb = next(jit), next(it)
        np.testing.assert_array_equal(tb["features"].numpy(),
                                      np.asarray(jb["features"]))
        start = (_snap(params), jopt.AdamWState(
            step=jnp.int32(ts.step), mu=_snap(ts.mu), nu=_snap(ts.nu)))
        _, _, jmet = jstep(*start, jb)
        params, ts, met = step(params, ts, tb)
        assert set(met) == set(jmet)
        for k in jmet:
            np.testing.assert_allclose(
                float(met[k]), float(jmet[k]), atol=1e-6,
                rtol=GRAD_NORM_RTOL if k == "grad_norm" else 1e-4,
                err_msg=f"step {i} {k}")
        rp, rs = jreplay(_snap(step.grads), start[1], start[0],
                         jnp.float32(met["lr"]))
        for got, want in ((params, rp), (ts.mu, rs.mu), (ts.nu, rs.nu)):
            for g, w in zip(jax.tree.leaves(_snap(got)),
                            jax.tree.leaves(want)):
                np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                           rtol=1e-5, atol=1e-7,
                                           err_msg=f"step {i}")


def test_train_launcher_trains_and_saves(tmp_path, capsys):
    """``launch/train.py`` on the reduced encoder: the reference's lines and
    a checkpoint that the reference's ``load`` reads into its own tree."""
    ckpt = str(tmp_path / "hubert.npz")
    train.main(["--arch", ARCH, "--reduced", "--steps", "3", "--batch", "2",
                "--seq", "16", "--device", "cpu", "--save", ckpt])
    lines = capsys.readouterr().out.splitlines()
    assert re.match(r"^\[train\] hubert-xlarge-smoke: \d+\.\dM params, "
                    r"opt=adamw$", lines[0]), lines[0]
    assert [int(re.search(r"step +(\d+)", ln).group(1))
            for ln in lines[1:-1]] == [0, 2]
    assert all(np.isfinite(float(re.search(r"loss=(\S+)", ln).group(1)))
               for ln in lines[1:-1])
    got = jload(ckpt, _reference("float32")[1])
    assert jax.tree.structure(got) == jax.tree.structure(
        _reference("float32")[1])
    assert "embed" not in got and got["pos_conv"].shape == (15, 256)


def test_serve_launcher_refuses_the_encoder():
    """The reference's launcher line for an encoder-only config."""
    with pytest.raises(SystemExit,
                       match="hubert-xlarge-smoke is encoder-only: no decode "
                             "serving"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])


def test_checkpoints_cross_both_ways(tmp_path):
    """An f32 encoder tree (the audio top-level keys, ``norm_b``, the GELU
    FFN's leaves) written by the port loads bitwise in the reference, and
    the reference's loads bitwise in the port; the bridge round-trips."""
    jm, jp = _reference("float32")
    tm = _port("float32")
    want = jax.tree.map(np.asarray, jp)
    back = bridge.params_to_jax(tm)
    assert sorted(back) == sorted(want) == [
        "blocks", "feat_bias", "feat_proj", "final_norm", "lm_head",
        "pos_conv"]
    assert set(back["blocks"]["pos0"]["attn"]) >= {"norm", "norm_b"}
    assert set(back["blocks"]["pos0"]["ffn"]) == {
        "norm", "norm_b", "w_in", "b_in", "w_out", "b_out"}
    jax.tree.map(np.testing.assert_array_equal, back, want)
    path = str(tmp_path / "port.npz")
    save(path, loop.param_tree(tm), {"arch": ARCH})
    jax.tree.map(lambda g, w: np.testing.assert_array_equal(
        np.asarray(g), w), jload(path, jp), want)
    ref_path = str(tmp_path / "ref.npz")
    moved = jax.tree.map(lambda a: a + 0.25, jp)
    jsave(ref_path, moved, {"arch": ARCH})
    fresh = TransformerModel(get_reduced(ARCH).replace(dtype="float32"),
                             device="cpu")
    got = load(ref_path, loop.param_tree(fresh))
    for (kp, g), w in zip(tree.flatten_with_path(got),
                          jax.tree.leaves(moved)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=tree.keystr(kp))


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_flash_attention_bidirectional_dh80(dtype):
    """The plain ``flash_attention`` at HuBERT-XLarge's head layout (16
    heads of 80, MHA, ``causal=False``, no window) against the reference's
    Pallas kernel in interpret mode, at S = 128 (the Pallas kernel needs S
    divisible by its 64 tile; the card holds S = 500 against this plain
    version), within ``tests/test_torch_flash_attention.py``'s
    tolerances."""
    rng = np.random.default_rng(13)
    arrs = [rng.standard_normal((1, 16, 128, 80)).astype(np.float32)
            for _ in range(3)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jx = [jnp.asarray(a, jdt) for a in arrs]
    tx = [torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in jx]
    got = tref.flash_attention(*tx, causal=False, window=0)
    want = jops.flash_attention(*jx, causal=False, window=0, bq=64, bk=64,
                                interpret=True)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
