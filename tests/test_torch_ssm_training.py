"""Training the SSM (xlstm-1.3b: mLSTM and sLSTM blocks) and hybrid
(jamba-v0.1-52b: Mamba, attention and MoE layers) families, port against
reference, on the CPU in f32: each mixer's gradients, the Mamba scan's
gradients (and its no-grad call bit for bit its autograd call), the
models' loss, metrics and every gradient leaf against
``jax.value_and_grad`` of the reference's ``loss`` (remat on and off),
Adafactor's blocked update, AdamW's buckets and slices, and
``launch/train.py`` against the reference's train loop.

The reference runs under ``jax.jit`` on the CPU, the port on the CPU with
the reference's parameters copied through ``repro_torch.bridge`` and the
same seeded inputs (numpy).  Tolerances: ``tests/test_torch_training.py``'s
``GRAD_TOL`` (rtol 1e-4, atol 1e-6) for losses and metrics; optimizer
updates rtol 1e-5, atol 1e-7 (``OPT_TOL``); the launcher's printed losses
(4 decimals) within 2e-4.

Gradients: rtol 1e-4 and an atol in units of each leaf's scale (its
largest element), for f32 rounding does not shrink with a gradient's
size: scaling the embedding table by 1 + 2^-23 (one ulp) moves the port's
own gradients by up to 3.4e-6 of a leaf's scale in the reduced xLSTM
(measured), and the port lands 3.2e-6 of a leaf's scale from the
reference at most, past an absolute 1e-6 on 3 of the embedding's 131,072
elements (leaf scale 1.2).  So xLSTM and each mixer alone are held to
``SSM_GRAD_SCALE`` = 1e-5 of a leaf's scale.  The reduced Jamba has no
qk-norm and an MoE (as ``tests/test_torch_training.py``'s MoE): one ulp of
its embedding moves its own gradients by up to 2.0e-4 of a leaf's scale
(the Mamba layer's ``w_x_proj``; measured), the port lands 2.1e-4 from the
reference, and it is held to ``MOE_GRAD_SCALE`` = 5e-4 of a leaf's scale.
Each leaf's relative L2 error is held to the same number: in the reduced
models the port's largest lies at 2.75e-6 (xLSTM) and 1.71e-4 (Jamba)
from the reference's, where one ulp of the embedding moves the port's own
by 2.59e-6 and 1.70e-4 (measured).
It runs with ample MoE capacity (``f32_cfg``: no token dropped), as the
MoE's gradient tests do, so that no routing choice sits at a capacity
edge.
"""
import tests.torch_threads  # noqa: F401  (first: one thread)
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.data import token_stream as jtoken_stream
from repro.models import build_model as jbuild_model
from repro.models import mamba as jmamba
from repro.models import ssm as jssm
from repro.training import loop as jloop
from repro.training import optimizer as jopt
from repro_torch import bridge, tree
from repro_torch.configs import get_reduced
from repro_torch.launch import train as train_launcher
from repro_torch.models import mamba, ssm
from repro_torch.models.transformer import TransformerModel
from repro_torch.training import loop, optimizer as topt
from tests.conftest import f32_cfg
from tests.test_torch_ssm import mixer_pair
from tests.test_torch_training import (GRAD_TOL, LINE, MOE_GRAD_SCALE,
                                       OPT_TOL, _close)

ARCHS = ("xlstm-1.3b", "jamba-v0.1-52b")
SSM_GRAD_SCALE = 1e-5          # of a leaf's scale: xLSTM, the mixers
GRAD_SCALE = {"xlstm-1.3b": SSM_GRAD_SCALE, "jamba-v0.1-52b": MOE_GRAD_SCALE}
MIXER_APPLY = {"mamba": (jmamba.mamba_apply, mamba.mamba_apply),
               "mlstm": (jssm.mlstm_apply, ssm.mlstm_apply),
               "slstm": (jssm.slstm_apply, ssm.slstm_apply)}


def _models(arch: str, remat: bool = True):
    """(reference model, its params, the port's model with them), f32,
    ample MoE capacity."""
    jm = jbuild_model(f32_cfg(jget_reduced(arch)))
    jp = jm.init(jax.random.PRNGKey(0))
    model = TransformerModel(
        f32_cfg(get_reduced(arch)).replace(remat=remat), device="cpu")
    bridge.transformer_params_from_jax(jax.tree.map(np.asarray, jp), model)
    return jm, jp, model


def grads_close(got: torch.Tensor, want, scale: float, key: str) -> None:
    """rtol 1e-4, atol ``scale`` of the leaf's largest element, and the
    leaf's relative L2 error at most ``scale`` (so its small entries are
    held too)."""
    want = np.asarray(want)
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=scale * float(np.abs(want).max()),
                               err_msg=key)
    err = np.linalg.norm((got - want).astype(np.float64))
    assert err <= scale * np.linalg.norm(want.astype(np.float64)), key


def _tokens(b: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 512, (b, s)).astype(
        np.int32)


# --------------------------------------------------------------------------
# the mixers under autograd
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", list(MIXER_APPLY))
def test_mixer_gradients_match_reference(kind):
    """One mixer block's full-sequence form (24 positions, 2 sequences;
    mLSTM in chunks of 12, sLSTM token by token, Mamba's scan over one
    chunk) under autograd: the gradient of a fixed projection of its output
    wrt its input and every parameter, against ``jax.grad``."""
    jcfg, cfg, jp, group = mixer_pair(kind, "float32", seed=3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    japply, tapply = MIXER_APPLY[kind]

    def jloss(p, xx):
        return jnp.sum(japply(p, xx, cfg=jcfg)[0] * w)

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    for p in group.parameters():
        p.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    (tapply(group, tx, cfg=cfg)[0] * torch.from_numpy(w)).sum().backward()
    grads_close(tx.grad, jgx, SSM_GRAD_SCALE, "x")
    for name, g in jax.tree.map(np.asarray, jgp).items():
        got = getattr(group, name).grad
        assert float(got.abs().max()) > 0, name
        grads_close(got, g, SSM_GRAD_SCALE, name)


@pytest.mark.parametrize("length", [1, 2, 7, 16, 64, 100])
def test_mamba_scans_are_bitwise_equal(length):
    """The chunk scan called as a ``no_grad`` prefill calls it and as
    training does (autograd recording) gives the same bits, y and the last
    state; and its gradients wrt every input (of a fixed projection of y
    and the last state) match ``jax.grad`` of the reference's scan."""
    rng = np.random.default_rng(length)
    arrays = [rng.random((2, length, 12, 8)).astype(np.float32),
              *(rng.standard_normal(s).astype(np.float32)
                for s in ((2, length, 12, 8), (2, length, 8), (2, 12, 8)))]
    wy = rng.standard_normal((2, length, 12)).astype(np.float32)
    wh = rng.standard_normal((2, 12, 8)).astype(np.float32)
    with torch.no_grad():
        y_ng, h_ng = mamba._chunk_scan(*map(torch.from_numpy, arrays))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    y, h = mamba._chunk_scan(*ts)
    assert torch.equal(y.detach(), y_ng) and torch.equal(h.detach(), h_ng)
    ((y * torch.from_numpy(wy)).sum()
     + (h * torch.from_numpy(wh)).sum()).backward()

    def jloss(*xs):
        jy, jh = jmamba._chunk_scan(*xs)
        return jnp.sum(jy * wy) + jnp.sum(jh * wh)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(
        *map(jnp.asarray, arrays))
    for name, t, w in zip(("da", "dbx", "c", "h0"), ts, want):
        grads_close(t.grad, w, SSM_GRAD_SCALE, name)


# --------------------------------------------------------------------------
# the models' loss and gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [True, False], ids=["remat", "saved"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, remat):
    """Next-token loss of 3 x 24 tokens (Jamba: its MoE aux added) and
    every gradient leaf of the reference's tree (``blocks/pos{i}``
    stacks), against ``jax.value_and_grad`` of the reference's ``loss``."""
    jm, jp, model = _models(arch, remat)
    batch = {"tokens": _tokens(3, 24, seed=5)}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(jp, {"tokens": jnp.asarray(batch["tokens"])})
    loop.param_tree(model)
    grads = loop.grad_tree(model)
    loss, met = model.loss({"tokens": torch.from_numpy(batch["tokens"])})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               **GRAD_TOL)
    assert set(met) == set(jmet)
    for k in met:
        np.testing.assert_allclose(float(met[k].detach()), float(jmet[k]),
                                   err_msg=k, **GRAD_TOL)
    if arch == "jamba-v0.1-52b":
        assert float(met["moe_aux"].detach()) > 0
    flat = tree.flatten_with_path(grads)
    assert len(flat) == len(jax.tree.leaves(jgrads))
    for (path, g), w in zip(flat, jax.tree.leaves(jgrads)):
        key = tree.keystr(path)
        assert float(g.abs().max()) > 0, key
        grads_close(g, w, GRAD_SCALE[arch], key)


# --------------------------------------------------------------------------
# Adafactor on a leaf updated in row blocks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("update_bytes", [960, 4096, 1 << 30],
                         ids=["blocked", "matrices", "whole"])
def test_adafactor_row_blocks_match_reference(monkeypatch, update_bytes):
    """Three Adafactor updates of an (L, E, D, F) = (2, 3, 20, 24) leaf
    beside a (20, 24) and a (24,) one, against the reference's Adafactor,
    with ``UPDATE_BYTES`` = 960 (every factored leaf in blocks of 10 rows:
    the full-width expert banks' path), 4096 (the expert leaf in blocks of
    two whole matrices) and at its default (each leaf one block)."""
    monkeypatch.setattr(topt, "UPDATE_BYTES", update_bytes)
    rng = np.random.default_rng(7)
    shapes = {"experts": (2, 3, 20, 24), "w": (20, 24), "b": (24,)}

    def draw(scale):
        return {k: (scale * rng.standard_normal(s)).astype(np.float32)
                for k, s in shapes.items()}

    p0 = draw(1.0)
    jo, to = jopt.Adafactor(weight_decay=0.1), topt.Adafactor(
        weight_decay=0.1)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = tree.map(lambda a: torch.from_numpy(a.copy()), p0)
    js, ts = jo.init(jp), to.init(tp)
    jupdate = jax.jit(jo.update)
    for step in range(3):
        g = draw(0.1)
        jp, js = jupdate(jax.tree.map(jnp.asarray, g), js, jp,
                         jnp.float32(1e-2))
        tp, ts = to.update(tree.map(torch.from_numpy, g), ts, tp, 1e-2)
        _close(tp, jp, **OPT_TOL)
        _close(ts.vr, js.vr, **OPT_TOL)
        _close(ts.vc, js.vc, **OPT_TOL)


def _adamw_runs(monkeypatch, nbytes):
    """Three AdamW updates of four leaves (2-D and 3-D ones decayed), at
    ``UPDATE_BYTES`` = 1 GiB (one bucket) and at ``nbytes``: (params,
    state) of each."""
    rng = np.random.default_rng(8)
    shapes = {"a": (6, 5), "b": (5,), "c": (3, 4, 7), "d": (40,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    gs = [{k: (0.1 * rng.standard_normal(s)).astype(np.float32)
           for k, s in shapes.items()} for _ in range(3)]
    out = []
    for size in (1 << 30, nbytes):
        monkeypatch.setattr(topt, "UPDATE_BYTES", size)
        opt = topt.AdamW()
        p = tree.map(lambda a: torch.from_numpy(a.copy()), p0)
        st = opt.init(p)
        for g in gs:
            p, st = opt.update(tree.map(torch.from_numpy, g), st, p, 1e-2)
        out.append((p, st))
    return out


def test_adamw_buckets_are_bitwise_the_whole_update(monkeypatch):
    """AdamW over buckets of at most ``UPDATE_BYTES`` (here 400: a leaf or
    two a bucket) gives the same bits as over all leaves at once."""
    (p1, s1), (p2, s2) = _adamw_runs(monkeypatch, 400)
    assert s1.step == s2.step == 3
    for a, b in zip(tree.leaves((p1, s1.mu, s1.nu)),
                    tree.leaves((p2, s2.mu, s2.nu))):
        assert torch.equal(a, b)


def test_adamw_slices_of_a_large_leaf_are_bitwise_the_whole_update(
        monkeypatch):
    """With ``UPDATE_BYTES`` = 52 (13 elements), every leaf is larger than
    the bound and runs in flat slices, the last one short; the 2-D and 3-D
    leaves' slices are still decayed: the same bits as the whole update,
    and the update moved every leaf."""
    (p1, s1), (p2, s2) = _adamw_runs(monkeypatch, 52)
    for a, b in zip(tree.leaves((p1, s1.mu, s1.nu)),
                    tree.leaves((p2, s2.mu, s2.nu))):
        assert torch.equal(a, b)
    assert all(float(m.abs().min()) > 0 for m in tree.leaves(s2.mu))


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_like_the_reference(arch, capsys, monkeypatch):
    """``launch/train.py --arch <arch> --reduced --device cpu --steps 3``
    (batch 2 x 32 tokens) with the reference's initial parameters (its
    ``model.init(PRNGKey(0))``, copied in for the launcher's own draw):
    the reference's lines, the config's optimizer (xLSTM AdamW, Jamba
    Adafactor), and the logged losses (steps 0 and 2) within 2e-4 of the
    reference's train loop's on its own ``token_stream`` with the same
    seed (the two streams draw the same tokens)."""
    jcfg = jget_reduced(arch).replace(dtype="float32")
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))

    def init_model(cfg, device, seed):
        model = TransformerModel(cfg, device=device)
        return bridge.transformer_params_from_jax(
            jax.tree.map(np.asarray, jp), model)

    monkeypatch.setattr(train_launcher, "init_model", init_model)
    capsys.readouterr()
    train_launcher.main(["--arch", arch, "--reduced", "--steps", "3",
                         "--batch", "2", "--seq", "32", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert re.match(rf"^\[train\] {re.escape(jcfg.name)}: \d+\.\dM params, "
                    rf"opt={jcfg.optimizer}$", lines[0]), lines[0]
    assert len(lines) == 3 and all(LINE.match(ln) for ln in lines[1:]), lines
    got = [float(re.search(r"loss=(\S+)", ln).group(1)) for ln in lines[1:]]
    _, _, hist = jloop.train(
        jm, jp, jopt.make_optimizer(jcfg.optimizer),
        jopt.cosine_schedule(3e-4, 20, 3), jtoken_stream(512, 2, 32, seed=0),
        steps=3, log_every=10)
    want = [h["loss"] for h in hist]
    assert [h["step"] for h in hist] == [0, 2]
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    assert np.isfinite(got).all()
