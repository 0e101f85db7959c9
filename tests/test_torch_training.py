"""The port's training path against the reference's, on the CPU in f32:
the learning-rate schedule, global-norm clipping, AdamW and Adafactor
(stacked leaves included), the chunked cross-entropy, the DiT's and the
LM's losses and parameter gradients (the dense LM and the reduced
arctic-480b MoE, whose loss adds the router's aux), three steps of
``make_train_step`` (one Adafactor step of the MoE), the reference's
learning checks and the launcher.

The reference runs under ``jax.jit`` on the CPU, the port on the CPU with
the reference's parameters copied through ``repro_torch.bridge`` and the
same seeded inputs (numpy).  Tolerances: the schedule and clipping rtol
1e-6; optimizer updates rtol 1e-5, atol 1e-7; chunked CE's nll rtol 1e-5,
its token count exact; losses and gradients rtol 1e-4, atol 1e-6;
parameters after three train steps within 1e-4 of each leaf's scale.

The smoke DiT's block gradients are conditioned worse than that in f32:
its fan-in init drives attention logits to ~140 (test_torch_model.py), and
scaling the input latents by 1 + 1.2e-7 (one ulp) moves the port's own
gradients by up to 8.4e-5 of each leaf's largest element.  Its gradients
are held to 2e-4 of each leaf's scale (the port against the reference:
1.3e-4 at most), the final layer's, which backpropagation reaches before
any block, to rtol 1e-4 / atol 1e-6.  AdamW's first moves are
g / |g| per element, so elements whose gradient lies in that noise move
by +-lr in either package: after a step the DiT's parameters (the launcher's
adaLN-zero start) are held to the reference's trajectory through the
metrics (rtol 1e-4) and to the
reference's optimizer replayed on the port's own clipped gradients
(rtol 1e-5), the LM's also elementwise within 1e-4 of each leaf's scale.

The reduced MoE (arctic-480b, f32, ample capacity) has no qk-norm, so its
attention logits are large too (``tests/test_torch_transformer.py``):
scaling its embedding table by one ulp moves the port's own gradients by
up to 2.7e-4 of a leaf's largest element (attention's ``wk``; measured),
and the port lands 1.3e-4 from the reference at most.  Its gradients are
held to ``MOE_GRAD_SCALE`` = 5e-4 of each leaf's scale, its loss and
metrics to rtol 1e-4.
"""
import tests.torch_threads  # noqa: F401  (first: one thread)
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load as jload
from repro.models import build_model as jbuild_model
from repro.models import transformer as jtransformer
from repro.training import loop as jloop
from repro.training import optimizer as jopt
from repro_torch import bridge, tree
from repro_torch.data import latent_stream, token_stream
from repro_torch.launch import train as train_launcher
from repro_torch.models import flags
from repro_torch.models import transformer as ttransformer
from repro_torch.training import loop, optimizer as topt
from repro.configs import get_reduced as jget_reduced
from repro_torch.configs import get_reduced
from repro_torch.models.transformer import TransformerModel
from tests.conftest import f32_cfg
from tests.test_torch_model import jax_config, jax_dit, port_dit
from tests.test_torch_transformer import jax_llm, port_llm

MOE_ARCH = "arctic-480b"
L = 3          # layers of the optimizer tests' stacked leaves
OPT_TOL = dict(rtol=1e-5, atol=1e-7)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
DIT_GRAD_SCALE = 2e-4   # the smoke DiT's block gradients, of a leaf's scale
MOE_GRAD_SCALE = 5e-4   # the reduced MoE's gradients, of a leaf's scale


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


# ---------------------------------------------------------------------------
# schedule, clipping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("base_lr,warmup,total",
                         [(3e-4, 20, 100), (1e-3, 5, 60), (3e-4, 5, 30),
                          (1e-2, 0, 7)])
def test_cosine_schedule_matches_reference(base_lr, warmup, total):
    """Against the reference's schedule op by op.  (Under ``jax.jit`` XLA
    fuses the cosine and lands up to 2e-6 away where 1 + cos nears 0.)"""
    jfn = jopt.cosine_schedule(base_lr, warmup, total)
    fn = topt.cosine_schedule(base_lr, warmup, total)
    got = np.array([fn(s) for s in range(total + 1)])
    want = np.array([float(jfn(jnp.int32(s))) for s in range(total + 1)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _tree(seed: int, scale: float = 1.0):
    """A parameter-shaped tree: top-level 2-D and 1-D leaves and stacked
    leaves of ndim 1 + L and 2 + L."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "b": (5,),
              "blocks": {"bias": (L, 7), "kernel": (L, 4, 7)}}

    def draw(shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    return {"w": draw(shapes["w"]), "b": draw(shapes["b"]),
            "blocks": {k: draw(s) for k, s in shapes["blocks"].items()}}


def _port(np_tree):
    return tree.map(lambda a: torch.from_numpy(a.copy()), np_tree)


def _jax(np_tree):
    return jax.tree.map(jnp.asarray, np_tree)


def _close(got_tree, want_tree, **tol):
    for (path, g), w in zip(tree.flatten_with_path(got_tree),
                            jax.tree.leaves(want_tree)):
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32),
                                   err_msg=tree.keystr(path), **tol)


@pytest.mark.parametrize("max_norm", [0.5, 1e3], ids=["clips", "passes"])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(1)
    jg, jnorm = jax.jit(lambda t: jopt.clip_by_global_norm(t, max_norm))(
        _jax(g))
    tg, tnorm = topt.clip_by_global_norm(_port(g), max_norm)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    _close(tg, jg, rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(topt.global_norm(_port(g))),
                               float(jopt.global_norm(_jax(g))), rtol=1e-6)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_reference(name):
    """Three updates on the same seeded gradients, at the schedule's lr:
    parameters and every state leaf, stacked leaves included."""
    jo, to = jopt.make_optimizer(name), topt.make_optimizer(name)
    p0 = _tree(0)
    jp, tp = _jax(p0), _port(p0)
    js, ts = jo.init(jp), to.init(tp)
    lr_fn = topt.cosine_schedule(1e-2, 1, 3)
    jupdate = jax.jit(jo.update)
    for step in range(3):
        g = _tree(10 + step, scale=0.1)
        jp, js = jupdate(_jax(g), js, jp, jnp.float32(lr_fn(ts.step)))
        tp, ts = to.update(_port(g), ts, tp, lr_fn(ts.step))
        assert ts.step == int(js.step) == step + 1
        _close(tp, jp, **OPT_TOL)
        for field in ts._fields[1:]:
            _close(getattr(ts, field), getattr(js, field), **OPT_TOL)


def test_adamw_decays_a_stacked_bias():
    """With zero gradients the update is decay alone: the reference decays
    its stacked (L, d) bias (ndim 2) but not a top-level (d,) bias, and the
    port's tree of stacked leaves does the same."""
    p0 = _tree(0)
    zeros = tree.map(np.zeros_like, p0)
    jp, js = _jax(p0), jopt.AdamW().init(_jax(p0))
    jp, _ = jopt.AdamW().update(_jax(zeros), js, jp, 0.5)
    tp = _port(p0)
    tp, _ = topt.AdamW().update(_port(zeros), topt.AdamW().init(tp), tp, 0.5)
    _close(tp, jp, **OPT_TOL)
    np.testing.assert_array_equal(tp["b"].numpy(), p0["b"])
    np.testing.assert_allclose(tp["blocks"]["bias"].numpy(),
                               p0["blocks"]["bias"] * (1 - 0.5 * 0.1),
                               rtol=1e-6)


def test_adamw_decays_the_moe_router_and_experts():
    """The MoE's stacked leaves under AdamW with zero gradients: the
    router (ndim 2 a layer, (L, D, E) stacked), the (L, E, D, F) experts
    and, stacked to ndim 2, the (L, D) norm decay; the top-level (D,)
    final norm does not, as in the reference."""
    _, jp, model, _ = _models("moe")
    params = loop.param_tree(model)
    p0 = tree.map(lambda t: np.array(_np(t)), params)
    zeros = tree.map(np.zeros_like, p0)
    want, _ = jopt.AdamW().update(_jax(zeros), jopt.AdamW().init(_jax(p0)),
                                  _jax(p0), 0.5)
    got, _ = topt.AdamW().update(_port(zeros), topt.AdamW().init(params),
                                 params, 0.5)
    _close(got, want, **OPT_TOL)
    moe, moe0 = got["blocks"]["pos0"]["moe"], p0["blocks"]["pos0"]["moe"]
    for name in ("router", "we_gate", "wd_down", "norm"):
        np.testing.assert_allclose(moe[name].numpy(),
                                   moe0[name] * (1 - 0.5 * 0.1), rtol=1e-6)
    np.testing.assert_array_equal(got["final_norm"].numpy(),
                                  p0["final_norm"])


def test_make_optimizer_rejects_unknown_names():
    with pytest.raises(KeyError):
        topt.make_optimizer("sgd")


# ---------------------------------------------------------------------------
# chunked cross-entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True], ids=["saved", "remat"])
@pytest.mark.parametrize("s,chunk", [(13, 5), (12, 4), (6, 512)])
def test_chunked_ce_matches_reference(monkeypatch, s, chunk, remat):
    """Sum of nll and token count, the padding branch (S % chunk != 0)
    included, and the gradient wrt the hidden states and the head."""
    monkeypatch.setattr(flags, "CE_REMAT", remat)
    rng = np.random.default_rng(s)
    b, d, v = 2, 16, 40
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    head = rng.standard_normal((v, d)).astype(np.float32)
    tgt = rng.integers(0, v, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.8).astype(np.float32)
    fn = jax.jit(lambda h, w: jtransformer.chunked_ce(
        h, w, jnp.asarray(tgt), jnp.asarray(mask), chunk=chunk))
    jnll, jden = fn(h, head)
    jgh, jgw = jax.grad(lambda h, w: fn(h, w)[0], argnums=(0, 1))(h, head)
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(head).requires_grad_(True)
    nll, den = ttransformer.chunked_ce(th, tw, torch.from_numpy(tgt),
                                       torch.from_numpy(mask), chunk=chunk)
    nll.backward()
    np.testing.assert_allclose(float(nll.detach()), float(jnll), rtol=1e-5)
    assert float(den) == float(jden)
    np.testing.assert_allclose(th.grad.numpy(), jgh, **GRAD_TOL)
    np.testing.assert_allclose(tw.grad.numpy(), jgw, **GRAD_TOL)


# ---------------------------------------------------------------------------
# losses and gradients of the two models
# ---------------------------------------------------------------------------

def _dit_batch(cfg, b: int = 4, seed: int = 0):
    rng = np.random.default_rng(seed)
    img, ch = cfg.dit.image_size, cfg.dit.in_channels
    return {"latents": rng.standard_normal((b, img, img, ch)).astype(
                np.float32),
            "t": rng.integers(0, 1000, b).astype(np.int32),
            "labels": rng.integers(0, cfg.dit.num_classes + 1, b).astype(
                np.int32),
            "noise": rng.standard_normal((b, img, img, ch)).astype(
                np.float32)}


def _llm_batch(cfg, b: int = 3, s: int = 24, seed: int = 0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}


def _models(family: str, remat: bool = True, unzero: bool = True):
    """(reference model, its params, the port's model, a batch); the DiT
    un-zeroed as the serving tests have it, or with ``unzero=False`` as the
    reference's ``model.init`` leaves it (adaLN-zero: the launcher's)."""
    if family == "dit":
        if unzero:
            jcfg, jm, jp = jax_dit("smoke")
        else:
            jcfg = jax_config("smoke")
            jm = jbuild_model(jcfg)
            jp = jm.init(jax.random.PRNGKey(0))
        model = port_dit(jcfg, jp)
        batch = _dit_batch(jcfg)
    elif family == "moe":           # f32_cfg's ample capacity: no drop
        jcfg = f32_cfg(jget_reduced(MOE_ARCH))
        jm = jbuild_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        model = TransformerModel(f32_cfg(get_reduced(MOE_ARCH)),
                                 device="cpu")
        bridge.transformer_params_from_jax(jax.tree.map(np.asarray, jp),
                                           model)
        batch = _llm_batch(jcfg)
    else:
        jcfg, jm, jp = jax_llm("float32")
        model = port_llm("float32", jp)
        batch = _llm_batch(jcfg)
    model.cfg = model.cfg.replace(remat=remat)
    return jm, jp, model, batch


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _backward(model, batch):
    """The model's loss and metrics, backpropagated into its bound
    gradients."""
    loss, metrics = model.loss(_tb(batch))
    loss.backward()
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "saved"])
@pytest.mark.parametrize("family", ["dit", "llm", "moe"])
def test_loss_and_grads_match_reference(family, remat):
    jm, jp, model, batch = _models(family, remat)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(jp, jax.tree.map(jnp.asarray, batch))
    loop.param_tree(model)
    grads = loop.grad_tree(model)
    loss, metrics = _backward(model, batch)
    np.testing.assert_allclose(float(loss), float(jloss), **GRAD_TOL)
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   **GRAD_TOL, err_msg=k)
    for (path, g), w in zip(tree.flatten_with_path(grads),
                            jax.tree.leaves(jgrads)):
        w, key = np.asarray(w), tree.keystr(path)
        assert float(g.abs().max()) > 0, key
        if family == "dit" and not key.startswith("['final_"):
            tol = dict(rtol=0, atol=DIT_GRAD_SCALE * float(np.abs(w).max()))
        elif family == "moe":
            tol = dict(rtol=0, atol=MOE_GRAD_SCALE * float(np.abs(w).max()))
        else:
            tol = GRAD_TOL
        np.testing.assert_allclose(g.numpy(), w, err_msg=key, **tol)


def test_param_tree_shares_the_models_storage():
    """Block leaves are (L, ...) stacks whose rows are the per-layer
    parameters; gradients land in the stacked buffers."""
    _, jp, model, batch = _models("dit")
    params = loop.param_tree(model)
    want = jax.tree.map(np.asarray, jp)
    _close(params, want, rtol=0, atol=0)
    params["blocks"]["wq"][1].add_(1.0)
    assert torch.equal(model.blocks[1].wq, params["blocks"]["wq"][1])
    grads = loop.grad_tree(model)
    _backward(model, batch)
    assert model.blocks[1].wq.grad.data_ptr() == \
        grads["blocks"]["wq"][1].data_ptr()
    assert model.pos_emb.grad.data_ptr() == grads["pos_emb"].data_ptr()


@pytest.mark.parametrize("family", ["dit", "llm"])
def test_train_step_matches_reference(family):
    """Three steps of ``make_train_step`` beside the reference's: the
    metrics; the parameters equal to the reference's AdamW replayed on the
    port's clipped gradients, state and parameters of that step; the LM's
    parameters within 1e-4 of each leaf's scale of the reference's.  The
    DiT starts as the launcher starts it (adaLN-zero): un-zeroed, the
    trajectories part by AdamW's +-lr on noise-level gradients and the
    second step's loss by 1.2e-4 of itself."""
    jm, jp, model, batch = _models(family, unzero=False)
    lr_fn = topt.cosine_schedule(1e-3, 2, 3)
    jopt_ = jopt.AdamW()
    jstep = jax.jit(jloop.make_train_step(
        jm, jopt_, jopt.cosine_schedule(1e-3, 2, 3)))
    jreplay = jax.jit(jopt_.update)
    js = jopt_.init(jp)
    params = loop.param_tree(model)
    to = topt.AdamW()
    ts = to.init(params)
    step = loop.make_train_step(model, to, lr_fn)
    snap = lambda t: jax.tree.map(jnp.asarray, tree.map(
        lambda x: np.array(_np(x)), t))     # copies: the port works in place
    for i in range(3):
        b = (_dit_batch if family == "dit" else _llm_batch)(
            jm.cfg, seed=i)
        jp, js, jmet = jstep(jp, js, jax.tree.map(jnp.asarray, b))
        before = (snap(params), jopt.AdamWState(
            step=jnp.int32(ts.step), mu=snap(ts.mu), nu=snap(ts.nu)))
        params, ts, met = step(params, ts, _tb(b))
        assert set(met) == set(jmet)
        for k in met:
            np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {i} {k}")
        rp, rs = jreplay(snap(step.grads), before[1], before[0],
                         jnp.float32(met["lr"]))
        _close(params, rp, **OPT_TOL)
        _close(ts.mu, rs.mu, **OPT_TOL)
        if family == "llm":
            for (path, p), w in zip(tree.flatten_with_path(params),
                                    jax.tree.leaves(jp)):
                w = np.asarray(w)
                np.testing.assert_allclose(
                    p.detach().numpy(), w, rtol=0,
                    atol=1e-4 * float(np.abs(w).max()),
                    err_msg=f"step {i} {tree.keystr(path)}")


def test_adafactor_step_on_the_moe_matches_reference():
    """One ``make_train_step`` step of the reduced arctic-480b with its
    config's optimizer, Adafactor, beside the reference's: the metrics
    (nll, moe_aux, loss); the parameters equal to the reference's Adafactor
    replayed on the port's clipped gradients (the (L, E, D, F) expert
    leaves factored over (D, F), rows (L, E, D) and columns (L, E, F), the
    RMS over the whole leaf) and within ``MOE_GRAD_SCALE`` of each leaf's
    scale of the reference's step (Adafactor divides each gradient by its
    factored RMS, so the gradients' noise carries into the step as it is:
    measured 1.5e-4 of the embedding's scale)."""
    jm, jp, model, batch = _models("moe")
    assert model.cfg.optimizer == "adafactor"
    jopt_ = jopt.Adafactor()
    jstep = jax.jit(jloop.make_train_step(
        jm, jopt_, jopt.cosine_schedule(1e-3, 2, 3)))
    js = jopt_.init(jp)
    params = loop.param_tree(model)
    to = topt.make_optimizer(model.cfg.optimizer)
    ts = to.init(params)
    assert tuple(ts.vr["blocks"]["pos0"]["moe"]["we_gate"].shape) == (
        2, 4, 256)
    assert tuple(ts.vc["blocks"]["pos0"]["moe"]["we_gate"].shape) == (
        2, 4, 512)
    before = jax.tree.map(jnp.asarray, tree.map(
        lambda x: np.array(_np(x)), params))
    step = loop.make_train_step(model, to, topt.cosine_schedule(1e-3, 2, 3))
    jp2, js2, jmet = jstep(jp, js, jax.tree.map(jnp.asarray, batch))
    params, ts, met = step(params, ts, _tb(batch))
    assert set(met) == set(jmet)
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    rp, rs = jax.jit(jopt_.update)(
        jax.tree.map(jnp.asarray, tree.map(lambda x: np.array(_np(x)),
                                           step.grads)),
        js, before, jnp.float32(met["lr"]))
    _close(params, rp, **OPT_TOL)
    _close(ts.vr, rs.vr, **OPT_TOL)
    _close(ts.vc, rs.vc, **OPT_TOL)
    for (path, p), w in zip(tree.flatten_with_path(params),
                            jax.tree.leaves(jp2)):
        w = np.asarray(w)
        np.testing.assert_allclose(
            p.detach().numpy(), w, rtol=0,
            atol=MOE_GRAD_SCALE * float(np.abs(w).max()),
            err_msg=tree.keystr(path))


def test_train_step_reads_nothing_back():
    """The metrics of a step are device scalars (``lr`` a host float) and
    the optimizer's step count a host int."""
    _, _, model, batch = _models("dit")
    params = loop.param_tree(model)
    opt = topt.AdamW()
    state = opt.init(params)
    step = loop.make_train_step(model, opt, topt.cosine_schedule(1e-3, 1, 4))
    params, state, met = step(params, state, _tb(batch))
    assert isinstance(state.step, int) and state.step == 1
    assert isinstance(met["lr"], float)
    assert all(isinstance(v, torch.Tensor) and v.ndim == 0
               for k, v in met.items() if k != "lr")


# ---------------------------------------------------------------------------
# the reference's learning checks (tests/test_system.py), on the port
# ---------------------------------------------------------------------------

def test_training_learns_synthetic_structure():
    """A tiny LM must beat its initial loss clearly on the Markov stream."""
    _, jp, model, _ = _models("llm")
    it = token_stream(model.cfg.vocab_size, 8, 64, seed=3, device="cpu")
    _, _, hist = loop.train(model, loop.param_tree(model),
                            topt.AdamW(weight_decay=0.0),
                            topt.cosine_schedule(1e-3, 5, 60), it, steps=60,
                            log_every=59)
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.5, hist


def test_dit_training_reduces_mse():
    _, _, model, _ = _models("dit")
    cfg = model.cfg
    it = latent_stream(4, cfg.dit.image_size, cfg.dit.in_channels,
                       num_classes=cfg.dit.num_classes, seed=1, device="cpu")
    _, _, hist = loop.train(model, loop.param_tree(model),
                            topt.AdamW(weight_decay=0.0),
                            topt.cosine_schedule(1e-3, 5, 40), it, steps=40,
                            log_every=39)
    assert hist[-1]["loss"] < hist[0]["loss"], hist
    assert [h["step"] for h in hist] == [0, 39]
    assert set(hist[0]) == {"loss", "grad_norm", "lr", "mse", "step",
                            "elapsed_s"}


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

LINE = re.compile(r"^\[train\] step +\d+ loss=\d+\.\d{4} lr=\d\.\d\de[-+]\d\d "
                  r"\|g\|=\d+\.\d\d \(\d+\.\ds\)$")


def _launch(capsys, *args):
    """``launch/train.py``'s ``main`` in this process: its printed lines."""
    capsys.readouterr()
    train_launcher.main(list(args))
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("arch,extra", [
    ("dit-xl2", ["--batch", "4"]),
    ("qwen3-0.6b", ["--batch", "4", "--seq", "32"])])
def test_launcher_trains_and_saves(tmp_path, capsys, arch, extra):
    """The reference's lines (header, a step line at 0, 10 and the last
    step, the save line), and a checkpoint that the reference's ``load``
    reads into its own tree of the reduced config in f32."""
    ckpt = str(tmp_path / "model.npz")
    lines = _launch(capsys, "--arch", arch, "--reduced", "--steps", "12",
                    "--device", "cpu", "--save", ckpt, *extra)
    assert re.match(r"^\[train\] [\w.-]+-smoke: \d+\.\dM params, "
                    r"opt=adamw$", lines[0]), lines[0]
    steps = [int(re.search(r"step +(\d+)", ln).group(1)) for ln in lines[1:-1]]
    assert steps == [0, 10, 11]
    assert all(LINE.match(ln) for ln in lines[1:-1]), lines
    assert lines[-1] == f"[train] saved -> {ckpt}"
    if arch == "dit-xl2":
        jcfg, jm, _ = jax_dit("smoke")
    else:
        jcfg, jm, _ = jax_llm("float32")
    like = jm.init(jax.random.PRNGKey(1))
    got = jload(ckpt, like)
    assert jax.tree.structure(got) == jax.tree.structure(like)
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree.leaves(got))


def test_launcher_trains_the_moe_with_adafactor(tmp_path, capsys):
    """The MoE family through the launcher on the CPU: the reduced
    arctic-480b with its config's Adafactor, saved and read back by the
    reference's ``load`` into its own tree."""
    ckpt = str(tmp_path / "moe.npz")
    lines = _launch(capsys, "--arch", MOE_ARCH, "--reduced", "--steps", "3",
                    "--batch", "2", "--seq", "16", "--device", "cpu",
                    "--save", ckpt)
    assert re.match(r"^\[train\] arctic-480b-smoke: \d+\.\dM params, "
                    r"opt=adafactor$", lines[0]), lines[0]
    assert all(LINE.match(ln) for ln in lines[1:-1]), lines
    like = jbuild_model(jget_reduced(MOE_ARCH).replace(
        dtype="float32")).init(jax.random.PRNGKey(1))
    got = jload(ckpt, like)
    assert jax.tree.structure(got) == jax.tree.structure(like)
    assert got["blocks"]["pos0"]["moe"]["we_up"].shape == (2, 4, 256, 512)
