"""The port's LLM training on a mesh (``training/sharded.py``) on ``gloo``
ranks on the CPU, against the reference's single-device ``train_step``.

The ranks (``tests/torch_sharded_train_ranks.py``, the port alone) start
for every mesh at once and run while the reference computes: each holds
its block of the reference's reduced f32 parameters (copied through
``bridge``, then cut by ``param_specs``), its rows of the same seeded
numpy batches (4 rows, so that ``data = 2`` cuts them) and its block of
the optimizer state; rank 0 answers with the gathered trees.  The
reference runs jitted on one CPU device, as ``tests/test_torch_training.
py`` runs it.

- One step of every arch (qwen3-0.6b: tied, qk-norm; qwen3-14b: untied
  head; arctic-480b: MoE with a parallel dense FFN, Adafactor; kimi-k2:
  a shared expert, Adafactor; qwen2-vl-2b: M-RoPE; hubert-xlarge: GELU,
  LayerNorm, bidirectional, vocab 504) on (2, 2) and (1, 4), the dense one
  also on (2, 1) and (1, 2), held twice.  Against the single-device port
  on the same inputs (``make_train_step``): the loss and metrics within
  rtol 1e-4, the gathered clipped gradients within ``GRAD_TOL`` (the
  qk-norm dense configs) or within ``GRAD_SCALE`` = 5e-4 of each leaf's
  scale (the MoE and the no-qk-norm configs, whose single-device ports
  are held so: ``tests/test_torch_training.py``, ``_vlm.py``,
  ``_audio.py``; their gradient norm, a function of those gradients, to
  rtol ``GRAD_SCALE`` too: HuBERT's moves 1.3e-4 between the sharded and
  the single-device step).  Against the reference: the same tolerances plus the
  single-device port's own distance to the reference on these inputs,
  metric by metric and leaf by leaf (on this batch it is up to 1.3e-4 of
  Arctic's gradient norm and 1.1e-3 of Qwen2-VL's, whose attention logits
  are large at the reference's init: no qk-norm).  On (1, 4) the 2 kv
  heads are replicated and each rank's q head takes its own; Arctic's and
  Kimi's 4 experts are one a rank.  Arctic with 3 experts on (1, 2): the
  experts replicated beside its cut dense FFN.
- Three steps of qwen3-0.6b and Arctic on (2, 2): the metrics of each
  step; the parameters and the optimizer state equal to the reference's
  optimizer replayed on the gathered clipped gradients, state and
  parameters of that step (``OPT_TOL``); the dense LM's parameters within
  ``DENSE_PARAM_SCALE`` of each leaf's scale of the reference's own
  trajectory.
- (1, 1): the sharded step is ``make_train_step``, bitwise, on the
  weights ``init_sharded`` draws (those of the launcher's ``init_model``).
- Drops: Arctic at capacity factor 0.5 on (2, 1): the kept copies of
  every dispatch equal the single-device port's on the whole batch
  (``test_torch_moe.py`` holds those to the reference), some are dropped,
  and the loss and metrics equal the reference's.
- Collective bytes: the counting comms on ``meta`` (the dry run's
  ``collective_bytes``) give, kind by kind, exactly the bytes rank 0 of
  the gloo ranks counted on (2, 2), for every arch.
- The ``native`` transport (``all_gather_into_tensor`` /
  ``reduce_scatter_tensor``, NCCL's, which gloo runs on the CPU) gives the
  staged transport's step bitwise on (2, 2) (sums of two ranks are
  exact either way).
- The SSM and hybrid families: xlstm-1.3b (mLSTM and sLSTM, AdamW) and
  jamba-v0.1-52b (Mamba, attention, MoE, Adafactor), two steps on (2, 1),
  (1, 2), (2, 2) and (1, 4) (on (1, 4) a rank holds half an sLSTM head's
  gate columns and one of Jamba's 4 experts), against the reference: the
  losses of its two jitted steps (``METRIC_TOL``); the step-0 metrics
  (``METRIC_TOL``, the gradient norm ``GRAD_SCALE``) and every clipped
  gradient leaf of step 0 within ``SSM_SCALE`` of the leaf's scale
  (``tests/test_torch_ssm_training.py``'s SSM parity: 1e-5 for xLSTM,
  5e-4 for Jamba), by atol (with rtol 1e-4) and by relative L2; step 1's
  metrics and gradients likewise, against the reference's step on batch
  1 at the parameters the ranks' step 0 left, each leaf's tolerance
  widened by the single-device port's own distance there (two steps of
  the reference from its own step 0 move step 1's gradients by up to
  1.2e-4 of a leaf's scale for xLSTM and 1.5e-2 for Jamba: AdamW's and
  Adafactor's first updates amplify step 0's 1e-5 differences; at the
  same parameters the ranks land 1.2e-5 and 6.2e-4 from the reference;
  measured on these inputs); the parameters and optimizer
  state after each of the two steps equal to the reference's optimizer
  replayed on that step's gathered gradients, state and parameters
  (``OPT_TOL``), as the three-step runs.  xLSTM on (1, 4) is held to
  ``SSM_SCALE_1x4`` = 3e-5: there the row-parallel products of the
  mLSTM's q, k, v and gates are sums of four f32 partial products, and
  splitting every f32 product of the single-device port into four partial
  sums alike moves its own gradients by up to 2.3e-5 in relative L2 (the
  first mLSTM's ``conv_w``; two partial sums: 1.3e-5; measured), while
  the (1, 4) ranks land 1.6e-5 from the reference on that leaf.
- The launcher: ``--mesh 2,1 --reduced --device cpu`` prints the
  reference's lines with the single-device run's numbers, and its
  ``--save`` loads in the reference's ``load`` and equals the (1, 1)
  run's file within 1e-4 of each leaf's scale; ``--arch xlstm-1.3b
  --mesh 1,2`` prints the single-device run's step-0 line;
  ``--production-mesh`` without 256 ranks and an odd batch on (2, 1) are
  refused before any rank starts.
"""
import tests.torch_threads  # noqa: F401  (first: one thread)
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load as jload
from repro.configs import get_reduced as jget_reduced
from repro.models import build_model as jbuild_model
from repro.training import loop as jloop
from repro.training import optimizer as jopt
from repro_torch import bridge, tree
from repro_torch.configs import get_reduced
from repro_torch.distributed import collectives
from repro_torch.launch import dryrun
from repro_torch.launch import train as train_launcher
from repro_torch.models import layers
from repro_torch.models.transformer import TransformerModel
from repro_torch.training import loop, optimizer as topt, sharded
from tests.conftest import f32_cfg
from tests.torch_sharded_train_ranks import MeshJobs

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3-0.6b", "qwen3-14b", "arctic-480b", "kimi-k2-1t-a32b",
         "qwen2-vl-2b", "hubert-xlarge")
DENSE = "qwen3-0.6b"
MOE = "arctic-480b"
THREE_STEPS = (DENSE, MOE)
ONE_STEP_MESHES = {(2, 2): ARCHS, (1, 4): ARCHS, (2, 1): (DENSE,),
                   (1, 2): (DENSE,)}
# the SSM and hybrid families: two steps on every mesh, held to the
# reference at tests/test_torch_ssm_training.py's parity
SSM_ARCHS = ("xlstm-1.3b", "jamba-v0.1-52b")
SSM_MESHES = ((2, 1), (1, 2), (2, 2), (1, 4))
SSM_SCALE = {"xlstm-1.3b": 1e-5, "jamba-v0.1-52b": 5e-4}
SSM_SCALE_1x4 = 3e-5      # xLSTM on (1, 4): the docstring
B, S = 4, 24
LR = (1e-3, 2, 3)                   # cosine_schedule(base, warmup, total)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
GRAD_SCALE = 5e-4
OPT_TOL = dict(rtol=1e-5, atol=1e-7)
DENSE_PARAM_SCALE = 1e-4
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
TIGHT_CAPACITY = 0.5
# Arctic with 3 experts on (1, 2): the experts do not divide ``model`` and
# run whole on both ranks, while its parallel dense FFN is cut
REPLICATED_EXPERTS = 3


def _cfgs(arch, capacity=None, experts=None):
    """(reference config, port config): reduced, f32, the MoE's capacity
    ample (``f32_cfg``) or ``capacity``, its expert count ``experts``."""
    jcfg, cfg = (f32_cfg(c(arch)) for c in (jget_reduced, get_reduced))
    for key, val in (("capacity_factor", capacity), ("num_experts", experts)):
        if val is not None:
            jcfg, cfg = (c.replace(moe=dataclasses.replace(
                c.moe, **{key: val})) for c in (jcfg, cfg))
    return jcfg, cfg


def _batches(cfg, n: int):
    rng = np.random.default_rng(11)
    if cfg.family == "audio":
        return [{"features": rng.standard_normal(
                    (B, S, cfg.frontend_dim)).astype(np.float32),
                 "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                     np.int32),
                 "mask_indices": rng.random((B, S)) < 0.3}
                for _ in range(n)]
    return [{"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)} for _ in range(n)]


def _job(name, arch, steps, capacity=None, experts=None, **kw):
    jcfg, cfg = _cfgs(arch, capacity, experts)
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    job = dict(name=name, cfg=cfg, params=jax.tree.map(np.asarray, jp),
               batches=_batches(cfg, steps), lr=LR, **kw)
    return job, (jm, jp)


def _reference_step(jm, jp, batch, step: int = 0):
    """The reference's loss, metrics and clipped gradients of step
    ``step`` at the parameters ``jp``."""
    (loss, met), grads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(jp, jax.tree.map(jnp.asarray, batch))
    clipped, norm = jopt.clip_by_global_norm(grads, 1.0)
    lr = float(jopt.cosine_schedule(*LR)(jnp.int32(step)))
    metrics = {"loss": float(loss), "grad_norm": float(norm), "lr": lr}
    metrics.update({k: float(v) for k, v in met.items()})
    return metrics, jax.tree.map(np.asarray, clipped)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's ranks, started at once; the reference meanwhile."""
    jobs, refs = {}, {}
    for topo, archs in ONE_STEP_MESHES.items():
        jobs[topo] = []
        for arch in archs:
            steps = 3 if topo == (2, 2) and arch in THREE_STEPS else 1
            job, ref = _job(arch, arch, steps)
            jobs[topo].append(job)
            refs[arch] = (ref, job["batches"])
    for topo in SSM_MESHES:
        jobs.setdefault(topo, [])
        for arch in SSM_ARCHS:
            job, ref = _job(arch, arch, 2)
            jobs[topo].append(job)
            refs[arch] = (ref, job["batches"])
    native, _ = _job("native", DENSE, 1, transport="native")
    jobs[(2, 2)].append(native)
    tight, tight_ref = _job("tight", MOE, 1, capacity=TIGHT_CAPACITY,
                            trace=True)
    jobs[(2, 1)].append(tight)
    repl, repl_ref = _job("replicated", MOE, 1, experts=REPLICATED_EXPERTS)
    jobs[(1, 2)].append(repl)
    group = MeshJobs(jobs, tmp_path_factory.mktemp("ranks"))
    want = {arch: _reference_step(jm, jp, batches[0])
            for arch, ((jm, jp), batches) in refs.items()}
    want["tight"] = _reference_step(*tight_ref, tight["batches"][0])
    want["replicated"] = _reference_step(*repl_ref, repl["batches"][0])
    single = {arch: _single_step(arch, batches[0])
              for arch, (_, batches) in refs.items()}
    single["replicated"] = _single_step(MOE, repl["batches"][0],
                                        experts=REPLICATED_EXPERTS)
    got = group.results()
    return {"got": got, "want": want, "single": single, "refs": refs,
            "tight": tight}


def _single_step(arch, batch, capacity=None, experts=None, params=None):
    """The single-device port's metrics and clipped gradients of one step
    (``make_train_step``) on the reference's parameters, or on ``params``
    (a global numpy tree)."""
    model = _port_model(arch, capacity, experts, params)
    params = loop.param_tree(model)
    opt = topt.make_optimizer(model.cfg.optimizer)
    step = loop.make_train_step(model, opt, topt.cosine_schedule(*LR))
    _, _, met = step(params, opt.init(params),
                     {k: torch.from_numpy(v) for k, v in batch.items()})
    return loop.host_metrics(met), tree.map(
        lambda t: t.detach().numpy().copy(), step.grads)


def _grad_tol(arch, w, slack: float = 0.0):
    """The gradients' tolerance, its atol widened by ``slack``."""
    if _noisy(arch):
        return dict(rtol=0, atol=GRAD_SCALE * float(np.abs(w).max()) + slack)
    return dict(GRAD_TOL, atol=GRAD_TOL["atol"] + slack)


def _noisy(arch) -> bool:
    """The MoE and no-qk-norm configs: gradients held to ``GRAD_SCALE``."""
    cfg = get_reduced(arch)
    return cfg.moe is not None or not cfg.qk_norm


def _check_metrics(got, want, where, slack=None):
    """Each metric within ``METRIC_TOL`` (the gradient norm of a noisy
    config within ``GRAD_SCALE``, its gradients' tolerance), its rtol
    widened by ``slack``'s relative distance for that metric (a metrics
    dict)."""
    assert set(got) == set(want), where
    for k in want:
        rtol = METRIC_TOL["rtol"]
        if k == "grad_norm" and _noisy(where.split()[0]):
            rtol = GRAD_SCALE
        if slack is not None:
            rtol += abs(slack[k] - want[k]) / max(abs(want[k]), 1e-30)
        np.testing.assert_allclose(got[k], want[k], err_msg=f"{where} {k}",
                                   rtol=rtol, atol=METRIC_TOL["atol"])


# (job, arch, mesh); the job "replicated" is Arctic with experts that do
# not divide ``model`` (run whole on each rank) beside its dense FFN cut
# over it: the routed term's input gradient is not summed over ``model``
ONE_STEP = [(arch, arch, topo) for topo, archs in ONE_STEP_MESHES.items()
            for arch in archs] + [("replicated", MOE, (1, 2))]


@pytest.mark.parametrize(
    "name,arch,topo", ONE_STEP,
    ids=[f"{a}-{t[0]}x{t[1]}" if n == a else f"{a}-{n}-experts-{t[0]}x{t[1]}"
         for n, a, t in ONE_STEP])
def test_one_step_matches_reference(runs, name, arch, topo):
    got = runs["got"][topo][name]["steps"][0]
    wmet, wgrads = runs["want"][name]
    smet, sgrads = runs["single"][name]
    _check_metrics(got["metrics"], smet, f"{arch} {topo} vs the port")
    _check_metrics(got["metrics"], wmet, f"{arch} {topo} vs the reference",
                   slack=smet)
    for (path, g), s, w in zip(tree.flatten_with_path(got["grads"]),
                               tree.leaves(sgrads), jax.tree.leaves(wgrads)):
        key = tree.keystr(path)
        assert g.shape == w.shape, key
        assert np.abs(g).max() > 0, key
        np.testing.assert_allclose(g, s, err_msg=f"{topo} {key} vs the port",
                                   **_grad_tol(arch, s))
        np.testing.assert_allclose(
            g, w, err_msg=f"{topo} {key} vs the reference",
            **_grad_tol(arch, w, float(np.abs(s - w).max())))


def _ssm_close(got, want, scale: float, key: str, single=None) -> None:
    """rtol 1e-4, atol ``scale`` of the leaf's largest element, and the
    leaf's relative L2 error at most ``scale``; each widened by the
    single-device port's own distance to ``want`` (``single``, its leaf
    on the same inputs), where given."""
    gap = (np.zeros(1) if single is None
           else (single - want).astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=scale * float(np.abs(want).max())
                               + float(np.abs(gap).max()), err_msg=key)
    err = np.linalg.norm((got - want).astype(np.float64))
    assert err <= (scale * np.linalg.norm(want.astype(np.float64))
                   + np.linalg.norm(gap)), key


SSM_CASES = [(arch, topo) for topo in SSM_MESHES for arch in SSM_ARCHS]


@pytest.mark.parametrize("arch,topo", SSM_CASES,
                         ids=[f"{a}-{t[0]}x{t[1]}" for a, t in SSM_CASES])
def test_ssm_and_hybrid_two_steps_match_reference(runs, arch, topo):
    """The mixers cut over ``model`` (Mamba's and the mLSTM's fused input
    projections exchanged by an all-to-all, the sLSTM's gates gathered and
    its recurrence replicated) and over ``data`` (FSDP): the losses of the
    reference's two jitted steps; step 0's metrics and gradients, and
    step 1's at the parameters step 0 left, against the reference's; its
    optimizer replayed on both steps."""
    steps = runs["got"][topo][arch]["steps"]
    (jm, jp), batches = runs["refs"][arch]
    scale = SSM_SCALE[arch]
    if arch == "xlstm-1.3b" and topo == (1, 4):
        scale = SSM_SCALE_1x4
    for i, loss in enumerate(_reference_losses(runs, arch)):
        np.testing.assert_allclose(steps[i]["metrics"]["loss"], loss,
                                   **METRIC_TOL,
                                   err_msg=f"{arch} {topo} step {i} loss")
    p0 = steps[0]["params"]
    ref_p0 = jax.tree.unflatten(jax.tree.structure(jp), tree.leaves(p0))
    wants = [(runs["want"][arch], None),
             (_reference_step(jm, ref_p0, batches[1], 1),
              _single_step(arch, batches[1], params=p0)[1])]
    for i, ((wmet, wgrads), single) in enumerate(wants):
        _check_metrics(steps[i]["metrics"], wmet, f"{arch} {topo} step {i}")
        slack = ([None] * len(jax.tree.leaves(wgrads)) if single is None
                 else tree.leaves(single))
        for (path, g), w, s in zip(tree.flatten_with_path(steps[i]["grads"]),
                                   jax.tree.leaves(wgrads), slack):
            assert g.shape == w.shape, tree.keystr(path)
            _ssm_close(g, w, scale,
                       f"{topo} step {i} grad {tree.keystr(path)}", s)
    _replay_optimizer(arch, steps, jp)


def _reference_losses(runs, arch):
    """The loss of each of the reference's jitted train steps from its
    initial parameters, once per arch."""
    memo = runs.setdefault("losses", {})
    if arch not in memo:
        (jm, jp), batches = runs["refs"][arch]
        jo = jopt.make_optimizer(get_reduced(arch).optimizer)
        jstep = jax.jit(jloop.make_train_step(jm, jo,
                                              jopt.cosine_schedule(*LR)))
        js, memo[arch] = jo.init(jp), []
        for b in batches:
            jp, js, jmet = jstep(jp, js, jax.tree.map(jnp.asarray, b))
            memo[arch].append(float(jmet["loss"]))
    return memo[arch]


def _state_cls(name):
    return jopt.AdamWState if name == "adamw" else jopt.AdafactorState


def _replay_optimizer(arch, got, jp) -> None:
    """Each step's parameters and optimizer state equal to the reference's
    optimizer replayed on that step's gathered clipped gradients, state
    and parameters (``OPT_TOL``); ``jp`` the reference's initial
    parameters."""
    name = get_reduced(arch).optimizer
    jo = jopt.make_optimizer(name)
    jreplay = jax.jit(jo.update)
    params, state = jax.tree.map(np.asarray, jp), jo.init(jp)
    for i in range(len(got)):
        rp, rs = jreplay(got[i]["grads"], state, params,
                         jnp.float32(got[i]["metrics"]["lr"]))
        for (path, p), w in zip(tree.flatten_with_path(got[i]["params"]),
                                jax.tree.leaves(rp)):
            np.testing.assert_allclose(p, np.asarray(w), **OPT_TOL,
                                       err_msg=f"step {i} {tree.keystr(path)}")
        for f, leaves in got[i]["state"].items():
            for a, w in zip(tree.leaves(leaves),
                            jax.tree.leaves(getattr(rs, f))):
                np.testing.assert_allclose(a, np.asarray(w), **OPT_TOL,
                                           err_msg=f"step {i} {f}")
        params = got[i]["params"]
        state = _state_cls(name)(jnp.int32(i + 1), *(
            got[i]["state"][f] for f in _state_cls(name)._fields[1:]))


@pytest.mark.parametrize("arch", THREE_STEPS)
def test_three_steps_match_reference(runs, arch):
    (jm, jp), batches = runs["refs"][arch]
    got = runs["got"][(2, 2)][arch]["steps"]
    name = get_reduced(arch).optimizer
    jo = jopt.make_optimizer(name)
    jstep = jax.jit(jloop.make_train_step(jm, jo,
                                          jopt.cosine_schedule(*LR)))
    js = jo.init(jp)
    jp0 = jp
    for i, b in enumerate(batches):
        jp, js, jmet = jstep(jp, js, jax.tree.map(jnp.asarray, b))
        _check_metrics(got[i]["metrics"],
                       {k: float(v) for k, v in jmet.items()},
                       f"{arch} step {i}")
        if arch == DENSE:
            for (path, p), w in zip(tree.flatten_with_path(got[i]["params"]),
                                    jax.tree.leaves(jp)):
                w = np.asarray(w)
                np.testing.assert_allclose(
                    p, w, rtol=0, atol=DENSE_PARAM_SCALE * np.abs(w).max(),
                    err_msg=f"step {i} {tree.keystr(path)}")
    _replay_optimizer(arch, got, jp0)


def _port_model(arch, capacity=None, experts=None, params=None):
    jcfg, cfg = _cfgs(arch, capacity, experts)
    if params is None:
        params = jax.tree.map(np.asarray, jbuild_model(jcfg).init(
            jax.random.PRNGKey(0)))
    model = TransformerModel(cfg, device="cpu")
    return bridge.transformer_params_from_jax(params, model)


def test_tight_capacity_drops_the_references_copies(runs):
    got = runs["got"][(2, 1)]["tight"]
    _check_metrics(got["steps"][0]["metrics"], runs["want"]["tight"][0],
                   f"{MOE} at a tight capacity")
    model = _port_model(MOE, TIGHT_CAPACITY)
    params = loop.param_tree(model)
    opt = topt.make_optimizer(model.cfg.optimizer)
    step = loop.make_train_step(model, opt, topt.cosine_schedule(*LR))
    layers.MOE_TRACE = []
    try:
        step(params, opt.init(params), {
            k: torch.from_numpy(v) for k, v in
            runs["tight"]["batches"][0].items()})
        want = [t.numpy() for t in layers.MOE_TRACE]
    finally:
        layers.MOE_TRACE = None
    ranks = got["kept_by_rank"]
    assert len(ranks[0]) == len(want) >= model.cfg.num_layers
    for i, w in enumerate(want):
        np.testing.assert_array_equal(
            np.concatenate([ranks[0][i], ranks[1][i]]), w,
            err_msg=f"dispatch {i}")
    assert not all(w.all() for w in want), "nothing was dropped"


@pytest.mark.parametrize("arch", ARCHS + SSM_ARCHS)
def test_counting_comms_count_the_gloo_ranks_bytes(runs, arch):
    got = runs["got"][(2, 2)][arch]["steps"][0]["counts"]
    want = dryrun.collective_bytes(_cfgs(arch)[1], B, S, (2, 2))
    assert want == got
    assert got["all-gather"] > 0 and got["reduce-scatter"] > 0
    assert got["all-reduce"] > 0
    # Mamba's and the mLSTM's fused input projections: one all-to-all
    assert (got["all-to-all"] > 0) == (arch in SSM_ARCHS)


def test_native_transport_is_bitwise_the_staged(runs):
    a = runs["got"][(2, 2)]["native"]["steps"][0]
    b = runs["got"][(2, 2)][DENSE]["steps"][0]
    assert a["metrics"] == b["metrics"]
    assert a["counts"] == b["counts"]
    for x, y in zip(tree.leaves((a["grads"], a["params"])),
                    tree.leaves((b["grads"], b["params"]))):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("arch", [DENSE, MOE])
def test_one_rank_mesh_is_make_train_step_bitwise(arch):
    """``init_sharded`` + ``make_sharded_train_step`` on (1, 1) against
    ``init_model`` + ``make_train_step``: every loss and parameter."""
    cfg = _cfgs(arch)[1]
    mesh = sharded.counting_train_mesh((1, 1), B)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in _batches(cfg, 2)]
    out = []
    for make in ("plain", "sharded"):
        if make == "plain":
            model = train_launcher.init_model(cfg, "cpu", 3)
        else:
            model = sharded.init_sharded(cfg, "cpu", 3, mesh)
        params = loop.param_tree(model)
        opt = topt.make_optimizer(cfg.optimizer)
        state = opt.init(params)
        lr_fn = topt.cosine_schedule(*LR)
        step = (loop.make_train_step(model, opt, lr_fn) if make == "plain"
                else sharded.make_sharded_train_step(model, opt, lr_fn,
                                                     mesh))
        losses = []
        for b in batches:
            params, state, met = step(params, state, b)
            losses.append(met["loss"])
        out.append((losses, params))
    for x, y in zip(out[0][0], out[1][0]):
        assert torch.equal(x, y)
    for x, y in zip(tree.leaves(out[0][1]), tree.leaves(out[1][1])):
        assert torch.equal(x, y)


def test_init_sharded_draws_the_blocks_of_init_model():
    """Each rank's blocks on (2, 2) are the slices of the single-device
    init's leaves (the model cut in place by ``cut_model`` alike)."""
    cfg = _cfgs(MOE)[1]
    whole = loop.param_tree(train_launcher.init_model(cfg, "cpu", 5))
    for coords in ({"data": 0, "model": 1}, {"data": 1, "model": 0}):
        mesh = collectives.counting_mesh({"data": 2, "model": 2}, coords)
        model = sharded.init_sharded(cfg, "cpu", 5, mesh)
        specs = sharded.leaf_specs(model, mesh)
        want = sharded.shard_tree(whole, specs, mesh)
        cut = sharded.cut_model(train_launcher.init_model(cfg, "cpu", 5),
                                mesh)
        for a, b, c in zip(tree.leaves(loop.param_tree(model)),
                           tree.leaves(want),
                           tree.leaves(loop.param_tree(cut))):
            assert torch.equal(a, b) and torch.equal(a, c)
        assert model.cut_onto == (("data", 2), ("model", 2))
        # a cut model runs only under its mesh
        with pytest.raises(RuntimeError, match="cut onto"):
            model.prefill({"tokens": torch.zeros((1, 4), dtype=torch.long)},
                          8)


# --------------------------------------------------------------------------
# the collectives, alone
# --------------------------------------------------------------------------

def test_counting_comm_shapes_and_bytes():
    mesh = collectives.counting_mesh({"data": 4, "model": 2},
                                     {"data": 1, "model": 0})
    c = mesh.comm(("data",))
    x = torch.empty((3, 8), dtype=torch.bfloat16, device="meta")
    assert tuple(c.all_gather(x, 1).shape) == (3, 32)
    assert tuple(c.reduce_scatter(x, 1).shape) == (3, 2)
    assert tuple(c.all_reduce(x).shape) == (3, 8)
    mesh.comm(("model",)).all_reduce(x)
    assert mesh.counter.read() == {"all-gather": 192, "reduce-scatter": 12,
                                   "all-reduce": 96, "all-to-all": 0,
                                   "total": 300}
    assert mesh.with_batch_axes(("data",)).counter is mesh.counter


def test_mesh_comms_orders_ranks_major_first():
    m = collectives.counting_mesh({"pod": 2, "data": 4, "model": 2},
                                  {"pod": 1, "data": 2, "model": 1})
    assert m.comm(("model",)).rank == 1
    assert (m.comm(("pod", "data")).size,
            m.comm(("data", "pod")).rank) == (8, 6)
    assert m.comm(()) is None
    assert m.axis_sizes == (2, 4, 2)


def test_transport_follows_the_backend():
    assert collectives.transport_for("nccl") == "native"
    assert collectives.transport_for("gloo") == "staged"
    with pytest.raises(ValueError):
        collectives.transport_for("mpi")
    with pytest.raises(ValueError, match="needs a process group"):
        collectives.Comm(2, 0, "staged")


def test_batch_axes_refuse_a_batch_that_does_not_split():
    assert sharded.counting_train_mesh((2, 2), 4).batch_axes == ("data",)
    assert sharded.counting_train_mesh((2, 16, 16), 256).batch_axes == \
        ("pod", "data")
    assert sharded.counting_train_mesh((1, 4), 3).batch_axes == ()
    with pytest.raises(ValueError, match="does not split"):
        sharded.counting_train_mesh((2, 1), 3)


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

LINE = re.compile(r"\[train\] step +(\d+) loss=([\d.]+) lr=([\d.e+-]+) "
                  r"\|g\|=([\d.]+) \([\d.]+s\)")
LAUNCH = ["--arch", DENSE, "--reduced", "--device", "cpu", "--steps", "3",
          "--batch", "4", "--seq", "32"]


def test_launcher_mesh_prints_the_reference_lines(tmp_path, capsys):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *LAUNCH,
         "--mesh", "2,1", "--save", str(tmp_path / "mesh.npz")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    train_launcher.main(LAUNCH + ["--save", str(tmp_path / "one.npz")])
    one = capsys.readouterr().out.splitlines()
    mesh = [l for l in proc.stdout.splitlines() if l.startswith("[train]")]
    assert mesh[0] == one[0]                      # the params line
    assert re.fullmatch(r"\[train\] .+: [\d.]+M params, opt=adamw", one[0])
    got = [LINE.fullmatch(l).groups() for l in mesh[1:-1]]
    want = [LINE.fullmatch(l).groups() for l in one[1:-1]]
    assert [g[0] for g in got] == [w[0] for w in want] == ["0", "2"]
    for g, w in zip(got, want):
        np.testing.assert_allclose([float(x) for x in g[1:]],
                                   [float(x) for x in w[1:]], atol=2e-4)
    assert mesh[-1] == f"[train] saved -> {tmp_path / 'mesh.npz'}"
    like = jax.tree.map(np.asarray, jbuild_model(
        jget_reduced(DENSE).replace(dtype="float32")).init(
            jax.random.PRNGKey(0)))
    a = jload(str(tmp_path / "mesh.npz"), like)
    b = jload(str(tmp_path / "one.npz"), like)
    for (path, x), y in zip(jax.tree_util.tree_flatten_with_path(a)[0],
                            jax.tree.leaves(b)):
        y = np.asarray(y)
        np.testing.assert_allclose(np.asarray(x), y, rtol=0,
                                   atol=1e-4 * np.abs(y).max(),
                                   err_msg=str(path))


@pytest.mark.parametrize("argv,match", [
    (["--arch", DENSE, "--production-mesh"], "needs 256 ranks"),
    (["--arch", "xlstm-1.3b", "--mesh", "1,2", "--steps", "1"], None),
    (["--arch", DENSE, "--mesh", "2,1", "--batch", "3"], "does not split"),
], ids=["production_mesh", "ssm_arch", "odd_batch"])
def test_launcher_refuses(argv, match, capsys):
    """What a mesh cannot run is refused before any rank starts.  An SSM
    arch on (1, 2), refused until its mixers ran on a mesh, trains there
    (``match`` None) and prints the single-device run's step-0 line."""
    argv = argv + ["--reduced", "--device", "cpu"]
    if match is not None:
        with pytest.raises(SystemExit, match=match):
            train_launcher.main(argv)
        return
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *argv],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    i = argv.index("--mesh")
    train_launcher.main(argv[:i] + argv[i + 2:])
    one = capsys.readouterr().out.splitlines()
    mesh = [l for l in proc.stdout.splitlines() if l.startswith("[train]")]
    assert mesh[0] == one[0]                      # the params line
    got, want = (LINE.fullmatch(lines[1]).groups() for lines in (mesh, one))
    assert got[0] == want[0] == "0"
    np.testing.assert_allclose([float(x) for x in got[1:]],
                               [float(x) for x in want[1:]], atol=2e-4)
