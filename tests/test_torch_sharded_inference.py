"""The port's prefill and decode of the LLMs on a mesh (``distributed/
inference.py``: the sharded paths of ``models/layers.py``, ``mamba.py``,
``ssm.py`` and ``transformer.py``) on ``gloo`` ranks on the CPU, against
the reference's unsharded ``prefill`` / ``decode_step``.

The ranks (``tests/torch_sharded_infer_ranks.py``, the port alone) start
for every mesh at once and run while the reference computes.  Each holds
its block of the reference's reduced f32 parameters (copied through
``bridge``, cut by ``param_specs``) and runs, under the reference's rule
tables, a prefill of 2 x 24 tokens into a cache of 16 slots (so the
prefill takes the ring fill's ``S >= w`` branch) and 6 teacher-forced
decode steps (so the ring wraps); rank 0 answers with the gathered logits
of every step and the gathered caches.

- qwen3-0.6b (tied head, qk-norm), qwen3-14b (untied head), arctic-480b
  (MoE, a parallel dense FFN), qwen2-vl-2b (M-RoPE, text tokens),
  jamba-v0.1-52b (Mamba, attention, MoE) and xlstm-1.3b (mLSTM, sLSTM) on
  (2, 1), (1, 2), (2, 2) and (1, 4): every step's logits, the cache after
  the prefill (prefill layout: every slot and kv head of a rank's rows)
  and after the last step (decode layout: the slots over ``model``),
  within ``SCALE`` = 1e-4 of each leaf's scale.  The configs without
  qk-norm are held as ``tests/test_torch_transformer.py`` holds their
  single-device prefill and decode: rtol 1e-4 and atol
  ``NO_QK_NORM_ATOL`` = 5e-4 of the leaf's scale.  Jamba's Mamba state
  needs it on (1, 4): splitting every f32 product of the single-device
  port into four partial sums, as the row-parallel products on (1, 4)
  are, moves its prefill state from 6.9e-5 to 2.5e-4 of the state's
  scale (11.2) from the reference's (measured); the (1, 4) ranks land
  2.5e-4 from it.  On (1, 4) the 2 kv heads are replicated, the mLSTM's
  state is cut on its key dim (64 of 256) and Arctic's and Jamba's 4
  experts are one a rank.
- ``long_500k``'s layout: batch 1 on (2, 2), the slots over (data,
  model).
- hubert-xlarge's encode (``apply``) under the prefill rules.
- On (2, 2) the counting comms (the dry run's ``collective_bytes`` on
  ``meta``) give, kind by kind, the bytes rank 0 counted for the prefill
  and for the first decode step.
"""
import tests.torch_threads  # noqa: F401  (first: one thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_reduced as jget_reduced
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_reduced
from repro_torch.launch import dryrun
from repro_torch.models.transformer import TransformerModel
from tests.conftest import f32_cfg
from tests.test_torch_transformer import NO_QK_NORM_ATOL, port_cache
from tests import torch_sharded_infer_ranks as infer_ranks
from tests.torch_sharded_train_ranks import MeshJobs

ARCHS = ("qwen3-0.6b", "qwen3-14b", "arctic-480b", "qwen2-vl-2b",
         "jamba-v0.1-52b", "xlstm-1.3b")
MESHES = ((2, 1), (1, 2), (2, 2), (1, 4))
ENCODER = "hubert-xlarge"
LONG = "qwen3-0.6b"
B, S, W, STEPS = 2, 24, 16, 6
SCALE = 1e-4


def _cfgs(arch):
    """(reference config, port config): reduced, f32, the MoE's capacity
    ample (``f32_cfg``)."""
    return tuple(f32_cfg(c(arch)) for c in (jget_reduced, get_reduced))


def _job(arch, name=None, batch=B):
    jcfg, cfg = _cfgs(arch)
    jm = jbuild_model(jcfg)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    job = dict(name=name or arch, cfg=cfg, params=jp)
    if cfg.is_encoder:
        job["features"] = rng.standard_normal(
            (batch, S, cfg.frontend_dim)).astype(np.float32)
    else:
        job.update(
            tokens=rng.integers(0, cfg.vocab_size, (batch, S)).astype(
                np.int32),
            steps=rng.integers(0, cfg.vocab_size, (STEPS, batch)).astype(
                np.int32),
            window=W, long_context=name == "long")
    return job, (jm, jp)


def _reference(job, jm, jp):
    """The reference's logits of the prefill and of every decode step, and
    its caches after the prefill and after the last step (port layout)."""
    model = TransformerModel(job["cfg"], device="meta")
    if "features" in job:
        hidden, _ = jm.apply(jp, {"features": jnp.asarray(job["features"])})
        return {"hidden": np.asarray(hidden)}
    logits, cache = jm.prefill(jp, {"tokens": jnp.asarray(job["tokens"])},
                               job["window"])
    out = {"logits": [np.asarray(logits)],
           "prefill_cache": port_cache(cache, model)}
    step = jax.jit(jm.decode_step)
    for tok in job["steps"]:
        logits, cache = step(jp, jnp.asarray(tok), cache)
        out["logits"].append(np.asarray(logits))
    out["cache"] = port_cache(cache, model)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's ranks, started at once; the reference meanwhile."""
    jobs, refs = {}, {}
    for topo in MESHES:
        jobs[topo] = []
        for arch in ARCHS + (ENCODER,):
            job, ref = _job(arch)
            jobs[topo].append(job)
            refs[arch] = (job, ref)
    long_job, long_ref = _job(LONG, "long", batch=1)
    jobs[(2, 2)].append(long_job)
    refs["long"] = (long_job, long_ref)
    group = MeshJobs(jobs, tmp_path_factory.mktemp("ranks"),
                     run=infer_ranks.run)
    want = {name: _reference(job, *ref) for name, (job, ref) in refs.items()}
    return {"got": group.results(), "want": want, "jobs": refs}


def _close(got, want, key, qk_norm=True):
    """Within ``SCALE`` of the leaf's largest element; a config without
    qk-norm at rtol 1e-4 and ``NO_QK_NORM_ATOL`` of it; integer leaves
    exactly."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, key
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=key)
        return
    rtol, scale = (0.0, SCALE) if qk_norm else (1e-4, NO_QK_NORM_ATOL)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=scale * float(np.abs(want).max()),
                               err_msg=key)


def _check_decoder(got, want, where, qk_norm):
    assert len(got["logits"]) == len(want["logits"]) == STEPS + 1
    for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        _close(g, w, f"{where} logits of step {i}", qk_norm)
    for which in ("prefill_cache", "cache"):
        assert set(got[which]) == set(want[which]), where
        for k, w in want[which].items():
            _close(got[which][k], w, f"{where} {which} {k}", qk_norm)


CASES = [(arch, topo) for topo in MESHES for arch in ARCHS]


@pytest.mark.parametrize("arch,topo", CASES,
                         ids=[f"{a}-{t[0]}x{t[1]}" for a, t in CASES])
def test_prefill_and_decode_match_reference(runs, arch, topo):
    got = runs["got"][topo][arch]
    _check_decoder(got, runs["want"][arch], f"{arch} {topo}",
                   _cfgs(arch)[1].qk_norm)
    assert got["batch_axes"] == (("data",) if topo[0] > 1 else ())
    assert got["kv_axes"] == (("model",) if topo[1] > 1 else ())


def test_long_context_layout_matches_reference(runs):
    """Batch 1: the rows are whole on every rank, the decode cache's slots
    cut over (data, model), the softmax merged over all four ranks."""
    got = runs["got"][(2, 2)]["long"]
    _check_decoder(got, runs["want"]["long"], "long context", True)
    assert got["batch_axes"] == () and got["kv_axes"] == ("data", "model")


@pytest.mark.parametrize("topo", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
def test_encoder_under_the_prefill_rules(runs, topo):
    got = runs["got"][topo][ENCODER]["hidden"]
    want = runs["want"][ENCODER]["hidden"]
    _close(got, want, f"encode {topo}", _cfgs(ENCODER)[1].qk_norm)


@pytest.mark.parametrize("arch", ARCHS + (ENCODER,))
def test_counting_comms_count_the_gloo_ranks_bytes(runs, arch):
    """The dry run's count on ``meta`` (rank coordinates 0) against rank
    0's counter of the gloo run, by kind: the prefill (the encode) and the
    first decode step."""
    got = runs["got"][(2, 2)][arch]["counts"]
    cfg = _cfgs(arch)[1]
    if cfg.is_encoder:
        assert dryrun.collective_bytes(cfg, B, S, (2, 2), "prefill") == got
        return
    assert dryrun.collective_bytes(cfg, B, S, (2, 2), "prefill") == \
        got["prefill"]
    want = dryrun.collective_bytes(cfg, B, W, (2, 2), "decode")
    assert want == got["decode"]
    assert want["all-reduce"] > 0 and want["reduce-scatter"] == 0


def test_a_cut_model_needs_its_mesh():
    """A cut model refuses to run without the mesh it is cut onto."""
    from repro_torch.distributed import collectives
    from repro_torch.training import sharded
    import torch
    cfg = _cfgs(LONG)[1]
    model = sharded.cut_model(TransformerModel(cfg, device="cpu"),
                              collectives.counting_mesh({"data": 1,
                                                         "model": 2}))
    with pytest.raises(RuntimeError, match="cut onto"):
        model.decode_step(torch.zeros((1,), dtype=torch.int32),
                          model.init_cache(1, 4))
