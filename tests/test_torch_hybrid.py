"""The hybrid (jamba-v0.1-52b) and SSM (xlstm-1.3b) families end to end in
the port: the model's own consistency (decode against the full forward,
causality), the decode gate's refusal, the engine's splice of every cache
leaf, the launchers, and checkpoints crossing to and from the reference.

The reduced configs run in f32; where a check mirrors a reference test
(``tests/test_models.py``, ``tests/test_system.py``), it keeps that test's
tolerance (2e-3 on logits, 1e-4 on hidden states).  Parity of the models
against the reference is in ``tests/test_torch_transformer.py`` (the
``pair`` fixture) and of the engine's token streams in
``tests/test_torch_llm_serving.py``.
"""
import tests.torch_threads  # noqa: F401  (first: one thread)
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load as jload
from repro.checkpoint import save as jsave
from repro.configs.base import FastCacheConfig as JFastCacheConfig
from repro.core.decode_runner import CachedDecoder as JCachedDecoder
from repro_torch import bridge, tree
from repro_torch.checkpoint import load, save
from repro_torch.configs import get_reduced
from repro_torch.configs.base import FastCacheConfig
from repro_torch.core.decode_runner import CachedDecoder
from repro_torch.launch import profile_llm, serve
from repro_torch.launch import train as train_launcher
from repro_torch.launch.serve import (GATE_NEEDS_ATTENTION, LLMWorkload,
                                      exact_fallback)
from repro_torch.models.transformer import TransformerModel
from repro_torch.serving.engine import ServingEngine
from repro_torch.training import loop
from tests.test_torch_transformer import jax_llm, port_llm, tokens, tt

ARCHS = ("jamba-v0.1-52b", "xlstm-1.3b")


def f32_model(arch: str, seed: int = 0, **replace) -> TransformerModel:
    """The reduced config in f32 with ample MoE capacity (drop-free, as the
    reference's ``f32_cfg``), random weights from ``seed``."""
    cfg = get_reduced(arch).replace(dtype="float32", **replace)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=8.0))
    return TransformerModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """The port's counterpart of the reference's
    ``test_decode_matches_full_forward``: a 24-token prefill then 4 decode
    steps give the full forward's logits at those positions."""
    model = f32_model(arch)
    toks = tt(tokens((2, 28), 70))
    ref = model.unembed(model.apply({"tokens": toks}))
    logits, cache = model.prefill({"tokens": toks[:, :24]}, 48)
    np.testing.assert_allclose(logits.numpy(), ref[:, 23].numpy(),
                               atol=2e-3)
    for t in range(4):
        logits, cache = model.decode_step(toks[:, 24 + t], cache)
        np.testing.assert_allclose(logits.numpy(), ref[:, 24 + t].numpy(),
                                   atol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_causality(arch):
    """Future tokens do not move earlier hidden states (the reference's
    ``test_causality``)."""
    model = f32_model(arch)
    toks = tt(tokens((1, 16), 71))
    h1 = model.apply({"tokens": toks})
    toks2 = toks.clone()
    toks2[:, 12:] = (toks2[:, 12:] + 7) % model.cfg.vocab_size
    h2 = model.apply({"tokens": toks2})
    np.testing.assert_allclose(h1[:, :12].numpy(), h2[:, :12].numpy(),
                               atol=1e-4)
    assert not torch.allclose(h1[:, 12:], h2[:, 12:], atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_layout_and_cache_leaves(arch):
    """Blocks follow the pattern (mixer, then FFN / MoE where the reference
    puts them); the cache stacks each kind's leaves over its layers, batch
    on axis 1; ``layer_cache`` returns views."""
    model = f32_model(arch)
    _, jm, _ = jax_llm("float32", arch=arch)
    for l, blk in enumerate(model.blocks):
        assert blk.kind == model.cfg.layer_kinds[l]
        assert sorted(blk.subs) == sorted(
            jm._block_defs(l % model.period)), l
    cache = model.init_cache(3, 16)
    jcache = jm.abstract_cache(3, 16)
    for l, kind in enumerate(model.layer_kinds):
        lc = model.layer_cache(cache, l)
        want = jcache["blocks"][f"pos{l % model.period}"]
        assert set(lc) == set(want)
        for key, t in lc.items():
            assert tuple(t.shape) == tuple(want[key].shape[1:]), (l, key)
            t.fill_(l + 1)                     # lands in the stacked leaf
    for key, t in cache.items():
        if key != "step":
            assert t.shape[1] == 3 and bool((t != 0).all()), key


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_splices_every_leaf(arch):
    """An admission writes the prefill's state into its slot of every cache
    leaf (bitwise the standalone prefill's) and leaves the other slots'
    rows as they were."""
    model = f32_model(arch)
    eng = ServingEngine(model, max_batch=3, window=16)
    before = {k: v.clone() for k, v in eng.cache.items()}
    prompt = tokens((12,), 72)
    eng._prefill(prompt, 1)
    _, one = model.prefill({"tokens": tt(prompt[None])}, 16)
    for key, leaf in eng.cache.items():
        if key == "step":
            assert leaf.tolist() == [0, 12, 0]
            continue
        assert torch.equal(leaf[:, 1], one[key][:, 0]), key
        assert torch.equal(leaf[:, 0], before[key][:, 0]), key
        assert torch.equal(leaf[:, 2], before[key][:, 2]), key


@pytest.mark.parametrize("arch", ARCHS)
def test_cached_decoder_refuses(arch):
    """The decode gate takes only a period-1 attention stack, with the
    reference's message, on both sides."""
    _, jm, _ = jax_llm("float32", arch=arch)
    with pytest.raises(ValueError) as jerr:
        JCachedDecoder(jm, JFastCacheConfig())
    with pytest.raises(ValueError) as terr:
        CachedDecoder(f32_model(arch), FastCacheConfig())
    assert str(terr.value) == str(jerr.value)
    assert "period-1 attention stacks" in str(terr.value)


@pytest.mark.parametrize("arch", ARCHS)
def test_exact_fallback(arch):
    """A fastcache workload on these stacks comes back exact with the
    reference launcher's line; on qwen3-0.6b it stays gated."""
    wl = LLMWorkload(arch=arch, reduced=True, fastcache=True)
    got, line = exact_fallback(wl, f32_model(arch))
    assert not got.fastcache and line == GATE_NEEDS_ATTENTION
    assert dataclasses.replace(got, fastcache=True) == wl
    wl = LLMWorkload(reduced=True, fastcache=True)
    assert exact_fallback(wl, f32_model("qwen3-0.6b")) == (wl, None)


def test_workload_depth_is_a_multiple_of_the_period():
    with pytest.raises(ValueError, match="not divisible by pattern period"):
        LLMWorkload(arch="jamba-v0.1-52b", reduced=True,
                    num_layers=6).build_model("cpu")
    model = LLMWorkload(arch="jamba-v0.1-52b", reduced=True,
                        num_layers=8).build_model("cpu")
    assert model.cfg.num_layers // model.period == 2
    assert model.kind_counts == {"mamba": 6, "attn": 2}


def test_launcher_serves_xlstm_exact_under_fastcache(capsys):
    """``--fastcache --arch xlstm-1.3b`` prints the reference's line and
    serves exact: 1 sync per decode step, no cache ratio."""
    serve.main(["--arch", "xlstm-1.3b", "--reduced", "--device", "cpu",
                "--json", "--fastcache", "--requests", "3", "--new-tokens",
                "6"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert GATE_NEEDS_ATTENTION in lines
    out = json.loads(lines[-1])
    assert out["fastcache"] is False and "block_cache_ratio" not in out
    assert out["arch"] == "xlstm-1.3b-smoke" and out["tokens"] == 3 * 6
    assert out["host_syncs_per_decode_step"] == 1.0


def test_profile_llm_runs_jamba_on_the_cpu(tmp_path, capsys):
    """``profile_llm --arch jamba-v0.1-52b`` (reduced, its 4 layers)
    profiles the exact prefill and decode steps."""
    out = tmp_path / "p.json"
    profile_llm.main(["--arch", "jamba-v0.1-52b", "--num-layers", "4",
                      "--reduced", "--device", "cpu", "--fastcache",
                      "--warmup", "2", "--window", "2", "--out", str(out)])
    assert GATE_NEEDS_ATTENTION in capsys.readouterr().out
    report = json.loads(out.read_text())
    assert report["fastcache"] is False and report["num_layers"] == 4
    assert report["decode"]["host_syncs_per_step"] == 1.0


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_trains(arch, tmp_path, capsys):
    """Both families train: ``launch/train.py`` runs 3 steps of the reduced
    config on the CPU with the config's optimizer (xLSTM AdamW, Jamba
    Adafactor), every logged loss finite, and saves a tree the reference's
    ``load`` reads; the model's loss backpropagates into every parameter.
    Its losses against the reference's train loop:
    ``tests/test_torch_ssm_training.py``."""
    ckpt = str(tmp_path / "model.npz")
    train_launcher.main(["--arch", arch, "--reduced", "--device", "cpu",
                         "--steps", "3", "--batch", "2", "--seq", "16",
                         "--save", ckpt])
    lines = capsys.readouterr().out.splitlines()
    opt = get_reduced(arch).optimizer
    assert lines[0].endswith(f"opt={opt}") and lines[-1].endswith(ckpt)
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in lines[1:-1]]
    assert len(losses) == 2 and np.isfinite(losses).all()
    _, _, jp = jax_llm("float32", arch=arch)
    got = jload(ckpt, jp)
    assert jax.tree.structure(got) == jax.tree.structure(jp)
    model = f32_model(arch)
    loop.param_tree(model)
    grads = loop.grad_tree(model)
    loss, _ = model.loss({"tokens": tt(tokens((1, 8), 73))})
    loss.backward()
    assert torch.isfinite(loss)
    assert all(float(g.abs().max()) > 0 for g in tree.leaves(grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_crosses_both_ways(tmp_path, arch):
    """The port's counterpart of the reference's checkpoint round trip: a
    reduced f32 tree saved by the reference loads through the port's
    ``checkpoint/io.py`` into a fresh model, and the port's save of
    ``params_to_jax`` loads in the reference, bitwise, every
    ``blocks/pos{i}`` leaf (n_super, ...)."""
    _, _, jp = jax_llm("float32", arch=arch)
    ref_path = str(tmp_path / "ref.npz")
    jsave(ref_path, jp, {"arch": arch})
    model = port_llm("float32", jax.tree.map(jnp.zeros_like, jp), arch)
    got = load(ref_path, loop.param_tree(model))
    bridge.transformer_params_from_jax(tree.map(bridge.to_numpy, got), model)
    port_path = str(tmp_path / "port.npz")
    save(port_path, bridge.params_to_jax(model), {"arch": arch})
    back = jload(port_path, jp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert len(jp["blocks"]) == model.period
