"""Rank processes for ``tests/test_torch_sharded_inference.py``: the
port's prefill and decode steps on a mesh (``distributed/inference.py``).

The ranks are ``tests/torch_sharded_train_ranks.py``'s ``MeshJobs``, each
running ``run`` below.  This module imports only the port, never
``tests/conftest.py`` (which imports JAX).

A job is a dict: ``name``, ``cfg`` (a port config), ``params`` (the
reference's global parameter tree as numpy arrays) and either
``features`` (B, S, F) (an encoder: ``apply`` under the prefill rules),
or ``tokens`` (B, S) (the prompt), ``steps`` (n, B) (the teacher-forced
decode tokens), ``window`` and optionally ``long_context``.  Rank 0
answers with the gathered logits of the prefill and of every decode step,
the gathered caches after the prefill (prefill layout) and after the last
step (decode layout), and this rank's collective bytes by kind of the
prefill and of the first decode step.
"""
from typing import Dict

import numpy as np
import torch


def _np(t):
    from repro_torch import tree
    return None if t is None else tree.map(
        lambda x: x.detach().float().numpy().copy()
        if isinstance(x, torch.Tensor) else x, t)


def run(job: Dict, device_mesh) -> Dict:
    from repro_torch import bridge
    from repro_torch.distributed import collectives, inference
    from repro_torch.distributed.sharding import ShardingCtx, spec_for
    from repro_torch.models.transformer import TransformerModel
    from repro_torch.training import sharded
    from repro_torch.training.sharded import gather_tree, shard_tree

    cfg = job["cfg"]
    base = collectives.device_mesh_comms(device_mesh, "staged")
    model = TransformerModel(cfg, device="cpu")
    bridge.transformer_params_from_jax(job["params"], model)
    sharded.cut_model(model, base)
    if "features" in job:
        feats = job["features"]
        mesh = inference.infer_mesh(base, "prefill", feats.shape[0])
        ctx = ShardingCtx(mesh, inference.rules_of("prefill"))
        spec = spec_for(feats.shape, ("act_batch", "act_seq", None), ctx)
        local = shard_tree(torch.from_numpy(feats), spec, mesh)
        mesh.counter.reset()
        with collectives.active(mesh):
            hidden = model.apply({"features": local})
        counts = mesh.counter.read()
        hspec = spec_for(tuple(feats.shape[:2]) + (cfg.d_model,),
                         ("act_batch", "act_seq", "act_embed"), ctx)
        return {"hidden": _np(gather_tree(hidden, hspec, mesh)),
                "counts": counts}

    tokens, steps = job["tokens"], job["steps"]
    b, window = tokens.shape[0], job["window"]
    long_ctx = job.get("long_context", False)
    pre = inference.infer_mesh(base, "prefill", b)
    dec = inference.infer_mesh(base, "decode", b, window, long_ctx)
    row_spec = (inference.logits_spec(model, b, pre, "prefill")[0], None)
    local = shard_tree(torch.from_numpy(tokens), row_spec, pre)
    pre.counter.reset()
    with collectives.active(pre):
        logits, cache = model.prefill({"tokens": local}, window)
    out = {"counts": {"prefill": pre.counter.read()}}
    out["logits"] = [_np(gather_tree(
        logits, inference.logits_spec(model, b, pre, "prefill"), pre))]
    out["prefill_cache"] = _np(gather_tree(
        cache, inference.cache_specs(model, b, window, pre, "prefill"),
        pre))
    cache = inference.decode_layout(cache, model, b, window, dec, long_ctx)
    dspec = inference.logits_spec(model, b, dec, "decode", long_ctx)
    for i, tok in enumerate(steps):
        t = shard_tree(torch.from_numpy(np.ascontiguousarray(tok)),
                       dspec[:1], dec)
        dec.counter.reset()
        with collectives.active(dec):
            logits, cache = model.decode_step(t, cache)
        if i == 0:
            out["counts"]["decode"] = dec.counter.read()
        out["logits"].append(_np(gather_tree(logits, dspec, dec)))
    out["cache"] = _np(gather_tree(
        cache, inference.cache_specs(model, b, window, dec, "decode",
                                     long_ctx), dec))
    out["kv_axes"], out["batch_axes"] = dec.kv_axes, dec.batch_axes
    return out
