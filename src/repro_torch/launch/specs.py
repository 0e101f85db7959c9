"""Bundles for the dry run, after the reference's ``launch/specs.py``: per
(arch x input shape) the step function, its inputs as ``meta`` tensors
(shapes and dtypes, no storage) and the specs (``distributed/sharding.py``)
of its inputs and outputs on a mesh.

Shape -> step, as the reference's:
  train_4k     train step (loss, gradients, clipping, optimizer update)
  prefill_32k  prefill (decoders) / encode (the audio encoder)
  decode_32k   decode step: one new token against a seq_len cache
  long_500k    decode step; sub-quadratic only (the SWA window for the
               dense / MoE / VLM families, the native state for SSM and
               hybrid)

The step runs the port's own eager code on the ``meta`` device, the
whole global batch at once (``launch/dryrun.py`` runs it; that is the
counterpart of the reference's compile).  The specs say how a mesh would
cut each input and output; ``shard_bytes`` sums the local shards.  The
parameters, the optimizer state and the cache are the port's own trees:
the reference's parameter tree (``training.loop.param_tree``), the
optimizers' states, and the cache of ``TransformerModel.cache_defs``.  Two
state numbers live on the host in the port, the optimizer's step count and
the learning rate; ``shard_bytes`` counts each host number as the 4-byte
scalar (int32 step, f32 rate) that the reference keeps on the device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree as tree_mod
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.configs.shapes import SHAPES
from repro_torch.device import dtype_of
from repro_torch.distributed.sharding import (ShardingCtx, Spec, _as_tuple,
                                              make_rules, param_specs,
                                              spec_for)
from repro_torch.models.dit import DiTModel
from repro_torch.models.params import ParamDef, count_params, map_defs
from repro_torch.models.transformer import TransformerModel
from repro_torch.training.loop import make_train_step, param_tree
from repro_torch.training.optimizer import (AdafactorState, Adafactor,
                                            AdamW, AdamWState,
                                            cosine_schedule, make_optimizer)

SWA_WINDOW = 8192  # sliding window substituting full attention at 500k
HOST_SCALAR_BYTES = 4   # a host step count or rate, as a device scalar


class Bundle(NamedTuple):
    step_fn: Callable
    args: Tuple                     # trees of meta tensors (host numbers)
    in_specs: Tuple
    out_specs: Any                  # a spec may stand for a whole subtree
    meta: Dict


def skip_reason(arch: str, shape_name: str) -> Optional[str]:
    cfg = get_config(arch)
    if cfg.is_encoder and shape_name in ("decode_32k", "long_500k"):
        return "encoder-only architecture: no decode step (DESIGN.md §6)"
    return None


def resolve_config(arch: str, shape: InputShape) -> ModelConfig:
    cfg = get_config(arch)
    if shape.name == "long_500k" and not cfg.is_encoder:
        if set(cfg.layer_kinds) == {"attn"}:
            # dense/moe/vlm: sub-quadratic via sliding-window attention
            cfg = cfg.replace(sliding_window=SWA_WINDOW)
    return cfg


# --------------------------------------------------------------------------
# Abstract batches
# --------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, batch: int, seq: int, *, train: bool
                ) -> Tuple[Dict, Dict]:
    """(meta-tensor dict, logical-axes dict) for a full-sequence batch."""
    i32 = torch.int32
    if cfg.family == "audio":
        out = {"features": _meta((batch, seq, cfg.frontend_dim),
                                 torch.float32)}
        axes = {"features": ("act_batch", "act_seq", None)}
        if train:
            out["targets"] = _meta((batch, seq), i32)
            out["mask_indices"] = _meta((batch, seq), torch.bool)
            axes["targets"] = ("act_batch", "act_seq")
            axes["mask_indices"] = ("act_batch", "act_seq")
        return out, axes
    out = {"tokens": _meta((batch, seq), i32)}
    axes = {"tokens": ("act_batch", "act_seq")}
    if cfg.family == "vlm":
        out["vision_embeds"] = _meta((batch, cfg.vision_tokens,
                                      cfg.d_model), dtype_of(cfg.dtype))
        out["vision_mask"] = _meta((batch, seq), torch.bool)
        out["positions"] = _meta((batch, seq, 3), i32)
        axes["vision_embeds"] = ("act_batch", None, "act_embed")
        axes["vision_mask"] = ("act_batch", "act_seq")
        axes["positions"] = ("act_batch", "act_seq", None)
    return out, axes


def _specs_of(tensors: Dict, axes: Dict, ctx: ShardingCtx) -> Dict:
    return {k: spec_for(tuple(t.shape), axes[k], ctx)
            for k, t in tensors.items()}


# --------------------------------------------------------------------------
# Optimizer specs
# --------------------------------------------------------------------------

def optimizer_specs(opt, defs, ctx: ShardingCtx):
    """Specs of ``opt``'s state over a model's ``param_defs`` (the
    reference's ``optimizer_shardings``): AdamW's moments as the
    parameters; Adafactor's row statistics over all dims but the last,
    column statistics over all but the second to last (replicated below
    two dims); the step replicated."""
    if isinstance(opt, AdamW):
        ps = param_specs(defs, ctx)
        return AdamWState(step=(), mu=ps, nu=ps)
    if not isinstance(opt, Adafactor):
        raise TypeError(f"optimizer_specs supports AdamW and Adafactor; "
                        f"got {type(opt).__name__}")

    def axes(d: ParamDef):
        return d.axes if d.axes is not None else (None,) * len(d.shape)

    def vr(d: ParamDef) -> Spec:
        if len(d.shape) >= 2:
            return spec_for(d.shape[:-1], axes(d)[:-1], ctx)
        return spec_for(d.shape, axes(d), ctx)

    def vc(d: ParamDef) -> Spec:
        if len(d.shape) >= 2:
            return spec_for(d.shape[:-2] + d.shape[-1:],
                            axes(d)[:-2] + axes(d)[-1:], ctx)
        return ()

    return AdafactorState(step=(), vr=map_defs(vr, defs),
                          vc=map_defs(vc, defs))


# --------------------------------------------------------------------------
# Per-device bytes
# --------------------------------------------------------------------------

def is_spec(x) -> bool:
    """A spec: a plain tuple of None, mesh-axis names or tuples of them
    (``()`` replicates whatever it stands for)."""
    return (type(x) is tuple
            and all(a is None or isinstance(a, str)
                    or (type(a) is tuple
                        and all(isinstance(n, str) for n in a))
                    for a in x))


def local_bytes(leaf, spec: Spec, extents: Dict[str, int]) -> int:
    """Bytes of one device's shard of ``leaf`` under ``spec`` (each
    sharded dim split evenly over its mesh axes); a host number counts
    ``HOST_SCALAR_BYTES``."""
    if leaf is None:
        return 0
    if not isinstance(leaf, torch.Tensor):
        return HOST_SCALAR_BYTES
    split = math.prod(extents[a] for entry in spec for a in _as_tuple(entry))
    return leaf.numel() // split * leaf.element_size()


def shard_bytes(tree, specs, extents: Dict[str, int]) -> int:
    """Per-device bytes of ``tree`` under ``specs``, a tree of specs of
    the same structure or a prefix of it: a spec at a node applies to
    every leaf below it."""
    if is_spec(specs):
        return sum(local_bytes(leaf, specs, extents)
                   for leaf in tree_mod.leaves(tree))
    if isinstance(specs, dict):
        return sum(shard_bytes(tree[k], s, extents)
                   for k, s in specs.items())
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return sum(shard_bytes(getattr(tree, f), getattr(specs, f), extents)
                   for f in specs._fields)
    return sum(shard_bytes(t, s, extents) for t, s in zip(tree, specs))


# --------------------------------------------------------------------------
# Bundle builder
# --------------------------------------------------------------------------

def _meta_model(cfg: ModelConfig, prefix_groups: int):
    if cfg.family == "dit":
        return DiTModel(cfg, device="meta")
    return TransformerModel(cfg, device="meta", prefix_groups=prefix_groups)


def build_bundle(arch: str, shape_name: str, mesh, *,
                 prefix_groups: int = 1,
                 num_layers: Optional[int] = None,
                 seq_override: Optional[int] = None,
                 attn_seq_shard: bool = False,
                 batch_override: Optional[int] = None) -> Bundle:
    """The step of ``arch`` at ``shape_name`` on a fresh model on the
    ``meta`` device, its inputs and the specs of its inputs and outputs
    on ``mesh``.  ``num_layers`` / ``seq_override`` cut the depth / the
    sequence (the dry run's cost probes); ``batch_override`` sets the
    global batch (the port's addition, for a step the card can hold)."""
    shape = SHAPES[shape_name]
    cfg = resolve_config(arch, shape)
    if num_layers is not None:
        cfg = cfg.replace(num_layers=num_layers)
    if seq_override is not None:
        shape = dataclasses.replace(shape, seq_len=seq_override)
    if batch_override is not None:
        shape = dataclasses.replace(shape, global_batch=batch_override)
    long_ctx = shape.name == "long_500k"
    rules = make_rules(shape.kind, long_context=long_ctx,
                       attn_seq_shard=attn_seq_shard)
    ctx = ShardingCtx(mesh, rules)

    model = _meta_model(cfg, prefix_groups)
    defs = model.param_defs()
    params = param_tree(model)      # the model's own (meta) parameters
    params_sp = param_specs(defs, ctx)
    b = shape.global_batch
    meta = {"arch": arch, "shape": shape_name, "config": cfg.name,
            "params": count_params(defs), "family": cfg.family,
            "n_super": getattr(model, "n_super", cfg.num_layers),
            "seq_len": shape.seq_len, "global_batch": b,
            "kind": shape.kind, "sliding_window": cfg.sliding_window}

    if shape.kind == "train":
        batch, baxes = batch_specs(cfg, b, shape.seq_len, train=True)
        opt = make_optimizer(cfg.optimizer)
        opt_state = opt.init(params)
        opt_sp = optimizer_specs(opt, defs, ctx)
        train_step = make_train_step(model, opt,
                                     cosine_schedule(3e-4, 100, 10_000))
        return Bundle(train_step, (params, opt_state, batch),
                      (params_sp, opt_sp, _specs_of(batch, baxes, ctx)),
                      (params_sp, opt_sp, ()), meta)   # metrics: scalars

    if shape.kind == "prefill":
        batch, baxes = batch_specs(cfg, b, shape.seq_len, train=False)
        in_sp = (params_sp, _specs_of(batch, baxes, ctx))
        if cfg.is_encoder:
            out_sp = spec_for((b, shape.seq_len, cfg.d_model),
                              ("act_batch", "act_seq", "act_embed"), ctx)
            return Bundle(lambda p, batch: model.apply(batch),
                          (params, batch), in_sp, out_sp, meta)
        window = shape.seq_len
        out_sp = (spec_for((b, cfg.vocab_size), ("act_batch", "act_vocab"),
                           ctx),
                  param_specs(model.cache_defs(b, window), ctx))
        return Bundle(lambda p, batch: model.prefill(batch, window),
                      (params, batch), in_sp, out_sp, meta)

    # ---- decode
    window = min(shape.seq_len,
                 cfg.sliding_window if cfg.sliding_window else shape.seq_len)
    meta["cache_window"] = window
    cache_sp = param_specs(model.cache_defs(b, window), ctx)
    tokens = _meta((b,), torch.int32)
    tokens_sp = spec_for((b,), ("act_batch",), ctx)
    logits_sp = spec_for((b, cfg.vocab_size), ("act_batch", "act_vocab"),
                         ctx)
    return Bundle(lambda p, tokens, cache: model.decode_step(tokens, cache),
                  (params, tokens, model.abstract_cache(b, window)),
                  (params_sp, tokens_sp, cache_sp), (logits_sp, cache_sp),
                  meta)


# --------------------------------------------------------------------------
# Model FLOPs (the roofline's "useful compute")
# --------------------------------------------------------------------------

def active_params(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: routed fraction only)."""
    total = count_params(_meta_model(cfg, 1).param_defs())
    if cfg.moe is None:
        return total
    m = cfg.moe
    expert_block = 3 * cfg.d_model * m.d_ff_expert
    n_moe_layers = sum(1 for i in range(len(cfg.layer_kinds))
                       if cfg.family == "moe"
                       or (cfg.moe and i % m.moe_layer_period == 1))
    if cfg.family == "moe":
        n_moe_layers = cfg.num_layers
    all_expert = n_moe_layers * m.num_experts * expert_block
    active_expert = n_moe_layers * m.top_k * expert_block
    return total - all_expert + active_expert


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """6*N*D for training, 2*N_active*D for inference (D = tokens)."""
    n_act = active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n_act * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_act * shape.global_batch * shape.seq_len
    return 2.0 * n_act * shape.global_batch  # one token per sequence
