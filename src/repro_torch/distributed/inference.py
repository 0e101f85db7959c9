"""Prefill and decode of the LLMs on a ``(data, model)`` mesh, after the
reference's dry run, which lowers ``model.prefill`` under
``make_rules("prefill")`` and ``model.decode_step`` under
``make_rules("decode")`` (``long_context`` for ``long_500k``).

A model cut onto a mesh (``training.sharded.cut_model``: the weights'
specs are the same under the train, prefill and decode rules) runs
``prefill``, ``decode_step`` and the encoder's ``apply`` under
``collectives.active(infer_mesh(...))``:

* ``infer_mesh`` gives a mesh its ``batch_axes`` (the axes that cut the
  rows under the rules' ``act_batch``) and ``kv_axes`` (those that cut a
  decode cache's slots, ``act_kv_seq``: none under the prefill rules,
  ``model`` under the decode rules, ``(data, model)`` for long context);
* ``cache_specs`` is the specs of the whole cache under the rules: a
  prefill returns this rank's blocks under the prefill rules (every slot
  and kv head of its rows), a decode step takes them under the decode
  rules; ``decode_layout`` cuts the one into the other (a rank keeps its
  block of the slots, nothing moves);
* ``logits_spec`` is the logits' spec (``act_batch``, ``act_vocab``):
  ``training.sharded.gather_tree`` gathers them, and the caches, to rank
  0.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.distributed.collectives import MeshComms
from repro_torch.distributed.sharding import (ShardingCtx, Spec, _as_tuple,
                                              make_rules, param_specs,
                                              spec_for)

KINDS = ("prefill", "decode")


def rules_of(kind: str, long_context: bool = False) -> Dict:
    """The reference's rule table of a prefill or a decode step."""
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r} is not one of {KINDS}")
    return make_rules(kind, long_context=long_context)


def _cut_axes(mesh: MeshComms, entry) -> Tuple[str, ...]:
    return tuple(a for a in _as_tuple(entry) if mesh.extents[a] > 1)


def infer_mesh(mesh: MeshComms, kind: str, global_batch: int,
               window: int = 0, long_context: bool = False) -> MeshComms:
    """``mesh`` (its comms and counter) with the batch axes of a global
    batch of ``global_batch`` rows and the kv axes of a cache of
    ``window`` slots under the ``kind`` rules."""
    ctx = ShardingCtx(mesh, rules_of(kind, long_context))
    rows = spec_for((global_batch,), ("act_batch",), ctx)[0]
    slots = (spec_for((window,), ("act_kv_seq",), ctx)[0] if window
             else None)
    return mesh.with_batch_axes(_cut_axes(mesh, rows),
                                _cut_axes(mesh, slots))


def cache_specs(model, global_batch: int, window: int, mesh: MeshComms,
                kind: str, long_context: bool = False) -> Dict[str, Spec]:
    """The specs of ``model``'s whole cache (``cache_defs``) under the
    ``kind`` rules on ``mesh``."""
    return param_specs(model.cache_defs(global_batch, window),
                       ShardingCtx(mesh, rules_of(kind, long_context)))


def logits_spec(model, global_batch: int, mesh: MeshComms, kind: str,
                long_context: bool = False) -> Spec:
    """The spec of a step's (B, V) logits: rows on ``act_batch``, the
    vocab on ``act_vocab``."""
    return spec_for((global_batch, model.cfg.vocab_size),
                    ("act_batch", "act_vocab"),
                    ShardingCtx(mesh, rules_of(kind, long_context)))


def decode_layout(cache: Dict[str, torch.Tensor], model, global_batch: int,
                  window: int, mesh: MeshComms,
                  long_context: bool = False) -> Dict[str, torch.Tensor]:
    """This rank's blocks of a cache under the decode rules, from its
    blocks under the prefill rules (what ``prefill`` returns): each dim
    the decode rules cut and the prefill rules leave whole is narrowed to
    this rank's block (the slots over the kv axes); nothing moves."""
    before = cache_specs(model, global_batch, window, mesh, "prefill")
    after = cache_specs(model, global_batch, window, mesh, "decode",
                        long_context)
    out = {}
    for name, t in cache.items():
        for dim, (a, b) in enumerate(zip(before[name], after[name])):
            if a == b:
                continue
            if _cut_axes(mesh, a):
                raise ValueError(f"cache leaf {name}: dim {dim} is cut as "
                                 f"{a} by the prefill and {b} by the decode "
                                 "rules")
            n, idx = 1, 0
            for ax in _as_tuple(b):
                idx = idx * mesh.extents[ax] + mesh.coords[ax]
                n *= mesh.extents[ax]
            size = t.shape[dim] // n
            t = t.narrow(dim, idx * size, size)
        out[name] = t.contiguous()
    return out
