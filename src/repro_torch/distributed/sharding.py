"""Logical-axis sharding rules with divisibility fallback, after the
reference's ``distributed/sharding.py``.

Models name every parameter dim and key activations with *logical* axes.  A
rule table (``make_rules``) maps logical names to mesh axes; ``spec_for``
drops a mesh axis when it is missing from the mesh, does not divide the dim,
or was already used by an earlier dim of the same array.

A spec is the port's counterpart of ``PartitionSpec``: a tuple with one
entry per dim, each ``None``, a mesh-axis name, or a tuple of names.  The
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names=("data", "model")``; the rule functions read only its axis
names and extents (``mesh_extents``), so any object with ``axis_names`` and
a ``devices`` array of the mesh's shape serves them too.

The port runs eagerly on local shards with explicit collectives, so there
is no compiler to apply a spec: the serving engine
(``serving/sharded_engine.py``) cuts each weight by its spec
(``local_slice``) and lays out the slot rows it owns, ``constrain`` is the
identity on a local shard (it checks the rank of the logical axes), and
``agree_all`` makes the host branches that guard a collective the same on
every rank of the model group.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

Axes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axes, ...]


# --------------------------------------------------------------------------
# Rule tables
# --------------------------------------------------------------------------

def make_rules(kind: str = "train", *, long_context: bool = False,
               seq_shard: bool = False,
               attn_seq_shard: bool = False) -> Dict[str, Axes]:
    """Logical-axis -> mesh-axes mapping (the reference's table, as is).

    Weight dims:  embed / ffn / heads / vocab / expert / expert_embed ...
    Activations:  act_batch / act_seq / act_kv_seq / act_embed / act_vocab ...
    """
    rules: Dict[str, Axes] = {
        # ---- weights: FSDP over `data`, tensor/expert-parallel over `model`
        "embed": ("data",),
        "ffn": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "head_dim": None,
        "vocab": ("model",),
        "expert": ("model",),
        "expert_embed": ("data",),
        "inner": ("model",),        # SSM inner/channel dims
        "state": None,
        "layers": None,
        "null": None,
        # serving-slot batch rows (engine state); mapped under kind="serve"
        "slot": None,
        # ---- activations
        "act_batch": ("pod", "data"),
        "act_seq": None,
        "act_kv_seq": None,
        "act_embed": None,
        "act_heads": ("model",),
        "act_ffn": ("model",),
        "act_inner": ("model",),
        "act_vocab": ("model",),
        "act_expert": ("model",),
        # shard attention internals over `model` on the query-seq dim
        "act_attn_seq": ("model",) if attn_seq_shard else None,
    }
    if seq_shard:
        # sequence parallelism on the residual stream
        rules["act_seq"] = ("model",)
        rules["act_ffn"] = None
    if kind == "serve":
        # diffusion serving: the slot batch (latents and every per-slot row
        # of the cache-policy state) over `data`; weights tensor-parallel
        # over `model` and replicated over `data` (no optimizer state, so
        # FSDP buys nothing)
        rules["slot"] = ("data",)
        rules["act_batch"] = ("data",)
        rules["embed"] = None
        rules["expert_embed"] = None
    if kind == "decode":
        # batch over data; the KV cache over `model`
        rules["act_kv_seq"] = ("model",)
    if long_context:
        # batch == 1: move `data` (and `model`) onto the KV/sequence dim
        rules["act_batch"] = ("pod",)
        rules["act_kv_seq"] = ("data", "model")
        if kind != "decode":
            rules["act_seq"] = ("data",)
    return rules


# --------------------------------------------------------------------------
# Context
# --------------------------------------------------------------------------

def mesh_extents(mesh) -> Dict[str, int]:
    """{axis name: extent} of a ``DeviceMesh`` (``mesh_dim_names``,
    ``mesh.shape``), of an abstract mesh (``axis_names``, ``axis_sizes``:
    ``launch.mesh.AbstractMesh``) or of any object with ``axis_names`` and
    a ``devices`` array, as the reference's rules read a JAX mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.mesh.shape)))
    sizes = getattr(mesh, "axis_sizes", None)
    if sizes is not None:
        return dict(zip(mesh.axis_names, tuple(sizes)))
    return dict(zip(mesh.axis_names, tuple(mesh.devices.shape)))


class ShardingCtx:
    def __init__(self, mesh, rules: Dict[str, Axes]):
        self.mesh = mesh
        self.rules = rules
        self.extents = mesh_extents(mesh)

    def group(self, axis: str):
        """The process group of this rank along mesh ``axis``, or None when
        the axis has extent 1 (no collective is needed along it)."""
        if self.extents.get(axis, 1) == 1:
            return None
        return self.mesh.get_group(axis)


_TLS = threading.local()


def current_ctx() -> Optional[ShardingCtx]:
    return getattr(_TLS, "ctx", None)


@contextlib.contextmanager
def use_sharding(mesh=None, rules: Optional[Dict[str, Axes]] = None, *,
                 ctx: Optional[ShardingCtx] = None):
    """Make ``ctx``, or a new context over ``mesh`` and ``rules``, current
    for a block."""
    prev = current_ctx()
    _TLS.ctx = ctx if ctx is not None else ShardingCtx(mesh, rules)
    try:
        yield _TLS.ctx
    finally:
        _TLS.ctx = prev


# --------------------------------------------------------------------------
# Spec construction
# --------------------------------------------------------------------------

def _as_tuple(a: Axes) -> Tuple[str, ...]:
    if a is None:
        return ()
    if isinstance(a, str):
        return (a,)
    return tuple(a)


def spec_for(shape: Sequence[int], logical_axes: Sequence[Optional[str]],
             ctx: Optional[ShardingCtx] = None) -> Spec:
    """The spec for ``shape`` given per-dim logical axis names.

    Drops mesh axes that (a) don't exist in the mesh, (b) don't divide the
    dim size, or (c) were already used by an earlier dim."""
    ctx = ctx or current_ctx()
    if ctx is None:
        return (None,) * len(shape)
    if len(shape) != len(logical_axes):
        raise ValueError(f"spec_for: shape {tuple(shape)} has {len(shape)} "
                         f"dims but logical_axes {tuple(logical_axes)} "
                         f"names {len(logical_axes)}")
    mesh_shape = ctx.extents
    used: set = set()
    out = []
    for size, name in zip(shape, logical_axes):
        mesh_axes = _as_tuple(ctx.rules.get(name)) if name else ()
        mesh_axes = tuple(a for a in mesh_axes
                          if a in mesh_shape and a not in used)
        # all-or-nothing per requested group, trimmed greedily
        picked: Tuple[str, ...] = ()
        extent = 1
        for a in mesh_axes:
            if size % (extent * mesh_shape[a]) == 0:
                picked += (a,)
                extent *= mesh_shape[a]
        used.update(picked)
        if not picked:
            out.append(None)
        elif len(picked) == 1:
            out.append(picked[0])
        else:
            out.append(picked)
    return tuple(out)


def constrain(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` by logical axes.  Eager
    code holds local shards already, so this is the identity; under a
    context it checks that the axes name every dim of ``x``."""
    if current_ctx() is not None and len(logical_axes) != x.dim():
        raise ValueError(f"constrain: {x.dim()}-dim tensor, logical axes "
                         f"{logical_axes}")
    return x


def agree_all(flag: torch.Tensor) -> torch.Tensor:
    """``flag`` (a bool tensor, e.g. ``do_cache.all()``) AND-reduced over
    this rank's model group under a context whose model axis is wider than
    one device, else ``flag`` itself.  A branch that skips a block holding
    a collective must be taken by every rank of the group or none, so the
    caller reads this once on the host in place of ``flag``."""
    ctx = current_ctx()
    group = ctx.group("model") if ctx is not None else None
    if group is None:
        return flag
    import torch.distributed as dist
    t = flag.to(torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return t.to(torch.bool)


def _require_ctx(ctx: Optional[ShardingCtx], who: str) -> ShardingCtx:
    if ctx is None:
        raise ValueError(f"{who} requires an active sharding ctx "
                         "(use_sharding(mesh, rules) or an explicit ctx=)")
    return ctx


def _slot_axis(shape: Tuple[int, ...], batch: int,
               layers: Optional[int]) -> Optional[int]:
    """Which dim of a state leaf is the sample/slot batch dim: the leading
    axis, except for layer-stacked trackers, whose leading extent
    ``layers`` or ``layers + 1`` followed by the batch extent puts the slot
    dim on axis 1.  Leaves without a batch-extent dim replicate.  The layer
    rule is checked first, so (L, B) trackers resolve to axis 1 even when
    ``L == batch``."""
    if (layers is not None and len(shape) >= 2
            and shape[0] in (layers, layers + 1) and shape[1] == batch):
        return 1
    if len(shape) >= 1 and shape[0] == batch:
        return 0
    return None


def _map(fn, tree: Any, is_leaf=None) -> Any:
    """``fn`` over the leaves of nested dicts, lists and named tuples."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v, is_leaf) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, is_leaf) for v in tree)
    return fn(tree)


def serve_state_specs(state, ctx: Optional[ShardingCtx] = None, *,
                      batch: int, layers: Optional[int] = None):
    """Specs matching any cache policy's serving-state tree
    (``CachedDiT.init_state(batch)``) under the ``kind="serve"`` rules: slot
    rows over ``data``, everything else replicated (with the usual
    divisibility fallback).  The walker names no state keys: each leaf's
    spec comes from its rank and extents alone (``_slot_axis``).  ``batch``
    is the state's sample-row count (CFG pairs included), ``layers`` the
    model's block count."""
    ctx = _require_ctx(ctx or current_ctx(), "serve_state_specs")

    def one(leaf):
        axis = _slot_axis(tuple(leaf.shape), batch, layers)
        logical = [None] * len(leaf.shape)
        if axis is not None:
            logical[axis] = "slot"
        return spec_for(tuple(leaf.shape), logical, ctx)

    return _map(one, state)


# Logical axes of the engine's per-slot sampling-plan tables: the
# (S, max_steps) ts / ts_prev tables and the (S,) guidance vector carry
# their slot dim on "slot"
_SERVE_PLAN_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    "ts": ("slot", None),
    "ts_prev": ("slot", None),
    "guidance": ("slot",),
}


def serve_plan_specs(plan, ctx: Optional[ShardingCtx] = None):
    """Specs for the engine's sampling-plan tables, keyed like ``plan``
    (ts / ts_prev / guidance): slot rows over ``data``."""
    ctx = _require_ctx(ctx or current_ctx(), "serve_plan_specs")
    return {k: spec_for(tuple(v.shape), _SERVE_PLAN_AXES[k], ctx)
            for k, v in plan.items()}


def serve_snapshot_specs(snap, ctx: Optional[ShardingCtx] = None):
    """Specs for a preemption snapshot: every leaf replicated, so the
    snapshot can be restored into any slot, on any data rank."""
    _require_ctx(ctx or current_ctx(), "serve_snapshot_specs")
    return _map(lambda v: (None,) * len(v.shape), snap)


def serve_metrics_specs(metrics, ctx: Optional[ShardingCtx] = None):
    """Specs for the device-metrics tree (``obs.metrics.
    init_device_metrics``): the ``per_slot`` group's (S,) leaves over
    ``slot``, counters and histogram bins replicated.  A walker of its own:
    a histogram's bucket count is set by its spec, not by the batch, so the
    state walker's extent rule could take it for a slot row."""
    ctx = _require_ctx(ctx or current_ctx(), "serve_metrics_specs")
    out = {}
    for group, leaves in metrics.items():
        if group == "flat":
            continue
        if group == "per_slot":
            out[group] = {k: spec_for(tuple(v.shape), ("slot",), ctx)
                          for k, v in leaves.items()}
        else:
            out[group] = _map(lambda v: (None,) * len(v.shape), leaves)
    return out


def param_specs(defs, ctx: Optional[ShardingCtx] = None):
    """Specs matching a tree of ``ParamDef`` (the reference's
    ``param_shardings``); a def with no axes is replicated."""
    from repro_torch.models.params import ParamDef   # local: avoids a cycle
    ctx = _require_ctx(ctx or current_ctx(), "param_specs")

    def one(d: ParamDef) -> Spec:
        axes = d.axes if d.axes is not None else (None,) * len(d.shape)
        return spec_for(tuple(d.shape), axes, ctx)

    return _map(one, defs, is_leaf=lambda x: isinstance(x, ParamDef))


# --------------------------------------------------------------------------
# Local shards
# --------------------------------------------------------------------------

def block_view(full: torch.Tensor, spec: Spec, coords: Dict[str, int],
               extents: Dict[str, int]) -> torch.Tensor:
    """The view of ``full`` that a rank at ``coords`` holds under ``spec``:
    each sharded dim cut into equal contiguous blocks over its mesh axes
    (major axis first), the block at the rank's ``coords`` kept."""
    out = full
    for dim, axes in enumerate(spec):
        names = _as_tuple(axes)
        if not names:
            continue
        n, idx = 1, 0
        for a in names:
            idx = idx * extents[a] + coords[a]
            n *= extents[a]
        size = full.shape[dim] // n
        out = out.narrow(dim, idx * size, size)
    return out


def local_slice(full: torch.Tensor, spec: Spec, coords: Dict[str, int],
                extents: Dict[str, int]) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (``block_view``), as a
    contiguous copy."""
    return block_view(full, spec, coords, extents).contiguous()
