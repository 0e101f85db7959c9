"""LLM training on a ``(data, model)`` mesh, after the reference's
``launch/train.py`` under ``use_sharding(mesh, make_rules("train"))``: one
process per rank, each holding its block of every leaf.

* Parameters: cut by ``param_specs`` under the train rules (``cut_model``
  cuts a model in place, ``init_sharded`` draws one leaf at a time as the
  single-device init draws it and keeps this rank's block).  A weight cut
  over ``data`` is gathered before its layer runs and its gradient
  reduce-scattered back (FSDP); heads, kv heads, ffn columns, the vocab
  and the experts cut over ``model`` run tensor- and expert-parallel
  (``models/layers.py``, ``models/transformer.py``).
* Batch: this rank's rows of the global batch (``batch_specs``: the rows
  over ``data``); the loss is the global batch's (nll and token counts
  summed over the batch axes), the MoE's capacity, slots and aux loss
  the global batch's.
* Gradients: a leaf's gradient is whole over the axes that do not cut it
  (a replicated input's gradient is summed inside the step, a leaf
  replicated over the batch axes has its gradient all-reduced over them
  after the backward); the global norm counts each distinct block once.
* Optimizer state: cut as its leaf (``optimizer_specs``: AdamW's moments
  as the parameters; Adafactor's row and column statistics as the leaf
  without its last or second-to-last dim), Adafactor's means over the
  ranks that cut the dims they average.

``make_sharded_train_step`` is ``training.loop.make_train_step`` itself on
a mesh of one rank (bit for bit), and otherwise its counterpart: the same
metrics, read back only at log steps, no host sync in a step.
``shard_tree`` and ``gather_tree`` move a tree between its global form and
the ranks' blocks.  The SSM and hybrid families cut their mixers' ``inner``
axis over ``model``, which this path does not run: ``check_family``
refuses them on a mesh wider than one rank.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from repro_torch import tree
from repro_torch.distributed import collectives
from repro_torch.distributed.collectives import MeshComms
from repro_torch.distributed.sharding import (ShardingCtx, Spec, _as_tuple,
                                              block_view, local_slice,
                                              make_rules, param_specs,
                                              spec_for)
from repro_torch.models import layers
from repro_torch.models.params import def_leaves
from repro_torch.training.loop import grad_tree, make_train_step
from repro_torch.training.optimizer import (Adafactor, LeafShard,
                                            clip_by_global_norm)

ATTENTION_ONLY = ("dense", "moe", "vlm", "audio")
NEXT_FAMILIES = "ROADMAP A8 (the SSM and hybrid families on a mesh)"


def check_family(cfg, mesh_size: int) -> None:
    """Refuse an SSM or hybrid config on a mesh wider than one rank."""
    if mesh_size > 1 and cfg.family not in ATTENTION_ONLY:
        raise ValueError(
            f"{cfg.name}: the {cfg.family} family trains on one device only;"
            f" its Mamba / mLSTM / sLSTM mixers cut their inner axis over "
            f"model, which the sharded step does not run yet "
            f"({NEXT_FAMILIES})")


def train_ctx(mesh: MeshComms) -> ShardingCtx:
    """The train rules on ``mesh``'s extents."""
    return ShardingCtx(mesh, make_rules("train"))


def batch_axes(mesh: MeshComms, global_batch: int) -> Tuple[str, ...]:
    """The mesh axes that cut the batch's rows under the train rules
    (``act_batch``).  Raises when an axis other than ``model`` is wider
    than one rank and does not cut them: those ranks would each hold the
    whole batch and count it again."""
    rows = spec_for((global_batch,), ("act_batch",), train_ctx(mesh))[0]
    axes = tuple(a for a in _as_tuple(rows) if mesh.extents[a] > 1)
    idle = [a for a, n in mesh.extents.items()
            if n > 1 and a != "model" and a not in axes]
    if idle:
        raise ValueError(
            f"a global batch of {global_batch} rows does not split over the "
            f"mesh's {'/'.join(idle)} axis "
            f"({'x'.join(str(mesh.extents[a]) for a in idle)} ranks): "
            "batch_specs would replicate it")
    return axes


def leaf_specs(model, mesh: MeshComms) -> Dict:
    """The specs of ``model``'s parameter tree (``training.loop.
    param_tree``'s structure) on ``mesh``."""
    return param_specs(model.param_defs(), train_ctx(mesh))


def _groups(model):
    """(ParamGroup, its per-layer specs' source) in ``model.init``'s order:
    the top-level group, then each layer's sub-groups."""
    yield model.top
    for blk in model.blocks:
        for sub in blk.subs:
            yield getattr(blk, sub)


def _group_specs(group, ctx: ShardingCtx) -> Dict[str, Spec]:
    return {name: spec_for(d.shape, d.axes or (None,) * len(d.shape), ctx)
            for name, d in group.defs.items()}


def _mark(model, mesh: MeshComms) -> None:
    if mesh.size > 1:
        model.cut_onto = tuple(mesh.extents.items())


@torch.no_grad()
def cut_model(model, mesh: MeshComms):
    """Cut every parameter of ``model`` (a ``TransformerModel``) to this
    rank's block, in place; each group keeps its specs.  Returns the
    model."""
    check_family(model.cfg, mesh.size)
    ctx = train_ctx(mesh)
    for group in _groups(model):
        group.specs = _group_specs(group, ctx)
        for name, spec in group.specs.items():
            p = getattr(group, name)
            p.data = local_slice(p.data, spec, mesh.coords, mesh.extents)
    _mark(model, mesh)
    return model


@torch.no_grad()
def init_sharded(cfg, device, seed: int, mesh: MeshComms):
    """A ``TransformerModel`` of ``cfg`` on ``device`` holding this rank's
    blocks of the weights that ``launch.train.init_model(cfg, device,
    seed)`` draws: each leaf is drawn whole from the same generator in the
    same order, cut, and dropped, so a rank never holds more than its
    blocks and one whole leaf."""
    from repro_torch.device import resolve_device
    from repro_torch.models.transformer import TransformerModel
    check_family(cfg, mesh.size)
    dev = resolve_device(device)
    model = TransformerModel(cfg, device="meta")
    model.device = dev
    gen = torch.Generator(dev).manual_seed(seed)
    ctx = train_ctx(mesh)
    for group in _groups(model):
        group.specs = _group_specs(group, ctx)
        for name, d in group.defs.items():
            old = getattr(group, name)
            full = torch.empty(d.shape, dtype=old.dtype, device=dev)
            layers.draw(d, full, gen)
            local = local_slice(full, group.specs[name], mesh.coords,
                                mesh.extents)
            del full
            setattr(group, name, nn.Parameter(local, requires_grad=False))
    _mark(model, mesh)
    return model


def spec_leaves(specs) -> list:
    """The specs of a specs tree (nested dicts of spec tuples), in the
    order ``tree.leaves`` gives the matching tree's leaves (sorted keys)."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    return [specs]


def _zip_specs(fn, specs, other):
    """``fn(spec, leaf)`` over a specs tree and a tree of the same
    structure, in that structure."""
    if isinstance(specs, dict):
        return {k: _zip_specs(fn, v, other[k]) for k, v in specs.items()}
    return fn(specs, other)


def _axes(spec) -> Tuple[str, ...]:
    return tuple(a for entry in spec for a in _as_tuple(entry))


def leaf_shards(model, specs, mesh: MeshComms) -> list:
    """The optimizer's view of each block: a ``LeafShard`` per leaf of
    ``model``'s parameter tree, in ``tree.leaves`` order."""
    return [LeafShard(tuple(d.shape),
                      tuple(mesh.comm(_as_tuple(e)) for e in sp),
                      mesh.comm(_axes(sp)))
            for sp, d in zip(spec_leaves(specs),
                             def_leaves(model.param_defs()))]


def _check_optimizer_specs(opt, model, specs, mesh: MeshComms) -> None:
    """Adafactor's statistics must be cut as the leaf without the dim they
    average, so that each rank's statistics are its block's."""
    if not isinstance(opt, Adafactor):
        return
    from repro_torch.launch.specs import optimizer_specs
    ost = optimizer_specs(opt, model.param_defs(), train_ctx(mesh))
    for sp, vr, vc in zip(spec_leaves(specs), spec_leaves(ost.vr),
                          spec_leaves(ost.vc)):
        want_vr = sp[:-1] if len(sp) >= 2 else sp
        want_vc = sp[:-2] + sp[-1:] if len(sp) >= 2 else ()
        if vr != want_vr or vc != want_vc:
            raise ValueError(f"Adafactor statistics cut as {vr} / {vc}, "
                             f"not as their leaf {sp}")


def make_sharded_train_step(model, opt, lr_fn: Callable, mesh: MeshComms,
                            max_grad_norm: float = 1.0):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` on this rank's blocks: ``params = param_tree(model)`` of a
    model cut onto ``mesh`` (``cut_model`` / ``init_sharded``), the state
    from ``opt.init(params)``, ``batch`` this rank's rows of the global
    batch; the metrics are the global step's (``make_train_step``'s).  On
    a one-rank mesh it is ``make_train_step(model, opt, lr_fn,
    max_grad_norm)``.  ``train_step.grads`` is the gradient tree of local
    blocks (clipped after a step), ``.specs`` its specs."""
    if mesh.size == 1:
        return make_train_step(model, opt, lr_fn, max_grad_norm)
    check_family(model.cfg, mesh.size)
    if model.cut_onto != tuple(mesh.extents.items()):
        raise ValueError(f"the model is cut onto {model.cut_onto}, not onto "
                         f"this mesh {mesh.extents}")
    specs = leaf_specs(model, mesh)
    _check_optimizer_specs(opt, model, specs, mesh)
    grads = grad_tree(model)
    shards = leaf_shards(model, specs, mesh)
    # leaves whose batch axes do not cut them: their gradients are this
    # rank's rows' sums until all-reduced over those axes
    whole_over = []
    for g, sp in zip(tree.leaves(grads), spec_leaves(specs)):
        cut = _axes(sp)
        comm = mesh.comm([a for a in mesh.batch_axes if a not in cut])
        if comm is not None:
            whole_over.append((g, comm))

    def train_step(params, opt_state, batch, events=None):
        mark = (lambda i: events[i].record()) if events else (lambda i: None)
        mark(0)
        with collectives.active(mesh):
            torch._foreach_zero_(tree.leaves(grads))
            loss, metrics = model.loss(batch)
            mark(1)
            loss.backward()
            with torch.no_grad():
                for g, comm in whole_over:
                    g.copy_(comm.all_reduce(g))
            mark(2)
            _, gnorm = clip_by_global_norm(grads, max_grad_norm, shards)
            lr = lr_fn(opt_state.step)
            params, opt_state = opt.update(grads, opt_state, params, lr,
                                           shards=shards)
            mark(3)
        out = {"loss": loss.detach(), "grad_norm": gnorm, "lr": lr}
        out.update({k: v.detach() for k, v in metrics.items()
                    if v.ndim == 0})
        return params, opt_state, out

    train_step.grads = grads
    train_step.specs = specs
    return train_step


# --------------------------------------------------------------------------
# Trees between their global form and the ranks' blocks
# --------------------------------------------------------------------------

def shard_tree(tree_, specs, mesh: MeshComms):
    """This rank's block of each leaf of a global tree (``local_slice``);
    a non-tensor leaf as it is."""
    def one(spec, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return local_slice(leaf, spec, mesh.coords, mesh.extents)
    return _zip_specs(one, specs, tree_)


@torch.no_grad()
def gather_tree(tree_, specs, mesh: MeshComms):
    """The global tree on the host of the rank at coordinates 0; None on
    the others.  One leaf at a time, each rank whose block is distinct (at
    coordinate 0 on every axis that does not cut the leaf) sends it to
    that rank, which places it: no rank holds more than its own blocks and
    one block in flight.  Point to point over the mesh's process group: on
    the card under ``native`` (NCCL), from the host under ``staged``
    (gloo).  Every rank must call it."""
    import itertools

    import torch.distributed as dist
    world = mesh.comm(mesh.axis_names)
    lead = all(c == 0 for c in mesh.coords.values())
    if world is None:
        return tree.map(lambda x: x.detach().cpu()
                        if isinstance(x, torch.Tensor) else x, tree_)
    if world.transport == "count":
        raise ValueError("gather_tree: counting comms move nothing")
    names, ext = mesh.axis_names, mesh.extents
    every = [dict(zip(names, c))
             for c in itertools.product(*(range(ext[a]) for a in names))]
    me = every.index(mesh.coords)
    host = world.transport == "staged"

    def one(spec, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        cut = {a for e in spec for a in _as_tuple(e)}
        senders = [r for r, c in enumerate(every)
                   if not any(c[a] for a in names if a not in cut)]
        blk = leaf.detach().contiguous()
        if host:
            blk = blk.cpu()
        if not lead:
            if me in senders:
                dist.send(blk, dst=dist.get_global_rank(world.group, 0),
                          group=world.group)
            return None
        shape = [n * math.prod(ext[a] for a in _as_tuple(e))
                 for n, e in itertools.zip_longest(blk.shape, spec[:blk.ndim])]
        out = torch.empty(shape, dtype=blk.dtype, device="cpu")
        for r in senders:
            got = blk
            if r != me:
                got = torch.empty_like(blk)
                dist.recv(got, src=dist.get_global_rank(world.group, r),
                          group=world.group)
            block_view(out, spec, every[r], ext).copy_(got)
        return out

    out = _zip_specs(one, specs, tree_)
    return out if lead else None


def data_shard(mesh: MeshComms) -> Optional[Tuple[int, int]]:
    """(this rank's index, the count) along the batch axes, for a data
    stream's ``shard=``; None on a mesh whose batch is not cut."""
    comm = mesh.comm(mesh.batch_axes)
    return None if comm is None else (comm.rank, comm.size)


def train_mesh(device_mesh, backend: str, global_batch: int) -> MeshComms:
    """The ``MeshComms`` of a ``(data, model)`` ``DeviceMesh`` whose
    process group runs ``backend``, with the batch axes of a global batch
    of ``global_batch`` rows (``batch_axes``)."""
    mesh = collectives.device_mesh_comms(
        device_mesh, collectives.transport_for(backend))
    return mesh.with_batch_axes(batch_axes(mesh, global_batch))


def counting_train_mesh(dims, global_batch: int) -> MeshComms:
    """The dry run's mesh of ``dims`` ((data, model) or (pod, data,
    model)): counting comms at rank coordinates 0, the batch axes of a
    global batch of ``global_batch`` rows."""
    names = ("pod", "data", "model") if len(dims) == 3 else ("data", "model")
    mesh = collectives.counting_mesh(dict(zip(names, dims)))
    return mesh.with_batch_axes(batch_axes(mesh, global_batch))

