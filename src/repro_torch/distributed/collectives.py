"""Collectives of sharded training over a ``(data, model)`` mesh, and their
byte count.

A ``Comm`` is one group of ranks along some mesh axes.  Its transport is
chosen by the caller from the process group's backend and never changes
on a failure:

* ``native``: ``all_gather_into_tensor``, ``reduce_scatter_tensor`` and
  ``all_reduce`` as they are (NCCL, one card per rank);
* ``staged``: through ``broadcast`` and ``all_reduce``, what gloo runs on
  CUDA tensors: an all-gather is one broadcast of each rank's block into
  a stack, a reduce-scatter the all-reduce of the whole tensor cut to
  this rank's block (gloo on ranks that share a card, NCCL refusing two
  ranks on one device; and gloo on the CPU), and an all-to-all gloo's
  own through the host;
* ``count``: moves nothing, returns tensors of the shapes the collective
  would give (on the ``meta`` device in the dry run) and counts what
  would move.

Whatever the transport, a Comm's ``counter`` (its mesh's, ``MeshComms.
counter``) adds the logical collective's bytes, in the reference's
convention (``distributed/hlo.py``): the size of each call's result on
this device, by kind (``all-gather``, ``all-reduce``, ``reduce-scatter``,
``all-to-all``) and ``total``.

The autograd functions are the patterns of a sharded step:
``gather_forward`` (all-gather over the FSDP axes, reduce-scatter
backward: each rank uses its own part of the whole), ``gather_replicated``
(all-gather, this rank's block of the gradient backward: a weight cut
over ``model`` for storage only, used whole by a computation replicated
over ``model``, so each rank's gradient of the whole is already the
sum), ``all_to_all`` (blocks exchanged, the inverse exchange backward:
a column-parallel output that another rank's channels need),
``reduce_forward`` (the sum over the group, identity backward:
a row-parallel output, or a statistic summed over ``data`` such as the
loss's token count), ``reduce_backward`` (identity, all-reduce backward:
a replicated input entering a tensor-parallel region) and
``Comm.all_reduce`` itself where no gradient flows (a max, the MoE's
per-expert counts).

``MeshComms`` is a mesh as the step sees it: each axis's extent, this
rank's coordinates, the batch axes and a ``Comm`` over any set of axes;
``active`` makes one current for the model code (``current``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")
TRANSPORTS = ("native", "staged", "count")
_BACKEND_TRANSPORT = {"nccl": "native", "gloo": "staged"}


class Counter:
    """Bytes by collective kind: each call's result size on this device."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.bytes = {k: 0 for k in KINDS}

    def add(self, kind: str, result: torch.Tensor) -> None:
        self.bytes[kind] += result.numel() * result.element_size()

    def read(self) -> Dict[str, int]:
        out = dict(self.bytes)
        out["total"] = sum(self.bytes.values())
        return out



def transport_for(backend: str) -> str:
    """The transport of a process group's backend: ``native`` on NCCL,
    ``staged`` on gloo."""
    if backend not in _BACKEND_TRANSPORT:
        raise ValueError(f"no collective transport for backend {backend!r}; "
                         f"expected one of {sorted(_BACKEND_TRANSPORT)}")
    return _BACKEND_TRANSPORT[backend]


class Comm:
    """``size`` ranks along some mesh axes, this one at ``rank`` (ordered
    major axis first); ``group`` is their process group (None under the
    ``count`` transport); ``counter`` adds each call's bytes."""

    def __init__(self, size: int, rank: int, transport: str, group=None,
                 counter: Optional[Counter] = None):
        if transport not in TRANSPORTS:
            raise ValueError(f"transport {transport!r} is not one of "
                             f"{TRANSPORTS}")
        if transport != "count" and group is None:
            raise ValueError(f"the {transport} transport needs a process "
                             "group")
        self.size, self.rank = size, rank
        self.transport, self.group = transport, group
        self.counter = Counter() if counter is None else counter

    def _all_reduce(self, t: torch.Tensor, op: str) -> None:
        import torch.distributed as dist
        ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
        dist.all_reduce(t, op=ops[op], group=self.group)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The elementwise ``op`` ("sum" or "max") over the group, as a new
        tensor."""
        out = x.detach().clone()
        if self.transport != "count":
            self._all_reduce(out, op)
        self.counter.add("all-reduce", out)
        return out

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' blocks concatenated along ``dim``, rank order."""
        x = x.detach().contiguous()
        n = self.size
        if self.transport == "count":
            shape = list(x.shape)
            shape[dim] *= n
            out = x.new_empty(shape)
        else:
            if self.transport == "native":
                import torch.distributed as dist
                flat = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
                dist.all_gather_into_tensor(flat, x, group=self.group)
                stack = flat.view((n,) + tuple(x.shape))
            else:
                import torch.distributed as dist
                stack = x.new_empty((n,) + tuple(x.shape))
                stack[self.rank] = x
                for r in range(n):
                    dist.broadcast(stack[r],
                                   src=dist.get_global_rank(self.group, r),
                                   group=self.group)
            out = stack.movedim(0, dim).reshape(
                x.shape[:dim] + (n * x.shape[dim],) + x.shape[dim + 1:])
        self.counter.add("all-gather", out)
        return out

    def all_to_all(self, x: torch.Tensor, dim: int, send: Sequence[int],
                   recv: Sequence[int]) -> torch.Tensor:
        """Blocks of ``x`` along ``dim`` to the ranks in order (``send[j]``
        entries to rank j); the result holds what each rank sent here,
        rank order (``recv[j]`` entries from rank j)."""
        xt = x.detach().movedim(dim, 0).contiguous()
        shape = (sum(recv),) + tuple(xt.shape[1:])
        if self.transport == "count":
            out = xt.new_empty(shape)
        else:
            import torch.distributed as dist
            host = self.transport == "staged"
            src = xt.cpu() if host else xt
            out = src.new_empty(shape)
            dist.all_to_all_single(out, src, list(recv), list(send),
                                   group=self.group)
            out = out.to(x.device)
        out = out.movedim(0, dim)
        self.counter.add("all-to-all", out)
        return out

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block along ``dim`` of the sum over the group."""
        x = x.detach()
        n = self.size
        if x.shape[dim] % n:
            raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                             f"does not split over {n} ranks")
        c = x.shape[dim] // n
        if self.transport == "count":
            out = x.narrow(dim, self.rank * c, c).clone()
        elif self.transport == "native":
            import torch.distributed as dist
            xt = x.movedim(dim, 0).contiguous()
            out = xt.new_empty((c,) + tuple(xt.shape[1:]))
            dist.reduce_scatter_tensor(out, xt, group=self.group)
            out = out.movedim(0, dim).contiguous()
        else:
            full = x.contiguous().clone()
            self._all_reduce(full, "sum")
            out = full.narrow(dim, self.rank * c, c).contiguous()
        self.counter.add("reduce-scatter", out)
        return out


# --------------------------------------------------------------------------
# The autograd patterns
# --------------------------------------------------------------------------

class _GatherForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm: Comm, dim: int):
        ctx.comm, ctx.dim = comm, dim
        return comm.all_gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.comm.reduce_scatter(grad, ctx.dim), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm: Comm, dim: int):
        ctx.comm, ctx.dim = comm, dim
        return comm.all_gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        c = grad.shape[ctx.dim] // ctx.comm.size
        return grad.narrow(ctx.dim, ctx.comm.rank * c, c), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm: Comm, dim: int, send, recv):
        ctx.comm, ctx.dim, ctx.send, ctx.recv = comm, dim, send, recv
        return comm.all_to_all(x, dim, send, recv)

    @staticmethod
    def backward(ctx, grad):
        return (ctx.comm.all_to_all(grad, ctx.dim, ctx.recv, ctx.send),
                None, None, None, None)


class _ReduceForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm: Comm):
        return comm.all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ReduceBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm: Comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.comm.all_reduce(grad), None


def gather_forward(x: torch.Tensor, comm: Optional[Comm],
                   dim: int) -> torch.Tensor:
    """All-gather along ``dim`` (a weight's FSDP shard); the gradient is
    reduce-scattered back to this rank's block.  ``x`` itself when
    ``comm`` is None (an axis of extent 1)."""
    return x if comm is None else _GatherForward.apply(x, comm, dim)


def gather_replicated(x: torch.Tensor, comm: Optional[Comm],
                      dim: int) -> torch.Tensor:
    """All-gather along ``dim`` for a computation that every rank of the
    group runs whole on the same inputs: the gradient of the whole is then
    the same on every rank, and this rank keeps its block of it (no
    collective backward).  ``x`` itself when ``comm`` is None."""
    return x if comm is None else _GatherReplicated.apply(x, comm, dim)


def all_to_all(x: torch.Tensor, comm: Comm, dim: int, send: Sequence[int],
               recv: Sequence[int]) -> torch.Tensor:
    """``Comm.all_to_all``; the gradient goes back by the inverse
    exchange."""
    return _AllToAll.apply(x, comm, dim, tuple(send), tuple(recv))


def reduce_forward(x: torch.Tensor, comm: Optional[Comm]) -> torch.Tensor:
    """The sum over the group; the gradient passes as it is (every rank
    carries the same downstream gradient)."""
    return x if comm is None else _ReduceForward.apply(x, comm)


def reduce_backward(x: torch.Tensor, comm: Optional[Comm]) -> torch.Tensor:
    """``x`` as it is; its gradient is summed over the group (a replicated
    tensor whose ranks each use a part of it)."""
    return x if comm is None else _ReduceBackward.apply(x, comm)


# --------------------------------------------------------------------------
# Meshes
# --------------------------------------------------------------------------

class MeshComms:
    """A mesh as a sharded step sees it: ``extents`` and this rank's
    ``coords`` by axis name (major axis first), ``batch_axes`` (the axes
    that cut the batch rows), ``kv_axes`` (those that cut a decode
    cache's slots) and ``comm(axes)``, the ranks that share this
    rank's coordinates off ``axes`` (None when they are this rank alone).
    ``make_comm(axes, size, rank, counter)`` builds a Comm once per set of
    axes; every Comm of the mesh adds its bytes to ``counter``."""

    def __init__(self, extents: Dict[str, int], coords: Dict[str, int],
                 make_comm: Callable[..., Comm],
                 batch_axes: Sequence[str] = (),
                 counter: Optional[Counter] = None,
                 kv_axes: Sequence[str] = ()):
        self.extents, self.coords = dict(extents), dict(coords)
        self.axis_names = tuple(extents)
        self.batch_axes = tuple(batch_axes)
        self.kv_axes = tuple(kv_axes)
        self.counter = Counter() if counter is None else counter
        self._make = make_comm
        self._comms: Dict[Tuple[str, ...], Optional[Comm]] = {}

    @property
    def size(self) -> int:
        return math.prod(self.extents.values())

    @property
    def axis_sizes(self) -> Tuple[int, ...]:
        """The extents in axis order (what the sharding rules read)."""
        return tuple(self.extents.values())

    def comm(self, axes: Iterable[str]) -> Optional[Comm]:
        axes = tuple(a for a in self.axis_names if a in set(axes))
        if axes not in self._comms:
            size = math.prod(self.extents[a] for a in axes)
            rank = 0
            for a in axes:
                rank = rank * self.extents[a] + self.coords[a]
            self._comms[axes] = (None if size == 1 else
                                 self._make(axes, size, rank, self.counter))
        return self._comms[axes]

    def with_batch_axes(self, axes: Sequence[str],
                        kv_axes: Sequence[str] = ()) -> "MeshComms":
        """This mesh (its comms and counter) with ``batch_axes`` (and
        ``kv_axes``)."""
        out = MeshComms(self.extents, self.coords, self._make, axes,
                        self.counter, kv_axes)
        out._comms = self._comms
        return out


def counting_mesh(extents: Dict[str, int],
                  coords: Optional[Dict[str, int]] = None) -> MeshComms:
    """A mesh of ``count`` comms (the dry run's): nothing moves, every call
    is counted; ``coords`` default to rank 0 on every axis."""
    coords = coords or {a: 0 for a in extents}
    return MeshComms(extents, coords,
                     lambda axes, size, rank, counter: Comm(
                         size, rank, "count", counter=counter))


def device_mesh_comms(mesh, transport: str) -> MeshComms:
    """The Comms of a ``(data, model)`` ``DeviceMesh`` laid over the whole
    process group (rank = d * model + m): one axis's group from the mesh,
    both axes' the world."""
    import torch.distributed as dist
    names = tuple(mesh.mesh_dim_names)
    extents = dict(zip(names, tuple(mesh.mesh.shape)))
    coords = dict(zip(names, mesh.get_coordinate()))

    def make(axes, size, rank, counter):
        if len(axes) == 1:
            return Comm(size, rank, transport, mesh.get_group(axes[0]),
                        counter)
        if size != dist.get_world_size():
            raise ValueError(f"axes {axes} must span the mesh's whole "
                             "process group")
        return Comm(size, rank, transport, dist.group.WORLD, counter)

    return MeshComms(extents, coords, make)


# one per process (a rank), not per thread: on the card autograd runs the
# backward, and remat's recomputed forward, on a thread of its own
_ACTIVE: Dict[str, Optional[MeshComms]] = {"mesh": None}


def current() -> Optional[MeshComms]:
    """The mesh of the sharded step running in this process, or None."""
    return _ACTIVE["mesh"]


@contextlib.contextmanager
def active(mesh: Optional[MeshComms]):
    """Make ``mesh`` current for a block (the model code reads it)."""
    prev = current()
    _ACTIVE["mesh"] = mesh
    try:
        yield mesh
    finally:
        _ACTIVE["mesh"] = prev
