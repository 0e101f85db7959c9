"""Meshes and the ranks behind them, after the reference's
``launch/mesh.py``.

A mesh here is a ``torch.distributed`` ``DeviceMesh`` over the ranks of an
initialized process group, one process per rank: ``make_mesh(data,
model)`` over the ranks a launcher starts or torchrun's, ``make_host_mesh``
the one-rank (1, 1) mesh, ``make_production_mesh`` the reference's (16,
16) pod (or (2, 16, 16)), real only in a process group of 256 (512) ranks.
``RankGroup`` starts processes (the ``spawn`` start method) on one host,
each joining a group on localhost (``init_ranks`` on a ``free_port``), and
collects what each returns; ``mesh_backend`` picks their backend and
devices.  Functions, not module constants, so that importing this module
touches no process group.

The dry run (``launch/dryrun.py``) plans for meshes no host here holds:
``abstract_production_mesh`` gives the production meshes as an
``AbstractMesh``, axis names and extents with no device and no process
group, which is all the sharding rules read of a mesh.
"""
from __future__ import annotations

import math
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class AbstractMesh(NamedTuple):
    """A mesh's axis extents and names (as ``jax.sharding.AbstractMesh``):
    ``distributed.sharding.mesh_extents`` reads it like a live mesh."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def abstract_mesh(dims: Sequence[int]) -> AbstractMesh:
    """(data, model) or, with three extents, (pod, data, model)."""
    dims = tuple(int(d) for d in dims)
    if len(dims) not in (2, 3):
        raise ValueError(f"a mesh has 2 or 3 axes, got {dims}")
    names = ("pod", "data", "model") if len(dims) == 3 else ("data", "model")
    return AbstractMesh(dims, names)


def production_shape(multi_pod: bool = False) -> Tuple[int, ...]:
    """The reference's production meshes: one pod (data=16, model=16) =
    256 chips; ``multi_pod``: (pod=2, data=16, model=16) = 512 chips."""
    return (2, 16, 16) if multi_pod else (16, 16)


def abstract_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """``production_shape`` as an ``AbstractMesh`` (the dry run's)."""
    return abstract_mesh(production_shape(multi_pod))


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh as a ``DeviceMesh`` over an initialized process
    group of exactly its 256 (``multi_pod``: 512) ranks, e.g. torchrun's;
    any other world size is refused with the size it needs."""
    from torch.distributed.device_mesh import DeviceMesh
    shape = production_shape(multi_pod)
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != need:
        raise ValueError(f"the production mesh {shape} needs a process "
                         f"group of {need} ranks (WORLD_SIZE={need}); this "
                         f"one has {have}")
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type,
                      torch.arange(need, dtype=torch.int).reshape(shape),
                      mesh_dim_names=names)


def mesh_backend(device: str, world: int) -> Tuple[str, List[str]]:
    """The process-group backend and each rank's device: ``nccl`` with a
    card per rank, ``gloo`` when the ranks share the cards there are (NCCL
    refuses two ranks on one card) and on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo", [str(dev)] * world
    n = torch.cuda.device_count()
    if n >= world:
        return "nccl", [f"cuda:{r}" for r in range(world)]
    return "gloo", [f"cuda:{r % n}" for r in range(world)]


def free_port() -> int:
    """A free TCP port on localhost for ``init_ranks``."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_ranks(rank: int, world_size: int, *, port: int,
               backend: str) -> None:
    """Join this process to a ``world_size``-rank group on localhost."""
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world_size)


def make_mesh(data: Optional[int] = None, model: int = 1):
    """A (data, model) ``DeviceMesh`` over the initialized process group's
    ranks, row-major (rank = d * model + m); ``data`` defaults to
    ``world_size // model``."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialized process group "
                           "(init_ranks)")
    n = dist.get_world_size()
    if data is None:
        data = max(1, n // model)
    if data * model != n:
        raise ValueError(f"mesh ({data}, {model}) needs {data * model} "
                         f"ranks, have {n}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type,
                      torch.arange(n, dtype=torch.int).reshape(data, model),
                      mesh_dim_names=("data", "model"))


def make_serving_mesh(data: Optional[int] = None, model: int = 1):
    """(data, model) mesh for the sharded diffusion serving engine: slots
    over ``data``, DiT weights tensor-parallel over ``model``
    (``make_mesh``)."""
    return make_mesh(data, model)


def make_host_mesh():
    """The (1, 1) mesh of a one-rank process group (axis names as in
    production); the group must be initialized (``init_ranks``)."""
    return make_mesh(1, 1)


def _rank_entry(target: Callable, rank: int, world: int, port: int,
                args: Sequence, out) -> None:
    try:
        out.put((rank, True, target(rank, world, port, *args)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


class RankGroup:
    """``world`` processes, each running ``target(rank, world, port,
    *args)`` (``port``: a free localhost port for ``init_ranks``), started
    at construction.  ``target`` must be importable by name in a fresh
    interpreter; what it returns must pickle."""

    def __init__(self, target: Callable, world: int, args: Sequence = (),
                 *, timeout: float = 600.0, label: str = "ranks"):
        import torch.multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.label, self.timeout = label, timeout
        self.out = ctx.Queue()
        port = free_port()
        self.procs = [ctx.Process(target=_rank_entry,
                                  args=(target, r, world, port, tuple(args),
                                        self.out), daemon=True)
                      for r in range(world)]
        self.t0 = time.monotonic()
        for p in self.procs:
            p.start()

    def results(self) -> List[Any]:
        """What each rank returned, by rank.  Raises ``RuntimeError`` with
        the traceback of a rank that raised, or when a rank exits without
        a result or the timeout passes; no rank outlives the call."""
        got = {}
        try:
            while len(got) < len(self.procs):
                try:
                    rank, ok, res = self.out.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(self.procs)
                            if p.exitcode is not None and r not in got]
                    if dead:
                        raise RuntimeError(f"{self.label}: rank(s) {dead} "
                                           "exited without a result")
                    if time.monotonic() - self.t0 > self.timeout:
                        raise RuntimeError(f"{self.label}: no result within "
                                           f"{self.timeout:.0f} s")
                    continue
                if not ok:
                    raise RuntimeError(f"{self.label}: rank {rank} failed:"
                                       f"\n{res}")
                got[rank] = res
        finally:
            # ranks that gave their result exit on their own; after a
            # failure the others may wait in a collective forever
            self.close(grace=30.0 if len(got) == len(self.procs) else 0.0)
        return [got[r] for r in range(len(self.procs))]

    def close(self, grace: float = 30.0) -> None:
        """Join every rank, killing those still running ``grace`` seconds
        from now."""
        deadline = time.monotonic() + grace
        for p in self.procs:
            p.join(timeout=max(deadline - time.monotonic(), 0.0))
            if p.is_alive():
                p.kill()
                p.join()


def run_ranks(target: Callable, world: int, args: Sequence = (), *,
              timeout: float = 600.0, label: str = "ranks") -> List[Any]:
    """``RankGroup(target, world, args).results()``."""
    return RankGroup(target, world, args, timeout=timeout,
                     label=label).results()
