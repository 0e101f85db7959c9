"""Serving meshes and the ranks behind them, after the reference's
``launch/mesh.py``.

A mesh here is a ``torch.distributed`` ``DeviceMesh`` over the ranks of an
initialized process group, one process per rank.  ``RankGroup`` starts
those processes (the ``spawn`` start method) on one host, each joining a
group on localhost (``init_ranks`` on a ``free_port``), and collects what
each returns.  Functions, not module constants, so that importing this
module touches no process group.  The reference's
``make_production_mesh`` (a 256-chip dry-run mesh) has no counterpart
yet.
"""
from __future__ import annotations

import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


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


def make_serving_mesh(data: Optional[int] = None, model: int = 1):
    """(data, model) mesh for the sharded diffusion serving engine: slots
    over ``data``, DiT weights tensor-parallel over ``model``.  A
    ``DeviceMesh`` over the initialized process group's ranks, row-major
    (rank = d * model + m); ``data`` defaults to ``world_size // model``."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("make_serving_mesh needs an initialized process "
                           "group (init_ranks)")
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


def make_host_mesh():
    """The (1, 1) mesh of a one-rank process group (axis names as in
    production); the group must be initialized (``init_ranks``)."""
    return make_serving_mesh(1, 1)


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
