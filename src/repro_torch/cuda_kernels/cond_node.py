"""Wrapper of the IF-node kernel (``csrc/cond_node.cu``).

Replaces no Pallas kernel: it is the port's form of the reference's
``lax.cond(jnp.all(mask), ...)`` inside a captured step graph.
``if_all(mask, body, when_all=...)`` runs ``body`` (a callable that
launches work and returns nothing) only when ``all(mask) == when_all``:

- on a CPU mask, the plain version (``ref.if_all``) read on the
  host, and ``body`` runs or not (returns True: the decision crossed to the
  host);
- on a CUDA mask while the current stream captures a graph, an IF node:
  the condition kernel is captured before it and ``body`` is captured into
  the node's body graph, on this module's body stream, its allocations in
  this module's body pool (returns False: nothing crossed);
- on a CUDA mask outside a capture, it raises: the eager card path decides
  on the host itself (``CachePolicy.branch``), it does not launch this
  kernel.

The body stream and the body pool are one per device, made by ``prepare``
before a capture (a capture cannot create a cuBLAS workspace for a new
stream eagerly).  The caching allocator routes a capture's own stream to
the graph's private pool, not a second stream captured into a node, so
every body allocates from the body pool and nothing else does; the pool
lives as long as the process, so a body's addresses are never handed to
work outside the graphs, and graphs replayed one after another on one
stream may share them.  Each captured IF node adds one to
``if_all.launches`` (its condition kernel); a graph's replays add what its
capture recorded (``core/step_graph.py``).  ``if_all.body_nodes`` holds
the last captured body's nodes by type (``NODE_TYPES``).
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict

import torch

from repro_torch.cuda_kernels import build, ref

_vp, _int = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"cond_if_begin": [_vp, _int, _int, _vp, _vp],
             "cond_if_end": [_vp, _vp, _int]}
# cudaGraphNodeType by value; the last slot gathers the kinds not named
NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty",
              "wait_event", "event_record", "ext_semas_signal",
              "ext_semas_wait", "mem_alloc", "mem_free", "type_12",
              "conditional", "other")
_FNS: Dict[str, Callable] = {}
# per device index: (body stream, body pool)
_BODY: Dict[int, tuple] = {}


def _kernel(name: str):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(build.load_library("cond_node").lib, name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _int
        _FNS[name] = fn
    return fn


def prepare(device: torch.device) -> None:
    """Make ``device``'s body stream and body pool, and the cuBLAS state of
    the stream (a product in f32 and in bf16 run on it), before a capture;
    the library is built here too.  Idempotent."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index in _BODY:
        return
    dev = torch.device("cuda", index)
    _kernel("cond_if_begin")
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.ones((16, 16), dtype=dtype, device=dev)
            torch.matmul(a, a)
            torch.addmm(a[0], a, a)
    torch.cuda.current_stream(dev).wait_stream(stream)
    _BODY[index] = (stream, torch.cuda.MemPool())


def _check(mask: torch.Tensor) -> None:
    if mask.dim() != 1 or mask.dtype != torch.bool:
        raise ValueError(f"mask must be (B,) bool, got {tuple(mask.shape)} "
                         f"{mask.dtype}")
    if mask.numel() == 0:
        raise ValueError("if_all needs a non-empty mask")
    if not mask.is_contiguous():
        raise ValueError("if_all needs a contiguous mask")


def if_all(mask: torch.Tensor, body: Callable[[], None], *,
           when_all: bool) -> bool:
    """Run ``body`` only when all(mask) == when_all (see the module
    docstring).  Returns whether the decision was read on the host."""
    _check(mask)
    if mask.device.type == "cpu":
        if bool(ref.if_all(mask, when_all)):
            body()
        return True
    if mask.device.type != "cuda":
        raise ValueError(f"if_all runs on CPU or CUDA, not {mask.device}")
    if not torch.cuda.is_current_stream_capturing():
        raise RuntimeError("if_all on a CUDA mask needs a graph capture under "
                           "way: outside one the caller branches on the host")
    index = mask.device.index
    index = torch.cuda.current_device() if index is None else index
    if index not in _BODY:
        raise RuntimeError("cond_node.prepare(device) must run before the "
                           "capture")
    body_stream, pool = _BODY[index]
    stream = torch.cuda.current_stream(mask.device)
    err = _kernel("cond_if_begin")(mask.data_ptr(), mask.numel(),
                                   int(when_all), stream.cuda_stream,
                                   body_stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"cond_node: adding the IF node failed: CUDA "
                           f"error {err}")
    if_all.launches += 1
    counts = (_int * len(NODE_TYPES))()
    try:
        with torch.cuda.stream(body_stream), torch.cuda.use_mem_pool(pool):
            body()
    finally:
        err = _kernel("cond_if_end")(body_stream.cuda_stream, counts,
                                     len(NODE_TYPES))
    if err != 0:
        raise RuntimeError(f"cond_node: ending the IF node's body capture "
                           f"failed: CUDA error {err}")
    if_all.body_nodes = {t: n for t, n in zip(NODE_TYPES, counts) if n}
    return False


if_all.launches = 0
if_all.body_nodes = {}
