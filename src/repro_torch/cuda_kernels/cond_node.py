"""Wrapper of the IF-node kernel (``csrc/cond_node.cu``).

Replaces no Pallas kernel: it is the port's form of the reference's
``lax.cond(jnp.all(mask), ...)`` inside a captured step graph.
``if_all(mask, body, when_all=...)`` runs ``body`` (a callable that
launches work and returns nothing) only when ``all(mask) == when_all``;
``if_all_sides(mask, sides)`` does so for up to two ``(body, when_all)``
sides of one branch on one read of the mask:

- on a CPU mask, the plain version (``ref.if_all``) read on the
  host, and each body runs or not (returns True: the decision crossed to
  the host);
- on a CUDA mask while the current stream captures a graph, an IF node a
  side: one condition kernel (``set_if_all``), captured before the nodes,
  sets every side's condition, and each body is captured into its node's
  body graph, on this module's body stream, its allocations in this
  module's body pool (returns False: nothing crossed);
- on a CUDA mask outside a capture, it raises: the eager card path decides
  on the host itself (``CachePolicy.branch``), it does not launch this
  kernel.

Where a kernel that makes the mask sets the condition itself (fused_gate's
GEMM, ``fused_gate(cond=...)``), the node needs no condition kernel:
``condition(device)`` makes the handle for that kernel, and
``if_set(handle, body, device)`` adds the node on it.

The body stream and the body pool are one per device, made by ``prepare``
before a capture (a capture cannot create a cuBLAS workspace for a new
stream eagerly).  The caching allocator routes a capture's own stream to
the graph's private pool, not a second stream captured into a node, so
every body allocates from the body pool and nothing else does; the pool
lives as long as the process, so a body's addresses are never handed to
work outside the graphs, and graphs replayed one after another on one
stream may share them.  Counts: ``if_all.launches`` the condition kernels
captured, ``if_all.nodes`` the IF nodes; a graph's replays add what its
capture recorded (``core/step_graph.py``).  ``if_all.body_nodes`` holds
the last captured body's nodes by type (``NODE_TYPES``).
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Sequence, Tuple

import torch

from repro_torch.cuda_kernels import build, ref

_vp, _int, _ull = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
MAX_SIDES = 2                 # handles one set_if_all sets (kMaxHandles)
_ARGTYPES = {"cond_handle_create": [_vp, ctypes.POINTER(_ull)],
             "cond_set_all": [_vp, _int, ctypes.POINTER(_ull),
                              ctypes.POINTER(_int), _int, _vp],
             "cond_if_begin": [_ull, _vp, _vp],
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


def _index(device: torch.device) -> int:
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def prepare(device: torch.device) -> None:
    """Make ``device``'s body stream and body pool, and the cuBLAS state of
    the stream (a product in f32 and in bf16 run on it), before a capture;
    the library is built here too.  Idempotent."""
    index = _index(device)
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


def _capturing_stream(device: torch.device) -> torch.cuda.Stream:
    """The current stream of ``device``, which must be capturing a graph,
    with the device's body stream made (``prepare``)."""
    if not torch.cuda.is_current_stream_capturing():
        raise RuntimeError("an IF node on a CUDA mask needs a graph capture "
                           "under way: outside one the caller branches on "
                           "the host")
    if _index(device) not in _BODY:
        raise RuntimeError("cond_node.prepare(device) must run before the "
                           "capture")
    return torch.cuda.current_stream(device)


def condition(device: torch.device) -> int:
    """A new condition handle of the graph that ``device``'s current stream
    captures, 0 at each launch until a kernel of the graph sets it: for a
    kernel that makes a mask to set (``fused_gate(cond=...)``), and an IF
    node on it (``if_set``)."""
    stream = _capturing_stream(device)
    out = _ull(0)
    err = _kernel("cond_handle_create")(stream.cuda_stream,
                                        ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"cond_node: making a condition handle failed: "
                           f"CUDA error {err}")
    return out.value


def if_set(handle: int, body: Callable[[], None],
           device: torch.device) -> None:
    """An IF node on ``handle`` (``condition``), whose body is ``body``'s
    capture, after the work captured so far on ``device``'s current stream:
    ``body`` runs at a replay when the kernel that set the handle set it to
    1.  Counts one node (``if_all.nodes``) and no condition kernel."""
    stream = _capturing_stream(device)
    body_stream, pool = _BODY[_index(device)]
    err = _kernel("cond_if_begin")(handle, stream.cuda_stream,
                                   body_stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"cond_node: adding the IF node failed: CUDA "
                           f"error {err}")
    if_all.nodes += 1
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


def if_all_sides(mask: torch.Tensor,
                 sides: Sequence[Tuple[Callable[[], None], bool]]) -> bool:
    """Each ``(body, when_all)`` of ``sides`` (at most MAX_SIDES) run only
    when all(mask) == when_all, on one read of the mask (see the module
    docstring).  Returns whether the decision was read on the host."""
    _check(mask)
    if not 1 <= len(sides) <= MAX_SIDES:
        raise ValueError(f"if_all_sides takes 1 to {MAX_SIDES} sides, got "
                         f"{len(sides)}")
    if mask.device.type == "cpu":
        for body, when_all in sides:
            if bool(ref.if_all(mask, when_all)):
                body()
        return True
    if mask.device.type != "cuda":
        raise ValueError(f"if_all runs on CPU or CUDA, not {mask.device}")
    stream = _capturing_stream(mask.device)
    handles = [condition(mask.device) for _ in sides]
    err = _kernel("cond_set_all")(
        mask.data_ptr(), mask.numel(), (_ull * len(sides))(*handles),
        (_int * len(sides))(*(int(w) for _, w in sides)), len(sides),
        stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"cond_node: the condition kernel's launch "
                           f"failed: CUDA error {err}")
    if_all.launches += 1
    for handle, (body, _) in zip(handles, sides):
        if_set(handle, body, mask.device)
    return False


def if_all(mask: torch.Tensor, body: Callable[[], None], *,
           when_all: bool) -> bool:
    """Run ``body`` only when all(mask) == when_all (see the module
    docstring).  Returns whether the decision was read on the host."""
    return if_all_sides(mask, [(body, when_all)])


if_all.launches = 0
if_all.nodes = 0
if_all.body_nodes = {}
