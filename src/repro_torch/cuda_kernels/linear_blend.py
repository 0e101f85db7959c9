"""Wrapper of the ``linear_blend`` CUDA kernels (``csrc/linear_blend.cu``).

Replaces the reference's Pallas kernel ``repro/kernels/linear_blend.py:
linear_blend``.  CPU tensors go to the plain version
(``ref.linear_blend``), which ignores the copies of W; CUDA tensors launch
a kernel or raise — there is no fallback.  The kernel is the one of the
route ``route.gemm_route`` picks: ``"wgmma"`` (bf16 X against the caller's
bf16 copy of W, ``w_bf16=``, required there), ``"gemv"`` (the same
operands at M <= ``route.GEMV_MAX_ROWS`` rows: a split-K kernel over every
SM, ``route.gemv_plan``), ``"wgmma_split"`` (the wgmma kernel, where that
copy is a split one, W as bf16 terms) or ``"simt"`` (f32 W), unless the
call names one (``gemm=``).  Each launch adds one to
``linear_blend.launches`` and to ``linear_blend.launches_by_route[route]``.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional

import torch

from repro_torch.cuda_kernels import build, ref, route

F32 = torch.float32
MAX_ROW_TILES = 65535         # either kernel's grid.y, in 128-row tiles
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_vp, _int, _flt = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _kernel(which: str):
    """The launcher of route ``which``: the SIMT one takes a dtype code
    after F, the split one the number of W's terms after use_prev, the
    gemv one a workspace after out and the K rows of a split after F."""
    name = {route.WGMMA: "linear_blend_wgmma_launch",
            route.WGMMA_SPLIT: "linear_blend_wgmma_split_launch",
            route.GEMV: "linear_blend_gemv_launch",
            route.SIMT: "linear_blend_launch"}[which]
    fn = getattr(build.load_library("linear_blend").lib, name)
    if fn.argtypes is None:
        if which == route.GEMV:
            fn.argtypes = [_vp] * 6 + [_int] * 4 + [_flt] * 2 + [_int, _vp]
        else:
            n_int = 4 if which == route.SIMT else 3
            tail = [_int] * (2 if which == route.WGMMA_SPLIT else 1)
            fn.argtypes = ([_vp] * 5 + [_int] * n_int + [_flt] * 2 + tail
                           + [_vp])
        fn.restype = _int
    return fn


def _check(x, w, b, prev) -> None:
    if x.dim() != 2:
        raise ValueError(f"x must be (M, D), got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    m, d = x.shape
    if w.dim() != 2 or w.shape[0] != d or w.dtype != F32:
        raise ValueError(f"w must be ({d}, F) float32, got "
                         f"{tuple(w.shape)} {w.dtype}")
    f = w.shape[1]
    if tuple(b.shape) != (f,) or b.dtype != F32:
        raise ValueError(f"b must be ({f},) float32, got {tuple(b.shape)} "
                         f"{b.dtype}")
    if tuple(prev.shape) != (m, f) or prev.dtype != x.dtype:
        raise ValueError(f"prev must be ({m}, {f}) {x.dtype}, got "
                         f"{tuple(prev.shape)} {prev.dtype}")
    tensors = (x, w, b, prev)
    if any(t.device != x.device for t in tensors):
        raise ValueError("linear_blend inputs must share one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("linear_blend inputs must be contiguous")
    if x.numel() == 0 or f == 0:
        raise ValueError("linear_blend needs non-empty x and w")


def linear_blend(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: torch.Tensor, *, gamma: float,
                 w_bf16: Optional[torch.Tensor] = None,
                 gemm: Optional[str] = None) -> torch.Tensor:
    """x: (M, D) and prev: (M, F) float32 or bfloat16 (one dtype); w: (D, F)
    and b: (F,) float32; w_bf16: the tensor-core copy of w, made once by
    the caller: w rounded to bfloat16, which the wgmma and gemv routes
    multiply, or w split into bfloat16 terms (``route.check_w_split``),
    which the wgmma_split route multiplies (not read on the CPU or on the
    SIMT route); gemm: the route to launch on CUDA
    (``route.BLEND_ROUTES``), None for the rule's pick (ignored on the
    CPU).
    Returns gamma * (x @ w + b) + (1-gamma) * prev,
    (M, F) in x.dtype, as ``ref.linear_blend``; at gamma = 1 the kernel
    does not read prev."""
    _check(x, w, b, prev)
    gamma = float(gamma)
    if x.device.type == "cpu":
        return ref.linear_blend(x, w, b, prev, gamma)
    if x.device.type != "cuda":
        raise ValueError(f"linear_blend runs on CPU or CUDA, not {x.device}")
    which = gemm or route.gemm_route(x.dtype, x.shape[1], w.shape[1],
                                     _addresses(x, b, prev), w_bf16,
                                     m=x.shape[0])
    return _launch(which, x, w, b, prev, gamma, w_bf16)


def _addresses(x, b, prev):
    return (t.data_ptr() for t in (x, b, prev))


def _launch(which: str, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            prev: torch.Tensor, gamma: float,
            copy: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch the kernel of route ``which`` on CUDA tensors that passed
    ``_check``, with ``copy`` the tensor-core copy of W it multiplies
    (single for wgmma and gemv, split for wgmma_split; not read on SIMT);
    raises if the route does not take them."""
    m, d = x.shape
    f = w.shape[1]
    if which not in route.BLEND_ROUTES:
        raise ValueError(f"unknown route {which!r}")
    if which != route.SIMT:
        if route.gemm_route(x.dtype, d, f, _addresses(x, b, prev)) \
                == route.SIMT:
            raise ValueError(f"the {which} route does not take {x.dtype} "
                             f"({m}, {d}) x ({d}, {f}) at these addresses")
        (route.check_w_split if which == route.WGMMA_SPLIT
         else route.check_w_bf16)(copy, w)
    if which == route.GEMV:
        return _gemv(x, copy, b, prev, gamma, route.gemv_plan(m, d, f))
    if (m + 127) // 128 > MAX_ROW_TILES:
        raise ValueError(f"the linear_blend kernel takes at most "
                         f"{128 * MAX_ROW_TILES} rows, got {m}")
    out = torch.empty((m, f), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        dtype_code = [_DTYPE_CODE[x.dtype]] if which == route.SIMT else []
        terms = [route.SPLIT_TERMS] if which == route.WGMMA_SPLIT else []
        err = _kernel(which)(
            x.data_ptr(), (w if which == route.SIMT else copy).data_ptr(),
            b.data_ptr(), prev.data_ptr(), out.data_ptr(), m, d, f,
            *dtype_code, gamma, 1.0 - gamma, int(gamma != 1.0), *terms,
            stream)
    if err != 0:
        raise RuntimeError(f"linear_blend kernel ({which}) launch failed: "
                           f"CUDA error {err}")
    linear_blend.launches += 1
    linear_blend.launches_by_route[which] += 1
    return out


def _gemv(x: torch.Tensor, copy: torch.Tensor, b: torch.Tensor,
          prev: torch.Tensor, gamma: float,
          plan: route.GemvPlan) -> torch.Tensor:
    """The gemv route's launch on checked inputs with ``plan``'s split of K
    (``route.gemv_plan``'s, or another for a measurement)."""
    m, d = x.shape
    f = copy.shape[1]
    if plan.tiles * plan.groups > route.GEMV_MAX_TICKETS:
        raise ValueError(f"the gemv route takes at most "
                         f"{route.GEMV_MAX_TICKETS} column tiles x row "
                         f"groups, got {plan.tiles} x {plan.groups}")
    out = torch.empty((m, f), dtype=x.dtype, device=x.device)
    ws = torch.empty((plan.workspace,), dtype=F32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel(route.GEMV)(
            x.data_ptr(), copy.data_ptr(), b.data_ptr(), prev.data_ptr(),
            out.data_ptr(), ws.data_ptr(), m, d, f, plan.k_rows, gamma,
            1.0 - gamma, int(gamma != 1.0), stream)
    if err != 0:
        raise RuntimeError(f"linear_blend kernel (gemv) launch failed: CUDA "
                           f"error {err}")
    linear_blend.launches += 1
    linear_blend.launches_by_route[route.GEMV] += 1
    return out


def gemv_tickets(count: int) -> List[int]:
    """The gemv route's first ``count`` tickets on the current device, read
    back (a synchronizing copy, for tests): each call leaves every ticket
    at zero."""
    if not 0 <= count <= route.GEMV_MAX_TICKETS:
        raise ValueError(f"count must be in [0, {route.GEMV_MAX_TICKETS}], "
                         f"got {count}")
    fn = build.load_library("linear_blend").lib.linear_blend_gemv_tickets
    fn.argtypes = [ctypes.POINTER(ctypes.c_uint), _int]
    fn.restype = _int
    out = (ctypes.c_uint * max(count, 1))()
    err = fn(out, count)
    if err != 0:
        raise RuntimeError(f"reading the tickets failed: CUDA error {err}")
    return list(out)[:count]


linear_blend.launches = 0
linear_blend.launches_by_route = dict.fromkeys(route.BLEND_ROUTES, 0)
