"""Wrapper of the ``linear_blend`` CUDA kernels (``csrc/linear_blend.cu``).

Replaces the reference's Pallas kernel ``repro/kernels/linear_blend.py:
linear_blend``.  CPU tensors go to the plain version
(``ref.linear_blend``), which ignores ``w_bf16``; CUDA tensors launch a
kernel or raise — there is no fallback.  The kernel is the one of the route
``route.gemm_route`` picks: ``"wgmma"`` (bf16 X against the caller's bf16
copy of W, ``w_bf16=``, required there) or ``"simt"`` (f32 W), unless the
call names one (``gemm=``: the runners name ``"simt"`` for maps handed in,
which have no bf16 copy).  Each launch
adds one to ``linear_blend.launches`` and to
``linear_blend.launches_by_route[route]``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.cuda_kernels import build, ref, route

F32 = torch.float32
MAX_ROW_TILES = 65535         # either kernel's grid.y, in 128-row tiles
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_vp, _int, _flt = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _kernel(name: str):
    fn = getattr(build.load_library("linear_blend").lib, name)
    if fn.argtypes is None:
        fn.argtypes = {
            "linear_blend_launch":
                [_vp] * 5 + [_int] * 4 + [_flt] * 2 + [_int, _vp],
            "linear_blend_wgmma_launch":
                [_vp] * 5 + [_int] * 3 + [_flt] * 2 + [_int, _vp]}[name]
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
    and b: (F,) float32; w_bf16: w rounded to bfloat16, made once by the
    caller, which the wgmma route multiplies (on the CPU and on the SIMT
    route it is not read); gemm: the route to launch on CUDA
    (``route.ROUTES``), None for the rule's pick (ignored on the CPU).
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
                                     (t.data_ptr() for t in (x, b, prev)))
    return _launch(which, x, w, b, prev, gamma, w_bf16)


def _launch(which: str, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            prev: torch.Tensor, gamma: float,
            w_bf16: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch the kernel of route ``which`` on CUDA tensors that passed
    ``_check``; raises if the route does not take them."""
    m, d = x.shape
    f = w.shape[1]
    if which not in route.ROUTES:
        raise ValueError(f"unknown route {which!r}")
    if which == route.WGMMA:
        if route.gemm_route(x.dtype, d, f, (t.data_ptr() for t in
                                            (x, b, prev))) != route.WGMMA:
            raise ValueError(f"the wgmma route does not take {x.dtype} "
                             f"({m}, {d}) x ({d}, {f}) at these addresses")
        route.check_w_bf16(w_bf16, w)
    if (m + 127) // 128 > MAX_ROW_TILES:
        raise ValueError(f"the linear_blend kernel takes at most "
                         f"{128 * MAX_ROW_TILES} rows, got {m}")
    out = torch.empty((m, f), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if which == route.WGMMA:
            err = _kernel("linear_blend_wgmma_launch")(
                x.data_ptr(), w_bf16.data_ptr(), b.data_ptr(),
                prev.data_ptr(), out.data_ptr(), m, d, f, gamma,
                1.0 - gamma, int(gamma != 1.0), stream)
        else:
            err = _kernel("linear_blend_launch")(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), prev.data_ptr(),
                out.data_ptr(), m, d, f, _DTYPE_CODE[x.dtype], gamma,
                1.0 - gamma, int(gamma != 1.0), stream)
    if err != 0:
        raise RuntimeError(f"linear_blend kernel ({which}) launch failed: "
                           f"CUDA error {err}")
    linear_blend.launches += 1
    linear_blend.launches_by_route[which] += 1
    return out


linear_blend.launches = 0
linear_blend.launches_by_route = dict.fromkeys(route.ROUTES, 0)
