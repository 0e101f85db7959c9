"""Wrapper of the ``fused_gate`` CUDA kernels (``csrc/fused_gate.cu``).

Replaces the reference's Pallas kernel ``repro/kernels/fused_gate.py:
fused_gate``.  CPU tensors go to the plain version (``ref.fused_gate``),
which ignores the copies of W; CUDA tensors launch a kernel or raise —
there is no fallback.  The GEMM is the one of the route ``route.gemm_route``
picks: ``"wgmma"`` (bf16 X against the caller's bf16 copy of W,
``w_bf16=``, required there), ``"wgmma_split"`` (the same kernel, where
that copy is a split one, W as bf16 terms) or ``"simt"`` (f32 W), unless
the call names one (``gemm=``).  Each call (the partial sums and the GEMM, two kernels on the
stream) adds one to ``fused_gate.launches`` and to
``fused_gate.launches_by_route[route]``.  In a captured step graph the
caller may hand the GEMM the handle of the IF node that skips the block
(``cond=``, from ``step_graph.producer_condition``): the GEMM sets it to
!all(gate) from the bits it returns, on every route.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.cuda_kernels import build, ref, route

F32 = torch.float32
REDUCTION_PARTS = 16          # partial sums per sample in the first launch
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_vp, _int, _flt = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ull = ctypes.c_ulonglong


# the launcher of each route
_LAUNCHERS = {route.WGMMA: "fused_gate_wgmma_launch",
              route.WGMMA_SPLIT: "fused_gate_wgmma_split_launch",
              route.SIMT: "fused_gate_launch"}


def _kernel(which: str):
    """The launcher of route ``which``: the SIMT one takes a dtype code
    after D, the split one the number of W's terms after use_blend; each
    then the IF node's condition handle and whether to set it."""
    fn = getattr(build.load_library("fused_gate").lib, _LAUNCHERS[which])
    if fn.argtypes is None:
        n_int = 5 if which == route.SIMT else 4
        tail = [_int] * (2 if which == route.WGMMA_SPLIT else 1)
        fn.argtypes = ([_vp] * 12 + [_int] * n_int + [_flt] * 4 + tail
                       + [_ull, _int, _vp])
        fn.restype = _int
    return fn


def _check(x, prev_in, prev_out, w, b, sigma2, eligible) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be (B, C, D), got shape {tuple(x.shape)}")
    bsz, _, d = x.shape
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("prev_in", prev_in), ("prev_out", prev_out)):
        if t.shape != x.shape or t.dtype != x.dtype:
            raise ValueError(f"{name} must match x {tuple(x.shape)} "
                             f"{x.dtype}, got {tuple(t.shape)} {t.dtype}")
    if tuple(w.shape) != (d, d) or w.dtype != F32:
        raise ValueError(f"w must be ({d}, {d}) float32, got "
                         f"{tuple(w.shape)} {w.dtype}")
    if tuple(b.shape) != (d,) or b.dtype != F32:
        raise ValueError(f"b must be ({d},) float32, got {tuple(b.shape)} "
                         f"{b.dtype}")
    if tuple(sigma2.shape) != (bsz,) or sigma2.dtype != F32:
        raise ValueError(f"sigma2 must be ({bsz},) float32, got "
                         f"{tuple(sigma2.shape)} {sigma2.dtype}")
    if tuple(eligible.shape) != (bsz,) or eligible.dtype != torch.bool:
        raise ValueError(f"eligible must be ({bsz},) bool, got "
                         f"{tuple(eligible.shape)} {eligible.dtype}")
    tensors = (x, prev_in, prev_out, w, b, sigma2, eligible)
    if any(t.device != x.device for t in tensors):
        raise ValueError("fused_gate inputs must share one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_gate inputs must be contiguous")
    if x.numel() == 0:
        raise ValueError("fused_gate needs a non-empty x")


def fused_gate(x: torch.Tensor, prev_in: torch.Tensor,
               prev_out: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               sigma2: torch.Tensor, eligible: torch.Tensor, *,
               threshold: float, gamma: float = 0.5, use_blend: bool = True,
               w_bf16: Optional[torch.Tensor] = None,
               gemm: Optional[str] = None, cond: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """x, prev_in, prev_out: (B, C, D) float32 or bfloat16; w: (D, D) and
    b: (D,) float32; sigma2: (B,) float32; eligible: (B,) bool; w_bf16: the
    tensor-core copy of w, made once by the caller: w rounded to bfloat16,
    which the wgmma route multiplies, or w split into bfloat16 terms
    (``route.check_w_split``), which the wgmma_split route multiplies (not
    read on the CPU or on the SIMT route); gemm: the route to launch on
    CUDA (``route.ROUTES``), None for the rule's pick (ignored on the
    CPU); cond: the handle of an IF node's condition in the graph being
    captured, which the GEMM sets to !all(gate) (ignored on the CPU).
    Returns
    (out (B,C,D) in x.dtype, gate (B,) bool, diff_sq (B,) f32,
    prev_sq (B,) f32), as ``ref.fused_gate``."""
    _check(x, prev_in, prev_out, w, b, sigma2, eligible)
    if x.device.type == "cpu":
        return ref.fused_gate(x, prev_in, prev_out, w, b, sigma2, eligible,
                              threshold=threshold, gamma=gamma,
                              use_blend=use_blend)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gate runs on CPU or CUDA, not {x.device}")
    d = x.shape[2]
    which = gemm or route.gemm_route(x.dtype, d, d, _aligned(x, prev_out, b),
                                     w_bf16)
    return _launch(which, x, prev_in, prev_out, w, b, sigma2, eligible,
                   float(threshold), float(gamma), bool(use_blend), w_bf16,
                   cond)


def _aligned(x, prev_out, b):
    """The addresses the wgmma route needs 16-byte aligned (prev_in is read
    element by element)."""
    return (t.data_ptr() for t in (x, prev_out, b))


def _launch(which: str, x, prev_in, prev_out, w, b, sigma2, eligible,
            threshold: float, gamma: float, use_blend: bool,
            copy: Optional[torch.Tensor], cond: Optional[int] = None):
    """Launch route ``which`` on CUDA tensors that passed ``_check``, with
    ``copy`` the tensor-core copy of W it multiplies (single for wgmma,
    split for wgmma_split; not read on SIMT) and ``cond`` the IF node's
    condition handle to set, if any; raises if the route does not take
    them."""
    bsz, c, d = x.shape
    if which not in route.ROUTES:
        raise ValueError(f"unknown route {which!r}")
    if which != route.SIMT:
        if route.gemm_route(x.dtype, d, d, _aligned(x, prev_out, b)) \
                == route.SIMT:
            raise ValueError(f"the {which} route does not take {x.dtype} "
                             f"{tuple(x.shape)} at these addresses")
        (route.check_w_split if which == route.WGMMA_SPLIT
         else route.check_w_bf16)(copy, w)
    dev = x.device
    out = torch.empty_like(x)
    gate = torch.empty((bsz,), dtype=torch.bool, device=dev)
    diff = torch.empty((bsz,), dtype=F32, device=dev)
    prevsq = torch.empty((bsz,), dtype=F32, device=dev)
    partials = torch.empty((bsz, REDUCTION_PARTS, 2), dtype=F32, device=dev)
    ptrs = [x.data_ptr(), prev_in.data_ptr(), prev_out.data_ptr(),
            (w if which == route.SIMT else copy).data_ptr(),
            b.data_ptr(), sigma2.data_ptr(), eligible.data_ptr(),
            out.data_ptr(), gate.data_ptr(), diff.data_ptr(),
            prevsq.data_ptr(), partials.data_ptr()]
    dtype_code = [_DTYPE_CODE[x.dtype]] if which == route.SIMT else []
    terms = [route.SPLIT_TERMS] if which == route.WGMMA_SPLIT else []
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel(which)(
            *ptrs, REDUCTION_PARTS, bsz, c, d, *dtype_code, threshold,
            float(c * d), gamma, 1.0 - gamma, int(use_blend), *terms,
            cond or 0, int(cond is not None), stream)
    if err != 0:
        raise RuntimeError(f"fused_gate kernel ({which}) launch failed: "
                           f"CUDA error {err}")
    fused_gate.launches += 1
    fused_gate.launches_by_route[which] += 1
    return out, gate, diff, prevsq


fused_gate.launches = 0
fused_gate.launches_by_route = dict.fromkeys(route.ROUTES, 0)
