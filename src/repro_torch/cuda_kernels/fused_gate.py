"""Wrapper of the ``fused_gate`` CUDA kernel (``csrc/fused_gate.cu``).

Replaces the reference's Pallas kernel ``repro/kernels/fused_gate.py:
fused_gate``.  CPU tensors go to the plain version (``ref.fused_gate``);
CUDA tensors launch the kernel or raise — there is no fallback.  Each
kernel launch adds one to ``fused_gate.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.cuda_kernels import build, ref

F32 = torch.float32
REDUCTION_PARTS = 16          # partial sums per sample in the first launch
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_vp, _int, _flt = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _kernel():
    built = build.load_library("fused_gate")
    fn = built.lib.fused_gate_launch
    if fn.argtypes is None:
        fn.argtypes = ([_vp] * 12 + [_int] * 5 + [_flt] * 4 + [_int, _vp])
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
               threshold: float, gamma: float = 0.5, use_blend: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """x, prev_in, prev_out: (B, C, D) float32 or bfloat16; w: (D, D) and
    b: (D,) float32; sigma2: (B,) float32; eligible: (B,) bool.  Returns
    (out (B,C,D) in x.dtype, gate (B,) bool, diff_sq (B,) f32,
    prev_sq (B,) f32), as ``ref.fused_gate``."""
    _check(x, prev_in, prev_out, w, b, sigma2, eligible)
    if x.device.type == "cpu":
        return ref.fused_gate(x, prev_in, prev_out, w, b, sigma2, eligible,
                              threshold=threshold, gamma=gamma,
                              use_blend=use_blend)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gate runs on CPU or CUDA, not {x.device}")
    bsz, c, d = x.shape
    dev = x.device
    out = torch.empty_like(x)
    gate = torch.empty((bsz,), dtype=torch.bool, device=dev)
    diff = torch.empty((bsz,), dtype=F32, device=dev)
    prevsq = torch.empty((bsz,), dtype=F32, device=dev)
    partials = torch.empty((bsz, REDUCTION_PARTS, 2), dtype=F32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(
            x.data_ptr(), prev_in.data_ptr(), prev_out.data_ptr(),
            w.data_ptr(), b.data_ptr(), sigma2.data_ptr(),
            eligible.data_ptr(), out.data_ptr(), gate.data_ptr(),
            diff.data_ptr(), prevsq.data_ptr(), partials.data_ptr(),
            REDUCTION_PARTS, bsz, c, d, _DTYPE_CODE[x.dtype],
            float(threshold), float(c * d), float(gamma), float(1.0 - gamma),
            int(bool(use_blend)), stream)
    if err != 0:
        raise RuntimeError(f"fused_gate kernel launch failed: CUDA error {err}")
    fused_gate.launches += 1
    return out, gate, diff, prevsq


fused_gate.launches = 0
