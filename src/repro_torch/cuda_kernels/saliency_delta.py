"""Wrapper of the ``saliency_delta`` CUDA kernel (``csrc/saliency_delta.cu``).

Replaces the reference's Pallas kernel ``repro/kernels/saliency_delta.py:
saliency_delta``.  CPU tensors go to the plain version
(``ref.saliency_delta``); CUDA tensors launch the kernel or raise — there is
no fallback.  Each kernel launch adds one to ``saliency_delta.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.cuda_kernels import build, ref

F32 = torch.float32
MAX_BATCH = 65535             # the row kernel's grid.y
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_vp, _int = ctypes.c_void_p, ctypes.c_int


def _kernel():
    fn = build.load_library("saliency_delta").lib.saliency_delta_launch
    if fn.argtypes is None:
        fn.argtypes = [_vp] * 6 + [_int] * 4 + [_vp]
        fn.restype = _int
    return fn


def _check(x: torch.Tensor, x_prev: torch.Tensor) -> None:
    if x.dim() not in (2, 3):
        raise ValueError(f"x must be (N, D) or (B, N, D), got shape "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x_prev.shape != x.shape or x_prev.dtype != x.dtype:
        raise ValueError(f"x_prev must match x {tuple(x.shape)} {x.dtype}, "
                         f"got {tuple(x_prev.shape)} {x_prev.dtype}")
    if x_prev.device != x.device:
        raise ValueError("saliency_delta inputs must share one device")
    if not (x.is_contiguous() and x_prev.is_contiguous()):
        raise ValueError("saliency_delta inputs must be contiguous")
    if x.numel() == 0:
        raise ValueError("saliency_delta needs a non-empty x")


def saliency_delta(x: torch.Tensor, x_prev: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x, x_prev: (N, D) or (B, N, D) float32 or bfloat16.  Returns
    (per-token saliency, ||dX||_F^2, ||X_prev||_F^2) in float32: (N,), (),
    () for a pair, (B, N), (B,), (B,) for a batch, as
    ``ref.saliency_delta``."""
    _check(x, x_prev)
    if x.device.type == "cpu":
        return ref.saliency_delta(x, x_prev)
    if x.device.type != "cuda":
        raise ValueError(f"saliency_delta runs on CPU or CUDA, not "
                         f"{x.device}")
    batched = x.dim() == 3
    xb, pb = (x, x_prev) if batched else (x[None], x_prev[None])
    bsz, n, d = xb.shape
    if bsz > MAX_BATCH:
        raise ValueError(f"the saliency_delta kernel takes at most "
                         f"{MAX_BATCH} samples, got {bsz}")
    dev = x.device
    sal = torch.empty((bsz, n), dtype=F32, device=dev)
    row_prev = torch.empty((bsz, n), dtype=F32, device=dev)
    diff = torch.empty((bsz,), dtype=F32, device=dev)
    prevsq = torch.empty((bsz,), dtype=F32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(xb.data_ptr(), pb.data_ptr(), sal.data_ptr(),
                        row_prev.data_ptr(), diff.data_ptr(),
                        prevsq.data_ptr(), bsz, n, d, _DTYPE_CODE[x.dtype],
                        stream)
    if err != 0:
        raise RuntimeError(f"saliency_delta kernel launch failed: CUDA "
                           f"error {err}")
    saliency_delta.launches += 1
    if batched:
        return sal, diff, prevsq
    return sal[0], diff[0], prevsq[0]


saliency_delta.launches = 0
