"""Wrapper of the ``knn_density`` CUDA kernel (``csrc/knn_density.cu``).

Replaces the reference's Pallas kernel ``repro/kernels/knn_density.py:
knn_density``.  CPU tensors go to the plain version (``ref.knn_density``);
CUDA tensors launch the kernel or raise — there is no fallback.  Each
kernel launch adds one to ``knn_density.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.cuda_kernels import build, ref

F32 = torch.float32
MAX_WINDOW = 32               # the kernel's window_gram.cuh kMaxW
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_vp, _int = ctypes.c_void_p, ctypes.c_int


def _kernel():
    fn = build.load_library("knn_density").lib.knn_density_launch
    if fn.argtypes is None:
        fn.argtypes = [_vp, _vp, _int, _int, _int, _int, _int, _vp]
        fn.restype = _int
    return fn


def _check(h: torch.Tensor, k: int) -> None:
    if h.dim() != 3:
        raise ValueError(f"h must be (W, w, D), got shape {tuple(h.shape)}")
    ref.check_knn_k(k, h.shape[1])
    if h.dtype not in _DTYPE_CODE:
        raise TypeError(f"h must be float32 or bfloat16, got {h.dtype}")
    if not h.is_contiguous():
        raise ValueError("knn_density needs a contiguous h")
    if h.numel() == 0:
        raise ValueError("knn_density needs a non-empty h")


def knn_density(h: torch.Tensor, *, k: int = 5) -> torch.Tensor:
    """h: (W, w, D) float32 or bfloat16 windows -> rho_sp (W, w) float32,
    as ``ref.knn_density``."""
    _check(h, k)
    if h.device.type == "cpu":
        return ref.knn_density(h, k)
    if h.device.type != "cuda":
        raise ValueError(f"knn_density runs on CPU or CUDA, not {h.device}")
    nw, w, d = h.shape
    if w > MAX_WINDOW:
        raise ValueError(f"the knn_density kernel takes windows of at most "
                         f"{MAX_WINDOW} tokens, got w={w}")
    out = torch.empty((nw, w), dtype=F32, device=h.device)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = _kernel()(h.data_ptr(), out.data_ptr(), nw, w, d, int(k),
                        _DTYPE_CODE[h.dtype], stream)
    if err != 0:
        raise RuntimeError(f"knn_density kernel launch failed: CUDA error "
                           f"{err}")
    knn_density.launches += 1
    return out


knn_density.launches = 0
