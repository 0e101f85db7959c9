"""Wrapper of the ``knn_density`` CUDA kernels (``csrc/knn_density.cu``).

Replaces the reference's Pallas kernel ``repro/kernels/knn_density.py:
knn_density``.  CPU tensors go to the plain version (``ref.knn_density``);
CUDA tensors launch a kernel or raise — there is no fallback.  The kernel
is the one of the route ``route.window_route`` picks: ``"mma"`` (bf16
windows, the Gram on the tensor cores) or ``"simt"`` (the rest).  Each
launch adds one to ``knn_density.launches`` and to
``knn_density.launches_by_route[route]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.cuda_kernels import build, ref, route

F32 = torch.float32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_vp, _int = ctypes.c_void_p, ctypes.c_int


def _kernel(name: str):
    fn = getattr(build.load_library("knn_density").lib, name)
    if fn.argtypes is None:
        fn.argtypes = {
            "knn_density_launch": [_vp, _vp] + [_int] * 5 + [_vp],
            "knn_density_mma_launch": [_vp, _vp] + [_int] * 4 + [_vp]}[name]
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
    _, w, d = h.shape
    return _launch(route.window_route(h.dtype, w, d, [h.data_ptr()]), h, k)


def _launch(which: str, h: torch.Tensor, k: int) -> torch.Tensor:
    """Launch the kernel of route ``which`` on a CUDA ``h`` that passed
    ``_check``; raises if the route does not take it."""
    nw, w, d = h.shape
    if which not in route.WINDOW_ROUTES:
        raise ValueError(f"unknown route {which!r}")
    if w > route.MAX_WINDOW:
        raise ValueError(f"the knn_density kernel takes windows of at most "
                         f"{route.MAX_WINDOW} tokens, got w={w}")
    if (which == route.MMA and route.window_route(
            h.dtype, w, d, [h.data_ptr()]) != route.MMA):
        raise ValueError(f"the mma route does not take {h.dtype} windows "
                         f"of ({w}, {d}) at this address")
    out = torch.empty((nw, w), dtype=F32, device=h.device)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        if which == route.MMA:
            err = _kernel("knn_density_mma_launch")(
                h.data_ptr(), out.data_ptr(), nw, w, d, int(k), stream)
        else:
            err = _kernel("knn_density_launch")(
                h.data_ptr(), out.data_ptr(), nw, w, d, int(k),
                _DTYPE_CODE[h.dtype], stream)
    if err != 0:
        raise RuntimeError(f"knn_density kernel ({which}) launch failed: "
                           f"CUDA error {err}")
    knn_density.launches += 1
    knn_density.launches_by_route[which] += 1
    return out


knn_density.launches = 0
knn_density.launches_by_route = dict.fromkeys(route.WINDOW_ROUTES, 0)
