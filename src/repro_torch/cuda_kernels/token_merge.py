"""Wrappers of the ``merge_assign`` and ``unmerge_scatter`` CUDA kernels
(``csrc/token_merge.cu``).

Replace the reference's Pallas kernels ``repro/kernels/token_merge.py:
merge_assign`` and ``:unmerge_scatter``.  CPU tensors go to the plain
versions (``ref.merge_assign`` / ``ref.unmerge_scatter``); CUDA tensors
launch a kernel or raise — there is no fallback.  ``merge_assign`` launches
the kernel of the route ``route.window_route`` picks: ``"mma"`` (bf16
windows, the Gram on the tensor cores) or ``"simt"`` (the rest).  Each
kernel launch adds one to the wrapper's ``launches``, and for
``merge_assign`` to ``merge_assign.launches_by_route[route]``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.cuda_kernels import build, ref, route

F32 = torch.float32
I32 = torch.int32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_vp, _int = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = build.load_library("token_merge").lib
    if lib.merge_assign_launch.argtypes is None:
        lib.merge_assign_launch.argtypes = [_vp] * 5 + [_int] * 5 + [_vp]
        lib.merge_assign_launch.restype = _int
        lib.merge_assign_mma_launch.argtypes = [_vp] * 5 + [_int] * 4 + [_vp]
        lib.merge_assign_mma_launch.restype = _int
        lib.unmerge_scatter_launch.argtypes = [_vp] * 3 + [_int] * 5 + [_vp]
        lib.unmerge_scatter_launch.restype = _int
    return lib


def _check_common(name: str, t: torch.Tensor, ids: torch.Tensor,
                  ids_name: str) -> None:
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if ids.device != t.device:
        raise ValueError(f"{name} and {ids_name} must share one device")
    if not (t.is_contiguous() and ids.is_contiguous()):
        raise ValueError(f"{name} and {ids_name} must be contiguous")
    if t.numel() == 0:
        raise ValueError(f"{name} must be non-empty")


def merge_assign(h: torch.Tensor, s: torch.Tensor, *, m: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """h: (W, w, D) float32 or bfloat16 windows, s: (W, w) float32 scores
    -> (merged (W, M, D) in h.dtype, assign (W, w) int32, centers (W, M)
    int32) with M = ``m``, as ``ref.merge_assign``."""
    if h.dim() != 3:
        raise ValueError(f"h must be (W, w, D), got shape {tuple(h.shape)}")
    nw, w, d = h.shape
    ref.check_merge_m(m, w)
    if tuple(s.shape) != (nw, w) or s.dtype != F32:
        raise ValueError(f"s must be ({nw}, {w}) float32, got "
                         f"{tuple(s.shape)} {s.dtype}")
    _check_common("h", h, s, "s")
    if h.device.type == "cpu":
        return ref.merge_assign(h, s, m)
    if h.device.type != "cuda":
        raise ValueError(f"merge_assign runs on CPU or CUDA, not {h.device}")
    return _launch(route.window_route(h.dtype, w, d, [h.data_ptr()]), h, s,
                   m)


def _launch(which: str, h: torch.Tensor, s: torch.Tensor, m: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel of route ``which`` on CUDA inputs that passed
    ``merge_assign``'s checks; raises if the route does not take them.  The
    outputs are fresh allocations, so 16-byte aligned."""
    nw, w, d = h.shape
    dev = h.device
    if which not in route.WINDOW_ROUTES:
        raise ValueError(f"unknown route {which!r}")
    if w > route.MAX_WINDOW:
        raise ValueError(f"the merge_assign kernel takes windows of at most "
                         f"{route.MAX_WINDOW} tokens, got w={w}")
    if (which == route.MMA and route.window_route(
            h.dtype, w, d, [h.data_ptr()]) != route.MMA):
        raise ValueError(f"the mma route does not take {h.dtype} windows "
                         f"of ({w}, {d}) at this address")
    merged = torch.empty((nw, m, d), dtype=h.dtype, device=dev)
    assign = torch.empty((nw, w), dtype=I32, device=dev)
    centers = torch.empty((nw, m), dtype=I32, device=dev)
    args = (h.data_ptr(), s.data_ptr(), merged.data_ptr(), assign.data_ptr(),
            centers.data_ptr(), nw, w, int(m), d)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if which == route.MMA:
            err = _lib().merge_assign_mma_launch(*args, stream)
        else:
            err = _lib().merge_assign_launch(*args, _DTYPE_CODE[h.dtype],
                                             stream)
    if err != 0:
        raise RuntimeError(f"merge_assign kernel ({which}) launch failed: "
                           f"CUDA error {err}")
    merge_assign.launches += 1
    merge_assign.launches_by_route[which] += 1
    return merged, assign, centers


def unmerge_scatter(merged: torch.Tensor, assign: torch.Tensor
                    ) -> torch.Tensor:
    """merged: (W, M, D) float32 or bfloat16, assign: (W, w) int32 ids in
    [0, M) -> (W, w, D) in merged.dtype, as ``ref.unmerge_scatter``.  An id
    outside [0, M) gives a zero row on the card, as the TPU kernel's one-hot
    product does (the plain version's gather raises on it)."""
    if merged.dim() != 3:
        raise ValueError(f"merged must be (W, M, D), got shape "
                         f"{tuple(merged.shape)}")
    nw, m, d = merged.shape
    if (assign.dim() != 2 or assign.shape[0] != nw or assign.shape[1] < 1
            or assign.dtype != I32):
        raise ValueError(f"assign must be ({nw}, w) int32, got "
                         f"{tuple(assign.shape)} {assign.dtype}")
    _check_common("merged", merged, assign, "assign")
    if merged.device.type == "cpu":
        return ref.unmerge_scatter(merged, assign)
    if merged.device.type != "cuda":
        raise ValueError(f"unmerge_scatter runs on CPU or CUDA, not "
                         f"{merged.device}")
    w = assign.shape[1]
    out = torch.empty((nw, w, d), dtype=merged.dtype, device=merged.device)
    with torch.cuda.device(merged.device):
        stream = torch.cuda.current_stream(merged.device).cuda_stream
        err = _lib().unmerge_scatter_launch(
            merged.data_ptr(), assign.data_ptr(), out.data_ptr(), nw, w, m,
            d, merged.element_size(), stream)
    if err != 0:
        raise RuntimeError(f"unmerge_scatter kernel launch failed: CUDA "
                           f"error {err}")
    unmerge_scatter.launches += 1
    return out


merge_assign.launches = 0
merge_assign.launches_by_route = dict.fromkeys(route.WINDOW_ROUTES, 0)
unmerge_scatter.launches = 0
