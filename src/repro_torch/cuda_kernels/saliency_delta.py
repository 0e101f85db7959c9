"""Wrapper of the ``saliency_delta`` CUDA kernels (``csrc/saliency_delta.cu``).

Replaces the reference's Pallas kernel ``repro/kernels/saliency_delta.py:
saliency_delta``.  CPU tensors go to the plain version
(``ref.saliency_delta``); CUDA tensors launch a kernel or raise — there is
no fallback.  The kernel is the one of the route ``route.saliency_route``
picks: ``"onepass"`` (one launch: the rows and each sample's totals, the
last block of a sample adding the others' partials) or ``"simt"`` (two
launches).  The two give the same bits.  Each call adds one to
``saliency_delta.launches`` and to ``saliency_delta.launches_by_route[route]``.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import List, Tuple

import torch

from repro_torch.cuda_kernels import build, ref, route

F32 = torch.float32
MAX_BATCH = 65535             # both kernels' grid.y
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_vp, _int = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "saliency_delta_launch": [_vp] * 6 + [_int] * 4 + [_vp],
    "saliency_delta_onepass_launch": [_vp] * 6 + [_int] * 4 + [_vp],
    "saliency_delta_onepass_blocks_per_sm": [_int, ctypes.POINTER(_int)],
    "saliency_delta_tickets": [ctypes.POINTER(ctypes.c_uint), _int]}
_FNS = {}


def _kernel(name: str):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(build.load_library("saliency_delta").lib, name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _int
        _FNS[name] = fn
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
    if x.dim() == 2:
        x, x_prev = x[None], x_prev[None]
        sal, diff, prevsq = _run(_route(x, x_prev), x, x_prev)
        return sal[0], diff[0], prevsq[0]
    return _run(_route(x, x_prev), x, x_prev)


def _addresses(x: torch.Tensor, x_prev: torch.Tensor):
    return x.data_ptr(), x_prev.data_ptr()


def _route(x: torch.Tensor, x_prev: torch.Tensor) -> str:
    _, n, d = x.shape
    return route.saliency_route(x.dtype, n, d, _addresses(x, x_prev))


def _launch(which: str, x: torch.Tensor, x_prev: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch route ``which`` on CUDA (B, N, D) tensors that passed
    ``_check``, whichever route ``saliency_route`` would pick; raises if
    the route's kernel does not take them."""
    if which not in route.SAL_ROUTES:
        raise ValueError(f"unknown route {which!r}")
    _, n, d = x.shape
    if which == route.ONEPASS and not route.onepass_takes(
            x.dtype, n, d, _addresses(x, x_prev)):
        raise ValueError(f"the onepass route does not take {x.dtype} "
                         f"{tuple(x.shape)} at these addresses")
    return _run(which, x, x_prev)


def _run(which: str, x: torch.Tensor, x_prev: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    bsz, n, d = x.shape
    if bsz > MAX_BATCH:
        raise ValueError(f"the saliency_delta kernels take at most "
                         f"{MAX_BATCH} samples, got {bsz}")
    onepass = which == route.ONEPASS
    dev = x.device
    # one allocation: sal (B, N), diff (B,), prevsq (B,), then the scratch
    # at an 8-byte aligned offset: the onepass route's (B, 32) float2 block
    # partials or the SIMT route's (B, N) per-row sums of prev^2
    rows = bsz * n
    start = rows + 2 * bsz + (rows % 2)
    buf = torch.empty(start + (2 * route.SAL_GROUPS * bsz if onepass
                               else rows), dtype=F32, device=dev)
    sal = buf[:rows].view(bsz, n)
    diff = buf[rows:rows + bsz]
    prevsq = buf[rows + bsz:rows + 2 * bsz]
    out = [sal.data_ptr(), diff.data_ptr(), prevsq.data_ptr()]
    scratch = buf[start:].data_ptr()
    with _on(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if onepass:
            err = _kernel("saliency_delta_onepass_launch")(
                x.data_ptr(), x_prev.data_ptr(), *out, scratch, bsz, n, d,
                _DTYPE_CODE[x.dtype], stream)
        else:
            err = _kernel("saliency_delta_launch")(
                x.data_ptr(), x_prev.data_ptr(), out[0], scratch, *out[1:],
                bsz, n, d, _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"saliency_delta kernel ({which}) launch failed: "
                           f"CUDA error {err}")
    saliency_delta.launches += 1
    saliency_delta.launches_by_route[which] += 1
    return sal, diff, prevsq


def _on(dev: torch.device):
    """``torch.cuda.device(dev)``, or nothing when ``dev`` is already the
    current device (the usual case: entering it costs host time)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def onepass_blocks_per_sm(dtype: torch.dtype) -> int:
    """How many onepass blocks one SM of the current card holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``): a call of B
    samples runs in one wave when SAL_GROUPS * B fits on the card's SMs."""
    out = _int(0)
    err = _kernel("saliency_delta_onepass_blocks_per_sm")(
        _DTYPE_CODE[dtype], ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveBlocksPerMultiprocessor "
                           f"failed: CUDA error {err}")
    return out.value


def tickets(count: int) -> List[int]:
    """The onepass route's first ``count`` per-sample tickets on the
    current device, read back (a synchronizing copy, for tests): each call
    leaves every ticket at zero."""
    if not 0 <= count <= MAX_BATCH:
        raise ValueError(f"count must be in [0, {MAX_BATCH}], got {count}")
    out = (ctypes.c_uint * max(count, 1))()
    err = _kernel("saliency_delta_tickets")(out, count)
    if err != 0:
        raise RuntimeError(f"reading the tickets failed: CUDA error {err}")
    return list(out)[:count]


saliency_delta.launches = 0
saliency_delta.launches_by_route = dict.fromkeys(route.SAL_ROUTES, 0)
