"""Wrapper of the ``flash_attention`` CUDA kernel
(``csrc/flash_attention.cu``).

Replaces the reference's Pallas kernel ``repro/kernels/flash_attention.py:
flash_attention``.  CPU tensors go to the plain version
(``ref.flash_attention``); CUDA tensors launch the kernel or raise — there
is no fallback.  Each kernel launch adds one to
``flash_attention.launches`` and to its mode's count in
``flash_attention.launches_by_mode`` ("implicit" or "positions").

The kernel reads any strides with a unit stride along dh, so a caller
holding (B, S, H, dh) activations passes ``x.transpose(1, 2)`` views and
gets the output back in the same layout, with no copy.

Two instances behind one launch.  bf16 (the serving path) runs a Hopper
kernel: TMA copies of 64 x 64 tiles into rings of K/V stages, S = QK^T and
O += PV on wgmma with f32 accumulation, P rounded to bf16 in registers as
the register operand of the second product, two warpgroups per 64-query
tile splitting its key tiles and merging in a fixed order.  Rounding P to
bf16 departs from the TPU kernel, which keeps p in f32; the reference's
model attention does the same (``src/repro/models/attention.py:69`` and
``:114``, ``p.astype(v.dtype)``), within the 2e-2 that bf16 is held to.
float32 keeps the SIMT kernel (f32 FMAs, p in f32): TF32 or bf16 tensor
cores would miss the reference's 2e-5, and nothing on the serving path runs
f32.  At the serve's prefill (B=1, H=16, KVH=8, S=512, dh=128, causal) the
bound is 1.88 us, set by the 6.29 MB that q, k, v and o move.  The bf16
tensor maps take no zero stride, so a broadcast (expanded) bf16 input is
refused; materialize it first.

Head dims: every multiple of 16 up to 128 (``HEAD_DIMS``) on two template
instances, 64 and 128 (``instance_dh``).  A head dim below its instance's
(StableLM-3B's 80, Kimi-K2's 112) reads its missing columns as zeros:
the bf16 tensor maps take the true dh as their innermost extent, so TMA
zero-fills the rest of each 64-column box, the f32 loads are masked, and
only the true columns are stored.  Zeros add nothing to QK^T, so the
result is the true-dh attention, at the scale dh^-1/2 of the true dh; the
zero columns' products are wasted work (80 / 128 of the products do work at
dh 80).

Position mode: ``q_pos`` (B or 1, Sq) and ``kv_pos`` (B or 1, Skv)
integer positions (both or neither) mask by the reference's rule
(``ref.flash_attention``; the full-sequence attention of an M-RoPE image
prompt, whose tokens share t positions) on a second instance of each
route's kernel, which finds its live key tiles from the positions on the
card.  Positions go to the kernel as int32 views with their strides (a
row of batch 1 is read for every sample); an int64 tensor is converted
first, one small copy.  Without positions the launch is the implicit
mode's, unchanged.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.cuda_kernels import build, ref

HEAD_DIMS = tuple(range(16, 129, 16))   # the head dims the kernel takes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_vp, _int, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _kernel():
    fn = build.load_library("flash_attention").lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([_vp] * 4 + [_int] * 6 + [_i64] * 12
                       + [_int, _int, ctypes.c_float, _int, _vp, _vp]
                       + [_i64] * 4 + [_vp])
        fn.restype = _int
    return fn


def instance_dh(dh: int) -> int:
    """The template instance (its DH) that runs head dim ``dh``."""
    if dh not in HEAD_DIMS:
        raise ValueError(f"the flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {dh}")
    return 64 if dh <= 64 else 128


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           positions: bool = False) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-d, got shape {tuple(t.shape)}")
        if t.numel() == 0:
            raise ValueError(f"{name} must be non-empty")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must share one device")
    b, h, sq, dh = q.shape
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    kb, kvh, skv, kdh = k.shape
    if kb != b or kdh != dh:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in batch or head_dim")
    if h % kvh:
        raise ValueError(f"{h} query heads are not a multiple of {kvh} KV "
                         "heads")
    if sq > skv and not positions:
        raise ValueError(f"Sq={sq} > Skv={skv}: query positions are aligned "
                         "to the end of the KV sequence")


def _check_positions(q: torch.Tensor, k: torch.Tensor, q_pos, kv_pos):
    """(q_pos, kv_pos) as (B or 1, S) int32 tensors on q's device."""
    if (q_pos is None) != (kv_pos is None):
        raise ValueError("q_pos and kv_pos go together: pass both or "
                         "neither")
    out = []
    for name, t, n in (("q_pos", q_pos, q.shape[2]),
                       ("kv_pos", kv_pos, k.shape[2])):
        if t.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"{name} must be int32 or int64, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")
        if t.dim() == 1:
            t = t[None]
        if t.dim() != 2 or t.shape[1] != n or t.shape[0] not in (
                1, q.shape[0]):
            raise ValueError(f"{name} must be (B or 1, {n}), got shape "
                             f"{tuple(t.shape)}")
        out.append(t.to(torch.int32))
    return out


def _check_layout(t: torch.Tensor, name: str) -> None:
    """The kernel loads 16-byte vectors along dh (f32) or 64 x 64 tiles
    through tensor maps (bf16), which take no zero stride."""
    if t.stride(-1) != 1:
        raise ValueError(f"{name} needs a unit stride along head_dim, got "
                         f"strides {t.stride()}")
    unit = 16 // t.element_size()
    if t.data_ptr() % 16 or any(s % unit for s in t.stride()[:3]):
        raise ValueError(f"{name} needs 16-byte aligned rows, got data_ptr "
                         f"{t.data_ptr()} and strides {t.stride()}")
    if t.dtype == torch.bfloat16 and any(
            s == 0 and n > 1 for s, n in zip(t.stride()[:3], t.shape[:3])):
        raise ValueError(f"{name} is broadcast (a zero stride, strides "
                         f"{t.stride()}); the bf16 kernel's tensor maps need "
                         "a materialized tensor")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int = 0,
                    q_pos: Optional[torch.Tensor] = None,
                    kv_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, H, Sq, dh); k, v: (B, KVH, Skv, dh), float32 or bfloat16, one
    dtype -> (B, H, Sq, dh) in q.dtype (on the card: in q's memory layout),
    as ``ref.flash_attention``.  Without positions, query positions are
    aligned to the end of the KV sequence; ``window > 0`` keeps keys with
    kpos > qpos - window.  ``q_pos`` / ``kv_pos`` (B or 1, S) integer
    positions select position mode (the module docstring)."""
    explicit = q_pos is not None or kv_pos is not None
    _check(q, k, v, positions=explicit)
    if explicit:
        q_pos, kv_pos = _check_positions(q, k, q_pos, kv_pos)
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   q_pos=q_pos, kv_pos=kv_pos)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CPU or CUDA, not "
                         f"{q.device}")
    b, h, sq, dh = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    instance_dh(dh)
    out = torch.empty_like(q)            # q's strides when q is dense
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        _check_layout(t, name)
    pos_args = [None, None, 0, 0, 0, 0]
    if explicit:
        pos_args = [q_pos.data_ptr(), kv_pos.data_ptr(),
                    q_pos.stride(0) if q_pos.shape[0] > 1 else 0,
                    q_pos.stride(1),
                    kv_pos.stride(0) if kv_pos.shape[0] > 1 else 0,
                    kv_pos.stride(1)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, kvh, sq, skv, dh, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *out.stride()[:3], int(bool(causal)),
            int(window), dh ** -0.5, _DTYPE_CODE[q.dtype], *pos_args,
            stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    flash_attention.launches_by_mode["positions" if explicit
                                     else "implicit"] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_mode = {"implicit": 0, "positions": 0}
