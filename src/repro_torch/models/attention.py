"""Attention (the reference's ``models/attention.py``): GQA, causal /
bidirectional / sliding-window, and decode over a ring KV cache.

* ``attention`` — every full-sequence attention (encode, prefill; Sq ==
  Skv) goes to the hand-written ``flash_attention`` kernel, which replaces
  the reference's ``attend_direct`` / ``attend_chunked`` XLA paths on the
  card; CPU tensors take its plain twin.  Positions are implicit
  (``arange(S)``) or the caller's (M-RoPE's t axis), masked by the
  reference's rule in the kernel's position mode.
* ``prefix_grouped_causal`` — the reference's causal attention as
  ``groups`` prefix attends, one kernel call a group.
* ``attend_direct`` — the reference's masked direct attention, used for
  decode (``decode_attend``) over the ring cache.
* ``attend_bidirectional`` — the DiT's unmasked attention (at 256 tokens
  the reference always takes the direct path).

The direct products run on operands upcast to f32.  A product of two bf16
values is exact in f32, so this is the reference's "inputs in the model
dtype, accumulate in f32" (``preferred_element_type=f32``) with the scores
kept in f32, as the reference keeps them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.cuda_kernels.flash_attention import flash_attention

F32 = torch.float32
NEG_INF = -1e30


def attend_bidirectional(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """q, k, v: (B, S, H, dh), no mask -> (B, S, H, dh) in q.dtype."""
    scale = q.shape[-1] ** -0.5
    qh = q.permute(0, 2, 1, 3).to(F32)                   # (B, H, Sq, dh)
    kh = k.permute(0, 2, 3, 1).to(F32)                   # (B, H, dh, Skv)
    s = torch.matmul(qh, kh) * scale
    p = torch.softmax(s, dim=-1)
    vh = v.permute(0, 2, 1, 3)
    out = torch.matmul(p.to(v.dtype).to(F32), vh.to(F32)).to(q.dtype)
    return out.permute(0, 2, 1, 3)


def _mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
          window: int, kv_valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Bool mask (..., Sq, Skv) from position arrays (..., Sq) / (..., Skv)."""
    qp = q_pos[..., :, None]
    kp = kv_pos[..., None, :]
    m = kp >= 0                         # invalid cache slots are marked pos=-1
    m = m.expand(torch.broadcast_shapes(qp.shape, kp.shape))
    if causal:
        m = m & (kp <= qp)
    if window > 0:
        m = m & (kp > qp - window)
    if kv_valid is not None:
        m = m & (kp < kv_valid[..., None, None])
    return m


def attend_direct(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, kv_pos: torch.Tensor, *, causal: bool,
                  window: int = 0,
                  kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B,Sq,H,dh); k/v: (B,Skv,KVH,dh); positions (B,S*) or (S*,)."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    scale = dh ** -0.5
    qg = q.reshape(b, sq, kvh, h // kvh, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.to(F32), k.to(F32)) * scale
    if q_pos.ndim == 1:
        q_pos = q_pos[None]
    if kv_pos.ndim == 1:
        kv_pos = kv_pos[None]
    m = _mask(q_pos, kv_pos, causal, window, kv_valid)       # (B,Sq,Skv)
    s = s.masked_fill(~m[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).to(F32),
                       v.to(F32)).to(q.dtype)
    return out.reshape(q.shape)


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_pos: Optional[torch.Tensor], kv_pos: Optional[torch.Tensor], *,
           causal: bool, window: int) -> torch.Tensor:
    """One ``flash_attention`` call on (B, S, heads, dh) views (no copy)."""
    kw = {} if q_pos is None else {"q_pos": q_pos, "kv_pos": kv_pos}
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal, window=window,
                          **kw)
    return out.transpose(1, 2)


def prefix_grouped_causal(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor,
                          q_pos: Optional[torch.Tensor] = None,
                          kv_pos: Optional[torch.Tensor] = None, *,
                          window: int = 0, groups: int = 1) -> torch.Tensor:
    """The reference's ``prefix_grouped_causal`` (Sq == Skv): causal
    attention as ``groups`` prefix attends, query group g (rows lo:hi)
    against keys kv_lo:hi, kv_lo = 0 or, under a window, max(0, lo -
    window + 1); one kernel call a group, the outputs concatenated.  One
    call of the whole when ``groups`` <= 1 or does not divide S.  Without
    positions each call's end-aligned positions are the group's own (query
    i at lo + i, key j at kv_lo + j, shifted alike); with them, the group's
    slices of ``q_pos`` / ``kv_pos``."""
    s = q.shape[1]
    if groups <= 1 or s % groups:
        return _flash(q, k, v, q_pos, kv_pos, causal=True, window=window)
    gs = s // groups
    outs = []
    for g in range(groups):
        lo, hi = g * gs, (g + 1) * gs
        kv_lo = 0 if window <= 0 else max(0, lo - window + 1)
        qp = None if q_pos is None else q_pos[..., lo:hi]
        kp = None if kv_pos is None else kv_pos[..., kv_lo:hi]
        outs.append(_flash(q[:, lo:hi], k[:, kv_lo:hi], v[:, kv_lo:hi], qp,
                           kp, causal=True, window=window))
    return torch.cat(outs, dim=1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              positions: Optional[torch.Tensor] = None, *, causal: bool,
              window: int = 0, prefix_groups: int = 1) -> torch.Tensor:
    """Full-sequence self-attention, q (B,S,H,dh), k/v (B,S,KVH,dh),
    through the ``flash_attention`` wrapper (strided views, no copy).
    Positions are implicit (``arange(S)``, the kernel's end-aligned
    positions at Sq == Skv) or ``positions`` (B or 1, S), the query's and
    the keys' alike (M-RoPE's t axis, as ``layers.attn_apply`` passes it),
    which the kernel masks by in its position mode (the reference's
    ``attention(q, k, v, pos1d, pos1d, ...)``); nothing is read back to
    the host.  Causal attention with ``prefix_groups`` > 1 runs as the
    reference's ``prefix_grouped_causal``."""
    s = q.shape[1]
    if k.shape[1] != s:
        raise ValueError(f"full-sequence attention needs Sq == Skv, got "
                         f"{s} and {k.shape[1]}")
    if causal and prefix_groups > 1:
        return prefix_grouped_causal(q, k, v, positions, positions,
                                     window=window, groups=prefix_groups)
    return _flash(q, k, v, positions, positions, causal=causal,
                  window=window)


def decode_attend(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, q_pos: torch.Tensor,
                  cache_pos: torch.Tensor) -> torch.Tensor:
    """One-token decode. q: (B,1,H,dh); caches (B,W,KVH,dh);
    q_pos (B,); cache_pos (B,W) absolute positions (-1 = empty)."""
    return attend_direct(q, k_cache, v_cache, q_pos[:, None], cache_pos,
                         causal=True, window=0)
