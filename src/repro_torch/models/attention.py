"""Bidirectional attention for the DiT: the reference's ``attend_direct``
with ``causal=False`` (at 256 tokens the reference always takes the direct
path).

Both products run on operands upcast to f32.  A product of two bf16 values
is exact in f32, so this is the reference's "inputs in the model dtype,
accumulate in f32" (``preferred_element_type=f32``) with the scores kept in
f32, as the reference keeps them.
"""
from __future__ import annotations

import torch

F32 = torch.float32


def attend_direct(q: torch.Tensor, k: torch.Tensor,
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
