"""Shared model building blocks (the reference's ``models/common.py``):
matmuls with f32 accumulation, RMSNorm, LayerNorm, RoPE and M-RoPE,
SwiGLU, the tanh-GELU MLP (the audio family's FFN and the DiT's), the
depthwise causal conv of the Mamba and mLSTM mixers, and for the DiT adaLN
modulation, timestep embedding and (un)patchify.

``fdot``/``feinsum`` mirror the reference's ``preferred_element_type=f32``
followed by a cast back: PyTorch's matmul on bf16 operands accumulates in
f32 and rounds the result once (cuBLAS, with
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`` off,
and oneDNN on the CPU); on f32 operands it is a plain f32 matmul (TF32 off,
PyTorch's default for matmul).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

F32 = torch.float32


def fdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matmul with f32 accumulation, result in a.dtype."""
    return torch.matmul(a, b.to(a.dtype))


def feinsum(eq: str, *xs: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, *(x.to(xs[0].dtype) for x in xs))


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(F32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.to(F32)).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(F32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * w.to(F32) + b.to(F32)
    return out.to(x.dtype)


def _inv_freq(half_dim: int, theta: float,
              device: torch.device) -> torch.Tensor:
    """(half_dim,) f32 rotary frequencies.  ``theta`` stays a Python
    scalar: a tensor made from it on the card would be a host copy that
    synchronizes."""
    exps = torch.arange(half_dim, dtype=F32, device=device) / half_dim
    return 1.0 / theta ** exps


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """Split-half rotation of x (B, S, H, dh) by angles (B, S, dh/2), in
    f32, cast back."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.to(F32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (B, S, H, dh); positions: (B, S) or (S,).  Split-half rotation,
    in f32."""
    dh = x.shape[-1]
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions.to(F32)[..., None] * _inv_freq(dh // 2, theta, x.device)
    return _rotate(x, ang)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections: Tuple[int, ...], theta: float) -> torch.Tensor:
    """Qwen2-VL's multi-axis RoPE.  x: (B, S, H, dh); positions (B, S, A)
    with A == len(sections): the rotary half-dims are split into
    ``sections`` (summing to dh // 2), each rotated with its own position
    axis (t, h, w).  Where the A axes agree this is ``apply_rope``, angle
    for angle."""
    dh = x.shape[-1]
    if sum(sections) != dh // 2:
        raise ValueError(f"mrope sections {sections} must sum to half the "
                         f"head dim ({dh} // 2 = {dh // 2})")
    lead = positions.shape[:2]
    pos = torch.cat([positions[..., i, None].to(F32).expand(*lead, n)
                     for i, n in enumerate(sections)], dim=-1)
    return _rotate(x, pos * _inv_freq(dh // 2, theta, x.device))


def rope_dispatch(x: torch.Tensor, positions, kind: str, theta: float,
                  sections: Tuple[int, ...]) -> torch.Tensor:
    """``kind`` "none" (or no positions) leaves x as it is; "mrope" is
    ``apply_mrope``, 2-d (text-only) positions repeated over the sections'
    axes; any other kind is ``apply_rope``, as in the reference
    (``TransformerModel`` refuses kinds the reference does not name)."""
    if kind == "none" or positions is None:
        return x
    if kind == "mrope":
        if positions.ndim == 2:
            positions = positions[..., None].expand(*positions.shape,
                                                    len(sections))
        return apply_mrope(x, positions, sections, theta)
    return apply_rope(x, positions, theta)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = fdot(x, w_gate)
    u = fdot(x, w_up)
    return fdot(F.silu(g.to(F32)).to(x.dtype) * u, w_down)


def modulate(x: torch.Tensor, shift: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    """adaLN modulation; shift/scale are (B, D), x is (B, N, D)."""
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor,
             w_out: torch.Tensor, b_out: torch.Tensor,
             reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
             ) -> torch.Tensor:
    """The tanh-GELU MLP.  With ``reduce``, ``w_in``/``b_in`` hold this
    rank's ffn columns and ``w_out`` its rows: the f32 partial product is
    summed by ``reduce`` (an all-reduce over the model group), rounded
    once, then ``b_out`` is added once."""
    h = fdot(x, w_in) + b_in
    h = F.gelu(h.to(F32), approximate="tanh").to(x.dtype)
    if reduce is None:
        return fdot(h, w_out) + b_out
    return reduce(torch.matmul(h.to(F32), w_out.to(F32))).to(x.dtype) + b_out


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10_000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding (DiT). t: (B,) -> (B, dim) f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=F32, device=t.device) / half)
    args = t.to(F32)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def patchify(latents: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, (H/p)*(W/p), p*p*C)."""
    b, h, w, c = latents.shape
    x = latents.reshape(b, h // patch, patch, w // patch, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // patch) * (w // patch), patch * patch * c)


def unpatchify(tokens: torch.Tensor, patch: int, grid: int) -> torch.Tensor:
    """(B, g*g, p*p*C) -> (B, g*p, g*p, C)."""
    b, n, d = tokens.shape
    c = d // (patch * patch)
    x = tokens.reshape(b, grid, grid, patch, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, grid * patch, grid * patch, c)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv along seq. x: (B, S, C); w: (K, C).

    If ``state`` (B, K-1, C) is given, it is the trailing context (decode),
    cast to x's dtype as the reference casts it; else the pad is zeros in
    x's dtype.  Taps accumulate in f32 in the reference's order, the result
    is cast back to x's dtype."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros(x.shape[:1] + (k - 1,) + x.shape[2:], dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = torch.zeros(x.shape, dtype=F32, device=x.device)
    for i in range(k):
        out = out + xp[:, i:i + s].to(F32) * w[i].to(F32)
    return out.to(x.dtype)
