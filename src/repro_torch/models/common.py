"""Shared DiT building blocks: matmuls with f32 accumulation, adaLN
modulation, the tanh-GELU MLP, timestep embedding and (un)patchify.

``fdot``/``feinsum`` mirror the reference's ``preferred_element_type=f32``
followed by a cast back: PyTorch's matmul on bf16 operands accumulates in
f32 and rounds the result once (cuBLAS, with
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`` off,
and oneDNN on the CPU); on f32 operands it is a plain f32 matmul (TF32 off,
PyTorch's default for matmul).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

F32 = torch.float32


def fdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matmul with f32 accumulation, result in a.dtype."""
    return torch.matmul(a, b.to(a.dtype))


def feinsum(eq: str, *xs: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, *(x.to(xs[0].dtype) for x in xs))


def modulate(x: torch.Tensor, shift: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    """adaLN modulation; shift/scale are (B, D), x is (B, N, D)."""
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor,
             w_out: torch.Tensor, b_out: torch.Tensor) -> torch.Tensor:
    h = fdot(x, w_in) + b_in
    h = F.gelu(h.to(F32), approximate="tanh").to(x.dtype)
    return fdot(h, w_out) + b_out


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
