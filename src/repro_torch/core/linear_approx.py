"""Learnable linear approximators (Eqs. 3, 6).

  * token bypass:  H^s = W_c X^s + b_c           (one global map, Eq. 3)
  * block cache:   H_l = W_l H_{l-1} + b_l       (one map per block, Eq. 6)

Initialization is the identity map in f32.  Calibration
(``fit_linear``/``calibrate_dit``) is not ported yet.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device

F32 = torch.float32


def init_linear_params(num_blocks: int, d_model: int,
                       device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    eye = torch.eye(d_model, dtype=F32, device=dev)
    return {
        "W_c": eye,
        "b_c": torch.zeros((d_model,), dtype=F32, device=dev),
        "W_l": eye.expand(num_blocks, d_model, d_model).clone(),
        "b_l": torch.zeros((num_blocks, d_model), dtype=F32, device=dev),
    }


def apply_linear(w: torch.Tensor, b: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    return (torch.matmul(x.to(F32), w.to(F32)) + b.to(F32)).to(x.dtype)


def blend(approx: torch.Tensor, prev_out: torch.Tensor,
          gamma: float) -> torch.Tensor:
    """Motion-aware blending (MB): gamma * linear-approx + (1-gamma) * cached
    previous-step output of the same block."""
    return (gamma * approx.to(F32)
            + (1.0 - gamma) * prev_out.to(F32)).to(approx.dtype)


def bf16_copies(w: torch.Tensor, dtype: torch.dtype,
                device: torch.device) -> List[Optional[torch.Tensor]]:
    """The matrices of ``w`` ((D, F), or a stack (L, D, F)) rounded to bf16
    once, as the wgmma route of ``linear_blend`` / ``fused_gate`` multiplies
    them (``cuda_kernels/route.py``): one contiguous (D, F) tensor per
    matrix for a bf16 model on CUDA, else None per matrix (the CPU's plain
    versions and the SIMT route read the f32 ``w``)."""
    stack = w.reshape(-1, *w.shape[-2:])
    if dtype != torch.bfloat16 or torch.device(device).type != "cuda":
        return [None] * stack.shape[0]
    return list(stack.to(torch.bfloat16).contiguous().unbind(0))
