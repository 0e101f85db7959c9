"""Learnable linear approximators (Eqs. 3, 6).

  * token bypass:  H^s = W_c X^s + b_c           (one global map, Eq. 3)
  * block cache:   H_l = W_l H_{l-1} + b_l       (one map per block, Eq. 6)

Initialization is the identity map in f32.  Calibration
(``fit_linear``/``calibrate_dit``) is not ported yet.
"""
from __future__ import annotations

from typing import Dict

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
