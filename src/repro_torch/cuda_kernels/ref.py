"""Plain PyTorch versions of the port's kernels, written line for line after
the reference's ``kernels/ref.py``.  The wrappers use them for CPU tensors;
the tests and ``chip_smoke.py`` hold the CUDA kernels against them."""
from __future__ import annotations

from typing import Tuple

import torch

F32 = torch.float32


def fused_gate(x: torch.Tensor, prev_in: torch.Tensor,
               prev_out: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               sigma2: torch.Tensor, eligible: torch.Tensor, *,
               threshold: float, gamma: float = 0.5, use_blend: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """Per-sample fused cache gate (Eqs. 4-7 + 6/MB).  x, prev_in, prev_out:
    (B, C, D); w: (D, D); b: (D,); sigma2, eligible: (B,).  Returns
    (out (B,C,D), gate (B,) bool, diff_sq (B,), prev_sq (B,)): gated samples
    get the blended linear approximation, the rest pass through."""
    xf = x.to(F32)
    pf = prev_in.to(F32)
    dd = xf - pf
    diff = (dd * dd).sum(dim=(1, 2))
    prevsq = (pf * pf).sum(dim=(1, 2))
    nd = x.shape[1] * x.shape[2]
    stat = diff / (sigma2.to(F32).clamp(min=1e-30) * nd)
    gate = (stat <= threshold) & eligible.to(torch.bool)
    approx = torch.matmul(xf, w.to(F32)) + b.to(F32)
    if use_blend:
        approx = gamma * approx + (1.0 - gamma) * prev_out.to(F32)
    out = torch.where(gate[:, None, None], approx, xf)
    return out.to(x.dtype), gate, diff, prevsq
