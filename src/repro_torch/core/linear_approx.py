"""Learnable linear approximators (Eqs. 3, 6).

  * token bypass:  H^s = W_c X^s + b_c           (one global map, Eq. 3)
  * block cache:   H_l = W_l H_{l-1} + b_l       (one map per block, Eq. 6)

Initialization is the identity map in f32.  Calibration (``fit_linear`` /
``calibrate_dit``) learns the first-order correction by ridge least squares
over (block input, block output) pairs, in f32 with ``torch.matmul`` and
``torch.linalg.solve`` as the reference does in XLA (no Pallas kernel there
either).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import torch

from repro_torch.cuda_kernels import route
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


def split_copies(w: torch.Tensor, dtype: torch.dtype,
                 device: torch.device) -> List[Optional[torch.Tensor]]:
    """The matrices of ``w`` ((D, F), or a stack (L, D, F)) each split once
    into ``route.SPLIT_TERMS`` bf16 terms, each the bf16 rounding of what
    the terms before it leave of W (W_hi = bf16(W), W_mid = bf16(W - W_hi),
    ...; each difference is exact in f32), as the wgmma_split route of
    ``linear_blend`` / ``fused_gate`` multiplies them: one contiguous
    (SPLIT_TERMS Kp, F) tensor per matrix, term t in rows [t Kp, t Kp + D),
    the rest zero, Kp = ``route.split_rows(D)``, for a bf16 model on CUDA;
    else None per matrix.  The terms' sum misses W by at most
    2^(-8 SPLIT_TERMS) of |W|."""
    stack = w.reshape(-1, *w.shape[-2:]).to(F32)
    if dtype != torch.bfloat16 or torch.device(device).type != "cuda":
        return [None] * stack.shape[0]
    n, d, f = stack.shape
    kp = route.split_rows(d)
    out = torch.zeros((n, route.SPLIT_TERMS * kp, f), dtype=torch.bfloat16,
                      device=stack.device)
    rest = stack
    for t in range(route.SPLIT_TERMS):
        out[:, t * kp:t * kp + d] = rest.to(torch.bfloat16)
        rest = rest - out[:, t * kp:t * kp + d].to(F32)
    return list(out.unbind(0))


def fit_linear(x: torch.Tensor, y: torch.Tensor, ridge: float = 1e-4
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ridge least-squares fit of y ~ x W + b in f32, centred, with the
    ridge scaled by the sample count (the reference's).  x, y:
    (samples, D).  Returns (W (D, F), b (F,))."""
    x = x.to(F32)
    y = y.to(F32)
    mu_x = x.mean(0)
    mu_y = y.mean(0)
    xc = x - mu_x
    yc = y - mu_y
    d = x.shape[1]
    g = xc.T @ xc + ridge * x.shape[0] * torch.eye(d, dtype=F32,
                                                   device=x.device)
    # LAPACK hands the solution back column-major: the kernels take W
    # row-major
    w = torch.linalg.solve(g, xc.T @ yc).contiguous()       # (D, F)
    b = mu_y - mu_x @ w
    return w, b


@torch.no_grad()
def calibrate_dit(model, sample_batches: Iterable[Mapping[str, torch.Tensor]],
                  ridge: float = 1e-4) -> Dict[str, torch.Tensor]:
    """Fit per-block linear maps from (block input, block output) pairs
    collected over calibration batches (each: ``latents``, ``t``,
    ``labels``), and the token-bypass map W_c from (token embedding, final
    hidden) pairs: the bypass approximates the whole stack for static
    tokens (Eq. 3).  Returns a new fastcache parameter dict (f32) for
    ``CachedDiT(fc_params=...)``, which serves maps handed in on the
    wgmma_split route (``split_copies``, ``core/runner.py``).

    Block l's output is block l+1's input, so each layer's activations are
    kept once (the reference stores both sides of every pair)."""
    n_blocks = model.cfg.num_layers
    acts: List[List[torch.Tensor]] = [[] for _ in range(n_blocks + 1)]
    for batch in sample_batches:
        x = model.tokens_in(batch["latents"])
        c = model.conditioning(batch["t"], batch["labels"])
        acts[0].append(x.reshape(-1, x.shape[-1]))
        for l, bp in enumerate(model.blocks):
            x = model.block_apply(bp, x, c)
            acts[l + 1].append(x.reshape(-1, x.shape[-1]))
    stacked = [torch.cat(a) for a in acts]
    w_l, b_l = [], []
    for l in range(n_blocks):
        w, b = fit_linear(stacked[l], stacked[l + 1], ridge)
        w_l.append(w)
        b_l.append(b)
    w_c, b_c = fit_linear(stacked[0], stacked[-1], ridge)
    return {"W_c": w_c, "b_c": b_c, "W_l": torch.stack(w_l),
            "b_l": torch.stack(b_l)}
