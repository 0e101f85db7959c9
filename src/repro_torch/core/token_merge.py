"""Spatial-temporal token merging — Local Clustering Token Merge (Eqs. 10-13,
Alg. 2) with static shapes, after the reference's ``core/token_merge.py``.

Tokens are processed in fixed windows of ``w``: the kNN density rho_sp uses
the K nearest neighbours within the window, each window keeps a static
number of cluster centers M = ceil(r * w), every token is assigned to its
nearest kept center, merged tokens are the importance-weighted cluster
means (Eq. 13), and ``unmerge_tokens`` restores resolution through the
stored assignment (Alg. 2's M mapping).

The three window kernels (``cuda_kernels.knn_density`` and
``cuda_kernels.token_merge``) are called through their wrappers, which run
the CUDA kernel on a card and the plain version on the CPU: the reference's
``use_fused`` switch is the tensors' device here.  The temporal term
rho_tm = ||h_t - h_prev|| is computed outside any kernel, as in the
reference.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.cuda_kernels.knn_density import knn_density as _knn_kernel
from repro_torch.cuda_kernels.ref import check_knn_k
from repro_torch.cuda_kernels.token_merge import merge_assign, unmerge_scatter

F32 = torch.float32


def knn_density(h: torch.Tensor, k: int) -> torch.Tensor:
    """Eq. 10 within windows.  h: (..., w, D) -> rho_sp (..., w) f32.  A
    ``k`` outside [1, w-1] raises (``check_knn_k``, in the wrapper)."""
    w, d = h.shape[-2:]
    flat = h.reshape(-1, w, d).contiguous()
    return _knn_kernel(flat, k=k).reshape(h.shape[:-1])


def importance(h_t: torch.Tensor, h_prev: torch.Tensor, k: int,
               lam: float) -> torch.Tensor:
    """Eq. 12: S_i = rho_sp * (1 + lambda * rho_tm). (..., w, D) -> (..., w)."""
    rho_sp = knn_density(h_t, k)
    rho_tm = torch.linalg.vector_norm(h_t.to(F32) - h_prev.to(F32), dim=-1)
    return rho_sp * (1.0 + lam * rho_tm)


class MergeMap(NamedTuple):
    assign: torch.Tensor     # (B, n_win, w) int32 — cluster id of each token
    centers: torch.Tensor    # (B, n_win, M) int32 — window-local centers
    scores: torch.Tensor     # (B, n_win, w) importance


def keep_count(window: int, keep_ratio: float) -> int:
    """Static centers per window, M = ceil(r * w) clamped to [1, w] — a
    ratio at or above 1.0 keeps every token (``merge_tokens`` is then the
    bitwise-identity map), a tiny ratio still keeps one center."""
    return min(window, max(1, math.ceil(keep_ratio * window)))


def _identity_map(b: int, n_win: int, window: int,
                  device: torch.device) -> MergeMap:
    idx = torch.arange(window, dtype=torch.int32, device=device).expand(
        b, n_win, window)
    return MergeMap(assign=idx, centers=idx,
                    scores=torch.ones((b, n_win, window), dtype=F32,
                                      device=device))


def merge_tokens(h_t: torch.Tensor, h_prev: torch.Tensor, *, window: int,
                 keep_ratio: float, k: int, lam: float
                 ) -> Tuple[torch.Tensor, MergeMap]:
    """(B, N, D) -> merged (B, N_keep, D), MergeMap.  N % window == 0.
    ``keep_ratio >= 1.0`` (M == w) short-circuits to the bitwise-identity
    map: the weighted-mean reconstruction of singleton clusters is only
    allclose-identical, and the r=1.0 contract is exact."""
    b, n, d = h_t.shape
    if n % window != 0:
        raise ValueError(f"token count {n} must be divisible by the merge "
                         f"window {window}")
    check_knn_k(k, window)
    n_win = n // window
    m = keep_count(window, keep_ratio)
    if m >= window:
        return h_t, _identity_map(b, n_win, window, h_t.device)
    hw = h_t.reshape(b, n_win, window, d)
    pw = h_prev.reshape(b, n_win, window, d)
    s = importance(hw, pw, k, lam)                         # (B, n_win, w)
    # normalize scores per window: the weighted mean (Eq. 13) is invariant
    # to per-window scaling and this avoids denominator underflow
    s = s / s.amax(dim=-1, keepdim=True).clamp(min=1e-30)
    merged, assign, centers = merge_assign(
        hw.reshape(b * n_win, window, d).contiguous(),
        s.reshape(b * n_win, window), m=m)
    return merged.reshape(b, n_win * m, d), MergeMap(
        assign=assign.reshape(b, n_win, window),
        centers=centers.reshape(b, n_win, m), scores=s)


def unmerge_tokens(merged: torch.Tensor, mm: MergeMap, *, window: int,
                   n_tokens: int) -> torch.Tensor:
    """Restore (B, N, D): each token takes its cluster representative."""
    b, nk, d = merged.shape
    n_win = n_tokens // window
    m = nk // n_win
    out = unmerge_scatter(merged.reshape(b * n_win, m, d).contiguous(),
                          mm.assign.reshape(b * n_win, window).contiguous())
    return out.reshape(b, n_tokens, d)
