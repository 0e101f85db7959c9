"""Plain PyTorch versions of the port's kernels, written line for line after
the reference's ``kernels/ref.py``.  The wrappers use them for CPU tensors;
the tests and ``chip_smoke.py`` hold the CUDA kernels against them."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

F32 = torch.float32


def saliency_delta(x: torch.Tensor, x_prev: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x, x_prev: (N, D). Returns (per-token saliency (N,), ||dX||_F^2,
    ||X_prev||_F^2) — the fused quantities of Eqs. 1 and 4.  A (B, N, D)
    batch gives (B, N), (B,), (B,): the totals per sample, the first
    summed over that sample's per-token sums."""
    d = x.to(F32) - x_prev.to(F32)
    sal = (d * d).sum(dim=-1)
    pf = x_prev.to(F32)
    return sal, sal.sum(dim=-1), (pf * pf).sum(dim=(-2, -1))


def linear_blend(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: torch.Tensor, gamma: float) -> torch.Tensor:
    """out = gamma * (x @ w + b) + (1-gamma) * prev.  x: (M, D); w: (D, F)."""
    y = torch.matmul(x.to(F32), w.to(F32)) + b.to(F32)
    return (gamma * y + (1.0 - gamma) * prev.to(F32)).to(x.dtype)


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int = 0,
                    q_pos: Optional[torch.Tensor] = None,
                    kv_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, H, Sq, dh); k, v: (B, KVH, Skv, dh); GQA by head grouping.
    Without positions, query positions are aligned to the end of the KV
    sequence (prefill: Sq == Skv; any Sq <= Skv).  With ``q_pos`` (B or 1,
    Sq) and ``kv_pos`` (B or 1, Skv) integer positions, any Sq and Skv,
    the mask is the reference's ``_mask``: key j is live for query i where
    kv_pos[j] >= 0, kv_pos[j] <= q_pos[i] if causal, and kv_pos[j] >
    q_pos[i] - window if window > 0.  Scores and p in f32, masked scores
    -1e30 (a row with no live key takes the uniform mean over all keys, as
    the reference's ``attend_direct``), output in q.dtype."""
    b, h, sq, dh = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, kvh, g, sq, dh)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg.to(F32), k.to(F32))
    s = s * dh ** -0.5
    if (q_pos is None) != (kv_pos is None):
        raise ValueError("q_pos and kv_pos go together")
    if q_pos is None:
        qp = (torch.arange(sq, device=q.device) + (skv - sq))[:, None]
        kp = torch.arange(skv, device=q.device)[None, :]
    else:                                            # (B|1, 1, 1, Sq, Skv)
        qp = q_pos[:, None, None, :, None]
        kp = kv_pos[:, None, None, None, :]
    m = kp >= 0
    if causal:
        m = m & (kp <= qp)
    if window > 0:
        m = m & (kp > qp - window)
    s = s.masked_fill(~m, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.to(F32))
    return o.reshape(b, h, sq, dh).to(q.dtype)


def check_knn_k(k: int, w: int) -> None:
    """A window of ``w`` tokens has ``w - 1`` neighbours: every knn-density
    path raises this same error for ``k`` outside [1, w-1]."""
    if not 1 <= k <= w - 1:
        raise ValueError(f"knn_density k={k} out of range for window "
                         f"w={w}; need 1 <= k <= w-1 = {w - 1}")


def check_merge_m(m: int, w: int) -> None:
    if not 1 <= m <= w:
        raise ValueError(f"merge_assign m={m} out of range for window "
                         f"w={w}; need 1 <= m <= w")


def knn_density(h: torch.Tensor, k: int) -> torch.Tensor:
    """h: (W, w, D) windowed tokens -> rho_sp (W, w) (Eq. 10)."""
    w = h.shape[-2]
    check_knn_k(k, w)
    hf = h.to(F32)
    sq = (hf * hf).sum(dim=-1)
    dist = (sq[..., :, None] + sq[..., None, :]
            - 2.0 * torch.einsum("wid,wjd->wij", hf, hf))
    dist = dist.clamp(min=0.0)
    eye = torch.eye(w, dtype=torch.bool, device=h.device)
    dist = torch.where(eye, torch.inf, dist)
    smallest = torch.sort(dist, dim=-1).values[..., :k]      # k smallest
    return torch.exp(-smallest.mean(dim=-1) / h.shape[-1])


def merge_assign(h: torch.Tensor, s: torch.Tensor, m: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ground truth of the merge kernel (Eqs. 12-13, Alg. 2; one window per
    leading row).  h: (W, w, D) tokens, s: (W, w) per-window-normalized
    importance -> (merged (W, M, D) importance-weighted cluster means,
    assign (W, w) int32 nearest-center ids, centers (W, M) int32
    window-local center indices in ``lax.top_k`` order)."""
    check_merge_m(m, h.shape[1])
    # lax.top_k order: descending, ties to the lower index
    centers = torch.sort(s, dim=-1, descending=True, stable=True
                         ).indices[:, :m]                    # (W, M)
    d = h.shape[-1]
    ch = torch.gather(h, 1, centers[..., None].expand(-1, -1, d))
    hf, cf = h.to(F32), ch.to(F32)
    d2 = ((hf * hf).sum(dim=-1)[..., :, None]
          + (cf * cf).sum(dim=-1)[..., None, :]
          - 2.0 * torch.einsum("wid,wjd->wij", hf, cf))      # (W, w, M)
    assign = torch.argmin(d2, dim=-1)                        # first minimum
    onehot = torch.nn.functional.one_hot(assign, m).to(F32)  # (W, w, M)
    wgt = onehot * s.to(F32)[..., None]
    num = torch.einsum("wim,wid->wmd", wgt, hf)
    den = wgt.sum(dim=1).clamp(min=1e-9)                     # (W, M)
    merged = (num / den[..., None]).to(h.dtype)
    return merged, assign.to(torch.int32), centers.to(torch.int32)


def unmerge_scatter(merged: torch.Tensor, assign: torch.Tensor
                    ) -> torch.Tensor:
    """merged: (W, M, D), assign: (W, w) int32 -> (W, w, D): exact gather of
    each token's cluster representative."""
    idx = assign.to(torch.int64)[..., None].expand(-1, -1, merged.shape[-1])
    return torch.gather(merged, 1, idx)


def if_all(mask: torch.Tensor, when_all: bool) -> torch.Tensor:
    """The condition ``cond_node``'s kernel sets on its IF node: all(mask)
    when ``when_all``, else not all(mask), as a 0-dim bool."""
    every = mask.to(torch.bool).all()
    return every if when_all else ~every
