"""Optimizers from scratch, after the reference's ``training/optimizer.py``:
AdamW and Adafactor (factored second moment), a cosine learning-rate
schedule and global-norm clipping.

Both optimizers are transforms of a parameter tree (``repro_torch.tree``):
``init(params) -> state`` and ``update(grads, state, params, lr) ->
(params, state)``, with the reference's defaults and rules.  Where the
reference returns new arrays, the port updates ``params``, the state's
moments and (in ``clip_by_global_norm``) the gradients in place, and
returns them.  ``torch.optim`` is not used: its decay and step rules are
not the reference's.

The rules read a leaf's ``ndim`` (AdamW decays, Adafactor factors, leaves
of two or more dimensions) and Adafactor reduces over a whole leaf (the
update's RMS, the column statistics of a stacked vector).  The reference's
block parameters are one leaf stacked on the layer axis, so the tree given
here must hold them the same way: ``training.loop.param_tree`` lays a
model's per-layer tensors out as rows of one (L, ...) leaf.

Parameters are updated in their own dtype with no f32 master copy, as in
the reference (``new_p.astype(p.dtype)``): an update smaller than half a
bf16 ulp of a parameter is lost.  The step count and the learning rate are
host numbers, so an update makes no device sync.

An update's f32 temporaries are bounded, so that a full-width model whose
parameters and gradients fill most of the card still steps (xLSTM-1.3b's
3.6 B parameters under AdamW, Jamba's 16 x 4,096 x 14,336 expert banks
under Adafactor) with at most ``UPDATE_BYTES`` of f32 per temporary: AdamW
runs its elementwise rule over buckets of leaves, a leaf larger than the
bound in flat slices (bit for bit the rule over all leaves at once), and
Adafactor runs a leaf of two or more dimensions in blocks of its (D, F)
matrices, in three passes (statistics, the update's RMS over the whole
leaf, the update), which sum in another order than the reference's
whole-leaf rule (f32 rounding).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import tree

F32 = torch.float32
_f = np.float32
UPDATE_BYTES = 1 << 30      # f32 bytes an update works on at once


# --------------------------------------------------------------------------
# LR schedule
# --------------------------------------------------------------------------

def cosine_schedule(base_lr: float, warmup: int,
                    total: int) -> Callable[[int], float]:
    """Linear warm-up then cosine decay, computed in float32 from a host
    step, as the reference computes it on the device."""
    def lr(step: int) -> float:
        s = _f(step)
        if s < warmup:
            return float(_f(base_lr) * (s + _f(1.0)) / _f(max(1, warmup)))
        prog = np.clip((s - _f(warmup)) / _f(max(1, total - warmup)),
                       _f(0.0), _f(1.0))
        # cos of the f32 argument, rounded once (as XLA's cos is, but for
        # one in 80 arguments; numpy's f32 cos is an ulp off in one in 5)
        cos = _f(np.cos(np.float64(_f(np.pi) * prog)))
        return float(_f(base_lr) * _f(0.5) * (_f(1.0) + cos))
    return lr


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(g**2), in float32 (0-dim)."""
    norms = torch._foreach_norm(tree.leaves(grads), 2, dtype=F32)
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(grads, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """Scale every gradient by min(1, max_norm / norm) in float32, rounded
    back to its dtype, in place.  Returns (grads, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    with torch.no_grad():
        torch._foreach_mul_(tree.leaves(grads), scale)
    return grads, norm


def _as_f32(ts):
    return [t.to(F32) for t in ts]


def _store(params, new):
    """Write float32 results back into the parameters (in their dtype);
    an f32 parameter was updated in place already."""
    pairs = [(p, n) for p, n in zip(params, new) if p is not n]
    if pairs:
        torch._foreach_copy_([p for p, _ in pairs], [n for _, n in pairs])


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

class AdamWState(NamedTuple):
    step: int
    mu: Any
    nu: Any


class AdamW:
    def __init__(self, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay

    def init(self, params) -> AdamWState:
        zeros = lambda p: torch.zeros(p.shape, dtype=F32, device=p.device)
        return AdamWState(step=0, mu=tree.map(zeros, params),
                          nu=tree.map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, lr: float):
        step = state.step + 1
        c1 = float(_f(1.0) - _f(self.b1) ** _f(step))
        c2 = float(_f(1.0) - _f(self.b2) ** _f(step))
        bucket, nbytes = [], 0
        for leaf in _pieces(params, state.mu, state.nu, grads):
            size = 4 * leaf[0].numel()
            if bucket and nbytes + size > UPDATE_BYTES:
                self._update(bucket, c1, c2, lr)
                bucket, nbytes = [], 0
            bucket.append(leaf)
            nbytes += size
        if bucket:
            self._update(bucket, c1, c2, lr)
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu)

    def _update(self, leaves, c1: float, c2: float, lr: float) -> None:
        """The rule on one bucket of (param, mu, nu, grad, decayed)."""
        b1, b2 = self.b1, self.b2
        ps, ms, vs, gs, decay = (list(x) for x in zip(*leaves))
        gs = _as_f32(gs)
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, gs, alpha=1 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, gs, gs, value=1 - b2)
        den = torch._foreach_div(vs, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(ms, c1)
        torch._foreach_div_(u, den)
        del den, gs
        p32 = _as_f32(ps)
        decayed = [i for i, d in enumerate(decay) if d]
        if decayed and self.wd:
            torch._foreach_add_([u[i] for i in decayed],
                                [p32[i] for i in decayed], alpha=self.wd)
        torch._foreach_add_(p32, u, alpha=-lr)
        _store(ps, p32)


def _pieces(params, mu, nu, grads):
    """(param, mu, nu, grad, decayed) for each leaf, a leaf of more than
    ``UPDATE_BYTES`` of f32 as flat slices of at most that many (views of
    its parameter and moments, which the update writes); ``decayed`` is the
    leaf's own ``ndim >= 2``."""
    n = UPDATE_BYTES // 4
    for p, m, v, g in zip(tree.leaves(params), tree.leaves(mu),
                          tree.leaves(nu), tree.leaves(grads)):
        decay = p.ndim >= 2
        if p.numel() <= n:
            yield p, m, v, g, decay
            continue
        flat = [t.view(-1) for t in (p, m, v)] + [g.reshape(-1)]
        for i in range(0, p.numel(), n):
            yield (*(t[i:i + n] for t in flat), decay)


# --------------------------------------------------------------------------
# Adafactor
# --------------------------------------------------------------------------

class AdafactorState(NamedTuple):
    step: int
    vr: Any     # row statistics (or full v for <2D leaves)
    vc: Any     # col statistics (or a (1,) placeholder)


class Adafactor:
    """Factored second-moment RMS optimizer (Shazeer & Stern 2018), no
    momentum, update-clipping d=1.0.  A leaf of ndim >= 2 is factored over
    its last two axes (a stacked (L, E, D, F) expert leaf keeps rows
    (L, E, D) and columns (L, E, F)) and its update clipped by the RMS over
    the whole leaf, as the reference does with its stacked leaves."""

    def __init__(self, eps: float = 1e-30, clip: float = 1.0,
                 decay_pow: float = 0.8, weight_decay: float = 0.0):
        self.eps, self.clip, self.decay_pow = eps, clip, decay_pow
        self.wd = weight_decay

    def init(self, params) -> AdafactorState:
        def vr(p):
            shape = p.shape[:-1] if p.ndim >= 2 else p.shape
            return torch.zeros(shape, dtype=F32, device=p.device)

        def vc(p):
            shape = (p.shape[:-2] + p.shape[-1:]) if p.ndim >= 2 else (1,)
            return torch.zeros(shape, dtype=F32, device=p.device)

        return AdafactorState(step=0, vr=tree.map(vr, params),
                              vc=tree.map(vc, params))

    @torch.no_grad()
    def update(self, grads, state: AdafactorState, params, lr: float):
        step = state.step + 1
        beta = float(_f(1.0) - (_f(step) + _f(1.0)) ** _f(-self.decay_pow))
        for g, vr, vc, p in zip(tree.leaves(grads), tree.leaves(state.vr),
                                tree.leaves(state.vc), tree.leaves(params)):
            if p.ndim >= 2:
                self._update_factored(g, vr, vc, p, beta, lr)
                continue
            g = g.to(F32)
            vr.mul_(beta).add_(g * g + self.eps, alpha=1 - beta)
            u = g / torch.sqrt(vr + self.eps)
            # update clipping on RMS
            rms = torch.sqrt((u * u).mean() + self.eps)
            u = u / torch.clamp(rms / self.clip, min=1.0)
            p.copy_(p.to(F32) - lr * u)
        return params, AdafactorState(step=step, vr=state.vr, vc=state.vc)

    def _update_factored(self, g, vr, vc, p, beta: float, lr: float) -> None:
        """The factored rule on a leaf of ndim >= 2, (..., D, F) seen as N
        matrices, in blocks holding at most ``UPDATE_BYTES`` of f32 (as
        many whole matrices as fit, else rows of one matrix): pass 1
        updates the row and column statistics (the columns' means from the
        blocks' sums), pass 2 sums the update's squares over the whole leaf
        for its RMS, pass 3 recomputes each block's update and applies it.
        Nothing is read back to the host."""
        d, f = p.shape[-2:]
        n = p.numel() // (d * f)
        gm, pm = g.reshape(n, d, f), p.view(n, d, f)   # pm writes p
        vrm, vcm = vr.view(n, d), vc.view(n, f)
        per = UPDATE_BYTES // (4 * d * f)
        if per:
            blocks = [(i, min(n, i + per), 0, d) for i in range(0, n, per)]
        else:
            rows = max(1, UPDATE_BYTES // (4 * f))
            blocks = [(i, i + 1, r, min(d, r + rows)) for i in range(n)
                      for r in range(0, d, rows)]

        def update_of(i0, i1, r0, r1):
            gb = gm[i0:i1, r0:r1].to(F32)
            denom = torch.clamp(vrm[i0:i1].mean(dim=-1), min=self.eps)
            vhat = (vrm[i0:i1, r0:r1, None] * vcm[i0:i1, None, :]
                    / denom[:, None, None])
            return gb / torch.sqrt(vhat + self.eps)

        colsum = torch.zeros((n, f), dtype=F32, device=p.device)
        for i0, i1, r0, r1 in blocks:                  # pass 1: statistics
            gb = gm[i0:i1, r0:r1].to(F32)
            g2 = gb * gb + self.eps
            vrm[i0:i1, r0:r1].mul_(beta).add_(g2.mean(dim=-1),
                                             alpha=1 - beta)
            colsum[i0:i1] += g2.sum(dim=1)
        vcm.mul_(beta).add_(colsum / d, alpha=1 - beta)
        sq = torch.zeros((), dtype=F32, device=p.device)
        for blk in blocks:                             # pass 2: the RMS
            u = update_of(*blk)
            sq += (u * u).sum()
        rms = torch.sqrt(sq / p.numel() + self.eps)
        scale = torch.clamp(rms / self.clip, min=1.0)
        for i0, i1, r0, r1 in blocks:                  # pass 3: the update
            u = update_of(i0, i1, r0, r1) / scale
            p32 = pm[i0:i1, r0:r1].to(F32)
            pm[i0:i1, r0:r1].copy_(p32 - lr * u - lr * self.wd * p32)


def make_optimizer(name: str, **kw):
    if name == "adamw":
        return AdamW(**kw)
    if name == "adafactor":
        return Adafactor(**kw)
    raise KeyError(name)
