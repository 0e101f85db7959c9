"""Mamba-1 selective-scan mixer (Jamba's SSM layers) [arXiv:2403.19887],
after the reference's ``models/mamba.py``.

The prefill runs chunked, as the reference's does: a loop over sequence
chunks (the chunk the largest divisor of S that is <= ``chunk``) carries the
(B, d_inner, d_state) f32 state; within a chunk the diagonal recurrence
``h_t = a_t * h_{t-1} + b_t`` is an inclusive log-depth doubling scan over
the chunk axis (the reference's ``lax.associative_scan`` combines the same
pairs in another tree order, so the two agree to f32 rounding).  Decode is
the single-step recurrent form, which updates a given state in place.  No
step reads a value back to the host.

The doubling runs out of place (each round builds new tensors), so that
autograd differentiates it, in training and in a ``no_grad`` prefill alike.

Casts are the reference's promotions: ``dt_r`` (model dtype) times the
model-dtype ``w_dt`` is an f32 product (JAX promotes, here ``w_dt`` is cast),
the conv bias is added in the model dtype, the skip term in f32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.layers import ParamGroup
from repro_torch.models.params import ParamDef

F32 = torch.float32
State = Dict[str, torch.Tensor]


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d = cfg.d_model
    di = cfg.ssm.expand * d
    ds = cfg.ssm.d_state
    dtr = cfg.ssm.dt_rank or math.ceil(d / 16)
    return d, di, ds, dtr


def mamba_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, di, ds, dtr = _dims(cfg)
    k = cfg.ssm.d_conv
    return {
        "norm": ParamDef((d,), "ones", dtype="float32", axes=("embed",)),
        "w_in": ParamDef((d, 2 * di), "fan_in", axes=("embed", "inner")),
        "conv_w": ParamDef((k, di), "fan_in", axes=(None, "inner")),
        "conv_b": ParamDef((di,), "zeros", axes=("inner",)),
        "w_x_proj": ParamDef((di, dtr + 2 * ds), "fan_in",
                             axes=("inner", None)),
        "w_dt": ParamDef((dtr, di), "fan_in", axes=(None, "inner")),
        "b_dt": ParamDef((di,), "ones", dtype="float32", axes=("inner",)),
        "a_log": ParamDef((di, ds), "ones", dtype="float32",
                          axes=("inner", "state")),
        "d_skip": ParamDef((di,), "ones", dtype="float32", axes=("inner",)),
        "w_out": ParamDef((di, d), "fan_in",
                          scale=1.0 / max(1, cfg.num_layers) ** 0.5,
                          axes=("inner", "embed")),
    }


def mamba_state_defs(cfg: ModelConfig, batch: int) -> Dict[str, ParamDef]:
    _, di, ds, _ = _dims(cfg)
    k = cfg.ssm.d_conv
    return {"ssm": ParamDef((batch, di, ds), "zeros", dtype="float32",
                            axes=("act_batch", "act_inner", None)),
            "conv": ParamDef((batch, k - 1, di), "zeros", dtype="float32",
                             axes=("act_batch", None, "act_inner"))}


def _ssm_params(p: ParamGroup, xc: torch.Tensor, cfg: ModelConfig):
    """xc: (B, L, di) post-conv activations. Returns dA, dBx (B, L, di, ds)
    and C (B, L, ds), all f32, for the span."""
    _, di, ds, dtr = _dims(cfg)
    dbc = common.fdot(xc, p.w_x_proj)                        # (B,L,dtr+2ds)
    dt_r = dbc[..., :dtr]
    b_mat = dbc[..., dtr:dtr + ds].to(F32)                   # (B,L,ds)
    c_mat = dbc[..., dtr + ds:].to(F32)                      # (B,L,ds)
    dt = F.softplus(torch.matmul(dt_r.to(F32), p.w_dt.to(F32)) + p.b_dt)
    a = -torch.exp(p.a_log)                                  # (di,ds)
    da = torch.exp(dt[..., None] * a)                        # (B,L,di,ds)
    dbx = (dt[..., None] * b_mat[:, :, None, :]
           * xc.to(F32)[..., None])                          # (B,L,di,ds)
    return da, dbx, c_mat


def _chunk_scan(da: torch.Tensor, dbx: torch.Tensor, c_mat: torch.Tensor,
                h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``h_t = da_t * h_{t-1} + dbx_t`` within a chunk.
    da/dbx: (B,L,di,ds); h0: (B,di,ds).  Returns y (B,L,di) and the last
    state.  Hillis-Steele doubling over the chunk axis: log2(L) rounds,
    each combining every position with the one ``k`` before it by the
    reference's ``combine`` (a1 * a2, a2 * b1 + b2)."""
    n = dbx.shape[1]
    a = da
    b = torch.cat([dbx[:, :1] + da[:, :1] * h0[:, None], dbx[:, 1:]],
                  dim=1)                           # fold the initial state
    k = 1
    while k < n:
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        if 2 * k < n:
            a = torch.cat([a[:, :k], a[:, k:] * a[:, :-k]], dim=1)
        k *= 2
    y = torch.matmul(b, c_mat[..., None])[..., 0]            # (B,L,di)
    return y, b[:, -1]


def mamba_apply(p: ParamGroup, x: torch.Tensor, *, cfg: ModelConfig,
                state: Optional[State] = None, decode: bool = False,
                chunk: int = 256) -> Tuple[torch.Tensor, State]:
    """Pre-norm Mamba block with residual.  Returns (x, state): with
    ``decode`` the one-token step updates ``state``'s tensors in place and
    returns them; else the state after the sequence is new tensors."""
    res = x
    b, s, _ = x.shape
    _, di, ds, _ = _dims(cfg)
    kk = cfg.ssm.d_conv
    xn = common.rms_norm(x, p.norm, cfg.norm_eps)
    xz = common.fdot(xn, p.w_in)
    xi, z = xz.chunk(2, dim=-1)                              # (B,S,di)

    conv_state = state["conv"] if state is not None else None
    conv_out = common.causal_conv1d(xi, p.conv_w, conv_state) + p.conv_b
    prev = (conv_state if conv_state is not None
            else torch.zeros((b, kk - 1, di), dtype=F32, device=x.device))
    new_conv = torch.cat([prev, xi.to(F32)], dim=1)[:, -(kk - 1):]
    xc = F.silu(conv_out.to(F32)).to(x.dtype)

    if decode:
        if s != 1:
            raise ValueError(f"mamba decode step expects seq len 1, got {s}")
        if state is None:
            raise ValueError("mamba decode step requires a state")
        da, dbx, c_mat = _ssm_params(p, xc, cfg)
        h = state["ssm"].mul_(da[:, 0]).add_(dbx[:, 0])      # in place
        y = torch.matmul(h, c_mat[:, 0, :, None])[..., 0][:, None]
        state["conv"].copy_(new_conv)
        new_state = state
    else:
        h = (state["ssm"] if state is not None
             else torch.zeros((b, di, ds), dtype=F32, device=x.device))
        cs = min(chunk, s)
        while s % cs:                                # largest divisor <= chunk
            cs -= 1
        ys = []
        for i in range(0, s, cs):
            da, dbx, c_mat = _ssm_params(p, xc[:, i:i + cs], cfg)
            y_c, h = _chunk_scan(da, dbx, c_mat, h)
            ys.append(y_c)
        y = torch.cat(ys, dim=1)
        new_state = {"ssm": h, "conv": new_conv}

    y = y + p.d_skip * xc.to(F32)
    y = (y * F.silu(z.to(F32))).to(x.dtype)
    out = common.fdot(y, p.w_out)
    return res + out, new_state
