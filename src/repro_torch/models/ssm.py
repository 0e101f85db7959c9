"""xLSTM blocks: chunkwise-parallel mLSTM (matrix memory, exponential
gating) and recurrent sLSTM (scalar memory, per-head recurrence)
[arXiv:2405.04517], after the reference's ``models/ssm.py``.

The mLSTM prefill runs in its chunkwise-parallel form: intra-chunk terms
are dense (c x c) matmuls, the inter-chunk state is carried by a loop over
the S/c chunks.  Its decode is the recurrent single-step form, which
updates the (B, H, dh, dh) matrix memory of a given state in place (a
scale and one rank-1 ``baddbmm_``).  The sLSTM scans the prompt token by
token, as the reference does.  All state math is in f32 with running-max
stabilization; no step reads a value back to the host.  The two sequence
forms (``mlstm_sequence``, the sLSTM's token loop) build new tensors at
every step, so autograd differentiates them as they are (training); only
the decode steps update a state in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.layers import ParamDef, ParamGroup

F32 = torch.float32
State = Dict[str, torch.Tensor]
MState = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]   # C, n, m


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------

def mlstm_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d = cfg.d_model
    inner = int(cfg.ssm.proj_factor * d)
    h = cfg.num_heads
    k = cfg.ssm.conv_kernel
    return {
        "norm": ParamDef((d,), "ones", dtype="float32"),
        "w_up": ParamDef((d, 2 * inner), "fan_in"),
        "conv_w": ParamDef((k, inner), "fan_in"),
        "wq": ParamDef((inner, inner), "fan_in"),
        "wk": ParamDef((inner, inner), "fan_in"),
        "wv": ParamDef((inner, inner), "fan_in"),
        "w_igate": ParamDef((inner, h), "fan_in", dtype="float32"),
        "b_igate": ParamDef((h,), "zeros", dtype="float32"),
        "w_fgate": ParamDef((inner, h), "fan_in", dtype="float32"),
        "b_fgate": ParamDef((h,), "ones", dtype="float32"),
        "out_norm": ParamDef((inner,), "ones", dtype="float32"),
        "w_down": ParamDef((inner, d), "fan_in",
                           scale=1.0 / max(1, cfg.num_layers) ** 0.5),
    }


def mlstm_state_defs(cfg: ModelConfig, batch: int) -> Dict[str, ParamDef]:
    inner = int(cfg.ssm.proj_factor * cfg.d_model)
    h = cfg.num_heads
    dh = inner // h
    k = cfg.ssm.conv_kernel
    return {
        "C": ParamDef((batch, h, dh, dh), "zeros", dtype="float32"),
        "n": ParamDef((batch, h, dh), "zeros", dtype="float32"),
        "m": ParamDef((batch, h), "zeros", dtype="float32"),
        "conv": ParamDef((batch, k - 1, inner), "zeros", dtype="float32"),
    }


def _mlstm_chunk(q, k, v, li, lf, state: MState):
    """One chunk. q,k,v: (B,H,c,dh) f32; li,lf: (B,H,c) log-gates f32;
    state: (C (B,H,dh,dh), n (B,H,dh), m (B,H))."""
    c0, n0, m0 = state
    dh = q.shape[-1]
    c = q.shape[2]
    fcum = torch.cumsum(lf, dim=-1)                    # (B,H,c) inclusive
    g_total = fcum[..., -1]

    # log weight of source s for target t (s <= t): fcum_t - fcum_s + li_s
    log_w = (fcum[..., :, None] - fcum[..., None, :]
             + li[..., None, :])                       # (B,H,c,c)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    log_w = torch.where(tri, log_w, -torch.inf)
    m_intra = log_w.amax(dim=-1)                       # (B,H,c)
    m_inter = fcum + m0[..., None]
    m_t = torch.maximum(m_intra, m_inter)              # (B,H,c)
    m_t = torch.clamp(m_t, min=-1e30)                  # guard -inf

    d_mat = torch.exp(log_w - m_t[..., None])
    d_mat = torch.where(tri, d_mat, 0.0)               # (B,H,c,c)
    scale = dh ** -0.5                             # k-scaling (xLSTM conv.)
    ks = k * scale
    s_qk = torch.matmul(q, ks.transpose(-1, -2)) * d_mat
    h_intra = torch.matmul(s_qk, v)
    n_intra = torch.matmul(d_mat, ks)                  # sum of weighted k
    w_inter = torch.exp(m_inter - m_t)                 # (B,H,c)
    h_inter = torch.matmul(q, c0) * w_inter[..., None]
    n_inter = n0[..., None, :] * w_inter[..., None]

    num = h_intra + h_inter
    nvec = n_intra + n_inter                           # (B,H,c,dh)
    denom = torch.maximum((q * nvec).sum(dim=-1).abs(), torch.exp(-m_t))
    h_out = num / denom[..., None]

    # ---- state update to end of chunk
    lw_end = g_total[..., None] - fcum + li            # (B,H,c)
    m_next = torch.maximum(g_total + m0, lw_end.amax(dim=-1))
    w_end = torch.exp(lw_end - m_next[..., None])      # (B,H,c)
    decay = torch.exp(g_total + m0 - m_next)           # (B,H)
    kw = w_end[..., None] * ks                         # (B,H,c,dh)
    c_next = (c0 * decay[..., None, None]
              + torch.matmul(kw.transpose(-1, -2), v))
    n_next = (n0 * decay[..., None]
              + torch.matmul(w_end[..., None, :], ks)[..., 0, :])
    return h_out, (c_next, n_next, m_next)


def mlstm_sequence(q, k, v, li, lf, state: MState, chunk: int):
    """q,k,v: (B,S,H,dh); li,lf: (B,S,H). Returns h (B,S,H,dh), state."""
    b, s, h, dh = q.shape
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")

    def heads_first(x):                                # (B,H,S,...) f32
        return x.to(F32).transpose(1, 2)

    qs, ks, vs = heads_first(q), heads_first(k), heads_first(v)
    lis, lfs = heads_first(li), heads_first(lf)
    hs = []
    for i in range(0, s, chunk):
        sl = slice(i, i + chunk)
        h_out, state = _mlstm_chunk(qs[:, :, sl], ks[:, :, sl], vs[:, :, sl],
                                    lis[:, :, sl], lfs[:, :, sl], state)
        hs.append(h_out)
    return torch.cat(hs, dim=2).transpose(1, 2), state


def mlstm_step(q, k, v, li, lf, state: MState):
    """Single recurrent step. q,k,v: (B,H,dh) f32; li,lf: (B,H).  The
    state's C, n and m (contiguous) are updated in place and returned."""
    c0, n0, m0 = state
    b, h, dh = q.shape
    scale = dh ** -0.5
    m_new = torch.maximum(lf + m0, li)
    fg = torch.exp(lf + m0 - m_new)
    ig = torch.exp(li - m_new)
    ks = k * scale
    c1 = c0.mul_(fg[..., None, None])
    c1.view(b * h, dh, dh).baddbmm_(
        (ig[..., None] * ks).reshape(b * h, dh, 1),
        v.reshape(b * h, 1, dh))                       # + ig k v^T
    n1 = n0.mul_(fg[..., None]).add_(ig[..., None] * ks)
    m1 = m0.copy_(m_new)
    denom = torch.maximum((q * n1).sum(dim=-1).abs(), torch.exp(-m_new))
    out = torch.matmul(q[..., None, :], c1)[..., 0, :] / denom[..., None]
    return out, (c1, n1, m1)


def _mlstm_qkv_gates(p: ParamGroup, x: torch.Tensor, cfg: ModelConfig,
                     conv_state: Optional[torch.Tensor] = None):
    """Shared pre-processing: up-proj, conv, heads, gates.

    x: (B,S,D). Returns q,k,v (B,S,H,dh), li,lf (B,S,H) f32, z (B,S,inner),
    new conv state (B,K-1,inner) f32."""
    inner = p.conv_w.shape[1]
    up = common.fdot(x, p.w_up)
    xi, z = up.chunk(2, dim=-1)
    kk = cfg.ssm.conv_kernel
    conv_out = common.causal_conv1d(xi, p.conv_w, conv_state)
    prev = (conv_state if conv_state is not None
            else torch.zeros(xi.shape[:1] + (kk - 1,) + xi.shape[2:],
                             dtype=F32, device=x.device))
    new_conv = torch.cat([prev, xi.to(F32)], dim=1)[:, -(kk - 1):]
    xc = F.silu(conv_out.to(F32)).to(x.dtype)
    h = cfg.num_heads
    b, s = x.shape[:2]

    def heads(t):
        return t.reshape(b, s, h, inner // h)

    q = heads(common.fdot(xc, p.wq))
    k = heads(common.fdot(xc, p.wk))
    v = heads(common.fdot(xi, p.wv))
    xc32 = xc.to(F32)
    li = torch.matmul(xc32, p.w_igate) + p.b_igate
    lf = F.logsigmoid(torch.matmul(xc32, p.w_fgate) + p.b_fgate)
    return q, k, v, li, lf, z, new_conv


def mlstm_apply(p: ParamGroup, x: torch.Tensor, *, cfg: ModelConfig,
                state: Optional[State] = None, decode: bool = False
                ) -> Tuple[torch.Tensor, State]:
    """Pre-norm mLSTM block with residual. state: see mlstm_state_defs.
    With ``decode`` the step updates ``state``'s tensors in place and
    returns them; else the state after the sequence is new tensors."""
    res = x
    xn = common.rms_norm(x, p.norm, cfg.norm_eps)
    conv_state = state["conv"] if state is not None else None
    q, k, v, li, lf, z, new_conv = _mlstm_qkv_gates(p, xn, cfg, conv_state)
    b, s = x.shape[:2]
    h = cfg.num_heads
    inner = p.conv_w.shape[1]
    dh = inner // h
    if state is not None:
        st = (state["C"], state["n"], state["m"])
    else:
        st = (torch.zeros((b, h, dh, dh), dtype=F32, device=x.device),
              torch.zeros((b, h, dh), dtype=F32, device=x.device),
              torch.zeros((b, h), dtype=F32, device=x.device))
    if decode:
        if s != 1:
            raise ValueError(f"mlstm decode step expects seq len 1, got {s}")
        if state is None:
            raise ValueError("mlstm decode step requires a state")
        hs, st = mlstm_step(q[:, 0].to(F32), k[:, 0].to(F32),
                            v[:, 0].to(F32), li[:, 0], lf[:, 0], st)
        hs = hs[:, None]                               # (B,1,H,dh)
        state["conv"].copy_(new_conv)
        new_state = state
    else:
        chunk = min(cfg.ssm.chunk_size, s)
        while s % chunk:                             # largest divisor <= chunk
            chunk -= 1
        hs, st = mlstm_sequence(q, k, v, li, lf, st, chunk)
        new_state = {"C": st[0], "n": st[1], "m": st[2], "conv": new_conv}
    hs = hs.reshape(b, s, inner)
    hs = common.rms_norm(hs.to(x.dtype), p.out_norm, cfg.norm_eps)
    out = hs * F.silu(z.to(F32)).to(x.dtype)
    out = common.fdot(out, p.w_down)
    return res + out, new_state


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------

def slstm_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d = cfg.d_model
    h = cfg.num_heads
    dh = d // h
    ff = int(4 * d / 3 + 63) // 64 * 64
    return {
        "norm": ParamDef((d,), "ones", dtype="float32"),
        # gates order: z, i, f, o (per head)
        "w_gates": ParamDef((d, 4 * d), "fan_in", dtype="float32"),
        "r_gates": ParamDef((h, dh, 4 * dh), "fan_in", dtype="float32"),
        "b_gates": ParamDef((4 * d,), "zeros", dtype="float32"),
        "out_norm": ParamDef((d,), "ones", dtype="float32"),
        "w_out": ParamDef((d, d), "fan_in"),
        # post-FFN
        "ffn_norm": ParamDef((d,), "ones", dtype="float32"),
        "w_ff_in": ParamDef((d, ff), "fan_in"),
        "w_ff_out": ParamDef((ff, d), "fan_in",
                             scale=1.0 / max(1, cfg.num_layers) ** 0.5),
    }


def slstm_state_defs(cfg: ModelConfig, batch: int) -> Dict[str, ParamDef]:
    d, h = cfg.d_model, cfg.num_heads
    dh = d // h
    return {name: ParamDef((batch, h, dh), "zeros", dtype="float32")
            for name in ("c", "n", "m", "h")}


def _slstm_cell(p: ParamGroup, xw: torch.Tensor, state):
    """xw: (B, 4D) input contribution (pre-computed). state: (c,n,m,h)."""
    c0, n0, m0, h0 = state
    b = xw.shape[0]
    hh, dh = h0.shape[1], h0.shape[2]
    rec = torch.matmul(h0.transpose(0, 1), p.r_gates).transpose(0, 1)
    gates = xw.reshape(b, hh, 4 * dh) + rec            # (B,H,4dh)
    z, i_raw, f_raw, o_raw = gates.chunk(4, dim=-1)    # (B,H,dh) each
    z = torch.tanh(z)
    o = torch.sigmoid(o_raw)
    m_new = torch.maximum(f_raw + m0, i_raw)
    ig = torch.exp(i_raw - m_new)
    fg = torch.exp(f_raw + m0 - m_new)
    c1 = fg * c0 + ig * z
    n1 = torch.maximum(fg * n0 + ig, torch.exp(-m_new))
    h1 = o * c1 / n1
    return (c1, n1, m_new, h1)


def slstm_apply(p: ParamGroup, x: torch.Tensor, *, cfg: ModelConfig,
                state: Optional[State] = None, decode: bool = False
                ) -> Tuple[torch.Tensor, State]:
    """Pre-norm sLSTM block with residual and its post-FFN (tanh GELU).
    With ``decode`` the step writes the new state into ``state``'s tensors
    and returns them; else the state after the sequence is new tensors."""
    res = x
    b, s, d = x.shape
    h, dh = cfg.num_heads, d // cfg.num_heads
    xn = common.rms_norm(x, p.norm, cfg.norm_eps)
    xw = torch.matmul(xn.to(F32), p.w_gates) + p.b_gates    # (B,S,4D)
    if state is not None:
        st = (state["c"], state["n"], state["m"], state["h"])
    else:
        z0 = torch.zeros((b, h, dh), dtype=F32, device=x.device)
        st = (z0, z0, z0, z0)

    if decode:
        if s != 1:
            raise ValueError(f"slstm decode step expects seq len 1, got {s}")
        if state is None:
            raise ValueError("slstm decode step requires a state")
        st = _slstm_cell(p, xw[:, 0], st)
        for name, t in zip(("c", "n", "m", "h"), st):
            state[name].copy_(t)
        hs = st[3][:, None]                                  # (B,1,H,dh)
        new_state = state
    else:
        outs = []
        for t in range(s):
            st = _slstm_cell(p, xw[:, t], st)
            outs.append(st[3])
        hs = torch.stack(outs, dim=1)                        # (B,S,H,dh)
        new_state = dict(zip(("c", "n", "m", "h"), st))

    hs = hs.reshape(b, s, d).to(x.dtype)
    hs = common.rms_norm(hs, p.out_norm, cfg.norm_eps)
    out = common.fdot(hs, p.w_out)
    x = res + out
    # post-FFN (GeLU)
    hf = common.rms_norm(x, p.ffn_norm, cfg.norm_eps)
    hf = F.gelu(common.fdot(hf, p.w_ff_in).to(F32),
                approximate="tanh").to(x.dtype)
    x = x + common.fdot(hf, p.w_ff_out)
    return x, new_state
