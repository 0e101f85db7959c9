"""Attention, FFN (SwiGLU, or the audio family's LayerNorm + GELU) and MoE
layer bodies and their parameter definitions, after the reference's
``models/layers.py`` (``attn_defs``, ``_qkv``, ``attn_apply``,
``attn_cache_defs``, ``ffn_defs``, ``ffn_apply``, ``moe_defs``,
``moe_capacity``, ``moe_gather_apply``, ``moe_apply``, ``stack_defs``).

Each ``*_defs`` returns a dict of ``ParamDef`` (shape, init kind, scale,
dtype override, logical axes); the LLM defs leave the axes unnamed
(replicated), the DiT's (``models/dit.py``) carry the reference's;
``ParamGroup`` materializes one dict as the parameters of a module, so a
layer's parameters are attributes (``p.wq``) where the reference reads
``p["wq"]``.

KV caches are updated in place: the decode step writes one slot per sample
into the cache it is given and the prefill fills the (empty) cache it is
given, where the reference returns new arrays.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import common, flags
from repro_torch.models.attention import (attend_direct, attention,
                                         decode_attend)

F32 = torch.float32
# a leaf whose f32 draw is larger is drawn in slices along its first axis,
# so that initializing a full-width MoE (an (E, D, F) expert leaf of up to
# 17.8 GB in f32) does not hold the whole draw beside the parameters; no
# leaf of a dense or DiT config reaches it, so their draws are unchanged
DRAW_SLICE_BYTES = 4 << 30


class ParamDef(NamedTuple):
    shape: Tuple[int, ...]
    init: str = "normal"        # normal | zeros | ones | fan_in
    scale: float = 1.0
    dtype: Optional[str] = None  # override the model dtype (f32 norms)
    # one logical axis name (or None) per dim for the sharding rules
    # (``distributed/sharding.py``); None: unnamed, replicated
    axes: Optional[Tuple[Optional[str], ...]] = None


def stack_defs(defs, n: int):
    """Add a leading stacking dim of size n to every ParamDef of a (nested)
    dict, as the reference's ``stack_defs`` (its ``layers`` axis)."""
    if isinstance(defs, ParamDef):
        axes = None if defs.axes is None else ("layers",) + tuple(defs.axes)
        return ParamDef((n,) + tuple(defs.shape), defs.init, defs.scale,
                        defs.dtype, axes)
    return {key: stack_defs(d, n) for key, d in defs.items()}


class ParamGroup(nn.Module):
    """One dict of ParamDefs as (frozen) parameters of a module."""

    def __init__(self, defs: Dict[str, ParamDef], dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.defs = defs
        for name, d in defs.items():
            dt = torch.float32 if d.dtype == "float32" else dtype
            self.register_parameter(name, nn.Parameter(
                torch.zeros(d.shape, dtype=dt, device=device),
                requires_grad=False))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The reference's initializers (``models/params.py:init_params``):
        zeros, ones, normal with std 0.02 * scale, fan_in with std
        scale / sqrt(shape[-2]); drawn in f32, scaled in place, then cast
        (a leaf above ``DRAW_SLICE_BYTES`` of f32 in slices along axis 0)."""
        for name, d in self.defs.items():
            p = getattr(self, name)
            if d.init in ("zeros", "ones"):
                p.fill_(1.0 if d.init == "ones" else 0.0)
                continue
            if d.init == "fan_in":
                fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
                std = d.scale / fan_in ** 0.5
            else:
                std = 0.02 * d.scale
            rows = d.shape[0]
            if 4 * p.numel() > DRAW_SLICE_BYTES:
                rows = max(1, DRAW_SLICE_BYTES // (4 * p[0].numel()))
            for i in range(0, d.shape[0], rows):
                part = p[i:i + rows]
                part.copy_(torch.randn(part.shape, generator=generator,
                                       device=p.device, dtype=F32).mul_(std))


# --------------------------------------------------------------------------
# Attention layer
# --------------------------------------------------------------------------

def attn_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, h, kvh, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
    out = {
        "norm": ParamDef((d,), "ones", dtype="float32"),
        "wq": ParamDef((d, h, dh), "fan_in"),
        "wk": ParamDef((d, kvh, dh), "fan_in"),
        "wv": ParamDef((d, kvh, dh), "fan_in"),
        "wo": ParamDef((h, dh, d), "fan_in",
                       scale=1.0 / max(1, cfg.num_layers) ** 0.5),
    }
    if cfg.qk_norm:
        out["q_norm"] = ParamDef((dh,), "ones", dtype="float32")
        out["k_norm"] = ParamDef((dh,), "ones", dtype="float32")
    if cfg.is_encoder and cfg.family == "audio":      # LayerNorm's bias
        out["norm_b"] = ParamDef((d,), "zeros", dtype="float32")
    return out


def _qkv(p: ParamGroup, x: torch.Tensor, cfg: ModelConfig, positions):
    q = common.feinsum("bsd,dhk->bshk", x, p.wq)
    k = common.feinsum("bsd,dhk->bshk", x, p.wk)
    v = common.feinsum("bsd,dhk->bshk", x, p.wv)
    if cfg.qk_norm:
        q = common.rms_norm(q, p.q_norm, cfg.norm_eps)
        k = common.rms_norm(k, p.k_norm, cfg.norm_eps)
    q = common.rope_dispatch(q, positions, cfg.rope_kind, cfg.rope_theta,
                             cfg.mrope_sections)
    k = common.rope_dispatch(k, positions, cfg.rope_kind, cfg.rope_theta,
                             cfg.mrope_sections)
    return q, k, v


def _prefill_fill(cache: Dict[str, torch.Tensor], k: torch.Tensor,
                  v: torch.Tensor, pos: torch.Tensor) -> None:
    """Fill an empty (B, w, ...) layer cache from a prompt of S positions,
    as the reference's prefill does (``layers.py:116-130``): S < w pads
    with pos = -1; S >= w keeps the last w entries in the reference's
    rotation, slot j holding entry (j + shift) % w of them, shift =
    (S - w) % w (the reference's ``argsort`` of ``(arange(w) - shift) %
    w``).  That gives slot == pos % w only when 2 * shift % w == 0; the port
    keeps the reference's order."""
    s, w = k.shape[1], cache["k"].shape[1]
    kd, vd = k.to(cache["k"].dtype), v.to(cache["v"].dtype)
    if s >= w:
        shift = (s - w) % w
        inv = (torch.arange(w, device=k.device) + shift) % w
        cache["k"].copy_(kd[:, s - w:][:, inv])
        cache["v"].copy_(vd[:, s - w:][:, inv])
        cache["pos"].copy_(pos[:, s - w:][:, inv])
    else:
        cache["k"][:, :s] = kd
        cache["v"][:, :s] = vd
        cache["pos"][:, :s] = pos
        cache["k"][:, s:].zero_()
        cache["v"][:, s:].zero_()
        cache["pos"][:, s:].fill_(-1)


def attn_apply(p: ParamGroup, x: torch.Tensor, *, cfg: ModelConfig,
               positions: Optional[torch.Tensor] = None,
               cache: Optional[Dict[str, torch.Tensor]] = None,
               decode_pos: Optional[torch.Tensor] = None,
               window: int = 0, train: bool = False, prefix_groups: int = 1
               ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Pre-norm attention sublayer with residual.  ``positions`` are (B, S)
    or, under M-RoPE, the reference's (B, S, 3); the mask and the cache
    take the t axis (``[..., 0]``), as the reference's ``pos1d``: every
    full-sequence call masks by it (without ``positions``, by arange(S),
    which the kernel's implicit mode gives bit for bit).  ``prefix_groups``
    is the reference's (causal attention as that many prefix attends).

    * train:        ``cache=None, decode_pos=None, train=True`` — full
      self-attention through ``attend_direct``, which autograd
      differentiates (the ``flash_attention`` kernel has no backward; the
      reference trains on its XLA attention too).
    * encode:       ``cache=None, decode_pos=None`` — full self-attention.
    * prefill:      ``cache`` is an empty layer cache to fill, decode_pos
      None.
    * decode:       ``cache`` holds K/V; ``decode_pos`` (B,) current
      positions; this position's K/V are written at slot decode_pos % w.
    """
    if "norm_b" in p.defs:                          # the audio encoder
        h_in = common.layer_norm(x, p.norm, p.norm_b, cfg.norm_eps)
    else:
        h_in = common.rms_norm(x, p.norm, cfg.norm_eps)
    causal = not cfg.is_encoder
    if decode_pos is not None:                       # ---- decode (Sq == 1)
        if cache is None:
            raise ValueError("attention decode step (decode_pos set) "
                             "requires a KV cache; got cache=None")
        q, k, v = _qkv(p, h_in, cfg, positions)
        write_kv(cache, k, v, decode_pos)
        out = decode_attend(q, cache["k"].to(x.dtype), cache["v"].to(x.dtype),
                            decode_pos, cache["pos"])
    else:                                            # ---- full sequence
        s = x.shape[1]
        rope_pos = positions
        if rope_pos is None:
            rope_pos = torch.arange(s, device=x.device)[None]    # (1, S)
        q, k, v = _qkv(p, h_in, cfg, rope_pos)
        pos1d = rope_pos[..., 0] if rope_pos.ndim == 3 else rope_pos
        if train:
            out = attend_direct(q, k, v, pos1d, pos1d, causal=causal,
                                window=window)
        else:
            out = attention(q, k, v, None if positions is None else pos1d,
                            causal=causal, window=window,
                            prefix_groups=prefix_groups)
        if cache is not None:                        # prefill: fill the cache
            pc = pos1d.to(torch.int32).expand(x.shape[0], s)
            _prefill_fill(cache, k, v, pc)
    proj = common.feinsum("bshk,hkd->bsd", out, p.wo)
    return x + proj, cache


def write_kv(cache: Dict[str, torch.Tensor], k: torch.Tensor,
             v: torch.Tensor, decode_pos: torch.Tensor) -> None:
    """Write one position's K/V (B, 1, KVH, dh) per sample at slot
    decode_pos % w of the (B, w, ...) layer cache, in place."""
    w = cache["k"].shape[1]
    slot = decode_pos.long() % w                     # (B,)
    bidx = torch.arange(k.shape[0], device=k.device)
    cache["k"][bidx, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, slot] = v[:, 0].to(cache["v"].dtype)
    cache["pos"][bidx, slot] = decode_pos.to(cache["pos"].dtype)


def attn_cache_defs(cfg: ModelConfig, batch: int,
                    window: int) -> Dict[str, ParamDef]:
    """One layer's cache: K/V in the model dtype, pos int32 (the empty
    cache has pos = -1, set by ``TransformerModel.init_cache``)."""
    kvh, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    return {"k": ParamDef((batch, window, kvh, dh), "zeros"),
            "v": ParamDef((batch, window, kvh, dh), "zeros"),
            "pos": ParamDef((batch, window), "zeros", dtype="int32")}


# --------------------------------------------------------------------------
# Dense FFN (SwiGLU, or LayerNorm + GELU for the audio family)
# --------------------------------------------------------------------------

def ffn_defs(cfg: ModelConfig, kind: str = "swiglu") -> Dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.d_ff
    out_scale = 1.0 / max(1, cfg.num_layers) ** 0.5
    out = {"norm": ParamDef((d,), "ones", dtype="float32")}
    if kind == "swiglu":
        out.update({
            "w_gate": ParamDef((d, f), "fan_in"),
            "w_up": ParamDef((d, f), "fan_in"),
            "w_down": ParamDef((f, d), "fan_in", scale=out_scale),
        })
    else:                                            # gelu
        out.update({
            "norm_b": ParamDef((d,), "zeros", dtype="float32"),
            "w_in": ParamDef((d, f), "fan_in"),
            "b_in": ParamDef((f,), "zeros"),
            "w_out": ParamDef((f, d), "fan_in", scale=out_scale),
            "b_out": ParamDef((d,), "zeros"),
        })
    return out


def ffn_apply(p: ParamGroup, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU after RMSNorm, or, where the layer has ``w_in``, the tanh-GELU
    MLP (biases added in the model dtype) after LayerNorm."""
    if "w_in" in p.defs:
        h = common.layer_norm(x, p.norm, p.norm_b, cfg.norm_eps)
        return x + common.gelu_mlp(h, p.w_in, p.b_in, p.w_out, p.b_out)
    h = common.rms_norm(x, p.norm, cfg.norm_eps)
    return x + common.swiglu(h, p.w_gate, p.w_up, p.w_down)


# --------------------------------------------------------------------------
# Mixture of Experts
# --------------------------------------------------------------------------

def moe_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    m = cfg.moe
    if m is None:
        raise ValueError(f"{cfg.name}: moe block requested but cfg.moe is "
                         "None")
    d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
    out = {
        "norm": ParamDef((d,), "ones", dtype="float32"),
        "router": ParamDef((d, e), "fan_in", dtype="float32"),
        "we_gate": ParamDef((e, d, f), "fan_in"),
        "we_up": ParamDef((e, d, f), "fan_in"),
        "we_down": ParamDef((e, f, d), "fan_in",
                            scale=1.0 / max(1, cfg.num_layers) ** 0.5),
    }
    if m.num_shared_experts:
        fs = f * m.num_shared_experts
        out.update({
            "ws_gate": ParamDef((d, fs), "fan_in"),
            "ws_up": ParamDef((d, fs), "fan_in"),
            "ws_down": ParamDef((fs, d), "fan_in"),
        })
    if m.dense_ff_parallel:
        fd = m.dense_ff_parallel
        out.update({
            "wd_gate": ParamDef((d, fd), "fan_in"),
            "wd_up": ParamDef((d, fd), "fan_in"),
            "wd_down": ParamDef((fd, d), "fan_in"),
        })
    return out


def moe_capacity(m: MoEConfig, tokens: int) -> int:
    c = int(m.capacity_factor * m.top_k * tokens / m.num_experts)
    return max(m.min_capacity, c)


def _route(p: ParamGroup, xt: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The f32 router: (probs (T, E), top_w (T, k) normalized, top_i (T, k)).
    The top k by a stable descending sort, so tied probabilities go to the
    lower expert id first, as ``lax.top_k`` breaks ties."""
    logits = torch.matmul(xt.to(F32), p.router)              # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :k], top_i[:, :k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return probs, top_w, top_i


def _aux_loss(m: MoEConfig, probs: torch.Tensor,
              top_i: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balancing loss: E * sum(frac_tokens * frac_probs)
    * weight, frac_tokens the share of tokens whose first choice is each
    expert (counted by ``index_add_``: no one-hot, no host sync)."""
    t, e = probs.shape
    first = torch.zeros((e,), dtype=F32, device=probs.device)
    first.index_add_(0, top_i[:, 0], torch.ones((t,), dtype=F32,
                                                device=probs.device))
    frac_tokens = first / t
    frac_probs = probs.mean(dim=0)
    return e * torch.sum(frac_tokens * frac_probs) * m.router_aux_weight


def _dense_branches(p: ParamGroup, m: MoEConfig, h: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """The shared experts (Kimi) and the parallel dense FFN (Arctic) on the
    normed tokens h (T, D), added to the routed output y."""
    if m.num_shared_experts:
        y = y + common.swiglu(h, p.ws_gate, p.ws_up, p.ws_down)
    if m.dense_ff_parallel:
        y = y + common.swiglu(h, p.wd_gate, p.wd_up, p.wd_down)
    return y


def moe_gather_apply(p: ParamGroup, x: torch.Tensor, cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode-path MoE: gather the top-k experts' weights per token and run
    per-token GEMVs, no capacity padding.  Materializes (T, k, D, F) weight
    copies.  Returns (residual-added output, aux load loss)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    h = common.rms_norm(x, p.norm, cfg.norm_eps)
    xt = h.reshape(t, d)
    probs, top_w, top_i = _route(p, xt, m.top_k)
    wg = p.we_gate[top_i]                                    # (T,k,D,F)
    wu = p.we_up[top_i]
    wd = p.we_down[top_i]                                    # (T,k,F,D)
    g = common.feinsum("td,tkdf->tkf", xt, wg)
    u = common.feinsum("td,tkdf->tkf", xt, wu)
    act = F.silu(g.to(F32)).to(x.dtype) * u
    out = common.feinsum("tkf,tkfd->tkd", act, wd)           # (T,k,D)
    y = torch.einsum("tkd,tk->td", out.to(F32), top_w).to(x.dtype)
    aux = _aux_loss(m, probs, top_i)
    y = _dense_branches(p, m, xt, y)
    return x + y.reshape(b, s, d), aux


def moe_apply(p: ParamGroup, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based top-k dispatch (scatter, not a one-hot product) with
    the experts' GEMMs as batched products over E.  Returns (residual-added
    output, aux load loss).

    Each expert takes up to ``moe_capacity`` copies (token, choice); the
    copies are ranked within their expert by a stable sort of the expert
    ids, so the earliest keep the slots and the rest go to a dump row that
    is thrown away, as in the reference.  The dump row takes duplicate
    writes (their winner is unspecified and unused); every kept slot is
    written once.  No step reads a value back to the host."""
    m = cfg.moe
    if m is None:
        raise ValueError(f"{cfg.name}: moe block requested but cfg.moe is "
                         "None")
    b, s, d = x.shape
    t = b * s
    k, e = m.top_k, m.num_experts
    if flags.MOE_GATHER_DECODE and t * k <= e:
        return moe_gather_apply(p, x, cfg)
    cap = moe_capacity(m, t)

    h = common.rms_norm(x, p.norm, cfg.norm_eps)
    xt = h.reshape(t, d)
    probs, top_w, top_i = _route(p, xt, k)

    # ---- slot assignment: a copy's slot is its rank within its expert's
    # run of the stably sorted expert ids
    dev = x.device
    flat_e = top_i.reshape(t * k)                            # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(e, device=dev))
    slot_sorted = torch.arange(t * k, device=dev) - starts[sorted_e]
    flat_slot = torch.empty_like(slot_sorted)
    flat_slot[order] = slot_sorted
    valid = flat_slot < cap
    dump = torch.where(valid, flat_slot, cap)                # overflow slot

    # ---- dispatch: scatter the copies into (E, cap + 1, D)
    xk = xt[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf = torch.zeros((e, cap + 1, d), dtype=x.dtype, device=dev)
    buf[flat_e, dump] = xk
    buf = buf[:, :cap]

    # ---- expert GEMMs, batched over E
    g = torch.bmm(buf, p.we_gate)                            # (E, cap, F)
    u = torch.bmm(buf, p.we_up)
    act = F.silu(g.to(F32)).to(x.dtype) * u
    out_e = F.pad(torch.bmm(act, p.we_down), (0, 0, 0, 1))   # dump slot = 0

    # ---- combine with the f32 weights
    gathered = out_e[flat_e, dump] * valid[:, None].to(x.dtype)
    y = torch.einsum("tkd,tk->td", gathered.reshape(t, k, d).to(F32),
                     top_w).to(x.dtype)
    aux = _aux_loss(m, probs, top_i)
    y = _dense_branches(p, m, xt, y)
    return x + y.reshape(b, s, d), aux
