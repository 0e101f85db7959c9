"""Attention, FFN (SwiGLU, or the audio family's LayerNorm + GELU) and MoE
layer bodies and their parameter definitions, after the reference's
``models/layers.py`` (``attn_defs``, ``_qkv``, ``attn_apply``,
``attn_cache_defs``, ``ffn_defs``, ``ffn_apply``, ``moe_defs``,
``moe_capacity``, ``moe_gather_apply``, ``moe_apply``, ``stack_defs``).

Each ``*_defs`` returns a dict of ``ParamDef`` (``models/params.py``:
shape, init kind, scale, dtype override and the reference's logical axes,
which ``distributed/sharding.py`` maps onto a mesh); ``ParamGroup``
materializes one dict as the parameters of a module, so a layer's
parameters are attributes (``p.wq``) where the reference reads
``p["wq"]``.

KV caches are updated in place: the decode step writes one slot per sample
into the cache it is given and the prefill fills the (empty) cache it is
given, where the reference returns new arrays.

Sharded training (``training/sharded.py``).  A model cut onto a mesh holds
this rank's block of every parameter and each ``ParamGroup`` its specs;
under ``collectives.active(mesh)`` a layer first gathers its weights over
the FSDP axes (``gathered``: every mesh axis but ``model``; the gradients
are reduce-scattered back), then runs tensor- and expert-parallel over
``model`` where a weight's dim is cut over it: ``wq`` (and ``wk`` / ``wv``
when the kv heads divide) and the FFN's and the MoE's dense branches'
input projections column-parallel, ``wo`` and the down projections
row-parallel (the f32 partial products summed over ``model``, rounded
once), the experts expert-parallel (every rank routes all of its data
rank's tokens and runs its own experts, the combine summed over
``model``).  A replicated tensor enters a tensor-parallel region through
``collectives.reduce_backward``, so every replicated parameter's gradient
is whole on every model rank.  A dim that is not cut runs whole on every
rank.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.distributed import collectives
from repro_torch.distributed.collectives import (reduce_backward,
                                                 reduce_forward)
from repro_torch.models import common, flags
from repro_torch.models.attention import (NEG_INF, attend_direct,
                                         attention, decode_attend)
from repro_torch.models.params import ParamDef

F32 = torch.float32
# when a list, each capacity dispatch appends its copies' kept flags (T*k,
# on the CPU; a sync on the card): the tests' view of which copies drop
MOE_TRACE: Optional[list] = None
# a leaf whose f32 draw is larger is drawn in slices along its first axis,
# so that initializing a full-width MoE (an (E, D, F) expert leaf of up to
# 17.8 GB in f32) does not hold the whole draw beside the parameters; no
# leaf of a dense or DiT config reaches it, so their draws are unchanged
DRAW_SLICE_BYTES = 4 << 30


def stack_defs(defs, n: int):
    """Add a leading stacking dim of size n to every ParamDef of a (nested)
    dict, as the reference's ``stack_defs`` (its ``layers`` axis)."""
    if isinstance(defs, ParamDef):
        axes = None if defs.axes is None else ("layers",) + tuple(defs.axes)
        return ParamDef((n,) + tuple(defs.shape), defs.init, defs.scale,
                        defs.dtype, axes)
    return {key: stack_defs(d, n) for key, d in defs.items()}


@torch.no_grad()
def draw(d: ParamDef, p: torch.Tensor, generator: torch.Generator) -> None:
    """Fill ``p`` (of ``d``'s shape) by the reference's initializer
    (``models/params.py:init_params``): zeros, ones, normal with std
    0.02 * scale, fan_in with std scale / sqrt(shape[-2]); drawn in f32,
    scaled in place, then cast (a leaf above ``DRAW_SLICE_BYTES`` of f32
    in slices along axis 0)."""
    if d.init in ("zeros", "ones"):
        p.fill_(1.0 if d.init == "ones" else 0.0)
        return
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


class ParamGroup(nn.Module):
    """One dict of ParamDefs as (frozen) parameters of a module.  ``specs``
    (None until a mesh cuts the group, ``training/sharded.py``) holds each
    parameter's spec; the parameters are then this rank's blocks."""

    def __init__(self, defs: Dict[str, ParamDef], dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.defs = defs
        self.specs: Optional[Dict[str, tuple]] = None
        for name, d in defs.items():
            dt = torch.float32 if d.dtype == "float32" else dtype
            self.register_parameter(name, nn.Parameter(
                torch.zeros(d.shape, dtype=dt, device=device),
                requires_grad=False))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """Every parameter by the reference's initializer (``draw``)."""
        for name, d in self.defs.items():
            draw(d, getattr(self, name), generator)

    def cut(self, name: str, dim: int) -> bool:
        """Whether dim ``dim`` of parameter ``name`` is cut over ``model``."""
        if self.specs is None:
            return False
        axes = self.specs[name][dim]
        return axes == "model" or (isinstance(axes, tuple)
                                   and "model" in axes)


def fsdp_axes(axes) -> Tuple[str, ...]:
    """The FSDP axes of one spec entry (every mesh axis but ``model``);
    an entry may not mix them with ``model``."""
    names = () if axes is None else ((axes,) if isinstance(axes, str)
                                     else tuple(axes))
    out = tuple(a for a in names if a != "model")
    if out and len(out) != len(names):
        raise ValueError(f"spec entry {axes} mixes model and FSDP axes")
    return out


class _Gathered:
    """A cut ``ParamGroup``'s parameters with their FSDP cuts gathered over
    the mesh (``collectives.gather_forward``: the gradients come back
    reduce-scattered); the model cuts stay."""

    def __init__(self, p: ParamGroup, mesh: collectives.MeshComms):
        self.defs, self.specs = p.defs, p.specs
        for name in p.defs:
            t = getattr(p, name)
            for dim, axes in enumerate(p.specs[name]):
                fsdp = fsdp_axes(axes)
                if fsdp:
                    t = collectives.gather_forward(t, mesh.comm(fsdp), dim)
            setattr(self, name, t)

    cut = ParamGroup.cut


def gathered(p: ParamGroup):
    """``p`` as a layer uses it: under an active mesh, its weights
    gathered over the FSDP axes; else ``p`` itself."""
    mesh = collectives.current()
    if mesh is None or p.specs is None:
        return p
    return _Gathered(p, mesh)


def _tp(p, name: str, dim: int) -> Optional[collectives.Comm]:
    """The model group, when the active mesh's ``model`` axis is wider than
    one rank and cuts dim ``dim`` of ``p``'s parameter ``name``."""
    mesh = collectives.current()
    if mesh is None or not p.cut(name, dim):
        return None
    return mesh.comm(("model",))


def row_parallel(x: torch.Tensor, w: torch.Tensor,
                 tp: Optional[collectives.Comm]) -> torch.Tensor:
    """``x @ w`` in x's dtype (``common.fdot``).  With ``tp``, w holds this
    rank's rows (x this rank's columns): the f32 partial product is summed
    over the model group and rounded once."""
    if tp is None:
        return common.fdot(x, w)
    return reduce_forward(torch.matmul(x.to(F32), w.to(F32)),
                          tp).to(x.dtype)


def fused_halves(x: torch.Tensor, w: torch.Tensor,
                 tp: Optional[collectives.Comm]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two halves of ``x @ w`` for a fused (D, 2N) projection split
    right after its product (Mamba's ``w_in``, the mLSTM's ``w_up``).
    With ``tp`` the 2N columns are cut contiguously over ``model``, so a
    rank's block is not its block of each half (on two ranks, rank 0 holds
    the whole first half): each rank takes the product on its columns
    (x entering through ``reduce_backward``) and an all-to-all over
    ``model`` hands every column to the rank whose channels it is
    (``_halves_exchange``).  The halves are this rank's N / model
    columns of each."""
    if tp is None:
        return common.fdot(x, w).chunk(2, dim=-1)
    y = common.fdot(reduce_backward(x, tp), w)
    order, send, recv = _halves_exchange(w.shape[1], tp.size, tp.rank)
    if order is not None:
        y = y[..., order]
    return collectives.all_to_all(y, tp, y.ndim - 1, send,
                                  recv).chunk(2, dim=-1)


@functools.lru_cache(maxsize=None)
def _halves_exchange(block: int, ranks: int, rank: int):
    """The all-to-all of ``fused_halves`` for a rank holding columns
    ``rank * block`` on of a fused 2N = ranks * block: global column j is
    channel j mod N of its half, owned by rank (j mod N) // (N / ranks).
    Returns (the order that groups this rank's columns by their owner,
    None when they are grouped already; the counts it sends to each rank;
    the counts each rank sends to it).  The columns that reach a rank
    come in global order, so its first half's block, then its second's."""
    c = block // 2
    n = c * ranks
    owner = (torch.arange(2 * n) % n) // c
    mine = owner[rank * block:(rank + 1) * block]
    order = torch.argsort(mine, stable=True)
    send = torch.bincount(mine, minlength=ranks).tolist()
    recv = (owner.view(ranks, block) == rank).sum(dim=1).tolist()
    if torch.equal(order, torch.arange(block)):
        order = None
    return order, tuple(send), tuple(recv)


# --------------------------------------------------------------------------
# Attention layer
# --------------------------------------------------------------------------

def attn_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, h, kvh, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
    out = {
        "norm": ParamDef((d,), "ones", dtype="float32", axes=("embed",)),
        "wq": ParamDef((d, h, dh), "fan_in",
                       axes=("embed", "heads", "head_dim")),
        "wk": ParamDef((d, kvh, dh), "fan_in",
                       axes=("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((d, kvh, dh), "fan_in",
                       axes=("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((h, dh, d), "fan_in",
                       scale=1.0 / max(1, cfg.num_layers) ** 0.5,
                       axes=("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        out["q_norm"] = ParamDef((dh,), "ones", dtype="float32",
                                 axes=("head_dim",))
        out["k_norm"] = ParamDef((dh,), "ones", dtype="float32",
                                 axes=("head_dim",))
    if cfg.is_encoder and cfg.family == "audio":      # LayerNorm's bias
        out["norm_b"] = ParamDef((d,), "zeros", dtype="float32",
                                 axes=("embed",))
    return out


def _qkv(p, x: torch.Tensor, cfg: ModelConfig, positions,
         tp: Optional[collectives.Comm] = None, whole_kv: bool = False):
    """q, k, v of the normed input x.  With ``tp`` (``wq`` cut over
    ``model``), on this rank's q heads: ``wq`` column-parallel, and
    ``wk`` / ``wv`` alike when the kv heads are cut too; with those
    replicated (they do not divide ``model``), every rank projects all kv
    heads from the replicated input and each local q head takes its own,
    kv head ``i // (H // KVH)`` for global q head i, as ``attend_direct``'s
    grouping does (the gradient of the whole k and v summed over
    ``model``).  The qk-norm weights then act on local heads, so their
    gradients are summed over ``model`` too.  ``tp`` None is the
    single-device projection.  ``whole_kv`` (no gradient: a prefill or a
    decode step) also returns k and v of every kv head, gathered over
    ``model`` where they are cut: (q, k, v, k_all, v_all)."""
    kv_cut = tp is None or p.cut("wk", 1)
    hq = reduce_backward(x, tp)
    hk = hq if kv_cut else x
    q = common.feinsum("bsd,dhk->bshk", hq, p.wq)
    k = common.feinsum("bsd,dhk->bshk", hk, p.wk)
    v = common.feinsum("bsd,dhk->bshk", hk, p.wv)
    if cfg.qk_norm:
        q = common.rms_norm(q, reduce_backward(p.q_norm, tp), cfg.norm_eps)
        k_norm = reduce_backward(p.k_norm, tp) if kv_cut else p.k_norm
        k = common.rms_norm(k, k_norm, cfg.norm_eps)
    q = common.rope_dispatch(q, positions, cfg.rope_kind, cfg.rope_theta,
                             cfg.mrope_sections)
    k = common.rope_dispatch(k, positions, cfg.rope_kind, cfg.rope_theta,
                             cfg.mrope_sections)
    k_all, v_all = k, v
    if tp is not None and kv_cut and whole_kv:
        k_all, v_all = tp.all_gather(k, 2), tp.all_gather(v, 2)
    if not kv_cut:
        hl = q.shape[2]
        group = cfg.num_heads // cfg.num_kv_heads
        idx = (tp.rank * hl + torch.arange(hl, device=q.device)) // group
        k = reduce_backward(k, tp)[:, :, idx]
        v = reduce_backward(v, tp)[:, :, idx]
    if whole_kv:
        return q, k, v, k_all, v_all
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

    Under an active mesh whose ``model`` axis cuts the heads, every mode
    runs on this rank's q heads (``_qkv``) and ``wo`` row-parallel; a
    prefill fills its cache with every kv head (the prefill rules leave
    the cache's kv heads and slots whole); a decode step on a cache whose
    slots are cut (the mesh's ``kv_axes``) runs ``decode_attend_cut``.
    """
    if "norm_b" in p.defs:                          # the audio encoder
        h_in = common.layer_norm(x, p.norm, p.norm_b, cfg.norm_eps)
    else:
        h_in = common.rms_norm(x, p.norm, cfg.norm_eps)
    causal = not cfg.is_encoder
    tp = _tp(p, "wq", 1)
    if decode_pos is not None:                       # ---- decode (Sq == 1)
        if cache is None:
            raise ValueError("attention decode step (decode_pos set) "
                             "requires a KV cache; got cache=None")
        mesh = collectives.current()
        if mesh is None:
            q, k, v = _qkv(p, h_in, cfg, positions)
            write_kv(cache, k, v, decode_pos)
            out = decode_attend(q, cache["k"].to(x.dtype),
                                cache["v"].to(x.dtype), decode_pos,
                                cache["pos"])
        else:
            q, _, _, k, v = _qkv(p, h_in, cfg, positions, tp, whole_kv=True)
            out = decode_attend_cut(q, k, v, cache, decode_pos, tp,
                                    mesh.comm(mesh.kv_axes))
    else:                                            # ---- full sequence
        s = x.shape[1]
        rope_pos = positions
        if rope_pos is None:
            rope_pos = torch.arange(s, device=x.device)[None]    # (1, S)
        pos1d = rope_pos[..., 0] if rope_pos.ndim == 3 else rope_pos
        if cache is not None:
            q, k, v, k_all, v_all = _qkv(p, h_in, cfg, rope_pos, tp,
                                         whole_kv=True)
        else:
            q, k, v = _qkv(p, h_in, cfg, rope_pos, tp)
        if train:
            out = attend_direct(q, k, v, pos1d, pos1d, causal=causal,
                                window=window)
        else:
            out = attention(q, k, v, None if positions is None else pos1d,
                            causal=causal, window=window,
                            prefix_groups=prefix_groups)
        if cache is not None:                        # prefill: fill the cache
            pc = pos1d.to(torch.int32).expand(x.shape[0], s)
            _prefill_fill(cache, k_all, v_all, pc)
    if tp is not None:                               # wo row-parallel
        proj = reduce_forward(torch.einsum(
            "bshk,hkd->bsd", out.to(F32), p.wo.to(F32)), tp)
        return x + proj.to(x.dtype), cache
    proj = common.feinsum("bshk,hkd->bsd", out, p.wo)
    return x + proj, cache


def decode_attend_cut(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      cache: Dict[str, torch.Tensor],
                      decode_pos: torch.Tensor,
                      tp: Optional[collectives.Comm],
                      kv: Optional[collectives.Comm]) -> torch.Tensor:
    """One decode step on a mesh.  q (B, 1, H_local, dh) is this rank's q
    heads (all of them when ``tp`` is None); k, v (B, 1, KVH, dh) the new
    token's, every kv head.  The layer cache holds every kv head and, when
    ``kv`` is a group, this rank's block of the slots (the decode rules'
    ``act_kv_seq``: over ``model``, over ``(data, model)`` for long
    context).  The rank owning slot ``decode_pos % w`` writes the new
    entry, the others write nothing.  q is gathered over ``model``, every
    head attends the rank's slots (``decode_attend``, or
    ``_merged_decode`` over cut slots), and the rank keeps its own heads'
    output.  Returns (B, 1, H_local, dh) in q's dtype."""
    hl = q.shape[2]
    q_all = q if tp is None else tp.all_gather(q, 2)         # (B,1,H,dh)
    if kv is None:
        write_kv(cache, k, v, decode_pos)
        out = decode_attend(q_all, cache["k"].to(q.dtype),
                            cache["v"].to(q.dtype), decode_pos, cache["pos"])
    else:
        wl = cache["k"].shape[1]
        slot = decode_pos.long() % (wl * kv.size) - kv.rank * wl
        mine = (slot >= 0) & (slot < wl)
        bidx = torch.arange(k.shape[0], device=k.device)
        at = slot.clamp(0, wl - 1)
        for name, new in (("k", k[:, 0]), ("v", v[:, 0]),
                          ("pos", decode_pos)):
            old = cache[name][bidx, at]
            sel = mine.view((-1,) + (1,) * (old.ndim - 1))
            cache[name][bidx, at] = torch.where(
                sel, new.to(old.dtype), old)
        out = _merged_decode(q_all, cache, decode_pos, kv)
    if tp is not None:
        out = out[:, :, tp.rank * hl:(tp.rank + 1) * hl]
    return out


def _merged_decode(q: torch.Tensor, cache: Dict[str, torch.Tensor],
                   decode_pos: torch.Tensor,
                   kv: collectives.Comm) -> torch.Tensor:
    """``decode_attend`` of q (B, 1, H, dh) over slots cut over ``kv``:
    every head attends this rank's slots, and the partial softmax terms
    (the running max, the sum of weights and the weighted values, in f32)
    are merged over ``kv`` by log-sum-exp."""
    b, _, h, dh = q.shape
    kvh = cache["k"].shape[2]
    kc, vc = cache["k"].to(q.dtype), cache["v"].to(q.dtype)
    qg = q.reshape(b, kvh, h // kvh, dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg.to(F32), kc.to(F32)) * dh ** -0.5
    kp = cache["pos"]                                        # (B, w)
    valid = (kp >= 0) & (kp <= decode_pos[:, None])
    s = s.masked_fill(~valid[:, None, None], NEG_INF)
    m = s.amax(dim=-1)                                       # (B,KVH,G)
    p = torch.exp(s - m[..., None]) * valid[:, None, None]
    mx = kv.all_reduce(m, op="max")
    w = torch.exp(m - mx)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(F32), vc.to(F32))
    tot = kv.all_reduce(torch.cat([o * w[..., None],
                                   (p.sum(dim=-1) * w)[..., None]], -1))
    o = tot[..., :dh] / tot[..., dh:]
    return o.to(q.dtype).reshape(b, 1, h, dh)


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
    cache has pos = -1, set by ``TransformerModel.init_cache``), with the
    reference's axes (the slots on ``act_kv_seq``)."""
    kvh, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    kv_axes = ("act_batch", "act_kv_seq", None, None)
    return {"k": ParamDef((batch, window, kvh, dh), "zeros", axes=kv_axes),
            "v": ParamDef((batch, window, kvh, dh), "zeros", axes=kv_axes),
            "pos": ParamDef((batch, window), "zeros", dtype="int32",
                            axes=("act_batch", "act_kv_seq"))}


# --------------------------------------------------------------------------
# Dense FFN (SwiGLU, or LayerNorm + GELU for the audio family)
# --------------------------------------------------------------------------

def ffn_defs(cfg: ModelConfig, kind: str = "swiglu") -> Dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.d_ff
    out_scale = 1.0 / max(1, cfg.num_layers) ** 0.5
    out = {"norm": ParamDef((d,), "ones", dtype="float32", axes=("embed",))}
    if kind == "swiglu":
        out.update({
            "w_gate": ParamDef((d, f), "fan_in", axes=("embed", "ffn")),
            "w_up": ParamDef((d, f), "fan_in", axes=("embed", "ffn")),
            "w_down": ParamDef((f, d), "fan_in", scale=out_scale,
                               axes=("ffn", "embed")),
        })
    else:                                            # gelu
        out.update({
            "norm_b": ParamDef((d,), "zeros", dtype="float32",
                               axes=("embed",)),
            "w_in": ParamDef((d, f), "fan_in", axes=("embed", "ffn")),
            "b_in": ParamDef((f,), "zeros", axes=("ffn",)),
            "w_out": ParamDef((f, d), "fan_in", scale=out_scale,
                              axes=("ffn", "embed")),
            "b_out": ParamDef((d,), "zeros", axes=("embed",)),
        })
    return out


def ffn_apply(p: ParamGroup, x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU after RMSNorm, or, where the layer has ``w_in``, the tanh-GELU
    MLP (biases added in the model dtype) after LayerNorm.  With the ffn
    dim cut over ``model``: column-parallel in, row-parallel out (``b_in``
    cut with the columns, ``b_out`` added once)."""
    if "w_in" in p.defs:
        h = common.layer_norm(x, p.norm, p.norm_b, cfg.norm_eps)
        tp = _tp(p, "w_in", 1)
        if tp is not None:
            return x + common.gelu_mlp(
                reduce_backward(h, tp), p.w_in, p.b_in, p.w_out, p.b_out,
                reduce=lambda t: reduce_forward(t, tp))
        return x + common.gelu_mlp(h, p.w_in, p.b_in, p.w_out, p.b_out)
    h = common.rms_norm(x, p.norm, cfg.norm_eps)
    tp = _tp(p, "w_gate", 1)
    if tp is not None:
        return x + common.swiglu(reduce_backward(h, tp), p.w_gate, p.w_up,
                                 p.w_down,
                                 reduce=lambda t: reduce_forward(t, tp))
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
    expert_in = ("expert", "expert_embed", None)
    out = {
        "norm": ParamDef((d,), "ones", dtype="float32", axes=("embed",)),
        "router": ParamDef((d, e), "fan_in", dtype="float32",
                           axes=("embed", None)),
        "we_gate": ParamDef((e, d, f), "fan_in", axes=expert_in),
        "we_up": ParamDef((e, d, f), "fan_in", axes=expert_in),
        "we_down": ParamDef((e, f, d), "fan_in",
                            scale=1.0 / max(1, cfg.num_layers) ** 0.5,
                            axes=("expert", None, "expert_embed")),
    }
    for pre, width in (("ws", f * m.num_shared_experts),
                       ("wd", m.dense_ff_parallel)):
        if width:                    # shared experts (Kimi), dense (Arctic)
            out.update({
                f"{pre}_gate": ParamDef((d, width), "fan_in",
                                        axes=("embed", "ffn")),
                f"{pre}_up": ParamDef((d, width), "fan_in",
                                      axes=("embed", "ffn")),
                f"{pre}_down": ParamDef((width, d), "fan_in",
                                        axes=("ffn", "embed")),
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


def _aux_loss(m: MoEConfig, probs: torch.Tensor, top_i: torch.Tensor,
              dp: Optional[collectives.Comm] = None) -> torch.Tensor:
    """Switch-style load-balancing loss: E * sum(frac_tokens * frac_probs)
    * weight, frac_tokens the share of tokens whose first choice is each
    expert (counted by ``index_add_``: no one-hot, no host sync).  With
    ``dp``, both fractions are the data-global ones: their sums all-reduced
    over the batch axes, over the global token count."""
    t, e = probs.shape
    first = torch.zeros((e,), dtype=F32, device=probs.device)
    first.index_add_(0, top_i[:, 0], torch.ones((t,), dtype=F32,
                                                device=probs.device))
    if dp is None:
        frac_tokens, frac_probs = first / t, probs.mean(dim=0)
    else:
        frac = reduce_forward(torch.cat([first, probs.sum(dim=0)]),
                              dp) / (t * dp.size)
        frac_tokens, frac_probs = frac[:e], frac[e:]
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
    copies.  Returns (residual-added output, aux load loss).  Single-device
    only: it raises under an active mesh."""
    if collectives.current() is not None:
        raise NotImplementedError("moe_gather_apply runs on one device; the "
                                  "sharded step takes the capacity dispatch")
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
    written once.  No step reads a value back to the host.

    Under an active mesh x holds this rank's rows of the global batch,
    which the reference runs flattened with the data ranks major.  The
    capacity is then the global token count's; a copy's slot is its rank
    within its expert among the copies of every data rank before it (an
    exclusive prefix, over the batch axes, of the per-expert counts,
    all-gathered), so the same copies are dropped; the aux loss takes the
    data-global fractions.  Experts cut over ``model`` run
    expert-parallel: every model rank routes all of its data rank's tokens
    with the replicated router and runs its own experts.  The shared
    (Kimi) and parallel dense (Arctic) branches cut over ``model`` are
    tensor-parallel like the FFN.  Those partial terms are summed in f32,
    all-reduced over ``model`` once and rounded once; whatever is not cut
    runs whole on every rank, on the replicated input, and is added after
    that sum."""
    m = cfg.moe
    if m is None:
        raise ValueError(f"{cfg.name}: moe block requested but cfg.moe is "
                         "None")
    b, s, d = x.shape
    t = b * s
    k, e = m.top_k, m.num_experts
    if flags.MOE_GATHER_DECODE and t * k <= e:
        return moe_gather_apply(p, x, cfg)
    mesh = collectives.current()
    dp = tp = None
    if mesh is not None:
        dp, tp = mesh.comm(mesh.batch_axes), mesh.comm(("model",))
    n_dp, r_dp = (dp.size, dp.rank) if dp is not None else (1, 0)
    cap = moe_capacity(m, t * n_dp)

    h = common.rms_norm(x, p.norm, cfg.norm_eps)
    xt = h.reshape(t, d)
    probs, top_w, top_i = _route(p, xt, k)

    # ---- slot assignment: a copy's slot is its rank within its expert's
    # run of the stably sorted expert ids (after the earlier data ranks')
    dev = x.device
    flat_e = top_i.reshape(t * k)                            # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    experts = torch.arange(e, device=dev)
    starts = torch.searchsorted(sorted_e, experts)
    slot_sorted = torch.arange(t * k, device=dev) - starts[sorted_e]
    flat_slot = torch.empty_like(slot_sorted)
    flat_slot[order] = slot_sorted
    if dp is not None:
        counts = torch.searchsorted(sorted_e, experts, right=True) - starts
        every = dp.all_gather(counts[None], 0)               # (n_dp, E)
        flat_slot = flat_slot + every[:r_dp].sum(0)[flat_e]
    valid = flat_slot < cap
    if MOE_TRACE is not None:
        MOE_TRACE.append(valid.cpu())

    # ---- the terms summed over model: this rank's experts, the cut
    # dense branches (their input's gradient summed over model once)
    ep = _tp(p, "we_gate", 0)
    dense = [pre for pre, width in (("ws", m.num_shared_experts),
                                    ("wd", m.dense_ff_parallel)) if width]
    cut = [pre for pre in dense if tp is not None and p.cut(f"{pre}_gate", 1)]
    xin = reduce_backward(xt, tp) if ep is not None or cut else xt
    if ep is not None:
        e_loc = e // ep.size
        lo = ep.rank * e_loc
        mine = (flat_e >= lo) & (flat_e < lo + e_loc)
        keep = valid & mine
        idx_e = torch.where(mine, flat_e - lo, 0)
        xe, w = xin, reduce_backward(top_w, ep)
    else:                       # every expert, whole on every rank
        e_loc, keep, idx_e, xe, w = e, valid, flat_e, xt, top_w
    dump = torch.where(keep, flat_slot, cap)                 # overflow slot

    # ---- dispatch: scatter the copies into (E, cap + 1, D)
    xk = xe[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf = torch.zeros((e_loc, cap + 1, d), dtype=x.dtype, device=dev)
    buf[idx_e, dump] = xk
    buf = buf[:, :cap]

    # ---- expert GEMMs, batched over E
    g = torch.bmm(buf, p.we_gate)                            # (E, cap, F)
    u = torch.bmm(buf, p.we_up)
    act = F.silu(g.to(F32)).to(x.dtype) * u
    out_e = F.pad(torch.bmm(act, p.we_down), (0, 0, 0, 1))   # dump slot = 0

    # ---- combine with the f32 weights
    gathered = out_e[idx_e, dump] * keep[:, None].to(x.dtype)
    routed = torch.einsum("tkd,tk->td", gathered.reshape(t, k, d).to(F32), w)
    partial = [routed] if ep is not None else []
    whole = [] if ep is not None else [routed]
    for pre in dense:
        ws = (getattr(p, f"{pre}_gate"), getattr(p, f"{pre}_up"),
              getattr(p, f"{pre}_down"))
        if pre in cut:
            partial.append(common.swiglu_partial(xin, *ws))
        else:
            whole.append(common.swiglu(xt, *ws))
    y = None
    if partial:
        y = reduce_forward(sum(partial[1:], partial[0]), tp).to(x.dtype)
    for term in whole:
        term = term.to(x.dtype)
        y = term if y is None else y + term
    aux = _aux_loss(m, probs, top_i, dp)
    return x + y.reshape(b, s, d), aux
