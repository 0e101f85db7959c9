"""Decoder-only transformer, after the reference's
``models/transformer.py:TransformerModel``, for the dense and MoE families
with a period-1 attention stack (the only stack ``CachedDecoder`` accepts).
A block is attention then a SwiGLU FFN, or attention then an MoE layer
where ``_moe_at`` says so (every layer of the MoE family).

The reference scans one stacked ``blocks/pos0`` tree over the layers; the
port keeps one ``TransformerBlock`` per layer (``bridge.
transformer_params_from_jax`` splits the stack).  The decode cache is the
reference's ``blocks/pos0`` leaves with the layer axis first, as one dict:
``k``/``v`` (L, B, W, KVH, dh) in the model dtype, ``pos`` (L, B, W) int32
(-1 = empty) and ``step`` (B,) int32.  ``decode_step`` updates it in place.
SSM/Mamba mixers, M-RoPE, VLM/audio frontends, ``block_pattern`` and
``prefix_groups`` are not ported: a config that needs them raises.

``forward_train`` and ``loss`` are the reference's ``apply(...,
train=True)`` and ``loss``: attention through ``attend_direct`` (autograd
cannot differentiate the ``flash_attention`` kernel), each layer
checkpointed when ``cfg.remat`` is set (its MoE aux loss with it), and
the cross-entropy over the vocabulary head in chunks (``chunked_ce``) plus
the layers' MoE aux losses.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, dtype_of, resolve_device
from repro_torch.models import common, flags, layers
from repro_torch.models.layers import ParamDef, ParamGroup

F32 = torch.float32
Cache = Dict[str, torch.Tensor]
FAMILIES = ("dense", "moe")


def _moe_at(cfg: ModelConfig, pos: int) -> bool:
    if cfg.moe is None:
        return False
    if cfg.family == "moe":
        return True
    return pos % cfg.moe.moe_layer_period == 1


class TransformerBlock(nn.Module):
    """One layer's parameters: the reference's ``params["blocks"]["pos0"]``
    at one layer, the ``attn`` sub-tree and an ``ffn`` or ``moe`` one
    (``subs`` names them)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.attn = ParamGroup(layers.attn_defs(cfg), dtype, device)
        if _moe_at(cfg, 0):
            self.moe = ParamGroup(layers.moe_defs(cfg), dtype, device)
            self.subs = ("attn", "moe")
        else:
            self.ffn = ParamGroup(layers.ffn_defs(cfg), dtype, device)
            self.subs = ("attn", "ffn")


class TransformerModel(nn.Module):
    def __init__(self, cfg: ModelConfig, device: DeviceLike = "cuda"):
        super().__init__()
        if cfg.family not in FAMILIES or cfg.block_pattern:
            raise NotImplementedError(
                f"{cfg.name}: only the {' and '.join(FAMILIES)} families with "
                f"a period-1 attention stack are ported; got "
                f"family={cfg.family!r}, "
                f"block_pattern={cfg.block_pattern}")
        if cfg.rope_kind not in ("default", "none"):
            raise NotImplementedError(f"rope_kind {cfg.rope_kind!r} is not "
                                      "ported")
        self.cfg = cfg
        self.kinds = ("attn",)
        self.period = 1
        self.device = resolve_device(device)
        self.dtype = dtype_of(cfg.dtype)
        self.top = ParamGroup(self._top_defs(), self.dtype, self.device)
        self.blocks = nn.ModuleList(
            TransformerBlock(cfg, self.dtype, self.device)
            for _ in range(cfg.num_layers))

    def _top_defs(self) -> Dict[str, ParamDef]:
        cfg = self.cfg
        defs = {"final_norm": ParamDef((cfg.d_model,), "ones",
                                       dtype="float32"),
                "embed": ParamDef((cfg.vocab_size, cfg.d_model), "normal")}
        if not cfg.tie_embeddings:
            defs["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_size),
                                       "fan_in")
        return defs

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "TransformerModel":
        """Random weights drawn from ``generator`` (on the model's device),
        with the reference's init kinds: normal 0.02 for the embedding,
        fan_in for the projections and the router with ``wo``/``w_down``/
        ``we_down`` scaled by 1/sqrt(L), ones for the norms (f32)."""
        self.top.init(generator)
        for blk in self.blocks:
            for sub in blk.subs:
                getattr(blk, sub).init(generator)
        return self

    # ------------------------------------------------------------------
    # Embedding / head
    # ------------------------------------------------------------------

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) int -> (B, S, D) in the model dtype."""
        return self.top.embed[tokens]

    def unembed(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return common.feinsum("...d,vd->...v", hidden, self.top.embed)
        return common.fdot(hidden, self.top.lm_head)

    def _head_matrix(self) -> torch.Tensor:
        """(V, D) regardless of tie/untie."""
        if self.cfg.tie_embeddings:
            return self.top.embed
        return self.top.lm_head.T

    # ------------------------------------------------------------------
    # Blocks
    # ------------------------------------------------------------------

    def block_apply(self, bp: TransformerBlock, x: torch.Tensor, *,
                    positions: Optional[torch.Tensor] = None,
                    cache: Optional[Cache] = None,
                    decode_pos: Optional[torch.Tensor] = None,
                    window: int = 0, train: bool = False):
        """One layer (attention then FFN or MoE).  Returns (x, layer cache,
        aux): the MoE layer's aux load loss (a 0-d f32 tensor), 0.0 after
        an FFN."""
        x, c = layers.attn_apply(bp.attn, x, cfg=self.cfg,
                                 positions=positions, cache=cache,
                                 decode_pos=decode_pos, window=window,
                                 train=train)
        if "moe" in bp.subs:
            x, aux = layers.moe_apply(bp.moe, x, self.cfg)
            return x, c, aux
        return layers.ffn_apply(bp.ffn, x, self.cfg), c, 0.0

    @torch.no_grad()
    def apply(self, tokens: torch.Tensor,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-sequence forward (train / encode): the final-normed hidden
        states (B, S, D) (the reference's ``apply(...)[0]``)."""
        x = self.embed(tokens)
        for bp in self.blocks:
            x = self.block_apply(bp, x, positions=positions)[0]
        return common.rms_norm(x, self.top.final_norm, self.cfg.norm_eps)

    def _train_block(self, bp: TransformerBlock, x: torch.Tensor):
        x, _, aux = self.block_apply(bp, x, train=True)
        return x, aux

    def forward_train(self, tokens: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The differentiable full-sequence forward: (final-normed hidden
        states (B, S, D), the layers' summed MoE aux loss) with autograd."""
        x = self.embed(tokens)
        aux = torch.zeros((), dtype=F32, device=x.device)
        for bp in self.blocks:
            if self.cfg.remat:
                x, a = checkpoint(self._train_block, bp, x,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, a = self._train_block(bp, x)
            if torch.is_tensor(a):                    # an MoE layer's
                aux = aux + a
        return (common.rms_norm(x, self.top.final_norm, self.cfg.norm_eps),
                aux)

    # ------------------------------------------------------------------
    # Loss (chunked cross-entropy over the vocab head)
    # ------------------------------------------------------------------

    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross-entropy over ``batch["tokens"]`` (B, S), the
        last position masked out (and by ``batch["loss_mask"]`` if given).
        Returns (loss, {"nll", "moe_aux", "tokens"}), the loss the mean
        nll plus the MoE aux."""
        hidden, aux = self.forward_train(batch["tokens"])
        tokens = batch["tokens"]
        targets = F.pad(tokens[:, 1:], (0, 1))
        mask = F.pad(torch.ones_like(tokens[:, 1:], dtype=F32), (0, 1))
        if "loss_mask" in batch:
            mask = mask * batch["loss_mask"].to(F32)
        nll, denom = chunked_ce(hidden, self._head_matrix(), targets, mask)
        mean = nll / torch.clamp(denom, min=1.0)
        return mean + aux, {"nll": mean, "moe_aux": aux, "tokens": denom}

    # ------------------------------------------------------------------
    # Caching / decode
    # ------------------------------------------------------------------

    def init_cache(self, batch: int, window: int) -> Cache:
        """Empty cache: zero K/V, pos = -1, step 0."""
        defs = layers.attn_cache_defs(self.cfg, batch, window)
        lead = (self.cfg.num_layers,)
        dev = self.device
        return {
            "k": torch.zeros(lead + defs["k"].shape, dtype=self.dtype,
                             device=dev),
            "v": torch.zeros(lead + defs["v"].shape, dtype=self.dtype,
                             device=dev),
            "pos": torch.full(lead + defs["pos"].shape, -1,
                              dtype=torch.int32, device=dev),
            "step": torch.zeros((batch,), dtype=torch.int32, device=dev),
        }

    @staticmethod
    def layer_cache(cache: Cache, layer: int) -> Cache:
        """Views of one layer's K/V/pos: writes land in ``cache``."""
        return {"k": cache["k"][layer], "v": cache["v"][layer],
                "pos": cache["pos"][layer]}

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, window: int
                ) -> Tuple[torch.Tensor, Cache]:
        """Full causal forward over tokens (B, S) that also builds the
        decode cache of ``window`` slots.  Attention is sliding-window with
        that window.  Returns (last-position logits (B, V), cache)."""
        b, s = tokens.shape
        cache = self.init_cache(b, window)
        x = self.embed(tokens)
        for l, bp in enumerate(self.blocks):
            x = self.block_apply(bp, x, cache=self.layer_cache(cache, l),
                                 window=window)[0]
        x = common.rms_norm(x, self.top.final_norm, self.cfg.norm_eps)
        cache["step"].fill_(s)
        return self.unembed(x[:, -1]), cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: Cache
                    ) -> Tuple[torch.Tensor, Cache]:
        """tokens: (B,) int. Returns (logits (B, V), cache), the cache
        updated in place (one slot per layer and sample, step + 1)."""
        step = cache["step"]                                 # (B,)
        x = self.embed(tokens[:, None])
        positions = step[:, None]
        for l, bp in enumerate(self.blocks):
            x = self.block_apply(bp, x, positions=positions,
                                 cache=self.layer_cache(cache, l),
                                 decode_pos=step)[0]
        x = common.rms_norm(x, self.top.final_norm, self.cfg.norm_eps)
        logits = self.unembed(x[:, 0])
        step.add_(1)
        return logits, cache


# --------------------------------------------------------------------------
# Chunked cross-entropy
# --------------------------------------------------------------------------

def _ce_chunk(h: torch.Tensor, head32: torch.Tensor, t: torch.Tensor,
              m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    logits = torch.einsum("bcd,vd->bcv", h.to(F32), head32)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.take_along_dim(logits, t.long()[..., None], dim=-1)[..., 0]
    return ((lse - tgt) * m).sum(), m.sum()


def chunked_ce(hidden: torch.Tensor, head: torch.Tensor,
               targets: torch.Tensor, mask: torch.Tensor, chunk: int = 512
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy without materializing (B, S, V): S in chunks, a
    sequence of a length that is not a multiple of ``chunk`` padded (masked)
    to one.  hidden (B,S,D); head (V,D); targets / mask (B,S).  Returns
    (sum nll, sum mask).  With ``flags.CE_REMAT`` each chunk's logits are
    recomputed in backward instead of saved."""
    b, s, d = hidden.shape
    chunk = min(chunk, s)
    if s % chunk:
        pad = chunk - s % chunk
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
        s += pad
    head32 = head.to(F32)
    nll = torch.zeros((), dtype=F32, device=hidden.device)
    denom = torch.zeros((), dtype=F32, device=hidden.device)
    for i in range(0, s, chunk):
        args = (hidden[:, i:i + chunk], head32, targets[:, i:i + chunk],
                mask[:, i:i + chunk])
        if flags.CE_REMAT:
            n, m = checkpoint(_ce_chunk, *args, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            n, m = _ce_chunk(*args)
        nll = nll + n
        denom = denom + m
    return nll, denom
