"""Dense decoder-only transformer, after the reference's
``models/transformer.py:TransformerModel``, for the dense family with a
period-1 attention stack (the only stack ``CachedDecoder`` accepts).

The reference scans one stacked ``blocks/pos0`` tree over the layers; the
port keeps one ``TransformerBlock`` per layer (``bridge.
transformer_params_from_jax`` splits the stack).  The decode cache is the
reference's ``blocks/pos0`` leaves with the layer axis first, as one dict:
``k``/``v`` (L, B, W, KVH, dh) in the model dtype, ``pos`` (L, B, W) int32
(-1 = empty) and ``step`` (B,) int32.  ``decode_step`` updates it in place.
MoE, SSM/Mamba mixers, M-RoPE, VLM/audio frontends, ``block_pattern`` and
``prefix_groups`` are not ported: a config that needs them raises.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, dtype_of, resolve_device
from repro_torch.models import common, layers
from repro_torch.models.layers import ParamDef, ParamGroup

F32 = torch.float32
Cache = Dict[str, torch.Tensor]


class TransformerBlock(nn.Module):
    """One layer's parameters: the reference's ``params["blocks"]["pos0"]``
    at one layer, ``attn`` and ``ffn`` sub-trees."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.attn = ParamGroup(layers.attn_defs(cfg), dtype, device)
        self.ffn = ParamGroup(layers.ffn_defs(cfg), dtype, device)


class TransformerModel(nn.Module):
    def __init__(self, cfg: ModelConfig, device: DeviceLike = "cuda"):
        super().__init__()
        if cfg.family != "dense" or cfg.block_pattern:
            raise NotImplementedError(
                f"{cfg.name}: only the dense family with a period-1 attention "
                f"stack is ported; got family={cfg.family!r}, "
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
        fan_in for the projections with ``wo``/``w_down`` scaled by
        1/sqrt(L), ones for the norms (f32)."""
        self.top.init(generator)
        for blk in self.blocks:
            blk.attn.init(generator)
            blk.ffn.init(generator)
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

    # ------------------------------------------------------------------
    # Blocks
    # ------------------------------------------------------------------

    def block_apply(self, bp: TransformerBlock, x: torch.Tensor, *,
                    positions: Optional[torch.Tensor] = None,
                    cache: Optional[Cache] = None,
                    decode_pos: Optional[torch.Tensor] = None,
                    window: int = 0) -> Tuple[torch.Tensor, Optional[Cache]]:
        """One layer (attention then FFN). Returns (x, layer cache)."""
        x, c = layers.attn_apply(bp.attn, x, cfg=self.cfg,
                                 positions=positions, cache=cache,
                                 decode_pos=decode_pos, window=window)
        return layers.ffn_apply(bp.ffn, x, self.cfg), c

    @torch.no_grad()
    def apply(self, tokens: torch.Tensor,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-sequence forward (train / encode): the final-normed hidden
        states (B, S, D) (the reference's ``apply(...)[0]``)."""
        x = self.embed(tokens)
        for bp in self.blocks:
            x, _ = self.block_apply(bp, x, positions=positions)
        return common.rms_norm(x, self.top.final_norm, self.cfg.norm_eps)

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
            x, _ = self.block_apply(bp, x, cache=self.layer_cache(cache, l),
                                    window=window)
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
            x, _ = self.block_apply(bp, x, positions=positions,
                                    cache=self.layer_cache(cache, l),
                                    decode_pos=step)
        x = common.rms_norm(x, self.top.final_norm, self.cfg.norm_eps)
        logits = self.unembed(x[:, 0])
        step.add_(1)
        return logits, cache
