"""The LM of the reference's ``models/transformer.py:TransformerModel``,
for the dense, MoE, SSM, hybrid, VLM and audio families.  Layers follow
``cfg.block_pattern`` (one period, tiled over the depth; empty means
attention only): a layer's mixer is attention, Mamba, mLSTM or sLSTM, and
an attention or Mamba mixer is followed by a SwiGLU FFN (the audio
family's: LayerNorm and a tanh-GELU MLP), or by an MoE layer where
``_moe_at`` says so (every layer of the MoE family, the odd positions of
Jamba's period); mLSTM and sLSTM blocks, and a config with ``d_ff == 0``,
have neither.

The entry points take the reference's batch dict: ``tokens`` (B, S), with
``vision_embeds`` (B, vision_tokens, D) and ``vision_mask`` (B, S) for the
VLM (the vision encoder is a stub: its embeddings replace the masked
positions' token embeddings), or ``features`` (B, S, frontend_dim) for the
audio encoder (its conv frontend is a stub: a projection and a 15-tap
positional conv); optional ``positions``, (B, S) or (B, S, 3) for
M-RoPE, any integers (an image prompt's tokens share t positions): they
rotate q and k and, through their t axis, mask every full-sequence
attention, as the reference's ``pos1d``.  They go to the layers as int32,
converted once per call.  The audio encoder has no embedding table and an untied head, and
attends bidirectionally; it has no decode step.

The reference scans one stacked ``blocks/pos{i}`` tree per period position
over the ``n_super`` periods; the port keeps one ``TransformerBlock`` per
layer, layer ``s * period + i`` holding period ``s``'s slice of
``pos{i}`` (``bridge.transformer_params_from_jax`` splits the stacks).
The decode cache is one dict of leaves, each stacked over the layers of
one kind with the batch on axis 1: ``k``/``v`` (n_attn, B, W, KVH, dh) in
the model dtype and ``pos`` (n_attn, B, W) int32 (-1 = empty) over the
attention layers, ``<kind>_<leaf>`` over each mixer kind's layers (e.g.
``mamba_ssm`` (n_mamba, B, di, ds) f32, ``mlstm_C`` (n_mlstm, B, H, dh,
dh) f32), and ``step`` (B,) int32.  A dense or MoE model's cache is thus
``k``/``v``/``pos`` over all L layers and ``step``.  ``layer_cache`` gives
one layer's views; ``decode_step`` updates the cache in place.
``prefix_groups`` (the constructor's, as the reference's) runs causal
full-sequence attention as that many prefix attends
(``attention.prefix_grouped_causal``).

``forward_train`` and ``loss`` are the reference's ``apply(...,
train=True)`` and ``loss``, for every block kind and ``block_pattern``
stack: attention through ``attend_direct`` (autograd cannot differentiate
the ``flash_attention`` kernel), the Mamba doubling scan (out of place,
``mamba._chunk_scan``), the mLSTM chunkwise and the sLSTM
token-by-token sequence forms as they are, each layer checkpointed when
``cfg.remat`` is set (its MoE aux loss with it), and the cross-entropy
over the vocabulary head in chunks (``chunked_ce``) plus the layers' MoE
aux losses: next-token for the decoders, masked prediction of ``targets``
for the audio encoder.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, dtype_of, resolve_device
from repro_torch.distributed import collectives
from repro_torch.distributed.collectives import (reduce_backward,
                                                 reduce_forward)
from repro_torch.models import common, flags, layers, mamba, ssm
from repro_torch.models.layers import ParamGroup, stack_defs
from repro_torch.models.params import ParamDef, abstract_params

F32 = torch.float32
Cache = Dict[str, torch.Tensor]
Batch = Dict[str, torch.Tensor]
POS_CONV_TAPS = 15        # the audio frontend's positional conv, pad 7 / 7
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
ROPE_KINDS = ("default", "mrope", "none")
# each mixer kind: (its parameter defs, its decode state's defs, its apply)
MIXERS = {"mamba": (mamba.mamba_defs, mamba.mamba_state_defs,
                    mamba.mamba_apply),
          "mlstm": (ssm.mlstm_defs, ssm.mlstm_state_defs, ssm.mlstm_apply),
          "slstm": (ssm.slstm_defs, ssm.slstm_state_defs, ssm.slstm_apply)}
KINDS = ("attn",) + tuple(MIXERS)


def _moe_at(cfg: ModelConfig, pos: int) -> bool:
    if cfg.moe is None:
        return False
    if cfg.family == "moe":
        return True
    return pos % cfg.moe.moe_layer_period == 1


def block_defs(cfg: ModelConfig, kind: str,
               pos: int) -> Dict[str, Dict[str, ParamDef]]:
    """One layer's defs at period position ``pos`` (the reference's
    ``_block_defs``): the mixer's under its kind's name (``attn``,
    ``mamba``, ``mlstm``, ``slstm``) and, after an attention or Mamba
    mixer, an ``ffn`` or ``moe`` one."""
    out = {kind: (layers.attn_defs(cfg) if kind == "attn"
                  else MIXERS[kind][0](cfg))}
    if kind not in ("mlstm", "slstm") and cfg.d_ff > 0:
        if _moe_at(cfg, pos):
            out["moe"] = layers.moe_defs(cfg)
        else:
            kind_ff = "gelu" if cfg.family == "audio" else "swiglu"
            out["ffn"] = layers.ffn_defs(cfg, kind_ff)
    return out


class TransformerBlock(nn.Module):
    """One layer's parameters: the reference's ``params["blocks"]
    ["pos{i}"]`` at one period, one ``ParamGroup`` per sub-tree of
    ``block_defs`` (``subs`` names them)."""

    def __init__(self, cfg: ModelConfig, kind: str, pos: int,
                 dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.kind = kind
        defs = block_defs(cfg, kind, pos)
        for sub, d in defs.items():
            setattr(self, sub, ParamGroup(d, dtype, device))
        self.subs = tuple(defs)


def _positions(batch: Batch) -> Optional[torch.Tensor]:
    """The batch's ``positions`` as int32 (None without them)."""
    pos = batch.get("positions")
    return None if pos is None else pos.to(torch.int32)


class TransformerModel(nn.Module):
    def __init__(self, cfg: ModelConfig, device: DeviceLike = "cuda", *,
                 prefix_groups: int = 1):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: only the {', '.join(FAMILIES)} families are "
                f"ported; got family={cfg.family!r}")
        if cfg.rope_kind not in ROPE_KINDS:
            raise NotImplementedError(f"rope_kind {cfg.rope_kind!r} is not "
                                      f"one of {ROPE_KINDS}")
        self.cfg = cfg
        self.prefix_groups = prefix_groups
        self.kinds = cfg.block_pattern or ("attn",)
        self.period = len(self.kinds)
        if cfg.num_layers % self.period != 0:
            raise ValueError(
                f"{cfg.name}: {cfg.num_layers} layers not divisible by "
                f"pattern period {self.period}")
        self.n_super = cfg.num_layers // self.period
        for kind in self.kinds:
            if kind not in KINDS:
                raise ValueError(f"{cfg.name}: unknown block kind {kind!r}; "
                                 f"expected one of {KINDS}")
            if kind != "attn" and cfg.ssm is None:
                raise ValueError(f"{cfg.name}: a {kind} block needs "
                                 "cfg.ssm")
        self.layer_kinds = cfg.layer_kinds
        # each layer's index within its kind's stack of cache leaves
        seen: Dict[str, int] = {}
        self.kind_index = []
        for kind in self.layer_kinds:
            self.kind_index.append(seen.get(kind, 0))
            seen[kind] = self.kind_index[-1] + 1
        self.kind_counts = seen
        self.device = resolve_device(device)
        self.dtype = dtype_of(cfg.dtype)
        self.cut_onto = None        # the mesh's extents once cut onto one
        self.top = ParamGroup(self._top_defs(), self.dtype, self.device)
        self.blocks = nn.ModuleList(
            TransformerBlock(cfg, kind, l % self.period, self.dtype,
                             self.device)
            for l, kind in enumerate(self.layer_kinds))

    def _top_defs(self) -> Dict[str, ParamDef]:
        cfg = self.cfg
        d = cfg.d_model
        defs = {"final_norm": ParamDef((d,), "ones", dtype="float32",
                                       axes=("embed",))}
        if cfg.family == "audio":
            defs.update({
                "feat_proj": ParamDef((cfg.frontend_dim, d), "fan_in",
                                      axes=(None, "embed")),
                "feat_bias": ParamDef((d,), "zeros", axes=("embed",)),
                "pos_conv": ParamDef((POS_CONV_TAPS, d), "fan_in",
                                     axes=(None, "embed"))})
        else:
            defs["embed"] = ParamDef((cfg.vocab_size, d), "normal",
                                     axes=("vocab", "embed"))
        if cfg.family == "audio" or not cfg.tie_embeddings:
            defs["lm_head"] = ParamDef((d, cfg.vocab_size), "fan_in",
                                       axes=("embed", "vocab"))
        return defs

    def param_defs(self) -> Dict:
        """The reference's ``param_defs`` tree: the top-level defs and
        ``blocks/pos{i}``, period position i's layer defs stacked over the
        ``n_super`` periods on a leading ``layers`` axis."""
        defs: Dict = dict(self._top_defs())
        defs["blocks"] = {
            f"pos{i}": stack_defs(block_defs(self.cfg, kind, i),
                                  self.n_super)
            for i, kind in enumerate(self.kinds)}
        return defs

    def abstract_params(self) -> Dict:
        """``param_defs`` as ``meta`` tensors (shapes and dtypes only)."""
        return abstract_params(self.param_defs(), self.cfg.dtype)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "TransformerModel":
        """Random weights drawn from ``generator`` (on the model's device),
        with the reference's init kinds: normal 0.02 for the embedding,
        fan_in for the projections and the router with ``wo``/``w_down``/
        ``we_down``/``w_out``/``w_ff_out`` scaled by 1/sqrt(L), ones for
        the norms and the Mamba's ``a_log``, ``b_dt``, ``d_skip`` (f32)."""
        self.top.init(generator)
        for blk in self.blocks:
            for sub in blk.subs:
                getattr(blk, sub).init(generator)
        return self

    # ------------------------------------------------------------------
    # Embedding / head
    # ------------------------------------------------------------------

    def embed(self, batch: Batch, top=None) -> torch.Tensor:
        """The batch's inputs -> (B, S, D) in the model dtype.

        Audio: ``features`` cast to the model dtype, projected, then the
        symmetric depthwise positional conv (taps accumulated in f32 in the
        reference's order, zero padding 7 / 7) added through a tanh GELU.
        Otherwise the ``tokens``' embeddings; for the VLM, position s takes
        vision embedding ``clip(cumsum(vision_mask)[s] - 1, 0, V - 1)``
        where ``vision_mask`` is set (so mask positions past the V-th reuse
        the last embedding).  ``top`` stands for ``self.top`` (its gathered
        view in a sharded step); with the vocab cut over ``model`` each
        rank looks up its own rows and the lookups are summed over
        ``model`` (the other ranks' rows are zeros)."""
        top = self.top if top is None else top
        if self.cfg.family == "audio":
            x = common.fdot(batch["features"].to(self.dtype),
                            top.feat_proj) + top.feat_bias
            k, s = top.pos_conv.shape[0], x.shape[1]
            xp = F.pad(x, (0, 0, k // 2, k - 1 - k // 2))
            pos = torch.zeros(x.shape, dtype=F32, device=x.device)
            for i in range(k):
                pos = pos + xp[:, i:i + s].to(F32) * top.pos_conv[i].to(F32)
            return x + F.gelu(pos, approximate="tanh").to(x.dtype)
        tp = layers._tp(top, "embed", 0)
        if tp is not None:                        # vocab-parallel lookup
            tokens = batch["tokens"]
            v = top.embed.shape[0]
            lo = tp.rank * v
            mine = (tokens >= lo) & (tokens < lo + v)
            rows = top.embed[torch.where(mine, tokens - lo, 0)]
            x = reduce_forward(torch.where(mine[..., None], rows, 0), tp)
        else:
            x = top.embed[batch["tokens"]]
        if self.cfg.family == "vlm" and "vision_embeds" in batch:
            vis, msk = batch["vision_embeds"], batch["vision_mask"]
            idx = torch.clamp(torch.cumsum(msk.to(torch.int32), dim=1) - 1,
                              0, vis.shape[1] - 1)
            scattered = torch.gather(
                vis.to(x.dtype), 1,
                idx[..., None].expand(*idx.shape, x.shape[-1]))
            x = torch.where(msk[..., None], scattered, x)
        return x

    def unembed(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return common.feinsum("...d,vd->...v", hidden, self.top.embed)
        return common.fdot(hidden, self.top.lm_head)

    def _head_matrix(self, top=None) -> torch.Tensor:
        """(V, D) regardless of tie/untie (this rank's vocab rows when the
        vocab is cut over ``model``)."""
        top = self.top if top is None else top
        if self.cfg.tie_embeddings:
            return top.embed
        return top.lm_head.T

    def _head_tp(self, top):
        """The model group when the head's vocab is cut over it."""
        if self.cfg.tie_embeddings:
            return layers._tp(top, "embed", 0)
        return layers._tp(top, "lm_head", 1)

    def _single_device(self, what: str) -> None:
        if self.cut_onto is not None:
            raise NotImplementedError(
                f"{what} runs on one device; this model is cut onto a "
                f"{self.cut_onto} mesh (sharded serving of the LLMs is not "
                "ported)")

    # ------------------------------------------------------------------
    # Blocks
    # ------------------------------------------------------------------

    def block_apply(self, bp: TransformerBlock, x: torch.Tensor, *,
                    positions: Optional[torch.Tensor] = None,
                    cache: Optional[Cache] = None,
                    decode_pos: Optional[torch.Tensor] = None,
                    window: int = 0, train: bool = False,
                    decode: bool = False):
        """One layer (its mixer, then an FFN or MoE if it has one).
        Returns (x, layer cache, aux): the MoE layer's aux load loss (a 0-d
        f32 tensor), else 0.0.

        Attention: ``cache`` is the layer's K/V to fill (prefill) or to
        decode from (``decode_pos`` set), as ``layers.attn_apply``.  A
        mixer: with ``decode`` it steps ``cache`` (its state's views) in
        place; else it runs from a zero state and, if ``cache`` is given,
        copies the state after the sequence into it (prefill); without a
        cache it returns that state."""
        if bp.kind == "attn":
            x, c = layers.attn_apply(layers.gathered(bp.attn), x,
                                     cfg=self.cfg,
                                     positions=positions, cache=cache,
                                     decode_pos=decode_pos, window=window,
                                     train=train,
                                     prefix_groups=self.prefix_groups)
        else:
            fn = MIXERS[bp.kind][2]
            p = getattr(bp, bp.kind)
            if decode:
                x, c = fn(p, x, cfg=self.cfg, state=cache, decode=True)
            else:
                x, c = fn(p, x, cfg=self.cfg)
                if cache is not None:
                    for key, t in c.items():
                        cache[key].copy_(t)
                    c = cache
        if "moe" in bp.subs:
            x, aux = layers.moe_apply(layers.gathered(bp.moe), x, self.cfg)
            return x, c, aux
        if "ffn" in bp.subs:
            x = layers.ffn_apply(layers.gathered(bp.ffn), x, self.cfg)
        return x, c, 0.0

    @torch.no_grad()
    def apply(self, batch: Batch) -> torch.Tensor:
        """Full-sequence forward (encode): the final-normed hidden states
        (B, S, D) (the reference's ``apply(...)[0]``)."""
        self._single_device("apply")
        x = self.embed(batch)
        positions = _positions(batch)
        for bp in self.blocks:
            x = self.block_apply(bp, x, positions=positions)[0]
        return common.rms_norm(x, self.top.final_norm, self.cfg.norm_eps)

    def _train_block(self, bp: TransformerBlock, x: torch.Tensor,
                     positions: Optional[torch.Tensor]):
        x, _, aux = self.block_apply(bp, x, positions=positions, train=True)
        return x, aux

    def forward_train(self, batch: Batch, top=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The differentiable full-sequence forward: (final-normed hidden
        states (B, S, D), the layers' summed MoE aux loss) with autograd,
        through every block kind.  ``top`` stands for ``self.top``."""
        top = self.top if top is None else top
        x = self.embed(batch, top)
        positions = _positions(batch)
        aux = torch.zeros((), dtype=F32, device=x.device)
        for bp in self.blocks:
            if self.cfg.remat:
                x, a = checkpoint(self._train_block, bp, x, positions,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, a = self._train_block(bp, x, positions)
            if torch.is_tensor(a):                    # an MoE layer's
                aux = aux + a
        return (common.rms_norm(x, top.final_norm, self.cfg.norm_eps),
                aux)

    # ------------------------------------------------------------------
    # Loss (chunked cross-entropy over the vocab head)
    # ------------------------------------------------------------------

    def loss(self, batch: Batch
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Cross-entropy: for the audio encoder over ``batch["targets"]``
        (B, S) where ``batch["mask_indices"]`` is set (every position
        without it); else next-token over ``batch["tokens"]`` (B, S), the
        last position masked out (and by ``batch["loss_mask"]`` if given).
        Returns (loss, {"nll", "moe_aux", "tokens"}), the loss the mean
        nll plus the MoE aux.

        In a sharded step (``collectives.active``) the batch is this rank's
        rows: the top-level weights are gathered over the FSDP axes once,
        the head runs vocab-parallel where the vocab is cut over ``model``
        and the nll and token sums are summed over the batch axes, so the
        loss is the global batch's mean."""
        mesh = collectives.current()
        top = layers.gathered(self.top)
        hidden, aux = self.forward_train(batch, top)
        if self.cfg.family == "audio":
            targets = batch["targets"]
            mask = torch.ones(targets.shape, dtype=F32, device=targets.device)
            if "mask_indices" in batch:
                mask = batch["mask_indices"].to(F32)
        else:
            tokens = batch["tokens"]
            targets = F.pad(tokens[:, 1:], (0, 1))
            mask = F.pad(torch.ones_like(tokens[:, 1:], dtype=F32), (0, 1))
            if "loss_mask" in batch:
                mask = mask * batch["loss_mask"].to(F32)
        nll, denom = chunked_ce(hidden, self._head_matrix(top), targets,
                                mask, tp=self._head_tp(top))
        if mesh is not None:
            sums = reduce_forward(torch.stack([nll, denom]),
                                  mesh.comm(mesh.batch_axes))
            nll, denom = sums[0], sums[1]
        mean = nll / torch.clamp(denom, min=1.0)
        return mean + aux, {"nll": mean, "moe_aux": aux, "tokens": denom}

    # ------------------------------------------------------------------
    # Caching / decode
    # ------------------------------------------------------------------

    def cache_defs(self, batch: int, window: int) -> Dict[str, ParamDef]:
        """The port's cache layout (the module docstring) as defs: each
        leaf one layer's def stacked over its kind's layers (``layers``
        axis first, the batch on axis 1), and ``step``.  The axes are the
        reference's ``cache_defs``' for the same leaves, so a mesh cuts
        both caches alike."""
        out: Dict[str, ParamDef] = {}
        n_attn = self.kind_counts.get("attn", 0)
        if n_attn:
            out.update(stack_defs(
                layers.attn_cache_defs(self.cfg, batch, window), n_attn))
        for kind in MIXERS:
            if kind in self.kind_counts:
                defs = stack_defs(MIXERS[kind][1](self.cfg, batch),
                                  self.kind_counts[kind])
                out.update({f"{kind}_{name}": d for name, d in defs.items()})
        out["step"] = ParamDef((batch,), "zeros", dtype="int32",
                               axes=("act_batch",))
        return out

    def abstract_cache(self, batch: int, window: int) -> Dict:
        """``cache_defs`` as ``meta`` tensors (shapes and dtypes only)."""
        return abstract_params(self.cache_defs(batch, window),
                               self.cfg.dtype)

    def init_cache(self, batch: int, window: int) -> Cache:
        """Empty cache: zero K/V, pos = -1, zero mixer states, step 0."""
        out: Cache = {
            name: torch.zeros(d.shape, dtype=dtype_of(d.dtype or self.dtype),
                              device=self.device)
            for name, d in self.cache_defs(batch, window).items()}
        if "pos" in out:
            out["pos"].fill_(-1)
        return out

    def layer_cache(self, cache: Cache, layer: int) -> Cache:
        """Views of one layer's K/V/pos or mixer state: writes land in
        ``cache``."""
        kind, i = self.layer_kinds[layer], self.kind_index[layer]
        if kind == "attn":
            return {"k": cache["k"][i], "v": cache["v"][i],
                    "pos": cache["pos"][i]}
        pre = f"{kind}_"
        return {key[len(pre):]: t[i] for key, t in cache.items()
                if key.startswith(pre)}

    @torch.no_grad()
    def prefill(self, batch: Batch, window: int
                ) -> Tuple[torch.Tensor, Cache]:
        """Full causal forward over the batch's S positions that also
        builds the decode cache of ``window`` slots.  Attention is
        sliding-window with that window.  Returns (last-position logits
        (B, V), cache)."""
        self._single_device("prefill")
        x = self.embed(batch)
        b, s = x.shape[:2]
        positions = _positions(batch)
        cache = self.init_cache(b, window)
        for l, bp in enumerate(self.blocks):
            x = self.block_apply(bp, x, positions=positions,
                                 cache=self.layer_cache(cache, l),
                                 window=window)[0]
        x = common.rms_norm(x, self.top.final_norm, self.cfg.norm_eps)
        cache["step"].fill_(s)
        return self.unembed(x[:, -1]), cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: Cache,
                    extra: Optional[Batch] = None
                    ) -> Tuple[torch.Tensor, Cache]:
        """tokens: (B,) int; ``extra`` joins the one-token batch (a VLM's
        ``vision_embeds`` / ``vision_mask``).  Returns (logits (B, V),
        cache), the cache updated in place (one K/V slot per attention
        layer and sample, each mixer's state one step on, step + 1)."""
        self._single_device("decode_step")
        step = cache["step"]                                 # (B,)
        x = self.embed({"tokens": tokens[:, None], **(extra or {})})
        positions = step[:, None]
        if self.cfg.rope_kind == "mrope":          # one position, every axis
            positions = positions[..., None].expand(
                -1, -1, len(self.cfg.mrope_sections))
        for l, bp in enumerate(self.blocks):
            x = self.block_apply(
                bp, x, positions=positions, cache=self.layer_cache(cache, l),
                decode_pos=step if bp.kind == "attn" else None,
                decode=True)[0]
        x = common.rms_norm(x, self.top.final_norm, self.cfg.norm_eps)
        logits = self.unembed(x[:, 0])
        step.add_(1)
        return logits, cache


# --------------------------------------------------------------------------
# Chunked cross-entropy
# --------------------------------------------------------------------------

def _ce_chunk(h: torch.Tensor, head32: torch.Tensor, t: torch.Tensor,
              m: torch.Tensor, tp: Optional[collectives.Comm] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk's (sum nll, sum mask).  With ``tp``, ``head32`` holds this
    rank's vocab rows: the max of the logits (no gradient), then the sums
    of their exponentials and the target logit (zero off this rank's
    rows) over ``model``."""
    logits = torch.einsum("bcd,vd->bcv", h.to(F32), head32)
    if tp is None:
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.take_along_dim(logits, t.long()[..., None],
                                   dim=-1)[..., 0]
        return ((lse - tgt) * m).sum(), m.sum()
    mx = tp.all_reduce(logits.detach().amax(dim=-1), op="max")
    v = logits.shape[-1]
    local = t.long() - tp.rank * v
    mine = (local >= 0) & (local < v)
    tgt = torch.take_along_dim(logits, local.clamp(0, v - 1)[..., None],
                               dim=-1)[..., 0]
    sums = reduce_forward(torch.stack([
        torch.exp(logits - mx[..., None]).sum(dim=-1),
        torch.where(mine, tgt, 0.0)]), tp)
    lse = mx + torch.log(sums[0])
    return ((lse - sums[1]) * m).sum(), m.sum()


def chunked_ce(hidden: torch.Tensor, head: torch.Tensor,
               targets: torch.Tensor, mask: torch.Tensor, chunk: int = 512,
               tp: Optional[collectives.Comm] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy without materializing (B, S, V): S in chunks, a
    sequence of a length that is not a multiple of ``chunk`` padded (masked)
    to one.  hidden (B,S,D); head (V,D); targets / mask (B,S).  Returns
    (sum nll, sum mask).  With ``flags.CE_REMAT`` each chunk's logits are
    recomputed in backward instead of saved.  With ``tp``, ``head`` holds
    this rank's block of the vocab rows (vocab-parallel: the logsumexp and
    the target logit reduced over the model group)."""
    b, s, d = hidden.shape
    chunk = min(chunk, s)
    if s % chunk:
        pad = chunk - s % chunk
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
        s += pad
    head32 = head.to(F32)
    hidden = reduce_backward(hidden, tp)
    nll = torch.zeros((), dtype=F32, device=hidden.device)
    denom = torch.zeros((), dtype=F32, device=hidden.device)
    for i in range(0, s, chunk):
        args = (hidden[:, i:i + chunk], head32, targets[:, i:i + chunk],
                mask[:, i:i + chunk], tp)
        if flags.CE_REMAT:
            n, m = checkpoint(_ce_chunk, *args, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            n, m = _ce_chunk(*args)
        nll = nll + n
        denom = denom + m
    return nll, denom
