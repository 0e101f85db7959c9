"""DiT (Peebles & Xie 2023): patchified latent tokens, adaLN-zero blocks.

``block_apply`` exposes single-block execution so the cache policies
(``repro_torch.core.policies``) can gate each block.  Parameter layouts at
the module's surface are the reference's (``wq`` is ``(d, h, dh)``, ``wo``
is ``(h, dh, d)``, ``ada_w`` is ``(d, 6d)``), so ``bridge.params_from_jax``
is a copy; the reference's layer-stacked ``blocks`` tree becomes one
``DiTBlock`` per layer.

``apply`` is serving's forward (no autograd); ``forward_train`` and
``loss`` are the reference's ``apply(..., train=True)`` and ``loss``, with
each block checkpointed (recomputed in backward) when ``cfg.remat`` is set,
as the reference wraps its scan body in ``jax.checkpoint``.

``param_defs`` carries the reference's logical axes, from which the sharded
serving engine (``serving/sharded_engine.py``) cuts each block's weights
over the mesh's ``model`` axis.  ``block_apply`` runs on such local shards
as well: ``wq``/``wk``/``wv``/``wo`` may hold a share of the heads and
``w_in``/``b_in``/``w_out`` a share of the ffn columns, each as its spec
fell (18 heads do not divide a 4-way axis; 4608 ffn columns do).  A
sharded product sums its f32 partials over the model group
(``tp_all_reduce``), rounds once, then adds the bias and the residual once,
as the unsharded product rounds its f32 accumulation once.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, dtype_of, resolve_device
from repro_torch.distributed.sharding import constrain, current_ctx
from repro_torch.models import common
from repro_torch.models.attention import attend_bidirectional
from repro_torch.models.layers import ParamDef, stack_defs

F32 = torch.float32


def tp_all_reduce(partial: torch.Tensor) -> torch.Tensor:
    """Sum an f32 partial product over this rank's model group, in place.
    A block holding a weight shard needs a sharding context whose model
    axis is wider than one device."""
    ctx = current_ctx()
    group = ctx.group("model") if ctx is not None else None
    if group is None:
        raise RuntimeError("a DiT block holds a weight shard, but no "
                           "sharding context with a model axis is active")
    dist.all_reduce(partial, group=group)
    return partial


def _ln(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm without affine params (DiT uses modulate instead)."""
    xf = x.to(F32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + 1e-6)).to(x.dtype)


def _make_params(module: nn.Module, specs: Dict[str, ParamDef],
                 dtype: torch.dtype, device: torch.device) -> None:
    for name, d in specs.items():
        module.register_parameter(name, nn.Parameter(
            torch.zeros(d.shape, dtype=dtype, device=device),
            requires_grad=False))


class DiTBlock(nn.Module):
    """One block's parameters (the reference's ``params["blocks"][...][l]``)."""

    def __init__(self, specs: Dict[str, ParamDef], dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.specs = specs
        _make_params(self, specs, dtype, device)


class DiTModel(nn.Module):
    def __init__(self, cfg: ModelConfig, device: DeviceLike = "cuda"):
        super().__init__()
        if cfg.family != "dit" or cfg.dit is None:
            raise ValueError(f"DiTModel requires a dit-family config with "
                             f"cfg.dit set; got family={cfg.family!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype_of(cfg.dtype)
        dit = cfg.dit
        self.grid = dit.image_size // dit.patch_size
        self.num_tokens = self.grid * self.grid
        self.patch_dim = dit.patch_size ** 2 * dit.in_channels
        self.out_dim = self.patch_dim * (2 if dit.learn_sigma else 1)
        _make_params(self, self._top_specs(), self.dtype, self.device)
        self.blocks = nn.ModuleList(
            DiTBlock(self._block_specs(), self.dtype, self.device)
            for _ in range(cfg.num_layers))

    # ------------------------------------------------------------------

    def _block_specs(self) -> Dict[str, ParamDef]:
        """One block's defs; init is "zeros", "normal" (0.02 std) or
        "fan_in" (1/sqrt(shape[-2]) std), axes the reference's."""
        cfg = self.cfg
        d, h, dh, f = (cfg.d_model, cfg.num_heads, cfg.resolved_head_dim,
                       cfg.d_ff)
        return {
            "ada_w": ParamDef((d, 6 * d), "zeros", axes=("embed", None)),
            "ada_b": ParamDef((6 * d,), "zeros", axes=(None,)),
            "wq": ParamDef((d, h, dh), "fan_in",
                           axes=("embed", "heads", "head_dim")),
            "wk": ParamDef((d, h, dh), "fan_in",
                           axes=("embed", "heads", "head_dim")),
            "wv": ParamDef((d, h, dh), "fan_in",
                           axes=("embed", "heads", "head_dim")),
            "wo": ParamDef((h, dh, d), "fan_in",
                           axes=("heads", "head_dim", "embed")),
            "w_in": ParamDef((d, f), "fan_in", axes=("embed", "ffn")),
            "b_in": ParamDef((f,), "zeros", axes=("ffn",)),
            "w_out": ParamDef((f, d), "fan_in", axes=("ffn", "embed")),
            "b_out": ParamDef((d,), "zeros", axes=("embed",)),
        }

    def _top_specs(self) -> Dict[str, ParamDef]:
        d = self.cfg.d_model
        return {
            "patch_w": ParamDef((self.patch_dim, d), "fan_in",
                                axes=(None, "embed")),
            "patch_b": ParamDef((d,), "zeros", axes=("embed",)),
            "pos_emb": ParamDef((self.num_tokens, d), "normal",
                                axes=(None, "embed")),
            "t_w1": ParamDef((256, d), "fan_in", axes=(None, "embed")),
            "t_b1": ParamDef((d,), "zeros", axes=("embed",)),
            "t_w2": ParamDef((d, d), "fan_in", axes=("embed", "embed")),
            "t_b2": ParamDef((d,), "zeros", axes=("embed",)),
            "label_emb": ParamDef((self.cfg.dit.num_classes + 1, d),
                                  "normal", axes=(None, "embed")),
            "final_ada_w": ParamDef((d, 2 * d), "zeros",
                                    axes=("embed", None)),
            "final_ada_b": ParamDef((2 * d,), "zeros", axes=(None,)),
            "final_w": ParamDef((d, self.out_dim), "zeros",
                                axes=("embed", None)),
            "final_b": ParamDef((self.out_dim,), "zeros", axes=(None,)),
        }

    def param_defs(self) -> Dict:
        """The reference's ``param_defs`` tree: the top-level defs plus the
        blocks' stacked over a leading ``layers`` axis."""
        defs = dict(self._top_specs())
        defs["blocks"] = stack_defs(self._block_specs(), self.cfg.num_layers)
        return defs

    @torch.no_grad()
    def init(self, generator: torch.Generator, unzero: bool = True
             ) -> "DiTModel":
        """Random weights drawn from ``generator`` (on the model's device).

        The reference's initializers (zeros / 0.02-normal / fan-in normal).
        With ``unzero`` the adaLN modulation and the output head are
        un-zeroed the way the reference's benchmarks do it
        (``benchmarks/common.py:build_dit``): under adaLN-zero every block
        is the identity and eps is identically 0, which makes any cache
        policy trivially exact."""
        def fill(p: torch.Tensor, shape, init: str, std_override=None):
            if init == "zeros" and std_override is None:
                p.zero_()
                return
            if std_override is not None:
                std = std_override
            elif init == "fan_in":
                std = 1.0 / (shape[-2] if len(shape) >= 2 else shape[-1]) ** 0.5
            else:
                std = 0.02
            p.copy_(torch.randn(shape, generator=generator, device=p.device,
                                dtype=F32) * std)

        unz = {"ada_w": 0.05, "ada_b": 0.2,
               "final_w": 1.0 / self.cfg.d_model ** 0.5} if unzero else {}
        for name, d in self._top_specs().items():
            fill(getattr(self, name), d.shape, d.init, unz.get(name))
        for blk in self.blocks:
            for name, d in blk.specs.items():
                fill(getattr(blk, name), d.shape, d.init, unz.get(name))
        return self

    # ------------------------------------------------------------------

    def conditioning(self, t: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
        """(B,) timesteps + (B,) labels -> (B, D) conditioning vector."""
        temb = common.timestep_embedding(t, 256)
        temb = common.fdot(temb.to(self.dtype), self.t_w1) + self.t_b1
        temb = F.silu(temb.to(F32)).to(temb.dtype)
        temb = common.fdot(temb, self.t_w2) + self.t_b2
        yemb = self.label_emb[labels]
        return temb + yemb

    def block_apply(self, bp: DiTBlock, x: torch.Tensor,
                    c: torch.Tensor) -> torch.Tensor:
        """One DiT block. x: (B,N,D); c: (B,D).  The weights may be local
        shards (see the module docstring)."""
        cfg = self.cfg
        mod = common.fdot(F.silu(c.to(F32)).to(x.dtype), bp.ada_w) + bp.ada_b
        sh1, sc1, g1, sh2, sc2, g2 = mod.chunk(6, dim=-1)
        h = common.modulate(_ln(x), sh1, sc1)
        q = common.feinsum("bnd,dhk->bnhk", h, bp.wq)
        k = common.feinsum("bnd,dhk->bnhk", h, bp.wk)
        v = common.feinsum("bnd,dhk->bnhk", h, bp.wv)
        o = attend_bidirectional(q, k, v)
        if bp.wo.shape[0] != cfg.num_heads:      # a share of the heads
            o = tp_all_reduce(torch.einsum("bnhk,hkd->bnd", o.to(F32),
                                           bp.wo.to(F32))).to(x.dtype)
        else:
            o = common.feinsum("bnhk,hkd->bnd", o, bp.wo)
        x = x + g1[:, None, :] * o
        h = common.modulate(_ln(x), sh2, sc2)
        h = common.gelu_mlp(h, bp.w_in, bp.b_in, bp.w_out, bp.b_out,
                            reduce=(tp_all_reduce
                                    if bp.w_in.shape[1] != cfg.d_ff
                                    else None))
        x = x + g2[:, None, :] * h
        return constrain(x, "act_batch", "act_seq", "act_embed")

    def final_layer(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        mod = (common.fdot(F.silu(c.to(F32)).to(x.dtype), self.final_ada_w)
               + self.final_ada_b)
        sh, sc = mod.chunk(2, dim=-1)
        x = common.modulate(_ln(x), sh, sc)
        return common.fdot(x, self.final_w) + self.final_b

    # ------------------------------------------------------------------

    def tokens_in(self, latents: torch.Tensor) -> torch.Tensor:
        """(B, Hs, Ws, C) -> (B, N, D) with positional embedding."""
        p = self.cfg.dit.patch_size
        tok = common.patchify(latents.to(self.dtype), p)
        x = common.fdot(tok, self.patch_w) + self.patch_b
        return x + self.pos_emb[None]

    def eps_from_hidden(self, x: torch.Tensor, c: torch.Tensor
                        ) -> torch.Tensor:
        """Final layer + unpatchify of the noise-prediction channels."""
        out = self.final_layer(x, c)
        return common.unpatchify(out[..., :self.patch_dim],
                                 self.cfg.dit.patch_size, self.grid)

    @torch.no_grad()
    def apply(self, latents: torch.Tensor, t: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
        """latents (B,Hs,Ws,C), t (B,), labels (B,) -> eps (B,Hs,Ws,C)."""
        x = self.tokens_in(latents)
        c = self.conditioning(t, labels)
        for bp in self.blocks:
            x = self.block_apply(bp, x, c)
        return self.eps_from_hidden(x, c)

    def forward_train(self, latents: torch.Tensor, t: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
        """The differentiable forward: eps (B,Hs,Ws,C) with autograd."""
        x = self.tokens_in(latents)
        c = self.conditioning(t, labels)
        for bp in self.blocks:
            if self.cfg.remat:
                x = checkpoint(self.block_apply, bp, x, c,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = self.block_apply(bp, x, c)
        return self.eps_from_hidden(x, c)

    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Denoising MSE in f32: predict the noise added to clean latents
        (batch: ``latents``, ``t``, ``labels``, ``noise``)."""
        eps_hat = self.forward_train(batch["latents"], batch["t"],
                                     batch["labels"])
        mse = (eps_hat.to(F32) - batch["noise"].to(F32)).square().mean()
        return mse, {"mse": mse}
