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
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, dtype_of, resolve_device
from repro_torch.models import common
from repro_torch.models.attention import attend_bidirectional

F32 = torch.float32

# (shape, init) per parameter; init is "zeros", "normal" (0.02 std) or
# "fan_in" (1/sqrt(shape[-2]) std), as in the reference's ParamDefs
ParamSpec = Tuple[Tuple[int, ...], str]


def _ln(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm without affine params (DiT uses modulate instead)."""
    xf = x.to(F32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + 1e-6)).to(x.dtype)


def _make_params(module: nn.Module, specs: Dict[str, ParamSpec],
                 dtype: torch.dtype, device: torch.device) -> None:
    for name, (shape, _) in specs.items():
        module.register_parameter(name, nn.Parameter(
            torch.zeros(shape, dtype=dtype, device=device),
            requires_grad=False))


class DiTBlock(nn.Module):
    """One block's parameters (the reference's ``params["blocks"][...][l]``)."""

    def __init__(self, specs: Dict[str, ParamSpec], dtype: torch.dtype,
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

    def _block_specs(self) -> Dict[str, ParamSpec]:
        cfg = self.cfg
        d, h, dh, f = (cfg.d_model, cfg.num_heads, cfg.resolved_head_dim,
                       cfg.d_ff)
        return {
            "ada_w": ((d, 6 * d), "zeros"),
            "ada_b": ((6 * d,), "zeros"),
            "wq": ((d, h, dh), "fan_in"),
            "wk": ((d, h, dh), "fan_in"),
            "wv": ((d, h, dh), "fan_in"),
            "wo": ((h, dh, d), "fan_in"),
            "w_in": ((d, f), "fan_in"),
            "b_in": ((f,), "zeros"),
            "w_out": ((f, d), "fan_in"),
            "b_out": ((d,), "zeros"),
        }

    def _top_specs(self) -> Dict[str, ParamSpec]:
        d = self.cfg.d_model
        return {
            "patch_w": ((self.patch_dim, d), "fan_in"),
            "patch_b": ((d,), "zeros"),
            "pos_emb": ((self.num_tokens, d), "normal"),
            "t_w1": ((256, d), "fan_in"),
            "t_b1": ((d,), "zeros"),
            "t_w2": ((d, d), "fan_in"),
            "t_b2": ((d,), "zeros"),
            "label_emb": ((self.cfg.dit.num_classes + 1, d), "normal"),
            "final_ada_w": ((d, 2 * d), "zeros"),
            "final_ada_b": ((2 * d,), "zeros"),
            "final_w": ((d, self.out_dim), "zeros"),
            "final_b": ((self.out_dim,), "zeros"),
        }

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
        for name, (shape, init) in self._top_specs().items():
            fill(getattr(self, name), shape, init, unz.get(name))
        for blk in self.blocks:
            for name, (shape, init) in blk.specs.items():
                fill(getattr(blk, name), shape, init, unz.get(name))
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
        """One DiT block. x: (B,N,D); c: (B,D)."""
        mod = common.fdot(F.silu(c.to(F32)).to(x.dtype), bp.ada_w) + bp.ada_b
        sh1, sc1, g1, sh2, sc2, g2 = mod.chunk(6, dim=-1)
        h = common.modulate(_ln(x), sh1, sc1)
        q = common.feinsum("bnd,dhk->bnhk", h, bp.wq)
        k = common.feinsum("bnd,dhk->bnhk", h, bp.wk)
        v = common.feinsum("bnd,dhk->bnhk", h, bp.wv)
        o = attend_bidirectional(q, k, v)
        o = common.feinsum("bnhk,hkd->bnd", o, bp.wo)
        x = x + g1[:, None, :] * o
        h = common.modulate(_ln(x), sh2, sc2)
        h = common.gelu_mlp(h, bp.w_in, bp.b_in, bp.w_out, bp.b_out)
        return x + g2[:, None, :] * h

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
