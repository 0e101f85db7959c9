"""CachedDecoder — FastCache's statistical block gate applied to
autoregressive LLM decode steps, after the reference's
``core/decode_runner.py:CachedDecoder``.

The iterative axis is the decode step: the chi^2 gate (Eq. 7) on each
layer's block input decides, per sample, whether to replace the block with
its learnable linear approximation (Eq. 6).  ``reset_slot`` re-arms one
slot's trackers when the serving engine gives it a new request.

KV-cache consistency: on a skipped block the position's K/V are still
computed from the (normalized) block input and written (``_kv_write``), so
later tokens attend to an approximated-but-present entry; when any sample
recomputes, the block writes the same K/V for every sample.

The reference's ``lax.cond(jnp.all(do_cache), all_skip, mixed)`` is a real
skip here, through ``step_graph.branch``: in a captured decode step (the
serving engine's default on the card) its two sides are IF nodes and
nothing crosses to the host; eagerly, one host sync per layer per decode
step reads ``all(do_cache)``, counted in ``host_syncs``.  The state's
``stats["layers_skipped"]`` counts the layers where every sample skipped,
on the device (the skip side adds one).  Both branches give the same
per-row results, so either way is exact.  The mixed branch runs the block
on the whole batch, cached slots included, and keeps the approximation
for those slots, as the reference does; in an MoE block the cached slots'
tokens therefore take part in the routing and share the experts'
capacity.  The all-skip branch writes K/V only, indexed by the device
``step`` tensor as the block does.  ``gate_mode="global"`` reduces the
statistic over the batch into one decision per layer.  The cache and the
state are updated in place (layer l reads and then writes slot l of
``prev_hidden``); the same dicts come back.

Kernels per decode step, in every layer: ``saliency_delta`` on the (B, 1, D)
block input against the previous step's (its per-sample totals are the
gate's ||dH||^2 and ||H_prev||^2) and ``linear_blend`` at gamma 1 for the
approximation W_l x + b_l (on the wgmma route it multiplies the bf16 copies
of W_l, on the wgmma_split route the split copies of maps handed in, made
once in the constructor).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import FastCacheConfig
from repro_torch.core import linear_approx, statcache
from repro_torch.core.statcache import GATE_MODES
from repro_torch.core.step_graph import branch
from repro_torch.cuda_kernels.linear_blend import linear_blend
from repro_torch.cuda_kernels.saliency_delta import saliency_delta
from repro_torch.models import common, layers
from repro_torch.models.transformer import Cache, TransformerModel

F32 = torch.float32


class CachedDecoder:
    def __init__(self, model: TransformerModel, fc: FastCacheConfig,
                 fc_params: Optional[Dict[str, torch.Tensor]] = None):
        if model.period != 1 or model.kinds != ("attn",):
            raise ValueError("CachedDecoder supports period-1 attention "
                             f"stacks; got {model.kinds}")
        if fc.gate_mode not in GATE_MODES:
            raise ValueError(f"unknown gate_mode {fc.gate_mode!r}; "
                             f"expected one of {GATE_MODES}")
        self.model = model
        self.fc = fc
        self.gate_mode = fc.gate_mode
        self.L = model.cfg.num_layers
        # as CachedDiT's: the identity maps get the bf16 copies of W_l[l]
        # the wgmma route multiplies, maps handed in the split copies the
        # wgmma_split route multiplies, made once (None each off a bf16
        # model on CUDA)
        self.split_maps = fc_params is not None
        self.fc_params = fc_params or linear_approx.init_linear_params(
            self.L, model.cfg.d_model, device=model.device)
        self.w_l_bf16 = (linear_approx.split_copies if self.split_maps
                         else linear_approx.bf16_copies)(
            self.fc_params["W_l"], model.dtype, model.device)
        self.host_syncs = 0

    def init_state(self, batch: int) -> Dict:
        m = self.model
        dev = m.device
        return {
            "prev_hidden": torch.zeros((self.L + 1, batch, m.cfg.d_model),
                                       dtype=m.dtype, device=dev),
            "gate": statcache.init_gate_state(self.L, batch, dev),
            "have_cache": torch.zeros((batch,), dtype=torch.bool, device=dev),
            "stats": {"blocks_computed": torch.zeros((batch,), dtype=F32,
                                                     device=dev),
                      "blocks_skipped": torch.zeros((batch,), dtype=F32,
                                                    device=dev),
                      "layers_skipped": torch.zeros((), dtype=F32,
                                                    device=dev),
                      "steps": torch.zeros((), dtype=F32, device=dev)},
        }

    def reset_slot(self, state: Dict, slot: int) -> Dict:
        """Re-arm one slot for a new request, in place: drop its hidden
        cache and variance trackers without disturbing its batchmates.
        Stats stay cumulative (engine-lifetime counters)."""
        state["have_cache"][slot].fill_(False)   # fill_: no host sync
        statcache.reset_gate_slot(state["gate"], [slot])
        state["prev_hidden"][:, slot].fill_(0.0)
        return state

    def _kv_write(self, p_attn, x: torch.Tensor, cache: Cache,
                  decode_pos: torch.Tensor) -> None:
        """Write this position's K/V from block input x (B,1,D) on skip."""
        cfg = self.model.cfg
        h_in = common.rms_norm(x, p_attn.norm, cfg.norm_eps)
        k = common.feinsum("bsd,dhk->bshk", h_in, p_attn.wk)
        v = common.feinsum("bsd,dhk->bshk", h_in, p_attn.wv)
        if cfg.qk_norm:
            k = common.rms_norm(k, p_attn.k_norm, cfg.norm_eps)
        k = common.rope_dispatch(k, decode_pos[:, None], cfg.rope_kind,
                                 cfg.rope_theta, cfg.mrope_sections)
        layers.write_kv(cache, k, v, decode_pos)

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: Cache, state: Dict
                    ) -> Tuple[torch.Tensor, Cache, Dict]:
        """tokens (B,). Returns (logits, cache, state), the cache and the
        state written in place."""
        m = self.model
        cfg = m.cfg
        fc = self.fc
        fcp = self.fc_params
        step = cache["step"]
        x = m.embed({"tokens": tokens[:, None]})           # (B,1,D)
        b = x.shape[0]
        positions = step[:, None]
        nd = int(x.shape[-1])                # per-sample elements (one token)
        threshold = statcache.make_threshold(fc.alpha, nd)
        if self.gate_mode == "global":
            threshold_g = statcache.make_threshold(fc.alpha, nd * b)
        gate = state["gate"]
        have = state["have_cache"]
        hidden = state["prev_hidden"]
        stats = state["stats"]
        sig, ini = gate.sigma2, gate.initialized
        comp = torch.zeros((b,), dtype=F32, device=x.device)
        skip = torch.zeros((b,), dtype=F32, device=x.device)
        for l, bp in enumerate(m.blocks):
            # (B, 1, D) rows: the kernel's per-sample totals are the
            # reference's delta_stats_per_sample(x[:, 0], prev_in)
            _, diff, prevsq = saliency_delta(x, hidden[l][:, None])
            eligible = ini[l] & have
            if not fc.use_sc:
                eligible = torch.zeros_like(eligible)
            if self.gate_mode == "global":
                do_cache = (statcache.gate_decision_global(
                    diff, sig[l], nd * b, threshold_g)
                    & eligible.all()).expand(b)
            else:
                do_cache = statcache.gate_decision(diff, prevsq, sig[l], nd,
                                                   threshold) & eligible
            flat = x[:, 0]
            # the carry: the approximation, every sample's on the skip side
            out = linear_blend(flat, fcp["W_l"][l], fcp["b_l"][l], flat,
                               gamma=1.0, w_bf16=self.w_l_bf16[l])[:, None]
            lc = m.layer_cache(cache, l)

            def skip_side(x=x, bp=bp, lc=lc):
                self._kv_write(bp.attn, x, lc, step)
                stats["layers_skipped"].add_(1.0)

            def compute(x=x, bp=bp, lc=lc, out=out, do_cache=do_cache):
                x_blk = m.block_apply(bp, x, positions=positions, cache=lc,
                                      decode_pos=step)[0]
                out.copy_(torch.where(do_cache[:, None, None], out, x_blk))

            self.host_syncs += branch(do_cache, compute, skip_side)
            # only observe deltas taken against a REAL previous hidden: after
            # a slot reset prev_hidden is zeroed and ||h - 0||^2 would poison
            # the no-change variance into an always-skip gate
            observe = ~do_cache & have
            new_sig, _ = statcache.update_sigma(sig[l], ini[l], diff, nd,
                                                fc.background_momentum)
            sig[l].copy_(torch.where(observe, new_sig, sig[l]))
            ini[l].copy_(ini[l] | observe)
            dc = do_cache.to(F32)
            comp = comp + (1.0 - dc)
            skip = skip + dc
            hidden[l].copy_(x[:, 0])
            x = out
        x = common.rms_norm(x, m.top.final_norm, cfg.norm_eps)
        logits = m.unembed(x[:, 0])
        step.add_(1)

        hidden[-1].copy_(x[:, 0])
        have.fill_(True)
        stats["blocks_computed"].add_(comp)
        stats["blocks_skipped"].add_(skip)
        stats["steps"].add_(1.0)
        return logits, cache, state
