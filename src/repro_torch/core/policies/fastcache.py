"""fastcache: the paper's method (Alg. 1) — STR token partition + per-block
chi^2 statistical gate + learnable linear approximation + motion-aware
blending, with per-sample block gates.

State: the previous step's token embeddings (Eq. 1 saliency reference), the
per-block input-hidden stack (L+1, B, N, D) that the linear approximators
blend against, the chi^2 variance trackers, and the warm-up flag.

The reference branches on device values with ``lax.cond`` in two places:
the cold / mixed / warm dispatch of ``step`` and the "every sample caches:
skip the block" test in each layer.  Both branches give identical per-row
results, so either way is exact.  The dispatch reads the host mirror of
``have_cache`` (``CachePolicy.step_kind``): nothing crosses.  The
per-layer skip goes through ``branch``: an IF node of the captured warm
step on the card (nothing crosses; ``fused_gate`` sets its condition from
the gate bits it makes, so no kernel reads the mask again), else one host
read per layer on an all-warm step, counted in ``host_syncs``.  A mixed
step skips the per-layer test: its cold rows are never eligible, so the
block always runs.

The state is written in place.  Layer l reads slots l and l + 1 of the
hidden stack ``prev_hidden`` and writes slot l only after both reads, so no
second stack is needed; slot L (the final hidden) is written last.

Kernels per gated (warm or mixed) step: ``saliency_delta`` once (the STR
saliency), ``linear_blend`` once (the static bypass) and ``fused_gate`` in
every layer.  With ``gate_mode="global"`` (the whole batch makes one
decision per layer, an ablation) each layer runs ``saliency_delta`` and
``linear_blend`` in place of ``fused_gate``, as the reference computes that
mode in plain jnp outside its fused kernel.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from repro_torch.core import chi2, linear_approx, saliency, statcache
from repro_torch.core.policies.base import F32, CachePolicy, register
from repro_torch.core.step_graph import producer_condition
from repro_torch.cuda_kernels.fused_gate import fused_gate
from repro_torch.cuda_kernels.linear_blend import linear_blend
from repro_torch.cuda_kernels.saliency_delta import saliency_delta
from repro_torch.distributed.sharding import constrain


@register("fastcache")
class FastCache(CachePolicy):
    MIRRORED = ("have_cache",)

    def __init__(self, model, fc, fc_params, **kw):
        super().__init__(model, fc, fc_params, **kw)
        # the tensor-core copies of W_c and each W_l[l], single or split,
        # made once (None each off a bf16 model on CUDA)
        (self.w_c_bf16,) = self.map_copies(fc_params["W_c"])
        self.w_l_bf16 = self.map_copies(fc_params["W_l"])
        # n_tokens is the reduced grid when token compression is on
        self.capacity = max(1, int(round(fc.motion_capacity * self.n_tokens)))

    def init_state(self, batch: int) -> Dict:
        n, d = self.n_tokens, self.model.cfg.d_model
        dt, dev = self.model.dtype, self.device
        return {
            "prev_tokens_in": torch.zeros((batch, n, d), dtype=dt, device=dev),
            "prev_hidden": torch.zeros((self.L + 1, batch, n, d), dtype=dt,
                                       device=dev),
            "gate": statcache.init_gate_state(self.L, batch, dev),
            "have_cache": torch.zeros((batch,), dtype=torch.bool, device=dev),
            "stats": self.init_stats(batch),
        }

    # -- audit plane -----------------------------------------------------

    def audit_hidden(self, state):
        """After ``step``, ``prev_hidden`` is this step's hidden stack —
        block inputs plus the reassembled final hidden, in
        ``audit_forward``'s (L+1, B, N, D) layout."""
        return state["prev_hidden"]

    def predicted_error_bound(self):
        """Eq. 9 bound from the chi^2 gate, with the df the gate uses
        (motion capacity x d_model: one sample's observed elements)."""
        nd = self.capacity * self.model.cfg.d_model
        return chi2.error_bound(self.fc.alpha, nd)

    def reset_rows(self, state: Dict, rows: Sequence[int]) -> Dict:
        # fill_ on views: assigning a Python scalar to a 0-dim CUDA view
        # goes through a host copy that synchronizes
        for r in rows:
            state["prev_tokens_in"][r].fill_(0.0)
            state["prev_hidden"][:, r].fill_(0.0)
            state["have_cache"][r].fill_(False)
        statcache.reset_gate_slot(state["gate"], rows)
        return super().reset_rows(state, rows)

    # ------------------------------------------------------------------

    def device_step(self, state, x_in, c, kind):
        if kind == "warm":
            return self._gated_step(state, x_in, c, can_skip=True)
        if kind == "mixed":
            return self._mixed_step(state, x_in, c)
        return self._cold_step(state, x_in, c)

    def _cold_step(self, state, x_in, c):
        """Warm-up: one full forward installing the cache payload."""
        x_out, inputs = self._full_forward(x_in, c)
        eps = self._eps(x_out, c)
        state["prev_tokens_in"].copy_(x_in)
        state["prev_hidden"][:-1].copy_(inputs)
        state["prev_hidden"][-1].copy_(x_out)
        state["have_cache"].fill_(True)
        stats = state["stats"]
        stats["blocks_computed"].add_(float(self.L))
        stats["motion_frac_sum"].add_(1.0)
        return eps

    # ------------------------------------------------------------------
    # FastCache proper (Alg. 1), per-sample block gates
    # ------------------------------------------------------------------

    def _gated_step(self, state, x_in, c, *, can_skip: bool):
        fc = self.fc
        fcp = self.fc_params
        b, n, d = x_in.shape
        hidden = state["prev_hidden"]

        # ---- STR: token partition (Eqs. 1-2), per-sample
        if fc.use_str:
            sal = saliency.token_saliency(x_in, state["prev_tokens_in"])
            part = saliency.partition_tokens(sal, fc.motion_threshold,
                                             self.capacity)
        else:
            sal = torch.full((b, n), float("inf"), dtype=F32,
                             device=x_in.device)
            part = saliency.partition_tokens(sal, -1.0, n)
        mfrac = saliency.motion_fraction(part)               # (B,)

        # ---- static bypass (Eq. 3) + MB blend with previous final hidden;
        # the bypass is the linear_blend kernel at gamma = 1 (apply_linear's
        # result), the blend stays a second bf16 rounding as in the reference
        flat = x_in.reshape(b * n, d)
        h_static = linear_blend(flat, fcp["W_c"], fcp["b_c"], flat,
                                gamma=1.0, w_bf16=self.w_c_bf16,
                                gemm=self.gemm
                                ).reshape(b, n, d)
        if fc.use_mb:
            h_static = linear_approx.blend(h_static, hidden[-1],
                                           fc.blend_gamma)

        # ---- motion stream through gated blocks
        xm = saliency.gather_motion(x_in, part)              # (B,C,D)
        gate = state["gate"]
        nd = int(xm.shape[1] * xm.shape[2])
        threshold = statcache.make_threshold(fc.alpha, nd)
        if self.gate_mode == "global":
            threshold_g = statcache.make_threshold(fc.alpha, nd * b)
        sig, ini = gate.sigma2, gate.initialized
        comp = torch.zeros((b,), dtype=F32, device=x_in.device)
        skip = torch.zeros((b,), dtype=F32, device=x_in.device)
        for lidx, bp in enumerate(self.model.blocks):
            prev_in = hidden[lidx]
            prev_m = saliency.gather_motion(prev_in, part)
            prev_om = saliency.gather_motion(hidden[lidx + 1], part)
            eligible = ini[lidx] & bool(fc.use_sc)
            cond = None
            if self.gate_mode == "global":
                out, do_cache, diff = self._global_gate(
                    lidx, xm, prev_m, prev_om, sig[lidx], eligible, nd * b,
                    threshold_g)
            else:
                # in a captured warm step B1 sets the block's IF node's
                # condition, !all(gate), itself (no condition kernel)
                cond = producer_condition(xm.device) if can_skip else None
                out, do_cache, diff, _ = fused_gate(
                    xm, prev_m, prev_om, fcp["W_l"][lidx], fcp["b_l"][lidx],
                    sig[lidx], eligible, threshold=threshold,
                    gamma=fc.blend_gamma, use_blend=fc.use_mb,
                    w_bf16=self.w_l_bf16[lidx], gemm=self.gemm, cond=cond)

            # ``out`` holds the skip side (every sample caches); otherwise
            # the block runs once for the batch and the cached samples keep
            # their approximation (agreed over the model group when the
            # block's weights are sharded: every rank of the group enters
            # its all-reduce or none)
            def compute(xm=xm, bp=bp, out=out, do_cache=do_cache):
                out.copy_(torch.where(do_cache[:, None, None], out,
                                      self.model.block_apply(bp, xm, c)))

            if can_skip:
                self.branch(do_cache, compute, cond=cond)
            else:
                compute()
            xm_new = constrain(out, "act_batch", "act_seq", "act_embed")
            # sliding-window variance tracker updates on recompute
            new_sig, _ = statcache.update_sigma(
                sig[lidx], ini[lidx], diff, nd, fc.background_momentum)
            sig[lidx].copy_(torch.where(do_cache, sig[lidx], new_sig))
            ini[lidx].fill_(True)
            dc = do_cache.to(F32)
            comp = comp + (1.0 - dc)
            skip = skip + dc
            # cache payload: this block's input scattered over prev grid,
            # into slot lidx once slots lidx and lidx + 1 have been read
            prev_in.copy_(saliency.scatter_motion(prev_in, xm, part))
            xm = xm_new

        # ---- reassemble full grid (concat of Eq. 2 sets)
        h_final = saliency.scatter_motion(h_static, xm, part)
        eps = self._eps(h_final, c)

        state["prev_tokens_in"].copy_(x_in)
        hidden[-1].copy_(h_final)
        stats = state["stats"]
        stats["blocks_computed"].add_(comp)
        stats["blocks_skipped"].add_(skip)
        stats["motion_frac_sum"].add_(mfrac)
        return eps

    def _global_gate(self, lidx, xm, prev_m, prev_om, sig, eligible,
                     n_total, threshold_g):
        """The whole batch's decision (``gate_mode="global"``): the
        per-sample totals of ``saliency_delta`` reduced to one chi^2
        statistic, and the approximation through ``linear_blend`` at gamma
        1 with the motion-aware blend after it, as the reference computes
        ``apply_linear`` then ``blend``.  Returns (out, do_cache (B,),
        per-sample diff)."""
        fc, fcp = self.fc, self.fc_params
        b, cap, d = xm.shape
        _, diff, _ = saliency_delta(xm, prev_m)
        do_cache = (statcache.gate_decision_global(diff, sig, n_total,
                                                   threshold_g)
                    & eligible.all()).expand(b)
        flat = xm.reshape(b * cap, d)
        approx = linear_blend(flat, fcp["W_l"][lidx], fcp["b_l"][lidx],
                              flat, gamma=1.0, w_bf16=self.w_l_bf16[lidx],
                              gemm=self.gemm
                              ).reshape(b, cap, d)
        if fc.use_mb:
            approx = linear_approx.blend(approx, prev_om, fc.blend_gamma)
        out = torch.where(do_cache[:, None, None], approx, xm)
        return out, do_cache, diff

    def _mixed_step(self, state, x_in, c):
        """Mixed warm/cold batch (a request admitted mid-flight): cold
        samples take a full forward, warm samples the gated path; results
        and state are selected per sample.  With token compression on both
        run on the reduced grid and both ``_eps`` calls unmerge with this
        step's assignment."""
        warm = state["have_cache"]
        x_out, inputs = self._full_forward(x_in, c)
        hidden = torch.cat([inputs, x_out[None]], dim=0)
        eps_full = self._eps(x_out, c)
        # what the gated step overwrites and the cold rows keep
        gate, stats = state["gate"], state["stats"]
        old_gate = statcache.GateState(sigma2=gate.sigma2.clone(),
                                       initialized=gate.initialized.clone())
        old = {k: stats[k].clone() for k in ("blocks_computed",
                                             "blocks_skipped",
                                             "steps_reused",
                                             "motion_frac_sum")}
        eps_fc = self._gated_step(state, x_in, c, can_skip=False)

        eps = torch.where(warm[:, None, None, None], eps_fc,
                          eps_full.to(eps_fc.dtype))
        prev = state["prev_hidden"]
        prev.copy_(torch.where(warm[None, :, None, None], prev,
                               hidden.to(prev.dtype)))
        # cold samples' warm-up leaves the gate untouched (as _cold_step)
        for now, before in zip(gate, old_gate):
            now.copy_(torch.where(warm[None, :], now, before))
        stats["blocks_computed"].copy_(torch.where(
            warm, stats["blocks_computed"], old["blocks_computed"] + self.L))
        for k in ("blocks_skipped", "steps_reused"):
            stats[k].copy_(torch.where(warm, stats[k], old[k]))
        stats["motion_frac_sum"].copy_(torch.where(
            warm, stats["motion_frac_sum"], old["motion_frac_sum"] + 1.0))
        state["have_cache"].fill_(True)
        return eps
