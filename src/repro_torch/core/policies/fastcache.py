"""fastcache: the paper's method (Alg. 1) — STR token partition + per-block
chi^2 statistical gate + learnable linear approximation + motion-aware
blending, with per-sample block gates.

State: the previous step's token embeddings (Eq. 1 saliency reference), the
per-block input-hidden stack (L+1, B, N, D) that the linear approximators
blend against, the chi^2 variance trackers, and the warm-up flag.

The reference branches on device values with ``lax.cond`` in two places:
the cold / mixed / warm dispatch of ``step`` and the "every sample caches:
skip the block" test in each layer.  Both branches give identical per-row
results, so either way is exact; the port keeps the real skip and pays one
host sync per decision: one per step (``have_cache`` read once, serving
both the all- and the any-test) plus one per layer on an all-warm step.  A
mixed step skips the per-layer test: its cold rows are never eligible, so
the block always runs.  ``host_syncs`` counts them.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from repro_torch.core import linear_approx, saliency, statcache
from repro_torch.core.policies.base import F32, CachePolicy, register
from repro_torch.cuda_kernels.fused_gate import fused_gate


@register("fastcache")
class FastCache(CachePolicy):
    def __init__(self, model, fc, fc_params, **kw):
        super().__init__(model, fc, fc_params, **kw)
        self.capacity = max(1, int(round(fc.motion_capacity * self.n_tokens)))
        # model steps by branch taken
        self.step_kinds = {"cold": 0, "mixed": 0, "warm": 0}

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

    def reset_rows(self, state: Dict, rows: Sequence[int]) -> Dict:
        # fill_ on views: assigning a Python scalar to a 0-dim CUDA view
        # goes through a host copy that synchronizes
        for r in rows:
            state["prev_tokens_in"][r].fill_(0.0)
            state["prev_hidden"][:, r].fill_(0.0)
            state["have_cache"][r].fill_(False)
        statcache.reset_gate_slot(state["gate"], rows)
        return state

    # ------------------------------------------------------------------

    def step(self, state, x_in, c):
        have = state["have_cache"].cpu()          # one host sync per step
        self.host_syncs += 1
        if bool(have.all()):
            self.step_kinds["warm"] += 1
            return self._gated_step(state, x_in, c, can_skip=True)
        if bool(have.any()):
            self.step_kinds["mixed"] += 1
            return self._mixed_step(state, x_in, c)
        self.step_kinds["cold"] += 1
        return self._cold_step(state, x_in, c)

    def _cold_step(self, state, x_in, c):
        """Warm-up: one full forward installing the cache payload."""
        x_out, inputs = self._full_forward(x_in, c)
        eps = self._eps(x_out, c)
        st = dict(state)
        st["prev_tokens_in"] = x_in
        st["prev_hidden"] = torch.cat([inputs, x_out[None]], dim=0)
        st["have_cache"] = torch.ones_like(state["have_cache"])
        stats = dict(st["stats"])
        stats["blocks_computed"] = stats["blocks_computed"] + float(self.L)
        stats["motion_frac_sum"] = stats["motion_frac_sum"] + 1.0
        st["stats"] = stats
        return eps, st

    # ------------------------------------------------------------------
    # FastCache proper (Alg. 1), per-sample block gates
    # ------------------------------------------------------------------

    def _gated_step(self, state, x_in, c, *, can_skip: bool):
        fc = self.fc
        fcp = self.fc_params
        b, n, d = x_in.shape

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

        # ---- static bypass (Eq. 3) + MB blend with previous final hidden
        h_static = linear_approx.apply_linear(fcp["W_c"], fcp["b_c"], x_in)
        if fc.use_mb:
            h_static = linear_approx.blend(h_static, state["prev_hidden"][-1],
                                           fc.blend_gamma)

        # ---- motion stream through gated blocks
        xm = saliency.gather_motion(x_in, part)              # (B,C,D)
        gate = state["gate"]
        nd = int(xm.shape[1] * xm.shape[2])
        threshold = statcache.make_threshold(fc.alpha, nd)
        sig = gate.sigma2.clone()
        ini = gate.initialized.clone()
        comp = torch.zeros((b,), dtype=F32, device=x_in.device)
        skip = torch.zeros((b,), dtype=F32, device=x_in.device)
        new_prev_in = []
        for lidx, bp in enumerate(self.model.blocks):
            prev_in = state["prev_hidden"][lidx]
            prev_out = state["prev_hidden"][lidx + 1]
            prev_m = saliency.gather_motion(prev_in, part)
            prev_om = saliency.gather_motion(prev_out, part)
            eligible = ini[lidx] & bool(fc.use_sc)
            out, do_cache, diff, _ = fused_gate(
                xm, prev_m, prev_om, fcp["W_l"][lidx], fcp["b_l"][lidx],
                sig[lidx], eligible, threshold=threshold,
                gamma=fc.blend_gamma, use_blend=fc.use_mb)

            # skip the block entirely when every sample caches; otherwise
            # compute it once for the batch and keep cached samples' approx
            if can_skip:
                self.host_syncs += 1
                all_cache = bool(do_cache.all())
            else:
                all_cache = False
            if all_cache:
                xm_new = out
            else:
                xm_new = torch.where(do_cache[:, None, None], out,
                                     self.model.block_apply(bp, xm, c))
            # sliding-window variance tracker updates on recompute
            new_sig, _ = statcache.update_sigma(
                sig[lidx], ini[lidx], diff, nd, fc.background_momentum)
            sig[lidx] = torch.where(do_cache, sig[lidx], new_sig)
            ini[lidx] = True
            dc = do_cache.to(F32)
            comp = comp + (1.0 - dc)
            skip = skip + dc
            # cache payload: this block's input scattered over prev grid
            new_prev_in.append(saliency.scatter_motion(prev_in, xm, part))
            xm = xm_new

        # ---- reassemble full grid (concat of Eq. 2 sets)
        h_final = saliency.scatter_motion(h_static, xm, part)
        eps = self._eps(h_final, c)

        st = dict(state)
        st["prev_tokens_in"] = x_in
        st["prev_hidden"] = torch.stack(new_prev_in + [h_final])
        st["gate"] = statcache.GateState(sigma2=sig, initialized=ini)
        stats = dict(st["stats"])
        stats["blocks_computed"] = stats["blocks_computed"] + comp
        stats["blocks_skipped"] = stats["blocks_skipped"] + skip
        stats["motion_frac_sum"] = stats["motion_frac_sum"] + mfrac
        st["stats"] = stats
        return eps, st

    def _mixed_step(self, state, x_in, c):
        """Mixed warm/cold batch (a request admitted mid-flight): cold
        samples take a full forward, warm samples the gated path; results
        and state are selected per sample."""
        warm = state["have_cache"]
        x_out, inputs = self._full_forward(x_in, c)
        hidden = torch.cat([inputs, x_out[None]], dim=0)
        eps_full = self._eps(x_out, c)
        eps_fc, st_fc = self._gated_step(state, x_in, c, can_skip=False)

        w3 = warm[:, None, None]
        eps = torch.where(warm[:, None, None, None], eps_fc,
                          eps_full.to(eps_fc.dtype))
        st = dict(st_fc)
        st["prev_tokens_in"] = torch.where(w3, st_fc["prev_tokens_in"], x_in)
        st["prev_hidden"] = torch.where(
            warm[None, :, None, None], st_fc["prev_hidden"],
            hidden.to(st_fc["prev_hidden"].dtype))
        # cold samples' warm-up leaves the gate untouched (as _cold_step)
        st["gate"] = statcache.GateState(
            sigma2=torch.where(warm[None, :], st_fc["gate"].sigma2,
                               state["gate"].sigma2),
            initialized=torch.where(warm[None, :], st_fc["gate"].initialized,
                                    state["gate"].initialized))
        st["have_cache"] = torch.ones_like(warm)
        old = state["stats"]
        stats = dict(st_fc["stats"])
        stats["blocks_computed"] = torch.where(
            warm, stats["blocks_computed"], old["blocks_computed"] + self.L)
        for k in ("blocks_skipped", "steps_reused"):
            stats[k] = torch.where(warm, stats[k], old[k])
        stats["motion_frac_sum"] = torch.where(
            warm, stats["motion_frac_sum"], old["motion_frac_sum"] + 1.0)
        st["stats"] = stats
        return eps, st
