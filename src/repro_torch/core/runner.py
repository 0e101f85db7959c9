"""CachedDiT: a thin shell around the cache-policy registry.

  init_state(batch)           -> policy.init_state
  reset_slot(state, rows)     -> policy.reset_rows (re-arm serving slot rows;
                                 stats stay cumulative)
  snapshot_slot(state, rows)  -> policy.snapshot_rows (a preemption
                                 checkpoint of the rows, a copy)
  restore_slot(state, snap, rows)
                              -> policy.restore_rows (write it back, in place)
  step(state, latents, t, labels)
                              -> tokens_in + conditioning, then the
                                 policy's step; the state is written in
                                 place and comes back as the same dict
  stats(state)                -> policy.stats

Gating is per sample: one moving sample never invalidates its batchmates'
caches, which the serving engine's solo-replay contract rests on.
``FastCacheConfig.gate_mode="global"`` restores the whole-batch decision
(the statistic reduced over the batch) for ablations.

Token compression (``core/token_reduce.py``) runs between ``tokens_in`` and
the policy when ``fc.merge_enabled`` asks for it: the policy sees the
reduced grid and unmerges inside ``_eps``.  Every registered policy composes
with it.

**Step graphs.**  With ``step_graph=True`` (on the card; the serving
engines turn it on there) a warm step, one whose rows all hold a cache by
the policy's host mirror, is ``tokens_in``, ``conditioning``, the reducer
and the policy's device step captured once as a CUDA graph and replayed
(``core/step_graph.py``): the latents, ``t`` and labels are copied into
the graph's buffers, the graph is replayed, and the policy's skipped
blocks are IF nodes, so the step launches one graph and reads nothing.
Cold and mixed steps (admissions) stay eager.  The eps a replay returns is
the graph's buffer, overwritten by the next replay.

The audit plane (``obs/audit.py``) reads three more: ``audit_eval`` (the
uncached full forward of the same inputs), ``audit_hidden`` (the cached
path's hidden stack) and ``audit_bound`` (the policy's claimed bound).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import FastCacheConfig
from repro_torch.core import linear_approx
from repro_torch.core import policies as _policies  # noqa: F401 (registers)
from repro_torch.core.policies.base import Rows, get_policy_class, row_index
from repro_torch.core.policies.l2c import l2c_mask_from_deltas  # noqa: F401
from repro_torch.core.statcache import GATE_MODES
from repro_torch.core.step_graph import StepGraphs
from repro_torch.core.token_reduce import STATE_KEY as TOKRED_KEY
from repro_torch.core.token_reduce import TokenReducer
from repro_torch.cuda_kernels import route
from repro_torch.models.dit import DiTModel


class CachedDiT:
    """DiT sampling under a named cache policy."""

    def __init__(self, model: DiTModel, fc: FastCacheConfig,
                 policy: str = "fastcache",
                 fc_params: Optional[Dict[str, torch.Tensor]] = None,
                 fora_interval: int = 3,
                 tea_threshold: float = 0.15,
                 ada_thresholds: Tuple[float, float] = (0.05, 0.15),
                 fb_rdt: float = 0.08,
                 l2c_mask=None,
                 step_graph: bool = False,
                 simt_maps: bool = False,
                 **policy_kwargs):
        """The per-policy knobs are the reference's front-door keywords;
        with ``**policy_kwargs`` (e.g. smoothcache's ``smooth_schedule``)
        the whole set goes to the resolved policy, which keeps the ones it
        knows.  Masks and schedules may be numpy or torch bool arrays.
        ``step_graph`` replays warm steps as CUDA graphs (the card only;
        see the module docstring).  ``simt_maps`` names the SIMT route (the
        f32 maps) for every ``linear_blend`` / ``fused_gate`` call on the
        maps, a yardstick; by default the wrappers' rule picks."""
        cls = get_policy_class(policy)     # ValueError on unknown names
        if fc.gate_mode not in GATE_MODES:
            raise ValueError(f"unknown gate_mode {fc.gate_mode!r}; "
                             f"expected one of {GATE_MODES}")
        self.model = model
        self.fc = fc
        self.policy = policy
        self.device = model.device
        self.gate_mode = fc.gate_mode
        self.L = model.cfg.num_layers
        # the identity maps of init_linear_params, which bf16 holds exactly,
        # get bf16 copies for the wgmma route; maps handed in (fitted by
        # calibrate_dit) get split copies, W as three bf16 terms, for the
        # wgmma_split route: a single bf16 copy of fitted maps moved the
        # static bypass by up to 8% rel-L2 on the card (PERF.md)
        split_maps = fc_params is not None
        self.fc_params = fc_params or linear_approx.init_linear_params(
            self.L, model.cfg.d_model, model.device)
        # a ratio whose static M fills the window leaves the reducer inert
        # and it is dropped, so r=1.0 runs exactly the merge-off step
        self.reducer: Optional[TokenReducer] = None
        if fc.merge_enabled:
            red = TokenReducer(model, fc)
            if red.active:
                self.reducer = red
        self.impl = cls(model, fc, self.fc_params, gate_mode=self.gate_mode,
                        gemm=route.SIMT if simt_maps else None,
                        split_maps=split_maps,
                        token_reducer=self.reducer,
                        fora_interval=fora_interval,
                        tea_threshold=tea_threshold,
                        ada_thresholds=ada_thresholds, fb_rdt=fb_rdt,
                        l2c_mask=l2c_mask, **policy_kwargs)
        self.graphs = StepGraphs()
        self.step_graph = step_graph

    @property
    def step_graph(self) -> bool:
        return self._step_graph

    @step_graph.setter
    def step_graph(self, on: bool) -> None:
        if on and self.device.type != "cuda":
            raise ValueError("step graphs are CUDA graphs: the runner's "
                             f"model is on {self.device}")
        self._step_graph = bool(on)

    @contextlib.contextmanager
    def eager(self):
        """Every step eager inside the block, whatever sets ``step_graph``
        there; the setting as it was after it."""
        on, self._step_graph = self._step_graph, False
        try:
            yield
        finally:
            self._step_graph = on

    def init_state(self, batch: int) -> Dict:
        """The policy's state for ``batch`` samples; with token compression
        on, the reducer's per-sample rows ride it under ``tokred``."""
        state = self.impl.init_state(batch)
        self.impl.bind_mirror(state)
        if self.reducer is not None:
            state[TOKRED_KEY] = self.reducer.init_rows(batch)
        return state

    def reset_slot(self, state: Dict, rows: Sequence[int]) -> Dict:
        """Re-arm the given sample rows (e.g. a slot's CFG cond/uncond pair)
        for a new request, in place, without disturbing batchmates."""
        state = self.impl.reset_rows(state, rows)
        if self.reducer is not None:
            self.reducer.reset_rows(state[TOKRED_KEY], rows)
        return state

    def snapshot_slot(self, state: Dict, rows: Rows) -> Dict:
        """Copy ``rows`` (a list of ints, or an int64 index tensor on the
        device) out of the state: the policy's rows by its rank rule
        (``CachePolicy.snapshot_rows``), the reducer's ``tokred`` rows when
        token compression is on.  The snapshot owns its memory."""
        idx = row_index(rows, self.device)
        snap = self.impl.snapshot_rows(
            {k: v for k, v in state.items() if k != TOKRED_KEY}, rows)
        if self.reducer is not None:
            snap[TOKRED_KEY] = self.reducer.snapshot_rows(state[TOKRED_KEY],
                                                          idx)
        return snap

    def restore_slot(self, state: Dict, snap: Dict, rows: Rows) -> Dict:
        """Write a ``snapshot_slot`` checkpoint into ``rows`` of the live
        state, in place and bitwise; ``rows`` may differ from the donor
        slot's."""
        idx = row_index(rows, self.device)
        # the policy's walk follows the state's keys: ``snap`` goes whole,
        # its mirror values with it
        out = self.impl.restore_rows(
            {k: v for k, v in state.items() if k != TOKRED_KEY}, snap, rows)
        if self.reducer is not None:
            out[TOKRED_KEY] = self.reducer.restore_rows(
                state[TOKRED_KEY], snap[TOKRED_KEY], idx)
        return out

    @torch.no_grad()
    def step(self, state: Dict, latents: torch.Tensor, t: torch.Tensor,
             labels: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """One denoising-model evaluation under the cache policy.  ``t`` and
        ``labels`` are (B,).  Returns (eps, state), the state written in
        place."""
        kind = self.impl.step_kind(state)
        if self._step_graph and kind == "warm":
            key = (self.policy, self.impl.gemm, self.impl.split_maps,
                   self.impl.n_tokens,
                   tuple(latents.shape), latents.dtype, t.dtype,
                   labels.dtype, self.model.dtype)
            eps = self.graphs.run(
                key, lambda x, tt, lab: self._device_step(state, x, tt, lab,
                                                          kind),
                (latents, t, labels), state)
        else:
            eps = self._device_step(state, latents, t, labels, kind)
        self.impl.host_step(state, kind)
        return eps, state

    def _device_step(self, state: Dict, latents: torch.Tensor,
                     t: torch.Tensor, labels: torch.Tensor,
                     kind: str) -> torch.Tensor:
        """The step's device work (what a step graph captures)."""
        x_in = self.model.tokens_in(latents)
        c = self.model.conditioning(t, labels)
        if self.reducer is not None:
            x_in = self.reducer.reduce(x_in, state[TOKRED_KEY])
        try:
            eps = self.impl.device_step(state, x_in, c, kind)
        finally:
            if self.reducer is not None:
                self.reducer._mm = None      # the MergeMap is per step only
        stats = state["stats"]
        stats["steps"].add_(1.0)
        if self.reducer is not None:
            kept = float(self.reducer.reduced_tokens)
            stats["tokens_kept"].add_(kept)
            stats["tokens_merged"].add_(self.model.num_tokens - kept)
        return eps

    def stats(self, state: Dict) -> Dict[str, float]:
        return self.impl.stats(state)

    # -- audit plane (obs/audit.py) ------------------------------------

    @torch.no_grad()
    def audit_eval(self, latents: torch.Tensor, t: torch.Tensor,
                   labels: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The shadow-compute twin of ``step``: the same tokens-in /
        conditioning feeding the policy's uncached full forward.  Returns
        ``(eps_true, hidden)``, hidden the (L+1, B, N, D) stack of
        ``CachePolicy.audit_forward``.  Touches no cache state or stats."""
        x_in = self.model.tokens_in(latents)
        c = self.model.conditioning(t, labels)
        return self.impl.audit_forward(x_in, c)

    def audit_hidden(self, state: Dict) -> Optional[torch.Tensor]:
        """The cached path's per-layer hidden stack for this step, or None
        when the policy keeps none.  With token compression on the stack
        lives on the reduced grid and cannot be compared layer by layer
        with the full-resolution shadow forward, so only the end-to-end eps
        error is audited."""
        if self.reducer is not None:
            return None
        return self.impl.audit_hidden(state)

    def audit_bound(self) -> Optional[float]:
        """The policy's claimed per-step relative error bound (None = no
        claim; see ``CachePolicy.predicted_error_bound``)."""
        return self.impl.predicted_error_bound()
