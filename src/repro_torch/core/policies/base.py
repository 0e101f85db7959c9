"""The CachePolicy protocol, registry, and shared machinery.

A cache policy owns a dict of per-sample state tensors whose batch rows are
the serving slots (see the reference's ``core/policies/base.py`` for the
full contract).  The port's protocol:

  init_state(batch) -> dict     the policy's buffers plus the ``stats`` block
  reset_rows(state, rows)       re-arm sample rows (a list of ints) in place
  snapshot_rows(state, rows)    copy the rows out (a preemption checkpoint)
  restore_rows(state, snap, rows)  write a checkpoint back into rows, in place
  step(state, x_in, c)          one model evaluation -> (eps, new state); the
                                input state's tensors are not modified
  stats(state)                  host-side summary (``summarize_stats``)

and for the audit plane (``obs/audit.py``): ``audit_forward`` (the uncached
full forward of the same inputs, with its hidden stack), ``audit_hidden``
(the cached path's stack, or None) and ``predicted_error_bound`` (the
claimed per-step error, or None).  ``gate_mode="global"`` reduces
``_rel_change``'s statistic over the batch (one decision for all rows).

``state["stats"]`` holds per-sample (B,) f32 counters ``blocks_computed /
blocks_skipped / steps_reused / motion_frac_sum`` plus the scalar ``steps``;
with token compression on (a ``token_reducer`` handed in), also the (B,)
``tokens_kept / tokens_merged``.

Constructor knobs arrive through ``CachedDiT(..., **policy_kwargs)``: every
policy receives the whole set and keeps the ones it knows.

The step-level policies (fora, teacache, adacache, fbcache) share
``masked_step``; the reference's ``lax.cond(all(skip))`` there is a real
skip that reads the (B,) skip mask once per step, one host sync, counted in
``host_syncs``.
"""
from __future__ import annotations

from typing import (TYPE_CHECKING, Any, Callable, Dict, List, Optional,
                    Sequence, Tuple, Type, Union)

import numpy as np
import torch

from repro_torch.core import linear_approx
from repro_torch.cuda_kernels.saliency_delta import saliency_delta
from repro_torch.device import to_device
# the slot-axis rank rule is the sharding rules' own
from repro_torch.distributed.sharding import _slot_axis as slot_axis
from repro_torch.distributed.sharding import agree_all
from repro_torch.models.dit import DiTModel

if TYPE_CHECKING:
    from repro_torch.core.token_reduce import TokenReducer

F32 = torch.float32

Rows = Union[Sequence[int], torch.Tensor]

_REGISTRY: Dict[str, Type["CachePolicy"]] = {}


def register(name: str) -> Callable[[Type["CachePolicy"]],
                                    Type["CachePolicy"]]:
    """Class decorator: register a CachePolicy under ``name``."""
    def deco(cls: Type["CachePolicy"]) -> Type["CachePolicy"]:
        if name in _REGISTRY and _REGISTRY[name] is not cls:
            raise ValueError(f"cache policy {name!r} already registered "
                             f"({_REGISTRY[name].__qualname__})")
        cls.name = name
        _REGISTRY[name] = cls
        return cls
    return deco


def registered_policies() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def get_policy_class(name: str) -> Type["CachePolicy"]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown cache policy {name!r}; registered policies: "
            f"{', '.join(registered_policies()) or '(none)'}") from None


class CachePolicy:
    """Base class: holds the model and FastCache config and provides the
    shared forward / eps / statistics helpers."""

    name: str = ""

    def __init__(self, model: DiTModel, fc, fc_params, *,
                 gate_mode: str = "per_sample", gemm: Optional[str] = None,
                 token_reducer: Optional["TokenReducer"] = None, **_unused):
        self.model = model
        self.fc = fc
        self.fc_params = fc_params
        self.gate_mode = gate_mode
        # the GEMM route every linear_blend / fused_gate call on the maps
        # names: None for the wrappers' rule (wgmma on a bf16 model on CUDA,
        # with the copies of ``map_copies``), route.SIMT for the f32 maps
        # (the runner's choice for maps handed in)
        self.gemm = gemm
        self.L = model.cfg.num_layers
        # token-compression stage (core/token_reduce.py): with a reducer the
        # policy's whole transformer path runs on the statically reduced
        # grid — token-axis buffers are sized by ``self.n_tokens`` — and
        # ``_eps`` unmerges back to full resolution
        self.reducer = token_reducer
        self.n_tokens = (token_reducer.reduced_tokens
                         if token_reducer is not None else model.num_tokens)
        self.device = model.device
        # host syncs this policy forced (one per `.item()`-like read)
        self.host_syncs = 0

    def map_copies(self, w: torch.Tensor) -> List[Optional[torch.Tensor]]:
        """The bf16 copies of the maps ``w`` ((D, F) or (L, D, F)) that the
        wgmma route multiplies, made once (``linear_approx.bf16_copies``);
        None each where the calls name a route."""
        if self.gemm is not None:
            return [None] * w.reshape(-1, *w.shape[-2:]).shape[0]
        return linear_approx.bf16_copies(w, self.model.dtype, self.device)

    def init_state(self, batch: int) -> Dict:
        raise NotImplementedError

    def reset_rows(self, state: Dict, rows: Sequence[int]) -> Dict:
        """Default: nothing policy-specific to re-arm."""
        return state

    def snapshot_rows(self, state: Dict, rows: Rows) -> Dict:
        """Copy ``rows`` out of ``state`` into a snapshot of the same
        structure (the preemption checkpoint).  Every leaf that carries the
        sample batch under the ``slot_axis`` rank rule is row-copied along
        that axis (``index_select``: the snapshot owns its memory, so later
        writes into the donor rows never reach it); replicated leaves (the
        scalar ``steps``) pass through.  ``rows`` is a list of ints or an
        int64 index tensor on the state's device (the engine keeps one per
        slot, so a CUDA snapshot makes no host copy)."""
        batch = self._state_batch(state)
        idx = row_index(rows, self.device)

        def take(leaf):
            axis = slot_axis(tuple(leaf.shape), batch, self.L)
            return leaf if axis is None else leaf.index_select(axis, idx)

        return map_tree(take, state)

    def restore_rows(self, state: Dict, snap: Dict, rows: Rows) -> Dict:
        """Write a ``snapshot_rows`` checkpoint into ``rows`` of a live
        state, in place (``index_copy_``), bitwise; ``rows`` may differ from
        the donor's.  Replicated leaves keep the live value: engine-lifetime
        scalars like ``stats["steps"]`` are not rewound."""
        batch = self._state_batch(state)
        idx = row_index(rows, self.device)

        def put(leaf, sleaf):
            axis = slot_axis(tuple(leaf.shape), batch, self.L)
            if axis is not None:
                leaf.index_copy_(axis, idx, sleaf)
            return leaf

        return map_tree(put, state, snap)

    def _state_batch(self, state: Dict) -> int:
        """The state's sample-row count, read off the first (B,) counter of
        the mandatory ``stats`` block: the anchor the snapshot walkers
        classify every other leaf against."""
        for k, v in state.get("stats", {}).items():
            if k != "steps" and v.dim() == 1:
                return int(v.shape[0])
        raise ValueError(
            f"policy {self.name or type(self).__name__!r}: state carries no "
            "(B,) stats counter to infer the sample batch from; override "
            "snapshot_rows/restore_rows or add a per-sample stats key")

    def step(self, state: Dict, x_in: torch.Tensor, c: torch.Tensor
             ) -> Tuple[torch.Tensor, Dict]:
        raise NotImplementedError

    def stats(self, state: Dict) -> Dict[str, float]:
        return summarize_stats(state)

    def init_stats(self, batch: int) -> Dict[str, torch.Tensor]:
        """The per-sample (B,) counters every policy carries (the engine
        accumulates every (B,) key per request), plus the token counters
        when a reducer is on."""
        z = lambda: torch.zeros((batch,), dtype=F32, device=self.device)
        out = {"blocks_computed": z(), "blocks_skipped": z(),
               "steps_reused": z(), "motion_frac_sum": z(),
               "steps": torch.zeros((), dtype=F32, device=self.device)}
        if self.reducer is not None:
            out["tokens_kept"] = z()
            out["tokens_merged"] = z()
        return out

    def _eps_shape(self, batch: int) -> Tuple[int, ...]:
        dit = self.model.cfg.dit
        return (batch, dit.image_size, dit.image_size, dit.in_channels)

    def _full_forward(self, x: torch.Tensor, c: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full block-stack forward.  Returns ``(x_out, inputs)`` where
        ``inputs`` (L, B, N, D) stacks each block's input."""
        inputs = []
        for bp in self.model.blocks:
            inputs.append(x)
            x = self.model.block_apply(bp, x, c)
        return x, torch.stack(inputs)

    def _eps(self, hidden_final: torch.Tensor, c: torch.Tensor
             ) -> torch.Tensor:
        # a reduced-grid hidden is unmerged through this step's assignment
        # before the final layer; a full-resolution one passes through —
        # the dispatch is on the static token count
        if (self.reducer is not None
                and hidden_final.shape[-2] != self.model.num_tokens):
            hidden_final = self.reducer.unmerge(hidden_final)
        return self.model.eps_from_hidden(hidden_final, c)

    # -- audit plane (obs/audit.py) -------------------------------------

    def audit_forward(self, x_in: torch.Tensor, c: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The full-forward twin the shadow-compute audit plane runs beside
        the cached path: an uncached evaluation of the same inputs,
        returning ``(eps_true, hidden)`` where ``hidden`` (L+1, B, N, D)
        stacks each block's input plus the final hidden, the layout
        ``audit_hidden`` mirrors.  It never touches the policy's state."""
        x_out, inputs = self._full_forward(x_in, c)
        hidden = torch.cat([inputs, x_out[None]], dim=0)
        return self._eps(x_out, c), hidden

    def audit_hidden(self, state: Dict) -> Optional[torch.Tensor]:
        """The per-layer hidden stack the cached path produced this step,
        (L+1, B, N, D) in ``audit_forward``'s layout, or None when the
        policy keeps no such payload (the step-level policies cache eps);
        None leaves out the per-layer error, the end-to-end eps error is
        always audited."""
        return None

    def predicted_error_bound(self) -> Optional[float]:
        """The per-step relative approximation error this policy claims for
        its cached outputs, or None for no claim (None never trips
        ``bound_violations_total``).  FastCache's is Eq. 9."""
        return None

    def _rel_change(self, x: torch.Tensor, prev: torch.Tensor
                    ) -> torch.Tensor:
        """Per-sample relative Frobenius change, (B,), from the two totals
        of the ``saliency_delta`` kernel.  In global mode the totals are
        summed over the batch and the one statistic broadcast."""
        _, diff, prevsq = saliency_delta(x, prev)
        if self.gate_mode == "global":
            rel = torch.sqrt(diff.sum() / prevsq.sum().clamp(min=1e-12))
            return rel.expand(diff.shape)
        return torch.sqrt(diff / prevsq.clamp(min=1e-12))

    def masked_step(self, state: Dict, x_in: torch.Tensor, c: torch.Tensor,
                    skip: torch.Tensor, *, computed_on_skip: float = 0.0,
                    store: Optional[Callable] = None
                    ) -> Tuple[torch.Tensor, Dict]:
        """One step under a per-sample step-level gate, for policies that
        reuse the previous step's model output (``state["prev_eps"]``).
        ``skip`` (B,) bool: True reuses that sample's cached eps and leaves
        its cache payload untouched; False recomputes and refreshes it.  The
        block stack runs only when at least one sample recomputes (one host
        sync reads that).  ``computed_on_skip`` counts probe blocks
        (fbcache's block 0) charged to skipped samples.  ``store(out, st,
        inputs, x_out)`` writes the policy's own payloads into ``out`` on
        the recompute path (masking with ``skip`` itself)."""
        self.host_syncs += 1
        # one host sync per step, agreed over the model group when the
        # blocks' weights are sharded (the stack holds all-reduces)
        if bool(agree_all(skip.all())):
            eps = state["prev_eps"].to(F32).to(x_in.dtype)
            st = dict(state)
        else:
            x_out, inputs = self._full_forward(x_in, c)
            eps = self._eps(x_out, c)
            st = dict(state)
            if store is not None:
                store(st, state, inputs, x_out)
            eps = torch.where(skip[:, None, None, None],
                              state["prev_eps"].to(eps.dtype), eps)
            st["prev_eps"] = eps.to(state["prev_eps"].dtype)
        st["have_cache"] = torch.ones_like(state["have_cache"])
        skf = skip.to(F32)
        stats = dict(st["stats"])
        stats["blocks_computed"] = (stats["blocks_computed"]
                                    + (1.0 - skf) * self.L
                                    + skf * computed_on_skip)
        stats["blocks_skipped"] = (stats["blocks_skipped"]
                                   + skf * (self.L - computed_on_skip))
        stats["steps_reused"] = stats["steps_reused"] + skf
        stats["motion_frac_sum"] = stats["motion_frac_sum"] + (1.0 - skf)
        st["stats"] = stats
        return eps, st


def row_index(rows: Rows, device: torch.device) -> torch.Tensor:
    """``rows`` as an int64 index tensor on ``device``; a list goes through
    ``to_device`` (pinned, non-blocking), never a pageable copy."""
    if isinstance(rows, torch.Tensor):
        return rows
    return to_device(np.asarray(rows, np.int64), device)


def map_tree(fn: Callable, tree: Any, *others: Any) -> Any:
    """``fn`` over the tensor leaves of nested dicts and named tuples (the
    gate trackers), zipped with ``others`` of the same structure; the
    structure is kept."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(map_tree(fn, v, *(o[i] for o in others))
                            for i, v in enumerate(tree)))
    return fn(tree, *others)


def summarize_stats(state: Dict) -> Dict[str, float]:
    """Batch-mean view of the per-sample accumulators (host-side)."""
    s = state.get("stats", {})

    def mean(k):
        v = s.get(k)
        return 0.0 if v is None else float(v.to(F32).mean())

    steps = float(s["steps"]) if "steps" in s else 0.0
    computed = mean("blocks_computed")
    skipped = mean("blocks_skipped")
    reused = mean("steps_reused")
    total = computed + skipped
    out = {
        "steps": steps,
        "steps_reused": reused,
        "blocks_computed": computed,
        "blocks_skipped": skipped,
        "block_cache_ratio": skipped / total if total else 0.0,
        "mean_motion_fraction": (mean("motion_frac_sum")
                                 / max(1.0, steps - reused)),
    }
    out["per_sample"] = {
        k: [float(v) for v in s[k].cpu()]
        for k in ("blocks_computed", "blocks_skipped", "steps_reused",
                  "motion_frac_sum") if k in s}
    return out
