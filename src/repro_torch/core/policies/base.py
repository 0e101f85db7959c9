"""The CachePolicy protocol, registry, and shared machinery.

A cache policy owns a dict of per-sample state tensors whose batch rows are
the serving slots (see the reference's ``core/policies/base.py`` for the
full contract).  The port's protocol:

  init_state(batch) -> dict     the policy's buffers plus the ``stats`` block
  reset_rows(state, rows)       re-arm sample rows (a list of ints) in place
  snapshot_rows(state, rows)    copy the rows out (a preemption checkpoint)
  restore_rows(state, snap, rows)  write a checkpoint back into rows, in place
  step(state, x_in, c)          one model evaluation -> (eps, state): the
                                state's tensors are updated in place and the
                                same dict comes back
  stats(state)                  host-side summary (``summarize_stats``)

``step`` is ``step_kind`` (cold, mixed or warm, from the host mirror below),
then ``device_step`` (the device work, which reads nothing on the host but
through ``branch``) and ``host_step`` (the host's bookkeeping).  The state's
tensors keep their storage from step to step, so a captured warm step
(``core/step_graph.py``) replays on them.

**Host mirror.**  Some state leaves are written only at points the host
controls: ``have_cache`` turns all-True after every step and is cleared by
``reset_rows`` and rewritten by ``restore_rows``; a step counter
(``step_count``, fora's and smoothcache's) advances by one a step and is
zeroed on reset.  A policy lists them in ``MIRRORED`` and keeps a host copy
beside the device tensors, updated at those same points, so its branch
choices read nothing from the device.  The mirror is bound to one state
(its tensors' identity); a state it is not bound to is read once (one
counted host sync) and the mirror binds to it.  A snapshot carries its
rows' mirror values (``Snapshot.host``); a restore from a snapshot without
them leaves the mirror to be read again at the next step.

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
skip through ``branch``: an IF node in a captured step, else a host
decision, known from the mirror where it can be (a cold row never reuses;
fora's schedule) and otherwise one read of the (B,) skip mask, counted in
``host_syncs``.
"""
from __future__ import annotations

from typing import (TYPE_CHECKING, Any, Callable, Dict, List, NamedTuple,
                    Optional, Sequence, Tuple, Type, Union)

import numpy as np
import torch

from repro_torch.core import linear_approx
from repro_torch.core.step_graph import branch
from repro_torch.cuda_kernels.saliency_delta import saliency_delta
from repro_torch.device import to_device
# the slot-axis rank rule is the sharding rules' own
from repro_torch.distributed.sharding import _slot_axis as slot_axis
from repro_torch.models.dit import DiTModel

if TYPE_CHECKING:
    from repro_torch.core.token_reduce import TokenReducer

F32 = torch.float32


class RowSet(NamedTuple):
    """Sample rows as an int64 index tensor on the state's device and as
    the same rows on the host (the engine makes one per slot, once)."""
    idx: torch.Tensor
    host: Tuple[int, ...]


Rows = Union[Sequence[int], torch.Tensor, RowSet]

STEP_KINDS = ("cold", "mixed", "warm")

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
                 split_maps: bool = False,
                 token_reducer: Optional["TokenReducer"] = None, **_unused):
        self.model = model
        self.fc = fc
        self.fc_params = fc_params
        self.gate_mode = gate_mode
        # the GEMM route every linear_blend / fused_gate call on the maps
        # names: None for the wrappers' rule (on a bf16 model on CUDA
        # wgmma, or wgmma_split with split copies: ``map_copies``),
        # route.SIMT for the f32 maps
        self.gemm = gemm
        # split copies of the maps in place of single bf16 ones (the
        # runner's choice for maps handed in, which bf16 does not hold)
        self.split_maps = split_maps
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
        # model steps by kind (from the host mirror: see the module
        # docstring); a policy without cache flags steps warm every time
        self.step_kinds = dict.fromkeys(STEP_KINDS, 0)
        # the host mirror: (the mirrored device leaves, their host copies)
        self._mirror: Optional[Tuple[Tuple[torch.Tensor, ...],
                                     Dict[str, np.ndarray]]] = None

    # state leaves written only at host-controlled points (see the module
    # docstring); each is 0 / False in a fresh state
    MIRRORED: Tuple[str, ...] = ()

    def map_copies(self, w: torch.Tensor) -> List[Optional[torch.Tensor]]:
        """The tensor-core copies of the maps ``w`` ((D, F) or (L, D, F)),
        made once: single bf16 ones for the wgmma route
        (``linear_approx.bf16_copies``), or with ``split_maps`` split ones
        for the wgmma_split route (``linear_approx.split_copies``); None
        each off a bf16 model on CUDA and where the calls name a route."""
        if self.gemm is not None:
            return [None] * w.reshape(-1, *w.shape[-2:]).shape[0]
        make = (linear_approx.split_copies if self.split_maps
                else linear_approx.bf16_copies)
        return make(w, self.model.dtype, self.device)

    def init_state(self, batch: int) -> Dict:
        raise NotImplementedError

    def reset_rows(self, state: Dict, rows: Sequence[int]) -> Dict:
        """The mirror's rows to 0 (a policy re-arms its own leaves, then
        calls this)."""
        host = self.mirror_of(state)
        if host is not None:
            for v in host.values():
                v[list(rows)] = 0
        return state

    # -- host mirror -----------------------------------------------------

    def bind_mirror(self, state: Dict) -> None:
        """Mirror a fresh state (every mirrored leaf 0 / False)."""
        if self.MIRRORED:
            b = self._state_batch(state)
            self._mirror = (tuple(state[k] for k in self.MIRRORED),
                            {k: np.zeros((b,), _NP[state[k].dtype])
                             for k in self.MIRRORED})

    def mirror_of(self, state: Dict) -> Optional[Dict[str, np.ndarray]]:
        """The host copies of ``state``'s mirrored leaves, or None when the
        mirror is bound to another state or waits for a read."""
        if self._mirror is None or not self.MIRRORED:
            return None
        leaves, host = self._mirror
        if all(a is state[k] for a, k in zip(leaves, self.MIRRORED)):
            return host
        return None

    def host_flags(self, state: Dict) -> Dict[str, np.ndarray]:
        """The mirror of ``state``; where it holds none, the leaves are read
        (one counted host sync) and the mirror binds to them."""
        host = self.mirror_of(state)
        if host is None:
            flat = torch.cat([state[k].to(torch.int64)
                              for k in self.MIRRORED]).cpu().numpy()
            self.host_syncs += 1
            b = state[self.MIRRORED[0]].shape[0]
            host = {k: flat[i * b:(i + 1) * b].astype(
                _NP[state[k].dtype]) for i, k in enumerate(self.MIRRORED)}
            self._mirror = (tuple(state[k] for k in self.MIRRORED), host)
        return host

    def snapshot_rows(self, state: Dict, rows: Rows) -> Dict:
        """Copy ``rows`` out of ``state`` into a snapshot of the same
        structure (the preemption checkpoint).  Every leaf that carries the
        sample batch under the ``slot_axis`` rank rule is row-copied along
        that axis (``index_select``: the snapshot owns its memory, so later
        writes into the donor rows never reach it); replicated leaves (the
        scalar ``steps``, which a step advances in place) are copied whole.
        ``rows`` is a list of ints, an int64 index tensor on the state's
        device, or a ``RowSet`` of both (the engine keeps one per slot, so a
        CUDA snapshot makes no host copy and the mirror knows the rows)."""
        batch = self._state_batch(state)
        idx = row_index(rows, self.device)

        def take(leaf):
            axis = slot_axis(tuple(leaf.shape), batch, self.L)
            return leaf.clone() if axis is None else leaf.index_select(axis,
                                                                       idx)

        snap = Snapshot(map_tree(take, state))
        host, on_host = self.mirror_of(state), host_rows(rows)
        if host is not None and on_host is not None:
            snap.host = {k: v[list(on_host)].copy() for k, v in host.items()}
        return snap

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

        out = map_tree(put, state, snap)
        host, on_host = self.mirror_of(state), host_rows(rows)
        if host is not None:
            kept = getattr(snap, "host", None)
            if kept is None or on_host is None:
                self._mirror = None           # read again at the next step
            else:
                for k, v in host.items():
                    v[list(on_host)] = kept[k]
        return out

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
        """One model evaluation, in place: ``step_kind``, ``device_step``,
        ``host_step``.  Returns (eps, state)."""
        kind = self.step_kind(state)
        eps = self.device_step(state, x_in, c, kind)
        self.host_step(state, kind)
        return eps, state

    def step_kind(self, state: Dict) -> str:
        """"warm" when every row holds a cache, "mixed" when some do,
        "cold" when none does, from the mirror (a policy without the flag
        is always warm)."""
        if "have_cache" not in self.MIRRORED:
            return "warm"
        have = self.host_flags(state)["have_cache"]
        return "warm" if have.all() else "mixed" if have.any() else "cold"

    def device_step(self, state: Dict, x_in: torch.Tensor, c: torch.Tensor,
                    kind: str) -> torch.Tensor:
        """The step's device work for a step of ``kind``, writing the state
        in place; returns eps.  It reads nothing on the host but through
        ``branch``."""
        raise NotImplementedError

    def host_step(self, state: Dict, kind: str) -> None:
        """The host's side of a step: its kind counted, the mirror moved as
        the step moved the device leaves (every row warm, counters + 1)."""
        self.step_kinds[kind] += 1
        host = self.mirror_of(state)
        if host is None:
            return
        if "have_cache" in host:
            host["have_cache"][:] = True
        if "step_count" in host:
            host["step_count"] += 1

    def branch(self, every: torch.Tensor, compute: Callable[[], None],
               skip: Optional[Callable[[], None]] = None,
               known: Optional[bool] = None,
               cond: Optional[int] = None) -> None:
        """``step_graph.branch``, its host reads counted in ``host_syncs``
        (``cond``: the handle the mask's producer set, or None)."""
        self.host_syncs += branch(every, compute, skip, known, cond=cond)

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
                    store: Optional[Callable] = None,
                    known: Optional[bool] = None) -> torch.Tensor:
        """One step under a per-sample step-level gate, for policies that
        reuse the previous step's model output (``state["prev_eps"]``).
        ``skip`` (B,) bool: True reuses that sample's cached eps and leaves
        its cache payload untouched; False recomputes and refreshes it.  The
        block stack runs only when at least one sample recomputes
        (``branch``; ``known`` is the host's answer to "every sample
        reuses" where it has one, and a cold row never reuses).
        ``computed_on_skip`` counts probe blocks (fbcache's block 0) charged
        to skipped samples.  ``store(inputs, x_out)`` writes the policy's
        own payloads into the state on the recompute path (masking with
        ``skip`` itself).  The state is written in place; returns eps."""
        if known is None and "have_cache" in self.MIRRORED:
            if not self.host_flags(state)["have_cache"].all():
                known = False
        prev = state["prev_eps"]
        # the carry holds the all-reuse side; the recompute side rewrites it
        eps = prev.to(F32).to(x_in.dtype, copy=True)

        def compute():
            x_out, inputs = self._full_forward(x_in, c)
            fresh = self._eps(x_out, c)
            if store is not None:
                store(inputs, x_out)
            eps.copy_(torch.where(skip[:, None, None, None],
                                  prev.to(fresh.dtype), fresh))
            prev.copy_(eps)

        self.branch(skip, compute, known=known)
        state["have_cache"].fill_(True)
        skf = skip.to(F32)
        stats = state["stats"]
        stats["blocks_computed"].add_((1.0 - skf) * self.L
                                      + skf * computed_on_skip)
        stats["blocks_skipped"].add_(skf * (self.L - computed_on_skip))
        stats["steps_reused"].add_(skf)
        stats["motion_frac_sum"].add_(1.0 - skf)
        return eps


_NP = {torch.bool: np.bool_, torch.int32: np.int32, torch.int64: np.int64,
       torch.float32: np.float32}


def row_index(rows: Rows, device: torch.device) -> torch.Tensor:
    """``rows`` as an int64 index tensor on ``device``; a list goes through
    ``to_device`` (pinned, non-blocking), never a pageable copy."""
    if isinstance(rows, RowSet):
        return rows.idx
    if isinstance(rows, torch.Tensor):
        return rows
    return to_device(np.asarray(rows, np.int64), device)


def host_rows(rows: Rows) -> Optional[Tuple[int, ...]]:
    """``rows`` on the host, or None for a bare index tensor."""
    if isinstance(rows, RowSet):
        return rows.host
    if isinstance(rows, torch.Tensor):
        return None
    return tuple(int(r) for r in rows)


class Snapshot(dict):
    """A ``snapshot_rows`` checkpoint: the state's structure, plus
    ``host``, its rows' mirror values where the mirror knew them."""
    host: Optional[Dict[str, np.ndarray]] = None


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
