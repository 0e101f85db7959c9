"""A warm model evaluation as one CUDA graph, and the block-skip branch.

The reference jits a whole denoising step (or decode step) and skips a
cached block with ``lax.cond`` on the device: the host launches one
program and reads nothing.  Eagerly, the port launches every op from the
host and can only branch on the host, reading the mask.  This module gives
it the reference's shape on the card:

``branch(every, compute, skip=None, known=None, cond=None)``
    The "every sample caches: skip the block" decision.  ``every`` is the
    (B,) bool mask of the samples that cache.  While a graph is being
    captured on the card, ``compute`` (and ``skip``, where given) become
    IF nodes of the graph (``cuda_kernels/cond_node.py``), so the branch
    is taken on the device at each replay: their conditions set by one
    condition kernel that reads the mask, or, where the kernel that made
    the mask set the compute side's condition itself (``cond``, a handle
    from ``producer_condition``), by none; otherwise the host decides:
    ``known`` where the caller already knows the answer (its host mirror),
    else one read of ``all(every)``, agreed over the model group when the
    block's weights are sharded.  Returns the host reads it made (0 or 1).
    Under a model group the capture makes that agreement on the device
    (``agreed_mask``: ``all(every)`` all-reduced with MIN over the group on
    the capturing stream), and the IF nodes read it, so every rank of the
    group takes the same side at each replay and the body's collectives
    run on all of them or on none.  Only nccl collectives can be captured
    (``capture_refusal``).
    ``producer_condition(device)`` is such a handle, or None where the
    IF node must read the mask itself (outside a capture, or under a model
    group, whose agreement it reads).
    Both sides write the same carry: ``compute`` keeps the cached samples'
    values with a ``torch.where``, so either side gives a cached sample the
    same bits, which is what lets the IF node stand in for ``lax.cond``.

``StepGraphs``
    Captured steps by key.  ``run(key, fn, inputs, bound)`` calls ``fn``
    eagerly for the key's first ``WARMUP_CALLS`` calls in the process (a key
    warmed once, by any ``StepGraphs``, is not warmed again), then
    captures it once (``torch.cuda.CUDAGraph``) and replays it: each call
    copies ``inputs`` into the graph's static buffers and replays.  ``bound`` is the state
    the step reads and writes in place; a graph is bound to its tensors,
    and a call with other tensors captures anew.  The capture records
    which kernel wrappers it called (``read_counts``); each replay adds
    that to their launch counts, so a replayed step counts the
    launches an eager one would.  A capture that fails raises: nothing
    falls back to the eager step.  The outputs are the graph's static
    tensors, overwritten by the next replay.

No kernel wrapper may launch inside an IF node's body: a replay cannot
know whether the body ran, so ``branch`` raises at capture if one did.
"""
from __future__ import annotations

import collections
import gc
from typing import (Any, Callable, Counter, Dict, Hashable, List, Optional,
                    Sequence)

import torch
import torch.distributed as dist

from repro_torch.cuda_kernels import add_counts, counts_since, read_counts
from repro_torch.cuda_kernels.cond_node import (condition, if_all_sides,
                                                if_set, prepare)
from repro_torch.distributed.sharding import (ShardingCtx, agree_all,
                                              current_ctx)

# eager calls of a key before its capture: the first warm steps run the
# lazy set-up (kernel libraries, cuBLAS handles, routes) outside a capture
WARMUP_CALLS = 2
# eager calls made so far of each key, in this process
_EAGER_CALLS: Counter[Hashable] = collections.Counter()


def capture_refusal(ctx: Optional[ShardingCtx],
                    device: torch.device) -> Optional[str]:
    """Why a step graph cannot hold a step on ``device`` under ``ctx``
    (the sharding context its blocks read), or None when it can: a CUDA
    graph needs the card, and captures the model group's collectives only
    when nccl runs them (gloo moves a CUDA tensor through the host)."""
    if torch.device(device).type != "cuda":
        return f"step graphs are CUDA graphs: the model is on {device}"
    group = ctx.group("model") if ctx is not None else None
    if group is not None:
        backend = dist.get_backend(group)
        if backend != "nccl":
            return (f"the model group's collectives run on {backend}, which "
                    "a CUDA graph cannot capture (nccl only)")
    return None


def agreed_mask(every: torch.Tensor) -> torch.Tensor:
    """The mask an IF node reads for ``every``: ``every`` itself, or under
    a model group its (1,) agreement, ``all(every)`` AND-reduced over the
    group on the device (``agree_all``); no host read."""
    ctx = current_ctx()
    if ctx is None or ctx.group("model") is None:
        return every.contiguous()
    return agree_all(every.all().reshape(1))


def producer_condition(device: torch.device) -> Optional[int]:
    """A condition handle for the kernel that makes a block's skip mask to
    set to ``!all(mask)`` (``fused_gate(cond=...)``), which ``branch(...,
    cond=...)`` then adds its IF node on; None where ``branch`` must read
    the mask itself: outside a capture on the card, or under a model group
    (its IF nodes read the group's agreement, ``agreed_mask``)."""
    if (torch.device(device).type != "cuda"
            or not torch.cuda.is_current_stream_capturing()):
        return None
    ctx = current_ctx()
    if ctx is not None and ctx.group("model") is not None:
        return None
    return condition(device)


def branch(every: torch.Tensor, compute: Callable[[], None],
           skip: Optional[Callable[[], None]] = None,
           known: Optional[bool] = None, cond: Optional[int] = None) -> int:
    """Run ``compute`` unless every sample caches, else ``skip`` (see the
    module docstring).  Returns the number of host reads made (0 or 1)."""
    if every.is_cuda and torch.cuda.is_current_stream_capturing():
        why = capture_refusal(current_ctx(), every.device)
        if why is not None:
            raise RuntimeError(f"a step graph cannot hold this block skip: "
                               f"{why}")
        before = read_counts()
        if cond is not None:
            if skip is not None:
                raise ValueError("a condition set by the mask's producer "
                                 "holds the compute side only")
            if_set(cond, compute, every.device)
        else:
            sides = [(skip, True)] if skip is not None else []
            if_all_sides(agreed_mask(every), sides + [(compute, False)])
        inside = [k for k in counts_since(before) if k[0] != "if_all"]
        if inside:
            raise RuntimeError(f"kernel wrappers launched inside an IF node "
                               f"({sorted({k[0] for k in inside})}): a replay "
                               "cannot count them")
        return 0
    reads = 0
    if known is None:
        known = bool(agree_all(every.all()))
        reads = 1
    if known:
        if skip is not None:
            skip()
    else:
        compute()
    return reads


def _tensors(tree: Any) -> List[torch.Tensor]:
    """The tensor leaves of nested dicts, tuples and lists, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _release_capture(dev: torch.device, pool: tuple) -> None:
    """After a failed capture: the allocator's routing of the graph's pool,
    where the capture's end did not take it back (an invalidated capture
    can raise before it does).  A routing left behind makes the allocator
    refuse to empty any pool later in the process."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        torch._C._cuda_endAllocateToPool(index, pool)
    except RuntimeError:
        pass                               # the capture's end took it back


class StepGraph:
    """One captured step: its static inputs, the graph, its outputs, the
    state tensors it is bound to and the launches its capture recorded."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor],
                 bound: Sequence[torch.Tensor]):
        dev = inputs[0].device
        prepare(dev)
        self.bound = tuple(bound)
        self.static = [t.clone() for t in inputs]
        self.graph = torch.cuda.CUDAGraph()
        pool = torch.cuda.graph_pool_handle()
        before = read_counts()
        # no garbage collection inside the capture: a graph freed there (a
        # finished engine's, held in a reference cycle) resets, which is not
        # permitted while a stream captures and invalidates this capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                self.out = fn(*self.static)
        except Exception as e:
            _release_capture(dev, pool)
            raise RuntimeError(f"capturing the step graph failed: {e}") from e
        finally:
            if collecting:
                gc.enable()
            # a capture runs nothing: its wrapper calls launched no kernel
            self.recorded = counts_since(before)
            add_counts(self.recorded, -1)

    def bound_to(self, bound: Sequence[torch.Tensor]) -> bool:
        return (len(bound) == len(self.bound)
                and all(a is b for a, b in zip(bound, self.bound)))

    def replay(self, inputs: Sequence[torch.Tensor]) -> Any:
        for s, t in zip(self.static, inputs):
            s.copy_(t)
        self.graph.replay()
        add_counts(self.recorded)
        return self.out


class StepGraphs:
    """Captured steps by key (see the module docstring)."""

    def __init__(self):
        self.graphs: Dict[Hashable, StepGraph] = {}
        self.captures = 0
        self.replays = 0

    def run(self, key: Hashable, fn: Callable,
            inputs: Sequence[torch.Tensor], bound: Any) -> Any:
        leaves = _tensors(bound)
        g = self.graphs.get(key)
        if g is not None and not g.bound_to(leaves):
            del self.graphs[key]
            g = None
        if g is None:
            if _EAGER_CALLS[key] < WARMUP_CALLS:
                _EAGER_CALLS[key] += 1
                return fn(*inputs)
            g = self.graphs[key] = StepGraph(fn, inputs, leaves)
            self.captures += 1
        self.replays += 1
        return g.replay(inputs)
