"""Hand-written CUDA kernels of the port, their wrappers and plain twins.

Nothing is compiled at import: a kernel's library is built with ``nvcc``
at its first launch (``build.py``).  The package is not named ``kernels``:
the reference's lint (``tools/reprolint``, kernel-parity) keys every
module under a ``/kernels/`` directory of ``src/`` by its short name, and
this package's ``ref`` and ``fused_gate`` would shadow the
reference's.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

# a wrapper counts its launches on itself: ``fn.launches``, and per route
# or mode ``fn.launches_by_route`` / ``fn.launches_by_mode``; ``if_all``
# also its IF nodes apart from its condition kernels, ``fn.nodes``
_SCALARS = ("launches", "nodes")
_PER = ("launches_by_route", "launches_by_mode")

Counts = Dict[Tuple[str, str, str], int]


def wrappers() -> Dict[str, Callable]:
    """Every kernel wrapper by name: the seven ports of the Pallas kernels
    and ``if_all``, the step graphs' IF node."""
    from repro_torch.cuda_kernels.cond_node import if_all
    from repro_torch.cuda_kernels.flash_attention import flash_attention
    from repro_torch.cuda_kernels.fused_gate import fused_gate
    from repro_torch.cuda_kernels.knn_density import knn_density
    from repro_torch.cuda_kernels.linear_blend import linear_blend
    from repro_torch.cuda_kernels.saliency_delta import saliency_delta
    from repro_torch.cuda_kernels.token_merge import (merge_assign,
                                                      unmerge_scatter)
    return {"fused_gate": fused_gate, "knn_density": knn_density,
            "merge_assign": merge_assign, "unmerge_scatter": unmerge_scatter,
            "flash_attention": flash_attention,
            "saliency_delta": saliency_delta, "linear_blend": linear_blend,
            "if_all": if_all}


def read_counts() -> Counts:
    """Every counter by (wrapper, attribute, key); key "" for the total."""
    out: Counts = {}
    for name, fn in wrappers().items():
        for attr in _SCALARS:
            if hasattr(fn, attr):
                out[(name, attr, "")] = getattr(fn, attr)
        for per in _PER:
            for key, n in getattr(fn, per, {}).items():
                out[(name, per, key)] = n
    return out


def counts_since(before: Counts) -> Counts:
    """What each counter gained since ``before``, the zeros left out."""
    now = read_counts()
    return {k: n - before.get(k, 0) for k, n in now.items()
            if n != before.get(k, 0)}


def add_counts(counts: Counts, times: int = 1) -> None:
    """Add ``times`` x ``counts`` to the counters."""
    fns = wrappers()
    for (name, attr, key), n in counts.items():
        fn = fns[name]
        if attr in _SCALARS:
            setattr(fn, attr, getattr(fn, attr) + times * n)
        else:
            getattr(fn, attr)[key] += times * n


def zero_counts() -> None:
    """Every counter to 0."""
    for fn in wrappers().values():
        for attr in _SCALARS:
            if hasattr(fn, attr):
                setattr(fn, attr, 0)
        for per in _PER:
            if hasattr(fn, per):
                setattr(fn, per, dict.fromkeys(getattr(fn, per), 0))
