"""Parameter declarations, after the reference's ``models/params.py``: a
model describes its parameters as a tree (nested dicts) of ``ParamDef``
(shape, initializer, dtype override, logical axes).  The same tree makes
the model's parameters (``layers.ParamGroup``), its sharding specs
(``distributed.sharding.param_specs``) and the dry run's abstract inputs
(``abstract_params``: tensors on the ``meta`` device, which hold a shape
and a dtype and no storage, as the reference's ``ShapeDtypeStruct``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.device import dtype_of


class ParamDef(NamedTuple):
    shape: Tuple[int, ...]
    init: str = "normal"        # normal | zeros | ones | fan_in
    scale: float = 1.0
    dtype: Optional[str] = None  # override the model dtype (f32 norms)
    # one logical axis name (or None) per dim for the sharding rules
    # (``distributed/sharding.py``); None: unnamed, replicated
    axes: Optional[Tuple[Optional[str], ...]] = None


def map_defs(fn, defs):
    """``fn`` over the ParamDefs of a nested dict, in its structure."""
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: map_defs(fn, v) for k, v in defs.items()}


def def_leaves(defs):
    """The ParamDefs of a nested dict, in JAX's order (sorted keys)."""
    if isinstance(defs, ParamDef):
        return [defs]
    return [d for k in sorted(defs) for d in def_leaves(defs[k])]


def abstract_params(defs, default_dtype: Union[str, torch.dtype]):
    """The tree of ``meta`` tensors that materializing ``defs`` would give:
    each leaf's shape, and its dtype override or ``default_dtype``."""
    def one(d: ParamDef) -> torch.Tensor:
        return torch.empty(d.shape, dtype=dtype_of(d.dtype or default_dtype),
                           device="meta")
    return map_defs(one, defs)


def count_params(defs) -> int:
    """The number of elements over the tree's leaves."""
    return sum(math.prod(d.shape) for d in def_leaves(defs))
