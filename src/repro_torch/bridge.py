"""Parameter bridge: the reference's parameter trees, as numpy arrays, into
the port's modules.

Callers hand over ``jax.tree.map(np.asarray, params)``; this module never
imports JAX.  The reference stacks block parameters on a leading L axis;
the port keeps one ``DiTBlock`` per layer, so the stack is split here.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.dit import DiTModel


def tensor_from_numpy(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy -> tensor, including ml_dtypes' bfloat16 (bit-copied)."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


@torch.no_grad()
def params_from_jax(np_tree: Mapping, model: DiTModel,
                    device: Optional[DeviceLike] = None) -> DiTModel:
    """Copy a reference DiT parameter tree into ``model`` (in place) and
    return it.  Shapes must match exactly; values are cast to the model's
    dtype."""
    dev = model.device if device is None else resolve_device(device)
    if dev != model.device:
        raise ValueError(f"model lives on {model.device}, not {dev}")
    for name in model._top_specs():
        dst = getattr(model, name)
        src = tensor_from_numpy(np_tree[name], dev)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                             f"{tuple(dst.shape)}")
        dst.copy_(src)
    blocks = np_tree["blocks"]
    for name in model.blocks[0].specs:
        stack = np.asarray(blocks[name])
        if stack.shape[0] != len(model.blocks):
            raise ValueError(f"blocks/{name}: {stack.shape[0]} layers, model "
                             f"has {len(model.blocks)}")
        for l, blk in enumerate(model.blocks):
            dst = getattr(blk, name)
            src = tensor_from_numpy(stack[l], dev)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"blocks/{name}[{l}]: shape "
                                 f"{tuple(src.shape)} != {tuple(dst.shape)}")
            dst.copy_(src)
    return model


def fc_params_from_jax(np_tree: Mapping, device: DeviceLike = "cuda"
                       ) -> Dict[str, torch.Tensor]:
    """The reference's linear-approximator tree (``W_c``, ``b_c``, ``W_l``,
    ``b_l``) as tensors on ``device``."""
    dev = resolve_device(device)
    return {k: tensor_from_numpy(np_tree[k], dev)
            for k in ("W_c", "b_c", "W_l", "b_l")}
