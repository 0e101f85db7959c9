"""Parameter bridge between the reference's parameter trees, as numpy
arrays, and the port's modules, both ways.

Callers hand over ``jax.tree.map(np.asarray, params)``; this module never
imports JAX.  The reference stacks block parameters on a leading L axis;
the port keeps one block module per layer (``DiTBlock``,
``TransformerBlock``), so the stack is split on the way in and rebuilt on
the way out (``params_to_jax``).
``param_groups`` names, for every leaf of the reference's tree, the port
tensors that hold it.

numpy has no bfloat16 (the reference's arrays are ml_dtypes'): a bf16
tensor leaves as a 2-byte void array (``V2``) of its bits, the form
``np.savez`` writes for an ml_dtypes bf16 leaf, and ``tensor_from_numpy``
reads ``V2`` and ml_dtypes bf16 back bit for bit.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch import tree
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.dit import DiTModel
from repro_torch.models.transformer import TransformerModel


BF16_BITS = np.dtype("V2")   # a bf16 array's bits, as np.savez stores it


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16" or a.dtype == BF16_BITS


def tensor_from_numpy(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy -> tensor, including ml_dtypes' bfloat16 and ``V2`` bf16 bits
    (bit-copied)."""
    a = np.ascontiguousarray(a)
    if _is_bf16(a):
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def to_numpy(t: Union[torch.Tensor, np.ndarray, int]) -> np.ndarray:
    """tensor (or array) -> host numpy array, bf16 as ``V2`` bits; an int
    (an optimizer's step count) -> an int32 scalar, as the reference keeps
    it."""
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(BF16_BITS)
        return t.cpu().numpy()
    if isinstance(t, int):
        return np.asarray(t, np.int32)
    return np.asarray(t)


class LayerStack:
    """The L per-layer tensors of one block parameter: one leaf, stacked
    on axis 0, in the reference's tree."""

    def __init__(self, tensors: List[torch.Tensor]):
        self.tensors = list(tensors)


def param_groups(model: Union[DiTModel, TransformerModel]) -> Dict:
    """The reference's parameter tree of ``model``'s config with, at each
    leaf, the port's tensor that holds it (a top-level Parameter) or the
    ``LayerStack`` of its per-layer Parameters."""
    if isinstance(model, DiTModel):
        out = {name: getattr(model, name) for name in model._top_specs()}
        out["blocks"] = {
            name: LayerStack([getattr(blk, name) for blk in model.blocks])
            for name in model.blocks[0].specs}
        return out
    out = {name: getattr(model.top, name) for name in model.top.defs}
    out["blocks"] = {}
    for i in range(model.period):
        blks = model.blocks[i::model.period]                # one per period
        out["blocks"][f"pos{i}"] = {
            sub: {name: LayerStack([getattr(getattr(blk, sub), name)
                                    for blk in blks])
                  for name in getattr(blks[0], sub).defs}
            for sub in blks[0].subs}
    return out


def _stacked_numpy(g) -> np.ndarray:
    if isinstance(g, LayerStack):
        return to_numpy(torch.stack([t.detach() for t in g.tensors]))
    return to_numpy(g)


def params_to_jax(model: Union[DiTModel, TransformerModel]) -> Dict:
    """The inverse of ``params_from_jax`` and
    ``transformer_params_from_jax``: ``model``'s parameters as the
    reference's tree of numpy arrays, block parameters stacked on L."""
    return tree.map(_stacked_numpy, param_groups(model))


def state_to_jax(state):
    """An optimizer state (``AdamWState`` / ``AdafactorState`` over a
    ``training.loop.param_tree``) as the reference's tree of numpy arrays:
    the step an int32 scalar, the moments as they are."""
    return tree.map(to_numpy, state)


def _copy(dst: torch.Tensor, a: np.ndarray, dev: torch.device,
          name: str) -> None:
    src = tensor_from_numpy(a, dev)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: shape {tuple(src.shape)} != "
                         f"{tuple(dst.shape)}")
    dst.copy_(src)


def _copy_stack(stack, dsts, dev: torch.device, name: str) -> None:
    """Split a layer-stacked (L, ...) array into L per-layer tensors."""
    stack = np.asarray(stack)
    if stack.shape[0] != len(dsts):
        raise ValueError(f"{name}: {stack.shape[0]} layers, model has "
                         f"{len(dsts)}")
    for l, dst in enumerate(dsts):
        _copy(dst, stack[l], dev, f"{name}[{l}]")


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
        _copy(getattr(model, name), np_tree[name], dev, name)
    for name in model.blocks[0].specs:
        _copy_stack(np_tree["blocks"][name],
                    [getattr(blk, name) for blk in model.blocks], dev,
                    f"blocks/{name}")
    return model


@torch.no_grad()
def transformer_params_from_jax(np_tree: Mapping, model: TransformerModel
                                ) -> TransformerModel:
    """Copy a reference ``TransformerModel`` parameter tree (``embed``,
    ``final_norm``, optional ``lm_head``; for the audio encoder
    ``feat_proj``, ``feat_bias``, ``pos_conv`` and ``lm_head`` in place of
    ``embed``; and, for each position i of the block pattern's period, the
    stacked ``blocks/pos{i}/<sub>/*`` with leaves (n_super, ...): the
    mixer's sub-tree (``attn``, with LayerNorm's ``norm_b`` in the
    encoder, ``mamba``, ``mlstm`` or ``slstm``) and an ``ffn`` (SwiGLU, or
    the encoder's GELU leaves ``norm_b``, ``w_in``, ``b_in``, ``w_out``,
    ``b_out``) or ``moe`` one where the layer has it, the MoE's expert
    leaves (n, E, D, F) and its f32 router) into ``model`` (in place) and
    return it.  Shapes and key sets must match
    exactly; values are cast to the parameters' dtypes (bf16
    bit-copied)."""
    dev = model.device
    if set(np_tree) - {"blocks"} != set(model.top.defs):
        raise ValueError(f"top-level keys {sorted(np_tree)} do not match "
                         f"{sorted(model.top.defs)} + blocks")
    for name in model.top.defs:
        _copy(getattr(model.top, name), np_tree[name], dev, name)
    blocks = np_tree["blocks"]
    want = [f"pos{i}" for i in range(model.period)]
    if set(blocks) != set(want):
        raise ValueError(f"blocks {sorted(blocks)} != {want}: this model's "
                         f"pattern {model.kinds} has period {model.period}")
    for i, key in enumerate(want):
        pos, blks = blocks[key], model.blocks[i::model.period]
        subs = blks[0].subs
        if set(pos) != set(subs):
            raise ValueError(f"blocks/{key} holds {sorted(pos)}; expected "
                             f"{' + '.join(subs)} (a {blks[0].kind} layer)")
        for sub in subs:
            groups = [getattr(blk, sub) for blk in blks]
            if set(pos[sub]) != set(groups[0].defs):
                raise ValueError(f"blocks/{key}/{sub}: keys "
                                 f"{sorted(pos[sub])} != "
                                 f"{sorted(groups[0].defs)}")
            for name in groups[0].defs:
                _copy_stack(pos[sub][name], [getattr(g, name) for g in groups],
                            dev, f"blocks/{key}/{sub}/{name}")
    return model


def fc_params_from_jax(np_tree: Mapping, device: DeviceLike = "cuda"
                       ) -> Dict[str, torch.Tensor]:
    """The reference's linear-approximator tree (``W_c``, ``b_c``, ``W_l``,
    ``b_l``) as tensors on ``device``."""
    dev = resolve_device(device)
    return {k: tensor_from_numpy(np_tree[k], dev)
            for k in ("W_c", "b_c", "W_l", "b_l")}
