"""Tree checkpoints in the reference's format (``checkpoint/io.py``): an
``.npz`` of ``leaf_i`` arrays plus a ``.meta.json`` with ``keys``,
``treedef``, ``metadata`` and ``num_leaves``.

Leaves are numbered in the order JAX flattens the same tree and keyed with
its key strings (``repro_torch.tree``), so a checkpoint of the reference's
tree written here loads in the reference and one written there loads here.
``treedef`` is the port's own description of the structure (the
reference's ``load`` never reads it).

A bf16 leaf is stored as 2-byte void bytes (``|V2``), as ``np.savez``
stores an ml_dtypes bf16 array, and read back bit for bit; an ``int``
leaf (an optimizer's host step count) as an int32 scalar.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from repro_torch import tree
from repro_torch.bridge import tensor_from_numpy, to_numpy


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _meta_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".meta.json"


def save(path: str, tree_: Any, metadata: Dict | None = None) -> None:
    """Write ``tree_`` (tensors, arrays or numbers at its leaves)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    pairs = tree.flatten_with_path(tree_)
    np.savez(_npz_path(path), **{f"leaf_{i}": to_numpy(leaf)
                                 for i, (_, leaf) in enumerate(pairs)})
    meta = {
        "keys": [tree.keystr(p) for p, _ in pairs],
        "treedef": repr(tree.map(lambda _: "*", tree_)),
        "metadata": metadata or {},
        "num_leaves": len(pairs),
    }
    with open(_meta_path(path), "w") as f:
        json.dump(meta, f)


def _restore(arr: np.ndarray, ref):
    if isinstance(ref, torch.Tensor):
        return tensor_from_numpy(arr, ref.device).to(ref.dtype)
    if isinstance(ref, int):
        return int(arr)
    return arr


def load(path: str, like) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors, arrays or
    ints): each leaf a tensor on the device and in the dtype of ``like``'s
    leaf, or the stored array / an int where ``like`` has one."""
    with np.load(_npz_path(path)) as npz:
        refs = tree.leaves(like)
        n = len(refs)
        if len(npz.files) != n:
            raise ValueError(f"checkpoint {path!r} holds {len(npz.files)} "
                             f"leaves; the target pytree expects {n}")
        out = []
        for i, ref in enumerate(refs):
            arr = npz[f"leaf_{i}"]
            shape = tuple(ref.shape) if hasattr(ref, "shape") else ()
            if tuple(arr.shape) != shape:
                raise ValueError(f"checkpoint {path!r} leaf {i}: stored "
                                 f"shape {tuple(arr.shape)} != expected "
                                 f"{shape}")
            out.append(_restore(arr, ref))
    return tree.unflatten(like, out)


def load_metadata(path: str) -> Dict:
    with open(_meta_path(path)) as f:
        return json.load(f)
