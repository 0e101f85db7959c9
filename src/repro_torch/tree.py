"""The few ``jax.tree`` functions the port needs, over nested dicts, lists,
tuples and NamedTuples of tensors (or arrays, or numbers).

Leaves come in the order JAX flattens the same structure: dict entries by
sorted key, NamedTuple fields and sequence items in order; ``None`` is an
empty subtree.  ``keystr`` of a leaf's path is ``jax.tree_util.keystr``'s
(``['blocks']['ada_w']``, ``.mu``, ``[0]``), so a checkpoint's leaf
index and key string are the reference's for the same tree.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[Any, ...]   # str (dict key), ".name" (NamedTuple field), int


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_path(tree) -> List[Tuple[Path, Any]]:
    """(path, leaf) pairs in JAX's order."""
    out: List[Tuple[Path, Any]] = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        elif _is_namedtuple(node):
            for f in node._fields:
                walk(getattr(node, f), path + ("." + f,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            out.append((path, node))

    walk(tree, ())
    return out


def keystr(path: Path) -> str:
    parts = []
    for p in path:
        if isinstance(p, int):
            parts.append(f"[{p}]")
        elif p.startswith("."):
            parts.append(p)
        else:
            parts.append(f"[{p!r}]")
    return "".join(parts)


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(like, new_leaves) -> Any:
    """``like``'s structure with ``new_leaves`` (JAX's order) at its
    leaves."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, f))
                                for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def map(fn: Callable, tree, *rest) -> Any:  # noqa: A001 (jax.tree.map)
    """``fn`` over the leaves of ``tree`` and of each tree in ``rest``
    (same structure), in ``tree``'s structure."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree), *others)])
