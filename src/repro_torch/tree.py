"""Nested dicts, lists and tuples of tensors as trees (what ``jax.tree``
does for the JAX package): map over leaves, list them, name them by path.

A dict, a list or a tuple is a node; anything else is a leaf. Leaves are
listed in JAX's order: a dict's by sorted key, a list's or a tuple's by
index. ``tree_map`` and ``tree_items`` keep a dict's own key order.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of same-shaped ``rest``. A
    node of ``rest`` where ``tree`` has a leaf reaches ``fn`` whole."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves in JAX's order (``jax.tree.leaves``): a dict's by sorted
    key, a list's by index."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_items(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """``{"a/b": leaf}`` for every leaf, in the tree's own order; a list's
    entries are named by index (``"tables/0"``)."""
    if isinstance(tree, (dict, list, tuple)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out: Dict[str, Any] = {}
        for key, value in items:
            out.update(tree_items(value, f"{prefix}{key}/"))
        return out
    return {prefix[:-1]: tree}
