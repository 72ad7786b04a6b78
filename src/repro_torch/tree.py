"""Nested dicts of tensors as trees (what ``jax.tree`` does for the JAX
package): map over leaves, list them, name them by path."""

from __future__ import annotations

from typing import Any, Callable, Dict, List


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of same-shaped ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves in sorted-key order, as ``jax.tree.leaves`` lists a
    dict's."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_items(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """``{"a/b": leaf}`` for every leaf, in the tree's own order."""
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for key, value in tree.items():
            out.update(tree_items(value, f"{prefix}{key}/"))
        return out
    return {prefix[:-1]: tree}
