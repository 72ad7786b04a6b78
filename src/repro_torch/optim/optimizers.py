"""AdamW and global-norm clipping (``repro/optim/optimizers.py``), with
the JAX package's math, as pure functions over nested dicts of tensors.

Two places differ from ``torch.optim.AdamW`` + ``clip_grad_norm_``, so
those are not used: the clip scale is ``min(1, max_norm / max(gn,
1e-12))``, and the weight decay enters the step as ``delta = mhat /
(sqrt(vhat) + eps) + wd * p`` on every leaf (norm scales and the bias
included) with ``t = step + 1``. The moments are f32; updates come back
in f32 and the caller casts them to the params' dtype
(``launch.steps``). Nothing is updated in place.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.optim.schedules import f32
from repro_torch.tree import tree_leaves, tree_map

Tree = Any


class Optimizer(NamedTuple):
    init: Callable[[Tree], Tree]
    # update(grads, state, params, step) -> (updates, new_state)
    update: Callable[[Tree, Tree, Tree, int], Tuple[Tree, Tree]]


def clip_by_global_norm(grads: Tree,
                        max_norm: float) -> Tuple[Tree, torch.Tensor]:
    """Scale every leaf by ``min(1, max_norm / max(gn, 1e-12))``, with
    ``gn`` the f32 norm over all leaves. Returns ``(grads, gn)``."""
    sq = [(g.float() * g.float()).sum() for g in tree_leaves(grads)]
    total = sq[0]
    for s in sq[1:]:
        total = total + s
    gn = total.sqrt()
    scale = (max_norm / gn.clamp_min(1e-12)).clamp_max(1.0)
    return tree_map(lambda g: g * scale, grads), gn


def adamw(
    lr: Union[Callable[[int], float], float],
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.01,
    max_grad_norm: Optional[float] = 1.0,
) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params: Tree) -> Tree:
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    def update(grads: Tree, state: Tree, params: Tree,
               step: int) -> Tuple[Tree, Tree]:
        if max_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, max_grad_norm)
        # the scalars in f32, as the JAX step computes them
        t = f32(step) + 1.0
        lr_t = float(f32(lr_fn(step)))
        bc1 = float(1.0 - f32(b1) ** t)
        bc2 = float(1.0 - f32(b2) ** t)

        def upd(g, m, v, p):
            g = g.float()
            m2 = b1 * m + (1 - b1) * g
            v2 = b2 * v + (1 - b2) * g * g
            delta = (m2 / bc1) / ((v2 / bc2).sqrt() + eps)
            delta = delta + weight_decay * p.float()
            return -lr_t * delta, m2, v2

        out = tree_map(upd, grads, state["mu"], state["nu"], params)
        return _pick(out, 0), {"mu": _pick(out, 1), "nu": _pick(out, 2)}

    return Optimizer(init, update)


def _pick(tree: Tree, i: int) -> Tree:
    """Element ``i`` of the tuples at the leaves of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
