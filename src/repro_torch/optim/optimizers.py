"""AdamW, Adagrad, SGD with momentum and global-norm clipping
(``repro/optim/optimizers.py``), with the JAX package's math, as pure
functions over trees of tensors (nested dicts and lists, ``tree``).

Two places differ from ``torch.optim.AdamW`` + ``clip_grad_norm_``, so
those are not used: the clip scale is ``min(1, max_norm / max(gn,
1e-12))``, and the weight decay enters the step as ``delta = mhat /
(sqrt(vhat) + eps) + wd * p`` on every leaf (norm scales and the bias
included) with ``t = step + 1``. The moments are f32; updates come back
in f32 and the caller casts them to the params' dtype
(``launch.steps``). Adagrad (the recsys tables' optimizer) and SGD with
momentum keep f32 state and return their updates cast to each param's
dtype, as the reference's do. Nothing is updated in place.

Over a mesh with ZeRO (``launch.steps.build_lsr_train_step(zero_specs=)``)
each rank holds blocks: ``adamw(shard_fn=, mesh=, block_axes=)`` cuts the
params to the moments' blocks (the reference's ``shard_fn``) and clips
by the norm of the whole gradient, each distinct block counted once.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.optim.schedules import f32
from repro_torch.tree import tree_leaves, tree_map

Tree = Any


class Optimizer(NamedTuple):
    init: Callable[[Tree], Tree]
    # update(grads, state, params, step) -> (updates, new_state)
    update: Callable[[Tree, Tree, Tree, int], Tuple[Tree, Tree]]


def clip_by_global_norm(grads: Tree, max_norm: float, *, mesh: Any = None,
                        block_axes: Tree = None
                        ) -> Tuple[Tree, torch.Tensor]:
    """Scale every leaf by ``min(1, max_norm / max(gn, 1e-12))``, with
    ``gn`` the f32 norm over all leaves. Returns ``(grads, gn)``.

    With ``mesh`` each leaf is this rank's block, and ``block_axes`` a
    tree like ``grads`` of the axes over which each leaf's blocks differ
    (those its ZeRO spec names; the blocks are the same over the
    others): each rank sums its blocks' squares by those axes, one
    all-reduce over each distinct set of axes, so every block counts
    once and every rank gets the same norm."""
    if mesh is None:
        sq = [(g.float() * g.float()).sum() for g in tree_leaves(grads)]
        total = sq[0]
        for s in sq[1:]:
            total = total + s
    else:
        total = _blocks_sum_sq(grads, mesh, block_axes)
    gn = total.sqrt()
    scale = (max_norm / gn.clamp_min(1e-12)).clamp_max(1.0)
    return tree_map(lambda g: g * scale, grads), gn


def _blocks_sum_sq(grads: Tree, mesh: Any, block_axes: Tree
                   ) -> torch.Tensor:
    """The f32 sum of squares of the whole gradient from each rank's
    blocks (``clip_by_global_norm`` over a mesh). The leaves are added in
    ``tree_leaves``' order, as without a mesh, so with no axes the sum is
    the unsharded clip's, bit for bit."""
    from repro_torch.collectives import psum

    keys = tree_map(lambda g, axes: "/".join(
        a for a in mesh.axis_names if a in axes), grads, block_axes)
    groups: Dict[str, torch.Tensor] = {}
    for g, key in zip(tree_leaves(grads), tree_leaves(keys)):
        s = (g.float() * g.float()).sum()
        groups[key] = s if key not in groups else groups[key] + s
    total = None
    with torch.no_grad():
        for key, s in groups.items():
            part = psum(s, tuple(key.split("/")), mesh) if key else s
            total = part if total is None else total + part
    return total


def adamw(
    lr: Union[Callable[[int], float], float],
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.01,
    max_grad_norm: Optional[float] = 1.0,
    shard_fn: Optional[Callable[[Tree], Tree]] = None,
    mesh: Any = None,
    block_axes: Tree = None,
) -> Optimizer:
    """``shard_fn`` (the reference's ZeRO constraint): the gradients and
    moments are this rank's ZeRO blocks, and ``shard_fn(params)`` cuts the
    params to the same blocks, so every f32 temporary of the update lives
    there; ``mesh`` and ``block_axes`` make the clip's norm that of the
    whole gradient (``clip_by_global_norm``)."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params: Tree) -> Tree:
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}

    def update(grads: Tree, state: Tree, params: Tree,
               step: int) -> Tuple[Tree, Tree]:
        if max_grad_norm is not None:
            grads, _ = clip_by_global_norm(grads, max_grad_norm, mesh=mesh,
                                           block_axes=block_axes)
        if shard_fn is not None:
            params = shard_fn(params)
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
        return (_pick(params, out, 0),
                {"mu": _pick(params, out, 1), "nu": _pick(params, out, 2)})

    return Optimizer(init, update)


def adagrad(
    lr: Union[Callable[[int], float], float],
    *,
    eps: float = 1e-10,
    initial_accumulator: float = 0.1,
) -> Optimizer:
    """Per-element adaptive rates: ``acc += g^2`` (f32, starting at
    ``initial_accumulator``), update ``-lr * g / (sqrt(acc) + eps)`` in
    the param's dtype. The state is ``{"acc": tree like params}``. A dense
    gradient reaches every row of a table: a row no id touched gets
    ``acc + 0`` and an update of ``-0``, as in the reference."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params: Tree) -> Tree:
        return {"acc": tree_map(
            lambda p: torch.full_like(p, initial_accumulator,
                                      dtype=torch.float32), params)}

    def update(grads: Tree, state: Tree, params: Tree,
               step: int) -> Tuple[Tree, Tree]:
        lr_t = float(f32(lr_fn(step)))

        def upd(g, a, p):
            g = g.float()
            a2 = a + g * g
            return (-lr_t * g / (a2.sqrt() + eps)).to(p.dtype), a2

        out = tree_map(upd, grads, state["acc"], params)
        return _pick(params, out, 0), {"acc": _pick(params, out, 1)}

    return Optimizer(init, update)


def sgd_momentum(
    lr: Union[Callable[[int], float], float],
    *,
    momentum: float = 0.9,
    nesterov: bool = False,
) -> Optimizer:
    """Heavy-ball momentum, ``v = momentum * v + g`` (f32), the step
    ``-lr * v`` (Nesterov: ``-lr * (g + momentum * v)``) in the param's
    dtype. The state is ``{"v": tree like params}``."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params: Tree) -> Tree:
        return {"v": tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), params)}

    def update(grads: Tree, state: Tree, params: Tree,
               step: int) -> Tuple[Tree, Tree]:
        lr_t = float(f32(lr_fn(step)))

        def upd(g, v, p):
            g = g.float()
            v2 = momentum * v + g
            d = g + momentum * v2 if nesterov else v2
            return (-lr_t * d).to(p.dtype), v2

        out = tree_map(upd, grads, state["v"], params)
        return _pick(params, out, 0), {"v": _pick(params, out, 1)}

    return Optimizer(init, update)


def _pick(like: Tree, out: Tree, i: int) -> Tree:
    """Element ``i`` of the tuples that ``out`` holds at the leaves of
    ``like`` (a tree of the same shape)."""
    return tree_map(lambda _, o: o[i], like, out)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
