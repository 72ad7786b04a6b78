"""Gradient accumulation (``repro/optim/accumulation.py``): the batch
split into ``n_micro`` chunks along its leading axis, one loss and grad
per chunk, averaged. Activation memory is that of one chunk while the
optimizer step keeps the whole batch. ``GradAccumulator`` is the
fault-tolerant runner's host-side window, normalised by the count it
actually holds.

Over a mesh, ``zero_reducer`` is the counterpart of the reference's
``grad_specs`` (ZeRO-2): each micro-batch's gradients are summed over the
batch axes into this rank's ZeRO block as they come
(``collectives.psum_scatter`` along the dimension the ZeRO spec splits),
so the f32 accumulator lives at that block, never at the param block."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.tree import tree_map

Tree = Any


def microbatch_grads(
    loss_and_grad_fn: Callable[[Tree, Dict[str, torch.Tensor]],
                               Tuple[torch.Tensor, Tree]],
    params: Tree,
    batch: Dict[str, torch.Tensor],
    *,
    n_micro: int,
    reduce: Optional[Callable[[Tree], Tree]] = None,
) -> Tuple[torch.Tensor, Tree]:
    """``(mean loss, mean f32 grads)`` over ``n_micro`` chunks (with one
    chunk, the grads in the params' dtype). ``reduce`` (``zero_reducer``'s)
    takes each chunk's gradients to where they are accumulated."""
    reduce = reduce or (lambda g: g)
    if n_micro == 1:
        loss, grads = loss_and_grad_fn(params, batch)
        return loss, reduce(grads)
    for k, x in batch.items():
        if x.shape[0] % n_micro:
            raise ValueError(f"microbatch_grads: {k} has batch "
                             f"{x.shape[0]}, not divisible by {n_micro}")
    loss = grads = None
    for i in range(n_micro):
        mb = {k: x.chunk(n_micro)[i] for k, x in batch.items()}
        l_i, g_i = loss_and_grad_fn(params, mb)
        l_i = l_i.float() / n_micro
        g_i = tree_map(lambda g: g.float() / n_micro, reduce(g_i))
        if grads is None:
            loss, grads = l_i, g_i
        else:
            loss, grads = loss + l_i, tree_map(torch.add, grads, g_i)
    return loss, grads


def zero_reducer(mesh: Any, param_specs: Tree, zero_specs: Tree,
                 split_axes: Sequence[str]) -> Callable[[Tree], Tree]:
    """``reduce(grads) -> grads``: a micro-batch's gradients at this rank's
    param blocks (``launch.sharding`` spec trees), each this rank's share
    (its rows of the batch, split over ``split_axes``; the same on every
    rank of the other axes), summed over the mesh's batch axes at this
    rank's ZeRO block, in the gradients' dtype. Per leaf: a dimension the
    ZeRO spec splits further over non-batch axes is cut (the share is the
    same on each of their ranks), one it splits over batch axes is
    ``psum_scatter``'d, and the batch axes it names nowhere are
    ``psum``'d (a leaf whose ZeRO spec adds no batch axis is all
    ``psum``). A batch axis that does not split the batch holds the same
    share on each of its ranks: only its rank 0 contributes. A dimension
    whose extra axes mix batch and non-batch axes raises.

    A batch axis that the param spec itself names (a recsys table split
    over ``("model", "data")``) is one over which the leaf's lookups have
    already gathered the batch (``sparse.sharded_embedding.
    row_sharded_take``): its block holds the gradient of every row, so
    nothing is summed or dropped over that axis."""
    from repro_torch.collectives import psum, psum_scatter
    from repro_torch.core.sharded import local_block
    from repro_torch.launch.mesh import batch_axes
    from repro_torch.launch.sharding import map_specs, spec_axes, zero_extra

    baxes = batch_axes(mesh)

    def leaf(pspec, zspec, g):
        held = set(spec_axes(pspec))
        extra = zero_extra(pspec, zspec)
        cuts, scatters = [], []
        for dim, axes in enumerate(extra):
            in_batch = [a in baxes for a in axes]
            if axes and all(in_batch):
                scatters.append((dim, axes))
            elif any(in_batch):
                raise ValueError(f"ZeRO spec {zspec}: dimension {dim} splits "
                                 f"over batch and other axes {axes} at once")
            elif axes:
                cuts.append((dim, axes))
        if any(mesh.coords[a] for a in baxes
               if a not in split_axes and a not in held):
            g = torch.zeros_like(g)
        for dim, axes in cuts:
            g = local_block(mesh, (None,) * dim + (axes,), g)
        summed = set()
        for dim, axes in scatters:
            g = psum_scatter(g, axes, mesh, dim=dim)
            summed.update(axes)
        rest = tuple(a for a in baxes if a not in summed and a not in held)
        return psum(g, rest, mesh) if rest else g.contiguous()

    def reduce(grads: Tree) -> Tree:
        with torch.no_grad():
            return map_specs(leaf, param_specs, zero_specs, grads)
    return reduce


@dataclasses.dataclass
class GradAccumulator:
    """Stateful accumulator for the fault-tolerant runner: lets the
    straggler path drop a microbatch from the window (normalizes by the
    count actually accumulated)."""

    grads: Tree = None
    count: int = 0

    def add(self, grads: Tree) -> None:
        if self.grads is None:
            self.grads = grads
            self.count = 1
        else:
            self.grads = tree_map(torch.add, self.grads, grads)
            self.count += 1

    def mean_and_reset(self) -> Tree:
        if self.count == 0:
            raise ValueError("no gradients accumulated")
        out = tree_map(lambda g: g / self.count, self.grads)
        self.grads, self.count = None, 0
        return out
