"""Gradient accumulation (``repro/optim/accumulation.py``): the batch
split into ``n_micro`` chunks along its leading axis, one loss and grad
per chunk, averaged. Activation memory is that of one chunk while the
optimizer step keeps the whole batch. ``GradAccumulator`` is the
fault-tolerant runner's host-side window, normalised by the count it
actually holds."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

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
) -> Tuple[torch.Tensor, Tree]:
    """``(mean loss, mean f32 grads)`` over ``n_micro`` chunks."""
    if n_micro == 1:
        return loss_and_grad_fn(params, batch)
    for k, x in batch.items():
        if x.shape[0] % n_micro:
            raise ValueError(f"microbatch_grads: {k} has batch "
                             f"{x.shape[0]}, not divisible by {n_micro}")
    loss = grads = None
    for i in range(n_micro):
        mb = {k: x.chunk(n_micro)[i] for k, x in batch.items()}
        l_i, g_i = loss_and_grad_fn(params, mb)
        l_i = l_i.float() / n_micro
        g_i = tree_map(lambda g: g.float() / n_micro, g_i)
        if grads is None:
            loss, grads = l_i, g_i
        else:
            loss, grads = loss + l_i, tree_map(torch.add, grads, g_i)
    return loss, grads


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
