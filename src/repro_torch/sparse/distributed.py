"""The gather and the scatter-add of row-sharded tensors over a mesh
(``repro/sparse/distributed.py``), on each rank's block.

A full-graph batch keeps each of its edge, triplet and node tables on
the ranks in row blocks; a gather ``take(table, idx)`` whose ids reach
into every block would otherwise replicate the table on every rank.
Instead, the partition-parallel gather (DGL/P3-style), as in the
reference:

  1. each rank sorts the row ids it needs by the rank that owns them,
  2. the ids go to their owners in one ``all_to_all``, capacity-capped
     like an MoE dispatch (uniform ids reach an owner R/n ± 3·sqrt(R/n)
     times, so ``_capacity``'s 1.25x drops nothing in practice; the
     dropped count is returned for monitoring),
  3. every owner gathers the requested rows of its block,
  4. the rows come back in the reverse ``all_to_all`` and go back into
     request order.

The scatter-add is its transpose: each value row travels to its
destination's owner, which sums what it receives by row.

The rules are the reference's, to the integer: the owner of id ``i`` is
``floor(i / rows_local)`` clipped to ``[0, n - 1]``, its row ``i mod
rows_local`` with the sign of the divisor, so an id below 0 or at or past
``n * rows_local`` goes where the JAX one goes; requests are sorted by
owner stably, so the first ones to an owner keep its ``C`` slots and the
rest are dropped (zero rows in a take, nothing added in a sum). The
owner's gather is the reproducible ``embedding_lookup`` and its sum
``segment.segment_sum``, so a step repeats bit for bit; the gradients
are those of ``collectives.all_to_all``'s transpose, as ``jax.grad``
takes them through the reference's ``shard_map``. ``DROPS`` records
each call's dropped count while it is on.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, List, Tuple

import torch

from repro_torch.collectives import all_to_all, psum
from repro_torch.launch.mesh import Axes, Mesh, as_axes, axis_size
from repro_torch.sparse.embedding_bag import embedding_lookup
from repro_torch.sparse.segment import segment_sum


class DropLog:
    """The dropped count (a tensor, summed over the axes) of every take
    and segment sum since ``reset``, in call order, while ``on``."""

    def __init__(self):
        self.reset(on=False)

    def reset(self, *, on: bool = True) -> None:
        self.on = on
        self.counts: List[Tuple[str, torch.Tensor]] = []

    def record(self, kind: str, dropped: torch.Tensor) -> None:
        if self.on:
            self.counts.append((kind, dropped.detach()))

    def summary(self) -> List[Tuple[str, int]]:
        return [(kind, int(n)) for kind, n in self.counts]


DROPS = DropLog()


def _capacity(R: int, n: int, cap_factor: float) -> int:
    """Request slots per peer: cap_factor x mean + a 3-sigma floor so
    small-R cases don't truncate (uniform ids ~ Binomial(R, 1/n))."""
    mean = R / n
    return max(4, int(math.ceil(cap_factor * mean + 3 * math.sqrt(mean))))


def _route(idx: torch.Tensor, rows_local: int, n: int, C: int):
    """Each request's row on its owner and its slot in the flat ``(n * C)``
    send buffer (``n * C`` when dropped); for each slot, the request that
    fills it (``R`` for none); the dropped count on this rank."""
    idx = idx.long()
    R = idx.shape[0]
    owner = torch.div(idx, rows_local, rounding_mode="floor").clamp(0, n - 1)
    row = torch.remainder(idx, rows_local)
    s_owner, order = torch.sort(owner, stable=True)
    counts = torch.bincount(owner, minlength=n)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(R, device=idx.device) - starts[s_owner]
    keep = rank < C
    s_slot = torch.where(keep, s_owner * C + rank, n * C)
    slot = torch.empty_like(s_slot)
    slot[order] = s_slot
    filler = torch.full((n * C + 1,), R, dtype=torch.long, device=idx.device)
    filler[s_slot] = order          # dropped ones all land on the cut slot
    return row, slot, filler[:n * C], (~keep).sum()


def distributed_take_local(
    src_local: torch.Tensor,    # (rows_local, d) this rank's rows
    idx_local: torch.Tensor,    # (R,) GLOBAL row ids needed here
    *,
    axis_names: Axes,
    mesh: Mesh,
    cap_factor: float = 1.25,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``((R, d) rows, dropped count)``: the rows of the global table at
    ``idx_local``, the table row-sharded over ``axis_names``. A request past
    its owner's capacity gives a zero row (counted, not silent); the count
    is summed over the axes, the same on every rank."""
    axes = as_axes(axis_names)
    rows_local, d = src_local.shape
    n = axis_size(mesh, axes)
    C = _capacity(idx_local.shape[0], n, cap_factor)
    row, slot, filler, dropped = _route(idx_local, rows_local, n, C)

    req = torch.cat([row, row.new_zeros(1)])[filler].view(n, C)
    req_in = all_to_all(req, axes, mesh)                      # (n, C)
    served = embedding_lookup(src_local, req_in.reshape(-1),
                              reproducible=True).view(n, C, d)
    back = all_to_all(served, axes, mesh)                     # (n, C, d)
    back = torch.cat([back.reshape(n * C, d), back.new_zeros(1, d)])
    out = embedding_lookup(back, slot, reproducible=True)     # (R, d)
    dropped = psum(dropped, axes, mesh)
    DROPS.record("take", dropped)
    return out, dropped


def distributed_segment_sum_local(
    vals_local: torch.Tensor,   # (R, d) rows to scatter-add
    idx_local: torch.Tensor,    # (R,) GLOBAL destination row ids
    out_local_rows: int,        # rows of the output this rank owns
    *,
    axis_names: Axes,
    mesh: Mesh,
    cap_factor: float = 1.25,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``((out_local_rows, d) this rank's block of the sum, dropped
    count)``: the transpose of ``distributed_take_local``. Each value row
    goes to its destination's owner in one ``all_to_all``; the owner sums
    what it receives by row, the unused slots into an extra row
    ``out_local_rows``, which is cut off."""
    axes = as_axes(axis_names)
    R, d = vals_local.shape
    n = axis_size(mesh, axes)
    C = _capacity(R, n, cap_factor)
    row, _, filler, dropped = _route(idx_local, out_local_rows, n, C)

    ids = torch.cat([row, row.new_full((1,), out_local_rows)])[filler]
    vals = embedding_lookup(torch.cat([vals_local,
                                       vals_local.new_zeros(1, d)]),
                            filler, reproducible=True)
    ids_in = all_to_all(ids.view(n, C), axes, mesh)
    vals_in = all_to_all(vals.view(n, C, d), axes, mesh)
    out = segment_sum(vals_in.reshape(n * C, d), ids_in.reshape(n * C),
                      out_local_rows + 1)[:out_local_rows]
    dropped = psum(dropped, axes, mesh)
    DROPS.record("segment_sum", dropped)
    return out, dropped


def make_distributed_take(mesh: Mesh, axis_names: Axes, *,
                          cap_factor: float = 1.25
                          ) -> Callable[[torch.Tensor, torch.Tensor],
                                        Tuple[torch.Tensor, torch.Tensor]]:
    """``take(src, idx) -> (rows, dropped)`` on this rank's row blocks of
    ``src`` and ``idx`` (the reference's ``shard_map`` over
    ``P(axis_names)`` blocks), this rank's block of the rows and the count
    replicated."""
    return functools.partial(distributed_take_local,
                             axis_names=as_axes(axis_names), mesh=mesh,
                             cap_factor=cap_factor)

