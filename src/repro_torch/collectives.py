"""Collectives over the axes of a ``launch.mesh.Mesh``, as autograd
functions whose gradients are those of ``shard_map``'s transposes in the
JAX package.

Each rank seeds its own backward with the cotangent of its own outputs.
A value that is the same on every rank of an axis (replicated over it,
like a loss summed over ``model``) has one cotangent, which every rank
holds; a value that differs over an axis has one per rank. So:

* ``psum`` — sum forward, identity backward: its output is replicated
  over ``axes``, and the cotangent every rank holds is the one cotangent.
  ``pmean`` is ``psum / n`` (its backward divides by n).
* ``replicated_input`` — identity forward, sum backward: a value
  replicated over ``axes`` entering a computation whose parts differ
  over them (``H`` entering the vocab-sharded head: ``∇H`` is one sum
  over ``model``).
* ``all_gather`` — the tiled gather in the row-major order of ``axes``;
  its output feeds parts that differ over ``axes``, so the backward sums
  the cotangents and keeps this rank's block (a reduce-scatter, written
  as an all-reduce and a slice).
* ``shard_rows`` — this rank's block of a replicated tensor along
  ``dim`` (a view), the backward gathering every rank's block of the
  cotangent: the gradient of the whole tensor on every rank.
* ``all_gather_invariant`` — the same gather, for an output that stays
  replicated over ``axes`` (a loss computed on every rank from the whole
  tensor): one cotangent, so the backward keeps this rank's block of it
  and sums nothing (the transpose of ``shard_rows``).
* ``psum_scatter`` — the sum over ``axes``, of which each rank keeps its
  block along ``dim`` (``jax.lax.psum_scatter(..., tiled=True)``, written
  as an all-reduce and a slice); the backward gathers the blocks'
  cotangents.
* ``all_to_all`` — the tiled exchange, and its transpose as backward.

``torch.distributed.nn``'s ``all_reduce`` sums cotangents in its backward
(an ``n``-fold gradient under a replicated loss) and its ``all_gather``
needs ``reduce_scatter``, so neither is used. The passes use
``all_reduce``, ``all_gather``, ``all_to_all_single`` and ``broadcast``.
A group of one rank runs no collective. ``TALLY`` counts each kind's
calls, bytes and host seconds (with ``TALLY.synchronize`` set, the card
is synchronised before each one starts, so its seconds are its own).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import Axes, Mesh, as_axes, axis_index, axis_size


class Tally:
    """Calls, bytes (of this rank's input) and host seconds per kind."""

    def __init__(self):
        self.synchronize = False
        self.reset()

    def reset(self, *, synchronize: bool = False) -> None:
        self.synchronize = synchronize
        self.by_kind: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def clock(self, kind: str, x: torch.Tensor):
        if self.synchronize and x.is_cuda:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        yield
        if self.synchronize and x.is_cuda:
            torch.cuda.synchronize(x.device)
        row = self.by_kind.setdefault(kind, [0, 0, 0.0])
        row[0] += 1
        row[1] += x.numel() * x.element_size()
        row[2] += time.perf_counter() - t0

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"calls": c, "bytes": b, "ms": 1e3 * s}
                for k, (c, b, s) in self.by_kind.items()}


TALLY = Tally()


def _sum(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    """The sum of ``x`` over the group of ``axes`` (a new tensor)."""
    if axis_size(mesh, axes) == 1:
        return x.view_as(x)
    y = x.contiguous().clone()
    with TALLY.clock("all_reduce", y):
        dist.all_reduce(y, group=mesh.group(axes))
    return y


def _gather(x: torch.Tensor, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    """Every rank's ``x`` along ``axes``, concatenated along ``dim`` in the
    row-major order of ``axes``."""
    n = axis_size(mesh, axes)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    with TALLY.clock("all_gather", x):
        dist.all_gather(parts, x, group=mesh.group(axes))
    # all_gather fills ``parts`` in ascending global rank
    by_rank = dict(zip(sorted(mesh.ranks(axes)), parts))
    return torch.cat([by_rank[r] for r in mesh.ranks(axes)], dim=dim)


def _block(x: torch.Tensor, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (a view)."""
    n = axis_size(mesh, axes)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"split into {n} blocks over {as_axes(axes)}")
    size = x.shape[dim] // n
    return x.narrow(dim, axis_index(mesh, axes) * size, size)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _sum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ReplicatedInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.mesh, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        total = _sum(g, ctx.mesh, ctx.axes)
        return (_block(total, ctx.mesh, ctx.axes, ctx.dim).contiguous(),
                None, None, None)


class _AllGatherInvariant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (_block(g, ctx.mesh, ctx.axes, ctx.dim).contiguous(),
                None, None, None)


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _block(_sum(x, mesh, axes), mesh, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _ShardRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _block(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


def _exchange(x, mesh, axes, split_dim, concat_dim):
    n = axis_size(mesh, axes)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dimension {split_dim} of "
                         f"{tuple(x.shape)} does not split into {n}")
    # block i of split_dim goes to the i-th rank of the row-major order
    order = mesh.ranks(axes)
    pos = {r: i for i, r in enumerate(order)}
    chunks = x.chunk(n, dim=split_dim)
    send = torch.stack([chunks[pos[r]].contiguous()
                        for r in sorted(order)])
    recv = torch.empty_like(send)
    with TALLY.clock("all_to_all", send):
        dist.all_to_all_single(recv, send, group=mesh.group(axes))
    by_rank = dict(zip(sorted(order), recv.unbind(0)))
    return torch.cat([by_rank[r] for r in order], dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, split_dim, concat_dim):
        ctx.args = (mesh, axes, split_dim, concat_dim)
        return _exchange(x, mesh, axes, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, split_dim, concat_dim = ctx.args
        return (_exchange(g, mesh, axes, concat_dim, split_dim),
                None, None, None, None)


def psum(x: torch.Tensor, axes: Axes, mesh: Mesh) -> torch.Tensor:
    """Sum over ``axes``; the output is replicated over them."""
    return _Psum.apply(x, mesh, as_axes(axes))


def pmean(x: torch.Tensor, axes: Axes, mesh: Mesh) -> torch.Tensor:
    """Mean over ``axes`` (``psum / n``)."""
    return psum(x, axes, mesh) / axis_size(mesh, axes)


def replicated_input(x: torch.Tensor, axes: Axes,
                     mesh: Mesh) -> torch.Tensor:
    """``x`` as it is; its cotangents summed over ``axes`` backward."""
    return _ReplicatedInput.apply(x, mesh, as_axes(axes))


def all_gather(x: torch.Tensor, axes: Axes, mesh: Mesh, *,
               dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` over ``axes``, tiled along ``dim`` in the
    row-major order of ``axes`` (``jax.lax.all_gather(..., tiled=True)``)."""
    return _AllGather.apply(x, mesh, as_axes(axes), dim)


def all_gather_invariant(x: torch.Tensor, axes: Axes, mesh: Mesh, *,
                         dim: int = 0) -> torch.Tensor:
    """``all_gather`` for an output replicated over ``axes``: the backward
    takes this rank's block of the one cotangent."""
    return _AllGatherInvariant.apply(x, mesh, as_axes(axes), dim)


def psum_scatter(x: torch.Tensor, axes: Axes, mesh: Mesh, *,
                 dim: int = 0) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``x`` over ``axes``
    (``jax.lax.psum_scatter(x, axes, scatter_dimension=dim,
    tiled=True)``)."""
    return _PsumScatter.apply(x, mesh, as_axes(axes), dim)


def shard_rows(x: torch.Tensor, axes: Axes, mesh: Mesh, *,
               dim: int = 0) -> torch.Tensor:
    """This rank's block of ``x`` (replicated over ``axes``) along ``dim``:
    a view; the backward gathers the blocks' cotangents."""
    return _ShardRows.apply(x, mesh, as_axes(axes), dim)


def all_to_all(x: torch.Tensor, axes: Axes, mesh: Mesh, *,
               split_dim: int = 0, concat_dim: int = 0) -> torch.Tensor:
    """Block i of ``x`` along ``split_dim`` goes to the i-th rank of
    ``axes`` (row-major); the blocks received are concatenated along
    ``concat_dim`` in the same order."""
    return _AllToAll.apply(x, mesh, as_axes(axes), split_dim, concat_dim)


def broadcast(x: torch.Tensor, axes: Axes, mesh: Mesh) -> torch.Tensor:
    """The ``x`` of the first rank of ``axes`` (row-major), on each rank of
    the group (no gradient)."""
    y = x.detach().contiguous().clone()
    if axis_size(mesh, axes) > 1:
        with TALLY.clock("broadcast", y):
            dist.broadcast(y, src=mesh.ranks(axes)[0],
                           group=mesh.group(axes))
    return y
