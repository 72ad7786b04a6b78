"""Row-sharded embedding tables (``repro/sparse/sharded_embedding.py``):
DLRM's model parallelism over a ``launch.mesh.Mesh``.

A table too large for one card keeps its rows split over mesh axes, each
rank a contiguous block. A lookup is a mask and a reduction: every rank
gathers the ids that fall in its block from its own rows (the others
read 0) and the partials are summed over the axes (``collectives.psum``).
No table is ever gathered; only ``(ids, dim)`` rows cross the
interconnect.

* ``sharded_lookup_local`` is the reference's body (inside its
  ``shard_map``): this rank's block, the ids whole on every rank of the
  axes, an id outside every block reads 0. Its backward is ``psum``'s
  identity (the one cotangent, as under ``shard_map``), then a
  scatter-add into this rank's rows.
* ``make_sharded_lookup``, ``pad_table_rows``, ``table_sharding`` and
  ``init_tables`` complete the reference's module.
* ``row_sharded_take`` is what the recsys mesh steps
  (``launch.steps``) look tables up with: ``jnp.take``'s rule (a
  negative id wraps, an id past the table reads NaN and passes no
  gradient), which GSPMD keeps when it partitions the reference's
  ``take``, for ids that are either whole on every rank or this rank's
  rows of a batch split over some of the table's axes (then gathered
  over them, and the sum ``psum_scatter``'d back).

The block order is row-major over the axes as the spec names them
(``(("model", "data"), None)`` is model-major): the offset is
``axis_index(mesh, axes) * rows_local``, the index by which
``core.sharded.local_block`` and ``launch.sharding.shard_state`` cut.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.collectives import all_gather_invariant, psum, psum_scatter
from repro_torch.launch.mesh import Axes, as_axes, axis_index, axis_size
from repro_torch.sparse.embedding_bag import embedding_lookup as take_rows


def _block_rows(local_table: torch.Tensor, idx: torch.Tensor, axes,
                mesh) -> torch.Tensor:
    """This rank's partial of a lookup of global ``idx`` (any shape) in a
    table split by rows over ``axes``: its own rows where the id falls in
    its block, 0 elsewhere."""
    rows_local = local_table.shape[0]
    local = idx.long() - axis_index(mesh, axes) * rows_local
    in_range = (local >= 0) & (local < rows_local)
    out = take_rows(local_table, torch.where(in_range, local, 0))
    in_range = in_range.reshape(in_range.shape
                                + (1,) * (local_table.dim() - 1))
    return torch.where(in_range, out, out.new_zeros(()))


def sharded_lookup_local(local_table: torch.Tensor, idx: torch.Tensor, *,
                         axis_name: Axes, mesh) -> torch.Tensor:
    """``local_table`` (``(rows_local, ...)``, this rank's row block over
    ``axis_name``, one axis or a tuple of them) at the global ``idx`` (any
    shape, the same on every rank of the axes): ``idx.shape +
    local_table.shape[1:]``, the same on every rank. An id outside every
    block reads 0 (the reference's rule)."""
    axes = as_axes(axis_name)
    return psum(_block_rows(local_table, idx, axes, mesh), axes, mesh)


def make_sharded_lookup(mesh, axis_name: Axes = "model"):
    """``lookup(local_table, idx)``: ``sharded_lookup_local`` over
    ``axis_name``; ``local_table`` is this rank's block of a table laid
    out by ``table_sharding(mesh, axis_name)`` (its rows padded so that
    the axes divide them: ``pad_table_rows``)."""
    def lookup(local_table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        return sharded_lookup_local(local_table, idx, axis_name=axis_name,
                                    mesh=mesh)
    return lookup


def pad_table_rows(rows: int, n_shards: int) -> int:
    return rows + ((-rows) % n_shards)


def table_sharding(mesh, axis_name: Axes = "model"):
    """The spec of a table row-sharded over ``axis_name`` (the port's form
    of ``P(axis_name, None)``)."""
    return (as_axes(axis_name), None)


def init_tables(generator: torch.Generator, table_sizes: Sequence[int],
                dim: int, n_shards: int = 1, dtype=torch.float32,
                device=None) -> List[torch.Tensor]:
    """One ``(pad_table_rows(rows, n_shards), dim)`` table a size, normal
    times ``dim ** -0.5``, drawn in order from ``generator`` on ``device``
    (default the generator's). The numbers differ from ``jax.random``'s."""
    device = generator.device if device is None else device
    return [torch.randn((pad_table_rows(rows, n_shards), dim),
                        generator=generator, dtype=dtype, device=device)
            .mul_(dim ** -0.5) for rows in table_sizes]


def row_sharded_take(local_table: torch.Tensor, idx: torch.Tensor, *,
                     axes: Axes, mesh, batch_axes: Sequence[str] = ()
                     ) -> torch.Tensor:
    """``jnp.take(table, idx, axis=0)`` of a table split by rows over
    ``axes`` (``local_table`` this rank's block), as the unsharded
    ``take_rows`` gives it: a negative id counts from the end of the
    whole table, an id still outside it reads NaN and passes no gradient.

    ``idx`` (any shape, leading dimension the batch) is this rank's rows
    of a batch split over ``batch_axes`` (``()``: the whole ids on every
    rank). Over the table's axes that split the batch the ids are
    gathered first, and the sum of the partials is ``psum_scatter``'d
    back to this rank's rows, so the backward gathers the cotangent and
    this rank's block gets the gradient of the whole batch; over the
    others (``model``, whose ranks hold the same rows) the partials are
    ``psum``'d."""
    axes = as_axes(axes)
    gather = tuple(a for a in batch_axes if a in axes)
    summed = tuple(a for a in axes if a not in gather)
    n = local_table.shape[0] * axis_size(mesh, axes)
    i = idx.long()
    i = torch.where(i < 0, i + n, i)
    inside = (i >= 0) & (i < n)
    ids = all_gather_invariant(i, gather, mesh) if gather else i
    out = _block_rows(local_table, ids, axes, mesh)
    if summed:
        out = psum(out, summed, mesh)
    if gather:
        out = psum_scatter(out, gather, mesh)
    inside = inside.reshape(inside.shape + (1,) * (local_table.dim() - 1))
    return torch.where(inside, out, out.new_full((), torch.nan))
