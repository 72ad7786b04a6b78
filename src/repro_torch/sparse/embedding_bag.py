"""Embedding lookups and bags (``repro/sparse/embedding_bag.py``): a
gather, then a segment reduction.

Two layouts, as in the reference:

* fixed single-hot: a ``(batch, n_fields)`` index matrix, one id per
  field (DLRM's Criteo layout), a plain gather;
* ragged multi-hot: flat ``values`` and ``bag_ids``, reduced per bag with
  sum, mean or max.

Every gather follows ``jnp.take``'s rule (``embedding_lookup``), the one
implementation of it in the port (``models.recsys`` and
``models.dimenet`` gather through it): a negative id counts from the end
of the table, an id still outside it reads a fill row (NaN for a float
table, the dtype's lowest value for an integer one) and passes no
gradient to the table.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.sparse.segment import segment_max, segment_mean, segment_sum


class _Gather(torch.autograd.Function):
    """``table[rows]`` (a 2-D table, ``rows`` flat and in range) whose
    backward is ``segment.segment_sum`` of the rows' gradients by the
    caller's ``idx`` (negative ids wrapped, ids outside dropped): one
    fixed order of sums, planned once per index tensor."""

    @staticmethod
    def forward(ctx, table, rows, idx):
        ctx.idx, ctx.n = idx, table.shape[0]
        return F.embedding(rows, table)

    @staticmethod
    def backward(ctx, grad):
        return segment_sum(grad, ctx.idx, ctx.n, wrap=True), None, None


def embedding_lookup(table: torch.Tensor, idx: torch.Tensor, *,
                     reproducible: bool = False) -> torch.Tensor:
    """``jnp.take(table, idx, axis=0)``: rows of ``table`` at ``idx`` (any
    shape), ``idx.shape + table.shape[1:]``. An id below 0 reads row ``id +
    rows``; an id that is then outside ``[0, rows)`` reads a NaN row (the
    dtype's lowest value for an integer table), and its position passes
    no gradient to the table (JAX's fill-or-drop).

    With ``reproducible`` the table's gradient is summed in one fixed
    order (``_Gather``: the sum's plan is built once per ``idx`` tensor
    and kept on it), so two backward passes give the same bits; without
    it ``F.embedding``'s backward runs, which on the card adds partial
    sums with atomics where ids repeat. DimeNet sets it: its index arrays
    serve every block and step. The recsys tables, whose ids are new each
    step, keep the faster backward."""
    n = table.shape[0]
    i = idx.long()
    i = torch.where(i < 0, i + n, i)
    inside = (i >= 0) & (i < n)
    flat, rows = (table.reshape(n, math.prod(table.shape[1:])),
                  torch.where(inside, i, 0).reshape(-1))
    rows = (_Gather.apply(flat, rows, idx) if reproducible
            else F.embedding(rows, flat))
    rows = rows.reshape(tuple(idx.shape) + tuple(table.shape[1:]))
    fill = (torch.nan if table.dtype.is_floating_point
            else torch.iinfo(table.dtype).min)
    inside = inside.reshape(inside.shape + (1,) * (table.dim() - 1))
    return torch.where(inside, rows, fill)


def embedding_bag(
    table: torch.Tensor,          # (rows, dim)
    values: torch.Tensor,         # (nnz,) flat indices
    bag_ids: torch.Tensor,        # (nnz,) which bag each value belongs to
    n_bags: int,
    *,
    combiner: str = "sum",
    weights: Optional[torch.Tensor] = None,  # (nnz,) per-sample weights
) -> torch.Tensor:
    reducers = {"sum": segment_sum, "mean": segment_mean, "max": segment_max}
    if combiner not in reducers:
        raise ValueError(f"unknown combiner {combiner!r}")
    emb = embedding_lookup(table, values)                  # (nnz, dim)
    if weights is not None:
        emb = emb * weights[:, None]
    return reducers[combiner](emb, bag_ids, n_bags)


def multi_table_lookup(tables: Sequence[torch.Tensor],
                       idx: torch.Tensor) -> torch.Tensor:
    """DLRM-style: one id per field, one table per field. ``tables``: a list
    of ``(rows_f, dim)``; ``idx``: ``(batch, n_fields)``. Returns
    ``(batch, n_fields, dim)``."""
    return torch.stack([embedding_lookup(t, idx[:, f])
                        for f, t in enumerate(tables)], dim=1)
