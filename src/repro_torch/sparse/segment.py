"""Segment reductions, the message-passing primitive
(``repro/sparse/segment.py``), on tensors.

Graph aggregation is an edge-index gather followed by a segment
reduction, as in the reference. The reference's semantics, kept here:

* an id outside ``[0, num_segments)``, negative ids included, is dropped
  (``jax.ops.segment_*``); ``index_add_`` would raise on the CPU and trip
  a device assert on the card, so those rows are masked out first;
* an empty segment's max is the dtype's lowest value (``-inf`` for
  floats), an empty segment's argmax the int32 maximum (the identity of
  ``segment_min``);
* ``segment_mean`` divides by the count clamped at 1;
* gathers follow ``jnp.take`` (``embedding_bag.embedding_lookup``).

``segment_sum`` adds each segment's rows in one fixed order, so two runs
give the same bits. On the CPU that is ``index_add_``, a serial loop. On
the card ``index_add_`` adds with atomics, and ``index_put_(accumulate=
True)``, which sorts first, adds a segment's rows one after the other in
one warp: a hub of a million rows (padded edges all point at node 0,
padded triplet slots at edge 0) then takes most of a second. Floating
data on the card therefore takes ``sorted_segment_sum``: the rows sorted
stably by id, ``torch.segment_reduce`` over runs of at most ``CHUNK``
rows, then over each id's run sums; the sort and the offsets (a
``SegmentPlan``) are memoised on the index tensor; its backward is the
gather.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch


def _kept(segment_ids: torch.Tensor,
          num_segments: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ids with dropped ones set to 0, keep mask)``."""
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    return torch.where(keep, ids, 0), keep


def _rows(mask: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """A per-row mask broadcast against ``data``'s trailing dims."""
    return mask.reshape(mask.shape + (1,) * (data.dim() - mask.dim()))


def _lowest(dtype: torch.dtype) -> float:
    return (-float("inf") if dtype.is_floating_point
            else torch.iinfo(dtype).min)


CHUNK = 1024   # rows a run of a sorted sum's first level sums at most
# the devices whose floating segment sums take the sorted sum (``segment_sum``)
SORTED_SUM_DEVICES = ("cuda", "meta")


class SegmentPlan(NamedTuple):
    """How ``sorted_segment_sum`` sums rows by one index array: ``ids``
    (long; dropped ones set to ``num_segments``), ``order`` (the rows
    sorted stably by id), ``runs`` (offsets of the first level's runs: at
    most ``CHUNK`` sorted rows of one id) and ``segments`` (offsets of
    each segment's runs)."""

    ids: torch.Tensor
    order: torch.Tensor
    runs: torch.Tensor
    segments: torch.Tensor


def segment_plan(segment_ids: torch.Tensor, num_segments: int, *,
                 wrap: bool = False) -> SegmentPlan:
    """The ``SegmentPlan`` of ``segment_ids`` (ids outside ``[0,
    num_segments)`` dropped; with ``wrap`` a negative id first counts from
    the end, as ``jnp.take`` reads it). Built without a host sync, and
    memoised on ``segment_ids`` itself while its version stays the same
    (an in-place change bumps it): a model sums over the same index
    arrays in every layer and step."""
    key = (num_segments, wrap)
    memo = segment_ids.__dict__.setdefault("_segment_plans", {})
    if key in memo and memo[key][0] == segment_ids._version:
        return memo[key][1]
    n, R, device = num_segments, segment_ids.numel(), segment_ids.device
    ids = segment_ids.reshape(-1).long()
    if wrap:
        ids = torch.where(ids < 0, ids + n, ids)
    ids = torch.where((ids >= 0) & (ids < n), ids, n)
    sorted_ids, order = torch.sort(ids, stable=True)
    pos = torch.arange(R, device=device)
    start = torch.ones(R, dtype=torch.bool, device=device)
    start[1:] = (sorted_ids[1:] != sorted_ids[:-1]) | (pos[1:] % CHUNK == 0)
    run = torch.cumsum(start, 0) - 1                   # each row's run
    n_runs = min(n + 1, R) + -(-R // CHUNK)            # at most this many
    runs = torch.searchsorted(run, torch.arange(n_runs + 1, device=device))
    run_id = torch.where(runs[:-1] < R,
                         sorted_ids[runs[:-1].clamp(max=max(R - 1, 0))], n)
    segments = torch.searchsorted(run_id,
                                  torch.arange(n + 1, device=device))
    plan = SegmentPlan(ids, order, runs, segments)
    memo[key] = (segment_ids._version, plan)
    return plan


def sorted_segment_sum(data: torch.Tensor, plan: SegmentPlan,
                       num_segments: int) -> torch.Tensor:
    """The segment sum of ``data`` (R, ...) by ``plan``'s ids in one fixed
    order, without atomics or a host sync: the first level sums each run
    (at most ``CHUNK`` rows of one id), the second each segment's runs, so
    neither adds more than ``max(CHUNK, R / CHUNK + 1)`` values one after
    the other. (``segment_reduce``'s ``unsafe``: the offsets are valid by
    construction, and checking them would wait for the device.)"""
    flat = data.reshape(data.shape[0], math.prod(data.shape[1:]))
    part = torch.segment_reduce(flat.index_select(0, plan.order), "sum",
                                offsets=plan.runs, axis=0, unsafe=True)
    out = torch.segment_reduce(part, "sum", offsets=plan.segments, axis=0,
                               unsafe=True)
    return out.reshape((num_segments,) + tuple(data.shape[1:]))


class _SortedSegmentSum(torch.autograd.Function):
    """``sorted_segment_sum`` with its gradient: the output's gradient
    gathered at each row's id, 0 at a dropped row."""

    @staticmethod
    def forward(ctx, data, plan, num_segments):
        ctx.plan = plan
        return sorted_segment_sum(data, plan, num_segments)

    @staticmethod
    def backward(ctx, grad):
        padded = torch.cat([grad, grad.new_zeros((1,) + grad.shape[1:])])
        return padded.index_select(0, ctx.plan.ids), None, None


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, *, wrap: bool = False) -> torch.Tensor:
    """``jax.ops.segment_sum`` (ids outside ``[0, num_segments)`` dropped;
    with ``wrap`` a negative id first counts from the end, the rule of a
    ``jnp.take`` gather's backward; ``segment_ids`` of any shape, one id a
    row of ``data``), in one fixed order on either device: the sorted sum
    for floating data on ``SORTED_SUM_DEVICES`` (the card, and meta
    tensors, so that the dry run counts the card's path), ``index_add_``,
    a serial loop, elsewhere."""
    if (data.device.type in SORTED_SUM_DEVICES
            and data.dtype.is_floating_point):
        return _SortedSegmentSum.apply(
            data, segment_plan(segment_ids, num_segments, wrap=wrap),
            num_segments)
    ids = segment_ids.reshape(-1).long()
    if wrap:
        ids = torch.where(ids < 0, ids + num_segments, ids)
    keep = (ids >= 0) & (ids < num_segments)
    vals = torch.where(_rows(keep, data), data, 0)
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add(0, torch.where(keep, ids, 0), vals)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    s = segment_sum(data, segment_ids, num_segments)
    cnt = segment_sum(torch.ones(data.shape[0], dtype=torch.float32,
                                 device=data.device),
                      segment_ids, num_segments)
    return s / _rows(cnt.clamp_min(1.0), s)


def _segment_reduce(data: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, reduce: str,
                    identity: float) -> torch.Tensor:
    ids, keep = _kept(segment_ids, num_segments)
    vals = torch.where(_rows(keep, data), data, identity)
    out = torch.full((num_segments,) + tuple(data.shape[1:]), identity,
                     dtype=data.dtype, device=data.device)
    return out.scatter_reduce(0, _rows(ids, data).expand(data.shape), vals,
                              reduce, include_self=True)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    return _segment_reduce(data, segment_ids, num_segments, "amax",
                           _lowest(data.dtype))


def _segment_min(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_min`` for integer data (an empty segment holds the
    dtype's maximum)."""
    return _segment_reduce(data, segment_ids, num_segments, "amin",
                           torch.iinfo(data.dtype).max)


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Numerically-stable softmax within each segment (edge-softmax)."""
    from repro_torch.sparse.embedding_bag import embedding_lookup

    seg_max = segment_max(scores, segment_ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    num = torch.exp(scores - embedding_lookup(seg_max, segment_ids))
    den = segment_sum(num, segment_ids, num_segments)
    return num / torch.clamp_min(embedding_lookup(den, segment_ids), 1e-30)


def segment_max_with_argmax(
    data: torch.Tensor,            # (N,) or (N, D)
    segment_ids: torch.Tensor,     # (N,)
    num_segments: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Max and the index of the first max per segment (int32): the Sparton
    reduction pattern, where gradients route to one element."""
    from repro_torch.sparse.embedding_bag import embedding_lookup

    n = data.shape[0]
    m = segment_max(data, segment_ids, num_segments)
    hit = data >= embedding_lookup(m, segment_ids)
    pos = _rows(torch.arange(n, dtype=torch.int32, device=data.device), data)
    idx = torch.where(hit, pos, n).to(torch.int32)
    return m, _segment_min(idx, segment_ids, num_segments)


def gather_scatter(
    node_feats: torch.Tensor,      # (N, D)
    edge_src: torch.Tensor,        # (E,)
    edge_dst: torch.Tensor,        # (E,)
    num_nodes: int,
    *,
    reduce: str = "sum",
) -> torch.Tensor:
    """One hop of message passing: out[i] = reduce_{j->i} feats[j]."""
    from repro_torch.sparse.embedding_bag import embedding_lookup

    reducers = {"sum": segment_sum, "mean": segment_mean, "max": segment_max}
    if reduce not in reducers:
        raise ValueError(f"unknown reduce {reduce!r}")
    return reducers[reduce](embedding_lookup(node_feats, edge_src), edge_dst,
                            num_nodes)
