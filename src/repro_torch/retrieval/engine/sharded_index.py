"""Doc-sharded inverted index over a mesh
(``repro/retrieval/engine/sharded_index.py``).

Sharding the documents keeps every shard a whole inverted index over a
contiguous doc range: each rank scores its range with the unsharded
impact scorer, then the per-shard winners are merged by an
``all_gather`` and a second top-k. The corpus grows with the rank count,
and no rank holds the ``(B, N)`` scores.

Layout: the per-shard CSC arrays stacked on a leading shard axis, padded
to the widest shard::

    term_starts  (S, V) i32      postings_doc (S, Pmax) i32 (local ids)
    term_lens    (S, V) i32      postings_val (S, Pmax) f32
    shard_counts (S,)   i32      — real docs per shard

Shard ``s`` holds docs ``[s * docs_per_shard, ...)`` in their order, so a
global id is ``s * docs_per_shard + local id``; each shard's top-k and
every merge are stable (``kernels.topk_score.topk_rows``) and the shards
are gathered in ascending order, so ties go to the lowest id as in the
unsharded scorer. A doc's score sums the same terms in the same order
as the unsharded ``impact`` method (one ``index_add_`` a query term), so
it is the same bits.

Two paths with one result:

* ``mesh`` given (a ``launch.mesh.Mesh``): each rank scores the shard at
  its index along the shard axis (``shard_mapped``) and the winners are
  merged with ``collectives.all_gather``. ``n_shards`` must equal the
  axis size.
* ``mesh=None``: every shard scored in one process, padded docs at
  ``NEG_INF``, and one top-k over the flattened ``(S * dps)`` row.

Every rank of a mesh holds the whole stacked index (as ``shard_map``'s
caller holds the global arrays), so the gathered tensors have one shape
on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import collectives
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels._common import NEG_INF
from repro_torch.kernels.impact_score import (ceiling_windows, index_windows,
                                              scatter_scores)
from repro_torch.kernels.topk_score import topk_rows
from repro_torch.launch.mesh import axis_index
from repro_torch.retrieval.index import build_inverted_index
from repro_torch.retrieval.sparse_rep import (SparseRep, device_get,
                                              query_columns)

# ---------------------------------------------------------------------------
# shared mesh plumbing (the doc-, term- and 2D-sharded paths)
# ---------------------------------------------------------------------------


def resolve_mesh_axes(mesh, axis_names, sizes: Tuple[int, ...],
                      what: str = "sharded_retrieve") -> Tuple[str, ...]:
    """The mesh axes the logical shard dims map onto, one shard a rank
    along each, so each axis size must equal its shard count.
    ``axis_names=None`` takes the mesh's leading axes in order."""
    if axis_names is None:
        if len(mesh.axis_names) < len(sizes):
            raise ValueError(
                f"{what}: mesh has {len(mesh.axis_names)} axes "
                f"{tuple(mesh.axis_names)}, needs {len(sizes)}")
        axis_names = tuple(mesh.axis_names[:len(sizes)])
    else:
        axis_names = tuple(axis_names)
        if len(axis_names) != len(sizes):
            raise ValueError(
                f"{what}: {len(axis_names)} axis names for "
                f"{len(sizes)} shard dims")
    for name, n_shards in zip(axis_names, sizes):
        n_dev = mesh.shape[name]
        if n_dev != n_shards:
            raise ValueError(
                f"{what}: n_shards={n_shards} must equal "
                f"mesh axis {name!r} size {n_dev}")
    return axis_names


def resolve_shard_axis(mesh, axis_name: Optional[str], n_shards: int,
                       what: str = "sharded_retrieve") -> str:
    """The 1D case of ``resolve_mesh_axes``: the one mesh axis the shard
    dimension maps onto."""
    names = None if axis_name is None else (axis_name,)
    return resolve_mesh_axes(mesh, names, (n_shards,), what)[0]


def shard_mapped(body, mesh, axis_name: Optional[str], n_in: int,
                 in_specs: Optional[Sequence[Tuple[str, ...]]] = None):
    """``body`` run on this rank's blocks of its ``n_in`` stacked inputs,
    as ``shard_map`` runs it: each input's leading dims are split one
    block a rank along the mesh axes of its spec (``(axis_name,)`` by
    default; the 2D grid passes ``(doc_axis, term_axis)`` for its grid
    arrays), keeping a leading dim of 1 each, and are whole over the other
    axes. The body's outputs must be the same on every rank (a merge
    through ``collectives``), as ``shard_map``'s ``P()`` outputs are."""
    if in_specs is None:
        in_specs = tuple((axis_name,) for _ in range(n_in))
    else:
        in_specs = tuple(tuple(spec) for spec in in_specs)
        if len(in_specs) != n_in:
            raise ValueError(
                f"shard_mapped: {len(in_specs)} in_specs for {n_in} inputs")

    def run(*arrays):
        if len(arrays) != n_in:
            raise ValueError(f"shard_mapped: {len(arrays)} inputs, "
                             f"expected {n_in}")
        blocks = []
        for a, spec in zip(arrays, in_specs):
            for dim, ax in enumerate(spec):
                if a.shape[dim] != mesh.shape[ax]:
                    raise ValueError(
                        f"shard_mapped: dim {dim} of {tuple(a.shape)} does "
                        f"not split one block a rank over mesh axis "
                        f"{ax!r} of size {mesh.shape[ax]}")
                a = a.narrow(dim, axis_index(mesh, ax), 1)
            blocks.append(a)
        return body(*blocks)

    return run


def stack_field(parts, name: str, dtype, device, lead=None) -> torch.Tensor:
    """The ``name`` arrays of the per-shard (CPU) indexes ``parts``, each
    zero-padded to the widest and stacked: ``lead + (widest,)`` on
    ``device`` (``lead`` defaults to ``(len(parts),)``)."""
    width = max(getattr(p, name).shape[0] for p in parts)
    out = np.zeros((len(parts), width), dtype)
    for s, p in enumerate(parts):
        row = getattr(p, name).numpy()
        out[s, :row.shape[0]] = row
    return put(out.reshape(*(lead or (len(parts),)), width), device)


def host_rows(reps: SparseRep) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A batched rep's ``(N, K)`` values, ids and ``(N,)`` nnz as numpy."""
    host = device_get(reps)
    k = host.width
    return (np.asarray(host.values, np.float32).reshape(-1, k),
            np.asarray(host.indices, np.int32).reshape(-1, k),
            np.asarray(host.nnz, np.int32).reshape(-1))


def put(a, device, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)


def nbytes(*tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors
                   if t is not None))


# ---------------------------------------------------------------------------
# the doc-sharded index
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedIndex:
    term_starts: torch.Tensor     # (S, V) i32
    term_lens: torch.Tensor       # (S, V) i32
    postings_doc: torch.Tensor    # (S, Pmax) i32 — local doc ids
    postings_val: torch.Tensor    # (S, Pmax) f32
    shard_counts: torch.Tensor    # (S,) i32 — real docs per shard
    n_shards: int
    docs_per_shard: int           # the uniform shard stride
    n_docs: int                   # real docs in all
    vocab_size: int
    max_postings: int             # the longest list over all shards

    @property
    def device(self) -> torch.device:
        return self.postings_doc.device

    def memory_bytes(self) -> int:
        return nbytes(self.term_starts, self.term_lens, self.postings_doc,
                      self.postings_val, self.shard_counts)

    def stats(self) -> Dict[str, float]:
        return {
            "n_shards": self.n_shards,
            "docs_per_shard": self.docs_per_shard,
            "n_docs": self.n_docs,
            "vocab_size": self.vocab_size,
            "max_postings": self.max_postings,
            "memory_bytes": self.memory_bytes(),
        }


def shard_index(reps: SparseRep, vocab_size: int, n_shards: int, *,
                device: DeviceLike = None) -> ShardedIndex:
    """Per-shard indexes over contiguous doc chunks (host numpy, then moved
    to ``device``, ``cuda`` unless given).

    The docs are split into ``n_shards`` ranges of ``ceil(N / n_shards)``;
    each range is indexed alone with local doc ids, and the CSC arrays
    are padded to the widest shard.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    dev = resolve_device(device)
    v, i, n = host_rows(reps)
    n_docs = v.shape[0]
    if n_shards > n_docs:
        raise ValueError(
            f"n_shards={n_shards} exceeds corpus size {n_docs}")
    dps = -(-n_docs // n_shards)

    parts = []
    for s in range(n_shards):
        lo, hi = s * dps, min((s + 1) * dps, n_docs)
        parts.append(build_inverted_index(
            SparseRep(v[lo:hi], i[lo:hi], n[lo:hi]), vocab_size,
            with_upper_bounds=False, stopword_warn_frac=1.1, device="cpu"))

    counts = [min((s + 1) * dps, n_docs) - s * dps for s in range(n_shards)]
    return ShardedIndex(
        term_starts=stack_field(parts, "term_starts", np.int32, dev),
        term_lens=stack_field(parts, "term_lens", np.int32, dev),
        postings_doc=stack_field(parts, "postings_doc", np.int32, dev),
        postings_val=stack_field(parts, "postings_val", np.float32, dev),
        shard_counts=put(np.asarray(counts, np.int32), dev),
        n_shards=n_shards, docs_per_shard=dps, n_docs=n_docs,
        vocab_size=vocab_size,
        max_postings=max(p.max_postings for p in parts))


def cell_scores(qi: torch.Tensor, qv: torch.Tensor, starts, lens, pdoc,
                weights, n_docs: int, max_postings: int) -> torch.Tensor:
    """``(B, n_docs)`` impact scores of one stacked cell (one shard's CSC
    arrays), summed one query term at a time as the unsharded scorer
    sums them (``score.impact_scores``)."""
    w, docs = index_windows(qi, qv, starts, lens, pdoc, weights,
                            max_postings)
    return scatter_scores(w, docs, n_docs, max_postings)


def mask_padding(scores: torch.Tensor, count) -> torch.Tensor:
    """``NEG_INF`` on the columns at or past ``count`` (a shard's padding)."""
    ids = torch.arange(scores.shape[1], device=scores.device)
    return torch.where(ids[None, :] < count, scores, NEG_INF)


def _local_scores(qi, qv, st, ln, pd, pv, count, index: ShardedIndex):
    """``(B, docs_per_shard)`` exact scores of one shard, its padded docs
    (local id >= count) at ``NEG_INF``."""
    scores = cell_scores(qi, qv, st, ln, pd, pv, index.docs_per_shard,
                         index.max_postings)
    return mask_padding(scores, count)


def merge_gathered(lv: torch.Tensor, li: torch.Tensor, axes, mesh, k: int):
    """Every rank's ``(B, k')`` winners along ``axes``, gathered in rank
    order along dim 1 (ids as int64 through the backend), and their
    stable top-k: ``(vals f32, ids i32)``, the same on every rank."""
    all_v = collectives.all_gather(lv.contiguous(), axes, mesh, dim=1)
    all_i = collectives.all_gather(li.long().contiguous(), axes, mesh, dim=1)
    mv, pos = topk_rows(all_v, k)
    return mv, torch.gather(all_i, 1, pos.long()).int()


def sharded_retrieve(queries: SparseRep, index: ShardedIndex, k: int = 10,
                     *, mesh=None, axis_name: Optional[str] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the sharded index; ids are global doc ids.

    With ``mesh`` the shard axis is ``axis_name`` (default: the mesh's
    first axis), one shard a rank; without, every shard is scored in this
    process. Both give the same result, on the index's device.
    """
    k = min(k, index.n_docs)
    dps = index.docs_per_shard
    qi, qv = query_columns(queries, index.device)

    if mesh is None:
        scores = [_local_scores(qi, qv, index.term_starts[s],
                                index.term_lens[s], index.postings_doc[s],
                                index.postings_val[s],
                                index.shard_counts[s], index)
                  for s in range(index.n_shards)]
        # contiguous chunks: the flattened (S * dps) position IS the id
        return topk_rows(torch.cat(scores, dim=1), k)

    axis_name = resolve_shard_axis(mesh, axis_name, index.n_shards)
    kk = min(k, dps)

    def body(st, ln, pd, pv, ct):
        scores = _local_scores(qi, qv, st[0], ln[0], pd[0], pv[0], ct[0],
                               index)                      # (B, dps)
        lv, li = topk_rows(scores, kk)
        li = li + axis_index(mesh, axis_name) * dps        # global ids
        return merge_gathered(lv, li, axis_name, mesh, k)

    merged = shard_mapped(body, mesh, axis_name, n_in=5)
    return merged(index.term_starts, index.term_lens, index.postings_doc,
                  index.postings_val, index.shard_counts)


# ---------------------------------------------------------------------------
# vocab-range partials (the term-sharded and 2D paths)
# ---------------------------------------------------------------------------

def route(qi: torch.Tensor, qv: torch.Tensor, lo, hi, local_vocab: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The query's terms masked to one vocab range ``[lo, hi)`` and
    remapped to local ids; every other slot carries value 0 and adds
    exactly 0 to the partials (``term_sharded._route`` too)."""
    in_range = (qi >= lo) & (qi < hi)
    lqv = torch.where(in_range, qv, 0.0)
    lqi = (qi - lo).clamp(0, local_vocab - 1).int()
    return lqi, lqv


def partial_scores(qi, qv, st, ln, pd, pv, lo, hi, n_docs: int,
                   local_vocab: int, max_postings: int) -> torch.Tensor:
    """``(B, n_docs)`` partial scores of one cell: the contribution of its
    vocab range to its docs."""
    lqi, lqv = route(qi, qv, lo, hi, local_vocab)
    return cell_scores(lqi, lqv, st, ln, pd, pv, n_docs, max_postings)


def partial_ub_scores(qi, qv, st, ln, pd, ubs, lo, hi, n_docs: int,
                      local_vocab: int, max_postings: int) -> torch.Tensor:
    """``(B, n_docs)`` partial MaxScore ceilings of one cell, from its own
    upper bounds (reading ``postings_doc`` only, as the unsharded tier 1
    does: ``pruning.upper_bound_scores``)."""
    lqi, lqv = route(qi, qv, lo, hi, local_vocab)
    w, docs = ceiling_windows(lqi, lqv, st, ln, pd, ubs, max_postings)
    return scatter_scores(w, docs, n_docs, max_postings)


def sum_in_order(parts) -> torch.Tensor:
    """``((p0 + p1) + p2) + ...``: the partial sums in shard order."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def two_tier_args(index, k: int, prune_margin: Optional[float],
                  candidates: Optional[int], what: str):
    """The pruned composition's checks and its candidate budget: ``None``
    without a margin, else ``candidates`` (default ``max(4k, 64)``: the
    skew doubling of ``pruning.default_candidates`` needs posting-length
    percentiles, which the stacked shards do not keep) clamped to ``[k,
    n_docs]``."""
    if prune_margin is None:
        return None
    if not index.has_forward:
        builder = ("shard2d_index" if what == "shard2d_retrieve"
                   else "term_shard_index")
        raise ValueError(
            f"{what}: pruning needs forward rows — build with "
            f"{builder}(..., keep_forward=True)")
    if not 0.0 <= prune_margin <= 1.0:
        raise ValueError(f"prune_margin must be in [0, 1], got "
                         f"{prune_margin}")
    if candidates is None:
        candidates = max(4 * k, 64)
    return min(max(candidates, k), index.n_docs)
