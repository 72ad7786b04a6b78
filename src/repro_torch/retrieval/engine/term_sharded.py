"""Term-partitioned (vocab-sharded) inverted index
(``repro/retrieval/engine/term_sharded.py``).

The doc-sharded index (``sharded_index``) splits documents; every shard
still holds the whole ``O(V)`` term directory and the lists of every term
its docs use. At the paper's multilingual |V| of 250002 the pressure runs
the other way: a few high-DF lists outgrow one device whatever the doc
count, and the replicated directory stops being small. So shard ``s``
owns the complete posting lists of the terms ``[lo_s, hi_s)`` and nothing
else.

That changes the merge. A document's score is spread over every shard its
terms land on, so each shard gives **partial sums** over the whole doc
space, which are added (``collectives.psum`` under a mesh, a sum in
shard order in one process) before one global top-k. A per-shard top-k
would rank by partial scores.

Layout (stacked on a leading shard axis, padded to the widest shard)::

    term_starts (S, Vloc) i32     postings_doc (S, Pmax) i32 (GLOBAL ids)
    term_lens   (S, Vloc) i32     postings_val (S, Pmax) f32
    term_ubs    (S, Vloc) f32     shard_lo / shard_hi (S,) i32

``Vloc = max(hi_s - lo_s)``; term ids are local to the shard (``t -
lo_s``, ``build_inverted_index(vocab_range=)``). Queries are routed: each
shard keeps the query's terms of its range (value 0 elsewhere, which adds
exactly 0).

A term-sharded score is a sum of partials, so against the unsharded
``impact`` method it can move in the last bits, and ids at near ties. A
psum of two partials is ``a + b`` on every rank, so on a 2-way axis the
mesh path and the one-process path give the same bits; on a wider axis
the backend's reduction order is its own.

Pruning composes per shard: tier 1 sums each shard's ceiling partials
(from its own upper bounds) into the global bound, tier 2 rescores the
surviving candidates exactly from forward rows stored once on the index
(they carry global term ids, so they are not split).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import collectives
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.topk_score import topk_rows
# placement is the ShardPlan planner's (``shard2d``); choose_shard_axis
# stays importable here as the reference's deprecated string shim
from repro_torch.retrieval.engine.shard2d import (  # noqa: F401
    DIR_BYTES_PER_TERM, _validate_boundaries, choose_shard_axis,
    mass_balanced_boundaries)
from repro_torch.retrieval.engine.sharded_index import (
    host_rows, nbytes, partial_scores, partial_ub_scores, put,
    resolve_shard_axis, shard_mapped, stack_field, sum_in_order,
    two_tier_args)
from repro_torch.retrieval.index import build_inverted_index
from repro_torch.retrieval.sparse_rep import SparseRep, query_columns


@dataclasses.dataclass(frozen=True)
class TermShardedIndex:
    term_starts: torch.Tensor     # (S, Vloc) i32 — local term offsets
    term_lens: torch.Tensor       # (S, Vloc) i32
    postings_doc: torch.Tensor    # (S, Pmax) i32 — GLOBAL doc ids
    postings_val: torch.Tensor    # (S, Pmax) f32
    term_ubs: torch.Tensor        # (S, Vloc) f32 — per-shard upper bounds
    shard_lo: torch.Tensor        # (S,) i32 — vocab range starts
    shard_hi: torch.Tensor        # (S,) i32 — vocab range ends (exclusive)
    n_shards: int
    n_docs: int                   # every shard scores all docs
    vocab_size: int               # global V
    local_vocab: int              # padded per-shard vocab width
    max_postings: int             # the longest list over all shards
    boundaries: Tuple[int, ...] = ()               # the vocab cuts
    doc_values: Optional[torch.Tensor] = None      # (N, K) f32 forward
    doc_indices: Optional[torch.Tensor] = None     # (N, K) i32, once

    @property
    def device(self) -> torch.device:
        return self.postings_doc.device

    @property
    def has_forward(self) -> bool:
        return self.doc_values is not None and self.doc_indices is not None

    def memory_bytes(self) -> int:
        return nbytes(self.term_starts, self.term_lens, self.postings_doc,
                      self.postings_val, self.term_ubs, self.shard_lo,
                      self.shard_hi, self.doc_values, self.doc_indices)

    def stats(self) -> Dict[str, float]:
        return {
            "n_shards": self.n_shards,
            "n_docs": self.n_docs,
            "vocab_size": self.vocab_size,
            "local_vocab": self.local_vocab,
            "max_postings": self.max_postings,
            "memory_bytes": self.memory_bytes(),
        }


def term_shard_index(reps: SparseRep, vocab_size: int, n_shards: int, *,
                     boundaries: Optional[Sequence[int]] = None,
                     balance: str = "mass", keep_forward: bool = False,
                     device: DeviceLike = None) -> TermShardedIndex:
    """Per-shard indexes over contiguous vocab ranges (host numpy, then
    moved to ``device``, ``cuda`` unless given).

    The vocabulary is cut at ``boundaries``; by default the cuts balance
    the cumulative posting mass (``balance="mass"``,
    ``shard2d.mass_balanced_boundaries``), so one stopword-heavy range
    cannot pad every shard's posting array to its length;
    ``balance="width"`` cuts even ``V / n_shards`` ranges. Each range is
    indexed alone (``build_inverted_index(vocab_range=...)``: local term
    ids, global doc ids) and padded to the widest shard; a range with no
    active term packs the usual one zero posting. ``keep_forward=True``
    stores the ``(N, K)`` forward rows once, for the pruned path.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if n_shards > vocab_size:
        raise ValueError(
            f"n_shards={n_shards} exceeds vocab size {vocab_size}")
    if balance not in ("mass", "width"):
        raise ValueError(
            f"balance must be 'mass' or 'width', got {balance!r}")
    dev = resolve_device(device)
    v, i, n = host_rows(reps)
    rep = SparseRep(v, i, n)

    if boundaries is None:
        if balance == "mass":
            counts = np.bincount(i[v > 0].ravel(), minlength=vocab_size)
            boundaries = mass_balanced_boundaries(counts, n_shards)
        else:
            boundaries = [s * vocab_size // n_shards
                          for s in range(n_shards + 1)]
    boundaries = _validate_boundaries(boundaries, n_shards, vocab_size,
                                      "boundaries")

    parts = [build_inverted_index(rep, vocab_size, vocab_range=(lo, hi),
                                  stopword_warn_frac=1.1, device="cpu")
             for lo, hi in zip(boundaries, boundaries[1:])]

    def stack(name, dtype):
        return stack_field(parts, name, dtype, dev)

    return TermShardedIndex(
        term_starts=stack("term_starts", np.int32),
        term_lens=stack("term_lens", np.int32),
        postings_doc=stack("postings_doc", np.int32),
        postings_val=stack("postings_val", np.float32),
        term_ubs=stack("term_ubs", np.float32),
        shard_lo=put(np.asarray(boundaries[:-1], np.int32), dev),
        shard_hi=put(np.asarray(boundaries[1:], np.int32), dev),
        n_shards=n_shards, n_docs=v.shape[0], vocab_size=vocab_size,
        local_vocab=max(p.vocab_size for p in parts),
        max_postings=max(p.max_postings for p in parts),
        boundaries=tuple(boundaries),
        doc_values=put(v, dev) if keep_forward else None,
        doc_indices=put(i, dev) if keep_forward else None)


def _partial_scores(qi, qv, st, ln, pd, pv, lo, hi,
                    index: TermShardedIndex) -> torch.Tensor:
    """``(B, n_docs)`` partial scores of one shard: its vocab range's
    contribution to every document's total."""
    return partial_scores(qi, qv, st, ln, pd, pv, lo, hi, index.n_docs,
                          index.local_vocab, index.max_postings)


def _partial_ub_scores(qi, qv, st, ln, pd, ubs, lo, hi,
                       index: TermShardedIndex) -> torch.Tensor:
    """``(B, n_docs)`` partial ceilings of one shard, from its own upper
    bounds."""
    return partial_ub_scores(qi, qv, st, ln, pd, ubs, lo, hi, index.n_docs,
                             index.local_vocab, index.max_postings)


def _partials(qi, qv, index: TermShardedIndex, ceilings: bool):
    """Every shard's partials in one process, in shard order."""
    return [(_partial_ub_scores(qi, qv, index.term_starts[s],
                                index.term_lens[s], index.postings_doc[s],
                                index.term_ubs[s], index.shard_lo[s],
                                index.shard_hi[s], index)
             if ceilings else
             _partial_scores(qi, qv, index.term_starts[s],
                             index.term_lens[s], index.postings_doc[s],
                             index.postings_val[s], index.shard_lo[s],
                             index.shard_hi[s], index))
            for s in range(index.n_shards)]


def term_sharded_retrieve(queries: SparseRep, index: TermShardedIndex,
                          k: int = 10, *, mesh=None,
                          axis_name: Optional[str] = None,
                          prune_margin: Optional[float] = None,
                          candidates: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the term-sharded index; ids are global doc ids.

    Exact by default: the per-shard partial impact sums are added (a
    ``psum`` over ``axis_name`` under a mesh, default its first axis; in
    shard order in one process), then one global top-k. With
    ``prune_margin`` the two-tier composition runs instead: the shards'
    ceiling partials are summed into the global bound and the surviving
    candidates rescored exactly from the forward rows (``keep_forward=True``
    at build).
    """
    from repro_torch.retrieval.engine.pruning import select_and_rescore_dense

    k = min(k, index.n_docs)
    qi, qv = query_columns(queries, index.device)
    cands = two_tier_args(index, k, prune_margin, candidates,
                          "term_sharded_retrieve")

    def finish(total, ceilings):
        if not ceilings:
            return topk_rows(total, k)
        vals, idx, _ = select_and_rescore_dense(
            total, queries, index.doc_values, index.doc_indices,
            index.vocab_size, k, cands, prune_margin)
        return vals, idx

    prune = cands is not None
    if mesh is None:
        return finish(sum_in_order(_partials(qi, qv, index, prune)), prune)

    axis_name = resolve_shard_axis(mesh, axis_name, index.n_shards,
                                   what="term_sharded_retrieve")

    def body(st, ln, pd, w, lo, hi):
        fn = _partial_ub_scores if prune else _partial_scores
        partial = fn(qi, qv, st[0], ln[0], pd[0], w[0], lo[0], hi[0], index)
        return finish(collectives.psum(partial, axis_name, mesh), prune)

    merged = shard_mapped(body, mesh, axis_name, n_in=6)
    return merged(index.term_starts, index.term_lens, index.postings_doc,
                  index.term_ubs if prune else index.postings_val,
                  index.shard_lo, index.shard_hi)
