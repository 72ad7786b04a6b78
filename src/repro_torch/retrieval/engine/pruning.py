"""Two-tier MaxScore-style pruned retrieval (``repro/retrieval/engine/
pruning.py``).

The exact impact scorer reads every posting of every live query term.
Each term's ceiling ``ub[t]`` (its largest impact, the index's
``term_ubs``) bounds what any doc can take from it, so most docs need no
exact score:

* **Tier 1 (ceilings).** Each doc's upper bound is the sum of the
  ceilings ``c[t] = q[t] * ub[t]`` of the live query terms whose list holds
  it. Impacts are non-negative, so it is at least the doc's exact score.
  Only ``postings_doc`` is read, never ``postings_val``. On the card this
  pass is K4's ceiling entry (``kernels/impact_score.
  fused_ceiling_index_topk``): it keeps the ``C + 1`` best ceilings and
  their ids, and the ``(B, n_docs)`` ceilings never reach device memory.
  On the CPU the entry runs its plain version; ``upper_bound_scores`` is
  the dense ceilings, the reference's own tier 1.
* **Tier 2 (rescoring).** The ``C`` best docs by ceiling are scored
  exactly from the index's forward rows (``doc_values`` / ``doc_indices``):
  the query scattered into a dense ``(V,)`` vector, then one gather and
  one sum over K a candidate. At most ``B * C * K`` products: plain
  PyTorch on the device, as the JAX package leaves it to XLA.

A true top-k doc can be missed only if its ceiling fell below the
candidates' cut. So each query row also reports whether the pruning was
provably exact: every excluded doc's ceiling is at most the exact k-th
best score. ``prune_margin`` trades that guarantee for fewer rescored
candidates: those whose ceiling cannot reach ``prune_margin`` times the
k-th best ceiling are dropped (0 keeps all, 1 only the docs whose ceiling
reaches the k-th best ceiling).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._common import NEG_INF
from repro_torch.kernels.impact_score import (ceiling_windows,
                                              fused_ceiling_index_topk,
                                              scatter_scores, term_rows)
from repro_torch.kernels.topk_score import topk_rows
from repro_torch.retrieval.index import InvertedIndex
from repro_torch.retrieval.sparse_rep import SparseRep, query_columns


def default_candidates(index: InvertedIndex, k: int) -> int:
    """Candidate budget of tier 2: ``max(4k, 64)``, doubled when the
    posting-length percentiles show stopword-like skew (p99 >= 8 * p50:
    the skewed terms' ceilings are loose), clamped to ``[k, n_docs]``."""
    base = max(4 * k, 64)
    pct = index.posting_percentiles
    if len(pct) == 4 and pct[0] > 0 and pct[2] >= 8 * pct[0]:
        base *= 2
    return min(max(base, k), index.n_docs)


def _require_upper_bounds(index: InvertedIndex, who: str) -> None:
    if index.term_ubs is None:
        raise ValueError(
            f"{who}: the index carries no per-term upper bounds (term_ubs) "
            "— rebuild with build_inverted_index(..., "
            "with_upper_bounds=True)")


def upper_bound_scores(queries: SparseRep, index: InvertedIndex
                       ) -> torch.Tensor:
    """Tier-1 ceilings as a dense ``(B, n_docs)`` f32 tensor: the same
    windows as ``score.impact_scores`` with each lane weighing its term's
    ceiling, summed one term at a time (the ceiling entry's order). The
    reference's tier 1; the pruned path itself keeps only the top
    ``C + 1`` (``ceiling_topk``)."""
    _require_upper_bounds(index, "upper_bound_scores")
    qi, qv = query_columns(queries, index.device)
    w, docs = ceiling_windows(qi, qv, index.term_starts, index.term_lens,
                              index.postings_doc, index.term_ubs,
                              index.max_postings)
    return scatter_scores(w, docs, index.n_docs, index.max_postings)


def ceiling_topk(queries: SparseRep, index: InvertedIndex, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` best tier-1 ceilings of each query row and their doc ids,
    ties to the lowest id: ``lax.top_k(upper_bound_scores(...), k)``. K4's
    ceiling entry on the card, its plain version on the CPU."""
    _require_upper_bounds(index, "ceiling_topk")
    qi, qv = query_columns(queries, index.device)
    return fused_ceiling_index_topk(
        qi, qv, index.term_starts, index.term_lens, index.postings_doc,
        index.term_ubs, n_docs=index.n_docs, k=k)


def query_dense(queries: SparseRep, vocab_size: int, device
                ) -> torch.Tensor:
    """``(B, V)`` f32: each row's live weights (``> 0``) added at their ids,
    as the reference's ``zeros(V).at[qi].add(...)`` scatters them: a
    negative id counts from the end, and an id still outside ``[0, V)``
    is dropped."""
    qi, qv = query_columns(queries, device)
    qi = qi.long()
    qi = torch.where(qi < 0, qi + vocab_size, qi)
    ok = (qi >= 0) & (qi < vocab_size) & (qv > 0)
    dense = torch.zeros((qi.shape[0], vocab_size + 1), dtype=torch.float32,
                        device=device)
    dense.scatter_add_(1, torch.where(ok, qi, vocab_size),
                       torch.where(ok, qv, 0.0))
    return dense[:, :vocab_size]


def select_and_rescore(ub_top: torch.Tensor, cand: torch.Tensor,
                       queries: SparseRep, doc_values: torch.Tensor,
                       doc_indices: torch.Tensor, vocab_size: int,
                       n_docs: int, k: int, candidates: int,
                       prune_margin: float
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tier 2 from tier 1's best ceilings ``ub_top`` / ``cand`` (``(B,
    min(candidates + 1, n_docs))``, value descending): the margin mask,
    the exact rescoring of the kept candidates from the forward rows, and
    the top-k. The reference's ``select_and_rescore`` after its
    ``lax.top_k`` of the dense ceilings. Returns ``(vals (B, k), idx (B,
    k) i32, exact_frontier (B,) bool)``."""
    B = ub_top.shape[0]
    dev = ub_top.device
    if ub_top.shape[1] > candidates:
        # the (C+1)-th best ceiling is the best excluded doc's
        excluded = ub_top[:, -1]
        ub_top, cand = ub_top[:, :candidates], cand[:, :candidates]
    else:
        excluded = torch.full((B,), NEG_INF, dtype=torch.float32,
                              device=dev)
    # drop candidates whose ceiling cannot reach margin * (k-th ceiling)
    theta = ub_top[:, min(k, candidates) - 1]
    margin = torch.tensor(prune_margin, dtype=torch.float32, device=dev)
    keep = ub_top >= margin * theta[:, None]
    excluded = torch.maximum(
        excluded, torch.where(keep, NEG_INF, ub_top).max(dim=1).values)

    # candidates in doc-id order, so that score ties go to the lowest id
    cand_sort = torch.sort(torch.where(keep, cand, n_docs), dim=1).values
    keep = cand_sort < n_docs
    cand_safe = cand_sort.clamp(0, n_docs - 1).long()

    q = query_dense(queries, vocab_size, dev)                # (B, V)
    cols = term_rows(doc_indices[cand_safe], vocab_size)     # (B, C, K)
    dv = doc_values[cand_safe]
    exact = (torch.gather(q, 1, cols.view(B, -1)).view(dv.shape)
             * dv).sum(dim=2)
    exact = torch.where(keep, exact, NEG_INF)
    # at least k candidates survive the mask (the top-k ceilings reach
    # margin * theta for margin <= 1), so every slot holds a survivor
    vals, pos = topk_rows(exact, k)
    idx = torch.gather(cand_safe, 1, pos.long()).int()
    frontier = excluded <= vals[:, min(k, vals.shape[1]) - 1]
    return vals, idx, frontier


def select_and_rescore_dense(ub: torch.Tensor, queries: SparseRep,
                             doc_values: torch.Tensor,
                             doc_indices: torch.Tensor, vocab_size: int,
                             k: int, candidates: int, prune_margin: float
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Tier 2 from dense ``(B, n_docs)`` ceilings ``ub``, the reference's
    ``select_and_rescore(ub, ...)``: the stable top ``C + 1`` of ``ub``
    (``topk_rows``, ties to the lowest id), then ``select_and_rescore``.
    The term-sharded and 2D engines' pruned compositions, whose ceilings
    are sums of per-shard partials, go through it; the single index's
    pruned path keeps K4's ceiling entry. Returns ``(vals, idx,
    exact_frontier)``."""
    n_docs = ub.shape[1]
    ub_top, cand = topk_rows(ub, min(candidates + 1, n_docs))
    return select_and_rescore(ub_top, cand, queries, doc_values,
                              doc_indices, vocab_size, n_docs, k,
                              candidates, prune_margin)


def pruned_retrieve(queries: SparseRep, index: InvertedIndex, k: int = 10,
                    *, prune_margin: float = 0.0,
                    candidates: Optional[int] = None,
                    with_diagnostics: bool = False):
    """Two-tier pruned top-k (see the module docstring).

    Returns ``(vals (B, k), idx (B, k))`` on the index's device, with
    ``with_diagnostics=True`` also the ``(B,)`` bool of provable
    exactness (every excluded doc's ceiling <= the exact k-th best
    score). ``candidates`` defaults to ``default_candidates`` and is
    clamped to ``[k, n_docs]``.
    """
    _require_upper_bounds(index, "pruned_retrieve")
    if not index.has_forward:
        raise ValueError(
            "pruned_retrieve: the index carries no forward rows for "
            "rescoring — rebuild with keep_forward=True")
    if not 0.0 <= prune_margin <= 1.0:
        raise ValueError(f"prune_margin must be in [0, 1], got "
                         f"{prune_margin}")
    k = min(k, index.n_docs)
    if candidates is None:
        candidates = default_candidates(index, k)
    candidates = min(max(candidates, k), index.n_docs)
    ub_top, cand = ceiling_topk(queries, index,
                                min(candidates + 1, index.n_docs))
    vals, idx, frontier = select_and_rescore(
        ub_top, cand, queries, index.doc_values, index.doc_indices,
        index.vocab_size, index.n_docs, k, candidates, prune_margin)
    if with_diagnostics:
        return vals, idx, frontier
    return vals, idx
