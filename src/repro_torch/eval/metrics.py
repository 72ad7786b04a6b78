"""Ranking-quality metrics over retrieved-id arrays
(``repro/eval/metrics.py``).

Everything upstream of this module speaks *ids*: ``retrieve()`` /
``IndexBuilder.search`` return ``(vals (B, K), ids (B, K))`` with
``-1`` marking below-top-k padding. This module turns those arrays
plus graded relevance judgments into MRR@k / nDCG@k / recall@k /
success@k.

Two implementations of every metric:

* a **host/NumPy reference** (``*_ref``): one query at a time, the
  relevance judgments as a plain ``{doc_id: grade}`` mapping, written
  as the textbook formula with Python loops — the hand-checkable
  ground truth the tests pin the batched path against (copied from the
  JAX package as they are);
* a **batched path** (``mrr_at_k`` / ``ndcg_at_k`` / ...): plain torch
  over ``(B, K)`` retrieved-id arrays and padded ``(B, R)`` relevance
  arrays (``qrels.Qrels.to_arrays``), returning per-query ``(B,)`` f32
  metric vectors on the device of the retrieved ids (numpy inputs: the
  CPU). The matching step is one ``(B, K, R)`` broadcast compare; every
  sum is f32.

Conventions shared by both paths:

* retrieved ids ``< 0`` are padding/tombstones — never a match;
* a judged grade ``<= 0`` means "not relevant" (and pads the arrays);
* nDCG uses **graded exponential gains** ``(2^g - 1) / log2(rank+1)``
  (the TREC/trec_eval form), so grade order matters, not just set
  membership; MRR / recall / success binarize at ``grade > 0``;
* queries with no relevant documents score 0 on every metric.

Ids are compared as int64 (the JAX path casts to int32, which equals
int64 for every id below 2^31).
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

METRIC_NAMES = ("mrr", "ndcg", "recall", "success")


# ---------------------------------------------------------------------------
# host/NumPy reference (one query, judgments as a mapping)
# ---------------------------------------------------------------------------

def mrr_ref(ranked: Sequence[int], rels: Mapping[int, float],
            k: int) -> float:
    """1 / rank of the first relevant doc within the top ``k``."""
    for pos, doc in enumerate(list(ranked)[:k]):
        if doc >= 0 and rels.get(int(doc), 0.0) > 0.0:
            return 1.0 / (pos + 1)
    return 0.0


def ndcg_ref(ranked: Sequence[int], rels: Mapping[int, float],
             k: int) -> float:
    """nDCG@k with graded exponential gains (see module docstring)."""
    def dcg(grades):
        return sum((2.0 ** g - 1.0) / np.log2(pos + 2.0)
                   for pos, g in enumerate(grades))

    got = [max(rels.get(int(d), 0.0), 0.0) if d >= 0 else 0.0
           for d in list(ranked)[:k]]
    ideal = sorted((g for g in rels.values() if g > 0), reverse=True)[:k]
    idcg = dcg(ideal)
    return dcg(got) / idcg if idcg > 0 else 0.0


def recall_ref(ranked: Sequence[int], rels: Mapping[int, float],
               k: int) -> float:
    """|top-k ∩ relevant| / |relevant| (0 when nothing is judged)."""
    relevant = {d for d, g in rels.items() if g > 0}
    if not relevant:
        return 0.0
    hits = {int(d) for d in list(ranked)[:k] if d >= 0} & relevant
    return len(hits) / len(relevant)


def success_ref(ranked: Sequence[int], rels: Mapping[int, float],
                k: int) -> float:
    """1.0 iff any relevant doc appears in the top ``k``."""
    return 1.0 if recall_ref(ranked, rels, k) > 0 else 0.0


REFERENCE = {"mrr": mrr_ref, "ndcg": ndcg_ref, "recall": recall_ref,
             "success": success_ref}


# ---------------------------------------------------------------------------
# batched path (retrieved-id arrays + padded relevance arrays)
# ---------------------------------------------------------------------------

def _on(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=device)


def ranked_grades(ranked_ids, rel_ids, rel_grades) -> torch.Tensor:
    """Grade of every retrieved doc: ``(B, K)`` f32 from ``(B, K)`` ids
    matched against padded ``(B, R)`` judgments.

    One broadcast compare — retrieved padding (id < 0) and judgment
    padding (grade <= 0) both fall out as grade 0.
    """
    device = (ranked_ids.device if isinstance(ranked_ids, torch.Tensor)
              else torch.device("cpu"))
    ranked = _on(ranked_ids, torch.int64, device)[..., :, None]
    rel = _on(rel_ids, torch.int64, device)[..., None, :]
    grades = _on(rel_grades, torch.float32, device)[..., None, :]
    match = (ranked == rel) & (ranked >= 0) & (grades > 0.0)
    return torch.where(match, grades, 0.0).amax(dim=-1)


def _discounts(k: int, device: torch.device) -> torch.Tensor:
    return 1.0 / torch.log2(
        torch.arange(k, dtype=torch.float32, device=device) + 2.0)


def mrr_at_k(ranked_ids, rel_ids, rel_grades, *, k: int) -> torch.Tensor:
    """Per-query ``(B,)`` reciprocal rank of the first relevant doc."""
    hit = ranked_grades(ranked_ids, rel_ids, rel_grades)[..., :k] > 0.0
    # argmax of an integer tensor gives the first maximal position, as
    # jnp.argmax does: the first hit (0 when there is none)
    first = hit.to(torch.int32).argmax(dim=-1)
    rr = 1.0 / (first.to(torch.float32) + 1.0)
    return torch.where(hit.any(dim=-1), rr, 0.0)


def ndcg_at_k(ranked_ids, rel_ids, rel_grades, *, k: int) -> torch.Tensor:
    """Per-query ``(B,)`` nDCG@k with graded exponential gains."""
    g = ranked_grades(ranked_ids, rel_ids, rel_grades)[..., :k]
    dcg = ((torch.exp2(g) - 1.0) * _discounts(g.shape[-1], g.device)
           ).sum(dim=-1)
    grades = _on(rel_grades, torch.float32, g.device).clamp_min(0.0)
    m = min(k, grades.shape[-1])
    ideal = grades.sort(dim=-1, descending=True).values[..., :m]
    idcg = ((torch.exp2(ideal) - 1.0) * _discounts(m, g.device)).sum(dim=-1)
    return torch.where(idcg > 0.0, dcg / idcg.clamp_min(1e-30), 0.0)


def recall_at_k(ranked_ids, rel_ids, rel_grades, *, k: int) -> torch.Tensor:
    """Per-query ``(B,)`` fraction of relevant docs in the top k."""
    g = ranked_grades(ranked_ids, rel_ids, rel_grades)[..., :k]
    hits = (g > 0.0).sum(dim=-1).to(torch.float32)
    n_rel = (_on(rel_grades, torch.float32, g.device) > 0.0).sum(
        dim=-1).to(torch.float32)
    return torch.where(n_rel > 0.0, hits / n_rel.clamp_min(1.0), 0.0)


def success_at_k(ranked_ids, rel_ids, rel_grades, *, k: int
                 ) -> torch.Tensor:
    """Per-query ``(B,)`` indicator: any relevant doc in the top k."""
    g = ranked_grades(ranked_ids, rel_ids, rel_grades)[..., :k]
    return (g > 0.0).any(dim=-1).to(torch.float32)


BATCHED = {"mrr": mrr_at_k, "ndcg": ndcg_at_k, "recall": recall_at_k,
           "success": success_at_k}


def compute_metrics(ranked_ids, qrels, *, ks: Tuple[int, ...] = (10,),
                    query_ids: Sequence[int] = None,
                    metrics: Tuple[str, ...] = METRIC_NAMES,
                    ) -> Dict[str, float]:
    """Mean metrics over a batch: ``{"mrr@10": 0.83, "ndcg@10": ...}``.

    ``ranked_ids`` is the ``(B, K)`` id array straight out of
    ``retrieve()`` / ``IndexBuilder.search`` (external ids, -1 pads; a
    numpy array or a tensor on any device); ``qrels`` a
    :class:`repro_torch.eval.qrels.Qrels`. Row b is scored against
    ``query_ids[b]`` (default: ``qrels.query_ids`` in order — the common
    "one row per judged query" case).
    """
    if not isinstance(ranked_ids, torch.Tensor):
        ranked_ids = np.asarray(ranked_ids)
    rel_ids, rel_grades = qrels.to_arrays(query_ids)
    if ranked_ids.shape[0] != rel_ids.shape[0]:
        raise ValueError(
            f"{ranked_ids.shape[0]} ranking rows for {rel_ids.shape[0]} "
            f"queries — pass query_ids= to align them")
    out: Dict[str, float] = {}
    for k in ks:
        for name in metrics:
            per_q = BATCHED[name](ranked_ids, rel_ids, rel_grades, k=k)
            out[f"{name}@{k}"] = float(per_q.mean())
    return out
