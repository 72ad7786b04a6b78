"""Ranking-quality evaluation: metrics, qrels, end-to-end harness
(``repro/eval``)."""

from repro_torch.eval.harness import (DEFAULT_METHODS, MethodSpec,
                                      encode_reps, evaluate_retrieval)
from repro_torch.eval.metrics import (BATCHED, METRIC_NAMES, REFERENCE,
                                      compute_metrics, mrr_at_k, mrr_ref,
                                      ndcg_at_k, ndcg_ref, ranked_grades,
                                      recall_at_k, recall_ref, success_at_k,
                                      success_ref)
from repro_torch.eval.qrels import Qrels

__all__ = [
    "BATCHED",
    "DEFAULT_METHODS",
    "METRIC_NAMES",
    "MethodSpec",
    "Qrels",
    "REFERENCE",
    "compute_metrics",
    "encode_reps",
    "evaluate_retrieval",
    "mrr_at_k",
    "mrr_ref",
    "ndcg_at_k",
    "ndcg_ref",
    "ranked_grades",
    "recall_at_k",
    "recall_ref",
    "success_at_k",
    "success_ref",
]
