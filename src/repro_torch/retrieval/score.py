"""Retrieval scoring behind one ``retrieve()`` (``repro/retrieval/score.py``).

Methods ported so far (queries are ``SparseRep``s, the corpus an
``InvertedIndex``):

    "impact"   gather the query terms' posting windows, scatter-add them
               into dense (B, N) scores, top-k (plain PyTorch, as the JAX
               package leaves it to XLA)
    "fused"    the same windows through K4 (``kernels/impact_score``):
               scoring and the running top-k in one kernel, no (B, N)
               matrix
    "auto"     "fused" for indexes of at least ``AUTO_FUSED_N`` docs,
               "impact" below

Both return ``(vals (B, k) f32, idx (B, k) i32)`` with ties to the
lowest doc id, and identical ids on inputs without near-ties. The JAX
package's other methods raise ``NotImplementedError`` naming the ROADMAP
item that brings them. The port's methods take no tuning keyword
arguments (the JAX ones — Pallas blocks, ``interpret`` — are TPU knobs),
and any that is passed raises instead of being ignored.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.impact_score import fused_impact_topk, scatter_scores
from repro_torch.kernels.topk_score import topk_rows
from repro_torch.retrieval.index import InvertedIndex
from repro_torch.retrieval.sparse_rep import SparseRep

METHODS = ("auto", "impact", "fused")
# the JAX package's other methods, and the ROADMAP item that ports each
NOT_PORTED = {
    "pruned": "ROADMAP Queue 1 item 8 (index engine, slice 4)",
    "quantized": "ROADMAP Queue 1 item 8 and kernel K5 (slice 4)",
    "sharded": "ROADMAP Queue 1 item 10 (multi-GPU, slice 4)",
    "term_sharded": "ROADMAP Queue 1 item 10 (multi-GPU, slice 4)",
    "shard2d": "ROADMAP Queue 1 item 10 (multi-GPU, slice 4)",
    "streaming": "ROADMAP Queue 1 item 6 and kernel K6 (slice 3)",
    "dense": "ROADMAP Queue 1 item 6 (dense corpora, slice 3)",
}
# indexed corpora at or above this many docs route "auto" to the fused
# kernel: below it the dense (B, N) score matrix is a rounding error
AUTO_FUSED_N = 16384


def _fused_windows(queries: SparseRep, index: InvertedIndex
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat ``(B, Q * max_postings)`` weight/doc windows: each query
    term's posting list padded to ``max_postings`` lanes, invalid lanes
    at weight exactly 0 (doc 0)."""
    q = queries.to(index.device)
    l_max = index.max_postings
    lane = torch.arange(l_max, dtype=torch.int32, device=index.device)
    qv = q.values.reshape(-1, queries.width).float()
    qi = q.indices.reshape(-1, queries.width).long()
    starts = index.term_starts[qi]                          # (B, Q)
    lens = index.term_lens[qi]
    pos = starts[:, :, None] + lane                         # (B, Q, L)
    valid = (lane < lens[:, :, None]) & (qv > 0)[:, :, None]
    pos = pos.clamp(0, index.n_postings - 1).long()
    docs = torch.where(valid, index.postings_doc[pos], 0)
    w = torch.where(valid, index.postings_val[pos], 0.0) * qv[:, :, None]
    b = w.shape[0]
    return w.reshape(b, -1).contiguous(), docs.reshape(b, -1).contiguous()


def impact_scores(queries: SparseRep, index: InvertedIndex) -> torch.Tensor:
    """Dense ``(B, n_docs)`` impact scores from the posting windows."""
    w, docs = _fused_windows(queries, index)
    return scatter_scores(w, docs, index.n_docs)


def fused_retrieve(queries: SparseRep, index: InvertedIndex, k: int = 10
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k through the fused kernel K4 (its plain version on CPU)."""
    w, docs = _fused_windows(queries, index)
    return fused_impact_topk(w, docs, n_docs=index.n_docs,
                             k=min(k, index.n_docs),
                             term_lanes=index.max_postings)


def resolve_method(method: str, corpus: InvertedIndex) -> str:
    if method in NOT_PORTED:
        raise NotImplementedError(
            f"method={method!r} is not ported yet: it arrives with "
            f"{NOT_PORTED[method]}")
    if method not in METHODS:
        raise ValueError(f"unknown retrieval method {method!r}; one of "
                         f"{list(METHODS)}")
    if method != "auto":
        return method
    return "fused" if corpus.n_docs >= AUTO_FUSED_N else "impact"


def _check_kwargs(method: str, passed: dict) -> None:
    """Raise on tuning kwargs: no ported method honors any."""
    stray = sorted(name for name, value in passed.items()
                   if value is not None)
    if stray:
        raise ValueError(
            f"method={method!r} does not accept {', '.join(stray)} (the "
            "port's methods take no tuning kwargs); refusing to silently "
            "ignore a tuning knob")


def retrieve(queries: SparseRep, corpus: InvertedIndex, k: int = 10, *,
             method: str = "auto", **tuning
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k retrieval of ``SparseRep`` queries from an ``InvertedIndex``.

    ``k`` is clamped to the corpus size; results lie on the index's
    device. See the module docstring for the methods.
    """
    if not isinstance(corpus, InvertedIndex):
        raise ValueError(
            f"method={method!r} needs an InvertedIndex corpus — build one "
            "with retrieval.index.build_inverted_index")
    method = resolve_method(method, corpus)
    _check_kwargs(method, tuning)
    if not isinstance(queries, SparseRep):
        raise ValueError(
            f"method={method!r} needs SparseRep queries — sparsify with "
            "retrieval.sparse_rep.sparsify_topk/threshold")
    if method == "fused":
        return fused_retrieve(queries, corpus, k)
    return topk_rows(impact_scores(queries, corpus), min(k, corpus.n_docs))
