"""End-to-end effectiveness harness: encode → sparsify → build-index →
retrieve → score, for any engine configuration
(``repro/eval/harness.py``).

``evaluate_retrieval(encoder, corpus, qrels, ...)`` turns each serving
path into a row of MRR@k / nDCG@k numbers against graded qrels, so
quality-vs-speed knobs are *measured* instead of asserted id-identical.

Corpus forms (one dict, two shapes):

* **token corpus** — ``{"doc_tokens": (N, S), "q_tokens": (B, S)}``
  (+ optional ``doc_mask`` / ``q_mask``): rows go through ``encoder``
  (the ``(tokens, mask) -> reps`` callable of
  ``runtime.serving.make_config_encoder``, which takes CPU tensors and
  returns results on its params' device) in fixed-size chunks; dense
  ``(B, V)`` outputs are sparsified with ``rep_topk``.
* **impact corpus** — ``{"docs": (N, V), "queries": (B, V)}`` dense
  impact matrices (``data.synthetic.lsr_impact_corpus``): no encoder
  needed, rows are sparsified directly on ``device``.

Each :class:`MethodSpec` builds a fresh index for its engine config
(``IndexBuilder`` kwargs) on ``device`` — ``cuda`` unless the caller
asks for the CPU — and searches with its ``search`` kwargs, so one call
sweeps the method matrix on identical reps. Judgments are keyed by
**external** doc ids (``doc_ids``, default row order), the ids the
engine preserves across mutations — see ``qrels.py``.

``DEFAULT_METHODS`` is the JAX package's: ``exact``, ``pruned`` (the
builder's forward rows, the two-tier scorer at margin 0) and
``quantized``. A spec with ``doc_shards > 0`` searches a doc-range
``ShardedIndex`` instead of a builder (``engine.sharded_index``), and the
builder's ``term_shards`` / ``plan`` give the term-sharded and 2D bases.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.eval.metrics import METRIC_NAMES, compute_metrics
from repro_torch.eval.qrels import Qrels
from repro_torch.retrieval.engine.builder import IndexBuilder
from repro_torch.retrieval.engine.sharded_index import shard_index
from repro_torch.retrieval.score import retrieve
from repro_torch.retrieval.sparse_rep import (SparseRep, sparsify_topk,
                                              stack_rows)


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    """One evaluated retrieval configuration.

    ``engine`` kwargs feed ``IndexBuilder`` (``quantize=True``,
    ``keep_forward=True``, ``term_shards=n``, ``plan=``); ``search`` kwargs
    feed ``IndexBuilder.search`` (``method=``, ``q_width=``,
    ``prune_margin=``, ``candidates=``). ``doc_shards > 0`` instead builds
    a doc-range ``ShardedIndex`` and searches it with ``sharded`` (the
    builder has no doc-sharded mode: doc sharding is a serving-mesh
    choice).
    """
    name: str
    engine: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    search: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    doc_shards: int = 0


DEFAULT_METHODS: Tuple[MethodSpec, ...] = (
    MethodSpec("exact"),
    MethodSpec("pruned", engine={"keep_forward": True},
               search={"method": "pruned", "prune_margin": 0.0}),
    MethodSpec("quantized", engine={"quantize": True}),
)


def encode_reps(encoder: Callable[[Any, Any], Any], tokens, mask=None,
                *, batch: int = 32, rep_topk: int = 64) -> SparseRep:
    """Run a token matrix through ``encoder`` in fixed-size chunks and
    stack the rows into one ``(N, K)`` numpy ``SparseRep``.

    Chunks are padded to exactly ``batch`` rows, so every call sees one
    shape, and the padding rows are dropped; dense ``(B, V)`` encoder
    outputs are reduced with ``sparsify_topk(rep_topk)`` (sparse-encoder
    outputs pass through).
    """
    toks = np.asarray(tokens, np.int32)
    msk = (np.ones_like(toks) if mask is None
           else np.asarray(mask, np.int32))
    n = toks.shape[0]
    rows = []
    for lo in range(0, n, batch):
        t = toks[lo:lo + batch]
        m = msk[lo:lo + batch]
        pad = batch - t.shape[0]
        if pad:
            t = np.pad(t, ((0, pad), (0, 0)))
            m = np.pad(m, ((0, pad), (0, 0)))
        reps = encoder(torch.from_numpy(t), torch.from_numpy(m))
        if not isinstance(reps, SparseRep):
            reps = sparsify_topk(reps, rep_topk)
        rows.append(reps)
    stacked = stack_rows(rows)
    if stacked.values.shape[0] != n:       # drop chunk padding rows
        stacked = SparseRep(stacked.values[:n], stacked.indices[:n],
                            stacked.nnz[:n])
    return stacked


def _corpus_reps(encoder, corpus: Mapping[str, Any], *, batch: int,
                 rep_topk: int, device: torch.device
                 ) -> Tuple[SparseRep, SparseRep, int]:
    """(doc_reps, query_reps, vocab_size) from either corpus form."""
    if "docs" in corpus and "queries" in corpus:
        docs = torch.as_tensor(corpus["docs"], device=device)
        queries = torch.as_tensor(corpus["queries"], device=device)
        vocab = int(docs.shape[-1])
        return (sparsify_topk(docs, min(rep_topk, vocab)),
                sparsify_topk(queries, min(rep_topk, vocab)),
                vocab)
    if "doc_tokens" in corpus and "q_tokens" in corpus:
        if encoder is None:
            raise ValueError("a token corpus needs an encoder "
                             "(tokens, mask) -> reps")
        if "vocab_size" not in corpus:
            raise ValueError("a token corpus must carry vocab_size")
        vocab = int(corpus["vocab_size"])
        d = encode_reps(encoder, corpus["doc_tokens"],
                        corpus.get("doc_mask"), batch=batch,
                        rep_topk=rep_topk)
        q = encode_reps(encoder, corpus["q_tokens"],
                        corpus.get("q_mask"), batch=batch,
                        rep_topk=rep_topk)
        return d, q, vocab
    raise ValueError(
        "corpus must carry docs+queries (dense impacts) or "
        f"doc_tokens+q_tokens (+vocab_size); got {sorted(corpus)}")


def _search_one(spec: MethodSpec, doc_reps: SparseRep,
                q_reps: SparseRep, vocab: int, k: int,
                doc_ids: np.ndarray, *, device: DeviceLike = None
                ) -> np.ndarray:
    """External-id ``(B, k)`` ranking for one method config."""
    if spec.doc_shards:
        sidx = shard_index(doc_reps, vocab, spec.doc_shards,
                           device=resolve_device(device))
        _, idx = retrieve(q_reps, sidx, k, method="sharded",
                          **dict(spec.search))
        idx = idx.cpu().numpy()
        ext = np.full(idx.shape, -1, np.int64)
        ok = idx >= 0
        ext[ok] = doc_ids[np.clip(idx, 0, doc_ids.shape[0] - 1)][ok]
        return ext
    builder = IndexBuilder(vocab, device=resolve_device(device),
                           **dict(spec.engine))
    builder.add(doc_reps, ids=doc_ids)
    builder.flush()
    _, ext = builder.search(q_reps, k, **dict(spec.search))
    return np.asarray(ext)


def evaluate_retrieval(
    encoder: Optional[Callable[[Any, Any], Any]],
    corpus: Mapping[str, Any],
    qrels: Qrels,
    *,
    methods: Sequence[MethodSpec] = DEFAULT_METHODS,
    ks: Tuple[int, ...] = (10,),
    metrics: Tuple[str, ...] = METRIC_NAMES,
    doc_ids: Optional[Sequence[int]] = None,
    query_ids: Optional[Sequence[int]] = None,
    batch: int = 32,
    rep_topk: int = 64,
    device: DeviceLike = None,
) -> Dict[str, Dict[str, float]]:
    """The full quality loop for every method: per-method metric dicts
    ``{"exact": {"mrr@10": ..., "ndcg@10": ...}, "quantized": {...}}``.

    ``doc_ids`` are the external ids documents are ingested under
    (default ``arange(N)``) — ``qrels`` must be keyed consistently.
    ``query_ids`` aligns ranking rows with qrels queries (default:
    query b of the corpus is qrels query b, i.e. ``range(B)``).
    Retrieval depth is ``max(ks)``; metrics at every ``k`` in ``ks``.
    The indexes live on ``device`` (``cuda`` unless the caller passes
    ``"cpu"``).
    """
    dev = resolve_device(device)
    doc_reps, q_reps, vocab = _corpus_reps(
        encoder, corpus, batch=batch, rep_topk=rep_topk, device=dev)
    n_docs = doc_reps.values.reshape(-1, doc_reps.width).shape[0]
    n_queries = q_reps.values.reshape(-1, q_reps.width).shape[0]
    ids = (np.arange(n_docs, dtype=np.int64) if doc_ids is None
           else np.asarray(list(doc_ids), np.int64))
    if ids.shape[0] != n_docs:
        raise ValueError(f"{ids.shape[0]} doc_ids for {n_docs} docs")
    qids = (list(range(n_queries)) if query_ids is None
            else list(query_ids))

    depth = max(ks)
    out: Dict[str, Dict[str, float]] = {}
    for spec in methods:
        ranked = _search_one(spec, doc_reps, q_reps, vocab, depth, ids,
                             device=dev)
        out[spec.name] = compute_metrics(ranked, qrels, ks=ks,
                                         query_ids=qids,
                                         metrics=metrics)
    return out
