"""Deterministic synthetic LSR and recsys data (the port's copy of
``repro/data/synthetic.py:_rng``, ``_zipf_ids``, ``lsr_pair_batches``,
``lsr_impact_corpus`` and ``recsys_batches``).

Host-side numpy: ``lsr_pair_batches`` and ``recsys_batches`` are seeded
per ``(seed, shard, step)``, ``lsr_impact_corpus`` by ``seed``; for the
same arguments each gives the JAX package's arrays, bit for bit.
"""

from __future__ import annotations

from typing import Dict, Iterator, Sequence

import numpy as np


def _rng(seed: int, shard: int, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed, shard, step]))


def _zipf_ids(rng, size, vocab: int, a: float = 1.3) -> np.ndarray:
    """Zipf-distributed ids in [0, vocab) — heavy head like real text."""
    raw = rng.zipf(a, size=size)
    return np.clip(raw - 1, 0, vocab - 1).astype(np.int32)


def lsr_pair_batches(
    *,
    batch: int,
    q_len: int,
    d_len: int,
    vocab: int,
    seed: int = 0,
    shard: int = 0,
    min_frac: float = 0.3,
) -> Iterator[Dict[str, np.ndarray]]:
    """(query, positive-doc) token batches with masks, SPLADE-style."""
    step = 0
    while True:
        rng = _rng(seed, shard, step)
        q_tok = _zipf_ids(rng, (batch, q_len), vocab)
        d_tok = _zipf_ids(rng, (batch, d_len), vocab)
        q_n = rng.integers(int(q_len * min_frac), q_len + 1, size=batch)
        d_n = rng.integers(int(d_len * min_frac), d_len + 1, size=batch)
        q_mask = (np.arange(q_len)[None] < q_n[:, None]).astype(np.int32)
        d_mask = (np.arange(d_len)[None] < d_n[:, None]).astype(np.int32)
        # overlap positives: splice some query tokens into the doc so
        # the contrastive task is learnable
        n_copy = max(1, q_len // 2)
        d_tok[:, :n_copy] = q_tok[:, :n_copy]
        yield {
            "q_tokens": q_tok, "q_mask": q_mask,
            "d_tokens": d_tok * d_mask, "d_mask": d_mask,
        }
        step += 1


def recsys_batches(
    *,
    batch: int,
    n_dense: int,
    n_sparse: int,
    table_sizes: Sequence[int],
    seq_len: int = 0,
    seed: int = 0,
    shard: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """CTR click batches: ``label`` (Bernoulli 0.25, f32), ``dense``
    (normal, f32) when ``n_dense``, and Zipf ids: ``sparse_idx`` (batch,
    one column a table) or, for DIEN (``seq_len``), ``hist_idx`` (batch,
    seq_len) and ``target_idx`` (batch,) into the first table."""
    step = 0
    while True:
        rng = _rng(seed, shard, step)
        out: Dict[str, np.ndarray] = {
            "label": rng.binomial(1, 0.25, size=batch).astype(np.float32),
        }
        if n_dense:
            out["dense"] = rng.normal(size=(batch, n_dense)).astype(
                np.float32)
        if seq_len:  # DIEN
            rows = table_sizes[0]
            out["hist_idx"] = _zipf_ids(rng, (batch, seq_len), rows)
            out["target_idx"] = _zipf_ids(rng, (batch,), rows)
        else:
            cols = [
                _zipf_ids(rng, (batch,), rows) for rows in table_sizes
            ]
            out["sparse_idx"] = np.stack(cols, axis=1)
        yield out
        step += 1


def lsr_impact_corpus(
    *,
    n_docs: int,
    vocab: int,
    doc_nnz: int,
    n_queries: int = 0,
    q_nnz: int = 16,
    graded: int = 12,
    seed: int = 0,
    term_jitter: float = 0.04,
) -> Dict[str, np.ndarray]:
    """Synthetic LSR impact matrices with graded relevance, the retrieval
    engine's acceptance corpus.

    Term t gets a center ``c_t ~ U(0.5, 2.0)`` and each posting draws
    ``c_t * U(1 - term_jitter, 1 + term_jitter)``, so per-term affine
    quantization sees a tight range. Docs activate ``doc_nnz`` distinct
    uniform terms. Per query, ``graded`` planted docs share a strictly
    shrinking prefix of its terms (``q_nnz - 2i`` for plant i, fillers
    drawn from the non-query terms), so consecutive grades differ by two
    whole terms and the top-``k`` ids (``k <= graded - 2``) are the same
    under every exact or quantized method.

    Returns ``{"docs": (n_docs, vocab) f32}``, plus ``"queries"``
    ``(n_queries, vocab) f32`` and ``"qrels"`` ``(n_queries * graded, 3)
    f32`` ``(query, doc, grade)`` triples when ``n_queries`` > 0.
    """
    if n_queries and n_docs < n_queries * graded:
        raise ValueError(f"need n_docs >= n_queries*graded = "
                         f"{n_queries * graded}, got {n_docs}")
    if n_queries and (doc_nnz < q_nnz or q_nnz < 2 * graded + 2):
        raise ValueError("planted docs need doc_nnz >= q_nnz and "
                         "q_nnz >= 2*graded + 2")
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.5, 2.0, size=vocab).astype(np.float32)

    def impacts(cols):
        jit = rng.uniform(1 - term_jitter, 1 + term_jitter,
                          size=cols.shape[0]).astype(np.float32)
        return centers[cols] * jit

    docs = np.zeros((n_docs, vocab), np.float32)
    rows = np.repeat(np.arange(n_docs), doc_nnz)
    cols = np.stack([rng.choice(vocab, size=doc_nnz, replace=False)
                     for _ in range(n_docs)]).ravel()
    docs[rows, cols] = impacts(cols)
    out = {"docs": docs}
    if n_queries:
        queries = np.zeros((n_queries, vocab), np.float32)
        triples = []
        for b in range(n_queries):
            q_terms = rng.choice(vocab, size=q_nnz, replace=False)
            queries[b, q_terms] = impacts(q_terms)
            pool = np.setdiff1d(np.arange(vocab), q_terms)
            for i in range(graded):
                d = b * graded + i
                shared = q_terms[:q_nnz - 2 * i]
                docs[d] = 0.0
                docs[d, shared] = impacts(shared)
                cols = rng.choice(pool, size=doc_nnz - shared.shape[0],
                                  replace=False)
                docs[d, cols] = impacts(cols)
                triples.append((b, d, graded - i))
        out["queries"] = queries
        out["qrels"] = np.asarray(triples, np.float32)
    return out
