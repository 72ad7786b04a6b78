"""Deterministic synthetic LSR, LM, recsys and graph data (the port's copy
of ``repro/data/synthetic.py``: ``_rng``, ``_zipf_ids``,
``lsr_pair_batches``, ``lsr_impact_corpus``, ``lm_token_batches``,
``recsys_batches``, ``make_synthetic_graph`` and ``molecule_batches``).

Host-side numpy: the batch streams are seeded per ``(seed, shard,
step)``, ``lsr_impact_corpus`` and ``make_synthetic_graph`` by ``seed``;
for the same arguments each gives the JAX package's arrays, bit for bit.
"""

from __future__ import annotations

from typing import Dict, Iterator, Sequence, Tuple

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


def lm_token_batches(
    *, batch: int, seq_len: int, vocab: int, seed: int = 0, shard: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Zipf token rows of ``seq_len + 1``: ``tokens``, ``labels`` (the next
    token) and a ``mask`` of ones."""
    step = 0
    while True:
        rng = _rng(seed, shard, step)
        tok = _zipf_ids(rng, (batch, seq_len + 1), vocab)
        yield {
            "tokens": tok[:, :-1],
            "labels": tok[:, 1:],
            "mask": np.ones((batch, seq_len), np.int32),
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


def make_synthetic_graph(
    n_nodes: int, n_edges: int, *, seed: int = 0,
    power_law: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Random (src, dst) edge lists; power-law dst to mimic citation
    hubs (the regime that makes triplet counting explode)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, size=n_edges).astype(np.int64)
    if power_law:
        ranks = rng.zipf(1.5, size=n_edges)
        dst = np.clip(ranks - 1, 0, n_nodes - 1).astype(np.int64)
        dst = (dst * 2654435761 % n_nodes).astype(np.int64)  # de-cluster
    else:
        dst = rng.integers(0, n_nodes, size=n_edges).astype(np.int64)
    keep = src != dst
    return src[keep], dst[keep]


def molecule_batches(
    *,
    n_graphs: int,
    nodes_per_graph: int,
    edges_per_graph: int,
    n_atom_types: int = 95,
    cutoff: float = 5.0,
    seed: int = 0,
    shard: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Batched random molecules: 3-D positions, cutoff-radius edges
    (capped at edges_per_graph), graph-level scalar targets."""
    step = 0
    while True:
        rng = _rng(seed, shard, step)
        N = n_graphs * nodes_per_graph
        pos = rng.uniform(0, cutoff * 1.2,
                          size=(n_graphs, nodes_per_graph, 3))
        feats = rng.integers(0, n_atom_types, size=N).astype(np.int32)

        srcs, dsts = [], []
        for g in range(n_graphs):
            d = np.linalg.norm(
                pos[g][:, None] - pos[g][None], axis=-1)
            np.fill_diagonal(d, np.inf)
            cand = np.argwhere(d < cutoff)
            if len(cand) > edges_per_graph:
                sel = rng.choice(len(cand), edges_per_graph, replace=False)
                cand = cand[sel]
            base = g * nodes_per_graph
            srcs.append(cand[:, 0] + base)
            dsts.append(cand[:, 1] + base)
        src = np.concatenate(srcs).astype(np.int32)
        dst = np.concatenate(dsts).astype(np.int32)

        E_cap = n_graphs * edges_per_graph
        e_mask = np.zeros(E_cap, np.int32)
        e_mask[:len(src)] = 1
        src_p = np.zeros(E_cap, np.int32)
        dst_p = np.zeros(E_cap, np.int32)
        src_p[:len(src)] = src
        dst_p[:len(dst)] = dst

        yield {
            "positions": pos.reshape(N, 3).astype(np.float32),
            "node_feat": feats,
            "node_mask": np.ones(N, np.int32),
            "node_graph_id": np.repeat(
                np.arange(n_graphs, dtype=np.int32), nodes_per_graph),
            "edge_src": src_p, "edge_dst": dst_p, "edge_mask": e_mask,
            "target": rng.normal(size=(n_graphs, 1)).astype(np.float32),
        }
        step += 1
