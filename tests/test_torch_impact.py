"""The port's K4 (its plain version, on the CPU) against the JAX package's
Pallas kernel run by the interpreter, and against the JAX ``impact``
path, on the same numpy inputs.

Ids must be identical (ties to the lowest doc id); values agree to 1e-6
(the same f32 products; the Pallas kernel sums a doc's lanes through a
one-hot contraction, the port in lane order). The random cases use
weights that are multiples of 1/8, so every sum is exact and even the
values must match bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import lsr_impact_corpus
from repro.kernels._common import NEG_INF as JAX_NEG_INF
from repro.kernels.impact_score import fused_impact_topk as jax_fused
from repro.retrieval import build_inverted_index as jax_build
from repro.retrieval import retrieve as jax_retrieve
from repro.retrieval import sparsify_topk as jax_sparsify
from repro.retrieval.score import _fused_windows as jax_windows
from repro_torch.kernels._common import NEG_INF
from repro_torch.kernels.impact_score import (fused_impact_topk,
                                              fused_window_bytes)
from repro_torch.retrieval.index import build_inverted_index
from repro_torch.retrieval.score import (_fused_windows, fused_retrieve,
                                         retrieve)
from repro_torch.retrieval.sparse_rep import sparsify_topk

K = 10
BENCH = dict(n_docs=384, vocab=512, doc_nnz=32, n_queries=6, q_nnz=28)
TOL = 1e-6


def _jax_k4(w, docs, n_docs, k):
    v, i = jax_fused(jnp.asarray(w), jnp.asarray(docs), n_docs=n_docs,
                     k=k, block_n=64, block_w=128, interpret=True)
    return np.asarray(v), np.asarray(i)


def _port_k4(w, docs, n_docs, k, term_lanes):
    v, i = fused_impact_topk(torch.from_numpy(w), torch.from_numpy(docs),
                             n_docs=n_docs, k=k, term_lanes=term_lanes)
    return v.numpy(), i.numpy()


def _assert_same(port, ref, *, exact=False):
    np.testing.assert_array_equal(port[1], ref[1])
    np.testing.assert_allclose(port[0], ref[0], rtol=0 if exact else TOL,
                               atol=0 if exact else TOL)


@pytest.fixture(scope="module")
def graded():
    data = lsr_impact_corpus(**BENCH)
    q_j = jax_sparsify(jnp.asarray(data["queries"]), BENCH["q_nnz"])
    raw = jax_build(jax_sparsify(jnp.asarray(data["docs"]),
                                 BENCH["doc_nnz"]), BENCH["vocab"])
    q_t = sparsify_topk(torch.from_numpy(data["queries"]), BENCH["q_nnz"])
    index = build_inverted_index(
        sparsify_topk(torch.from_numpy(data["docs"]), BENCH["doc_nnz"]),
        BENCH["vocab"], device="cpu")
    return {"q_j": q_j, "raw": raw, "q_t": q_t, "index": index}


def test_windows_equal_jax_windows(graded):
    w_j, d_j = jax_windows(graded["q_j"], graded["raw"])
    w_t, d_t = _fused_windows(graded["q_t"], graded["index"])
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))


def test_plain_k4_matches_pallas_kernel_on_graded_windows(graded):
    w, d = (np.array(a) for a in jax_windows(graded["q_j"], graded["raw"]))
    n = BENCH["n_docs"]
    _assert_same(_port_k4(w, d, n, K, graded["index"].max_postings),
                 _jax_k4(w, d, n, K))


@pytest.mark.parametrize("method", ["impact", "fused"])
def test_fused_retrieve_matches_jax_paths(graded, method):
    ref = jax_retrieve(graded["q_j"], graded["raw"], K, method=method,
                       **({"interpret": True} if method == "fused" else {}))
    v, i = fused_retrieve(graded["q_t"], graded["index"], K)
    _assert_same((v.numpy(), i.numpy()), tuple(np.asarray(a) for a in ref))


@pytest.fixture(scope="module")
def graded_2000():
    """The graded corpus at 2000 docs, for a k past K4's old limit of
    1024: a third of the docs score 0 for a query, so the ids past the
    matches are the lowest-id ties of the reference's rule."""
    data = lsr_impact_corpus(n_docs=2000, vocab=512, doc_nnz=32,
                             n_queries=3, q_nnz=28)
    raw_j = jax_build(jax_sparsify(jnp.asarray(data["docs"]), 32), 512)
    index = build_inverted_index(
        sparsify_topk(torch.from_numpy(data["docs"]), 32), 512, device="cpu")
    return {"q_j": jax_sparsify(jnp.asarray(data["queries"]), 28),
            "q_t": sparsify_topk(torch.from_numpy(data["queries"]), 28),
            "raw_j": raw_j, "index": index}


@pytest.mark.parametrize("method", ["fused", "auto"])
def test_retrieve_past_k1024_equals_jax(graded_2000, method):
    g = graded_2000
    ref = jax_retrieve(g["q_j"], g["raw_j"], 1100, method=method,
                       **({"interpret": True} if method == "fused" else {}))
    _, want = jax_retrieve(g["q_j"], g["raw_j"], 1100, method="impact")
    v, i = retrieve(g["q_t"], g["index"], 1100, method=method)
    assert i.shape == (3, 1100)
    np.testing.assert_array_equal(np.asarray(ref[1]), np.asarray(want))
    _assert_same((v.numpy(), i.numpy()), tuple(np.asarray(a) for a in ref))


@pytest.mark.parametrize("seed", range(6))
def test_plain_k4_exact_on_eighths(seed):
    """Random windows, weights in multiples of 1/8, duplicate docs across
    terms, zero lanes and k both below and above the doc count."""
    rng = np.random.default_rng(seed)
    B, Q, L = 3, 5, 7
    n_docs = int(rng.integers(5, 60))
    docs = np.stack([np.stack([rng.permutation(max(n_docs, L))[:L]
                               for _ in range(Q)]) for _ in range(B)])
    docs = np.minimum(docs, n_docs - 1).astype(np.int32).reshape(B, -1)
    w = (rng.integers(0, 9, (B, Q * L)) / 8).astype(np.float32)
    k = int(rng.integers(1, n_docs + 5))
    _assert_same(_port_k4(w, docs, n_docs, k, L), _jax_k4(w, docs,
                                                            n_docs, k),
                 exact=True)


@pytest.mark.filterwarnings("ignore:build_inverted_index")
def test_duplicate_scores_tie_to_lowest_id():
    """Every doc identical: the ranking is ascending doc ids (mirrors
    tests/test_kernels_impact.py's duplicate-score case)."""
    n, vocab = 37, 64
    m = np.zeros((n, vocab), np.float32)
    m[:, [3, 7, 11]] = 1.0
    index = build_inverted_index(sparsify_topk(torch.from_numpy(m), 4),
                                 vocab, device="cpu")
    q = sparsify_topk(torch.from_numpy(m[:1]), 4)
    v, i = fused_retrieve(q, index, 8)
    np.testing.assert_array_equal(i.numpy()[0], np.arange(8))
    jq = jax_sparsify(jnp.asarray(m[:1]), 4)
    ref = jax_retrieve(jq, jax_build(jax_sparsify(jnp.asarray(m), 4),
                                     vocab), 8, method="impact")
    _assert_same((v.numpy(), i.numpy()), tuple(np.asarray(a) for a in ref))


def test_k_greater_than_n_docs_pads_neg_inf_and_zero():
    w = np.asarray([[1.0, 2.0, 3.0]], np.float32)
    docs = np.asarray([[0, 1, 2]], np.int32)
    port = _port_k4(w, docs, 3, 5, 1)
    _assert_same(port, _jax_k4(w, docs, 3, 5), exact=True)
    np.testing.assert_array_equal(port[1][0], [2, 1, 0, 0, 0])
    assert NEG_INF == JAX_NEG_INF and (port[0][0, 3:] == NEG_INF).all()


def test_empty_window():
    w = np.zeros((2, 0), np.float32)
    docs = np.zeros((2, 0), np.int32)
    port = _port_k4(w, docs, 9, 4, 1)
    _assert_same(port, _jax_k4(w, docs, 9, 4), exact=True)
    np.testing.assert_array_equal(port[1], np.tile(np.arange(4), (2, 1)))
    assert (port[0] == 0).all()


def test_empty_query_rows_score_lowest_ids_at_zero(graded):
    q = sparsify_topk(torch.zeros((2, BENCH["vocab"])), 4)
    v, i = fused_retrieve(q, graded["index"], K)
    np.testing.assert_array_equal(i.numpy(), np.tile(np.arange(K), (2, 1)))
    assert (v.numpy() == 0).all()


def test_kernel_arguments_checked_without_a_card():
    """Tensors that are not on the CPU go to the kernel's wrapper: any
    k >= 1 (past the old limit of 1024 too) passes its checks and reaches
    the device check, which meta tensors fail."""
    w = torch.empty((2, 40), device="meta")
    docs = torch.empty((2, 40), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="k must be >= 1"):
        fused_impact_topk(w, docs, n_docs=2000, k=0, term_lanes=4)
    for k in (1024, 1025, 1100, 2000, 50000):
        with pytest.raises(ValueError, match="one CUDA device"):
            fused_impact_topk(w, docs, n_docs=2000, k=k, term_lanes=4)


@pytest.mark.parametrize("term_lanes", [0, -1])
def test_term_lanes_below_one_raises(term_lanes):
    w = np.ones((1, 4), np.float32)
    docs = np.arange(4, dtype=np.int32)[None]
    with pytest.raises(ValueError, match="term_lanes"):
        _port_k4(w, docs, 4, 2, term_lanes)


def test_window_bytes():
    assert fused_window_bytes(8, 64, 211) == 8 * 64 * 211 * 8
