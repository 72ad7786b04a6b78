"""Query ids outside ``[0, V)`` and the order of the index scorers' sums,
the port against the JAX package on the same numpy inputs (CPU).

* A query id at or past V, or negative, reads the term the reference's
  gather reads (JAX: a negative id plus V, then clamped to ``[0, V -
  1]``): ``impact``, ``fused``, ``quantized`` (and ``fused`` on a
  quantized index) and ``pruned`` return the reference's ids, and its
  scores to 1e-6 (the reference's segment sums run in another order; 1e-5
  on the quantized index, as ``test_torch_quantize.py`` holds it).
  ``pruned``'s tier 2 scatters the query into a dense (V,) vector as the
  reference's ``.at[].add`` does: a negative id counts from the end and
  an id still outside ``[0, V)`` is dropped, so such a term has a ceiling
  in tier 1 (the gather's row) but adds nothing to the exact score.
* ``impact`` and ``quantized`` sum each doc's lanes one query term at a
  time, in term order: their scores and top-k are bit for bit those of
  the fused scorers' plain versions, and a sum whose f32 result depends
  on the order comes out as the sequential one in term order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import retrieval as jr
from repro_torch.kernels import impact_score as k45
from repro_torch.retrieval import score
from repro_torch.retrieval.engine.quantize import (quantize_index,
                                                   quantized_scores)
from repro_torch.retrieval.index import build_inverted_index
from repro_torch.retrieval.sparse_rep import SparseRep, sparsify_topk

V = 16
K = 6
TOL = 1e-6
Q_TOL = 1e-5
# ids past V, negative ones (one below -V) and ordinary ones; 0.0 marks a
# padded slot
QUERY_IDS = np.array([[19, -3, 2, 15, 0],
                      [-20, 100, 7, -1, 3],
                      [16, -16, 5, 31, 9]], np.int32)
QUERY_VALS = np.array([[1.0, 0.5, 0.7, 0.2, 0.0],
                       [0.9, 1.3, 0.4, 0.8, 0.6],
                       [0.3, 1.1, 0.0, 0.6, 1.7]], np.float32)


def _corpus(n_docs=48, nnz=6, seed=0):
    rng = np.random.default_rng(seed)
    m = np.zeros((n_docs, V), np.float32)
    for r in range(n_docs):
        cols = rng.choice(V, size=nnz, replace=False)
        m[r, cols] = rng.uniform(0.1, 2.0, size=nnz)
    return m


@pytest.fixture(scope="module")
def indexes():
    D = _corpus()
    raw = build_inverted_index(sparsify_topk(torch.from_numpy(D), 8), V,
                               device="cpu")
    raw_j = jr.build_inverted_index(jr.sparsify_topk(jnp.asarray(D), 8), V)
    fwd = build_inverted_index(sparsify_topk(torch.from_numpy(D), 8), V,
                               keep_forward=True, device="cpu")
    fwd_j = jr.build_inverted_index(jr.sparsify_topk(jnp.asarray(D), 8), V,
                                    keep_forward=True)
    return {"raw": (raw, raw_j),
            "quantized": (quantize_index(raw), jr.quantize_index(raw_j)),
            "forward": (fwd, fwd_j)}


def _queries():
    nnz = (QUERY_VALS > 0).sum(1).astype(np.int32)
    return (SparseRep(QUERY_VALS, QUERY_IDS, nnz),
            jr.SparseRep(jnp.asarray(QUERY_VALS), jnp.asarray(QUERY_IDS),
                         jnp.asarray(nnz)))


def test_term_rows_is_the_reference_gather_rule():
    ids = torch.tensor([-40, -17, -16, -3, -1, 0, 5, 15, 16, 19, 1000])
    rule = [0, 0, 0, 13, 15, 0, 5, 15, 15, 15, 15]
    assert k45.term_rows(ids, V).tolist() == rule
    table = jnp.arange(V)
    assert np.asarray(table[jnp.asarray(ids.numpy())]).tolist() == rule


# (index, the port's method, the reference's method, score tolerance)
METHODS = {
    "impact": ("raw", "impact", "impact", TOL),
    "fused": ("raw", "fused", "fused", TOL),
    "quantized": ("quantized", "quantized", "quantized", Q_TOL),
    "fused_on_quantized": ("quantized", "fused", "fused", Q_TOL),
    "pruned": ("forward", "pruned", "pruned", TOL),
}


@pytest.mark.parametrize("case", sorted(METHODS))
def test_out_of_range_query_ids_match_the_reference(indexes, case):
    which, method, ref_method, tol = METHODS[case]
    index, index_j = indexes[which]
    q, q_j = _queries()
    v, i = score.retrieve(q, index, K, method=method)
    kw = {"interpret": True} if ref_method == "fused" else {}
    v_j, i_j = jr.retrieve(q_j, index_j, K, method=ref_method, **kw)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("entry", ["impact", "quantized"])
def test_index_entries_take_out_of_range_ids_as_their_windows(indexes,
                                                              entry):
    """The in-place plain versions read the rows the window gathers read:
    an id past V is the last term, a negative one wraps."""
    qi, qv = torch.from_numpy(QUERY_IDS), torch.from_numpy(QUERY_VALS)
    mapped = k45.term_rows(qi, V).int()
    if entry == "impact":
        index = indexes["raw"][0]
        arrays = (index.term_starts, index.term_lens, index.postings_doc,
                  index.postings_val)
        fn = k45.fused_impact_index_topk
    else:
        index = indexes["quantized"][0]
        arrays = (index.term_starts, index.term_lens, index.packed_vals,
                  index.deltas, index.term_lo, index.term_hi)
        fn = k45.fused_quantized_index_topk
    got = fn(qi, qv, *arrays, n_docs=index.n_docs, k=K)
    want = fn(mapped, qv, *arrays, n_docs=index.n_docs, k=K)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _graded_queries(seed, B=4, Q=8):
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.choice(V, size=Q, replace=False)
                    for _ in range(B)]).astype(np.int32)
    vals = rng.uniform(0.05, 3.0, size=(B, Q)).astype(np.float32)
    vals[0, -1] = 0.0
    return SparseRep(torch.from_numpy(vals), torch.from_numpy(ids),
                     torch.from_numpy((vals > 0).sum(1).astype(np.int32)))


@pytest.mark.parametrize("seed", range(3))
def test_impact_scores_equal_the_fused_plain_version_bit_for_bit(indexes,
                                                                 seed):
    index = indexes["raw"][0]
    q = _graded_queries(seed)
    qi, qv = q.indices.int(), q.values.float()
    L = k45.query_lanes(qi, index.term_lens)
    w, docs = k45.index_windows(qi, qv, index.term_starts, index.term_lens,
                                index.postings_doc, index.postings_val, L)
    assert torch.equal(score.impact_scores(q, index),
                       k45.scatter_scores(w, docs, index.n_docs, L))
    got = score.retrieve(q, index, K, method="impact")
    want = k45.fused_impact_index_topk_plain(
        qi, qv, index.term_starts, index.term_lens, index.postings_doc,
        index.postings_val, n_docs=index.n_docs, k=K)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed", range(3))
def test_quantized_scores_equal_the_fused_plain_version_bit_for_bit(
        indexes, seed):
    index = indexes["quantized"][0]
    q = _graded_queries(seed)
    got = score.retrieve(q, index, K, method="quantized")
    want = score.retrieve(q, index, K, method="fused")   # K5's plain version
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert quantized_scores(q, index).shape == (4, index.n_docs)


def test_term_lanes_sum_each_doc_in_term_order():
    """Doc 2 gets 1e8, then 1, then -1e8, one lane in each of three terms:
    in term order f32 gives (1e8 + 1) - 1e8 = 0, where (1e8 - 1e8) + 1
    would give 1. The other docs and a ragged last term score as a loop
    over the lanes does."""
    w = torch.tensor([[1e8, 0.0, 1.0, 0.5, -1e8, 0.25, 2.0]])
    docs = torch.tensor([[2, 0, 2, 1, 2, 1, 3]], dtype=torch.int32)
    got = k45.scatter_scores(w, docs, 4, term_lanes=2)
    want = torch.zeros(4)
    for lane in range(w.shape[1]):
        want[docs[0, lane]] += w[0, lane]
    assert got[0, 2].item() == 0.0
    assert torch.equal(got[0], want)
    # a doc id outside [0, n_docs) scores nothing
    out = k45.scatter_scores(torch.ones((1, 3)),
                             torch.tensor([[-1, 4, 1]], dtype=torch.int32),
                             4, term_lanes=1)
    assert out.tolist() == [[0.0, 1.0, 0.0, 0.0]]
