"""The port's sparse reps, inverted index and ``retrieve`` against the JAX
package on the same numpy inputs (CPU).

Reps, index arrays and retrieved ids are compared for equality: the
port keeps the reference's tie rule (lowest id first), so there is no
tolerance on ids; scores agree to 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import retrieval as jr
from repro.retrieval import score as jscore
from repro_torch.retrieval import score
from repro_torch.retrieval.index import build_inverted_index
from repro_torch.retrieval.sparse_rep import (SparseRep, sparsify_threshold,
                                              sparsify_topk, split_rows,
                                              stack_rows, truncate_width)

V = 128
TOL = 1e-6


def _sparse_mat(rng, n, nnz, vocab=V):
    m = np.zeros((n, vocab), np.float32)
    for r in range(n):
        cols = rng.choice(vocab, size=nnz, replace=False)
        m[r, cols] = rng.uniform(0.1, 2.0, size=nnz)
    return m


@pytest.fixture
def corpus():
    rng = np.random.default_rng(0)
    return _sparse_mat(rng, 5, 8), _sparse_mat(rng, 40, 10)


def _np(rep):
    return [np.asarray(a) for a in (rep.values, rep.indices, rep.nnz)]


def _assert_rep_equal(port, ref):
    for a, b in zip(_np(port), _np(ref)):
        np.testing.assert_array_equal(a, b)


def test_sparsify_topk_bf16_ties_keep_the_lower_id():
    """bf16 rounding makes equal values; the lower vocab id is kept, as
    with merge_topk (an argsort oracle may keep the other one)."""
    x = np.zeros((2, 64), np.float32)
    x[0, [5, 9, 40, 41]] = [1.390625, 1.3906251, 1.39, 0.5]
    x[1, [60, 2, 30]] = [2.0, 2.0, 2.0]
    xb = torch.from_numpy(x).to(torch.bfloat16)
    rep = sparsify_topk(xb, 2)
    ref = jr.sparsify_topk(jnp.asarray(x).astype(jnp.bfloat16), 2, tile=16)
    _assert_rep_equal(rep, ref)
    np.testing.assert_array_equal(rep.indices.numpy(), [[5, 9], [2, 30]])


@pytest.mark.parametrize("k", [4, 8, 12, 200])
def test_sparsifiers_match_jax(corpus, k):
    Q, D = corpus
    _assert_rep_equal(sparsify_topk(torch.from_numpy(D), k),
                      jr.sparsify_topk(jnp.asarray(D), k))
    _assert_rep_equal(
        sparsify_threshold(torch.from_numpy(D), 0.5, max_nnz=k),
        jr.sparsify_threshold(jnp.asarray(D), 0.5, max_nnz=k))


def test_rep_round_trips(corpus):
    _, D = corpus
    rep = sparsify_topk(torch.from_numpy(D), 12)
    np.testing.assert_allclose(rep.to_dense(V).numpy(), D, atol=TOL)
    back = stack_rows(split_rows(rep))
    np.testing.assert_allclose(back.to_dense(V).numpy(), D, atol=TOL)
    narrow = truncate_width(rep, 5)
    ref = jr.truncate_width(jr.sparsify_topk(jnp.asarray(D), 12), 5)
    _assert_rep_equal(narrow, ref)


def test_build_inverted_index_equals_jax(corpus):
    _, D = corpus
    idx = build_inverted_index(sparsify_topk(torch.from_numpy(D), 16), V,
                               device="cpu")
    ref = jr.build_inverted_index(jr.sparsify_topk(jnp.asarray(D), 16), V)
    for name in ("term_starts", "term_lens", "postings_doc",
                 "postings_val"):
        np.testing.assert_array_equal(getattr(idx, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert (idx.n_docs, idx.vocab_size, idx.max_postings) == \
        (ref.n_docs, ref.vocab_size, ref.max_postings)
    assert idx.posting_percentiles == ref.posting_percentiles


def test_empty_corpus_keeps_one_posting():
    rep = sparsify_topk(torch.zeros((3, V)), 4)
    idx = build_inverted_index(rep, V, device="cpu")
    assert idx.n_postings == 1 and idx.max_postings == 1


@pytest.mark.parametrize("method", ["auto", "impact", "fused"])
def test_retrieve_ids_equal_jax(corpus, method):
    Q, D = corpus
    q = sparsify_topk(torch.from_numpy(Q), 8)
    idx = build_inverted_index(sparsify_topk(torch.from_numpy(D), 16), V,
                               device="cpu")
    jq = jr.sparsify_topk(jnp.asarray(Q), 8)
    jidx = jr.build_inverted_index(jr.sparsify_topk(jnp.asarray(D), 16), V)
    v, i = score.retrieve(q, idx, 7, method=method)
    kw = {"interpret": True} if method == "fused" else {}
    jv, ji = jr.retrieve(jq, jidx, 7, method=method, **kw)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=TOL,
                               atol=TOL)
    # k is clamped to the corpus size
    assert score.retrieve(q, idx, 500, method=method)[1].shape == (5, 40)


def test_auto_resolves_to_fused_at_the_jax_threshold():
    assert score.AUTO_FUSED_N == jscore.AUTO_FUSED_N
    n = score.AUTO_FUSED_N
    rng = np.random.default_rng(1)
    vals = rng.integers(1, 9, (n, 1)).astype(np.float32) / 8
    ids = rng.integers(0, V, (n, 1)).astype(np.int32)
    docs = SparseRep(vals, ids, np.ones(n, np.int32))
    idx = build_inverted_index(docs, V, device="cpu")
    assert score.resolve_method("auto", idx) == "fused"
    small = build_inverted_index(SparseRep(vals[:10], ids[:10],
                                           np.ones(10, np.int32)), V,
                                 device="cpu")
    assert score.resolve_method("auto", small) == "impact"
    q = SparseRep(np.asarray([[1.0, 0.5]], np.float32),
                  ids[:2].reshape(1, 2), np.asarray([2], np.int32))
    v, i = score.retrieve(q, idx, 10)
    jv, ji = jr.retrieve(jr.SparseRep(*(jnp.asarray(a) for a in (
        q.values, q.indices, q.nnz))), jr.build_inverted_index(
        jr.SparseRep(*(jnp.asarray(a) for a in (docs.values, docs.indices,
                                                 docs.nnz))), V),
        10, method="fused", interpret=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_retrieve_rejects_stray_kwargs_and_unported_methods(corpus):
    Q, D = corpus
    q = sparsify_topk(torch.from_numpy(Q), 8)
    idx = build_inverted_index(sparsify_topk(torch.from_numpy(D), 16), V,
                               device="cpu")
    for method in ("auto", "impact", "fused"):
        with pytest.raises(ValueError, match="does not accept block_n"):
            score.retrieve(q, idx, 3, method=method, block_n=64)
    # None-valued knobs are "not passed", as in the JAX dispatcher
    score.retrieve(q, idx, 3, method="fused", interpret=None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        score.retrieve(q, idx, 3, method="pruned")
    with pytest.raises(ValueError, match="unknown retrieval method"):
        score.retrieve(q, idx, 3, method="bm25")
    with pytest.raises(ValueError, match="SparseRep queries"):
        score.retrieve(torch.from_numpy(Q), idx, 3)
