"""The port's sparse reps, inverted index and ``retrieve`` against the JAX
package on the same numpy inputs (CPU).

Reps, index arrays and retrieved ids are compared for equality: the
port keeps the reference's tie rule (lowest id first), so there is no
tolerance on ids; index scores agree to 1e-6, and dense-corpus scores
(``dense``, ``streaming``: the same products summed over the whole
vocabulary in another order) to 1e-5.
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
DENSE_TOL = 1e-5


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
    # the dense-corpus methods take none either
    for method in ("auto", "dense", "streaming"):
        for knob in ("block_b", "block_n", "interpret"):
            with pytest.raises(ValueError, match=f"does not accept {knob}"):
                score.retrieve(q, torch.from_numpy(D), 3, method=method,
                               **{knob: 8})
    # None-valued knobs are "not passed", as in the JAX dispatcher
    score.retrieve(q, idx, 3, method="fused", interpret=None)
    score.retrieve(q, torch.from_numpy(D), 3, method="streaming",
                   block_n=None)
    # pruned runs on an index with forward rows and equals impact there
    # (values to 1e-5: tier 2 sums each candidate over K in another order)
    eng = build_inverted_index(sparsify_topk(torch.from_numpy(D), 16), V,
                               keep_forward=True, device="cpu")
    v_p, i_p = score.retrieve(q, eng, 3, method="pruned")
    v_i, i_i = score.retrieve(q, eng, 3, method="impact")
    assert torch.equal(i_p, i_i)
    torch.testing.assert_close(v_p, v_i, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="needs a ShardedIndex corpus"):
        score.retrieve(q, idx, 3, method="sharded")
    with pytest.raises(ValueError, match="unknown retrieval method"):
        score.retrieve(q, idx, 3, method="bm25")
    with pytest.raises(ValueError, match="SparseRep queries"):
        score.retrieve(torch.from_numpy(Q), idx, 3)


def _queries(Q, sparse):
    if sparse:
        return sparsify_topk(torch.from_numpy(Q), 8), \
            jr.sparsify_topk(jnp.asarray(Q), 8)
    return torch.from_numpy(Q), jnp.asarray(Q)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense_q", "sparse_q"])
@pytest.mark.parametrize("method", ["dense", "streaming", "auto"])
def test_dense_corpus_ids_equal_jax(corpus, method, sparse):
    Q, D = corpus
    q, jq = _queries(Q, sparse)
    v, i = score.retrieve(q, torch.from_numpy(D), 7, method=method)
    kw = {"interpret": True} if method == "streaming" else {}
    jv, ji = jr.retrieve(jq, jnp.asarray(D), 7, method=method, **kw)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=DENSE_TOL,
                               atol=DENSE_TOL)
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    # k is clamped to the corpus size
    assert score.retrieve(q, torch.from_numpy(D), 500,
                          method=method)[1].shape == (5, 40)


def test_auto_resolves_dense_corpora_at_the_jax_threshold():
    assert score.AUTO_STREAMING_N == jscore.AUTO_STREAMING_N
    n = score.AUTO_STREAMING_N
    for rows, want in ((n, "streaming"), (n - 1, "dense")):
        assert score.resolve_method("auto", torch.zeros((rows, 4))) == want
        assert jscore._resolve_method("auto", jnp.zeros((rows, 4))) == want
    rng = np.random.default_rng(2)
    C = rng.standard_normal((n, 12)).astype(np.float32)
    q = rng.standard_normal((3, 12)).astype(np.float32)
    v, i = score.retrieve(torch.from_numpy(q), torch.from_numpy(C), 10)
    jv, ji = jr.retrieve(jnp.asarray(q), jnp.asarray(C), 10,
                         interpret=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=DENSE_TOL,
                               atol=DENSE_TOL)


@pytest.mark.parametrize("method", ["auto", "streaming"])
def test_retrieve_past_k256_on_a_dense_corpus_equals_jax_auto(method):
    """k = 300 on a corpus at the streaming threshold: the reference's
    ``auto`` returns (2, 300); the port's streaming path (K6 on the card,
    past its old limit of 256) gives its ids and values."""
    rng = np.random.default_rng(5)
    C = rng.standard_normal((score.AUTO_STREAMING_N, 16)).astype(np.float32)
    q = rng.standard_normal((2, 16)).astype(np.float32)
    assert score.resolve_method(method, torch.from_numpy(C)) == "streaming"
    v, i = score.retrieve(torch.from_numpy(q), torch.from_numpy(C), 300,
                          method=method)
    jv, ji = jr.retrieve(jnp.asarray(q), jnp.asarray(C), 300, method="auto")
    assert i.shape == np.asarray(ji).shape == (2, 300)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=DENSE_TOL,
                               atol=DENSE_TOL)


@pytest.mark.parametrize("method", ["dense", "streaming"])
def test_retrieve_on_a_bf16_dense_corpus_equals_jax(method):
    """A bf16 corpus is scored as the reference scores it, cast to f32."""
    rng = np.random.default_rng(6)
    C = torch.from_numpy(rng.standard_normal((300, 24)).astype(
        np.float32)).to(torch.bfloat16)
    q = rng.standard_normal((3, 24)).astype(np.float32)
    v, i = score.retrieve(torch.from_numpy(q), C, 12, method=method)
    kw = {"interpret": True} if method == "streaming" else {}
    jv, ji = jr.retrieve(jnp.asarray(q), jnp.asarray(C.float().numpy(),
                                                     dtype=jnp.bfloat16),
                         12, method=method, **kw)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=DENSE_TOL,
                               atol=DENSE_TOL)


def test_parity_impact_fused_dense_streaming(corpus):
    """The JAX package's acceptance parity (tests/test_retrieval.py), in
    the port: the four scoring paths give the same ids from the same
    SparseRep / dense inputs, and the JAX package's ids."""
    Q, D = corpus
    q_rep = sparsify_threshold(torch.from_numpy(Q), 0.0, max_nnz=16)
    d_rep = sparsify_threshold(torch.from_numpy(D), 0.0, max_nnz=16)
    index = build_inverted_index(d_rep, V, device="cpu")
    Dt = torch.from_numpy(D)
    got = {"dense": score.retrieve(torch.from_numpy(Q), Dt, 7,
                                   method="dense"),
           "streaming": score.retrieve(q_rep, Dt, 7, method="streaming"),
           "impact": score.retrieve(q_rep, index, 7, method="impact"),
           "fused": score.retrieve(q_rep, index, 7, method="fused")}
    jv, ji = jr.retrieve(jnp.asarray(Q), jnp.asarray(D), 7, method="dense")
    for name, (v, i) in got.items():
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji),
                                      err_msg=name)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv),
                                   rtol=DENSE_TOL, atol=DENSE_TOL,
                                   err_msg=name)


def _message(fn, *args, **kw):
    with pytest.raises(ValueError) as err:
        fn(*args, **kw)
    return str(err.value)


def test_mismatched_query_and_corpus_kinds_raise_as_in_jax(corpus):
    Q, D = corpus
    q, jq = _queries(Q, True)
    idx = build_inverted_index(sparsify_topk(torch.from_numpy(D), 16), V,
                               device="cpu")
    jidx = jr.build_inverted_index(jr.sparsify_topk(jnp.asarray(D), 16), V)
    Dt, jD = torch.from_numpy(D), jnp.asarray(D)
    for method in ("impact", "fused"):
        port = _message(score.retrieve, torch.from_numpy(Q), Dt, 3,
                        method=method)
        assert "needs SparseRep queries" in port
        assert port == _message(jr.retrieve, jnp.asarray(Q), jD, 3,
                                method=method)
        assert "needs an InvertedIndex" in _message(
            score.retrieve, q, Dt, 3, method=method)
    assert _message(score.retrieve, q, Dt, 3, method="impact") == \
        _message(jr.retrieve, jq, jD, 3, method="impact")
    for method in ("dense", "streaming"):
        port = _message(score.retrieve, q, idx, 3, method=method)
        assert "needs a dense (N, V) corpus matrix; got InvertedIndex" in port
        assert port == _message(jr.retrieve, jq, jidx, 3, method=method)
    assert {"dense", "streaming"} <= set(score.METHODS)
