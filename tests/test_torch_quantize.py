"""The port's quantized index and K5 against the JAX package (CPU).

``quantize_index`` is the JAX build copied, so every array is compared for
equality, dtype included. The decoded scores are the same f32 products
(two roundings each) summed in the same lane order: they agree to 1e-5.
K5's plain version runs against the JAX package's Pallas K5 in interpret
mode on identical numpy windows: ids equal (ties to the lowest doc id),
values to 1e-5 (the Pallas kernel sums a doc's lanes through a one-hot
contraction).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import lsr_impact_corpus
from repro.kernels.impact_score import fused_quantized_topk as jax_k5
from repro.retrieval import SparseRep as JaxRep
from repro.retrieval import build_inverted_index as jax_build
from repro.retrieval import quantize_index as jax_quantize
from repro.retrieval import retrieve as jax_retrieve
from repro.retrieval import sparsify_topk as jax_sparsify
from repro.retrieval.engine.quantize import _fused_q_windows as jax_windows
from repro.retrieval.engine.quantize import quantized_scores as jax_scores
from repro.retrieval.score import _resolve_method as jax_resolve
from repro_torch.data.synthetic import lsr_impact_corpus as port_corpus
from repro_torch.kernels.impact_score import (fused_quantized_topk,
                                              fused_window_bytes)
from repro_torch.retrieval import score
from repro_torch.retrieval.engine.quantize import (_fused_q_windows,
                                                   fused_quantized_retrieve,
                                                   quantize_index,
                                                   quantized_retrieve,
                                                   quantized_scores, to_numpy)
from repro_torch.retrieval.index import build_inverted_index
from repro_torch.retrieval.sparse_rep import SparseRep, sparsify_topk

K = 10
TOL = 1e-5
ARRAYS = ("term_starts", "term_lens", "packed_vals", "deltas", "term_lo",
          "term_hi")
STATICS = ("n_docs", "vocab_size", "max_postings", "n_source_postings")


def _rep_pair(v, i):
    """The same numpy rows as a port rep and a JAX rep."""
    nnz = (v > 0).sum(1).astype(np.int32)
    return SparseRep(v, i, nnz), JaxRep(v, i, nnz)


def _one_term(n_docs, docs, term=3, vocab=8, value=1.5):
    """A corpus where ``docs`` hold ``term`` at ``value``; nothing else."""
    v = np.zeros((n_docs, 2), np.float32)
    i = np.zeros((n_docs, 2), np.int32)
    v[docs, 0] = value
    i[docs, 0] = term
    return _rep_pair(v, i) + (vocab,)


def _graded():
    data = lsr_impact_corpus(n_docs=384, vocab=512, doc_nnz=32,
                             n_queries=6, q_nnz=28)
    d_t = sparsify_topk(torch.from_numpy(data["docs"]), 32)
    d_j = jax_sparsify(jnp.asarray(data["docs"]), 32)
    return d_t, d_j, 512


def _sparse_gaps():
    """Uniformly sparse lists (mean gap far above 255): u16 deltas."""
    rng = np.random.default_rng(7)
    n, vocab, nnz = 20000, 4096, 4
    v = rng.uniform(0.5, 1.5, size=(n, nnz)).astype(np.float32)
    i = np.stack([rng.choice(vocab, size=nnz, replace=False)
                  for _ in range(n)]).astype(np.int32)
    return _rep_pair(v, i) + (vocab,)


def _empty():
    return _rep_pair(np.zeros((3, 4), np.float32),
                     np.zeros((3, 4), np.int32)) + (32,)


CORPORA = {
    "graded": _graded,
    # a dense run and two long jumps: u8 deltas with escape phantoms
    "large_gaps_u8": lambda: _one_term(2000, np.r_[np.arange(100), 800,
                                                   1900]),
    # gaps that are exact multiples of the u8 escape: remainder-0 phantoms
    # share their doc id with the real posting that follows them
    "escape_multiples_u8": lambda: _one_term(
        3000, np.r_[np.arange(40), 39 + 255, 39 + 255 + 510]),
    "sparse_gaps_u16": _sparse_gaps,
    # one u16 list whose gaps are exact multiples of 65535
    "escape_multiples_u16": lambda: _one_term(
        131071 + 1, np.array([0, 65535, 131070])),
    "empty": _empty,
}


@pytest.fixture(scope="module", params=sorted(CORPORA))
def built(request):
    rep_t, rep_j, vocab = CORPORA[request.param]()
    raw = build_inverted_index(rep_t, vocab, device="cpu")
    raw_j = jax_build(rep_j, vocab)
    return {"name": request.param, "raw": raw, "quant": quantize_index(raw),
            "quant_j": jax_quantize(raw_j), "raw_j": raw_j, "vocab": vocab}


def test_quantize_index_equals_jax_build(built):
    q, ref = built["quant"], built["quant_j"]
    for name in ARRAYS:
        got, want = to_numpy(getattr(q, name)), np.asarray(getattr(ref, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in STATICS:
        assert getattr(q, name) == getattr(ref, name), name
    assert q.stats() == ref.stats()
    assert q.memory_bytes() == ref.memory_bytes()


def test_quantize_picks_the_reference_delta_width_and_phantoms(built):
    stats, deltas = built["quant"].stats(), to_numpy(built["quant"].deltas)
    want = {"large_gaps_u8": np.uint8, "escape_multiples_u8": np.uint8,
            "sparse_gaps_u16": np.uint16,
            "escape_multiples_u16": np.uint16}.get(built["name"])
    if want is not None:
        assert deltas.dtype == want
    if built["name"].startswith(("large", "escape")):
        assert stats["phantom_frac"] > 0


def _queries(built, rng, B=3, Q=6):
    """Query reps over terms the corpus holds (and one it does not)."""
    lens = to_numpy(built["raw"].term_lens)
    active = np.flatnonzero(lens) if lens.any() else np.arange(1)
    terms = np.stack([rng.choice(np.r_[active, (active.max() + 1)
                                       % built["vocab"]],
                                 size=min(Q, active.size + 1), replace=False)
                      for _ in range(B)]).astype(np.int32)
    vals = rng.uniform(0.2, 2.0, terms.shape).astype(np.float32)
    vals[0, -1] = 0.0                   # a padded query slot
    return _rep_pair(vals, terms)


def test_quantized_scores_match_jax(built):
    q_t, q_j = _queries(built, np.random.default_rng(1))
    got = quantized_scores(q_t, built["quant"]).numpy()
    want = np.asarray(jax_scores(q_j, built["quant_j"]))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_windows_equal_jax_windows(built):
    q_t, q_j = _queries(built, np.random.default_rng(2))
    for got, want in zip(_fused_q_windows(q_t, built["quant"]),
                         jax_windows(q_j, built["quant_j"])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_k5(wins, n_docs, k):
    # wide doc tiles for large corpora: fewer interpreted grid steps
    v, i = jax_k5(*(jnp.asarray(a) for a in wins), n_docs=n_docs, k=k,
                  block_n=512 if n_docs <= 20000 else 16384, block_w=128,
                  interpret=True)
    return np.asarray(v), np.asarray(i)


def _port_k5(wins, n_docs, k):
    v, i = fused_quantized_topk(*(torch.from_numpy(np.array(a))
                                  for a in wins), n_docs=n_docs, k=k)
    return v.numpy(), i.numpy()


def _assert_same(port, ref):
    np.testing.assert_array_equal(port[1], ref[1])
    np.testing.assert_allclose(port[0], ref[0], rtol=TOL, atol=TOL)


def test_plain_k5_matches_pallas_kernel(built):
    q_t, q_j = _queries(built, np.random.default_rng(3))
    wins = [np.asarray(a) for a in jax_windows(q_j, built["quant_j"])]
    n = built["quant_j"].n_docs
    _assert_same(_port_k5(wins, n, min(K, n)), _jax_k5(wins, n, min(K, n)))


def test_plain_k5_surfaces_escape_phantom_docs():
    """tests/test_kernels_impact.py's phantom case: k covers every
    positive doc, so the long-jump docs must surface at their own ids."""
    rep_t, rep_j, vocab = _one_term(2000, np.r_[np.arange(64), 777, 1901])
    quant_j = jax_quantize(jax_build(rep_j, vocab))
    quant = quantize_index(build_inverted_index(rep_t, vocab, device="cpu"))
    q_t, q_j = _rep_pair(np.ones((1, 1), np.float32),
                         np.full((1, 1), 3, np.int32))
    wins = [np.asarray(a) for a in jax_windows(q_j, quant_j)]
    port = _port_k5(wins, 2000, 70)
    _assert_same(port, _jax_k5(wins, 2000, 70))
    assert {777, 1901} <= set(port[1][0][port[0][0] > 0].tolist())
    v, i = fused_quantized_retrieve(q_t, quant, 70)
    np.testing.assert_array_equal(i.numpy(), port[1])


@pytest.mark.parametrize("seed", range(4))
def test_plain_k5_matches_pallas_on_random_windows(seed):
    """Windows the kernel must read exactly as given: odd starts (the
    nibble parity is the absolute position's), garbage past each term's
    length, empty terms, qv <= 0 columns, phantom codes, repeated docs
    across terms and k above the doc count."""
    rng = np.random.default_rng(seed)
    B, Q, L = 3, 5, 9
    n_docs = int(rng.integers(20, 90))
    byte = rng.integers(0, 256, (B, Q, L)).astype(np.int32)
    gaps = rng.integers(0, 4, (B, Q, L)).astype(np.int32)
    starts = rng.integers(0, 1000, (B, Q)).astype(np.int32)
    lens = rng.integers(0, L + 1, (B, Q)).astype(np.int32)
    lens[0, 0] = 0
    qv = rng.uniform(-0.5, 2.0, (B, Q)).astype(np.float32)
    qv[1, 2] = 0.0
    lo = rng.uniform(0.0, 1.0, (B, Q)).astype(np.float32)
    step = (rng.uniform(0.0, 1.0, (B, Q)) / 14).astype(np.float32)
    wins = (byte, gaps, starts, lens, qv, lo, step)
    k = int(rng.integers(1, n_docs + 8))
    _assert_same(_port_k5(wins, n_docs, k), _jax_k5(wins, n_docs, k))


def test_plain_k5_empty_window_and_k_past_n_docs():
    z3 = np.zeros((2, 3, 0), np.int32)
    z2 = np.zeros((2, 3), np.int32)
    f2 = np.zeros((2, 3), np.float32)
    wins = (z3, z3, z2, z2, f2, f2, f2)
    port = _port_k5(wins, 4, 6)
    np.testing.assert_array_equal(port[1], [[0, 1, 2, 3, 0, 0]] * 2)
    assert (port[0][:, :4] == 0).all() and (port[0][:, 4:] == -1e30).all()
    assert fused_quantized_topk.launches == 0     # the CPU takes the plain


@pytest.mark.parametrize("kw", [
    dict(n_docs=1536, vocab=1536, doc_nnz=32, n_queries=8, q_nnz=28),
    dict(n_docs=96, vocab=256, doc_nnz=16, seed=3),
    dict(n_docs=40, vocab=64, doc_nnz=30, n_queries=2, q_nnz=26, graded=12,
         seed=5, term_jitter=0.2)])
def test_lsr_impact_corpus_identical_to_jax(kw):
    """The port's copy of the acceptance corpus (the card's >= 4x gate
    builds it) gives the JAX package's arrays bit for bit."""
    want, got = lsr_impact_corpus(**kw), port_corpus(**kw)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("kw", [
    dict(n_docs=10, vocab=64, doc_nnz=30, n_queries=1, q_nnz=26),
    dict(n_docs=40, vocab=64, doc_nnz=20, n_queries=2, q_nnz=26)])
def test_lsr_impact_corpus_refuses_as_jax(kw):
    for make in (lsr_impact_corpus, port_corpus):
        with pytest.raises(ValueError, match="need n_docs|planted docs"):
            make(**kw)


def test_compression_at_least_4x():
    """The JAX package's acceptance size: 1536 docs of 32 terms over 1536
    terms is at least 4x smaller quantized, with the reference's ids."""
    data = lsr_impact_corpus(n_docs=1536, vocab=1536, doc_nnz=32,
                             n_queries=8, q_nnz=28)
    raw = build_inverted_index(sparsify_topk(
        torch.from_numpy(data["docs"]), 32), 1536, device="cpu")
    quant = quantize_index(raw)
    assert raw.memory_bytes() / quant.memory_bytes() >= 4.0
    q = sparsify_topk(torch.from_numpy(data["queries"]), 28)
    _, want = jax_retrieve(jax_sparsify(jnp.asarray(data["queries"]), 28),
                           jax_quantize(jax_build(jax_sparsify(
                               jnp.asarray(data["docs"]), 32), 1536)), K,
                           method="quantized")
    _, got = quantized_retrieve(q, quant, K)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_docs", [score.AUTO_FUSED_N - 1,
                                    score.AUTO_FUSED_N])
def test_auto_on_a_quantized_index_resolves_as_in_jax(n_docs):
    rep_t, rep_j, vocab = _one_term(n_docs, np.arange(0, n_docs, 97))
    quant = quantize_index(build_inverted_index(rep_t, vocab, device="cpu"))
    quant_j = jax_quantize(jax_build(rep_j, vocab))
    want = "fused" if n_docs >= score.AUTO_FUSED_N else "quantized"
    assert score.resolve_method("auto", quant) == want
    assert jax_resolve("auto", quant_j) == want
    q_t, q_j = _rep_pair(np.ones((2, 1), np.float32),
                         np.full((2, 1), 3, np.int32))
    v, i = score.retrieve(q_t, quant, K)
    v_q, i_q = score.retrieve(q_t, quant, K, method="quantized")
    np.testing.assert_array_equal(i.numpy(), i_q.numpy())
    _, i_j = jax_retrieve(q_j, quant_j, K, method="quantized")
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))


def test_fused_ids_equal_quantized_ids_on_graded():
    d_t, d_j, vocab = _graded()
    data = lsr_impact_corpus(n_docs=384, vocab=512, doc_nnz=32,
                             n_queries=6, q_nnz=28)
    q = sparsify_topk(torch.from_numpy(data["queries"]), 28)
    quant = quantize_index(build_inverted_index(d_t, vocab, device="cpu"))
    v_f, i_f = score.retrieve(q, quant, K, method="fused")
    v_q, i_q = score.retrieve(q, quant, K, method="quantized")
    np.testing.assert_array_equal(i_f.numpy(), i_q.numpy())
    np.testing.assert_allclose(v_f.numpy(), v_q.numpy(), rtol=TOL, atol=TOL)
    ref = jax_retrieve(jax_sparsify(jnp.asarray(data["queries"]), 28),
                       jax_quantize(jax_build(d_j, vocab)), K,
                       method="fused", interpret=True)
    _assert_same((v_f.numpy(), i_f.numpy()),
                 tuple(np.asarray(a) for a in ref))


@pytest.mark.parametrize("method", ["fused", "auto"])
def test_retrieve_past_k1024_on_a_quantized_index_equals_jax(method):
    """k = 1100 on a 2000-doc QuantizedIndex (K5 on the card, past its old
    limit of 1024): the reference's quantized and fused ids, and values."""
    data = lsr_impact_corpus(n_docs=2000, vocab=512, doc_nnz=32,
                             n_queries=3, q_nnz=28)
    q = sparsify_topk(torch.from_numpy(data["queries"]), 28)
    quant = quantize_index(build_inverted_index(
        sparsify_topk(torch.from_numpy(data["docs"]), 32), 512,
        device="cpu"))
    q_j = jax_sparsify(jnp.asarray(data["queries"]), 28)
    quant_j = jax_quantize(jax_build(jax_sparsify(jnp.asarray(data["docs"]),
                                                  32), 512))
    ref = jax_retrieve(q_j, quant_j, 1100, method=method,
                       **({"interpret": True} if method == "fused" else {}))
    _, want = jax_retrieve(q_j, quant_j, 1100, method="quantized")
    v, i = score.retrieve(q, quant, 1100, method=method)
    assert i.shape == (3, 1100)
    np.testing.assert_array_equal(np.asarray(ref[1]), np.asarray(want))
    _assert_same((v.numpy(), i.numpy()), tuple(np.asarray(a) for a in ref))


def test_k5_arguments_checked_without_a_card():
    """Tensors that are not on the CPU go to K5's wrapper: any k >= 1
    (past the old limit of 1024 too) passes its checks and reaches the
    device check, which meta tensors fail."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    wins = (meta((2, 3, 5), torch.int32), meta((2, 3, 5), torch.int32),
            *(meta((2, 3), t) for t in (torch.int32, torch.int32,
                                        torch.float32, torch.float32,
                                        torch.float32)))
    with pytest.raises(ValueError, match="k must be >= 1"):
        fused_quantized_topk(*wins, n_docs=2000, k=0)
    for k in (1024, 1025, 1100, 2000, 50000):
        with pytest.raises(ValueError, match="one CUDA device"):
            fused_quantized_topk(*wins, n_docs=2000, k=k)


def test_quantized_method_checks_its_corpus_and_kwargs():
    d_t, _, vocab = _graded()
    raw = build_inverted_index(d_t, vocab, device="cpu")
    quant = quantize_index(raw)
    q = SparseRep(*(a[:2] for a in (d_t.values, d_t.indices, d_t.nnz)))
    with pytest.raises(ValueError, match="needs a QuantizedIndex"):
        score.retrieve(q, raw, 3, method="quantized")
    with pytest.raises(ValueError, match="needs an InvertedIndex corpus"):
        score.retrieve(q, quant, 3, method="impact")
    with pytest.raises(ValueError, match="does not accept block_n"):
        score.retrieve(q, quant, 3, method="fused", block_n=64)
    assert "quantized" in score.METHODS
    assert score.METHOD_KWARGS["quantized"] == frozenset()


def test_u4_window_bytes():
    assert fused_window_bytes(8, 64, 300, "u4") == 8 * 64 * 300 * 8 + \
        8 * 64 * 5 * 4
    with pytest.raises(ValueError, match="unknown fused variant"):
        fused_window_bytes(1, 1, 1, "u8")
