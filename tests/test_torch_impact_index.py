"""K4 and K5 reading an index in place (the port's index entries, their
plain versions on the CPU) against the JAX package's ``fused`` method, whose
Pallas kernels run in interpret mode, on the same numpy corpora.

Ids must be identical (ties to the lowest doc id). Values agree to 1e-6 for
K4 (the same f32 products; the Pallas kernel sums a doc's lanes through a
one-hot contraction, the port in term order) and 1e-5 for K5 (the decode
is exact against the same f16-rounded bounds). The index entries must also
give the window entries' results on the same query's windows, bit for bit,
whatever the stored dtypes (u8/u16 deltas, u16/i32 term lengths).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import lsr_impact_corpus
from repro.kernels.impact_score import fused_impact_topk as jax_k4
from repro.kernels.impact_score import fused_quantized_topk as jax_k5
from repro.retrieval import SparseRep as JaxRep
from repro.retrieval import build_inverted_index as jax_build
from repro.retrieval import quantize_index as jax_quantize
from repro.retrieval.engine.quantize import _fused_q_windows as jax_q_windows
from repro.retrieval.score import _fused_windows as jax_windows
from repro_torch.kernels import impact_score as k45
from repro_torch.retrieval.engine.quantize import (fused_quantized_retrieve,
                                                   quantize_index)
from repro_torch.retrieval.index import build_inverted_index
from repro_torch.retrieval.score import fused_retrieve
from repro_torch.retrieval.sparse_rep import SparseRep, query_columns

K = 10
TOL_K4 = 1e-6
TOL_K5 = 1e-5


def _rep_pair(v, i):
    nnz = (v > 0).sum(1).astype(np.int32)
    return SparseRep(v, i, nnz), JaxRep(v, i, nnz)


def _graded(n_docs=384):
    data = lsr_impact_corpus(n_docs=n_docs, vocab=512, doc_nnz=32,
                             n_queries=6, q_nnz=28)
    i = np.argsort(-data["docs"], axis=1, kind="stable")[:, :32]
    v = np.take_along_axis(data["docs"], i, axis=1).astype(np.float32)
    return _rep_pair(v, i.astype(np.int32)) + (512,)


def _one_term(n_docs, docs, term=3, vocab=8, value=1.5):
    v = np.zeros((n_docs, 2), np.float32)
    i = np.zeros((n_docs, 2), np.int32)
    v[docs, 0] = value
    i[docs, 0] = term
    return _rep_pair(v, i) + (vocab,)


def _sparse_gaps():
    rng = np.random.default_rng(7)
    n, vocab, nnz = 20000, 4096, 4
    v = rng.uniform(0.5, 1.5, size=(n, nnz)).astype(np.float32)
    i = np.stack([rng.choice(vocab, size=nnz, replace=False)
                  for _ in range(n)]).astype(np.int32)
    return _rep_pair(v, i) + (vocab,)


CORPORA = {
    "graded": _graded,
    # u8 deltas with escape phantoms; remainder-0 phantoms sharing a doc
    "large_gaps_u8": lambda: _one_term(2000, np.r_[np.arange(100), 800,
                                                   1900]),
    "escape_multiples_u8": lambda: _one_term(
        3000, np.r_[np.arange(40), 39 + 255, 39 + 255 + 510]),
    "sparse_gaps_u16": _sparse_gaps,
    "escape_multiples_u16": lambda: _one_term(
        131071 + 1, np.array([0, 65535, 131070])),
}


@pytest.fixture(scope="module", params=sorted(CORPORA))
def built(request):
    rep_t, rep_j, vocab = CORPORA[request.param]()
    raw = build_inverted_index(rep_t, vocab, device="cpu")
    raw_j = jax_build(rep_j, vocab)
    return {"name": request.param, "raw": raw, "raw_j": raw_j,
            "quant": quantize_index(raw), "quant_j": jax_quantize(raw_j),
            "vocab": vocab}


def _queries(built, rng, B=4, Q=6):
    """Query reps over terms the corpus holds and one it does not, with a
    padded slot, a term of negative weight and an empty last row."""
    lens = built["raw"].term_lens.numpy()
    active = np.flatnonzero(lens)
    pool = np.r_[active, (active.max() + 1) % built["vocab"]]
    terms = np.stack([rng.choice(pool, size=min(Q, pool.size),
                                 replace=False)
                      for _ in range(B)]).astype(np.int32)
    vals = rng.uniform(0.2, 2.0, terms.shape).astype(np.float32)
    vals[0, -1] = 0.0                   # a padded query slot
    if terms.shape[1] > 1:
        vals[1, 0] = -0.7               # weight <= 0: skipped
    vals[-1] = 0.0                      # an empty query row
    return _rep_pair(vals, terms)


def _k4_args(q, raw):
    return (*query_columns(q, "cpu"), raw.term_starts, raw.term_lens,
            raw.postings_doc, raw.postings_val)


def _k5_args(q, quant):
    return (*query_columns(q, "cpu"), quant.term_starts, quant.term_lens,
            quant.packed_vals, quant.deltas, quant.term_lo, quant.term_hi)


def _numpy(pair):
    return tuple(np.asarray(a) for a in pair)


def _jax_fused(q_j, corpus_j, k, *, quantized):
    """The JAX package's fused kernel (Pallas, interpret mode) on its own
    windows of ``corpus_j``; wide doc tiles for large corpora (fewer
    interpreted grid steps)."""
    n = corpus_j.n_docs
    blocks = dict(block_n=512 if n <= 20000 else 16384, block_w=128,
                  interpret=True)
    if quantized:
        return _numpy(jax_k5(*jax_q_windows(q_j, corpus_j), n_docs=n, k=k,
                             **blocks))
    return _numpy(jax_k4(*jax_windows(q_j, corpus_j), n_docs=n, k=k,
                         **blocks))


def _assert_same(port, ref, tol):
    np.testing.assert_array_equal(port[1], ref[1])
    np.testing.assert_allclose(port[0], ref[0], rtol=tol, atol=tol)


def test_k4_index_entry_matches_jax_fused(built):
    q_t, q_j = _queries(built, np.random.default_rng(1))
    raw = built["raw"]
    k = min(K, raw.n_docs)
    got = k45.fused_impact_index_topk(*_k4_args(q_t, raw), n_docs=raw.n_docs,
                                      k=k)
    _assert_same(_numpy(got), _jax_fused(q_j, built["raw_j"], k,
                                         quantized=False), TOL_K4)


def test_k5_index_entry_matches_jax_fused(built):
    q_t, q_j = _queries(built, np.random.default_rng(2))
    quant = built["quant"]
    k = min(K, quant.n_docs)
    got = k45.fused_quantized_index_topk(
        *_k5_args(q_t, quant), n_docs=quant.n_docs, k=k)
    _assert_same(_numpy(got), _jax_fused(q_j, built["quant_j"], k,
                                         quantized=True), TOL_K5)


def test_index_entries_equal_window_entries(built):
    """The index entries and the window entries on the same query's
    windows: the same bits, for K4 and K5."""
    q_t, _ = _queries(built, np.random.default_rng(3))
    raw, quant = built["raw"], built["quant"]
    k = min(K, raw.n_docs)
    a4 = _k4_args(q_t, raw)
    got = k45.fused_impact_index_topk(*a4, n_docs=raw.n_docs, k=k)
    w, docs = k45.index_windows(*a4, raw.max_postings)
    want = k45.fused_impact_topk(w, docs, n_docs=raw.n_docs, k=k,
                                 term_lanes=raw.max_postings)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    a5 = _k5_args(q_t, quant)
    got = k45.fused_quantized_index_topk(*a5, n_docs=quant.n_docs, k=k)
    want = k45.fused_quantized_topk(
        *k45.quantized_index_windows(*a5, quant.max_postings),
        n_docs=quant.n_docs, k=k)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("kind", ["k4", "k5"])
def test_plain_width_is_the_querys_longest_list(built, kind):
    """The index entries' plain versions gather windows as wide as the
    query's longest list: wider windows (past the index's longest list)
    give the same bits, and an empty query takes a width of 1."""
    q_t, _ = _queries(built, np.random.default_rng(8))
    idx = built["raw"] if kind == "k4" else built["quant"]
    args = (_k4_args if kind == "k4" else _k5_args)(q_t, idx)
    lens = idx.term_lens.int()[args[0].long()]   # expanded lists for K5
    assert k45.query_lanes(args[0], idx.term_lens) == max(1, int(lens.max()))
    assert k45.query_lanes(args[0][:, :0], idx.term_lens) == 1
    k = min(K, idx.n_docs)
    wide = idx.max_postings + 9
    if kind == "k4":
        got = k45.fused_impact_index_topk(*args, n_docs=idx.n_docs, k=k)
        want = k45.fused_impact_topk(*k45.index_windows(*args, wide),
                                     n_docs=idx.n_docs, k=k,
                                     term_lanes=wide)
    else:
        got = k45.fused_quantized_index_topk(*args, n_docs=idx.n_docs, k=k)
        want = k45.fused_quantized_topk(
            *k45.quantized_index_windows(*args, wide), n_docs=idx.n_docs,
            k=k)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_quantized_windows_equal_jax_windows(built):
    q_t, q_j = _queries(built, np.random.default_rng(4))
    quant = built["quant"]
    got = k45.quantized_index_windows(*_k5_args(q_t, quant),
                                      quant.max_postings)
    for a, b in zip(got, jax_q_windows(q_j, built["quant_j"])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_k5_index_entry_takes_i32_term_lens(built):
    """The same QuantizedIndex with its term lengths stored as i32 (the
    build's type for lists of 2**16 postings or more): the same result."""
    quant = built["quant"]
    assert quant.term_lens.dtype == torch.uint16
    wide = dataclasses.replace(
        quant, term_lens=(quant.term_lens.view(torch.int16).int() & 0xFFFF))
    q_t, _ = _queries(built, np.random.default_rng(5))
    k = min(K, quant.n_docs)
    got = [k45.fused_quantized_index_topk(
        *_k5_args(q_t, idx), n_docs=idx.n_docs, k=k)
        for idx in (quant, wide)]
    assert all(torch.equal(x, y) for x, y in zip(*got))


def test_deltas_u8_and_u16_are_both_covered(built):
    want = {"large_gaps_u8": torch.uint8, "escape_multiples_u8": torch.uint8,
            "sparse_gaps_u16": torch.uint16,
            "escape_multiples_u16": torch.uint16}.get(built["name"])
    if want is not None:
        assert built["quant"].deltas.dtype == want
        assert built["quant"].n_postings > built["quant"].n_source_postings \
            or built["name"] == "sparse_gaps_u16"


def test_escape_phantom_docs_surface_in_place():
    """k covers every positive doc: the long-jump docs of a u8 list with
    phantoms surface at their own ids, as the JAX kernel finds them."""
    rep_t, rep_j, vocab = _one_term(2000, np.r_[np.arange(64), 777, 1901])
    quant = quantize_index(build_inverted_index(rep_t, vocab, device="cpu"))
    quant_j = jax_quantize(jax_build(rep_j, vocab))
    q_t, q_j = _rep_pair(np.ones((1, 1), np.float32),
                         np.full((1, 1), 3, np.int32))
    got = _numpy(k45.fused_quantized_index_topk(
        *_k5_args(q_t, quant), n_docs=2000, k=70))
    wins = [jnp.asarray(a) for a in jax_q_windows(q_j, quant_j)]
    ref = _numpy(jax_k5(*wins, n_docs=2000, k=70, block_n=512, block_w=128,
                        interpret=True))
    _assert_same(got, ref, TOL_K5)
    assert {777, 1901} <= set(got[1][0][got[0][0] > 0].tolist())


@pytest.mark.parametrize("kind", ["k4", "k5"])
def test_index_entries_past_k1024_and_n_docs(kind):
    """k = 1100 on a 2000-doc graded corpus (a third of the docs score 0:
    the tail is the lowest-id ties) and k past n_docs on a small one (the
    tail is (NEG_INF, 0)): the JAX kernels' results."""
    rep_t, rep_j, vocab = _graded(2000)
    q_t, q_j = _rep_pair(*(np.asarray(a)[:3] for a in (rep_t.values,
                                                       rep_t.indices)))
    raw = build_inverted_index(rep_t, vocab, device="cpu")
    raw_j = jax_build(rep_j, vocab)
    for n_docs, k in ((2000, 1100), (2000, 2003)):
        if kind == "k4":
            got = k45.fused_impact_index_topk(
                *_k4_args(q_t, raw), n_docs=n_docs, k=k)
            w, docs = jax_windows(q_j, raw_j)
            ref = jax_k4(w, docs, n_docs=n_docs, k=k, block_n=512,
                         block_w=128, interpret=True)
            tol = TOL_K4
        else:
            quant = quantize_index(raw)
            got = k45.fused_quantized_index_topk(
                *_k5_args(q_t, quant), n_docs=n_docs, k=k)
            wins = jax_q_windows(q_j, jax_quantize(raw_j))
            ref = jax_k5(*wins, n_docs=n_docs, k=k, block_n=512,
                         block_w=128, interpret=True)
            tol = TOL_K5
        got, ref = _numpy(got), _numpy(ref)
        assert got[1].shape == (3, k)
        _assert_same(got, ref, tol)
    assert (got[0][:, 2000:] == -1e30).all() and (got[1][:, 2000:] == 0).all()


def test_window_batch_read_as_an_index_gives_the_window_result():
    """The kernel reads a (B, Q * L) window batch as an index whose term
    (b, t) starts at (b * Q + t) * L, holds L lanes and has weight 1 (an
    exact product): that index, through the index entry, gives the window
    entry's result."""
    rng = np.random.default_rng(9)
    B, Q, L, n_docs = 3, 5, 7, 40
    docs = np.stack([np.stack([rng.permutation(n_docs)[:L]
                               for _ in range(Q)]) for _ in range(B)])
    w = (rng.integers(0, 9, (B, Q, L)) / 8).astype(np.float32)
    w_t = torch.from_numpy(w.reshape(B, -1))
    d_t = torch.from_numpy(docs.reshape(B, -1).astype(np.int32))
    term = np.arange(B * Q, dtype=np.int32)
    got = k45.fused_impact_index_topk(
        torch.from_numpy(term.reshape(B, Q)), torch.ones((B, Q)),
        torch.from_numpy(term * L), torch.full((B * Q,), L,
                                               dtype=torch.int32),
        d_t.view(-1), w_t.view(-1), n_docs=n_docs, k=12)
    want = k45.fused_impact_topk(w_t, d_t, n_docs=n_docs, k=12, term_lanes=L)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_term_order_scatter_equals_one_pass_on_the_cpu():
    rng = np.random.default_rng(11)
    w = torch.from_numpy(rng.uniform(0, 1, (4, 30)).astype(np.float32))
    d = torch.from_numpy(rng.integers(-2, 25, (4, 30)).astype(np.int32))
    assert torch.equal(k45.scatter_scores(w, d, 20, term_lanes=30),
                       k45.scatter_scores(w, d, 20, term_lanes=6))


def test_fused_retrievers_take_the_index_entries_on_the_cpu(built):
    """``fused_retrieve`` and ``fused_quantized_retrieve`` go through the
    index entries (their plain versions here: no launch is counted)."""
    q_t, q_j = _queries(built, np.random.default_rng(6))
    before = (k45.fused_impact_index_topk.launches,
              k45.fused_quantized_index_topk.launches)
    k = min(K, built["raw"].n_docs)
    for got, corpus, quantized in (
            (fused_retrieve(q_t, built["raw"], K), built["raw_j"], False),
            (fused_quantized_retrieve(q_t, built["quant"], K),
             built["quant_j"], True)):
        _assert_same(_numpy(got), _jax_fused(q_j, corpus, k,
                                             quantized=quantized), TOL_K5)
    assert (k45.fused_impact_index_topk.launches,
            k45.fused_quantized_index_topk.launches) == before


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta_k4(**dtypes):
    d = {"q_idx": torch.int32, "q_val": torch.float32,
         "term_starts": torch.int32, "term_lens": torch.int32,
         "postings_doc": torch.int32, "postings_val": torch.float32,
         **dtypes}
    return (_meta((2, 4), d["q_idx"]), _meta((2, 4), d["q_val"]),
            _meta((50,), d["term_starts"]), _meta((50,), d["term_lens"]),
            _meta((300,), d["postings_doc"]),
            _meta((300,), d["postings_val"]))


def _meta_k5(**dtypes):
    d = {"q_idx": torch.int32, "q_val": torch.float32,
         "term_starts": torch.int32, "term_lens": torch.uint16,
         "packed_vals": torch.uint8, "deltas": torch.uint16,
         "term_lo": torch.float16, "term_hi": torch.float16, **dtypes}
    return (_meta((2, 4), d["q_idx"]), _meta((2, 4), d["q_val"]),
            _meta((50,), d["term_starts"]), _meta((50,), d["term_lens"]),
            _meta((150,), d["packed_vals"]), _meta((300,), d["deltas"]),
            _meta((50,), d["term_lo"]), _meta((50,), d["term_hi"]))


def _meta_ceiling(**dtypes):
    """K4's ceiling entry: term_ubs (V,) f32 in place of postings_val."""
    d = {"term_ubs": torch.float32, **dtypes}
    return _meta_k4(**{k: v for k, v in dtypes.items()
                       if k != "term_ubs"})[:5] + (_meta((50,),
                                                         d["term_ubs"]),)


@pytest.mark.parametrize("entry,make", [
    (k45.fused_impact_index_topk, _meta_k4),
    (k45.fused_quantized_index_topk, _meta_k5),
    (k45.fused_ceiling_index_topk, _meta_ceiling)])
def test_index_entry_arguments_checked_without_a_card(entry, make):
    """Tensors that are not on the CPU go to the kernel's wrapper: any
    k >= 1 passes its checks and reaches the device check, which meta
    tensors fail; bad k and n_docs raise first."""
    args = make()
    with pytest.raises(ValueError, match="k must be >= 1"):
        entry(*args, n_docs=2000, k=0)
    with pytest.raises(ValueError, match="n_docs must be >= 1"):
        entry(*args, n_docs=0, k=5)
    for k in (1, 1024, 1025, 2000, 50000):
        with pytest.raises(ValueError, match="one CUDA device"):
            entry(*args, n_docs=2000, k=k)
    assert entry.launches == 0


@pytest.mark.parametrize("entry,make,dtypes", [
    (k45.fused_impact_index_topk, _meta_k4, {"term_lens": torch.int64}),
    (k45.fused_impact_index_topk, _meta_k4,
     {"postings_val": torch.float16}),
    (k45.fused_quantized_index_topk, _meta_k5, {"deltas": torch.int32}),
    (k45.fused_quantized_index_topk, _meta_k5, {"term_lo": torch.float32}),
    (k45.fused_quantized_index_topk, _meta_k5, {"q_idx": torch.int64}),
    (k45.fused_ceiling_index_topk, _meta_ceiling,
     {"term_ubs": torch.float16}),
    (k45.fused_ceiling_index_topk, _meta_ceiling,
     {"postings_doc": torch.int64})])
def test_index_entries_refuse_other_dtypes(entry, make, dtypes):
    """The kernel reads the arrays as stored: another dtype raises rather
    than being widened by a copy."""
    with pytest.raises(ValueError, match="the kernel takes"):
        entry(*make(**dtypes), n_docs=2000, k=5)


def test_index_entries_check_shapes_without_a_card():
    args = list(_meta_k4())
    args[1] = _meta((2, 5), torch.float32)
    with pytest.raises(ValueError, match="must both be"):
        k45.fused_impact_index_topk(*args, n_docs=10, k=3)
    args = list(_meta_k5())
    args[4] = _meta((100,), torch.uint8)       # too few packed bytes
    with pytest.raises(ValueError, match="packed_vals"):
        k45.fused_quantized_index_topk(*args, n_docs=10, k=3)
