"""Two-tier pruned retrieval and the index extensions it reads, the port
against the JAX package on the same numpy inputs (CPU).

Ports tests/test_engine.py's index-extension and pruning tests. Tolerances:

* ``term_ubs``, the forward rows, the CSC arrays, ``stats()`` and
  ``memory_bytes()``: bit for bit (the same numpy build).
* Tier-1 ceilings: rtol 1e-6 against JAX's ``upper_bound_scores`` (JAX's
  segment sums run in another order than the port's term order); the
  ceiling entry's top-(C+1) ids equal ``lax.top_k``'s.
* ``pruned_retrieve``: ids equal JAX's and the ``impact`` method's;
  values within 1e-5 (tier 2 sums K products in another order).
* The builder run with forward rows: the same external ids as JAX's
  builder, values within 1e-4 (tests/test_torch_engine.py's tolerance).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import retrieval as jr
from repro.data.synthetic import lsr_impact_corpus
from repro.retrieval.engine import pruning as jp
from repro.retrieval.score import _resolve_method as j_resolve
from repro.runtime import serving as jserving
from repro_torch.kernels import impact_score as k45
from repro_torch.launch import serve
from repro_torch.retrieval import score
from repro_torch.retrieval.engine import IndexBuilder
from repro_torch.retrieval.engine import pruning as tp
from repro_torch.retrieval.index import build_inverted_index
from repro_torch.retrieval.sparse_rep import (SparseRep, query_columns,
                                              sparsify_threshold,
                                              sparsify_topk)
from repro_torch.runtime.serving import (DEFAULT_LADDER, BatchedEncoder,
                                         BatchPolicy, CorpusEngine)

K = 10
BENCH = dict(n_docs=1536, vocab=1536, doc_nnz=32, n_queries=8, q_nnz=28)
UB_RTOL = 1e-6
VAL_TOL = 1e-5
ENGINE_TOL = 1e-4


@pytest.fixture(scope="module")
def graded():
    """tests/test_engine.py's bench-shaped corpus, indexed by each
    package: raw (upper bounds only) and engine (plus forward rows)."""
    data = lsr_impact_corpus(**BENCH)
    q = sparsify_topk(torch.from_numpy(data["queries"]), BENCH["q_nnz"])
    d = sparsify_topk(torch.from_numpy(data["docs"]), BENCH["doc_nnz"])
    q_j = jr.sparsify_topk(jnp.asarray(data["queries"]), BENCH["q_nnz"])
    d_j = jr.sparsify_topk(jnp.asarray(data["docs"]), BENCH["doc_nnz"])
    out = {"q": q, "q_j": q_j, "d": d}
    for name, fwd in (("raw", False), ("eng", True)):
        out[name] = build_inverted_index(d, BENCH["vocab"], keep_forward=fwd,
                                         device="cpu")
        out[name + "_j"] = jr.build_inverted_index(d_j, BENCH["vocab"],
                                                   keep_forward=fwd)
    vals, idx = score.retrieve(q, out["raw"], K, method="impact")
    out["vals"], out["idx"] = vals.numpy(), idx.numpy()
    return out


def _small(rng, n, nnz, vocab):
    m = np.zeros((n, vocab), np.float32)
    for r in range(n):
        cols = rng.choice(vocab, size=nnz, replace=False)
        m[r, cols] = rng.uniform(0.1, 2.0, size=nnz)
    return m


# ---------------------------------------------------------------------------
# the index extensions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["raw", "eng"])
def test_index_extensions_equal_jax_bit_for_bit(graded, which):
    got, want = graded[which], graded[which + "_j"]
    assert got.has_upper_bounds and want.has_upper_bounds
    assert got.has_forward == want.has_forward == (which == "eng")
    for name in ("term_starts", "term_lens", "postings_doc", "postings_val",
                 "term_ubs", "doc_values", "doc_indices"):
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, name
            continue
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert got.posting_percentiles == want.posting_percentiles
    assert got.stats() == want.stats()
    assert got.memory_bytes() == want.memory_bytes()


def test_upper_bounds_are_each_terms_largest_impact(graded):
    raw = graded["raw"]
    ubs, lens = raw.term_ubs.numpy(), raw.term_lens.numpy()
    starts, pv = raw.term_starts.numpy(), raw.postings_val.numpy()
    for t in np.flatnonzero(lens > 0)[:50]:
        assert ubs[t] == pv[starts[t]:starts[t] + lens[t]].max()
    assert (ubs[lens == 0] == 0).all()
    assert graded["eng"].memory_bytes() > raw.memory_bytes()


def test_memory_bytes_counts_the_upper_bounds_as_jax():
    """200 docs at V 1000: the JAX index counts its term_ubs (4 * V
    bytes); so must the port's."""
    rng = np.random.default_rng(0)
    m = _small(rng, 200, 4, 1000)
    got = build_inverted_index(sparsify_topk(torch.from_numpy(m), 4), 1000,
                               device="cpu")
    want = jr.build_inverted_index(jr.sparsify_topk(jnp.asarray(m), 4), 1000)
    assert got.memory_bytes() == want.memory_bytes()
    assert got.stats()["memory_bytes"] == want.stats()["memory_bytes"]
    bare = build_inverted_index(sparsify_topk(torch.from_numpy(m), 4), 1000,
                                with_upper_bounds=False, device="cpu")
    assert not bare.has_upper_bounds
    assert bare.memory_bytes() == want.memory_bytes() - 4 * 1000


def test_vocab_range_refuses_as_jax():
    """``vocab_range``, refused before term shards were ported: the
    reference's ``ValueError`` outside ``[0, V)`` and with
    ``keep_forward``; a range inside builds the reference's shard."""
    rep = sparsify_topk(torch.eye(4, 8), 2)
    rep_j = jr.sparsify_topk(jnp.eye(4, 8), 2)
    for kw in ({"vocab_range": (4, 9)}, {"vocab_range": (3, 3)},
               {"vocab_range": (0, 4), "keep_forward": True}):
        with pytest.raises(ValueError) as got:
            build_inverted_index(rep, 8, device="cpu", **kw)
        with pytest.raises(ValueError) as want:
            jr.build_inverted_index(rep_j, 8, **kw)
        assert str(got.value) == str(want.value)
    got = build_inverted_index(rep, 8, vocab_range=(2, 6), device="cpu")
    want = jr.build_inverted_index(rep_j, 8, vocab_range=(2, 6))
    assert got.stats() == want.stats()
    np.testing.assert_array_equal(got.postings_doc.numpy(),
                                  np.asarray(want.postings_doc))


# ---------------------------------------------------------------------------
# tier 1: the ceilings
# ---------------------------------------------------------------------------

def test_upper_bound_scores_dominate_exact(graded):
    ub = tp.upper_bound_scores(graded["q"], graded["raw"]).numpy()
    exact = score.impact_scores(graded["q"], graded["raw"]).numpy()
    assert (ub >= exact - 1e-4).all()


def test_upper_bound_scores_match_jax(graded):
    got = tp.upper_bound_scores(graded["q"], graded["raw"]).numpy()
    want = np.asarray(jp.upper_bound_scores(graded["q_j"], graded["raw_j"]))
    np.testing.assert_allclose(got, want, rtol=UB_RTOL, atol=0)


def _ceiling_case(seed, n_docs=300, nnz=6, vocab=512, B=4, Q=7):
    """A small corpus and queries with a padded slot, a negative weight,
    ids at and past V and below 0, built by each package."""
    rng = np.random.default_rng(seed)
    D = _small(rng, n_docs, nnz, vocab)
    qi = rng.integers(-2 * vocab, 2 * vocab, size=(B, Q)).astype(np.int32)
    qi[:, :3] = rng.integers(0, vocab, size=(B, 3))
    qv = rng.uniform(0.1, 2.0, size=(B, Q)).astype(np.float32)
    qv[0, 1] = 0.0
    qv[1, 2] = -0.5
    nnz_q = (qv > 0).sum(1).astype(np.int32)
    q = SparseRep(torch.from_numpy(qv), torch.from_numpy(qi),
                  torch.from_numpy(nnz_q))
    q_j = jr.SparseRep(jnp.asarray(qv), jnp.asarray(qi), jnp.asarray(nnz_q))
    idx = build_inverted_index(sparsify_topk(torch.from_numpy(D), nnz),
                               vocab, device="cpu")
    idx_j = jr.build_inverted_index(jr.sparsify_topk(jnp.asarray(D), nnz),
                                    vocab)
    return q, q_j, idx, idx_j


@pytest.mark.parametrize("k", [65, 129, 257, 300])
def test_ceiling_entry_plain_matches_jax_top_k(k):
    """The ceiling entry's plain version is lax.top_k over JAX's dense
    ceilings: at k past the docs with a ceiling (300 docs, a few dozen of
    them reached) the list fills with zero-ceiling docs by lowest id,
    so the best excluded ceiling is 0, not NEG_INF."""
    q, q_j, idx, idx_j = _ceiling_case(k)
    qi, qv = query_columns(q, "cpu")
    vals, ids = k45.fused_ceiling_index_topk(
        qi, qv, idx.term_starts, idx.term_lens, idx.postings_doc,
        idx.term_ubs, n_docs=idx.n_docs, k=k)
    ub_j = jp.upper_bound_scores(q_j, idx_j)
    want_v, want_i = jax.lax.top_k(ub_j, k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(vals.numpy(), np.asarray(want_v),
                               rtol=UB_RTOL, atol=0)
    assert (vals[:, -1] == 0).all() and (vals[:, 0] > 0).all()
    # the dense ceilings of the plain version, one term at a time
    dense = tp.upper_bound_scores(q, idx)
    for a, b in zip((vals, ids), torch.topk(dense, 1)):
        assert a[:, 0].tolist() == b[:, 0].tolist()


def test_ceiling_topk_reads_no_impact(graded):
    """Tier 1 never reads postings_val: zeroing it leaves the ceilings."""
    raw = graded["raw"]
    blind = dataclasses.replace(raw, postings_val=torch.zeros_like(
        raw.postings_val))
    for a, b in zip(tp.ceiling_topk(graded["q"], raw, 65),
                    tp.ceiling_topk(graded["q"], blind, 65)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# pruned_retrieve
# ---------------------------------------------------------------------------

def test_pruned_ids_equal_jax_and_impact_at_safe_margin(graded):
    vals, idx, frontier = tp.pruned_retrieve(graded["q"], graded["eng"], K,
                                             with_diagnostics=True)
    v_j, i_j, f_j = jp.pruned_retrieve(graded["q_j"], graded["eng_j"], K,
                                       with_diagnostics=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(idx.numpy(), graded["idx"])
    np.testing.assert_allclose(vals.numpy(), graded["vals"], atol=VAL_TOL)
    np.testing.assert_allclose(vals.numpy(), np.asarray(v_j), atol=VAL_TOL)
    assert frontier.all() and np.asarray(f_j).all()
    assert frontier.dtype == torch.bool and idx.dtype == torch.int32


def test_pruned_full_candidates_is_exhaustive(graded):
    vals, idx = tp.pruned_retrieve(graded["q"], graded["eng"], K,
                                   candidates=BENCH["n_docs"])
    np.testing.assert_array_equal(idx.numpy(), graded["idx"])
    np.testing.assert_allclose(vals.numpy(), graded["vals"], atol=VAL_TOL)


@pytest.mark.parametrize("margin", [0.5, 1.0])
def test_pruned_margins_equal_jax_and_keep_top1(graded, margin):
    vals, idx, frontier = tp.pruned_retrieve(
        graded["q"], graded["eng"], K, prune_margin=margin,
        with_diagnostics=True)
    v_j, i_j, f_j = jp.pruned_retrieve(graded["q_j"], graded["eng_j"], K,
                                       prune_margin=margin,
                                       with_diagnostics=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(frontier.numpy(), np.asarray(f_j))
    np.testing.assert_allclose(vals.numpy(), np.asarray(v_j), atol=VAL_TOL)
    np.testing.assert_array_equal(idx.numpy()[:, 0], graded["idx"][:, 0])


def test_pruned_input_validation(graded):
    with pytest.raises(ValueError, match="forward"):
        tp.pruned_retrieve(graded["q"], graded["raw"], K)
    with pytest.raises(ValueError, match="prune_margin"):
        tp.pruned_retrieve(graded["q"], graded["eng"], K, prune_margin=2.0)
    no_ubs = dataclasses.replace(graded["eng"], term_ubs=None)
    with pytest.raises(ValueError, match="upper bounds"):
        tp.pruned_retrieve(graded["q"], no_ubs, K)


def test_default_candidates_planner_reads_percentiles(graded):
    base = tp.default_candidates(graded["raw"], K)
    assert base == jp.default_candidates(graded["raw_j"], K)
    assert K <= base <= BENCH["n_docs"]
    pct = (4.0, 30.0, 40.0, 900.0)
    skewed = dataclasses.replace(graded["raw"], posting_percentiles=pct)
    skewed_j = dataclasses.replace(graded["raw_j"], posting_percentiles=pct)
    assert tp.default_candidates(skewed, K) == min(2 * base,
                                                   BENCH["n_docs"])
    assert tp.default_candidates(skewed, K) == jp.default_candidates(
        skewed_j, K)


def test_auto_prefers_pruned_on_engine_index(graded):
    assert score.resolve_method("auto", graded["eng"]) == "pruned"
    assert j_resolve("auto", graded["eng_j"]) == "pruned"
    assert score.resolve_method("auto", graded["raw"]) == "impact"
    assert j_resolve("auto", graded["raw_j"]) == "impact"
    _, i_auto = score.retrieve(graded["q"], graded["eng"], K)
    np.testing.assert_array_equal(i_auto.numpy(), graded["idx"])


def test_retrieve_takes_pruning_kwargs_only_for_pruned(graded):
    q, eng = graded["q"], graded["eng"]
    got = score.retrieve(q, eng, K, method="pruned", prune_margin=0.5,
                         candidates=80)
    want = tp.pruned_retrieve(q, eng, K, prune_margin=0.5, candidates=80)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for method in ("impact", "fused"):
        with pytest.raises(ValueError, match="does not accept prune_margin"):
            score.retrieve(q, eng, K, method=method, prune_margin=0.0)
    with pytest.raises(ValueError, match="does not accept block_n"):
        score.retrieve(q, eng, K, method="pruned", block_n=64)


# ---------------------------------------------------------------------------
# the engine with forward rows
# ---------------------------------------------------------------------------

def _both_reps(m):
    return (sparsify_threshold(torch.from_numpy(m), 0.0, max_nnz=12),
            jr.sparsify_threshold(jnp.asarray(m), 0.0, max_nnz=12))


def test_builder_with_forward_rows_matches_jax():
    """add, remove, flush (tombstones zeroed in place: postings and forward
    rows) and compact with keep_forward, searched with auto (pruned on each
    segment), pruned (the delta by impact) and impact after each step."""
    rng = np.random.default_rng(3)
    D = _small(rng, 90, 8, 128)
    Q = _small(rng, 4, 6, 128)
    q_t, q_j = _both_reps(Q)
    port = IndexBuilder(128, keep_forward=True, compact_dead_frac=0.5,
                        device="cpu")
    ref = jr.IndexBuilder(128, keep_forward=True, compact_dead_frac=0.5)

    def searched():
        assert port.stats() == ref.stats()
        assert port.resolved_method() == ref.resolved_method() == "pruned"
        for kw in ({}, {"method": "pruned"},
                   {"method": "pruned", "prune_margin": 0.5},
                   {"method": "impact"}):
            v_t, e_t = port.search(q_t, 7, **kw)
            v_j, e_j = ref.search(q_j, 7, **kw)
            np.testing.assert_array_equal(e_t, e_j)
            np.testing.assert_allclose(v_t, np.asarray(v_j),
                                       rtol=ENGINE_TOL, atol=ENGINE_TOL)
        return e_t

    for b in (port, ref):
        b.add(_both_reps(D[:60])[b is ref])
        b.flush()
        b.add(_both_reps(D[60:])[b is ref])
    searched()
    gone = [1, 4, 9, 33, 70]
    for b in (port, ref):
        assert b.remove(gone) == len(gone)
        b.flush()
    ext = searched()
    assert not set(gone) & set(ext.ravel().tolist())
    assert port._base_raw.doc_values[[1, 4, 9, 33]].abs().sum() == 0
    np.testing.assert_array_equal(port._base_raw.doc_values.numpy(),
                                  np.asarray(ref._base_raw.doc_values))
    # the ceilings stay as built: a stale ceiling still bounds the impacts
    np.testing.assert_array_equal(port._base_raw.term_ubs.numpy(),
                                  np.asarray(ref._base_raw.term_ubs))
    for b in (port, ref):
        b.flush(force_compact=True)
    searched()
    assert port.stats()["n_compactions"] == ref.stats()["n_compactions"]


def test_engine_search_kwargs_are_checked_against_the_resolved_method():
    rng = np.random.default_rng(4)
    rep = _both_reps(_small(rng, 20, 6, 64))[0]
    b = IndexBuilder(64, keep_forward=True, device="cpu")
    b.add(rep)
    b.search(rep, 3, prune_margin=0.5, candidates=12)
    with pytest.raises(TypeError, match=r"resolved to 'pruned': unknown "
                                        r"kwargs block_n"):
        b.search(rep, 3, block_n=64)
    with pytest.raises(TypeError, match=r"resolved to 'impact': kwargs "
                                        r"prune_margin that method='impact'"
                                        r" does not accept"):
        b.search(rep, 3, method="impact", prune_margin=0.5)
    q = IndexBuilder(64, quantize=True, device="cpu")
    q.add(rep)
    with pytest.raises(TypeError, match="resolved to 'quantized'"):
        q.search(rep, 3, prune_margin=0.0)


def _counting_encoder(vocab=64, width=6):
    def encode(tokens, mask):
        out = torch.zeros((tokens.shape[0], vocab))
        ones = mask.float()
        out.scatter_add_(1, tokens.long() % vocab, ones)
        out += 0.01 * (tokens.long() % vocab).float().mean(1, keepdim=True)
        return sparsify_topk(out, width)
    return encode


def test_every_rung_of_the_degrade_ladder_answers():
    """Each rung's search_kwargs and q_width go to a CorpusEngine with
    forward rows: every rung returns k results with finite scores, a
    tombstoned doc (it surfaces as -1) only where the rung's narrowed
    query leaves fewer than k docs a positive score, and the exact and
    pruned (margin 0) rungs return the same ids."""
    enc = _counting_encoder()
    eng = CorpusEngine(BatchedEncoder(enc, policy=BatchPolicy(max_batch=8)),
                       64, keep_forward=True, device="cpu")
    rng = np.random.default_rng(5)
    ids = eng.add_docs([rng.integers(1, 64, 10).astype(np.int32)
                        for _ in range(40)])
    eng.remove_docs(ids[:3].tolist())
    q = enc(torch.from_numpy(rng.integers(1, 64, (3, 8)).astype(np.int32)),
            torch.ones((3, 8), dtype=torch.int32))
    got = {}
    for rung in DEFAULT_LADDER:
        vals, ext = eng.search(q, 5, q_width=max(1, int(
            q.width * rung.q_width_frac)), **rung.search_kwargs)
        assert ext.shape == (3, 5), rung.name
        assert not set(ids[:3].tolist()) & set(ext.ravel().tolist())
        assert (vals[ext < 0] <= 0).all(), rung.name
        assert np.isfinite(vals).all(), rung.name
        got[rung.name] = ext
    assert [r.name for r in DEFAULT_LADDER] == ["exact", "pruned",
                                                "aggressive", "minimal"]
    np.testing.assert_array_equal(got["exact"], got["pruned"])


def test_corpus_engine_with_forward_rows_searches_as_in_jax():
    def counts(tokens, mask):
        tokens, mask = np.asarray(tokens), np.asarray(mask)
        out = np.zeros((tokens.shape[0], 32), np.float32)
        for r in range(tokens.shape[0]):
            for t, on in zip(tokens[r], mask[r]):
                if on:
                    out[r, int(t) % 32] += 1 + 0.1 * r
        return out

    eng = CorpusEngine(BatchedEncoder(
        lambda t, m: sparsify_topk(torch.from_numpy(counts(t, m)), 4),
        policy=BatchPolicy(max_batch=8)), 32, keep_forward=True,
        device="cpu")
    ref = jserving.CorpusEngine(jserving.BatchedEncoder(
        lambda t, m: jr.sparsify_topk(jnp.asarray(counts(t, m)), 4),
        policy=jserving.BatchPolicy(max_batch=8)), 32, keep_forward=True)
    rng = np.random.default_rng(6)
    docs = [rng.integers(0, 32, 5).astype(np.int32) for _ in range(20)]
    Q = np.zeros((2, 32), np.float32)
    Q[0, [1, 5, 9]] = (2.0, 1.0, 0.5)
    Q[1, [3, 5, 30]] = (1.5, 0.7, 0.2)
    for e in (eng, ref):
        e.add_docs(docs[:12])
        e.flush()
        e.add_docs(docs[12:])
        e.remove_docs([2, 15])
    for kw in ({}, {"method": "pruned", "prune_margin": 1.0}):
        v_t, e_t = eng.search(sparsify_topk(torch.from_numpy(Q), 3), 4, **kw)
        v_j, e_j = ref.search(jr.sparsify_topk(jnp.asarray(Q), 3), 4, **kw)
        np.testing.assert_array_equal(e_t, e_j)
        np.testing.assert_allclose(v_t, np.asarray(v_j), atol=ENGINE_TOL)
    assert eng.stats() == ref.stats()


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args,tag", [
    (["--engine", "--prune-margin", "0"], "engine/pruned"),
    (["--method", "pruned"], "pruned"),
])
def test_serve_cli_pruned_on_cpu(args, tag, capsys):
    assert serve.main(["--device", "cpu", "--corpus", "64", "--requests",
                       "8", *args]) == 0
    out = capsys.readouterr().out
    assert "encoded 8/8 requests" in out
    assert f"retrieval[{tag}]: top-10 for 8 queries" in out


@pytest.mark.parametrize("args,says", [
    (["--prune-margin", "0"],
     "--quantize/--prune-margin/--remove-frac need --engine"),
    (["--engine", "--quantize", "--prune-margin", "0"],
     "--quantize and --prune-margin are exclusive"),
])
def test_serve_cli_prune_margin_refuses_as_in_jax(args, says, capsys):
    with pytest.raises(SystemExit) as exit_:
        serve.main(["--device", "cpu", *args])
    assert exit_.value.code == 2
    assert says in capsys.readouterr().err
