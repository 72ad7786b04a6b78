"""splade_xlmr's vocabulary (|V| 250002) through the port's index engine,
its pruned path and its dense top-k, against the JAX package on the same
numpy inputs (CPU).

The corpus: 2048 docs of 64 terms from a numpy seed, half of each row
from a pool of 4096 terms spread over the whole vocabulary (so that lists
overlap), half anywhere in it; the ids 65535, 65536 and 250001 are in
every few rows. The queries add ids that are negative or at and past V,
which every path reads by the reference's gather rule
(``tests/test_torch_query_ids.py``). Tolerances:

* the index builds (raw, with forward rows, quantized): every array equal,
  dtype included, and ``stats()`` and ``memory_bytes()`` equal (the same
  numpy build);
* ``impact``, ``fused``, ``quantized`` and ``fused`` on the quantized
  index: ids equal the reference's, scores to 1e-6 (raw) and 1e-5
  (quantized), as ``test_torch_query_ids.py`` holds them at V 16;
* ``pruned``: ids and ``exact_frontier`` equal the reference's at margins
  0 and 0.5, scores to 1e-5 (``test_torch_pruning.py``), and at margin 0,
  on the rows whose ids all lie in [0, V), ``exact_frontier`` true and
  the ids of ``impact`` (tier 2 drops an id outside it, as the
  reference's scatter does); on lists whose ceilings tie at the
  candidate cut, the reference's ids and frontier where the frontier
  fails and the ids leave ``impact``'s;
* the dense top-k at D 250002: on integer-valued inputs every sum is
  exact, so values and ids are equal, planted duplicate rows included
  (ties to the lowest id); on random non-negative floats the ids are
  equal and the values within rtol 1e-5 (sums of 250002 f32 products in
  another order);
* the engines of a narrow trunk with ``vocab_size=250002`` (the JAX
  weights carried over, f32 compute): equal external ids, values to 1e-3
  (``test_torch_engine.py``'s SMOKE encoder tolerance).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import retrieval as jr
from repro.configs.splade_xlmr import SMOKE as JAX_SMOKE
from repro.kernels.ref import topk_score_ref
from repro.models import transformer as jtfm
from repro.retrieval.engine import pruning as jp
from repro.runtime import serving as jserving
from repro_torch.configs.splade_xlmr import SMOKE
from repro_torch.kernels.topk_score import topk_score_plain
from repro_torch.retrieval import score
from repro_torch.retrieval.engine import pruning as tp
from repro_torch.retrieval.engine.quantize import quantize_index, to_numpy
from repro_torch.retrieval.index import build_inverted_index
from repro_torch.retrieval.sparse_rep import SparseRep
from repro_torch.runtime.serving import (BatchedEncoder, BatchPolicy,
                                         CorpusEngine, make_config_encoder)
from repro_torch.weights import params_from_jax

V = 250002
N_DOCS, NNZ, POOL = 2048, 64, 4096
K = 10
TOL = 1e-6
Q_TOL = 1e-5
ENGINE_TOL = 1e-3
DENSE_RTOL = 1e-5
# ids every path must take: the u16 boundary, the last row, and (queries
# only) ids outside [0, V) that the gather rule wraps or clamps
EDGE_IDS = (65535, 65536, V - 1)
OUTSIDE_IDS = (-3, -V - 5, V, V + 40000)
Q_ARRAYS = ("term_starts", "term_lens", "packed_vals", "deltas", "term_lo",
            "term_hi")
RAW_ARRAYS = ("term_starts", "term_lens", "postings_doc", "postings_val",
              "term_ubs", "doc_values", "doc_indices")


def _rows(rng, n, width, pool):
    """(n, width) distinct ids a row, half from ``pool``, half anywhere
    in [0, V), with f32 weights in [0.1, 2.0)."""
    ids = np.empty((n, width), np.int64)
    for r in range(n):
        own = rng.choice(pool, size=width // 2, replace=False)
        rest = rng.choice(V, size=width, replace=False)
        rest = rest[~np.isin(rest, own)][:width - width // 2]
        ids[r] = np.r_[own, rest]
    vals = rng.uniform(0.1, 2.0, size=(n, width)).astype(np.float32)
    return vals, ids.astype(np.int32)


def _pair(vals, ids):
    nnz = (vals > 0).sum(1).astype(np.int32)
    return (SparseRep(vals, ids, nnz),
            jr.SparseRep(jnp.asarray(vals), jnp.asarray(ids),
                         jnp.asarray(nnz)))


@pytest.fixture(scope="module")
def full_v():
    """The corpus and queries at V 250002, indexed by each package: raw,
    with forward rows, and quantized."""
    rng = np.random.default_rng(250002)
    pool = np.unique(np.r_[rng.choice(V, size=POOL, replace=False),
                           EDGE_IDS])
    vals, ids = _rows(rng, N_DOCS, NNZ, pool)
    for j, term in enumerate(EDGE_IDS):   # the edge ids in every 7th row
        rows = np.arange(j, N_DOCS, 7)
        hit = (ids[rows] == term).any(1)
        ids[rows[~hit], -1] = term
    q_vals, q_ids = _rows(rng, 6, 24, pool)
    q_vals[0, -1] = 0.0                    # a padded slot
    q_ids[1, :len(EDGE_IDS)] = EDGE_IDS
    q_ids[2, :len(OUTSIDE_IDS)] = OUTSIDE_IDS
    q_ids[3, -len(OUTSIDE_IDS):] = OUTSIDE_IDS
    d_t, d_j = _pair(vals, ids)
    out = {"q": _pair(q_vals, q_ids)}
    for name, fwd in (("raw", False), ("forward", True)):
        out[name] = (build_inverted_index(d_t, V, keep_forward=fwd,
                                          device="cpu"),
                     jr.build_inverted_index(d_j, V, keep_forward=fwd))
    raw, raw_j = out["raw"]
    out["quantized"] = (quantize_index(raw), jr.quantize_index(raw_j))
    return out


@pytest.mark.parametrize("which", ["raw", "forward"])
def test_raw_index_equals_jax_at_full_vocab(full_v, which):
    index, ref = full_v[which]
    for name in RAW_ARRAYS:
        got, want = getattr(index, name), getattr(ref, name)
        if want is None:
            assert got is None, name
            continue
        got = got.numpy()
        assert got.dtype == np.asarray(want).dtype, name
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)
    assert index.stats() == ref.stats()
    assert index.memory_bytes() == ref.memory_bytes()
    lens = index.term_lens.numpy()
    assert lens.shape == (V,) and all(lens[t] > 0 for t in EDGE_IDS)


def test_quantize_index_equals_jax_at_full_vocab(full_v):
    quant, ref = full_v["quantized"]
    for name in Q_ARRAYS:
        got, want = to_numpy(getattr(quant, name)), np.asarray(getattr(ref,
                                                                       name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in ("n_docs", "vocab_size", "max_postings",
                 "n_source_postings"):
        assert getattr(quant, name) == getattr(ref, name), name
    assert quant.stats() == ref.stats()
    assert quant.memory_bytes() == ref.memory_bytes()
    # gaps across 2048 docs pass the u8 escape; no list reaches 2**16
    assert quant.deltas.dtype == torch.uint16
    assert quant.term_lens.dtype == torch.uint16
    assert quant.term_starts.shape == (V,)


# (index, the port's method, the reference's method, score tolerance)
METHODS = {
    "impact": ("raw", "impact", "impact", TOL),
    "fused": ("raw", "fused", "fused", TOL),
    "quantized": ("quantized", "quantized", "quantized", Q_TOL),
    "fused_on_quantized": ("quantized", "fused", "fused", Q_TOL),
}


@pytest.mark.parametrize("case", sorted(METHODS))
def test_index_methods_equal_jax_at_full_vocab(full_v, case):
    which, method, ref_method, tol = METHODS[case]
    index, ref = full_v[which]
    q, q_j = full_v["q"]
    v, i = score.retrieve(q, index, K, method=method)
    kw = {"interpret": True} if ref_method == "fused" else {}
    v_j, i_j = jr.retrieve(q_j, ref, K, method=ref_method, **kw)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), rtol=tol,
                               atol=tol)
    assert float(v[:, 0].min()) > 0     # every query meets the corpus


@pytest.mark.parametrize("margin", [0.0, 0.5])
def test_pruned_equals_jax_at_full_vocab(full_v, margin):
    index, ref = full_v["forward"]
    q, q_j = full_v["q"]
    v, i, frontier = tp.pruned_retrieve(q, index, K, prune_margin=margin,
                                        with_diagnostics=True)
    v_j, i_j, f_j = jp.pruned_retrieve(q_j, ref, K, prune_margin=margin,
                                       with_diagnostics=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(frontier.numpy(), np.asarray(f_j))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), rtol=Q_TOL,
                               atol=Q_TOL)
    assert score.resolve_method("auto", index) == "pruned"
    if margin == 0.0:
        # rows 2 and 3 hold ids outside [0, V): tier 1 gives them the
        # ceiling of the row the gather reads, tier 2's scatter drops
        # them (the reference's rule), so those rows are held to JAX only
        inside = [0, 1, 4, 5]
        assert bool(frontier[inside].all())
        _, i_impact = score.retrieve(q, index, K, method="impact")
        np.testing.assert_array_equal(i.numpy()[inside],
                                      i_impact.numpy()[inside])


DENSE_N, N_DUP = 128, 10
DUP_AT = DENSE_N - 12       # rows DUP_AT + d repeat rows d: exact ties


def test_pruned_follows_jax_where_its_frontier_fails():
    """Lists that share a 128-term pool (2048 docs of 8 pool terms and 24
    others; queries of 24 pool terms): the default budget (C 64) cuts
    through many equal ceilings, so ``exact_frontier`` fails and some
    rows miss a top-10 doc of ``impact``, in the reference as in the
    port. The port returns the reference's ids and frontier there too, to
    1e-5; with every doc a candidate it is ``impact`` again."""
    rng = np.random.default_rng(0)
    pool = rng.choice(V, size=128, replace=False)
    ids = np.stack([np.r_[rng.choice(pool, 8, replace=False),
                          rng.choice(V, 24, replace=False)]
                    for _ in range(N_DOCS)]).astype(np.int32)
    vals = rng.uniform(0.1, 2.0, size=ids.shape).astype(np.float32)
    d_t, d_j = _pair(vals, ids)
    index = build_inverted_index(d_t, V, keep_forward=True, device="cpu")
    ref = jr.build_inverted_index(d_j, V, keep_forward=True)
    q_ids = np.stack([rng.choice(pool, 24, replace=False)
                      for _ in range(8)]).astype(np.int32)
    q, q_j = _pair(rng.uniform(0.1, 2.0, size=q_ids.shape)
                   .astype(np.float32), q_ids)
    v, i, frontier = tp.pruned_retrieve(q, index, K, with_diagnostics=True)
    v_j, i_j, f_j = jp.pruned_retrieve(q_j, ref, K, with_diagnostics=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(frontier.numpy(), np.asarray(f_j))
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), rtol=Q_TOL,
                               atol=Q_TOL)
    assert tp.default_candidates(index, K) == 64
    _, i_impact = score.retrieve(q, index, K, method="impact")
    missed = (i != i_impact).any(1)
    assert bool(missed.any()) and not bool(frontier[missed].any())
    _, i_all = tp.pruned_retrieve(q, index, K, candidates=N_DOCS)
    np.testing.assert_array_equal(i_all.numpy(), i_impact.numpy())


def _dense_case(kind, B=4):
    rng = np.random.default_rng(7)
    if kind == "ints":       # every sum exact whatever its order
        q = rng.integers(0, 3, size=(B, V)).astype(np.float32)
        C = rng.integers(0, 3, size=(DENSE_N, V)).astype(np.float32)
    else:                    # dense SPLADE-like rows: non-negative floats
        q = np.maximum(rng.standard_normal((B, V)), 0).astype(np.float32)
        C = np.maximum(rng.standard_normal((DENSE_N, V)),
                       0).astype(np.float32)
    C[DUP_AT:DUP_AT + N_DUP] = C[:N_DUP]
    return q, C


DENSE = {"retrieve": lambda q, C, k: score.retrieve(q, C, k, method="dense"),
         "plain": lambda q, C, k: topk_score_plain(q, C, k=k)}


@pytest.mark.parametrize("kind", ["ints", "normal"])
@pytest.mark.parametrize("path", sorted(DENSE))
def test_dense_topk_equals_reference_at_d_250002(kind, path):
    q, C = _dense_case(kind)
    k = 24                                # past the planted duplicates
    v, i = DENSE[path](torch.from_numpy(q), torch.from_numpy(C), k)
    v_j, i_j = topk_score_ref(jnp.asarray(q), jnp.asarray(C), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    if kind == "ints":
        np.testing.assert_array_equal(v.numpy(), np.asarray(v_j))
    else:
        np.testing.assert_allclose(v.numpy(), np.asarray(v_j),
                                   rtol=DENSE_RTOL)
    # a planted duplicate in the top-k ranks after its original
    ties = 0
    for b in range(q.shape[0]):
        ids = i[b].tolist()
        for d in range(N_DUP):
            if DUP_AT + d in ids:
                assert d in ids and ids.index(d) < ids.index(DUP_AT + d)
                ties += 1
    assert ties > 0


def _narrow_pair():
    """A narrow trunk at V 250002 (xlmr's SMOKE widths, f32 compute, 16
    terms a rep): JAX's params and the port's carried copy."""
    cfg_j = dataclasses.replace(JAX_SMOKE, vocab_size=V,
                                compute_dtype="float32", rep_topk=16)
    cfg_t = dataclasses.replace(SMOKE, vocab_size=V, compute_dtype="float32",
                                rep_topk=16)
    params_j = jtfm.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t,
                               "cpu")
    return (make_config_encoder(params_t, cfg_t),
            jserving.make_config_encoder(params_j, cfg_j))


ENGINES = {"quantized": ({"quantize": True}, ("auto", "fused", "quantized")),
           "forward": ({"keep_forward": True}, ("auto", "impact", "fused"))}


@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_engines_of_a_narrow_trunk_search_as_jax(kind):
    engine_kw, methods = ENGINES[kind]
    enc_t, enc_j = _narrow_pair()
    eng = CorpusEngine(BatchedEncoder(enc_t, policy=BatchPolicy(max_batch=16)),
                       V, device="cpu", **engine_kw)
    ref = jserving.CorpusEngine(
        jserving.BatchedEncoder(enc_j,
                                policy=jserving.BatchPolicy(max_batch=16)),
        V, **engine_kw)
    rng = np.random.default_rng(11)
    # tokens from a small shared pool and from past 2**16, so docs overlap
    pool = np.r_[np.arange(1, 40), 70000 + np.arange(20), V - 1 - np.arange(5)]
    docs = [rng.choice(pool, size=12).astype(np.int32) for _ in range(48)]
    toks = rng.choice(pool, size=(3, 8)).astype(np.int32)
    for e in (eng, ref):
        e.add_docs(docs[:32])
        e.flush()
        e.add_docs(docs[32:])
        e.remove_docs([2, 40])
    q_t = enc_t(torch.from_numpy(toks), torch.ones((3, 8), dtype=torch.int32))
    q_j = enc_j(jnp.asarray(toks), jnp.ones((3, 8), jnp.int32))
    assert eng.builder.resolved_method() == ref.builder.resolved_method()
    for method in methods + (("pruned",) if kind == "forward" else ()):
        kw = {"method": method}
        if method == "pruned":
            kw["prune_margin"] = 0.5
        v_t, e_t = eng.search(q_t, 5, **kw)
        v_j, e_j = ref.search(q_j, 5, **kw)
        np.testing.assert_array_equal(e_t, e_j, err_msg=method)
        np.testing.assert_allclose(v_t, np.asarray(v_j), rtol=ENGINE_TOL,
                                   atol=ENGINE_TOL, err_msg=method)
        assert not {2, 40} & set(e_t.ravel().tolist())
    assert eng.stats() == ref.stats()
