"""The sharded engines (``engine/sharded_index``, ``term_sharded``,
``shard2d``) and the ``ShardPlan`` planner against the JAX package on the
same numpy inputs (CPU).

One process: each index and its retrieve against the JAX ``mesh=None``
function at 1–4 shards and at grids 1x2, 2x1, 2x2 and 3x2 (uneven cuts
included), the stacked arrays field for field, the planner's numbers and
``reason`` strings. Mesh paths: one world of four gloo ranks
(``tests/_torch_mesh_ranks.sharded_index_rank``) beside one JAX subprocess
with four forced host devices, each function jitted under the (4,), (2, 2)
and (1, 4) meshes; every rank must return the same result, and it must equal
the JAX function's under ``jax.make_mesh`` and the port's one-process
result.

Tolerances:

* doc-sharded: ids equal, scores within 1e-6 (each doc's terms summed in
  the same order; measured equal);
* term-sharded and 2D: a doc's score is a sum of per-shard partials, in
  another order than JAX's ``jnp.sum`` over the shard axis past two
  shards: ids equal except at near ties, ``|s(got) - s(want)| <= 1e-5 *
  (1 + |s|)`` of the exact (float64) scores, scores within ``1e-5 * (1 +
  |s|)``; the pruned compositions by the same rule;
* the mesh against the port's one-process result: ids equal and, where a
  psum adds two partials (a 2-way axis), the same bits;
* the planner and the stacked arrays: equal.
"""

import dataclasses
import tempfile
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_ranks import (SHARD_MESHES, finish_jax, shard_cases,
                               sharded_index_rank, start_jax, world)
from repro.retrieval import index as jindex
from repro.retrieval.engine import shard2d as j2d
from repro.retrieval.engine import sharded_index as jsi
from repro.retrieval.engine import term_sharded as jts
from repro.retrieval.sparse_rep import SparseRep as JRep
from repro_torch.retrieval.engine import shard2d as t2d
from repro_torch.retrieval.engine import sharded_index as tsi
from repro_torch.retrieval.engine import term_sharded as tts
from repro_torch.retrieval.index import build_inverted_index
from repro_torch.retrieval.sparse_rep import SparseRep

N, V, K, B, QK, TOPK = 150, 256, 12, 6, 8, 7
DOC_TOL = 1e-6
SUM_TOL = 1e-5
MARGINS = (0.25, 0.5)
CANDIDATES = 24


def corpus_rows(seed, n=N, vocab=V, width=K):
    """``(n, width)`` positive rows with a padded tail and a stopword term
    (id 3 in 60 % of the docs): values, ids, nnz as numpy."""
    rng = np.random.default_rng(seed)
    vals = np.zeros((n, width), np.float32)
    ids = np.zeros((n, width), np.int32)
    nnz = rng.integers(width // 2, width + 1, size=n)
    for r in range(n):
        cols = rng.choice(np.arange(4, vocab), size=nnz[r], replace=False)
        if rng.random() < 0.6:
            cols[0] = 3
        ids[r, :nnz[r]] = cols
        vals[r, :nnz[r]] = rng.uniform(0.05, 2.0, size=nnz[r])
    return vals, ids, nnz.astype(np.int32)


def query_rows(seed):
    return corpus_rows(seed, n=B, width=QK)


def reps(rows):
    """The same rows as the port's and the JAX package's rep."""
    return (SparseRep(*(torch.from_numpy(a) for a in rows)),
            JRep(*(jnp.asarray(a) for a in rows)))


DOCS = corpus_rows(0)
QUERIES = query_rows(1)


def exact_scores(doc_rows=DOCS, q_rows=QUERIES):
    """(B, N) float64 dot products of the dense rows."""
    def dense(rows):
        v, i, _ = rows
        m = np.zeros((v.shape[0], V))
        np.add.at(m, (np.arange(v.shape[0])[:, None], i), v)
        return m
    return dense(q_rows) @ dense(doc_rows).T


SCORES = exact_scores()


def held(got, want, *, tol, exact_ids=False, scores=SCORES):
    """``got`` and ``want`` ``(vals, ids)``: ids equal (but at near ties
    unless ``exact_ids``), values within ``tol * (1 + |v|)``."""
    gv, gi = (np.asarray(a) for a in got)
    wv, wi = (np.asarray(a) for a in want)
    assert gi.shape == wi.shape and gi.dtype == np.int32
    if exact_ids:
        np.testing.assert_array_equal(gi, wi)
    else:
        rows = np.arange(gi.shape[0])[:, None]
        s_g, s_w = scores[rows, gi], scores[rows, wi]
        near = np.abs(s_g - s_w) <= SUM_TOL * (1 + np.abs(s_w))
        assert ((gi == wi) | near).all(), (gi, wi)
    np.testing.assert_allclose(gv, wv, rtol=tol, atol=tol)


def fields_equal(port, ref, names):
    for name in names:
        got, want = getattr(port, name), getattr(ref, name)
        if isinstance(got, torch.Tensor):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=name)
        else:
            assert got == want, name


# ---------------------------------------------------------------------------
# build_inverted_index(vocab_range=)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lo,hi", [(0, 256), (0, 100), (100, 256),
                                   (200, 201)])
def test_vocab_range_index_equals_jax(lo, hi):
    d_t, d_j = reps(DOCS)
    got = build_inverted_index(d_t, V, vocab_range=(lo, hi), device="cpu")
    want = jindex.build_inverted_index(d_j, V, vocab_range=(lo, hi))
    fields_equal(got, want, ("term_starts", "term_lens", "postings_doc",
                             "postings_val", "term_ubs", "n_docs",
                             "vocab_size", "max_postings",
                             "posting_percentiles"))
    assert got.stats() == want.stats()


def _message(fn, *args, **kw):
    with pytest.raises(ValueError) as err:
        fn(*args, **kw)
    return str(err.value)


@pytest.mark.parametrize("kw", [{"vocab_range": (0, 257)},
                                {"vocab_range": (5, 5)},
                                {"vocab_range": (-1, 4)},
                                {"vocab_range": (0, 4),
                                 "keep_forward": True}])
def test_vocab_range_refusals_equal_jax(kw):
    d_t, d_j = reps(DOCS)
    assert _message(build_inverted_index, d_t, V, device="cpu", **kw) == \
        _message(jindex.build_inverted_index, d_j, V, **kw)


# ---------------------------------------------------------------------------
# the doc-sharded index
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_shard_index_and_retrieve_equal_jax(n_shards):
    d_t, d_j = reps(DOCS)
    q_t, q_j = reps(QUERIES)
    got = tsi.shard_index(d_t, V, n_shards, device="cpu")
    want = jsi.shard_index(d_j, V, n_shards)
    fields_equal(got, want, ("term_starts", "term_lens", "postings_doc",
                             "postings_val", "shard_counts", "n_shards",
                             "docs_per_shard", "n_docs", "vocab_size",
                             "max_postings"))
    assert got.stats() == want.stats()
    held(tsi.sharded_retrieve(q_t, got, TOPK),
         jsi.sharded_retrieve(q_j, want, TOPK), tol=DOC_TOL, exact_ids=True)


# ---------------------------------------------------------------------------
# the term-sharded index
# ---------------------------------------------------------------------------

TERM_BUILDS = {
    **{f"mass{n}": dict(n_shards=n) for n in (1, 2, 3, 4)},
    **{f"width{n}": dict(n_shards=n, balance="width") for n in (2, 3, 4)},
    "cuts": dict(n_shards=3, boundaries=(0, 4, 130, V)),
}
TERM_FIELDS = ("term_starts", "term_lens", "postings_doc", "postings_val",
               "term_ubs", "shard_lo", "shard_hi", "n_shards", "n_docs",
               "vocab_size", "local_vocab", "max_postings", "boundaries",
               "doc_values", "doc_indices")


def _term(name):
    d_t, d_j = reps(DOCS)
    kw = dict(TERM_BUILDS[name], keep_forward=True)
    return (tts.term_shard_index(d_t, V, device="cpu", **kw),
            jts.term_shard_index(d_j, V, **kw))


@pytest.mark.parametrize("name", sorted(TERM_BUILDS))
def test_term_shard_index_equals_jax(name):
    got, want = _term(name)
    fields_equal(got, want, TERM_FIELDS)
    assert got.stats() == want.stats()
    assert got.memory_bytes() == want.memory_bytes()


@pytest.mark.parametrize("margin", [None, *MARGINS])
@pytest.mark.parametrize("name", ["mass2", "mass3", "width4", "cuts"])
def test_term_sharded_retrieve_equals_jax(name, margin):
    got, want = _term(name)
    q_t, q_j = reps(QUERIES)
    kw = {} if margin is None else dict(prune_margin=margin,
                                        candidates=CANDIDATES)
    held(tts.term_sharded_retrieve(q_t, got, TOPK, **kw),
         jts.term_sharded_retrieve(q_j, want, TOPK, **kw), tol=SUM_TOL)


# ---------------------------------------------------------------------------
# the 2D grid
# ---------------------------------------------------------------------------

GRIDS = {
    "1x2": dict(doc_shards=1, term_shards=2),
    "2x1": dict(doc_shards=2, term_shards=1),
    "2x2": dict(doc_shards=2, term_shards=2),
    "3x2": dict(doc_shards=3, term_shards=2),
    "3x2_uneven": dict(doc_shards=3, term_shards=2,
                       doc_boundaries=(0, 17, 100, N),
                       term_boundaries=(0, 60, V)),
    "2x3_width": dict(doc_shards=2, term_shards=3, balance="width"),
}
GRID_FIELDS = ("term_starts", "term_lens", "postings_doc", "postings_val",
               "term_ubs", "term_lo", "term_hi", "chunk_starts",
               "chunk_counts", "doc_shards", "term_shards", "n_docs",
               "vocab_size", "local_vocab", "docs_per_chunk", "max_postings",
               "term_boundaries", "doc_boundaries", "doc_values",
               "doc_indices")


def _grid(name):
    d_t, d_j = reps(DOCS)
    kw = dict(GRIDS[name], keep_forward=True)
    return (t2d.shard2d_index(d_t, V, device="cpu", **kw),
            j2d.shard2d_index(d_j, V, **kw))


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_shard2d_index_equals_jax(name):
    got, want = _grid(name)
    fields_equal(got, want, GRID_FIELDS)
    assert got.stats() == want.stats()
    assert got.memory_bytes() == want.memory_bytes()


@pytest.mark.parametrize("margin", [None, *MARGINS])
@pytest.mark.parametrize("name", sorted(GRIDS))
def test_shard2d_retrieve_equals_jax(name, margin):
    got, want = _grid(name)
    q_t, q_j = reps(QUERIES)
    kw = {} if margin is None else dict(prune_margin=margin,
                                        candidates=CANDIDATES)
    held(t2d.shard2d_retrieve(q_t, got, TOPK, **kw),
         j2d.shard2d_retrieve(q_j, want, TOPK, **kw), tol=SUM_TOL)


def test_zero_docs_equals_jax():
    got, want = _grid("3x2_uneven")
    dead = [0, 16, 17, 99, 100, N - 1]
    fields_equal(got.zero_docs(dead), want.zero_docs(dead),
                 ("postings_val", "doc_values"))


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("counts,n", [
    (np.bincount(DOCS[1][DOCS[0] > 0], minlength=V), 3),
    (np.r_[1000, np.ones(15, np.int64)], 4),
    (np.zeros(10, np.int64), 3),
    (np.arange(20), 20),
])
def test_mass_balanced_boundaries_equal_jax(counts, n):
    assert t2d.mass_balanced_boundaries(counts, n) == \
        j2d.mass_balanced_boundaries(counts, n)


STATS = [
    dict(posting_bytes=8 * 40_000_000, vocab_size=30522, n_docs=10**6),
    dict(posting_bytes=8 * 200_000, vocab_size=250002, n_docs=20000,
         forward_bytes=10**6),
    dict(posting_bytes=8 * 5_000, vocab_size=250002, n_docs=100),
]


@pytest.mark.parametrize("hbm", [None, 2**20, 2**24, 10**9, 10])
@pytest.mark.parametrize("stats", range(len(STATS)))
@pytest.mark.parametrize("n_devices", [1, 4, 6])
def test_plan_placement_equals_jax(stats, n_devices, hbm):
    got = t2d.plan_placement(t2d.CorpusStats(**STATS[stats]), n_devices,
                             hbm)
    want = j2d.plan_placement(j2d.CorpusStats(**STATS[stats]), n_devices,
                              hbm)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.grid, got.n_devices, got.axis, got.describe()) == \
        (want.grid, want.n_devices, want.axis, want.describe())
    for s in STATS:
        assert got.per_device_bytes(t2d.CorpusStats(**s)) == \
            want.per_device_bytes(j2d.CorpusStats(**s))


def test_corpus_stats_equal_jax():
    d_t, d_j = reps(DOCS)
    for fwd in (False, True):
        got = t2d.CorpusStats.from_index(build_inverted_index(
            d_t, V, keep_forward=fwd, device="cpu"))
        want = j2d.CorpusStats.from_index(jindex.build_inverted_index(
            d_j, V, keep_forward=fwd))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert dataclasses.asdict(t2d.CorpusStats.from_rep(
            d_t, V, keep_forward=fwd)) == dataclasses.asdict(
            j2d.CorpusStats.from_rep(d_j, V, keep_forward=fwd))


def test_shard_plan_and_choose_shard_axis_equal_jax():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = [t2d.choose_shard_axis(8 * p, v, n, hbm)
               for p, v, n, hbm in ((10**6, 30522, 4, None),
                                    (10**3, 250002, 4, None),
                                    (10**5, 250002, 4, 2**22))]
    with warnings.catch_warnings(record=True) as caught_j:
        warnings.simplefilter("always")
        want = [j2d.choose_shard_axis(8 * p, v, n, hbm)
                for p, v, n, hbm in ((10**6, 30522, 4, None),
                                     (10**3, 250002, 4, None),
                                     (10**5, 250002, 4, 2**22))]
    assert got == want
    assert [(w.category, str(w.message)) for w in caught] == \
        [(w.category, str(w.message)) for w in caught_j]
    assert tts.choose_shard_axis is t2d.choose_shard_axis
    plan = t2d.ShardPlan(2, 3, replicas=2, reason="r")
    assert (plan.grid, plan.n_devices, plan.axis, plan.describe()) == \
        (6, 12, "2d", "2x3 (doc x term) x2 replicas")
    for kw in (dict(doc_shards=0, term_shards=1),
               dict(doc_shards=1, term_shards=1, replicas=0),
               dict(doc_shards=1, term_shards=1, axis_order=("doc",
                                                             "doc"))):
        assert _message(t2d.ShardPlan, **kw) == _message(j2d.ShardPlan, **kw)


@pytest.mark.parametrize("call", ["shard_index", "term_index", "grid_docs",
                                  "grid_terms", "balance", "boundaries",
                                  "doc_boundaries", "no_forward_term",
                                  "no_forward_grid", "margin"])
def test_builders_and_retrieves_refuse_as_jax(call):
    d_t, d_j = reps(DOCS)
    q_t, q_j = reps(QUERIES)
    small_t, small_j = reps(corpus_rows(2, n=3))
    calls = {
        "shard_index": lambda m, d, s: m[0].shard_index(s[0], V, 4, **m[1]),
        "term_index": lambda m, d, s: m[2].term_shard_index(d, V, V + 1,
                                                            **m[1]),
        "grid_docs": lambda m, d, s: m[3].shard2d_index(s[0], V, 4, 1,
                                                        **m[1]),
        "grid_terms": lambda m, d, s: m[3].shard2d_index(d, V, 1, V + 1,
                                                         **m[1]),
        "balance": lambda m, d, s: m[2].term_shard_index(
            d, V, 2, balance="rows", **m[1]),
        "boundaries": lambda m, d, s: m[2].term_shard_index(
            d, V, 2, boundaries=(0, 5, 5), **m[1]),
        "doc_boundaries": lambda m, d, s: m[3].shard2d_index(
            d, V, 2, 1, doc_boundaries=(0, 200, N), **m[1]),
        "no_forward_term": lambda m, d, s: m[2].term_sharded_retrieve(
            s[1], m[2].term_shard_index(d, V, 2, **m[1]), 3,
            prune_margin=0.5),
        "no_forward_grid": lambda m, d, s: m[3].shard2d_retrieve(
            s[1], m[3].shard2d_index(d, V, 2, 2, **m[1]), 3,
            prune_margin=0.5),
        "margin": lambda m, d, s: m[2].term_sharded_retrieve(
            s[1], m[2].term_shard_index(d, V, 2, keep_forward=True,
                                        **m[1]), 3, prune_margin=1.5),
    }
    port = (tsi, {"device": "cpu"}, tts, t2d)
    ref = (jsi, {}, jts, j2d)
    assert _message(calls[call], port, d_t, (small_t, q_t)) == \
        _message(calls[call], ref, d_j, (small_j, q_j))


# ---------------------------------------------------------------------------
# the mesh paths: one world of four gloo ranks beside one JAX subprocess
# ---------------------------------------------------------------------------

_JAX = """
import os
import numpy as np, jax
from repro.retrieval.engine import shard2d, sharded_index, term_sharded
from repro.retrieval.engine.shard2d import ShardPlan
from repro.retrieval.sparse_rep import SparseRep

x = dict(np.load(os.environ["OUT"] + ".in.npz"))
docs = SparseRep(x["dv"], x["di"], x["dn"])
q = SparseRep(x["qv"], x["qi"], x["qn"])
out = {}
for case in %r:
    mesh = jax.make_mesh(tuple(case["mesh"]), tuple(case["axes"]))
    kind, kw = case["kind"], dict(case["kw"])
    try:
        if kind == "sharded":
            idx = sharded_index.shard_index(docs, %d, case["shards"])
            fn = lambda q, idx: sharded_index.sharded_retrieve(
                q, idx, %d, mesh=mesh, **kw)
        elif kind == "term":
            idx = term_sharded.term_shard_index(
                docs, %d, case["shards"], keep_forward=True)
            fn = lambda q, idx: term_sharded.term_sharded_retrieve(
                q, idx, %d, mesh=mesh, **kw)
        else:
            idx = shard2d.shard2d_index(docs, %d, *case["grid"],
                                        keep_forward=True,
                                        **dict(case["build"]))
            plan = ShardPlan(*case["grid"], axis_order=tuple(case["order"]))
            fn = lambda q, idx: shard2d.shard2d_retrieve(
                q, idx, %d, mesh=mesh, plan=plan, **kw)
        v, i = jax.jit(fn)(q, idx)
        out[case["name"] + "|v"] = np.asarray(v)
        out[case["name"] + "|i"] = np.asarray(i)
    except ValueError as e:
        out[case["name"] + "|error"] = np.asarray(str(e))
np.savez(os.environ["OUT"], **out)
"""


@pytest.fixture(scope="module")
def mesh_runs():
    cases = shard_cases(N)
    x = {"dv": DOCS[0], "di": DOCS[1], "dn": DOCS[2],
         "qv": QUERIES[0], "qi": QUERIES[1], "qn": QUERIES[2]}
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "jax.npz"
        np.savez(str(out) + ".in.npz", **x)
        proc = start_jax(_JAX % (cases, V, TOPK, V, TOPK, V, TOPK), out)
        ranks = world(sharded_index_rank, x, cases, V, TOPK)
        ref = finish_jax(proc, out)
    return cases, ranks, ref


def _case_ids():
    return [c["name"] for c in shard_cases(N)]


@pytest.mark.parametrize("name", _case_ids())
def test_mesh_paths_equal_jax_and_one_process(mesh_runs, name):
    cases, ranks, ref = mesh_runs
    case = next(c for c in cases if c["name"] == name)
    outs = [r[name] for r in ranks]
    if "error" in case:
        for out in outs:
            assert out["error"] == str(ref[name + "|error"])
            assert case["error"] in out["error"]
        return
    first = outs[0]
    for out in outs[1:]:     # every rank returns the same result
        np.testing.assert_array_equal(out["v"], first["v"])
        np.testing.assert_array_equal(out["i"], first["i"])
    doc_only = case["kind"] == "sharded"
    held((first["v"], first["i"]), (ref[name + "|v"], ref[name + "|i"]),
         tol=DOC_TOL if doc_only else SUM_TOL, exact_ids=doc_only)
    # against this process's result: ids equal, and the same bits where
    # a psum adds two partials
    np.testing.assert_array_equal(first["i"], first["one_i"])
    if case["same_bits"]:
        np.testing.assert_array_equal(first["v"], first["one_v"])
    else:
        np.testing.assert_allclose(first["v"], first["one_v"],
                                   rtol=SUM_TOL, atol=SUM_TOL)


def test_both_2d_orientations_give_the_same_bits(mesh_runs):
    _, ranks, _ = mesh_runs
    for rank in ranks:
        for suffix in ("", "_pruned"):
            a, b = (rank[f"2x2|grid2x2|{o}{suffix}"]
                    for o in ("doc_term", "term_doc"))
            np.testing.assert_array_equal(a["v"], b["v"])
            np.testing.assert_array_equal(a["i"], b["i"])


def test_mesh_cases_cover_the_meshes():
    assert {tuple(m) for m, _ in SHARD_MESHES} == {(4,), (2, 2), (1, 4)}
    assert len(_case_ids()) == len(set(_case_ids()))
