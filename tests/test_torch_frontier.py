"""The port's serving frontier against the JAX package (CPU): the query
and hot-posting caches, ``CachedEngine``, the builder's ``base_scorer``
seam, ``TenantPool``, and the serve CLI's frontier flags.

Each package gets the same numpy inputs: a numpy encode stub feeding its
own ``SparseRep`` and one fake clock each. Cache keys, byte accounting,
LRU order, the pinned terms, hit and miss counts, the pool's dispatch
sequence and stats must be equal. The hot windows must equal
``index_windows`` bit for bit and ``hot_fused_retrieve`` the port's
``fused_retrieve`` bit for bit; against JAX's ``hot_fused_retrieve``
(Pallas in interpret mode) the ids are equal and the values within 1e-6
(the same f32 products summed in another order). Cache-on must equal
cache-off exactly, including through the churn property test.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import retrieval as jr
from repro.retrieval.sparse_rep import SparseRep as JSparseRep
from repro.runtime import faults as jfaults
from repro.runtime import frontier as jfront
from repro.runtime import serving as jserving
from repro.runtime.frontier.caches import ENTRY_OVERHEAD_BYTES as J_OVERHEAD
from repro_torch.kernels.impact_score import index_windows, term_rows
from repro_torch.launch import serve
from repro_torch.retrieval.engine import IndexBuilder
from repro_torch.retrieval.index import build_inverted_index
from repro_torch.retrieval.score import fused_retrieve
from repro_torch.retrieval.sparse_rep import SparseRep, query_columns
from repro_torch.retrieval.sparse_rep import stack_rows
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import frontier as tfront
from repro_torch.runtime import serving as tserving
from repro_torch.runtime.frontier.caches import (ENTRY_OVERHEAD_BYTES,
                                                 hot_windows)

VOCAB = 64
VAL_TOL = 1e-6
PKGS = {"jax": (jfront, jserving, jfaults, JSparseRep),
        "torch": (tfront, tserving, tfaults, SparseRep)}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def np_encoder(rep_cls, width=4, vocab=VOCAB):
    """Numpy encode stub: the top-``width`` token counts of each row."""

    def encode(tokens, mask):
        toks = np.asarray(tokens)
        msk = np.asarray(mask)
        B = toks.shape[0]
        vals = np.zeros((B, width), np.float32)
        idxs = np.zeros((B, width), np.int32)
        for i in range(B):
            ids, counts = np.unique(toks[i][msk[i] > 0] % vocab,
                                    return_counts=True)
            order = np.argsort(-counts, kind="stable")[:width]
            vals[i, :order.size] = counts[order]
            idxs[i, :order.size] = ids[order]
        return rep_cls(vals, idxs, (vals > 0).sum(axis=1).astype(np.int32))

    return encode


def make_engine(pkg, n_docs=24, seed=0, encode=None, **kw):
    _, serving, _, rep_cls = PKGS[pkg]
    if pkg == "torch":
        kw.setdefault("device", "cpu")
    eng = serving.CorpusEngine(
        serving.BatchedEncoder(encode or np_encoder(rep_cls),
                               policy=serving.BatchPolicy(max_batch=8)),
        VOCAB, **kw)
    rng = np.random.default_rng(seed)
    eng.add_docs(list(rng.integers(1, VOCAB, size=(n_docs, 12))
                      .astype(np.int32)))
    eng.flush()
    return eng


def encode_queries(eng, toks):
    toks = np.asarray(toks, np.int32)
    if toks.ndim == 1:
        toks = toks[None, :]
    return eng.encoder.encode_fn(toks, np.ones_like(toks))


def make_cached(pkg, eng, cache_bytes=1 << 20, hot=True, tag="corpus"):
    front = PKGS[pkg][0]
    return front.CachedEngine(
        eng, result_cache=front.QueryResultCache(cache_bytes),
        hot_cache=front.HotPostingCache(cache_bytes // 4) if hot else None,
        tag=tag)


def row(rep_cls, values, indices):
    v = np.asarray(values, np.float32)[None, :]
    i = np.asarray(indices, np.int32)[None, :]
    return rep_cls(v, i, (v > 0).sum(axis=1).astype(np.int32))


def _frozen(n_docs=40, seed=1, vocab=VOCAB):
    """The same corpus indexed by each package; and its query stub."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, vocab, size=(n_docs, 12)).astype(np.int32)
    ones = np.ones_like(toks)
    t_index = build_inverted_index(np_encoder(SparseRep, vocab=vocab)(
        toks, ones), vocab, device="cpu")
    j_index = jr.build_inverted_index(np_encoder(JSparseRep, vocab=vocab)(
        toks, ones), vocab)
    return t_index, j_index


def _queries(seed, n=5, vocab=VOCAB, width=4):
    toks = np.random.default_rng(seed).integers(
        1, vocab, size=(n, 12)).astype(np.int32)
    ones = np.ones_like(toks)
    return (np_encoder(SparseRep, width, vocab)(toks, ones),
            np_encoder(JSparseRep, width, vocab)(toks, ones))


# ---------------------------------------------------------------------------
# query_cache_key
# ---------------------------------------------------------------------------

KEY_CASES = [
    ([3.0, 2.0, 0.0], [5, 9, 0], 10, {}, "corpus", 0, None),
    ([3.0, 2.0, 0.0, 0.0, 0.0], [5, 9, 0, 0, 0], 10, {}, "corpus", 0, None),
    ([3.0, 2.0], [5, 9], 10, {"method": "fused"}, "t1", 7, None),
    ([3.0, 2.0], [5, 9], 10, {"method": "pruned", "prune_margin": 0.5,
                              "candidates": None}, "corpus", 3, None),
    ([1.234567, 0.5], [1, 2], 5, {"q_width": 2, "method": "auto"}, "x",
     2**40, 2),
    ([0.0, 0.0], [0, 0], 1, {}, "empty", 0, None),
]


@pytest.mark.parametrize("case", range(len(KEY_CASES)))
def test_key_digests_equal_jax(case):
    vals, ids, k, kw, tag, gen, dec = KEY_CASES[case]
    want = jfront.query_cache_key(row(JSparseRep, vals, ids), k, kw, tag,
                                  gen, decimals=dec)
    got = tfront.query_cache_key(row(SparseRep, vals, ids), k, kw, tag, gen,
                                 decimals=dec)
    assert got == want
    # a torch-tensor row keys the same
    t_row = row(SparseRep, vals, ids)
    t_row = SparseRep(*(torch.from_numpy(np.asarray(a)) for a in
                        (t_row.values, t_row.indices, t_row.nnz)))
    assert tfront.query_cache_key(t_row, k, kw, tag, gen,
                                  decimals=dec) == want


def test_key_normalizes_padding_and_is_sensitive_as_jax():
    a = row(SparseRep, [3.0, 2.0, 0.0], [5, 9, 0])
    b = row(SparseRep, [3.0, 2.0, 0.0, 0.0], [5, 9, 0, 0])
    key = tfront.query_cache_key
    assert key(a, 10, {}, "c", 0) == key(b, 10, {}, "c", 0)
    base = key(a, 10, {}, "c", 0)
    for other in (key(a, 11, {}, "c", 0), key(a, 10, {}, "d", 0),
                  key(a, 10, {}, "c", 1),
                  key(a, 10, {"method": "fused"}, "c", 0),
                  key(row(SparseRep, [3.0, 2.5], [5, 9]), 10, {}, "c", 0)):
        assert other != base
    assert key(a, 10, {"m": None}, "c", 0) == base


# ---------------------------------------------------------------------------
# QueryResultCache: byte accounting, LRU order, eviction, stats
# ---------------------------------------------------------------------------

def _cache_script(front, capacity):
    """A scripted sequence of puts, gets and invalidations; the cache's
    state after every step."""
    cache = front.QueryResultCache(capacity)
    trace = []

    def entry(n, seed):
        r = np.random.default_rng(seed)
        return (r.standard_normal(n).astype(np.float32),
                r.integers(0, 100, n).astype(np.int64))

    ops = [("put", b"a", "t0", 0, 5), ("put", b"b", "t0", 0, 5),
           ("get", b"a"), ("put", b"c", "t1", 0, 5), ("get", b"b"),
           ("put", b"d", "t0", 1, 10), ("get", b"zz"), ("put", b"a", "t0",
                                                        1, 3),
           ("invalidate", "t0", 1), ("put", b"huge", "t1", 0, 10_000),
           ("get", b"c"), ("put", b"e", "t1", 2, 2),
           ("invalidate", "t1", 2), ("get", b"e"), ("get", b"d")]
    for i, op in enumerate(ops):
        if op[0] == "put":
            vals, ids = entry(op[4], i)
            cache.put(op[1], op[2], op[3], vals, ids)
            res = None
        elif op[0] == "get":
            got = cache.get(op[1])
            res = None if got is None else (got[0].tolist(),
                                            got[1].tolist())
        else:
            res = cache.invalidate(op[1], op[2])
        trace.append((res, list(cache._entries), cache.bytes_used,
                      len(cache), dict(cache.counters), cache.stats()))
    return trace


@pytest.mark.parametrize("capacity", [200, 400, 700, 1 << 20])
def test_result_cache_script_equals_jax(capacity):
    assert ENTRY_OVERHEAD_BYTES == J_OVERHEAD
    assert _cache_script(tfront, capacity) == _cache_script(jfront, capacity)


def test_result_cache_returns_copies_and_rejects_bad_capacity():
    cache = tfront.QueryResultCache(1 << 20)
    cache.put(b"k", "t", 0, np.ones(3, np.float32), np.arange(3))
    v, i = cache.get(b"k")
    v[:] = 9
    i[:] = 9
    v2, i2 = cache.get(b"k")
    assert v2.tolist() == [1.0] * 3 and i2.tolist() == [0, 1, 2]
    for cls in (tfront.QueryResultCache, tfront.HotPostingCache):
        with pytest.raises(ValueError, match="capacity"):
            cls(0)


# ---------------------------------------------------------------------------
# HotPostingCache and hot_fused_retrieve
# ---------------------------------------------------------------------------

def _per_window(index):
    return int(index.max_postings) * 8 + ENTRY_OVERHEAD_BYTES


@pytest.mark.parametrize("windows", [0, 1, 3, 17, 10_000])
@pytest.mark.parametrize("top_m", [1 << 30, 5])
def test_hot_cache_pins_the_terms_jax_pins(windows, top_m):
    t_index, j_index = _frozen()
    cap = max(1, windows * _per_window(t_index))
    hot_t = tfront.HotPostingCache(cap, top_m=top_m)
    hot_j = jfront.HotPostingCache(cap, top_m=top_m)
    hot_t.ensure(t_index, 0)
    hot_j.ensure(j_index, 0)
    assert hot_t._terms.tolist() == list(hot_j._windows)   # heaviest first
    assert hot_t.bytes_pinned == hot_j.bytes_pinned <= cap
    assert hot_t.stats() == hot_j.stats()
    for t in list(hot_j._windows)[:4] + [0, 63, 64, -1]:
        got, want = hot_t.window(t), hot_j.window(t)
        assert (got is None) == (want is None)
        if want is not None:
            assert got[0].tolist() == want[0].tolist()
            assert got[1].tolist() == want[1].tolist()
    assert hot_t.stats() == hot_j.stats()


def test_hot_cache_rebuilds_on_generation_and_index_as_jax():
    t_index, j_index = _frozen()
    t_other, j_other = _frozen(seed=5)
    hot_t = tfront.HotPostingCache(1 << 20)
    hot_j = jfront.HotPostingCache(1 << 20)
    for (ti, ji), gen in (((t_index, j_index), 0), ((t_index, j_index), 0),
                          ((t_index, j_index), 1), ((t_other, j_other), 1),
                          ((t_other, j_other), 1)):
        hot_t.ensure(ti, gen)
        hot_j.ensure(ji, gen)
        assert hot_t.stats() == hot_j.stats()
        assert hot_t.generation == hot_j.generation == gen
    assert hot_t.stats()["rebuilds"] == 3
    assert hot_t.stats()["invalidations"] == 2


@pytest.mark.parametrize("windows", [0, 2, 10_000])
def test_hot_windows_equal_index_windows_bit_for_bit(windows):
    t_index, _ = _frozen()
    q_t, _ = _queries(2, width=6)
    hot = tfront.HotPostingCache(max(1, windows * _per_window(t_index)))
    hot.ensure(t_index, 0)
    w, docs = hot_windows(q_t, t_index, hot=hot)
    qi, qv = query_columns(q_t, "cpu")
    want = index_windows(qi, qv, t_index.term_starts, t_index.term_lens,
                         t_index.postings_doc, t_index.postings_val,
                         t_index.max_postings)
    assert torch.equal(w, want[0]) and torch.equal(docs, want[1])
    assert w.dtype == torch.float32 and docs.dtype == torch.int32
    live = int((qv > 0).sum())
    assert hot.counters["hits"] + hot.counters["misses"] == live
    assert (hot.counters["hits"] > 0) == (windows > 0)


@pytest.mark.parametrize("windows", [0, 1, 4, 10_000])
def test_hot_fused_retrieve_equals_fused_and_jax(windows):
    t_index, j_index = _frozen()
    q_t, q_j = _queries(2)
    rv, ri = fused_retrieve(q_t, t_index, 7)
    cap = max(1, windows * _per_window(t_index))
    hot_t = tfront.HotPostingCache(cap)
    hot_t.ensure(t_index, 0)
    hv, hi = tfront.hot_fused_retrieve(q_t, t_index, 7, hot=hot_t)
    assert torch.equal(hv, rv) and torch.equal(hi, ri)
    hot_j = jfront.HotPostingCache(cap)
    hot_j.ensure(j_index, 0)
    jv, ji = jfront.hot_fused_retrieve(q_j, j_index, 7, hot=hot_j)
    np.testing.assert_array_equal(hi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(hv.numpy(), np.asarray(jv), rtol=0,
                               atol=VAL_TOL)
    assert hot_t.stats() == hot_j.stats()
    # warm: a second call, the same bits
    again = tfront.hot_fused_retrieve(q_t, t_index, 7, hot=hot_t)
    assert torch.equal(again[0], hv) and torch.equal(again[1], hi)


def test_hot_fused_reads_ids_outside_vocab_as_the_ports_fused():
    """Ids at or past V and negative ids read the term ``term_rows`` gives
    (a negative id plus V, then clamped), as the port's fused path does;
    the JAX hot path raises IndexError on an id at or past V (a fault of
    the reference that the port does not copy)."""
    t_index, j_index = _frozen()
    vals = np.array([[3.0, 2.0, 1.0, 1.0], [2.0, 2.0, 1.0, 0.0]], np.float32)
    active = np.flatnonzero(t_index.term_lens.numpy() > 0)
    # negative ids that wrap onto terms with postings (pinned when the
    # cache is large enough), ids past V, and one clamped to term 0
    ids = np.array([[VOCAB + 5, active[0] - VOCAB, 7, 2 * VOCAB],
                    [-1, -VOCAB - 9, active[-1] - VOCAB, 0]], np.int32)
    nnz = (vals > 0).sum(axis=1).astype(np.int32)
    q_t = SparseRep(vals, ids, nnz)
    rv, ri = fused_retrieve(q_t, t_index, 6)
    read = term_rows(torch.from_numpy(ids), VOCAB).numpy()[vals > 0]
    for windows in (0, 3, 10_000):
        hot = tfront.HotPostingCache(max(1, windows * _per_window(t_index)))
        hot.ensure(t_index, 0)
        hv, hi = tfront.hot_fused_retrieve(q_t, t_index, 6, hot=hot)
        assert torch.equal(hv, rv) and torch.equal(hi, ri)
        # a look-up counts the term the id reads
        pinned = set(hot._terms.tolist())
        assert hot.counters["hits"] == sum(int(t) in pinned for t in read)
        assert hot.counters["misses"] == read.size - hot.counters["hits"]
    hot_j = jfront.HotPostingCache(1 << 20)
    hot_j.ensure(j_index, 0)
    with pytest.raises(IndexError):
        jfront.hot_fused_retrieve(JSparseRep(vals, ids, nnz), j_index, 6,
                                  hot=hot_j)


# ---------------------------------------------------------------------------
# the builder's base_scorer seam
# ---------------------------------------------------------------------------

def test_base_scorer_seam_is_called_as_jax_calls_it():
    calls = {"torch": [], "jax": []}

    def recorder(pkg, answer=None):
        def scorer(queries, base, k, resolved, kw):
            calls[pkg].append((type(base).__name__, k, resolved, kw))
            return answer
        return scorer

    q_t = _queries(3, n=3)[0]
    for pkg, eng in (("torch", make_engine("torch", n_docs=30)),
                     ("jax", make_engine("jax", n_docs=30))):
        q = q_t if pkg == "torch" else _queries(3, n=3)[1]
        plain = eng.search(q, 5)
        for method in ("auto", "impact", "fused"):
            got = eng.builder.search(q, 5, method=method,
                                     base_scorer=recorder(pkg))
            want = eng.builder.search(q, 5, method=method)
            assert all(np.array_equal(a, b) for a, b in zip(got, want))
        assert all(np.array_equal(a, b) for a, b in
                   zip(eng.search(q, 5, base_scorer=recorder(pkg)), plain))
        eng.add_docs([np.arange(1, 13, dtype=np.int32)])   # a delta
        eng.search(q, 50, method="fused", base_scorer=recorder(pkg))
    assert calls["torch"] == calls["jax"]
    assert [c[2] for c in calls["torch"]] == ["impact", "impact", "fused",
                                              "impact", "fused"]


def test_base_scorer_answer_replaces_the_base_only():
    """A scorer's answer stands for the base segment's; the delta is still
    scored and merged, and slots map to external ids as before."""
    eng = make_engine("torch", n_docs=30)
    eng.add_docs([np.arange(1, 13, dtype=np.int32)])
    eng.flush()
    q = _queries(4, n=2)[0]
    n_base = eng.builder._base.n_docs

    def scorer(queries, base, k, resolved, kw):
        b = queries.values.shape[0]
        return (torch.full((b, k), -5.0),
                torch.zeros((b, k), dtype=torch.int32))

    vals, ids = eng.builder.search(q, 4, base_scorer=scorer)
    assert vals.shape == ids.shape == (2, 4)
    assert (vals[:, 0] >= 0).all()            # the delta's one doc
    assert (ids[:, 0] == eng.builder._ext_ids[n_base]).all()
    assert (vals[:, 1:] == -5.0).all()
    assert (ids[:, 1:] == eng.builder._ext_ids[0]).all()


# ---------------------------------------------------------------------------
# CachedEngine
# ---------------------------------------------------------------------------

def test_cached_engine_hit_pass_equals_miss_pass_and_cache_off():
    out = {}
    for pkg in ("torch", "jax"):
        eng = make_engine(pkg)
        cached = make_cached(pkg, eng)
        q = encode_queries(eng, np.random.default_rng(3).integers(
            1, VOCAB, size=(4, 12)))
        v1, i1 = cached.search(q, 5)
        rv, ri = eng.search(q, 5)
        assert np.array_equal(v1, np.asarray(rv))
        assert np.array_equal(i1, np.asarray(ri))
        v2, i2 = cached.search(q, 5)
        assert np.array_equal(v1, v2) and np.array_equal(i1, i2)
        assert i1.dtype == np.int64 and v1.dtype == np.float32
        out[pkg] = (i1, v1, cached.results.stats())
    assert out["torch"][2] == out["jax"][2]
    assert out["torch"][2]["hits"] == 4 and out["torch"][2]["misses"] == 4
    np.testing.assert_array_equal(out["torch"][0], out["jax"][0])
    np.testing.assert_allclose(out["torch"][1], out["jax"][1], atol=1e-4)


def test_cached_engine_mixed_batch_rebatches_only_misses():
    eng = make_engine("torch")
    cached = make_cached("torch", eng)
    rng = np.random.default_rng(4)
    warm = encode_queries(eng, rng.integers(1, VOCAB, size=(2, 12)))
    cached.search(warm, 5)
    cold = encode_queries(eng, rng.integers(1, VOCAB, size=(2, 12)))
    mixed = stack_rows([warm, cold])
    seen = []
    search = eng.builder.search

    def spy(queries, k, **kw):
        seen.append(queries.values.shape[0])
        return search(queries, k, **kw)

    eng.builder.search = spy
    cv, ci = cached.search(mixed, 5)
    del eng.builder.search
    assert seen == [2]                         # one search of the misses
    assert cached.results.stats()["hits"] == 2
    rv, ri = eng.search(mixed, 5)
    assert np.array_equal(cv, rv) and np.array_equal(ci, ri)


@pytest.mark.parametrize("hot_bytes", [3000, 1 << 20])
def test_cached_fused_search_uses_hot_windows_as_jax(hot_bytes):
    stats = {}
    for pkg in ("torch", "jax"):
        front = PKGS[pkg][0]
        eng = make_engine(pkg, n_docs=40)
        cached = front.CachedEngine(
            eng, result_cache=front.QueryResultCache(1 << 20),
            hot_cache=front.HotPostingCache(hot_bytes))
        q = encode_queries(eng, np.random.default_rng(5).integers(
            1, VOCAB, size=(3, 12)))
        cv, ci = cached.search(q, 5, method="fused")
        rv, ri = eng.search(q, 5, method="fused")
        assert np.array_equal(cv, rv) and np.array_equal(ci, ri)
        stats[pkg] = (cached.hot.stats(), cached.results.stats(), ci)
    assert stats["torch"][0]["hits"] > 0
    assert stats["torch"][:2] == stats["jax"][:2]
    np.testing.assert_array_equal(stats["torch"][2], stats["jax"][2])


@pytest.mark.parametrize("method", ["auto", "impact", "pruned"])
def test_hot_scorer_declines_off_fused(method):
    """``auto``, ``impact`` and ``pruned`` (forward rows) decline; so does
    ``fused`` over a quantized base (K5's path)."""
    eng = make_engine("torch", n_docs=40, keep_forward=method == "pruned")
    cached = make_cached("torch", eng)
    q = encode_queries(eng, np.random.default_rng(6).integers(
        1, VOCAB, size=(3, 12)))
    cv, ci = cached.search(q, 5, method=method)
    rv, ri = eng.search(q, 5, method=method)
    assert np.array_equal(cv, rv) and np.array_equal(ci, ri)
    assert cached.hot.stats()["rebuilds"] == 0
    quant = make_engine("torch", n_docs=40, quantize=True)
    cached = make_cached("torch", quant)
    cv, ci = cached.search(q, 5, method="fused")
    rv, ri = quant.search(q, 5, method="fused")
    assert np.array_equal(cv, rv) and np.array_equal(ci, ri)
    assert cached.hot.stats()["rebuilds"] == 0


def test_cached_engine_never_serves_stale_after_mutation():
    for pkg in ("torch", "jax"):
        eng = make_engine(pkg)
        cached = make_cached(pkg, eng)
        rng = np.random.default_rng(6)
        q = encode_queries(eng, rng.integers(1, VOCAB, size=(2, 12)))
        cached.search(q, 5, method="fused")
        gen0 = eng.builder.generation
        ids = cached.add_docs(list(rng.integers(
            1, VOCAB, size=(4, 12)).astype(np.int32)))
        cv, ci = cached.search(q, 5, method="fused")
        assert eng.builder.generation > gen0
        assert cached.results.counters["invalidations"] >= 1
        rv, ri = eng.search(q, 5, method="fused")
        assert np.array_equal(cv, rv) and np.array_equal(ci, ri)
        cached.remove_docs([int(i) for i in ids])
        cv, ci = cached.search(q, 5, method="fused")
        rv, ri = eng.search(q, 5, method="fused")
        assert np.array_equal(cv, rv) and np.array_equal(ci, ri)
        assert not set(ids.tolist()) & set(ci.ravel().tolist())


def test_generation_moves_on_the_mutations_jax_counts():
    builders = {"torch": IndexBuilder(VOCAB, device="cpu"),
                "jax": jr.IndexBuilder(VOCAB)}
    rng = np.random.default_rng(8)
    rows = [np_encoder(SparseRep)(t, np.ones_like(t)) for t in
            rng.integers(1, VOCAB, size=(5, 6, 12)).astype(np.int32)]
    gens = {pkg: [] for pkg in builders}
    for pkg, b in builders.items():
        rep = SparseRep if pkg == "torch" else JSparseRep
        for step, r in enumerate(rows):
            b.add(rep(r.values, r.indices, r.nnz))
            gens[pkg].append(b.generation)
            b.flush()
            gens[pkg].append(b.generation)
            b.flush()                      # clean: no bump
            gens[pkg].append(b.generation)
            b.remove([step, 999])
            gens[pkg].append(b.generation)
            b.remove([999])                # nothing removed: no bump
            gens[pkg].append(b.generation)
        b.flush(force_compact=True)
        gens[pkg].append(b.generation)
    assert gens["torch"] == gens["jax"]


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000))
def test_churn_property_cache_on_equals_cache_off(seed):
    """Arbitrary add/remove/flush/compact interleavings: after every step
    the cached frontend (fused through the hot windows, and auto) matches
    the raw engine exactly."""
    eng = make_engine("torch", n_docs=10, seed=seed)
    cached = make_cached("torch", eng, cache_bytes=8192,
                         tag=f"churn{seed}")
    rng = np.random.default_rng(seed)
    catalog = rng.integers(1, VOCAB, size=(6, 12)).astype(np.int32)
    removable = []
    for step in range(8):
        op = ("add", "remove", "flush", "compact",
              "none")[int(rng.integers(0, 5))]
        if op == "add":
            ids = cached.add_docs(list(rng.integers(
                1, VOCAB, size=(3, 12)).astype(np.int32)))
            removable.extend(int(i) for i in ids)
        elif op == "remove" and removable:
            cached.remove_docs(removable[:2])
            removable = removable[2:]
        elif op == "flush":
            cached.flush()
        elif op == "compact":
            cached.flush(force_compact=True)
        q = encode_queries(
            eng, catalog[rng.integers(0, len(catalog), size=3)])
        for method in ("fused", "auto"):
            cv, ci = cached.search(q, 5, method=method)
            rv, ri = eng.search(q, 5, method=method)
            assert np.array_equal(ci, ri), (seed, step, op, method)
            assert np.array_equal(cv, rv), (seed, step, op, method)


def test_cached_engine_propagates_strict_kwargs():
    eng = make_engine("torch")
    cached = make_cached("torch", eng)
    q = encode_queries(eng, np.arange(1, 13))
    with pytest.raises(TypeError, match="bogus"):
        cached.search(q, 5, bogus=1)
    with pytest.raises(TypeError, match="prune_margin"):
        cached.search(q, 5, method="fused", prune_margin=0.5)
    cv, ci = cached.search(q, 5, method="fused", prune_margin=None)
    rv, ri = eng.search(q, 5, method="fused")
    assert np.array_equal(cv, rv) and np.array_equal(ci, ri)


# ---------------------------------------------------------------------------
# TenantPool
# ---------------------------------------------------------------------------

def make_pool(pkg, clock, encode=None, tenants=("a", "b"), weights=None,
              max_batch=4, **pool_kw):
    front, serving, _, rep_cls = PKGS[pkg]
    be = serving.BatchedEncoder(encode or np_encoder(rep_cls),
                                policy=serving.BatchPolicy(
                                    max_batch=max_batch, max_wait_s=10.0))
    pool = front.TenantPool(be, clock=clock, **pool_kw)
    for name in tenants:
        w = (weights or {}).get(name, 1.0)
        add_tenant(pkg, pool, name, quota=front.TenantQuota(weight=w))
    return pool


def add_tenant(pkg, pool, name, **kw):
    """``pool.add_tenant`` at VOCAB, the port's engine on the CPU."""
    if pkg == "torch":
        kw["device"] = "cpu"
    return pool.add_tenant(name, VOCAB, **kw)


def req(serving, uid, token=None, deadline_s=None):
    toks = np.arange(1, 9, dtype=np.int32)
    if token is not None:
        toks = toks.copy()
        toks[0] = token
    return serving.Request(uid=uid, tokens=toks, deadline_s=deadline_s)


def _pool_script(pkg):
    """Three weighted tenants under contention, a poison token in one, a
    one-shot OOM, a deadline that expires, ticks and forced ticks: the
    dispatch sequence, outcomes and stats."""
    front, serving, faults, rep_cls = PKGS[pkg]
    clock = FakeClock()
    poison = VOCAB + 7
    encode = faults.inject_faults(
        np_encoder(rep_cls),
        [{"on": {"call": 5}, "exc": "oom", "times": 1},
         {"on": {"token": poison}}],
        sleep=clock.advance)
    pool = make_pool(pkg, clock, encode=encode, tenants=("a", "b", "c"),
                     weights={"a": 1.0, "b": 2.0, "c": 3.0},
                     cache_bytes=1 << 16, hot_cache_bytes=1 << 14)
    dispatches = []
    uid = 0
    for rnd in range(6):
        for name in ("a", "b", "c"):
            for _ in range(4):
                token = poison if name == "b" and uid % 7 == 3 else None
                deadline = 0.5 if uid % 11 == 5 else None
                pool.submit(name, req(serving, uid, token=token,
                                      deadline_s=deadline))
                uid += 1
        for _ in range(2):
            dispatches.append(pool.tick(force=True))
        clock.advance(0.6)
        dispatches.append(pool.tick())
    pool.drain()
    names = {u: ("a", "b", "c")[(u // 4) % 3] for u in range(uid)}
    outcomes = []
    for u in range(uid):
        r = pool.take(names[u], u)
        outcomes.append(type(r).__name__ if not hasattr(r, "values")
                        else np.asarray(r.values).tolist())
    return dispatches, outcomes, pool.stats(), encode.log


def test_pool_dispatch_sequence_and_stats_equal_jax():
    got, want = _pool_script("torch"), _pool_script("jax")
    assert got[0] == want[0]                  # (tenant, n) per tick
    assert got[1] == want[1]
    assert got[3] == want[3]
    st_t, st_j = got[2], want[2]
    assert set(st_t) == set(st_j)
    for name in ("a", "b", "c"):
        assert st_t["tenants"][name] == st_j["tenants"][name], name
    assert st_t["result_cache"] == st_j["result_cache"]
    assert st_t["memory_bytes"] == st_j["memory_bytes"]
    # the cases the script means to reach
    per = st_t["tenants"]
    assert per["b"]["failed"] > 0
    assert per["a"]["failed"] == per["c"]["failed"] == 0
    assert sum(t["oom_faults"] for t in per.values()) == 1
    assert sum(t["shed_expired"] for t in per.values()) > 0


def test_pool_weighted_fairness_under_contention():
    clock = FakeClock()
    out = {}
    for pkg in ("torch", "jax"):
        serving = PKGS[pkg][1]
        pool = make_pool(pkg, clock, weights={"a": 2.0, "b": 1.0})
        for uid in range(80):
            pool.submit("a" if uid % 2 else "b", req(serving, uid))
        out[pkg] = [pool.tick(force=True) for _ in range(12)]
    assert out["torch"] == out["jax"]
    served = {n: sum(k for name, k in out["torch"] if name == n)
              for n in ("a", "b")}
    assert served["a"] + served["b"] == 48
    assert served["a"] / served["b"] == pytest.approx(2.0, rel=0.25)


def test_pool_poison_confined_to_submitting_tenant():
    clock = FakeClock()
    poison_token = VOCAB + 7
    encode = tfaults.inject_faults(
        np_encoder(SparseRep), [{"on": {"token": poison_token}}],
        seed=0, sleep=clock.advance)
    pool = make_pool("torch", clock, encode=encode, tenants=("a", "b", "c"))
    for uid in range(24):
        name = ("a", "b", "c")[uid % 3]
        token = poison_token if name == "c" and uid % 6 == 2 else None
        pool.submit(name, req(tserving, uid, token=token))
    pool.drain()
    st = pool.stats()["tenants"]
    assert st["c"]["failed"] > 0
    for victim in ("a", "b"):
        assert st[victim]["failed"] == st[victim]["shed"] == 0
        assert st[victim]["served"] == 8


def test_pool_max_docs_quota_refuses_before_applying():
    for pkg in ("torch", "jax"):
        front = PKGS[pkg][0]
        pool = make_pool(pkg, FakeClock(), tenants=())
        add_tenant(pkg, pool, "a", quota=front.TenantQuota(max_docs=4))
        docs = list(np.random.default_rng(0).integers(
            1, VOCAB, size=(3, 12)).astype(np.int32))
        pool.add_docs("a", docs)
        pool.tenant("a").engine.flush()
        gen = pool.tenant("a").engine.builder.generation
        with pytest.raises(front.QuotaExceeded, match="max_docs"):
            pool.add_docs("a", docs)       # 3 live + 3 > 4
        assert pool.tenant("a").live_docs == 3
        assert pool.tenant("a").engine.builder.generation == gen


def test_pool_memory_budget_compacts_then_refuses():
    seen = {}
    for pkg in ("torch", "jax"):
        front = PKGS[pkg][0]
        pool = make_pool(pkg, FakeClock(), tenants=("a",), max_batch=8)
        rng = np.random.default_rng(0)
        ids = pool.add_docs("a", list(rng.integers(
            1, VOCAB, size=(8, 12)).astype(np.int32)))
        pool.tenant("a").engine.flush()
        pool.remove_docs("a", [int(i) for i in ids[:2]])
        # over budget by the tombstones' rows: compaction reclaims them
        pool.memory_budget_bytes = pool.memory_bytes() - 1
        compactions = pool.tenant("a").engine.builder.n_compactions
        pool.add_docs("a", list(rng.integers(
            1, VOCAB, size=(2, 12)).astype(np.int32)))
        assert (pool.tenant("a").engine.builder.n_compactions
                == compactions + 1)
        # now over with nothing to reclaim: refused
        pool.tenant("a").engine.flush()
        pool.memory_budget_bytes = pool.memory_bytes() - 1
        with pytest.raises(front.QuotaExceeded, match="memory budget"):
            pool.add_docs("a", list(rng.integers(
                1, VOCAB, size=(2, 12)).astype(np.int32)))
        seen[pkg] = (pool.memory_bytes(), pool.tenant("a").live_docs)
    assert seen["torch"] == seen["jax"]


def test_pool_unknown_tenant_and_duplicate_name():
    pool = make_pool("torch", FakeClock())
    with pytest.raises(KeyError, match="unknown tenant"):
        pool.submit("nope", req(tserving, 0))
    with pytest.raises(ValueError, match="already exists"):
        add_tenant("torch", pool, "a")
    with pytest.raises(ValueError, match="weight"):
        tfront.TenantQuota(weight=0.0)


def test_pool_shared_cache_is_namespaced_per_tenant():
    hits = {}
    for pkg in ("torch", "jax"):
        pool = make_pool(pkg, FakeClock(), cache_bytes=1 << 20,
                         hot_cache_bytes=1 << 12)
        rng = np.random.default_rng(0)
        for name in ("a", "b"):
            pool.add_docs(name, list(rng.integers(
                1, VOCAB, size=(6, 12)).astype(np.int32)))
            pool.tenant(name).engine.flush()
        q = encode_queries(pool.tenant("a").engine,
                           rng.integers(1, VOCAB, size=(2, 12)))
        trace = []
        for name, kw in (("a", {}), ("a", {}), ("b", {}),
                         ("a", {"method": "fused"}), ("b", {})):
            pool.search(name, q, 5, **kw)
            trace.append(pool.result_cache.counters["hits"])
        pool.add_docs("b", list(rng.integers(
            1, VOCAB, size=(2, 12)).astype(np.int32)))
        pool.search("b", q, 5)
        pool.search("a", q, 5)         # b's churn left a's entries
        trace.append(pool.result_cache.counters["hits"])
        hits[pkg] = (trace, pool.stats()["result_cache"])
        cv, ci = pool.search("a", q, 5, method="fused")
        rv, ri = pool.tenant("a").engine.search(q, 5, method="fused")
        assert np.array_equal(cv, np.asarray(rv))
        assert np.array_equal(ci, np.asarray(ri))
    assert hits["torch"] == hits["jax"]
    assert hits["torch"][0] == [0, 2, 2, 2, 4, 6]


def test_pool_search_merges_degrade_kwargs_under_the_callers():
    pool = make_pool("torch", FakeClock(), tenants=("a",))
    pool.add_docs("a", list(np.random.default_rng(1).integers(
        1, VOCAB, size=(6, 12)).astype(np.int32)))
    q = encode_queries(pool.tenant("a").engine, np.arange(1, 13))
    pool.tenant("a").loop.degrade.level = 1     # pruned rung
    with pytest.raises(ValueError, match="forward rows"):
        pool.search("a", q, 5)       # the rung asks for pruned
    v, i = pool.search("a", q, 5, method="impact", prune_margin=None)
    rv, ri = pool.tenant("a").engine.search(q, 5, method="impact")
    assert np.array_equal(v, rv) and np.array_equal(i, ri)


# ---------------------------------------------------------------------------
# the serve CLI's frontier flags (CPU)
# ---------------------------------------------------------------------------

def _cli(capsys, *args):
    rc = serve.main(["--device", "cpu", "--corpus", "64", "--requests", "8",
                     *args])
    return rc, capsys.readouterr().out


def test_serve_cli_cached_engine(capsys):
    rc, out = _cli(capsys, "--engine", "--cache-mb", "1")
    assert rc == 0, out
    assert "retrieval[fused/cached]: top-10 for 8 queries" in out
    line = [ln for ln in out.splitlines() if ln.startswith("frontier")][0]
    assert "hit ratio 0.5" in line and "hot windows:" in line
    assert "0 terms" not in line


def test_serve_cli_tenants_continuous_deadline(capsys):
    rc, out = _cli(capsys, "--engine", "--tenants", "3", "--cache-mb", "1",
                   "--continuous", "--deadline-ms", "1000", "--requests",
                   "12")
    assert rc == 0, out
    lines = out.splitlines()
    assert lines[0].startswith("provisioned 3 tenants x 21 docs")
    for i in range(3):
        t = [ln for ln in lines if ln.startswith(f"tenant t{i}:")][0]
        assert f"weight {float(i + 1)}, 21 docs, served 4 / shed 0 / " \
               "failed 0" in t and "B pinned" in t
    assert any(ln.startswith("shared result cache: hit ratio 0.5")
               for ln in lines)


def test_serve_cli_loop_flags(capsys):
    rc, out = _cli(capsys, "--continuous", "--deadline-ms", "60000",
                   "--max-queue", "1000", "--method", "fused")
    assert rc == 0, out
    assert "encoded 8/8 requests" in out and "(0 shed, 0 failed)" in out


def test_run_passes_the_loop_flags():
    """``run`` builds the loop with the admission bound, the deadlines and
    continuous batching it is given."""
    res = serve.run(np_encoder(SparseRep), VOCAB, corpus=16, requests=6,
                    topk=3, method="fused", index_batch=8, device="cpu",
                    continuous=True, deadline_ms=250.0, max_queue=2)
    loop = res["loop"]
    assert loop.continuous and loop.admission.max_queue_depth == 2
    st = loop.stats()
    assert st["submitted"] == 6 and st["served"] + st["shed"] == 6
    assert all(r.deadline_s == 0.25 for r in loop.pending) \
        and not loop.pending


@pytest.mark.parametrize("argv,message", [
    (["--cache-mb", "1"], "--cache-mb/--tenants need --engine"),
    (["--tenants", "2"], "--cache-mb/--tenants need --engine"),
    (["--engine", "--tenants", "-1"], "--tenants must be >= 0"),
])
def test_serve_cli_refuses_as_jax(capsys, argv, message):
    with pytest.raises(SystemExit) as e:
        serve.main(["--device", "cpu", *argv])
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def test_run_tenants_marks_requests_and_serves_every_uid():
    """``run_tenants`` with an injected encoder: a persistent poison in
    t1's marked requests fails only there; every uid completes once; each
    tenant's cached fused search equals its engine's."""
    poison = VOCAB + 7
    encode = tfaults.inject_faults(np_encoder(SparseRep),
                                   [{"on": {"token": poison}}])

    def mark(uid, name, tokens):
        if name == "t1" and uid % 2:
            tokens = tokens.copy()
            tokens[0] = poison
        return tokens

    res = serve.run_tenants(encode, VOCAB, tenants=3, corpus=48,
                            requests=18, topk=4, index_batch=4,
                            device="cpu", cache_mb=0.5, continuous=True,
                            deadline_ms=60_000.0, mark=mark)
    per = res["pool"].stats()["tenants"]
    assert len(res["outcomes"]) == 18
    assert per["t1"]["failed"] == 3
    assert per["t0"]["failed"] == per["t2"]["failed"] == 0
    assert sum(n for _, n in res["dispatches"]) <= 18
    for name, passes in res["searches"].items():
        engine = res["pool"].tenant(name).engine
        want = engine.search(res["queries"][name], 4, method="fused")
        for vals, ids in passes:
            assert np.array_equal(vals, want[0])
            assert np.array_equal(ids, want[1])
