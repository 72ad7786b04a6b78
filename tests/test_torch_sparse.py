"""The port's sparse substrate against the JAX package, on the CPU: the
segment ops (dropped ids, empty segments, argmax ties, the hypothesis
property of ``tests/test_sparse.py``), ``gather_scatter`` with each
reduce, the embedding lookups and bags (the ``jnp.take`` rule, the three
combiners with weights), the triplets and the fanout sampler (numpy, bit
for bit, the caps' ``rng.choice`` included), and the synthetic LM and
graph data (bit for bit).

Tolerances: f32 sums in another order, atol 1e-6 (inputs of order 1);
maxima, argmaxima, counts, gathers and every numpy array exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.data import synthetic as jax_data
from repro.sparse import embedding_bag as jax_bag
from repro.sparse import sampler as jax_sampler
from repro.sparse import segment as jax_segment
from repro.sparse import triplets as jax_triplets
from repro_torch.data import synthetic
from repro_torch.sparse import embedding_bag, sampler, segment, triplets

ATOL = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(np.array(x))


def _rand(seed, shape, segments, n, lo=None):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=shape).astype(np.float32)
    ids = rng.integers(-2 if lo is None else lo, segments + 2,
                       size=n).astype(np.int32)
    return data, ids


# ---------------------------------------------------------------------------
# segment ops
# ---------------------------------------------------------------------------

def test_segment_sum_drops_ids_outside_the_segments():
    out = segment.segment_sum(_t([1.0, 2, 3, 4, 5]), _t([0, 3, -1, 5, 1]), 4)
    assert out.tolist() == [1.0, 5.0, 0.0, 2.0]
    ref = jax_segment.segment_sum(_j([1.0, 2, 3, 4, 5]), _j([0, 3, -1, 5, 1]),
                                  4)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("op", ["segment_sum", "segment_mean",
                                "segment_max"])
@pytest.mark.parametrize("shape", [(40,), (40, 5)])
def test_segment_ops_match_jax(op, shape):
    """Random data, ids in [-2, 8) over 6 segments: some dropped, some
    segments empty (a max of -inf, a mean of 0)."""
    data, ids = _rand(1, shape, 6, shape[0])
    ids[ids == 4] = 7                       # segment 4 is empty
    got = getattr(segment, op)(_t(data), _t(ids), 6).numpy()
    want = np.asarray(getattr(jax_segment, op)(_j(data), _j(ids), 6))
    assert got.dtype == want.dtype and got.shape == want.shape
    if op == "segment_max":
        np.testing.assert_array_equal(got, want)
        assert np.isneginf(got[4]).all()
    else:
        np.testing.assert_allclose(got, want, atol=ATOL)
        assert (got[4] == 0).all()


def test_segment_max_on_integers_matches_jax():
    data = np.array([3, -7, 2, 9, 9, -1], np.int32)
    ids = np.array([0, 0, 2, 2, -1, 5], np.int32)
    got = segment.segment_max(_t(data), _t(ids), 4)
    want = jax_segment.segment_max(_j(data), _j(ids), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


@pytest.mark.parametrize("shape", [(30,), (30, 3)])
def test_segment_softmax_matches_jax(shape):
    """Dropped ids included: the reference gathers their max and sum by
    ``jnp.take`` (-1 wraps to the last segment, past the end reads NaN)."""
    scores, ids = _rand(2, shape, 5, shape[0])
    got = segment.segment_softmax(_t(scores), _t(ids), 5).numpy()
    want = np.asarray(jax_segment.segment_softmax(_j(scores), _j(ids), 5))
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    kept = (ids >= 0) & (ids < 5)
    sums = np.zeros((5,) + shape[1:])
    np.add.at(sums, ids[kept], got[kept])
    present = np.bincount(ids[kept], minlength=5) > 0
    np.testing.assert_allclose(sums[present], 1.0, atol=1e-5)


@pytest.mark.parametrize("shape", [(12,), (12, 3)])
def test_segment_max_with_argmax_matches_jax(shape):
    """Ties go to the first index; an empty segment's argmax is the int32
    maximum; dropped ids take no part."""
    data, ids = _rand(3, shape, 4, shape[0], lo=-1)
    data[5] = data[2] = 9.0              # a tie in one segment
    ids[5] = ids[2] = 1
    ids[ids == 3] = 6                    # segment 3 empty
    m, arg = segment.segment_max_with_argmax(_t(data), _t(ids), 4)
    jm, jarg = jax_segment.segment_max_with_argmax(_j(data), _j(ids), 4)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(arg.numpy(), np.asarray(jarg))
    assert arg.dtype == torch.int32
    assert (arg.numpy()[1] == 2).all()
    assert (arg.numpy()[3] == 2147483647).all()


def test_segment_max_with_argmax_routes_to_first_max():
    m, arg = segment.segment_max_with_argmax(
        _t([1.0, 5.0, 5.0, 2.0, 7.0]), _t([0, 0, 0, 1, 1]), 2)
    assert m.tolist() == [5.0, 7.0] and arg.tolist() == [1, 4]


@pytest.mark.parametrize("op", ["segment_sum", "segment_mean",
                                "segment_max"])
def test_segment_grads_match_jax(op):
    """Gradients through each op against ``jax.grad``, a max tie
    included (both split the gradient evenly across tied rows)."""
    data, ids = _rand(4, (24, 3), 5, 24)
    data[7] = data[3]
    ids[7] = ids[3] = 2
    w = np.random.default_rng(5).normal(size=(5, 3)).astype(np.float32)
    x = _t(data).requires_grad_(True)
    out = getattr(segment, op)(x, _t(ids), 5)
    (torch.where(torch.isfinite(out), out, 0) * _t(w)).sum().backward()

    def ref(d):
        o = getattr(jax_segment, op)(d, _j(ids), 5)
        return jnp.sum(jnp.where(jnp.isfinite(o), o, 0) * _j(w))

    np.testing.assert_allclose(x.grad.numpy(),
                               np.asarray(jax.grad(ref)(_j(data))),
                               atol=ATOL)


@pytest.mark.parametrize("chunk", [4, 1024])
@pytest.mark.parametrize("wrap", [False, True])
def test_sorted_segment_sum_is_index_add_s_sum(monkeypatch, chunk, wrap):
    """The card's sorted sum (run here on the CPU): a hub of 300 rows on
    one id (runs cut every ``chunk`` rows), ids of two dims, dropped ids
    (negatives wrapped with ``wrap``), empty segments, an empty input; its
    gradient is the gather, 0 at dropped rows; the plan is memoised on the
    id tensor and rebuilt after an in-place change."""
    monkeypatch.setattr(segment, "CHUNK", chunk)
    rng = np.random.default_rng(11)
    ids = rng.integers(-3, 12, size=(100, 4)).astype(np.int32)
    ids[:75] = 2                                   # the hub
    data = rng.normal(size=(400, 3)).astype(np.float64)
    flat = ids.reshape(-1).astype(np.int64)
    if wrap:
        flat = np.where(flat < 0, flat + 10, flat)
    want = np.zeros((10, 3))
    keep = (flat >= 0) & (flat < 10)
    np.add.at(want, flat[keep], data[keep])
    tids = _t(ids)
    plan = segment.segment_plan(tids, 10, wrap=wrap)
    assert segment.segment_plan(tids, 10, wrap=wrap) is plan
    x = _t(data).requires_grad_(True)
    out = segment._SortedSegmentSum.apply(x, plan, 10)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-12)
    np.testing.assert_allclose(
        segment.segment_sum(_t(data), tids, 10, wrap=wrap).numpy(), want,
        atol=1e-12)
    g = rng.normal(size=(10, 3))
    out.backward(_t(g))
    np.testing.assert_array_equal(
        x.grad.numpy(), np.where(keep[:, None], g[np.clip(flat, 0, 9)], 0))
    tids.add_(1)                                   # a new version
    assert segment.segment_plan(tids, 10, wrap=wrap) is not plan
    empty = segment.segment_plan(torch.zeros(0, dtype=torch.int64), 5)
    assert segment.sorted_segment_sum(torch.zeros(0, 2), empty, 5).tolist() \
        == [[0.0, 0.0]] * 5


@settings(max_examples=20, deadline=None)
@given(n=st.integers(1, 40), s=st.integers(1, 8),
       seed=st.integers(0, 2**16))
def test_property_segment_sum_total_preserved(n, s, seed):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n, 3)).astype(np.float32)
    ids = rng.integers(0, s, size=n)
    out = segment.segment_sum(_t(data), _t(ids), s)
    np.testing.assert_allclose(float(out.sum()), float(data.sum()),
                               atol=1e-3)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jax_segment.segment_sum(_j(data), _j(ids), s)),
        atol=ATOL)


@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
def test_gather_scatter_matches_jax(reduce):
    rng = np.random.default_rng(6)
    feats = rng.normal(size=(10, 4)).astype(np.float32)
    src = rng.integers(0, 10, size=30).astype(np.int32)
    dst = rng.integers(0, 12, size=30).astype(np.int32)   # 10, 11 dropped
    got = segment.gather_scatter(_t(feats), _t(src), _t(dst), 10,
                                 reduce=reduce).numpy()
    want = np.asarray(jax_segment.gather_scatter(
        _j(feats), _j(src), _j(dst), 10, reduce=reduce))
    np.testing.assert_allclose(got, want, atol=ATOL)
    with pytest.raises(ValueError, match="unknown reduce"):
        segment.gather_scatter(_t(feats), _t(src), _t(dst), 10,
                               reduce="min")


# ---------------------------------------------------------------------------
# embedding lookups and bags
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reproducible", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("idx_shape", [(7,), (2, 4)])
def test_embedding_lookup_is_jnp_take(dtype, idx_shape, reproducible):
    """Ids -3..7 on 5 rows: negatives wrap, past the end fills (NaN, or
    the int32 minimum), 1-D and 3-D tables too."""
    rng = np.random.default_rng(7)
    idx = rng.integers(-7, 8, size=idx_shape).astype(np.int32)
    for shape in [(5,), (5, 3), (5, 2, 2)]:
        table = (rng.normal(size=shape) * 10).astype(dtype)
        got = embedding_bag.embedding_lookup(
            _t(table), _t(idx), reproducible=reproducible).numpy()
        want = np.asarray(jnp.take(_j(table), _j(idx), axis=0))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_matches_jax(combiner, weighted):
    rng = np.random.default_rng(8)
    table = rng.normal(size=(10, 4)).astype(np.float32)
    values = rng.integers(0, 10, size=20).astype(np.int32)
    values[3] = -1                         # wraps to row 9, as jnp.take
    bags = rng.integers(0, 5, size=20).astype(np.int32)
    bags[bags == 2] = 6                    # bag 2 empty, 6 dropped
    w = rng.uniform(0.5, 2.0, size=20).astype(np.float32) if weighted \
        else None
    got = embedding_bag.embedding_bag(
        _t(table), _t(values), _t(bags), 5, combiner=combiner,
        weights=None if w is None else _t(w)).numpy()
    want = np.asarray(jax_bag.embedding_bag(
        _j(table), _j(values), _j(bags), 5, combiner=combiner,
        weights=None if w is None else _j(w)))
    np.testing.assert_allclose(got, want, atol=ATOL)
    with pytest.raises(ValueError, match="unknown combiner"):
        embedding_bag.embedding_bag(_t(table), _t(values), _t(bags), 5,
                                    combiner="min")


def test_embedding_bag_weighted_identity():
    out = embedding_bag.embedding_bag(torch.eye(4), _t([0, 1]), _t([0, 0]),
                                      1, weights=_t([2.0, 3.0]))
    assert out[0].tolist() == [2.0, 3.0, 0.0, 0.0]


def test_multi_table_lookup_matches_jax():
    tables = [np.arange(8.0, dtype=np.float32).reshape(4, 2) * (f + 1)
              for f in range(3)]
    idx = np.array([[0, 1, 2], [3, 0, -1]], np.int32)
    got = embedding_bag.multi_table_lookup([_t(t) for t in tables], _t(idx))
    want = jax_bag.multi_table_lookup([_j(t) for t in tables], _j(idx))
    assert tuple(got.shape) == (2, 3, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("reproducible", [False, True])
def test_embedding_lookup_gradient_is_jax_s(reproducible):
    """No gradient reaches the table from an id past its end; the
    fixed-order backward (``reproducible``) gives the same values."""
    table = np.random.default_rng(9).normal(size=(6, 3)).astype(np.float32)
    idx = np.array([[0, 5, -1], [8, 2, 2]], np.int32)
    t = _t(table).requires_grad_(True)
    out = embedding_bag.embedding_lookup(t, _t(idx),
                                         reproducible=reproducible)
    torch.where(torch.isnan(out), 0, out).sum().backward()

    def ref(x):
        o = jnp.take(x, _j(idx), axis=0)
        return jnp.sum(jnp.where(jnp.isnan(o), 0, o))

    np.testing.assert_array_equal(t.grad.numpy(),
                                  np.asarray(jax.grad(ref)(_j(table))))


# ---------------------------------------------------------------------------
# triplets and the sampler: numpy, bit for bit
# ---------------------------------------------------------------------------

def _graph(n, e, seed):
    return tuple(a.astype(np.int32) for a in
                 jax_data.make_synthetic_graph(n, e, seed=seed))


@pytest.mark.parametrize("cap", [0, 3, 8])
def test_build_and_densify_triplets_bit_for_bit(cap):
    src, dst = _graph(60, 700, 1)
    got = triplets.build_triplets(src, dst, 60, max_per_edge=cap, seed=4)
    want = jax_triplets.build_triplets(src, dst, 60, max_per_edge=cap,
                                       seed=4)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    k = cap or 5
    for a, b in zip(triplets.densify_triplets(*got, len(src), k),
                    jax_triplets.densify_triplets(*want, len(src), k)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert triplets.count_triplets(src, dst, 60, cap) == \
        jax_triplets.count_triplets(src, dst, 60, cap)
    assert triplets.triplet_budget(60, len(src), cap) == \
        jax_triplets.triplet_budget(60, len(src), cap)
    if cap:
        assert np.bincount(got[1], minlength=len(src)).max() <= cap


def test_triplets_exclude_k_equal_i():
    src, dst = np.array([0, 1, 2, 1]), np.array([1, 2, 0, 0])
    t_in, t_out = triplets.build_triplets(src, dst, 3)
    pairs = set(zip(t_in.tolist(), t_out.tolist()))
    assert {(0, 1), (2, 0), (1, 2)} <= pairs
    assert 3 not in t_out.tolist()


def test_sampler_bit_for_bit():
    src, dst = jax_data.make_synthetic_graph(300, 4000, seed=4)
    g = sampler.CSRGraph.from_edges(src, dst, 300)
    jg = jax_sampler.CSRGraph.from_edges(src, dst, 300)
    np.testing.assert_array_equal(g.indptr, jg.indptr)
    np.testing.assert_array_equal(g.indices, jg.indices)
    assert g.n_nodes == 300
    np.testing.assert_array_equal(g.neighbors(7), jg.neighbors(7))
    seeds = np.array([1, 2, 3, 4, 250])
    assert sampler.fanout_budget(5, (4, 3)) == \
        jax_sampler.fanout_budget(5, (4, 3))
    total, per_hop = sampler.fanout_budget(5, (4, 3))
    for pad in [dict(pad_nodes=total, pad_edges_per_hop=per_hop),
                dict(pad_edges_per_hop=(7,))]:
        sub = sampler.sample_subgraph(g, seeds, (4, 3),
                                      rng=np.random.default_rng(0), **pad)
        ref = jax_sampler.sample_subgraph(jg, seeds, (4, 3),
                                          rng=np.random.default_rng(0),
                                          **pad)
        assert sub.n_nodes == ref.n_nodes
        for name in ("nodes", "node_mask", "seeds"):
            np.testing.assert_array_equal(getattr(sub, name),
                                          getattr(ref, name))
        assert len(sub.blocks) == len(ref.blocks) == 2
        for a, b in zip(sub.blocks, ref.blocks):
            assert a.n_edges == b.n_edges
            for name in ("src", "dst", "mask"):
                assert getattr(a, name).dtype == getattr(b, name).dtype
                np.testing.assert_array_equal(getattr(a, name),
                                              getattr(b, name))
    np.testing.assert_array_equal(sub.nodes[:5], seeds)


# ---------------------------------------------------------------------------
# synthetic data: bit for bit
# ---------------------------------------------------------------------------

def _same_stream(mine, ref, n=2):
    for _ in range(n):
        a, b = next(mine), next(ref)
        assert list(a) == list(b)
        for key in a:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key])


def test_lm_token_batches_bit_for_bit():
    kw = dict(batch=3, seq_len=9, vocab=50, seed=2, shard=1)
    _same_stream(synthetic.lm_token_batches(**kw),
                 jax_data.lm_token_batches(**kw))


@pytest.mark.parametrize("power_law", [True, False])
def test_make_synthetic_graph_bit_for_bit(power_law):
    got = synthetic.make_synthetic_graph(500, 3000, seed=3,
                                         power_law=power_law)
    want = jax_data.make_synthetic_graph(500, 3000, seed=3,
                                         power_law=power_law)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert not (got[0] == got[1]).any()


def test_molecule_batches_bit_for_bit():
    kw = dict(n_graphs=5, nodes_per_graph=9, edges_per_graph=14, seed=6,
              shard=2)
    _same_stream(synthetic.molecule_batches(**kw),
                 jax_data.molecule_batches(**kw), n=3)
