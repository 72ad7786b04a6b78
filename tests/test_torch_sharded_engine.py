"""The sharded engines behind the port's entry points against the JAX
package (CPU): ``retrieve(method="sharded" | "term_sharded" | "shard2d",
mesh=, plan=)``, ``IndexBuilder(term_shards=, plan=)``,
``CorpusEngine(shard_axis="term", plan=)``, ``MethodSpec(doc_shards=)``
and the serve CLI's ``--shards`` / ``--shard-axis``.

The builders are driven in step through the same adds, tombstones,
flushes, compactions and searches on the same numpy rows and must give,
after every call, equal ``stats()`` and the same external ids (a
term-sharded or 2D score adds two per-shard partials, ``a + b`` on both
sides, so no tie moves here), values within 1e-5. The harness's metrics
within 1e-6; the CLI's plan lines equal to the reference planner's on
the same sizes; every refusal the reference's ``ValueError``, message for
message.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import eval as jeval
from repro import retrieval as jr
from repro.data import synthetic as jax_data
from repro.launch import serve as jserve
from repro.retrieval import score as jscore
from repro.retrieval.engine import shard2d as j2d
from repro.runtime import serving as jserving
from repro_torch import eval as teval
from repro_torch.configs.splade_bert import SMOKE
from repro_torch.data import synthetic
from repro_torch.launch import serve
from repro_torch.retrieval import score
from repro_torch.retrieval.engine import (IndexBuilder, ShardPlan,
                                          shard2d_index, shard_index,
                                          term_shard_index)
from repro_torch.retrieval.engine import shard2d as t2d
from repro_torch.retrieval.sparse_rep import sparsify_topk
from repro_torch.runtime.serving import (BatchedEncoder, BatchPolicy,
                                         CorpusEngine)

VAL_TOL = 1e-5
ATOL = 1e-6
V = 128


def _rows(rng, n, nnz, vocab=V):
    m = np.zeros((n, vocab), np.float32)
    for r in range(n):
        cols = rng.choice(vocab, size=nnz, replace=False)
        m[r, cols] = rng.uniform(0.1, 2.0, size=nnz)
    return m


def _reps(m, topk=10):
    return (sparsify_topk(torch.from_numpy(m), topk),
            jr.sparsify_topk(jnp.asarray(m), topk))


def _message(fn, *args, **kw):
    with pytest.raises(ValueError) as err:
        fn(*args, **kw)
    return str(err.value)


class Both:
    """The port's builder and the JAX builder, driven in step."""

    def __init__(self, port_kw, ref_kw=None):
        self.port = IndexBuilder(V, device="cpu", **port_kw)
        self.ref = jr.IndexBuilder(V, **(port_kw if ref_kw is None
                                         else ref_kw))

    def check(self):
        assert self.port.stats() == self.ref.stats()
        assert self.port.dirty == self.ref.dirty

    def add(self, m):
        rep_t, rep_j = _reps(m)
        got = self.port.add(rep_t)
        np.testing.assert_array_equal(got, self.ref.add(rep_j))
        self.check()

    def remove(self, ids):
        assert self.port.remove(ids) == self.ref.remove(ids)
        self.check()

    def flush(self, **kw):
        self.port.flush(**kw)
        self.ref.flush(**kw)
        self.check()

    def search(self, m, k, **kw):
        q_t, q_j = _reps(m)
        v_t, e_t = self.port.search(q_t, k, **kw)
        v_j, e_j = self.ref.search(q_j, k, **kw)
        np.testing.assert_array_equal(e_t, e_j)
        np.testing.assert_allclose(v_t, np.asarray(v_j), rtol=VAL_TOL,
                                   atol=VAL_TOL)
        self.check()
        return e_t


BUILDERS = {
    "term2": ({"term_shards": 2}, None),
    "term3_fwd": ({"term_shards": 3, "keep_forward": True}, None),
    "grid2x2": ({"plan": ShardPlan(2, 2)}, {"plan": j2d.ShardPlan(2, 2)}),
    "grid2x2_fwd": ({"plan": ShardPlan(2, 2), "keep_forward": True},
                    {"plan": j2d.ShardPlan(2, 2), "keep_forward": True}),
    "plan1x3": ({"plan": ShardPlan(1, 3)}, {"plan": j2d.ShardPlan(1, 3)}),
    "plan4x1": ({"plan": ShardPlan(4, 1)}, {"plan": j2d.ShardPlan(4, 1)}),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_sharded_builder_lifecycle_equals_jax(name):
    """Adds, base tombstones zeroed in place, a delta, a compaction and a
    delta after it; every search method the base and delta take."""
    rng = np.random.default_rng(7)
    D = _rows(rng, 120, 12)
    Q = _rows(rng, 5, 6)
    b = Both(*BUILDERS[name])
    fwd = b.port.keep_forward
    methods = [{"method": "auto"}, {"method": "fused"}]
    if fwd:
        methods += [{"method": "pruned"},
                    {"method": "pruned", "prune_margin": 0.5,
                     "candidates": 16}]
    b.add(D[:80])
    b.flush()
    for kw in methods:
        b.search(Q, 6, **kw)
    b.remove([0, 5, 41, 79])               # base tombstones, zeroed
    b.flush()
    gone = {0, 5, 41, 79}
    for kw in methods:
        assert not gone & set(b.search(Q, 6, **kw).ravel().tolist())
    b.add(D[80:95])                        # a delta under merge_frac
    b.flush()
    for kw in methods:
        b.search(Q, 8, **kw)
    b.flush(force_compact=True)
    b.add(D[95:])
    for kw in methods:
        b.search(Q, 9, **kw)
    for method in score.METHODS:
        assert b.port.resolved_method(method) == \
            b.ref.resolved_method(method)


def test_builder_clamps_the_grid_to_the_live_rows_as_jax():
    rng = np.random.default_rng(3)
    b = Both({"plan": ShardPlan(4, 2)}, {"plan": j2d.ShardPlan(4, 2)})
    b.add(_rows(rng, 8, 8))
    b.flush()
    b.remove([0, 1, 2, 3, 4])
    b.flush(force_compact=True)            # 3 live rows, 4 chunks planned
    assert b.port._base.doc_shards == b.ref._base.doc_shards == 3
    b.search(_rows(rng, 2, 5), 2)
    # even chunks of ceil(N / D) leave the last one empty at N 6, D 4: the
    # reference refuses its own cuts there, and so does the port
    d_t, d_j = _reps(_rows(rng, 6, 8))
    assert _message(shard2d_index, d_t, V, 4, 2, device="cpu") == \
        _message(jr.shard2d_index, d_j, V, 4, 2)


def test_builder_and_engine_shard_refusals_equal_jax():
    """Replaces the refusals that named multi-GPU: the reference's
    ``ValueError`` for each bad combination."""
    def both(port_fn, ref_fn):
        assert _message(port_fn) == _message(ref_fn)

    both(lambda: IndexBuilder(V, term_shards=2, plan=ShardPlan(1, 2),
                              device="cpu"),
         lambda: jr.IndexBuilder(V, term_shards=2,
                                 plan=j2d.ShardPlan(1, 2)))
    for port_kw, ref_kw in (({"term_shards": 2}, {"term_shards": 2}),
                            ({"plan": ShardPlan(2, 2)},
                             {"plan": j2d.ShardPlan(2, 2)})):
        both(lambda: IndexBuilder(V, quantize=True, device="cpu",
                                  **port_kw),
             lambda: jr.IndexBuilder(V, quantize=True, **ref_kw))
    enc_t = BatchedEncoder(lambda t, m: None)
    enc_j = jserving.BatchedEncoder(lambda t, m: None)
    both(lambda: CorpusEngine(enc_t, 8, shard_axis="rows", device="cpu"),
         lambda: jserving.CorpusEngine(enc_j, 8, shard_axis="rows"))
    both(lambda: CorpusEngine(enc_t, 8, shard_axis="term",
                              plan=ShardPlan(2, 2), device="cpu"),
         lambda: jserving.CorpusEngine(enc_j, 8, shard_axis="term",
                                       plan=j2d.ShardPlan(2, 2)))


def test_shard_counts_above_the_corpus_refuse_as_jax():
    rng = np.random.default_rng(4)
    d_t, d_j = _reps(_rows(rng, 5, 4, vocab=8), topk=4)
    assert _message(shard_index, d_t, 8, 6, device="cpu") == \
        _message(jr.shard_index, d_j, 8, 6)
    assert _message(term_shard_index, d_t, 8, 9, device="cpu") == \
        _message(jr.term_shard_index, d_j, 8, 9)
    assert _message(shard2d_index, d_t, 8, 6, 1, device="cpu") == \
        _message(jr.shard2d_index, d_j, 8, 6, 1)


# ---------------------------------------------------------------------------
# retrieve(): methods, kwargs, plans
# ---------------------------------------------------------------------------

def _indexes():
    rng = np.random.default_rng(5)
    d_t, d_j = _reps(_rows(rng, 40, 10))
    q_t, q_j = _reps(_rows(rng, 3, 5))
    port = {"sharded": shard_index(d_t, V, 2, device="cpu"),
            "term_sharded": term_shard_index(d_t, V, 2, device="cpu"),
            "shard2d": shard2d_index(d_t, V, 2, 2, device="cpu")}
    ref = {"sharded": jr.shard_index(d_j, V, 2),
           "term_sharded": jr.term_shard_index(d_j, V, 2),
           "shard2d": jr.shard2d_index(d_j, V, 2, 2)}
    return q_t, q_j, port, ref


@pytest.mark.parametrize("method", ["sharded", "term_sharded", "shard2d"])
def test_retrieve_sharded_methods_equal_jax(method):
    q_t, q_j, port, ref = _indexes()
    assert score.resolve_method("auto", port[method]) == \
        jscore._resolve_method("auto", ref[method]) == method
    assert score.METHOD_KWARGS[method] == jscore._METHOD_KWARGS[method]
    for m in ("auto", method):
        v_t, i_t = score.retrieve(q_t, port[method], 5, method=m)
        v_j, i_j = jr.retrieve(q_j, ref[method], 5, method=m)
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j),
                                   rtol=VAL_TOL, atol=VAL_TOL)
    # a sharded method on another corpus, and another method on this one
    other = "shard2d" if method == "sharded" else "sharded"
    assert _message(score.retrieve, q_t, port[other], 5, method=method) == \
        _message(jr.retrieve, q_j, ref[other], 5, method=method)
    assert _message(score.retrieve, q_t, port[method], 5,
                    method="impact") == \
        _message(jr.retrieve, q_j, ref[method], 5, method="impact")


@pytest.mark.parametrize("method,grid", [
    ("sharded", (3, 1)), ("sharded", (2, 2)), ("term_sharded", (1, 3)),
    ("term_sharded", (2, 2)), ("shard2d", (2, 1)), ("shard2d", (1, 2))])
def test_plan_grid_mismatch_refuses_as_jax(method, grid):
    """``_check_plan``: a plan must describe the grid that was built."""
    q_t, q_j, port, ref = _indexes()
    assert _message(score.retrieve, q_t, port[method], 5, method=method,
                    plan=ShardPlan(*grid)) == \
        _message(jr.retrieve, q_j, ref[method], 5, method=method,
                 plan=j2d.ShardPlan(*grid))


def test_plans_that_match_and_margin_zero_route_as_jax():
    q_t, q_j, port, ref = _indexes()
    for method, grid in (("sharded", (2, 1)), ("term_sharded", (1, 2)),
                         ("shard2d", (2, 2))):
        i_t = score.retrieve(q_t, port[method], 5, method=method,
                             plan=ShardPlan(*grid))[1]
        i_j = jr.retrieve(q_j, ref[method], 5, method=method,
                          plan=j2d.ShardPlan(*grid))[1]
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    for method in ("term_sharded", "shard2d"):
        # margin 0: the exact path, no forward rows needed
        i_t = score.retrieve(q_t, port[method], 5, method=method,
                             prune_margin=0.0)[1]
        np.testing.assert_array_equal(
            i_t.numpy(), np.asarray(jr.retrieve(
                q_j, ref[method], 5, method=method, prune_margin=0.0)[1]))
        assert _message(score.retrieve, q_t, port[method], 5, method=method,
                        prune_margin=0.5) == \
            _message(jr.retrieve, q_j, ref[method], 5, method=method,
                     prune_margin=0.5)
    assert _message(score.retrieve, q_t, port["sharded"], 5,
                    method="sharded", prune_margin=0.5) == \
        _message(jr.retrieve, q_j, ref["sharded"], 5, method="sharded",
                 prune_margin=0.5)


# ---------------------------------------------------------------------------
# CorpusEngine and the harness
# ---------------------------------------------------------------------------

def _counting_encoders(vocab=32, width=4):
    def counts(tokens, mask):
        tokens, mask = np.asarray(tokens), np.asarray(mask)
        out = np.zeros((tokens.shape[0], vocab), np.float32)
        for r in range(tokens.shape[0]):
            for t, on in zip(tokens[r], mask[r]):
                if on:
                    out[r, int(t) % vocab] += 1 + 0.01 * int(t)
        return out

    return (lambda t, m: sparsify_topk(torch.from_numpy(counts(t, m)),
                                       width),
            lambda t, m: jr.sparsify_topk(jnp.asarray(counts(t, m)), width))


@pytest.mark.parametrize("kw", ["term", "plan"])
def test_corpus_engine_sharded_base_searches_as_jax(kw):
    enc_t, enc_j = _counting_encoders()
    port_kw, ref_kw = ({"shard_axis": "term", "n_shards": 2},) * 2
    if kw == "plan":
        port_kw, ref_kw = ({"plan": ShardPlan(2, 2)},
                           {"plan": j2d.ShardPlan(2, 2)})
    eng = CorpusEngine(BatchedEncoder(enc_t, policy=BatchPolicy(max_batch=8)),
                       32, device="cpu", **port_kw)
    ref = jserving.CorpusEngine(jserving.BatchedEncoder(
        enc_j, policy=jserving.BatchPolicy(max_batch=8)), 32, **ref_kw)
    rng = np.random.default_rng(2)
    docs = [rng.integers(1, 64, size=5).astype(np.int32) for _ in range(30)]
    for e in (eng, ref):
        np.testing.assert_array_equal(e.add_docs(docs[:24]), np.arange(24))
        e.flush()
        e.remove_docs([2, 7])
        e.add_docs(docs[24:])
    q_t, q_j = enc_t(np.array([[3, 9, 17]]), np.ones((1, 3))), \
        enc_j(np.array([[3, 9, 17]]), np.ones((1, 3)))
    for method in ("auto", "fused"):
        v_t, e_t = eng.search(q_t, 6, method=method)
        v_j, e_j = ref.search(q_j, 6, method=method)
        np.testing.assert_array_equal(e_t, e_j)
        np.testing.assert_allclose(v_t, np.asarray(v_j), atol=VAL_TOL)
    assert eng.stats() == ref.stats()
    assert eng.builder_kwargs.keys() == ref.builder_kwargs.keys()


@pytest.fixture(scope="module")
def harness_runs():
    kw = dict(n_docs=96, vocab=1024, doc_nnz=32, n_queries=8, q_nnz=26,
              graded=12, seed=3)
    specs = {"doc_sharded": {"doc_shards": 3},
             "doc_sharded_4": {"doc_shards": 4},
             "term_sharded": {"engine": {"term_shards": 2}}}
    run = {}
    for mod, data, extra in ((teval, synthetic, {"device": "cpu"}),
                             (jeval, jax_data, {})):
        corpus = data.lsr_impact_corpus(**kw)
        run[mod.__name__] = mod.evaluate_retrieval(
            None, corpus, mod.Qrels.from_triples(corpus["qrels"]),
            methods=[mod.MethodSpec("exact"),
                     *(mod.MethodSpec(n, **s) for n, s in specs.items())],
            ks=(1, 10), **extra)
    return run["repro_torch.eval"], run["repro.eval"]


@pytest.mark.parametrize("name", ["doc_sharded", "doc_sharded_4",
                                  "term_sharded"])
def test_sharded_specs_metrics_equal_jax(harness_runs, name):
    got, want = (r[name] for r in harness_runs)
    assert list(got) == list(want)
    np.testing.assert_allclose(list(got.values()), list(want.values()),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(list(got.values()),
                               list(harness_runs[0]["exact"].values()),
                               rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

CLI = ["--device", "cpu", "--corpus", "40", "--requests", "4"]


def _postings(out):
    return int(re.search(r"indexed \d+ docs in [0-9.]+ ms: (\d+) postings",
                         out).group(1))


@pytest.mark.parametrize("args,tag", [
    (["--method", "sharded"], "sharded"),
    (["--method", "term_sharded"], "term_sharded"),
    (["--method", "shard2d", "--shards", "4"], "shard2d"),
    (["--method", "sharded", "--shard-axis", "auto"], None),
    (["--method", "sharded", "--shard-axis", "2d", "--shards", "6"],
     "shard2d"),
])
def test_serve_cli_sharded_methods_on_cpu(args, tag, capsys):
    assert serve.main(CLI + args) == 0
    out = capsys.readouterr().out
    if tag is None:            # auto: the reference planner on these sizes
        plan = jr.plan_placement(jr.CorpusStats(
            posting_bytes=8 * _postings(out), vocab_size=SMOKE.vocab_size,
            n_docs=40), 2)
        assert f"auto shard plan -> {plan.describe()}: {plan.reason}" in out
        tag = {"doc": "sharded", "term": "term_sharded"}.get(plan.axis,
                                                            "shard2d")
    assert "encoded 4/4 requests" in out
    assert f"retrieval[{tag}]: top-10 for 4 queries" in out


@pytest.mark.parametrize("args,line", [
    (["--shard-axis", "auto"], "auto"),
    (["--shard-axis", "term"], "term shards: 2"),
    (["--shard-axis", "2d", "--shards", "4"], "2d shard plan -> 2x2 (doc x "
                                              "term)"),
])
def test_serve_cli_engine_shard_axes_on_cpu(args, line, capsys):
    assert serve.main(CLI + ["--engine", "--corpus", "96"] + args) == 0
    out = capsys.readouterr().out
    if line == "auto":
        plan = jr.plan_placement(jr.CorpusStats(
            posting_bytes=8 * 96 * 16, vocab_size=SMOKE.vocab_size,
            n_docs=96), 2)
        line = (f"auto shard plan (estimated stats) -> {plan.describe()}: "
                f"{plan.reason}")
    assert line in out
    assert "engine-indexed 96 live docs" in out


def test_grid_plan_equals_jax():
    for n in range(1, 13):
        got, want = serve._grid_plan(n), jserve._grid_plan(n)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_serve_cli_refuses_quantize_with_a_shard_axis(capsys):
    with pytest.raises(SystemExit):
        serve.main(CLI + ["--engine", "--quantize", "--shard-axis", "term"])
    assert "--shard-axis term and --quantize are exclusive" in \
        capsys.readouterr().err


def test_port_planner_is_the_reference_planner():
    assert t2d.DIR_BYTES_PER_TERM == j2d.DIR_BYTES_PER_TERM
    assert t2d.POSTING_BYTES == j2d.POSTING_BYTES
    assert [g for g in t2d._grid_candidates(6)] == j2d._grid_candidates(6)
