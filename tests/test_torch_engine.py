"""The port's index engine against the JAX package (CPU): ``IndexBuilder``,
``CorpusEngine`` and the serve CLI's engine mode.

Each builder test drives the port's builder and the JAX builder through the
same sequence of add/remove/flush/compact/search calls on the same numpy
rows (mirroring tests/test_engine.py's builder tests) and requires, after
every call, equal stats, and from every search identical external ids and
values within 1e-4 (the JAX tests' tolerance: segments scored by the
Pallas kernels sum a doc's lanes through a one-hot contraction).
``CorpusEngine`` is held against the JAX one through a counting encoder
(exact reps) and through the splade_bert SMOKE encoder with the carried
JAX weights at f32 compute, where the reps agree to 2e-4
(tests/test_torch_serving.py) and the ids must still be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import retrieval as jr
from repro.configs.splade_bert import SMOKE as JAX_SMOKE
from repro.data.synthetic import lsr_impact_corpus
from repro.models import transformer as jtfm
from repro.runtime import serving as jserving
from repro_torch.configs.splade_bert import SMOKE
from repro_torch.launch import serve
from repro_torch.retrieval import score
from repro_torch.retrieval.engine import (IndexBuilder, QuantizedIndex,
                                          ShardPlan)
from repro_torch.retrieval.index import build_inverted_index
from repro_torch.retrieval.sparse_rep import sparsify_threshold, sparsify_topk
from repro_torch.runtime.serving import (BatchedEncoder, BatchPolicy,
                                         CorpusEngine, make_config_encoder)
from repro_torch.weights import params_from_jax

VAL_TOL = 1e-4


def _small(rng, n, nnz, vocab):
    m = np.zeros((n, vocab), np.float32)
    for r in range(n):
        cols = rng.choice(vocab, size=nnz, replace=False)
        m[r, cols] = rng.uniform(0.1, 2.0, size=nnz)
    return m


def _reps(m, *, topk=None):
    """The same dense rows sparsified by each package."""
    if topk is None:
        return (sparsify_threshold(torch.from_numpy(m), 0.0, max_nnz=12),
                jr.sparsify_threshold(jnp.asarray(m), 0.0, max_nnz=12))
    return (sparsify_topk(torch.from_numpy(m), topk),
            jr.sparsify_topk(jnp.asarray(m), topk))


class Both:
    """The port's builder and the JAX builder, driven in step."""

    def __init__(self, vocab, **kw):
        self.port = IndexBuilder(vocab, device="cpu", **kw)
        self.ref = jr.IndexBuilder(vocab, **kw)

    def check(self):
        assert self.port.stats() == self.ref.stats()
        assert self.port.dirty == self.ref.dirty

    def add(self, m, ids=None, topk=None):
        rep_t, rep_j = _reps(m, topk=topk)
        got = self.port.add(rep_t, ids=ids)
        np.testing.assert_array_equal(got, self.ref.add(rep_j, ids=ids))
        self.check()
        return got

    def remove(self, ids):
        n = self.port.remove(ids)
        assert n == self.ref.remove(ids)
        self.check()
        return n

    def flush(self, **kw):
        self.port.flush(**kw)
        self.ref.flush(**kw)
        self.check()

    def search(self, m, k, topk=None, **kw):
        q_t, q_j = _reps(m, topk=topk)
        v_t, e_t = self.port.search(q_t, k, **kw)
        v_j, e_j = self.ref.search(q_j, k, **kw)
        assert e_t.dtype == np.int64 and v_t.dtype == np.float32
        np.testing.assert_array_equal(e_t, e_j)
        np.testing.assert_allclose(v_t, np.asarray(v_j), rtol=VAL_TOL,
                                   atol=VAL_TOL)
        self.check()
        return v_t, e_t


def test_builder_add_flush_matches_frozen_build():
    rng = np.random.default_rng(0)
    D = _small(rng, 60, 8, 128)
    Q = _small(rng, 4, 6, 128)
    b = Both(128)
    ids = b.add(D[:40])
    b.flush()
    assert b.port.stats()["base_docs"] == 40
    ids2 = b.add(D[40:])
    np.testing.assert_array_equal(np.concatenate([ids, ids2]),
                                  np.arange(60))
    vals, ext = b.search(Q, 7)              # auto-flush -> base + delta
    frozen = build_inverted_index(_reps(D)[0], 128, device="cpu")
    v_ref, i_ref = score.retrieve(_reps(Q)[0], frozen, 7, method="impact")
    np.testing.assert_array_equal(ext, i_ref.numpy())
    np.testing.assert_allclose(vals, v_ref.numpy(), atol=VAL_TOL)


def test_builder_delta_segment_is_incremental():
    rng = np.random.default_rng(1)
    D = _small(rng, 80, 8, 128)
    b = Both(128, merge_frac=0.5)
    b.add(D[:64])
    b.flush()
    base_before = b.port._base
    b.add(D[64:])
    b.flush()
    assert b.port._base is base_before, "base was rebuilt for a delta add"
    assert b.port._delta is not None and b.port._delta.n_docs == 16
    st = b.port.stats()
    assert st["base_docs"] == 64 and st["delta_docs"] == 16


def test_builder_remove_tombstones_then_compacts():
    rng = np.random.default_rng(2)
    D = _small(rng, 50, 8, 128)
    Q = _small(rng, 3, 6, 128)
    b = Both(128, compact_dead_frac=0.5)
    b.add(D)
    b.flush()
    _, ext0 = b.search(Q, 5)
    victim = int(ext0[0, 0])
    assert b.remove([victim, victim, 9999]) == 1   # idempotent + unknown
    _, ext1 = b.search(Q, 5)
    assert victim not in ext1, "tombstoned doc still retrieved"
    assert b.port.stats()["n_dead"] == 1
    b.flush(force_compact=True)
    assert b.port.stats()["n_dead"] == 0 and b.port.stats()["n_slots"] == 49
    _, ext2 = b.search(Q, 5)
    np.testing.assert_array_equal(ext1, ext2)      # external ids stable


def test_builder_auto_compaction_thresholds():
    rng = np.random.default_rng(4)
    D = _small(rng, 40, 6, 64)
    b = Both(64, compact_dead_frac=0.25)
    b.add(D)
    b.flush()
    b.remove(range(15))                  # 15/40 > 25% dead
    b.flush()
    st = b.port.stats()
    assert st["n_dead"] == 0 and st["n_slots"] == 25


@pytest.mark.parametrize("method", ["auto", "quantized", "fused"])
def test_builder_quantized_base_serves_search(method):
    data = lsr_impact_corpus(n_docs=96, vocab=256, doc_nnz=16, n_queries=3,
                             q_nnz=14, graded=6)
    b = Both(256, quantize=True)
    b.add(data["docs"], topk=16)
    _, ext = b.search(data["queries"], 4, topk=14, method=method)
    assert b.port.stats()["quantized_base"]
    assert isinstance(b.port._base, QuantizedIndex)
    q_j = jr.sparsify_topk(jnp.asarray(data["queries"]), 14)
    frozen = jr.build_inverted_index(
        jr.sparsify_topk(jnp.asarray(data["docs"]), 16), 256)
    _, i_ref = jr.retrieve(q_j, frozen, 4, method="impact")
    np.testing.assert_array_equal(ext, np.asarray(i_ref))


def test_builder_external_ids_and_empty():
    b = Both(64)
    b.search(np.zeros((2, 64), np.float32), 3)
    rng = np.random.default_rng(5)
    ids = b.add(_small(rng, 4, 6, 64), ids=[10, 20, 30, 40])
    np.testing.assert_array_equal(ids, [10, 20, 30, 40])
    with pytest.raises(ValueError, match="duplicate"):
        b.port.add(_reps(_small(rng, 1, 6, 64))[0], ids=[20])
    assert b.add(_small(rng, 1, 6, 64))[0] == 41


def test_builder_removed_id_is_reusable_before_compaction():
    rng = np.random.default_rng(6)
    b = Both(64, compact_dead_frac=0.9)   # never auto-compact
    b.add(_small(rng, 8, 6, 64))
    b.flush()
    assert b.remove([3]) == 1
    assert b.port.stats()["n_dead"] == 1
    m = _small(rng, 1, 6, 64)
    np.testing.assert_array_equal(b.add(m, ids=[3]), [3])
    _, ext = b.search(m, 1)
    assert ext[0, 0] == 3                 # the new doc 3
    assert b.remove([3]) == 1


@pytest.mark.parametrize("method", ["auto", "quantized", "fused"])
def test_quantized_lifecycle_matches_jax(method):
    """Online growth one batch at a time (delta segments and merge_frac
    compactions), tombstones in the base (zeroed, then quantized again)
    and in the delta, a forced compaction, narrowed queries."""
    data = lsr_impact_corpus(n_docs=120, vocab=192, doc_nnz=12,
                             n_queries=4, q_nnz=10, graded=4, seed=3)
    docs, queries = data["docs"], data["queries"]
    b = Both(192, quantize=True)
    for lo in range(0, 96, 16):
        b.add(docs[lo:lo + 16], topk=12)
        b.flush()
        b.search(queries, 6, topk=10, method=method)
    assert b.port.stats()["n_compactions"] >= 2
    b.add(docs[96:], topk=12)
    b.remove([1, 5, 50, 97, 119, 7777])
    b.flush()
    _, ext = b.search(queries, 8, topk=10, method=method)
    assert not {1, 5, 50, 97, 119} & set(ext.ravel().tolist())
    b.search(queries, 8, topk=10, method=method, q_width=3)
    b.flush(force_compact=True)
    b.search(queries, 200, topk=10, method=method)   # k past the corpus


def test_search_kwargs_raise_naming_the_resolved_method():
    rng = np.random.default_rng(8)
    b = Both(64, quantize=True)
    b.add(_small(rng, 10, 6, 64))
    q_t, q_j = _reps(_small(rng, 2, 4, 64))
    with pytest.raises(TypeError, match="resolved to 'quantized'"):
        b.ref.search(q_j, 3, block_n=64)
    with pytest.raises(TypeError, match=r"search\(method='auto'\) resolved "
                                        r"to 'quantized': unknown kwargs "
                                        r"block_n \(accepted: no tuning"):
        b.port.search(q_t, 3, block_n=64)
    with pytest.raises(TypeError, match="resolved to 'fused'"):
        b.port.search(q_t, 3, method="fused", interpret=True)
    assert b.port.resolved_method() == b.ref.resolved_method() == "quantized"
    assert b.port.resolved_method("fused") == "fused"


def test_sharded_builder_options_refuse_as_jax():
    """The sharded builder options, refused before the sharded engines were
    ported: the reference's ``ValueError`` for each bad combination."""
    def message(fn, *args, **kw):
        with pytest.raises(ValueError) as err:
            fn(*args, **kw)
        return str(err.value)

    plan, j_plan = ShardPlan(1, 2), jr.ShardPlan(1, 2)
    assert message(IndexBuilder, 64, term_shards=2, plan=plan,
                   device="cpu") == message(jr.IndexBuilder, 64,
                                            term_shards=2, plan=j_plan)
    assert message(IndexBuilder, 64, term_shards=2, quantize=True,
                   device="cpu") == message(jr.IndexBuilder, 64,
                                            term_shards=2, quantize=True)
    rep, rep_j = _reps(np.eye(4, 8, dtype=np.float32))
    for kw in ({"vocab_range": (0, 9)}, {"vocab_range": (0, 4),
                                         "keep_forward": True}):
        assert message(build_inverted_index, rep, 8, device="cpu", **kw) \
            == message(jr.build_inverted_index, rep_j, 8, **kw)
    enc = BatchedEncoder(lambda t, m: None)
    enc_j = jserving.BatchedEncoder(lambda t, m: None)
    assert message(CorpusEngine, enc, 8, shard_axis="rows", device="cpu") \
        == message(jserving.CorpusEngine, enc_j, 8, shard_axis="rows")
    assert message(CorpusEngine, enc, 8, n_shards=2, plan=plan,
                   device="cpu") == message(jserving.CorpusEngine, enc_j, 8,
                                            n_shards=2, plan=j_plan)


def test_forward_rows_build_and_search_pruned():
    """keep_forward and method="pruned", refused before pruning was
    ported, now build and search as the JAX package does."""
    assert IndexBuilder(64, keep_forward=True, device="cpu").keep_forward
    m = np.eye(4, 8, dtype=np.float32) * np.arange(1, 5, dtype=np.float32
                                                   )[:, None]
    rep, rep_j = _reps(m)
    index = build_inverted_index(rep, 8, keep_forward=True, device="cpu")
    assert index.has_forward and index.has_upper_bounds
    np.testing.assert_array_equal(index.doc_values.numpy(),
                                  np.asarray(rep_j.values))
    b = Both(8, keep_forward=True)
    b.add(m)
    b.flush()
    assert b.port.resolved_method() == b.ref.resolved_method() == "pruned"
    b.search(m, 2, method="pruned")
    b.search(m, 2, prune_margin=1.0)
    enc = BatchedEncoder(lambda t, m: None)
    assert CorpusEngine(enc, 8, keep_forward=True,
                        device="cpu").builder.keep_forward


def _counting_encoders(vocab=32, width=4):
    """A token-counting encoder for each package: identical reps."""
    def counts(tokens, mask):
        tokens, mask = np.asarray(tokens), np.asarray(mask)
        out = np.zeros((tokens.shape[0], vocab), np.float32)
        for r in range(tokens.shape[0]):
            for t, on in zip(tokens[r], mask[r]):
                if on:
                    out[r, int(t) % vocab] += 1
        return out

    return (lambda t, m: sparsify_topk(torch.from_numpy(counts(t, m)),
                                       width),
            lambda t, m: jr.sparsify_topk(jnp.asarray(counts(t, m)), width))


def test_corpus_engine_grows_and_searches_as_in_jax():
    enc_t, enc_j = _counting_encoders()
    eng = CorpusEngine(BatchedEncoder(enc_t, policy=BatchPolicy(max_batch=8)),
                       32, device="cpu")
    ref = jserving.CorpusEngine(jserving.BatchedEncoder(
        enc_j, policy=jserving.BatchPolicy(max_batch=8)), 32)
    docs = [np.array([d, d, d], np.int32) for d in range(6)]
    for e in (eng, ref):
        np.testing.assert_array_equal(e.add_docs(docs), np.arange(6))
        np.testing.assert_array_equal(
            e.add_docs([np.array([7, 7, 7], np.int32)]), [6])
    q = np.eye(32, dtype=np.float32)[[3]] * 5
    for remove in ([], [3]):
        eng.remove_docs(remove)
        ref.remove_docs(remove)
        v_t, e_t = eng.search(sparsify_topk(torch.from_numpy(q), 4), 2)
        v_j, e_j = ref.search(jr.sparsify_topk(jnp.asarray(q), 4), 2)
        np.testing.assert_array_equal(e_t, e_j)
        np.testing.assert_allclose(v_t, v_j, atol=VAL_TOL)
    assert e_t[0, 0] != 3 and eng.stats() == ref.stats()
    assert eng.stats()["n_alive"] == 6


def test_corpus_engine_refuses_a_dense_encoder_after_one_chunk():
    calls = []

    def dense(tokens, mask):
        calls.append(tokens.shape[0])
        return torch.zeros((tokens.shape[0], 16))

    eng = CorpusEngine(BatchedEncoder(dense, policy=BatchPolicy(max_batch=4)),
                       16, device="cpu")
    with pytest.raises(ValueError, match="needs a sparse encoder"):
        eng.add_docs([np.ones(3, np.int32)] * 10)
    assert calls == [4]


def test_corpus_engine_with_the_smoke_encoder_matches_jax():
    """The SMOKE encoder with the JAX weights carried over, quantized base:
    the same external ids after growth and removal, values to 1e-3 (the
    reps agree to 2e-4; a code may step once where a rep lies on a
    rounding boundary)."""
    cfg_j = dataclasses.replace(JAX_SMOKE, compute_dtype="float32",
                                rep_topk=16)
    cfg_t = dataclasses.replace(SMOKE, compute_dtype="float32", rep_topk=16)
    params_j = jtfm.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t,
                               "cpu")
    eng = CorpusEngine(BatchedEncoder(make_config_encoder(params_t, cfg_t),
                                      policy=BatchPolicy(max_batch=16)),
                       cfg_t.vocab_size, quantize=True, device="cpu")
    ref = jserving.CorpusEngine(
        jserving.BatchedEncoder(jserving.make_config_encoder(params_j, cfg_j),
                                policy=jserving.BatchPolicy(max_batch=16)),
        cfg_j.vocab_size, quantize=True)
    rng = np.random.default_rng(9)
    docs = [rng.integers(1, cfg_t.vocab_size, 12).astype(np.int32)
            for _ in range(40)]
    toks = rng.integers(1, cfg_t.vocab_size, (3, 8)).astype(np.int32)
    for e in (eng, ref):
        e.add_docs(docs[:24])
        e.flush()
        e.add_docs(docs[24:])
        e.remove_docs([2, 30])
    q_t = make_config_encoder(params_t, cfg_t)(
        torch.from_numpy(toks), torch.ones((3, 8), dtype=torch.int32))
    q_j = jserving.make_config_encoder(params_j, cfg_j)(
        jnp.asarray(toks), jnp.ones((3, 8), jnp.int32))
    v_t, e_t = eng.search(q_t, 5)
    v_j, e_j = ref.search(q_j, 5)
    np.testing.assert_array_equal(e_t, e_j)
    np.testing.assert_allclose(v_t, v_j, rtol=1e-3, atol=1e-3)
    assert eng.stats() == ref.stats()


def test_serve_cli_engine_quantize_on_cpu(capsys):
    assert serve.main(["--device", "cpu", "--corpus", "96", "--requests",
                       "8", "--index-batch", "16", "--engine", "--quantize",
                       "--remove-frac", "0.25"]) == 0
    out = capsys.readouterr().out
    # six batches of 16: compactions at 32, 48, 64 and 96 docs (the delta
    # past a quarter of the base), then 24 tombstones zeroed in the base
    assert ("engine-indexed 72 live docs (24 tombstoned, 4 compactions, "
            "quantized base: True)") in out
    assert "encoded 8/8 requests" in out
    assert "retrieval[quantized]: top-10 for 8 queries" in out


def test_serve_cli_frozen_quantized_on_cpu(capsys):
    assert serve.main(["--device", "cpu", "--corpus", "64", "--requests",
                       "8", "--method", "quantized"]) == 0
    out = capsys.readouterr().out
    assert "indexed 64 docs in" in out and "quantized index:" in out
    assert "retrieval[quantized]: top-10 for 8 queries" in out


# the JAX CLI's messages; the ids are the cases' names from before the
# CLI took --prune-margin (which joined the first message)
@pytest.mark.parametrize("args,says", [
    (["--quantize"], "--quantize/--prune-margin/--remove-frac need --engine"),
    (["--remove-frac", "0.1"],
     "--quantize/--prune-margin/--remove-frac need --engine"),
    (["--engine", "--rep-topk", "0"], "--engine needs sparse reps"),
    (["--engine", "--method", "fused"], "--engine picks its retrieval path"),
    (["--method", "quantized", "--rep-topk", "0"],
     "needs SparseRep queries and an index"),
], ids=["args0---quantize/--remove-frac need --engine",
        "args1---quantize/--remove-frac need --engine",
        "args2---engine needs sparse reps",
        "args3---engine picks its retrieval path",
        "args4-needs SparseRep queries and an index"])
def test_serve_cli_engine_flags_refuse_as_in_jax(args, says, capsys):
    with pytest.raises(SystemExit) as exit_:
        serve.main(["--device", "cpu", *args])
    assert exit_.value.code == 2
    assert says in capsys.readouterr().err
