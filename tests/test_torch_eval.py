"""The port's evaluation package (``repro_torch.eval``) and the train CLI's
``--eval-every`` against the JAX package (``repro.eval``) on the same numpy
inputs, on the CPU.

Tolerances:

* ``Qrels``: every constructor and ``to_arrays`` identical (the same
  numpy code);
* the metric references (``*_ref``): identical values (the same Python
  code);
* the batched metrics and ``compute_metrics``: atol 1e-6 against the
  JAX package's (f32 sums that may run in another order);
* ``evaluate_retrieval`` on an impact corpus (``exact``, ``quantized``,
  and ``fused``: the port's plain versions here, the JAX package's
  Pallas K4 in interpret mode) and on a token corpus (SMOKE splade_bert
  with the JAX state carried across, f32 compute so that no score tie
  flips; the JAX side on its reference head, ``head_impl="jax"``):
  every metric within 1e-6, so every ranking that a metric sees is the
  same;
* the CLI's ``eval @ init`` line: equal, at its four printed decimals,
  to ``evaluate_retrieval`` on the CLI's initial state.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import eval as jeval
from repro.configs.splade_bert import SMOKE as JAX_SMOKE
from repro.data import synthetic as jax_data
from repro.launch import steps as jax_steps
from repro_torch import eval as teval
from repro_torch.configs.splade_bert import SMOKE
from repro_torch.data import synthetic
from repro_torch.eval import harness
from repro_torch.launch import train as cli
from repro_torch.launch.steps import init_state
from repro_torch.runtime.serving import make_config_encoder
from repro_torch.weights import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
ATOL = 1e-6


# ---------------------------------------------------------------------------
# Qrels
# ---------------------------------------------------------------------------

TRIPLES = [(0, 5, 1.0), (0, 5, 3.0), (1, 2, 2.0), (0, 5, 2.0), (4, 9, -1.0),
           (4, 1, 2.0), (4, 3, 0.0)]
QRELS_CASES = {
    "mapping": lambda Q: Q({0: {3: 2.0}, 4: {1: 1.0, 2: 3.0}, 6: {}}),
    "empty": lambda Q: Q(),
    "triples": lambda Q: Q.from_triples(TRIPLES),
    "triples_array": lambda Q: Q.from_triples(
        np.array([[0, 3, 2.0], [2, 4, 1.0], [2, 7, 4.0]], np.float32)),
    "paired": lambda Q: Q.paired(3),
    "paired_ids_grade": lambda Q: Q.paired(3, doc_ids=[10, 20, 30],
                                           grade=2.0),
    "remap": lambda Q: Q({0: {5: 1.0, 6: 2.0}, 1: {6: 1.0}}).remap_docs(
        {5: 50, 6: 60}),
    "remap_drop": lambda Q: Q({0: {5: 1.0, 6: 2.0}, 1: {6: 1.0}}
                              ).remap_docs({5: 50}, strict=False),
}


def _qrels_view(q):
    return (q.query_ids, q.n_queries, q.n_judged, q.max_relevant, len(q),
            repr(q), {qid: q.relevant(qid) for qid in q.query_ids + [99]},
            q.grade(0, 5))


@pytest.mark.parametrize("case", sorted(QRELS_CASES))
def test_qrels_constructors_and_arrays_identical_to_jax(case):
    ours, theirs = (QRELS_CASES[case](m.Qrels) for m in (teval, jeval))
    assert _qrels_view(ours) == _qrels_view(theirs)
    for args in ((), (list(reversed(ours.query_ids)) + [7],),
                 (ours.query_ids[:1],)):
        for width in (None, ours.max_relevant + 2):
            a, b = ours.to_arrays(*args, width=width), \
                theirs.to_arrays(*args, width=width)
            for x, y in zip(a, b):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


ERROR_CASES = {
    "paired_ids": (ValueError, "doc ids",
                   lambda Q: Q.paired(3, doc_ids=[1, 2])),
    "remap_strict": (KeyError, "no entry",
                     lambda Q: Q({0: {5: 1.0}}).remap_docs({6: 60})),
    "width": (ValueError, "width",
              lambda Q: Q({0: {1: 1.0, 2: 1.0}}).to_arrays(width=1)),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_qrels_errors_as_jax(case):
    exc, match, fn = ERROR_CASES[case]
    for mod in (teval, jeval):
        with pytest.raises(exc, match=match):
            fn(mod.Qrels)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

K_RETRIEVED, R_JUDGED = 12, 5
KS = (1, 5, 10, 16)          # 16 > K: every retrieved id counts


def _instance(seed, b=9, n_docs=40):
    """Retrieved ids with padding holes (-1), and judgments with grades in
    {-1, 0, 1, 2, 3} (the non-positive ones are not relevant), some
    queries with none, some with repeated retrieved ids."""
    rng = np.random.default_rng(seed)
    ranked = np.stack([rng.permutation(n_docs)[:K_RETRIEVED]
                       for _ in range(b)])
    ranked[rng.random(ranked.shape) < 0.15] = -1
    ranked[0, 3] = ranked[0, 1]
    judged = {}
    for q in range(b):
        docs = rng.permutation(n_docs)[:rng.integers(0, R_JUDGED + 1)]
        judged[q] = {int(d): float(rng.integers(-1, 4)) for d in docs}
    judged[1] = {int(ranked[1, 2]): 3.0, int(ranked[1, 7]): 1.0}
    return ranked, judged


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(teval.REFERENCE))
def test_reference_metrics_identical_to_jax(name, seed):
    ranked, judged = _instance(seed)
    for k in KS:
        for q, rels in judged.items():
            assert teval.REFERENCE[name](ranked[q], rels, k) \
                == jeval.REFERENCE[name](ranked[q], rels, k)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", sorted(teval.BATCHED))
def test_batched_metrics_match_jax(name, k):
    for seed in range(3):
        ranked, judged = _instance(seed)
        rel_ids, rel_grades = jeval.Qrels(judged).to_arrays()
        assert rel_ids.shape[1] <= R_JUDGED < K_RETRIEVED
        got = teval.BATCHED[name](ranked, rel_ids, rel_grades, k=k)
        want = jeval.BATCHED[name](ranked, rel_ids, rel_grades, k=k)
        assert got.dtype == torch.float32 and got.shape == (ranked.shape[0],)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL, err_msg=f"{name}@{k}")
        # tensors in, a tensor on their device out
        t = teval.BATCHED[name](torch.from_numpy(ranked), rel_ids,
                                rel_grades, k=k)
        assert t.device == CPU
        np.testing.assert_array_equal(t.numpy(), got.numpy())


def test_ranked_grades_match_jax():
    ranked, judged = _instance(4)
    rel_ids, rel_grades = jeval.Qrels(judged).to_arrays()
    got = teval.ranked_grades(ranked, rel_ids, rel_grades)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jeval.ranked_grades(ranked, rel_ids,
                                                    rel_grades)))


def test_mrr_takes_the_first_of_several_hits():
    ranked = np.array([[7, 3, 9, 3], [-1, 9, 9, 2]])
    rel_ids = np.array([[3, 9], [9, 2]])
    rel_grades = np.array([[1.0, 2.0], [1.0, 1.0]], np.float32)
    got = teval.mrr_at_k(ranked, rel_ids, rel_grades, k=4)
    np.testing.assert_array_equal(got.numpy(), [0.5, 0.5])


@pytest.mark.parametrize("seed", [0, 1])
def test_compute_metrics_matches_jax(seed):
    ranked, judged = _instance(seed)
    ours, theirs = teval.Qrels(judged), jeval.Qrels(judged)
    order = list(np.random.default_rng(seed).permutation(ranked.shape[0]))
    for query_ids in (None, order):
        got = teval.compute_metrics(ranked, ours, ks=KS, query_ids=query_ids)
        want = jeval.compute_metrics(ranked, theirs, ks=KS,
                                     query_ids=query_ids)
        assert list(got) == list(want)
        np.testing.assert_allclose([got[m] for m in got],
                                   [want[m] for m in want], rtol=0,
                                   atol=ATOL)


def test_compute_metrics_row_alignment():
    qrels = teval.Qrels.paired(2)
    ranked = np.array([[0, 5], [1, 5], [9, 9]])
    with pytest.raises(ValueError, match="ranking rows"):
        teval.compute_metrics(ranked, qrels)
    out = teval.compute_metrics(ranked[:2], qrels, ks=(1, 2))
    assert out["mrr@1"] == 1.0 and out["mrr@2"] == 1.0
    out = teval.compute_metrics(ranked[:2], qrels, ks=(2,), query_ids=[1, 0])
    assert out["mrr@2"] == 0.0


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------

IMPACT_METHODS = {
    "exact": {},
    "quantized": {"engine": {"quantize": True}},
    "fused": {"search": {"method": "fused"}},
}


@pytest.fixture(scope="module")
def impact_runs():
    kw = dict(n_docs=96, vocab=1024, doc_nnz=32, n_queries=8, q_nnz=26,
              graded=12, seed=3)
    ours, theirs = synthetic.lsr_impact_corpus(**kw), \
        jax_data.lsr_impact_corpus(**kw)
    for key in theirs:
        np.testing.assert_array_equal(ours[key], theirs[key])
    run = {}
    for mod, corpus, extra in ((teval, ours, {"device": "cpu"}),
                               (jeval, theirs, {})):
        specs = [mod.MethodSpec(name, **spec)
                 for name, spec in IMPACT_METHODS.items()]
        run[mod.__name__] = mod.evaluate_retrieval(
            None, corpus, mod.Qrels.from_triples(corpus["qrels"]),
            methods=specs, ks=(1, 10), **extra)
    return run["repro_torch.eval"], run["repro.eval"]


@pytest.mark.parametrize("method", sorted(IMPACT_METHODS))
def test_evaluate_retrieval_impact_corpus_matches_jax(impact_runs, method):
    got, want = (r[method] for r in impact_runs)
    assert list(got) == list(want)
    np.testing.assert_allclose([got[m] for m in got],
                               [want[m] for m in want], rtol=0, atol=ATOL)
    assert got["ndcg@10"] == pytest.approx(1.0)


def test_evaluate_retrieval_token_corpus_matches_jax():
    """SMOKE splade_bert from the JAX package's PRNGKey(0) params, held-out
    pairs of the train CLI's seed, external doc ids, chunks of 5 (the
    last one padded)."""
    cfg_t = dataclasses.replace(SMOKE, compute_dtype="float32")
    cfg_j = dataclasses.replace(JAX_SMOKE, compute_dtype="float32",
                                head_impl="jax")
    state, _ = jax_steps.init_state("splade_bert", jax.random.PRNGKey(0),
                                    smoke=True)
    params = params_from_jax(jax.tree.map(np.asarray, state["params"]),
                             cfg_t, "cpu")
    corpus, _ = cli.held_out(cfg_t, 24, q_len=8, d_len=16)
    doc_ids = 100 + 3 * np.arange(24)
    kw = dict(ks=(1, 3, 10), doc_ids=doc_ids, batch=5)

    got = teval.evaluate_retrieval(
        make_config_encoder(params, cfg_t), corpus,
        teval.Qrels.paired(24, doc_ids=doc_ids), device="cpu", **kw)
    encode = jax.jit(lambda t, m: jax_steps._encode_fn(cfg_j, None, 5)(
        state["params"], t, m)[0])
    want = jeval.evaluate_retrieval(
        encode, corpus, jeval.Qrels.paired(24, doc_ids=doc_ids),
        methods=jeval.DEFAULT_METHODS, **kw)
    assert list(got) == ["exact", "pruned", "quantized"]
    for name in got:
        assert list(got[name]) == list(want[name])
        np.testing.assert_allclose(list(got[name].values()),
                                   list(want[name].values()), rtol=0,
                                   atol=ATOL, err_msg=name)
    assert 0.0 < got["exact"]["mrr@10"] < 1.0     # a ranking, not a tie


def test_encode_reps_pads_every_chunk_and_drops_the_padding():
    shapes = []

    def encoder(tokens, mask):
        assert isinstance(tokens, torch.Tensor)
        shapes.append(tuple(tokens.shape))
        return 2.0 * torch.eye(tokens.shape[0], 32) + tokens[:, :1].float()

    def jax_encoder(tokens, mask):
        return 2.0 * jnp.eye(tokens.shape[0], 32) + tokens[:, :1]

    tokens = np.arange(44, dtype=np.int32).reshape(11, 4) % 7
    got = teval.encode_reps(encoder, tokens, batch=4, rep_topk=8)
    want = jeval.encode_reps(jax_encoder, tokens, batch=4, rep_topk=8)
    assert set(shapes) == {(4, 4)} and len(shapes) == 3
    assert got.values.shape == (11, 8)
    for a, b in zip((got.values, got.indices, got.nnz),
                    (want.values, want.indices, want.nnz)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_doc_sharded_spec_metrics_equal_jax():
    """``MethodSpec(doc_shards=3)``, refused before the doc-sharded index
    was ported: a ``ShardedIndex`` searched with ``sharded``, each metric
    within 1e-6 of JAX's and of ``exact``'s."""
    kw = dict(n_docs=16, vocab=64, doc_nnz=8, n_queries=2, q_nnz=6,
              graded=2)
    out = {}
    for mod, data, extra in ((teval, synthetic, {"device": "cpu"}),
                             (jeval, jax_data, {})):
        corpus = data.lsr_impact_corpus(**kw)
        out[mod.__name__] = mod.evaluate_retrieval(
            None, corpus, mod.Qrels.from_triples(corpus["qrels"]),
            methods=(mod.MethodSpec("exact"),
                     mod.MethodSpec("doc_sharded", doc_shards=3)), **extra)
    got, want = out["repro_torch.eval"], out["repro.eval"]
    for name in ("exact", "doc_sharded"):
        np.testing.assert_allclose(list(got[name].values()),
                                   list(want[name].values()), rtol=0,
                                   atol=ATOL)
    np.testing.assert_allclose(list(got["doc_sharded"].values()),
                               list(got["exact"].values()), rtol=0, atol=ATOL)


@pytest.mark.parametrize("margin", [0.0, 0.5])
def test_pruned_spec_metrics_equal_jax(margin):
    """The pruned spec (the engine's forward rows, the two-tier scorer) on
    a graded corpus: each metric equal to JAX's to 1e-6, and at margin 0
    equal to exact's."""
    corpus = synthetic.lsr_impact_corpus(n_docs=128, vocab=256, doc_nnz=16,
                                         n_queries=6, q_nnz=12, graded=4,
                                         seed=3)
    kw = dict(engine={"keep_forward": True},
              search={"method": "pruned", "prune_margin": margin})
    got = teval.evaluate_retrieval(
        None, corpus, teval.Qrels.from_triples(corpus["qrels"]),
        methods=(teval.MethodSpec("exact"), teval.MethodSpec("pruned", **kw)),
        device="cpu")
    want = jeval.evaluate_retrieval(
        None, corpus, jeval.Qrels.from_triples(corpus["qrels"]),
        methods=(jeval.MethodSpec("exact"), jeval.MethodSpec("pruned", **kw)))
    for name in ("exact", "pruned"):
        assert set(got[name]) == set(want[name])
        for key, value in want[name].items():
            assert abs(got[name][key] - value) <= 1e-6, (name, key)
    if margin == 0.0:
        assert got["pruned"] == got["exact"]


def test_default_methods_are_the_ported_ones():
    assert ([m.name for m in teval.DEFAULT_METHODS]
            == [m.name for m in jeval.DEFAULT_METHODS]
            == ["exact", "pruned", "quantized"])
    for got, want in zip(teval.DEFAULT_METHODS, jeval.DEFAULT_METHODS):
        assert dict(got.engine) == dict(want.engine)
        assert dict(got.search) == dict(want.search)


@pytest.mark.parametrize("corpus,match", [
    ({"docs": np.ones((2, 4))}, "corpus must carry"),
    ({"doc_tokens": np.ones((2, 4)), "q_tokens": np.ones((1, 4))},
     "needs an encoder"),
])
def test_evaluate_retrieval_rejects_bad_corpus(corpus, match):
    with pytest.raises(ValueError, match=match):
        teval.evaluate_retrieval(None, corpus, teval.Qrels.paired(1),
                                 device="cpu")


def test_harness_indexes_on_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    corpus = synthetic.lsr_impact_corpus(n_docs=16, vocab=64, doc_nnz=8,
                                         n_queries=2, q_nnz=6, graded=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        teval.evaluate_retrieval(None, corpus,
                                 teval.Qrels.from_triples(corpus["qrels"]))
    assert harness.resolve_device("cpu") == CPU


# ---------------------------------------------------------------------------
# the train CLI's --eval-every
# ---------------------------------------------------------------------------

LINE = r"mrr@10 ([0-9.]+) ndcg@10 ([0-9.]+)"


def _cli(ckpt_dir, *extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "splade_bert", "--steps", "2", "--batch", "2", "--seq-len", "16",
         "--eval-every", "1", "--eval-queries", "8", "--ckpt-dir",
         str(ckpt_dir), *extra],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)


def test_train_cli_eval_lines_match_evaluate_retrieval(tmp_path):
    proc = _cli(tmp_path, "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    init = re.search(r"^eval @ init: " + LINE + "$", out, re.MULTILINE)
    steps = re.findall(r"^eval @ step (\d+): " + LINE + "$", out,
                       re.MULTILINE)
    gain = re.search(r"^eval improvement over init: mrr@10 ([0-9.]+)->"
                     r"([0-9.]+)\(([-+][0-9.]+)\) ndcg@10 ([0-9.]+)->"
                     r"([0-9.]+)\(([-+][0-9.]+)\)$", out, re.MULTILINE)
    assert init and gain and [s[0] for s in steps] == ["1", "2"], out
    assert out.index("eval @ init") < out.index("eval @ step 1") \
        < out.index("step 2: loss") < out.index("eval improvement")
    assert gain.group(1, 4) == init.group(1, 2)
    assert gain.group(2, 5) == steps[-1][1:]

    state = init_state("splade_bert", torch.Generator().manual_seed(0),
                       smoke=True)
    want = cli.evaluator(SMOKE, *cli.held_out(SMOKE, 8, q_len=16, d_len=16),
                         device=CPU)(state)
    assert init.group(1, 2) == (f"{want['mrr@10']:.4f}",
                                f"{want['ndcg@10']:.4f}")


@pytest.mark.parametrize("steps,every,at", [(3, 2, [2, 3]), (4, 2, [2, 4]),
                                             (2, 0, [])])
def test_train_cli_evaluates_every_n_steps_and_at_the_last(steps, every, at,
                                                           capsys, tmp_path):
    args = cli.parser().parse_args([
        "--arch", "splade_bert", "--steps", str(steps), "--batch", "2",
        "--seq-len", "8", "--eval-every", str(every), "--eval-queries", "4",
        "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    res = cli.run(args, CPU)
    assert [s for s, _ in res["evals"]] == at
    assert (res["init"] is None) == (not every)
    assert len(res["losses"]) == steps and res["state"]["step"] == steps
    printed = capsys.readouterr().out
    assert ("eval improvement over init" in printed) == bool(every)
    for s, m in res["evals"]:
        assert set(m) == {"mrr@10", "ndcg@10"}
        assert f"eval @ step {s}: mrr@10 {m['mrr@10']:.4f}" in printed


def test_train_cli_with_eval_without_cuda_exits_non_zero_naming_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = _cli(tmp_path)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr and "eval" not in proc.stdout
