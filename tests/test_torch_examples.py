"""The port's examples and the head API names they use, against the JAX
package on the same inputs (CPU).

* ``sparton_forward_with_indices``: y to rtol = atol = 1e-5 (the f32
  products summed over D in another order, ``test_torch_sparton_head``'s
  TOL), ``i_max`` identical on inputs without exact ties.
* ``lm_head``: every impl to 1e-5 of the JAX ladder; an unknown name and
  the ``softcap`` deprecation give the JAX package's messages.
* ``serve_retrieval``: each flag set passes its own checks with its own
  weights. With the JAX package's SMOKE params carried across and both
  sides at f32 compute, the query reps hold the JAX ids (values to 2e-4,
  ``test_torch_serving``'s TOL for the trunk's f32 differences), the
  index holds the JAX postings except where a doc's rep cut its top 48
  at a near tie (the two terms within that TOL of each other), and the
  ``impact`` ids are the JAX ids. At the example's bf16 compute the two
  trunks round differently (query values a bf16 ulp apart, 7.8e-3), so
  the JAX comparison runs at f32.
* ``quickstart``: its sparton output and its top dims against the JAX
  head on its inputs.
* ``train_dimenet``: its first loss from the JAX example's carried SMOKE
  state equals the JAX example's first step on the same batch (rtol
  1e-5, ``test_torch_gnn_train``'s LOSS_RTOL); the CLI's default 60 steps
  on the CPU learn.
"""

import argparse
import dataclasses
import importlib
import importlib.util
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch.steps import init_state as jax_init_state
from repro.retrieval import build_inverted_index as jax_build
from repro.retrieval import retrieve as jax_retrieve
from repro.retrieval import stack_rows as jax_stack
from repro.runtime.serving import BatchedEncoder as JaxBatchedEncoder
from repro.runtime.serving import BatchPolicy as JaxBatchPolicy
from repro.runtime.serving import Request as JaxRequest
from repro.runtime.serving import ServingLoop as JaxServingLoop
from repro.runtime.serving import make_config_encoder as jax_encoder
from repro_torch.configs import get_config
from repro_torch.core import head_api, lm_head
from repro_torch.examples import quickstart, serve_retrieval, train_dimenet
from repro_torch.weights import params_from_jax

# the modules: ``repro.core`` exports a function named ``lm_head``
jax_head_api = importlib.import_module("repro.core.head_api")
jax_lm = importlib.import_module("repro.core.lm_head")

TOL = 1e-5
TRUNK_TOL = 2e-4
FLAG_SETS = {
    "frozen": [],
    "engine_quantize": ["--engine", "--quantize"],
    "engine_prune": ["--engine", "--prune-margin", "0.0"],
    "engine_cache": ["--engine", "--cache-mb", "4"],
}
CPU = torch.device("cpu")


def _inputs(B, S, D, V, seed):
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((B, S, D)).astype(np.float32)
    E = (rng.standard_normal((V, D)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(V) * 0.2).astype(np.float32)
    mask = (rng.random((B, S)) > 0.2).astype(np.int32)
    mask[:, 0] = 1
    return H, E, b, mask


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# --- the head API's names ---------------------------------------------------

@pytest.mark.parametrize("softcap", [None, 4.0])
@pytest.mark.parametrize("B,S,D,V", [(3, 33, 24, 100), (2, 64, 32, 600)])
def test_sparton_forward_with_indices_matches_jax(B, S, D, V, softcap):
    H, E, b, mask = _inputs(B, S, D, V, seed=B + V)
    y, i_max = lm_head.sparton_forward_with_indices(
        *_t(H, E, b, mask), vocab_tile=64, logit_softcap=softcap)
    y_ref, i_ref = jax_lm.sparton_forward_with_indices(
        *_j(H, E, b, mask), vocab_tile=64, logit_softcap=softcap)
    assert y.dtype == torch.float32 and i_max.dtype == torch.int32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(i_max.numpy(), np.asarray(i_ref))


def test_sparton_forward_with_indices_casts_to_h_dtype():
    H, E, b, mask = _inputs(2, 16, 8, 40, seed=5)
    Hb, Eb = (torch.from_numpy(a).to(torch.bfloat16) for a in (H, E))
    y, i_max = lm_head.sparton_forward_with_indices(Hb, Eb, *_t(b, mask))
    assert y.dtype == torch.bfloat16 and i_max.dtype == torch.int32
    y_ref, _ = jax_lm.sparton_forward_with_indices(
        jnp.asarray(H).astype(jnp.bfloat16),
        jnp.asarray(E).astype(jnp.bfloat16), *_j(b, mask))
    np.testing.assert_array_equal(y.float().numpy(),
                                  np.asarray(y_ref, np.float32))


def test_implementations_table_is_the_jax_one():
    assert sorted(lm_head.IMPLEMENTATIONS) == sorted(jax_lm.IMPLEMENTATIONS)
    assert lm_head.IMPLEMENTATIONS["sparton"] is lm_head.lm_head_sparton


@pytest.mark.parametrize("impl", ["naive", "tiled", "sparton", "kernel"])
def test_lm_head_dispatches_every_impl(impl):
    H, E, b, mask = _inputs(3, 33, 24, 100, seed=7)
    y = lm_head.lm_head(*_t(H, E, b, mask), impl=impl, vocab_tile=32,
                        logit_softcap=2.0)
    # the JAX Pallas "kernel" head does not run on this JAX version: the
    # port's kernel head is held to the JAX sparton rung
    ref = jax_lm.lm_head(*_j(H, E, b, mask),
                         impl="sparton" if impl == "kernel" else impl,
                         vocab_tile=32, logit_softcap=2.0)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_lm_head_defaults_fill_bias_and_mask():
    H, E, _, _ = _inputs(2, 10, 8, 30, seed=8)
    y = lm_head.lm_head(*_t(H, E))
    ref = jax_lm.lm_head(*_j(H, E))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_lm_head_unknown_impl_lists_the_registry():
    H, E, b, mask = _inputs(1, 4, 4, 8, seed=9)
    with pytest.raises(ValueError) as port:
        lm_head.lm_head(*_t(H, E, b, mask), impl="pallas")
    with pytest.raises(ValueError) as ref:
        jax_lm.lm_head(*_j(H, E, b, mask), impl="pallas")
    assert str(port.value) == str(ref.value)
    assert "'kernel', 'naive', 'sparton', 'tiled'" in str(port.value)


def test_lm_head_softcap_kwarg_is_deprecated():
    H, E, b, mask = _inputs(2, 12, 8, 50, seed=10)
    with pytest.warns(DeprecationWarning, match="'softcap' kwarg") as rec:
        y = lm_head.lm_head(*_t(H, E, b, mask), softcap=3.0)
    assert rec[0].filename == __file__      # blamed on the caller
    want = lm_head.lm_head(*_t(H, E, b, mask), logit_softcap=3.0)
    assert torch.equal(y, want)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = jax_lm.lm_head(*_j(H, E, b, mask), softcap=3.0)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("logit_softcap,softcap", [(2.0, 3.0), (None, 3.0),
                                                   (3.0, 3.0), (2.0, None),
                                                   (None, None)])
def test_normalize_softcap_kwarg_matches_jax(logit_softcap, softcap):
    def call(fn):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            try:
                out = fn(logit_softcap, softcap, "where")
            except ValueError as e:
                out = ("raised", str(e))
        return out, [(w.category, str(w.message)) for w in rec]

    port = call(head_api.normalize_softcap_kwarg)
    assert port == call(jax_head_api.normalize_softcap_kwarg)
    if softcap is not None and logit_softcap not in (None, softcap):
        assert port[0][0] == "raised" and "conflicting" in port[0][1]


# --- serve_retrieval --------------------------------------------------------

def _args(flags):
    return serve_retrieval.parser().parse_args(flags + ["--device", "cpu"])


@pytest.mark.parametrize("name", list(FLAG_SETS))
def test_serve_retrieval_passes_its_checks(name, capsys):
    out = serve_retrieval.run(_args(FLAG_SETS[name]), CPU)
    assert out["hits"] == 1.0
    assert all(out["exact_ids"].values()), out["exact_ids"]
    assert out["serving"]["served"] == serve_retrieval.QUERIES
    printed = capsys.readouterr().out
    assert "impact scoring == dense fallback (same SparseReps): True" in \
        printed and printed.rstrip().endswith("done.")
    if name == "engine_cache":
        assert "cached engine search == uncached (miss + hit pass): True" \
            in printed
        assert out["engine"]["cache_stats"]["results"]["hits"] == \
            serve_retrieval.QUERIES


@pytest.fixture(scope="module")
def jax_serve():
    """The JAX example's parts 1-3a with the JAX functions at f32 compute:
    SMOKE params from ``init_state(PRNGKey(0))``, the corpus reps, the
    index, the served query reps and the ``impact`` top-5."""
    state, _ = jax_init_state("splade_bert", jax.random.PRNGKey(0),
                              smoke=True)
    cfg = dataclasses.replace(jax_config("splade_bert").SMOKE,
                              rep_topk=serve_retrieval.REP_TOPK,
                              compute_dtype="float32")
    encode = jax_encoder(state["params"], cfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, size=(
        serve_retrieval.CORPUS, serve_retrieval.DOC_LEN)).astype(np.int32)
    corpus = jax_stack([encode(jnp.asarray(toks[lo:lo + 64]),
                               jnp.ones((64, toks.shape[1]), jnp.int32))
                        for lo in range(0, toks.shape[0], 64)])
    dense = np.asarray(jax_encoder(state["params"], dataclasses.replace(
        cfg, rep_topk=None))(jnp.asarray(toks),
                             jnp.ones(toks.shape, jnp.int32)))
    index = jax_build(corpus, cfg.vocab_size)
    loop = JaxServingLoop(JaxBatchedEncoder(
        encode, policy=JaxBatchPolicy(max_batch=8, max_wait_s=0.002)))
    for uid in range(serve_retrieval.QUERIES):
        loop.submit(JaxRequest(uid=uid, tokens=toks[uid].copy(),
                               deadline_s=60.0))
        loop.tick()
    loop.drain()
    q_rep = jax_stack([loop.take(u) for u in range(serve_retrieval.QUERIES)])
    vals, idx = jax_retrieve(q_rep, index, serve_retrieval.K,
                             method="impact")
    params = params_from_jax(jax.tree.map(np.asarray, state["params"]),
                             get_config("splade_bert").SMOKE, "cpu")
    return {"params": params, "q_rep": q_rep, "index": index,
            "dense": dense, "impact": (np.asarray(vals), np.asarray(idx))}


def _postings(index):
    """``{(term, doc): impact}`` of an index, either package's."""
    lens = np.asarray(index.term_lens)
    docs = np.asarray(index.postings_doc)
    vals = np.asarray(index.postings_val)
    terms = np.repeat(np.arange(lens.size), lens)
    return {(int(t), int(d)): float(v)
            for t, d, v in zip(terms, docs[:terms.size], vals[:terms.size])}


@pytest.mark.parametrize("name", list(FLAG_SETS))
def test_serve_retrieval_with_jax_params_matches_jax(name, jax_serve):
    cfg = dataclasses.replace(get_config("splade_bert").SMOKE,
                              compute_dtype="float32")
    out = serve_retrieval.run(_args(FLAG_SETS[name]), CPU,
                              params=jax_serve["params"], cfg=cfg)
    ref_q = jax_serve["q_rep"]
    np.testing.assert_array_equal(out["q_rep"].indices,
                                  np.asarray(ref_q.indices))
    np.testing.assert_array_equal(out["q_rep"].nnz, np.asarray(ref_q.nnz))
    np.testing.assert_allclose(out["q_rep"].values, np.asarray(ref_q.values),
                               rtol=TRUNK_TOL, atol=TRUNK_TOL)

    # the index: the same postings, but where a doc's top-48 cut fell at a
    # near tie and the two packages kept the other of two terms
    ref_index = jax_serve["index"]
    assert (out["index"].n_docs, out["index"].vocab_size) == \
        (ref_index.n_docs, ref_index.vocab_size)
    got, want = _postings(out["index"]), _postings(ref_index)
    for key in got.keys() & want.keys():
        assert abs(got[key] - want[key]) <= TRUNK_TOL * (1 + want[key]), key
    dense = jax_serve["dense"]
    kth = {d: v for (t, d), v in sorted(want.items(), key=lambda kv: -kv[1])}
    for term, doc in got.keys() ^ want.keys():
        assert abs(dense[doc, term] - kth[doc]) <= \
            TRUNK_TOL * (1 + kth[doc]), (term, doc)
    assert len(got.keys() ^ want.keys()) <= 2

    ref_vals, ref_ids = jax_serve["impact"]
    vals, ids = out["impact"]
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_allclose(vals, ref_vals, rtol=TRUNK_TOL, atol=TRUNK_TOL)


@pytest.mark.parametrize("flags,says", [
    (["--quantize"], "need --engine"),
    (["--prune-margin", "0"], "need --engine"),
    (["--cache-mb", "4"], "need --engine"),
    (["--engine", "--quantize", "--prune-margin", "0"], "exclusive"),
])
def test_serve_retrieval_cli_exclusions_raise(flags, says, capsys):
    with pytest.raises(SystemExit) as exc:
        serve_retrieval.main(flags + ["--device", "cpu"])
    assert exc.value.code == 2 and says in capsys.readouterr().err


def test_serve_retrieval_cli_runs_on_cpu(capsys):
    assert serve_retrieval.main(["--engine", "--prune-margin", "0.0",
                                 "--device", "cpu"]) == 0
    assert "engine search [pruned] == frozen-index retrieval on live docs" \
        in capsys.readouterr().out


@pytest.mark.parametrize("module", [serve_retrieval, quickstart])
def test_examples_default_to_cuda(module, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert module.parser().parse_args([]).device == "cuda"
    with pytest.raises(SystemExit) as exc:
        module.main([])
    assert exc.value.code == 2 and "CUDA" in capsys.readouterr().err


def test_same_ids_fails_on_the_cpu_and_passes_near_ties_on_the_card(capsys):
    scores = torch.tensor([[1.0, 1.00001, 0.5, 2.0]])
    got, want = np.array([[1, 0]]), np.array([[0, 1]])
    held = {}
    with pytest.raises(AssertionError, match="near_tie"):
        serve_retrieval.same_ids("near_tie", got, want, scores, CPU, held)
    assert held == {"near_tie": False}
    serve_retrieval.same_ids("near_tie", got, want, scores,
                             torch.device("cuda"), held)
    assert "row 0 ids [1, 0]" in capsys.readouterr().out
    with pytest.raises(AssertionError, match="far"):
        serve_retrieval.same_ids("far", np.array([[3, 0]]),
                                 np.array([[0, 3]]), scores,
                                 torch.device("cuda"), held)


# --- quickstart -------------------------------------------------------------

def test_quickstart_runs_and_matches_the_jax_head(capsys):
    out = quickstart.run(argparse.Namespace(device="cpu"), CPU)
    assert out["kernel_vs_sparton"] <= quickstart.KERNEL_TOL
    assert out["sparton_vs_naive"] <= TOL
    assert out["grads_finite"]
    B, S, D, V = quickstart.B, quickstart.S, quickstart.D, quickstart.V
    assert out["grad_shapes"] == [(B, S, D), (V, D), (V,)]
    printed = capsys.readouterr().out
    assert "registered head impls: ('kernel', 'naive', 'sparton', 'tiled')" \
        in printed and "example 0 — top vocab dims:" in printed

    H, E, b, mask = (x.numpy() for x in out["inputs"])
    y_ref, i_ref = jax_lm.sparton_forward_with_indices(*_j(H, E, b, mask))
    y_ref, i_ref = np.asarray(y_ref), np.asarray(i_ref)
    top = np.argsort(-y_ref[0], kind="stable")[:5]
    assert out["top_dims"] == top.tolist()
    assert out["top_tokens"] == i_ref[0, top].tolist()
    y, _ = lm_head.sparton_forward_with_indices(*_t(H, E, b, mask))
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=TOL, atol=TOL)


def test_quickstart_cli_runs_on_cpu(capsys):
    assert quickstart.main(["--device", "cpu"]) == 0
    assert "max |kernel - sparton|:" in capsys.readouterr().out


# --- train_dimenet ----------------------------------------------------------

def _jax_example(name):
    """The JAX package's ``examples/<name>.py`` as a module."""
    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_train_dimenet_first_loss_matches_the_jax_example(monkeypatch):
    from repro.configs.specs import CellSpec
    from repro.launch.steps import build_gnn_train_step
    from repro_torch.weights import state_from_jax

    ref = _jax_example("train_dimenet")
    jstate, _ = jax_init_state("dimenet", jax.random.PRNGKey(0), smoke=True)
    cfg = get_config("dimenet").SMOKE
    monkeypatch.setattr(train_dimenet, "init_state", lambda *a, **k:
                        state_from_jax(jax.tree.map(np.asarray, jstate), cfg,
                                       CPU))
    out = train_dimenet.run(argparse.Namespace(steps=11, device="cpu"), CPU)
    cell = CellSpec("dimenet", "molecule", "gnn_train", {}, n_graphs=8)
    _, m = jax.jit(build_gnn_train_step(jax_config("dimenet").SMOKE, cell,
                                        lr=2e-3))(jstate, ref.make_batch(0))
    assert [s for s, _ in out["losses"]] == [0, 10]
    np.testing.assert_allclose(out["losses"][0][1], float(m["loss"]),
                               rtol=1e-5)
    batch = train_dimenet.make_batch(0, CPU)
    for key, value in ref.make_batch(0).items():
        np.testing.assert_array_equal(batch[key].numpy(), np.asarray(value))


def test_train_dimenet_cli_learns_on_cpu(capsys):
    assert train_dimenet.main(["--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "loss trajectory:" in printed and "done: 60 steps" in printed


def test_train_dimenet_defaults_to_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert train_dimenet.parser().parse_args([]).device == "cuda"
    with pytest.raises(SystemExit) as exc:
        train_dimenet.main([])
    assert exc.value.code == 2 and "CUDA" in capsys.readouterr().err
