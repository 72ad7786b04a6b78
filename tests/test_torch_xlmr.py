"""``splade_xlmr`` (|V| 250002) in the port against the JAX package, with
the JAX params carried over by ``repro_torch.weights`` (CPU, at SMOKE).

Tolerances, those the BERT tests state:

* configs and shapes: equal field for field;
* hidden states: f32 compute rtol = atol = 1e-4, bf16 compute atol 0.1
  with a mean-error bound of 0.02 (``test_torch_encoder.py``);
* the head's ``(B, V)`` rep at f32 compute: rtol = atol = 1e-4;
* one train step at f32 compute against the jitted JAX step, with a peak
  lr of 0.5: the loss rtol 1e-5, every param atol 1e-5
  (``test_torch_train.py``).

The full width runs only on the card (``chip_smoke.py``); here the K1,
K2 and K3 wrappers take its shapes (V 250002, B 420, S 256) on meta
tensors: every check passes up to the device check, and the scratch K2
allocates there (its (v, g) lists, 840 MB) is sized exactly. So do the
serving kernels at its shapes: K6 on the dense serve's (16384, 250002)
corpus, K5 reading the engine's quantized base in place and K4's
ceiling entry on the pruned engine's base.
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

from repro.configs import splade_xlmr as jax_xlmr
from repro.data import synthetic as jax_data
from repro.launch import steps as jax_steps
from repro.models import transformer as jtfm
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs import splade_xlmr as xlmr
from repro_torch.kernels import impact_score, sparton, sparton_bwd
from repro_torch.kernels import topk_score
from repro_torch.launch import steps
from repro_torch.models import transformer as tfm
from repro_torch.tree import tree_leaves
from repro_torch.weights import params_from_jax, state_from_jax

ROOT = Path(__file__).resolve().parents[1]
FULL_V = 250002


def test_xlmr_is_registered():
    assert "splade_xlmr" in ARCHS
    assert get_config("splade_xlmr") is xlmr


@pytest.mark.parametrize("name", ["CONFIG", "SMOKE"])
def test_configs_equal_jax_field_for_field(name):
    """Every field of the port's config equals the JAX one's, but
    ``head_impl``: the port's configs default to the CUDA head."""
    ours, theirs = getattr(xlmr, name), getattr(jax_xlmr, name)
    for field in dataclasses.fields(ours):
        if field.name == "head_impl":
            assert ours.head_impl == "kernel"
            continue
        assert getattr(ours, field.name) == getattr(theirs, field.name), \
            field.name
    assert ours.n_params == theirs.n_params


def test_full_config_is_the_published_width():
    cfg = xlmr.CONFIG
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff,
            cfg.vocab_size, cfg.tie_embeddings) == (12, 768, 12, 3072,
                                                    FULL_V, True)
    assert xlmr.SMOKE.vocab_size == 1024


def test_shapes_equal_jax():
    assert sorted(xlmr.SHAPES) == sorted(jax_xlmr.SHAPES) == [
        "train_16", "train_420"]
    for key, ours in xlmr.SHAPES.items():
        theirs = jax_xlmr.SHAPES[key]
        assert (ours.name, ours.kind, ours.seq_len, ours.global_batch) == (
            theirs.name, theirs.kind, theirs.seq_len, theirs.global_batch)


def _tokens(B=3, S=20, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, xlmr.SMOKE.vocab_size, size=(B, S)).astype(
        np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 13:] = 0
    mask[2, 5:] = 0
    return toks, mask


def _both(compute_dtype):
    cfg_j = dataclasses.replace(jax_xlmr.SMOKE, compute_dtype=compute_dtype)
    cfg_t = dataclasses.replace(xlmr.SMOKE, compute_dtype=compute_dtype)
    params_j = jtfm.init_params(jax.random.PRNGKey(0), cfg_j)
    tree = jax.tree.map(np.asarray, params_j)
    return cfg_j, params_j, cfg_t, params_from_jax(tree, cfg_t, "cpu")


@pytest.mark.parametrize("compute_dtype,atol,mean_tol", [
    ("float32", 1e-4, 1e-5), ("bfloat16", 0.1, 0.02)])
def test_forward_hidden_matches_jax(compute_dtype, atol, mean_tol):
    cfg_j, params_j, cfg_t, params_t = _both(compute_dtype)
    toks, mask = _tokens()
    H_j, _ = jtfm.forward_hidden(params_j, cfg_j, jnp.asarray(toks),
                                 jnp.asarray(mask))
    H_t = tfm.forward_hidden(params_t, cfg_t, torch.from_numpy(toks),
                             torch.from_numpy(mask))
    ref = np.asarray(H_j, np.float32)
    got = H_t.float().numpy()
    rtol = 1e-4 if compute_dtype == "float32" else 0.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)
    assert np.abs(got - ref).mean() <= mean_tol


@pytest.mark.parametrize("impl", ["sparton", "kernel"])
def test_lsr_encode_rep_matches_jax_f32(impl):
    cfg_j, params_j, cfg_t, params_t = _both("float32")
    toks, mask = _tokens(seed=1)
    y_j, _ = jtfm.lsr_encode(params_j, cfg_j, jnp.asarray(toks),
                             jnp.asarray(mask))
    y_t = tfm.lsr_encode(params_t, cfg_t, torch.from_numpy(toks),
                         torch.from_numpy(mask), head_impl=impl)
    assert y_t.shape == (3, xlmr.SMOKE.vocab_size)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-4,
                               atol=1e-4)


def test_init_state_carries_jax_params_across_unchanged():
    state_j, _ = jax_steps.init_state("splade_xlmr", jax.random.PRNGKey(0),
                                      smoke=True)
    numpy_state = jax.tree.map(np.asarray, state_j)
    state_t = state_from_jax(numpy_state, xlmr.SMOKE, "cpu")
    for got, want in zip(tree_leaves(state_t["params"]),
                         jax.tree.leaves(numpy_state["params"])):
        np.testing.assert_array_equal(got.numpy(), want)
    ours = steps.init_state("splade_xlmr", torch.Generator().manual_seed(0),
                            smoke=True)
    assert ours["params"]["embed"].shape == (1024, 64)
    assert [tuple(t.shape) for t in tree_leaves(ours["params"])] == [
        tuple(t.shape) for t in tree_leaves(state_t["params"])]


def test_train_step_f32_matches_jax_jitted_step():
    """One step of both packages from the JAX SMOKE state, the kernel head
    (its plain versions here) against the JAX package's plain head."""
    cfg_j = dataclasses.replace(jax_xlmr.SMOKE, compute_dtype="float32",
                                head_impl="jax")
    cfg_t = dataclasses.replace(xlmr.SMOKE, compute_dtype="float32")
    state_j, _ = jax_steps.init_state("splade_xlmr", jax.random.PRNGKey(0),
                                      smoke=True)
    state_t = state_from_jax(jax.tree.map(np.asarray, state_j), cfg_t,
                             "cpu")
    batch = next(jax_data.lsr_pair_batches(batch=4, q_len=12, d_len=16,
                                           vocab=cfg_t.vocab_size))
    step_j = jax.jit(jax_steps.build_lsr_train_step(
        cfg_j, None, n_micro=1, n_pairs=4, lr=0.5))
    state_j, m_j = step_j(state_j, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    state_t, m_t = steps.build_lsr_train_step(cfg_t, lr=0.5)(
        state_t, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                               rtol=1e-5)
    leaves_j = jax.tree.leaves(state_j["params"])
    leaves_t = tree_leaves(state_t["params"])
    assert len(leaves_j) == len(leaves_t)
    for got, want in zip(leaves_t, leaves_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


def _run(module, *extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", module, "--arch", "splade_xlmr", *extra],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)


def test_train_cli_runs_xlmr_on_the_cpu(tmp_path):
    proc = _run("repro_torch.launch.train", "--steps", "2", "--batch", "2",
                "--seq-len", "16", "--device", "cpu", "--ckpt-dir",
                str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    m = re.search(r"step 2: loss ([-0-9.e]+) \(first ([-0-9.e]+)\)",
                  proc.stdout)
    assert m and all(np.isfinite(float(x)) for x in m.groups())
    assert "splade-xlmr-smoke (head kernel)" in proc.stdout


def test_serve_cli_runs_xlmr_on_the_cpu():
    proc = _run("repro_torch.launch.serve", "--device", "cpu", "--corpus",
                "64", "--requests", "8", "--method", "fused")
    assert proc.returncode == 0, proc.stderr
    assert "retrieval[fused]" in proc.stdout


@pytest.mark.parametrize("module", ["repro_torch.launch.train",
                                    "repro_torch.launch.serve"])
def test_xlmr_clis_without_cuda_exit_non_zero_naming_it(module, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = _run(module, *(("--steps", "1", "--ckpt-dir", str(tmp_path))
                          if "train" in module else ()))
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("B,S", [(420, 256), (16, 256), (8, 128)])
def test_head_kernels_take_xlmr_shapes_without_a_card(B, S):
    """K1, K2 and K3 at D 768 and V 250002 pass every argument check and
    reach the device check, where meta tensors get the kernels' empty
    outputs and launch nothing (a CPU bias beside them raises); K1 plans
    the "tma" path."""
    D = 768
    H = _meta((B, S, D), torch.bfloat16)
    E = _meta((FULL_V, D), torch.bfloat16)
    mask = _meta((B, S), torch.int32)
    assert sparton._plan(H, E) == "tma"
    launches = (sparton.sparton_forward.launches,
                sparton_bwd.sparton_backward_dh.launches,
                sparton_bwd.sparton_backward_de.launches)
    y, i_max = sparton.sparton_forward(H, E, _meta((FULL_V,)), mask)
    assert tuple(y.shape) == tuple(i_max.shape) == (B, FULL_V)
    with pytest.raises(ValueError, match="one CUDA device"):
        sparton.sparton_forward(H, E, torch.zeros(FULL_V), mask)
    dy = _meta((B, FULL_V))
    i_max = _meta((B, FULL_V), torch.int32)
    dH = sparton_bwd.sparton_backward_dh(dy, dy, i_max, E, S)
    dE, db = sparton_bwd.sparton_backward_de(dy, dy, i_max, H)
    assert tuple(dH.shape) == (B, S, D)
    assert (tuple(dE.shape), tuple(db.shape)) == ((FULL_V, D), (FULL_V,))
    assert (sparton.sparton_forward.launches,
            sparton_bwd.sparton_backward_dh.launches,
            sparton_bwd.sparton_backward_de.launches) == launches


def test_dh_scratch_at_train_420_has_no_overflow():
    """K2's scratch at train_420: (420, 250002, 2) i32 entries, 840 MB;
    every size is the exact product."""
    B, S, V = 420, 256, FULL_V
    ofs, lists, gs, heavy = sparton_bwd.dh_scratch(B, S, V,
                                                   torch.device("meta"))
    assert lists.numel() == 2 * B * V == 210_001_680
    assert lists.numel() * lists.element_size() == 840_006_720
    assert gs.numel() * gs.element_size() == 4 * B * V
    assert ofs.numel() == B * (S + 1)
    assert heavy.numel() == 2 + 2 * B * S
    # B * S * V, the logits the kernels never write, passes 2**31
    assert B * S * V > 2**31


# the xlmr serving phases' shapes: 8 served queries of 64 terms, the
# engine's 19456-doc base of 64 terms a doc, the dense serve's corpus
SERVE_B, SERVE_Q, BASE_DOCS, DENSE_DOCS = 8, 64, 19456, 16384


def test_k6_takes_the_xlmr_dense_corpus_without_a_card():
    """K6's wrapper at (8, 16384, 250002) passes its argument checks and
    stops at the device check; a corpus of the wrong width stops at the
    shape check. The corpus holds more than 2**31 elements (16.4 GB of
    f32), which the kernel addresses with size_t row offsets."""
    q = _meta((SERVE_B, FULL_V))
    C = _meta((DENSE_DOCS, FULL_V))
    with pytest.raises(ValueError, match="one CUDA device"):
        topk_score.topk_score(q, C, k=10)
    with pytest.raises(ValueError, match=r"must be \(B, D\) and \(N, D\)"):
        topk_score.topk_score(q, _meta((DENSE_DOCS, FULL_V - 1)), k=10)
    assert C.numel() == 4_096_032_768 > 2**31
    assert C.numel() * C.element_size() == 16_384_131_072


def _queries():
    return (_meta((SERVE_B, SERVE_Q), torch.int32),
            _meta((SERVE_B, SERVE_Q)))


def test_k5_takes_the_xlmr_quantized_base_without_a_card():
    """K5 reading a quantized base in place at V 250002 (u16 lengths and
    deltas, as the engine builds it there) passes its argument checks and
    stops at the device check."""
    P = BASE_DOCS * 64
    base = (_meta((FULL_V,), torch.int32), _meta((FULL_V,), torch.uint16),
            _meta(((P + 1) // 2,), torch.uint8), _meta((P,), torch.uint16),
            _meta((FULL_V,), torch.float16), _meta((FULL_V,), torch.float16))
    with pytest.raises(ValueError, match="one CUDA device"):
        impact_score.fused_quantized_index_topk(*_queries(), *base,
                                                n_docs=BASE_DOCS, k=10)
    short = base[:4] + (_meta((FULL_V - 1,), torch.float16),) + base[5:]
    with pytest.raises(ValueError, match=r"must be \(V,\)"):
        impact_score.fused_quantized_index_topk(*_queries(), *short,
                                                n_docs=BASE_DOCS, k=10)


@pytest.mark.parametrize("k", [65, 129, 257])
def test_k4_ceiling_entry_takes_the_xlmr_base_without_a_card(k):
    """K4's ceiling entry (tier 1 of ``pruned``) at V 250002 and the
    pruned phase's k (C + 1 for C 64 and 128, and 257) passes its argument
    checks and stops at the device check."""
    P = BASE_DOCS * 64
    base = (_meta((FULL_V,), torch.int32), _meta((FULL_V,), torch.int32),
            _meta((P,), torch.int32), _meta((FULL_V,)))
    with pytest.raises(ValueError, match="one CUDA device"):
        impact_score.fused_ceiling_index_topk(*_queries(), *base,
                                              n_docs=BASE_DOCS, k=k)
    with pytest.raises(ValueError, match="k must be >= 1"):
        impact_score.fused_ceiling_index_topk(*_queries(), *base,
                                              n_docs=BASE_DOCS, k=0)
