"""The slice as a whole: the port's config encoder, serving loop and
serve entry point against the JAX package (CPU).

The JAX ``make_config_encoder`` and the port's run the same carried
weights on the same tokens at f32 compute. Dense head outputs agree to
rtol = atol = 2e-4 (the trunk's f32 differences, 1e-4 at most, pass
through the head's max and log1p). Sparse reps hold the same ids except
where two candidates for the last slots are within that tolerance of
each other (a near-tie the two sums may order either way).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.splade_bert import SMOKE as JAX_SMOKE
from repro.models import transformer as jtfm
from repro.runtime.serving import make_config_encoder as jax_encoder
from repro_torch.configs.splade_bert import SMOKE
from repro_torch.retrieval.sparse_rep import SparseRep
from repro_torch.runtime.serving import (BatchedEncoder, BatchPolicy,
                                         FailedResult, Request, ServingLoop,
                                         make_config_encoder)
from repro_torch.weights import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-4
REP_TOPK = 16


def _pair(**overrides):
    cfg_j = dataclasses.replace(JAX_SMOKE, compute_dtype="float32",
                                **overrides)
    cfg_t = dataclasses.replace(SMOKE, compute_dtype="float32",
                                **overrides)
    params_j = jtfm.init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t,
                               "cpu")
    return cfg_j, params_j, cfg_t, params_t


def _batch(seed=0, B=6, S=24):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, SMOKE.vocab_size, size=(B, S)).astype(np.int32)
    mask = np.zeros((B, S), np.int32)
    for r, n in enumerate(rng.integers(4, S + 1, size=B)):
        mask[r, :n] = 1
    return toks, mask


def test_dense_encoder_matches_jax():
    cfg_j, params_j, cfg_t, params_t = _pair()
    toks, mask = _batch()
    y_j = jax_encoder(params_j, cfg_j)(jnp.asarray(toks), jnp.asarray(mask))
    for impl in ("sparton", "kernel"):
        spec = cfg_t.head_spec(impl=impl)
        y_t = make_config_encoder(params_t, cfg_t, spec=spec)(
            torch.from_numpy(toks), torch.from_numpy(mask))
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=TOL,
                                   atol=TOL)


def test_sparse_encoder_reps_match_jax_up_to_near_ties():
    cfg_j, params_j, cfg_t, params_t = _pair(rep_topk=REP_TOPK)
    toks, mask = _batch(seed=1)
    rep_j = jax_encoder(params_j, cfg_j)(jnp.asarray(toks),
                                         jnp.asarray(mask))
    dense_j = np.asarray(jax_encoder(params_j, dataclasses.replace(
        cfg_j, rep_topk=None))(jnp.asarray(toks), jnp.asarray(mask)))
    rep_t = make_config_encoder(params_t, cfg_t,
                                spec=cfg_t.head_spec(impl="kernel"))(
        torch.from_numpy(toks), torch.from_numpy(mask))
    assert isinstance(rep_t, SparseRep) and rep_t.width == REP_TOPK
    vals_j, ids_j = np.asarray(rep_j.values), np.asarray(rep_j.indices)
    np.testing.assert_allclose(rep_t.values.numpy(), vals_j, rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(rep_t.nnz.numpy(), np.asarray(rep_j.nnz))
    for r in range(ids_j.shape[0]):
        kth = vals_j[r, -1]
        for v in set(rep_t.indices[r].tolist()) ^ set(ids_j[r].tolist()):
            assert abs(dense_j[r, v] - kth) <= TOL * (1 + kth), (r, v)


def _loop(encode=None, **policy):
    if encode is None:
        from repro_torch.models.transformer import init_params

        cfg = dataclasses.replace(SMOKE, head_impl="kernel", rep_topk=8)
        params = init_params(torch.Generator().manual_seed(0), cfg)
        encode = make_config_encoder(params, cfg)
    return ServingLoop(BatchedEncoder(encode, policy=BatchPolicy(**policy)))


def test_serving_loop_completes_every_uid_once_and_take_pops():
    loop = _loop(max_batch=4, max_wait_s=0.0)
    rng = np.random.default_rng(2)
    for uid in range(10):
        loop.submit(Request(uid=uid, tokens=rng.integers(
            1, SMOKE.vocab_size, size=int(rng.integers(4, 24)))
            .astype(np.int32)))
        loop.tick()
    loop.drain()
    assert sorted(loop.completed) == list(range(10))
    reps = [loop.take(uid) for uid in range(10)]
    assert all(isinstance(r, SparseRep) and r.width == 8 for r in reps)
    assert not loop.completed
    with pytest.raises(KeyError):
        loop.take(3)
    assert loop.stats()["served"] == 10 and sum(loop.batch_sizes) == 10


def test_serving_loop_isolates_a_poison_request():
    def encode(tokens, mask):
        if (tokens == 7).any():
            raise RuntimeError("poison")
        return torch.zeros((tokens.shape[0], 5))

    loop = _loop(encode, max_batch=8)
    for uid in range(6):
        toks = np.full(5, 7 if uid == 4 else 3, np.int32)
        loop.submit(Request(uid=uid, tokens=toks))
    loop.drain()
    out = {uid: loop.take(uid) for uid in range(6)}
    assert isinstance(out[4], FailedResult)
    assert all(out[u].shape == (5,) for u in range(6) if u != 4)


def _serve(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--corpus", "64",
         "--requests", "8", "--method", "fused", *args],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)


def test_serve_cli_runs_on_cpu():
    proc = _serve("--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert "encoded 8/8 requests" in proc.stdout
    assert "retrieval[fused]" in proc.stdout


def test_serve_cli_without_cuda_fails_naming_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = _serve()
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr


def test_resolve_device_defaults_to_cuda_and_never_falls_back():
    from repro_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        for dev in (None, "cuda"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                resolve_device(dev)
