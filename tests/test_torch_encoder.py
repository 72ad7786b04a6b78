"""The port's encoder trunk against the JAX package's, with the JAX
weights carried over by ``weights.params_from_jax`` (CPU).

Tolerances: at f32 compute, rtol = atol = 1e-4 (matmuls, softmax and
norms summed in another order by another library, through two layers).
At bf16 compute both sides round every matmul output and residual to
bf16, but at different places inside fused ops, so single elements land
a few bf16 ulps apart (0.047 at most, 0.006 on average, measured):
atol = 0.1 on hidden states of magnitude up to ~4, plus a mean-error
bound of 0.02 that a wrong layer would break.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.splade_bert import SMOKE as JAX_SMOKE
from repro.models import transformer as jtfm
from repro_torch.configs.splade_bert import SMOKE
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import apply_rope
from repro_torch.weights import params_from_jax


def _tokens(B=3, S=20, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, SMOKE.vocab_size, size=(B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 13:] = 0                     # padded rows
    mask[2, 5:] = 0
    return toks, mask


def _both(compute_dtype):
    cfg_j = dataclasses.replace(JAX_SMOKE, compute_dtype=compute_dtype)
    cfg_t = dataclasses.replace(SMOKE, compute_dtype=compute_dtype)
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
    assert H_t.dtype == getattr(torch, compute_dtype)
    ref = np.asarray(H_j, np.float32)
    got = H_t.float().numpy()
    rtol = 1e-4 if compute_dtype == "float32" else 0.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)
    assert np.abs(got - ref).mean() <= mean_tol


def test_lsr_encode_matches_jax_f32():
    cfg_j, params_j, cfg_t, params_t = _both("float32")
    toks, mask = _tokens(seed=1)
    y_j, _ = jtfm.lsr_encode(params_j, cfg_j, jnp.asarray(toks),
                             jnp.asarray(mask))
    for impl in ("sparton", "kernel"):
        y_t = tfm.lsr_encode(params_t, cfg_t, torch.from_numpy(toks),
                             torch.from_numpy(mask), head_impl=impl)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-4,
                                   atol=1e-4)


def test_rope_matches_jax():
    from repro.models.attention import apply_rope as jax_rope

    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7))
    np.testing.assert_allclose(
        apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                   1e4).numpy(),
        np.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)),
        rtol=1e-5, atol=1e-5)


def test_params_from_jax_checks_the_tree():
    _, params_j, cfg_t, _ = _both("float32")
    tree = jax.tree.map(np.asarray, params_j)
    tree["layers"]["attn"]["wq"] = tree["layers"]["attn"]["wq"][:, :, :8]
    with pytest.raises(ValueError, match="wq"):
        params_from_jax(tree, cfg_t, "cpu")
    del tree["final_norm"]
    with pytest.raises(ValueError, match="final_norm"):
        params_from_jax(tree, cfg_t, "cpu")


@pytest.mark.parametrize("tie", [True, False])
def test_compute_weights_cast_once_changes_no_number(tie):
    """Weights cast to bf16 up front give bit-identical hidden states to
    f32 weights cast at each call; norm scales and the bias stay f32."""
    cfg = dataclasses.replace(SMOKE, compute_dtype="bfloat16",
                              tie_embeddings=tie)
    params = tfm.init_params(torch.Generator().manual_seed(5), cfg)
    cast = tfm.compute_weights(params, cfg)
    E, b = tfm.head_weights(cast, cfg)
    assert E.dtype == cast["layers"]["mlp"]["w_up"].dtype == torch.bfloat16
    assert b.dtype == cast["layers"]["ln1"].dtype == torch.float32
    toks, mask = (torch.from_numpy(a) for a in _tokens(seed=3))
    assert torch.equal(tfm.forward_hidden(cast, cfg, toks, mask),
                       tfm.forward_hidden(params, cfg, toks, mask))


def test_init_params_is_seeded_and_shaped():
    a = tfm.init_params(torch.Generator().manual_seed(3), SMOKE)
    b = tfm.init_params(torch.Generator().manual_seed(3), SMOKE)
    assert torch.equal(a["layers"]["mlp"]["w_up"], b["layers"]["mlp"]["w_up"])
    assert a["embed"].shape == (SMOKE.vocab_size, SMOKE.d_model)
    assert a["layers"]["attn"]["wq"].shape == (
        SMOKE.n_layers, SMOKE.d_model, SMOKE.n_heads * SMOKE.d_head)
    # the same tree layout as the JAX package: it round-trips
    params_from_jax(jax.tree.map(lambda t: t.numpy(), a), SMOKE, "cpu")
