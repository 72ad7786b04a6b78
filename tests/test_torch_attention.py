"""The port's ``chunked_attention`` and ``decode_attention`` against the
JAX package's, on the same numpy inputs (CPU).

Tolerances: f32 rtol = atol = 1e-4 (the same products and softmax summed
in another order by another library). bf16 inputs as
``test_torch_encoder.py`` states them: both sides round the scaled query
and the probabilities to bf16 and the output from f32 sums, at the same
places, so single outputs land a bf16 ulp or so apart: atol 0.1 on
outputs of magnitude up to ~3, with a mean-error bound of 0.02 that a
wrong mask or chunk order would break.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.models import attention as attn

TOL = {"float32": dict(rtol=1e-4, atol=1e-4, mean=1e-5),
       "bfloat16": dict(rtol=0.0, atol=0.1, mean=0.02)}
B, H, DH, CHUNK = 3, 4, 16, 8


def _close(got: torch.Tensor, want, dtype: str) -> None:
    tol = TOL[dtype]
    ref = np.asarray(want, np.float32)
    out = got.float().numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=tol["rtol"], atol=tol["atol"])
    assert np.abs(out - ref).mean() <= tol["mean"]


def _qkv(S, KV, dtype, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, DH)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, DH)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, DH)).astype(np.float32)
    mask = np.ones((B, S), np.int32)
    mask[1, S * 2 // 3:] = 0        # a padded row
    mask[2] = 0                     # an all-masked row
    if dtype == "bfloat16":        # the same bf16 values on both sides
        q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (q, k, v))
    return q, k, v, mask


def _torch(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))


# name: (S, causal, window, softcap, KV heads); chunks of 8 keys
CASES = {
    "one_chunk": (5, False, None, None, 4),
    "exactly_one_chunk_causal": (8, True, None, None, 4),
    "two_chunks_causal_gqa": (16, True, None, None, 2),
    "three_chunks_short_last_causal_mqa": (20, True, None, None, 1),
    "three_chunks_bidirectional": (20, False, None, None, 4),
    "window_causal": (20, True, 6, None, 2),
    "window_bidirectional": (20, False, 6, None, 2),
    "softcap": (20, True, None, 5.0, 2),
    "window_softcap_mqa": (24, True, 6, 5.0, 1),
}


def _run_both(case, dtype, seed=0):
    S, causal, window, cap, KV = CASES[case]
    q, k, v, mask = _qkv(S, KV, dtype, seed)
    pos = np.arange(S, dtype=np.int32)
    jd = getattr(jnp, dtype)
    want = jattn.chunked_attention(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
        q_positions=jnp.asarray(pos), k_positions=jnp.asarray(pos),
        kv_mask=jnp.asarray(mask), causal=causal, window=window,
        logit_softcap=cap, chunk_size=CHUNK)
    got = attn.chunked_attention(
        _torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
        q_positions=torch.from_numpy(pos), k_positions=torch.from_numpy(pos),
        kv_mask=torch.from_numpy(mask), causal=causal, window=window,
        logit_softcap=cap, chunk_size=CHUNK)
    return got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_chunked_attention_matches_jax(case, dtype):
    got, want = _run_both(case, dtype)
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == want.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("case", ["three_chunks_short_last_causal_mqa",
                                  "window_softcap_mqa"])
def test_query_blocks_give_the_same_numbers(case, monkeypatch):
    """Queries taken 3 at a time (the scores of 3 query rows against one
    chunk in ``SCORE_BYTES``) see the same chunk updates in the same
    order as all at once."""
    whole, want = _run_both(case, "float32", seed=1)
    monkeypatch.setattr(attn, "SCORE_BYTES", 4 * B * H * CHUNK * 3)
    blocked, _ = _run_both(case, "float32", seed=1)
    torch.testing.assert_close(blocked, whole, rtol=1e-6, atol=1e-6)
    _close(blocked, want, "float32")


def test_all_masked_row_averages_its_keys_as_jax_does():
    """A row with no valid key averages every (padded) key evenly, as the
    JAX package does: finite, not NaN."""
    got, want = _run_both("three_chunks_bidirectional", "float32", seed=2)
    assert torch.isfinite(got[2]).all()
    _close(got[2], np.asarray(want)[2], "float32")


def test_one_chunk_is_the_plain_softmax():
    """At one chunk the online softmax is the plain one: the encoders'
    numbers at S <= attn_chunk."""
    S, KV = 12, 2
    q, k, v, mask = _qkv(S, KV, "float32", 3)
    pos = torch.arange(S)
    got = attn.chunked_attention(
        *(_torch(a, "float32") for a in (q, k, v)), q_positions=pos,
        k_positions=pos, kv_mask=torch.from_numpy(mask), causal=False,
        chunk_size=512)
    kk = torch.from_numpy(k).repeat_interleave(H // KV, dim=2)
    vv = torch.from_numpy(v).repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", torch.from_numpy(q) * DH ** -0.5, kk)
    s = s.masked_fill(~torch.from_numpy(mask).bool()[:, None, None], -1e30)
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vv)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# name: (S_max, positions of the 3 rows, window, softcap, KV heads)
DECODE_CASES = {
    "full": (12, (0, 5, 11), None, None, 4),
    "gqa": (12, (3, 7, 11), None, None, 2),
    "window": (20, (2, 9, 19), 4, None, 2),
    "softcap_mqa": (12, (0, 6, 11), None, 5.0, 1),
    "window_softcap": (20, (15, 16, 19), 16, 50.0, 2),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_attention_matches_jax(case, dtype, monkeypatch):
    S_max, positions, window, cap, KV = DECODE_CASES[case]
    monkeypatch.setattr(attn, "DECODE_CHUNK", 8)   # 2-3 cache chunks
    rng = np.random.default_rng(4)
    q = rng.standard_normal((B, 1, H, DH)).astype(np.float32)
    kc = rng.standard_normal((B, S_max, KV, DH)).astype(np.float32)
    vc = rng.standard_normal((B, S_max, KV, DH)).astype(np.float32)
    pos = np.asarray(positions, np.int32)
    jd = getattr(jnp, dtype)
    want = jattn.decode_attention(
        jnp.asarray(q, jd), jnp.asarray(kc, jd), jnp.asarray(vc, jd),
        positions=jnp.asarray(pos), window=window, logit_softcap=cap)
    if dtype == "bfloat16":
        q, kc, vc = (np.asarray(jnp.asarray(a, jd).astype(jnp.float32))
                     for a in (q, kc, vc))
    kt, vt = _torch(kc, dtype), _torch(vc, dtype)
    k_before = kt.clone()
    got = attn.decode_attention(_torch(q, dtype), kt, vt,
                                positions=torch.from_numpy(pos),
                                window=window, logit_softcap=cap)
    assert got.shape == (B, 1, H, DH) and got.dtype == kt.dtype
    assert torch.equal(kt, k_before)        # the cache is read, not cast
    _close(got, want, dtype)
