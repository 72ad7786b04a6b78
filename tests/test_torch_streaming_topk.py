"""``repro_torch.launch.steps.streaming_topk`` against the JAX package's
``launch.steps.streaming_topk`` and against K6's plain version (CPU).

The same numpy inputs go through both. Ids must be identical: ties to the
lowest id, and ``(-1e30, 0)`` past N when ``k > N``. Values agree to
rtol = atol = 1e-5 (the same f32 products, summed over D by two
libraries); on integer entries every sum is exact and they are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.steps import streaming_topk as jax_streaming_topk
from repro_torch.kernels._common import NEG_INF
from repro_torch.kernels.topk_score import topk_score_plain
from repro_torch.launch.steps import streaming_topk

TOL = 1e-5


def _normal(B, N, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, D)).astype(np.float32),
            rng.standard_normal((N, D)).astype(np.float32))


def _ints(B, N, D, seed, dup=None):
    """Entries in {-3..3}: every sum exact. ``dup=(dst, src, n)`` copies
    ``n`` candidate rows from ``src`` to ``dst`` (exact ties)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-3, 4, (B, D)).astype(np.float32)
    C = rng.integers(-3, 4, (N, D)).astype(np.float32)
    if dup is not None:
        dst, src, n = dup
        C[dst:dst + n] = C[src:src + n]
    return q, C, True


CASES = {  # name: (q, C, exact), k, tile
    "n_not_a_multiple_of_tile": ((*_normal(4, 37, 8, 0), False), 5, 16),
    "tile_past_n": ((*_normal(4, 20, 8, 1), False), 7, 64),
    "k_past_n": ((*_normal(3, 5, 8, 2), False), 8, 4),
    "k_past_n_many_tiles": ((*_normal(2, 13, 8, 3), False), 20, 4),
    "ties_duplicated_rows": (_ints(4, 96, 8, 4, dup=(60, 0, 24)), 12, 16),
    "ties_integer_entries": (_ints(5, 70, 3, 5), 30, 16),
    "bf16": ((*_normal(4, 50, 16, 6), False), 6, 16),
    "B1": ((*_normal(1, 300, 32, 7), False), 10, 64),
    "B4": ((*_normal(4, 300, 32, 8), False), 10, 64),
    "B64": ((*_normal(64, 300, 32, 9), False), 10, 64),
}


@pytest.mark.parametrize("name", list(CASES))
def test_streaming_topk_matches_jax(name):
    (q, C, exact), k, tile = CASES[name]
    if name == "bf16":
        qt, Ct = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, C))
        qj, Cj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, C))
    else:
        qt, Ct = torch.from_numpy(q), torch.from_numpy(C)
        qj, Cj = jnp.asarray(q), jnp.asarray(C)
    vals, idx = streaming_topk(qt, Ct, k=k, tile=tile)
    v_ref, i_ref = (np.asarray(a) for a in
                    jax_streaming_topk(qj, Cj, k=k, tile=tile))
    assert vals.dtype == torch.float32 and idx.dtype == torch.int32
    assert tuple(vals.shape) == tuple(idx.shape) == (q.shape[0], k)
    np.testing.assert_array_equal(idx.numpy(), i_ref)
    if exact:
        np.testing.assert_array_equal(vals.numpy(), v_ref)
    else:
        np.testing.assert_allclose(vals.numpy(), v_ref, rtol=TOL, atol=TOL)
    N = C.shape[0]
    if k > N:   # the initial carry wins every tie past the real rows
        assert (vals[:, N:] == NEG_INF).all() and (idx[:, N:] == 0).all()


def test_ties_go_to_the_lowest_id():
    q = torch.ones((2, 4))
    C = torch.zeros((40, 4))
    C[[3, 17, 33]] = 1.0            # three equal best scores, in 3 tiles
    vals, idx = streaming_topk(q, C, k=5, tile=8)
    assert idx[:, :3].tolist() == [[3, 17, 33]] * 2
    assert idx[:, 3:].tolist() == [[0, 1]] * 2   # then the zero rows


@pytest.mark.parametrize("B,N,D,k,tile", [
    (4, 37, 8, 5, 16), (1, 300, 32, 10, 64), (64, 300, 32, 10, 64),
    (3, 5, 8, 8, 4)])
def test_streaming_topk_matches_k6_plain(B, N, D, k, tile):
    q, C = (torch.from_numpy(a) for a in _normal(B, N, D, seed=B + N))
    vals, idx = streaming_topk(q, C, k=k, tile=tile)
    v_ref, i_ref = topk_score_plain(q, C, k=k)
    np.testing.assert_array_equal(idx.numpy(), i_ref.numpy())
    np.testing.assert_allclose(vals.numpy(), v_ref.numpy(), rtol=TOL,
                               atol=TOL)


def test_streaming_topk_takes_a_strided_c():
    """A strided view of C gives the bits its contiguous copy gives."""
    q, C = (torch.from_numpy(a) for a in _normal(3, 200, 16, seed=11))
    wide = torch.zeros((200, 32))
    wide[:, ::2] = C
    view = wide[:, ::2]
    assert not view.is_contiguous()
    got = streaming_topk(q, view, k=7, tile=64)
    want = streaming_topk(q, C, k=7, tile=64)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_vary_axes_raises_naming_the_roadmap_item():
    """``vary_axes`` (the JAX package's carry marking inside a shard_map)
    is taken and changes nothing: PyTorch has no varying-value types."""
    q, C = (torch.from_numpy(a) for a in _normal(2, 10, 4, seed=12))
    got = streaming_topk(q, C, k=3, vary_axes=("data", "model"))
    want = streaming_topk(q, C, k=3)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_tile_must_be_positive():
    q, C = (torch.from_numpy(a) for a in _normal(2, 10, 4, seed=13))
    with pytest.raises(ValueError, match="tile"):
        streaming_topk(q, C, k=3, tile=0)
