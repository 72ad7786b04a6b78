"""The port's K6 (its plain version, on the CPU) and its oracle against the
JAX package's Pallas kernel run by the interpreter and the JAX oracle, on
the same numpy inputs.

Ids must be identical (ties to the lowest candidate id); values agree to
1e-5 (f32 sums over D in another order: the Pallas kernel contracts each
candidate block on its own). Inputs with small integer entries make every
sum exact whatever its order, and there the values must match bit for
bit. The kernel's own argument checks, which need no card, run on meta
tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import topk_score_ref as jax_ref
from repro.kernels.topk_score import topk_score as jax_topk
from repro_torch.kernels._common import NEG_INF
from repro_torch.kernels.ref import topk_score_ref
from repro_torch.kernels.topk_score import topk_score

TOL = 1e-5


def _qc(B, N, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, D)).astype(np.float32),
            rng.standard_normal((N, D)).astype(np.float32))


def _port(q, C, k):
    v, i = topk_score(torch.from_numpy(q), torch.from_numpy(C), k=k)
    return v.numpy(), i.numpy()


def _pallas(q, C, k, bn):
    v, i = jax_topk(jnp.asarray(q), jnp.asarray(C), k=k, block_b=2,
                    block_n=bn, interpret=True)
    return np.asarray(v), np.asarray(i)


def _assert_same(port, ref, *, exact=False):
    np.testing.assert_array_equal(port[1], ref[1])
    np.testing.assert_allclose(port[0], ref[0], rtol=0 if exact else TOL,
                               atol=0 if exact else TOL)


@pytest.mark.parametrize("B,N,D,k,bn", [
    (1, 100, 16, 5, 32),
    (3, 500, 32, 10, 128),
    (8, 1024, 64, 100, 256),
    (2, 999, 8, 7, 128),       # N not a multiple of any tile
    (3, 301, 13, 9, 64),       # an odd D
])
def test_plain_k6_matches_pallas_kernel_and_oracle(B, N, D, k, bn):
    q, C = _qc(B, N, D)
    port = _port(q, C, k)
    _assert_same(port, _pallas(q, C, k, bn))
    _assert_same(port, tuple(np.asarray(a) for a in jax_ref(
        jnp.asarray(q), jnp.asarray(C), k)))
    assert port[0].dtype == np.float32 and port[1].dtype == np.int32


@pytest.mark.parametrize("seed", range(4))
def test_plain_k6_exact_on_small_integers(seed):
    """Entries in {-3..3}: every product and sum is an exact f32 integer,
    so values match bit for bit and many scores tie exactly."""
    rng = np.random.default_rng(seed)
    B, N, D = 4, int(rng.integers(20, 300)), int(rng.integers(1, 40))
    q = rng.integers(-3, 4, (B, D)).astype(np.float32)
    C = rng.integers(-3, 4, (N, D)).astype(np.float32)
    k = int(rng.integers(1, min(N, 60)))
    _assert_same(_port(q, C, k), _pallas(q, C, k, 32), exact=True)


def test_oracle_matches_jax_oracle():
    q, C = _qc(5, 200, 24, seed=1)
    for qq in (q, q[0]):
        v, i = topk_score_ref(torch.from_numpy(qq), torch.from_numpy(C), 11)
        jv, ji = jax_ref(jnp.asarray(qq), jnp.asarray(C), 11)
        assert v.shape == jv.shape
        _assert_same((v.numpy(), i.numpy()), (np.asarray(jv),
                                                np.asarray(ji)))


@pytest.mark.parametrize("N,k,bn", [
    (10, 10, 32),     # k == N
    (10, 16, 32),     # k > N: the tail is (NEG_INF, 0), the head the ranking
    (7, 12, 4),       # k > N with block_n < k and bn not dividing N
])
def test_k_at_or_above_n(N, k, bn):
    q, C = _qc(3, N, 8, seed=5)
    v, i = _port(q, C, k)
    jv, ji = _pallas(q, C, k, bn)
    _assert_same((v[:, :N], i[:, :N]), (jv[:, :N], ji[:, :N]))
    rv, ri = topk_score_ref(torch.from_numpy(q), torch.from_numpy(C), N)
    _assert_same((v[:, :N], i[:, :N]), (rv.numpy(), ri.numpy()))
    assert (v[:, N:] == NEG_INF).all() and (jv[:, N:] == NEG_INF).all()
    assert (i[:, N:] == 0).all()


def test_padded_tail_never_beats_real_negatives():
    """All real scores negative: a padded candidate (the Pallas kernel's
    rows past N score q.0 = 0) must never be selected."""
    rng = np.random.default_rng(3)
    B, N, D = 2, 700, 16
    q = (rng.uniform(size=(B, D)) + 0.5).astype(np.float32)
    C = -(rng.uniform(size=(N, D)) + 0.5).astype(np.float32)
    v, i = _port(q, C, 9)
    assert (v < 0).all() and (i >= 0).all() and (i < N).all()
    _assert_same((v, i), _pallas(q, C, 9, 256))


@pytest.mark.parametrize("bn", [32, 48])   # dividing and non-dividing
def test_duplicate_rows_tie_to_lowest_id(bn):
    B, N, D, k = 2, 96, 8, 12
    q, C = _qc(B, N, D, seed=11)
    C[60:84] = C[0:24]                      # a later block than the source
    v, i = _port(q, C, k)
    _assert_same((v, i), _pallas(q, C, k, bn))
    # a copy follows its source, the lower id, at the same value
    r, p = np.nonzero(np.isin(i, np.arange(60, 84)))
    assert r.size and (p > 0).all()
    np.testing.assert_array_equal(i[r, p - 1], i[r, p] - 60)
    np.testing.assert_array_equal(v[r, p - 1], v[r, p])


def test_every_row_identical_ranks_ascending_ids():
    C = np.ones((37, 5), np.float32)
    q = np.ones((2, 5), np.float32)
    v, i = _port(q, C, 8)
    np.testing.assert_array_equal(i, np.tile(np.arange(8), (2, 1)))
    assert (v == 5.0).all()


def test_empty_batch():
    q, C = _qc(0, 50, 6)
    v, i = _port(q, C, 4)
    assert v.shape == (0, 4) and i.shape == (0, 4)
    assert v.dtype == np.float32 and i.dtype == np.int32


def _meta(B, N, D):
    return (torch.empty((B, D), device="meta"),
            torch.empty((N, D), device="meta"))


def test_kernel_arguments_checked_without_a_card():
    """Tensors that are not on the CPU go to the kernel's wrapper, never to
    the plain version; its checks raise before anything is built. The
    kernel takes any k >= 0 (past the old limit of 256 too) and a bf16 or
    non-contiguous corpus (cast to f32 as the reference casts it): those
    pass the checks and reach the device check, which meta tensors fail."""
    q, C = _meta(4, 100, 8)
    with pytest.raises(ValueError, match="k must be >= 0"):
        topk_score(q, C, k=-1)
    with pytest.raises(ValueError, match=r"must be \(B, D\) and \(N, D\)"):
        topk_score(q, torch.empty((100, 9), device="meta"), k=3)
    for k in (0, 256, 257, 300, 5000):
        with pytest.raises(ValueError, match="one CUDA device"):
            topk_score(q, C, k=k)
    strided = torch.empty((8, 100), device="meta").T
    for corpus in (C.to(torch.bfloat16), strided):
        with pytest.raises(ValueError, match="one CUDA device"):
            topk_score(q, corpus, k=300)
    with pytest.raises(ValueError, match="one CUDA device"):
        topk_score(torch.zeros((4, 8)), C, k=3)


def test_plain_version_takes_any_k_on_the_cpu():
    q, C = _qc(2, 400, 4, seed=7)
    v, i = _port(q, C, 300)
    rv, ri = topk_score_ref(torch.from_numpy(q), torch.from_numpy(C), 300)
    _assert_same((v, i), (rv.numpy(), ri.numpy()))


@pytest.mark.parametrize("k", [257, 300, 999])
def test_plain_k6_past_256_matches_pallas_kernel(k):
    """Lists longer than the old kernel limit, merged over many candidate
    blocks: the ids of the Pallas kernel (which keeps them in its output
    block) and its values."""
    q, C = _qc(3, 1000, 12, seed=k)
    _assert_same(_port(q, C, k), _pallas(q, C, k, 128))


@pytest.mark.parametrize("layout", ["bf16", "strided", "strided_bf16"])
def test_plain_k6_casts_the_corpus_as_jax(layout):
    """A bf16 corpus is cast to f32 (the reference's ``astype``); a
    non-contiguous one is read as its values: both give the reference's
    ids and values on the same numbers."""
    q, C = _qc(4, 700, 24, seed=11)
    Ct = torch.from_numpy(C)
    if "bf16" in layout:
        Ct = Ct.to(torch.bfloat16)
    if "strided" in layout:
        Ct = Ct.T.contiguous().T
        assert not Ct.is_contiguous()
    v, i = topk_score(torch.from_numpy(q), Ct, k=20)
    ref = _pallas(q, Ct.float().numpy(), 20, 128)
    _assert_same((v.numpy(), i.numpy()), ref)
