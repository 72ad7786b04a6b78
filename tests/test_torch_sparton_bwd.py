"""The port's Sparton head backward (``bwd_factor``, the plain versions of
K2 and K3, the oracles, the autograd of ``ops.sparton_head`` and
``lm_head.lm_head_sparton``) against the JAX package on the same numpy
inputs, on the CPU.

The JAX Pallas backward does not run on this JAX version, so the port is
held against the pure-jnp oracle ``kernels/ref.sparton_backward_fused_ref``
and ``jax.grad`` through the custom-VJP ``core/lm_head.lm_head_sparton``
(the paper's Alg. 3). Tolerances:

* ``bwd_factor``: rtol 1e-6 (the same f32 formula; exp/expm1 of two
  libraries may differ in the last ulp).
* K2/K3 plain versions and the oracles: rtol 1e-5 with atol 1e-5 times
  the largest |value| (f32 sums over V or B in another order). Both sides
  are fed the same ``(y, i_max)``, so near-ties cannot split them.
* Autograd of the whole head, f32: rtol 1e-5, atol 1e-5 times the
  largest |gradient|. bf16 inputs: gradients come back in bf16, and an
  f32 value a hair either side of a rounding boundary lands one bf16 ulp
  away: rtol 2**-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.lm_head import lm_head_sparton as jax_sparton
from repro.kernels._common import bwd_factor as jax_bwd_factor
from repro.kernels.ref import sparton_backward_fused_ref as jax_fused_ref
from repro.kernels.ref import sparton_forward_ref as jax_fwd_ref
from repro_torch.core import head_api, lm_head
from repro_torch.kernels import sparton_bwd
from repro_torch.kernels._common import bwd_factor
from repro_torch.kernels.ops import sparton_head
from repro_torch.kernels.ref import sparton_backward_fused_ref

SHAPES = [  # (B, S, D, V): the sweep of tests/test_kernels_sparton.py
    (1, 16, 8, 16),
    (4, 96, 64, 200),
    (3, 33, 24, 100),     # non-divisible everything
    (8, 128, 128, 256),
    (2, 256, 32, 512),
]
CAPS = [None, 5.0]
DTYPES = ["float32", "bfloat16"]


def _inputs(B, S, D, V, dtype="float32", seed=0, mask_p=0.2):
    """H, E, b, mask, dy with a fully masked row (y = 0, i_max = 0), a
    block of vocab columns whose bias keeps them at y = 0, and one
    position that wins the max for many columns (a shared i_max)."""
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((B, S, D)).astype(np.float32)
    H[0, min(1, S - 1)] *= 20.0
    E = (rng.standard_normal((V, D)) * 0.2).astype(np.float32)
    if dtype == "bfloat16":      # bf16 values, carried as f32 numbers
        H = torch.from_numpy(H).bfloat16().float().numpy()
        E = torch.from_numpy(E).bfloat16().float().numpy()
    b = (rng.standard_normal(V) * 0.2).astype(np.float32)
    b[:max(1, V // 8)] = -100.0
    mask = (rng.random((B, S)) > mask_p).astype(np.int32)
    mask[:, 0] = 1
    if B > 1:
        mask[-1] = 0
    dy = rng.standard_normal((B, V)).astype(np.float32)
    return H, E, b, mask, dy


def _close(got, ref, rtol=1e-5, scale_tol=1e-5):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    atol = scale_tol * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


def _torch(x, dtype="float32"):
    t = torch.from_numpy(np.array(x))
    return t.to(getattr(torch, dtype)) if t.is_floating_point() else t


@pytest.mark.parametrize("softcap", CAPS)
def test_bwd_factor_matches_jax(softcap):
    rng = np.random.default_rng(1)
    y = np.abs(rng.standard_normal((6, 50))).astype(np.float32) * 3
    y[:, :10] = 0.0                      # zero reps give g = 0
    dy = rng.standard_normal((6, 50)).astype(np.float32)
    got = bwd_factor(_torch(y), _torch(dy), softcap)
    ref = jax_bwd_factor(jnp.asarray(y), jnp.asarray(dy), softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)
    assert (got[:, :10] == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("softcap", CAPS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_k2_k3_match_fused_oracle(shape, softcap, dtype):
    H, E, b, mask, dy = _inputs(*shape, dtype=dtype)
    y, i_max = jax_fwd_ref(*(jnp.asarray(a) for a in (H, E, b, mask)),
                           softcap)
    y, i_max = np.asarray(y), np.asarray(i_max)
    dH_j, dE_j, db_j = jax_fused_ref(*(jnp.asarray(a) for a in (
        dy, y, i_max, H, E)), softcap)
    Ht, Et = _torch(H, dtype), _torch(E, dtype)
    dyt, yt, it = _torch(dy), _torch(y), _torch(i_max)
    dH = sparton_bwd.sparton_backward_dh(dyt, yt, it, Et, shape[1],
                                         softcap=softcap)
    dE, db = sparton_bwd.sparton_backward_de(dyt, yt, it, Ht,
                                             softcap=softcap)
    assert dH.dtype == dE.dtype == db.dtype == torch.float32
    assert dH.shape == shape[:3] and dE.shape == (shape[3], shape[2])
    _close(dH.numpy(), dH_j)
    _close(dE.numpy(), dE_j)
    _close(db.numpy(), db_j)
    if shape[0] > 1:                     # the fully masked row: no grad
        assert (dH[-1] == 0).all()


@pytest.mark.parametrize("softcap", CAPS)
@pytest.mark.parametrize("S", [1729, 2048])
def test_plain_k2_past_one_accumulator_matches_jax_oracle(S, softcap):
    """Sequences longer than the 1728 positions that the first K2 design's
    accumulator held (the card's gates run K2 there too): the plain K2 and
    K3 against the JAX oracle, at the tolerance above."""
    H, E, b, mask, dy = _inputs(3, S, 8, 64, seed=S)
    H[1, S - 1] *= 20.0                  # the last row wins many columns
    mask[1, S - 1] = 1
    y, i_max = jax_fwd_ref(*(jnp.asarray(a) for a in (H, E, b, mask)),
                           softcap)
    y, i_max = np.asarray(y), np.asarray(i_max)
    assert (i_max[1] == S - 1).sum() > 8
    dH_j, dE_j, db_j = jax_fused_ref(*(jnp.asarray(a) for a in (
        dy, y, i_max, H, E)), softcap)
    dyt, yt, it = _torch(dy), _torch(y), _torch(i_max)
    dH = sparton_bwd.sparton_backward_dh(dyt, yt, it, _torch(E), S,
                                         softcap=softcap)
    dE, db = sparton_bwd.sparton_backward_de(dyt, yt, it, _torch(H),
                                             softcap=softcap)
    _close(dH.numpy(), dH_j)
    _close(dE.numpy(), dE_j)
    _close(db.numpy(), db_j)


ROUTINGS = ["sparse", "skewed", "one_position", "empty_buckets"]
ROUTING_SHAPES = [(3, 40, 24, 600), (2, 33, 13, 300)]
SPARSE_KEEP = 256


def _reroute(y, i_max, S, kind, seed):
    """The routings the card's kernels are gated on: "sparse" keeps each
    row's SPARSE_KEEP largest y (a trained SPLADE rep), "skewed" routes a
    random half of each row's terms to position 0, "one_position" every
    term to S // 2, "empty_buckets" every term to an even position."""
    y, i_max = y.copy(), i_max.copy()
    if kind == "sparse":
        drop = np.argsort(-y, axis=1, kind="stable")[:, SPARSE_KEEP:]
        np.put_along_axis(y, drop, 0.0, axis=1)
    elif kind == "skewed":
        half = np.random.default_rng(seed).random(y.shape) < 0.5
        i_max[half] = 0
    elif kind == "one_position":
        i_max[:] = S // 2
    elif kind == "empty_buckets":
        i_max = i_max // 2 * 2
    return y, i_max


@pytest.mark.parametrize("softcap", CAPS)
@pytest.mark.parametrize("kind", ROUTINGS)
@pytest.mark.parametrize("shape", ROUTING_SHAPES, ids=str)
def test_plain_k2_k3_match_fused_oracle_on_routings(shape, kind, softcap):
    """The plain K2/K3 against the JAX oracle where the routing is far from
    uniform: 256 nonzero terms a row, half of a row's terms at one
    position, every term at one position, positions that get no term. The
    tolerance of the module docstring."""
    H, E, b, mask, dy = _inputs(*shape, seed=11)
    y, i_max = jax_fwd_ref(*(jnp.asarray(a) for a in (H, E, b, mask)),
                           softcap)
    y, i_max = _reroute(np.asarray(y), np.asarray(i_max), shape[1], kind,
                        seed=12)
    if kind == "sparse":
        assert ((y > 0).sum(axis=1) <= SPARSE_KEEP).all()
    dH_j, dE_j, db_j = jax_fused_ref(*(jnp.asarray(a) for a in (
        dy, y, i_max, H, E)), softcap)
    dyt, yt, it = _torch(dy), _torch(y), _torch(i_max)
    dH = sparton_bwd.sparton_backward_dh(dyt, yt, it, _torch(E), shape[1],
                                         softcap=softcap)
    dE, db = sparton_bwd.sparton_backward_de(dyt, yt, it, _torch(H),
                                             softcap=softcap)
    _close(dH.numpy(), dH_j)
    _close(dE.numpy(), dE_j)
    _close(db.numpy(), db_j)
    if kind == "empty_buckets":
        assert (dH[:, 1::2] == 0).all()
    if kind == "one_position":
        assert (np.delete(dH.numpy(), shape[1] // 2, axis=1) == 0).all()


@pytest.mark.parametrize("softcap", CAPS)
def test_port_oracle_matches_jax_oracle(softcap):
    H, E, b, mask, dy = _inputs(3, 33, 24, 100, seed=2)
    y, i_max = jax_fwd_ref(*(jnp.asarray(a) for a in (H, E, b, mask)),
                           softcap)
    y, i_max = np.asarray(y), np.asarray(i_max)
    ref = jax_fused_ref(*(jnp.asarray(a) for a in (dy, y, i_max, H, E)),
                        softcap)
    got = sparton_backward_fused_ref(*(_torch(a) for a in (
        dy, y, i_max, H, E)), softcap)
    for g, r in zip(got, ref):
        _close(g.numpy(), r)


def test_backward_and_batch_chunks_agree():
    """The plain versions give the same sums for any batch chunk."""
    H, E, b, mask, dy = _inputs(5, 20, 16, 64, seed=3)
    y, i_max = jax_fwd_ref(*(jnp.asarray(a) for a in (H, E, b, mask)))
    args = [_torch(dy), _torch(np.asarray(y)), _torch(np.asarray(i_max))]
    ref_h = sparton_bwd.sparton_backward_dh_plain(*args, _torch(E), 20)
    ref_e = sparton_bwd.sparton_backward_de_plain(*args, _torch(H))
    for chunk in (1, 2, 5, 64):
        dH = sparton_bwd.sparton_backward_dh_plain(
            *args, _torch(E), 20, bwd_batch_chunk=chunk)
        dE, db = sparton_bwd.sparton_backward_de_plain(
            *args, _torch(H), bwd_batch_chunk=chunk)
        _close(dH.numpy(), ref_h.numpy())
        _close(dE.numpy(), ref_e[0].numpy())
        _close(db.numpy(), ref_e[1].numpy())


def _jax_grads(H, E, b, mask, w, softcap):
    def loss(H, E, b):
        y = jax_sparton(H, E, b, mask, logit_softcap=softcap)
        return jnp.sum(y.astype(jnp.float32) * w)
    return jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(H), jnp.asarray(E), jnp.asarray(b))


def _torch_grads(head, H, E, b, mask, w, softcap, dtype):
    Ht = _torch(H, dtype).requires_grad_(True)
    Et = _torch(E, dtype).requires_grad_(True)
    bt = _torch(b).requires_grad_(True)
    y = head(Ht, Et, bt, _torch(mask), logit_softcap=softcap)
    (y.float() * _torch(w)).sum().backward()
    return Ht.grad, Et.grad, bt.grad


HEADS = {"kernel": sparton_head, "sparton": lm_head.lm_head_sparton}


@pytest.mark.parametrize("softcap", CAPS)
@pytest.mark.parametrize("impl", sorted(HEADS))
def test_head_grads_match_jax_grad_f32(impl, softcap):
    H, E, b, mask, w = _inputs(4, 24, 16, 96, seed=5)
    ref = _jax_grads(H, E, b, mask, w, softcap)
    got = _torch_grads(HEADS[impl], H, E, b, mask, w, softcap, "float32")
    for g, r, name in zip(got, ref, ("dH", "dE", "db")):
        assert g.dtype == torch.float32, name
        _close(g.numpy(), r)


@pytest.mark.parametrize("impl", sorted(HEADS))
def test_head_grads_match_jax_grad_bf16(impl):
    H, E, b, mask, w = _inputs(3, 20, 16, 64, dtype="bfloat16", seed=6)
    Hj, Ej = (jnp.asarray(a, jnp.bfloat16) for a in (H, E))
    ref = _jax_grads(Hj, Ej, b, mask, w, None)
    got = _torch_grads(HEADS[impl], H, E, b, mask, w, None, "bfloat16")
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    assert got[2].dtype == torch.float32
    for g, r in zip(got, ref):
        _close(g.float().numpy(), np.asarray(r, np.float32), rtol=2**-7,
               scale_tol=2**-7)


def test_kernel_head_saves_only_inputs_and_y_imax():
    """The autograd node keeps (H, E, y, i_max): nothing of size B·S·V."""
    B, S, D, V = 2, 16, 8, 40
    H, E, b, mask, _ = _inputs(B, S, D, V)
    Ht = _torch(H).requires_grad_(True)
    y = sparton_head(Ht, _torch(E), _torch(b), _torch(mask))
    shapes = sorted(tuple(t.shape) for t in y.grad_fn.saved_tensors)
    assert shapes == sorted([(B, S, D), (V, D), (B, V), (B, V)])


@pytest.mark.parametrize("impl", ["naive", "tiled", "sparton", "kernel"])
def test_every_registered_impl_is_differentiable(impl):
    H, E, b, mask, w = _inputs(2, 12, 8, 32, seed=7)
    ref = _jax_grads(H, E, b, mask, w, None)
    head = head_api.make_head(head_api.HeadSpec(impl=impl))
    Ht = _torch(H).requires_grad_(True)
    Et = _torch(E).requires_grad_(True)
    (head(Ht, Et, _torch(b), _torch(mask)) * _torch(w)).sum().backward()
    _close(Ht.grad.numpy(), ref[0])
    _close(Et.grad.numpy(), ref[1])


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    H, E, b, mask, dy = _inputs(2, 16, 8, 16)
    y, i_max = jax_fwd_ref(*(jnp.asarray(a) for a in (H, E, b, mask)))
    before = (sparton_bwd.sparton_backward_dh.launches,
              sparton_bwd.sparton_backward_de.launches)
    sparton_bwd.sparton_backward(_torch(dy), _torch(np.asarray(y)),
                                 _torch(np.asarray(i_max)), _torch(H),
                                 _torch(E))
    assert (sparton_bwd.sparton_backward_dh.launches,
            sparton_bwd.sparton_backward_de.launches) == before


def test_non_cpu_non_cuda_tensors_raise_instead_of_falling_back():
    """Tensors that are not all on one CUDA device (or all on meta, the
    dry run's empty outputs) raise: a CPU weight beside meta cotangents
    takes neither the kernel nor the plain version."""
    dy = torch.zeros((2, 16), device="meta")
    i_max = torch.zeros((2, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        sparton_bwd.sparton_backward_dh(dy, dy, i_max, torch.zeros((16, 8)),
                                        4)
    with pytest.raises(ValueError, match="CUDA device"):
        sparton_bwd.sparton_backward_de(dy, dy, i_max,
                                        torch.zeros((2, 4, 8)))


@pytest.mark.parametrize("B,S", [(2, 2048), (65536, 4), (65536, 2048),
                                 (384, 256), (1, 70000)])
def test_kernel_arguments_checked_without_a_card(B, S):
    """K2 and K3 take any S and any B: those shapes pass the wrappers'
    checks and reach the device check, where meta tensors get the
    kernels' empty outputs and launch nothing; an empty one does not
    pass."""
    dy = torch.empty((B, 16), device="meta")
    i_max = torch.empty((B, 16), dtype=torch.int32, device="meta")
    E = torch.empty((16, 8), device="meta")
    before = (sparton_bwd.sparton_backward_dh.launches,
              sparton_bwd.sparton_backward_de.launches)
    dH = sparton_bwd.sparton_backward_dh(dy, dy, i_max, E, S)
    assert dH.is_meta and tuple(dH.shape) == (B, S, 8)
    dE, db = sparton_bwd.sparton_backward_de(
        dy, dy, i_max, torch.empty((B, S, 8), device="meta"))
    assert (tuple(dE.shape), tuple(db.shape)) == ((16, 8), (16,))
    assert dE.dtype == db.dtype == dH.dtype == torch.float32
    assert (sparton_bwd.sparton_backward_dh.launches,
            sparton_bwd.sparton_backward_de.launches) == before
    with pytest.raises(ValueError, match="outside the kernel's range"):
        sparton_bwd.sparton_backward_dh(dy, dy, i_max, E, 0)


@pytest.mark.parametrize("B,S,V", [(384, 256, 30522), (1, 1, 1),
                                   (65536, 8, 64)])
def test_dh_scratch_is_one_offset_row_and_one_entry_list_per_batch_row(
        B, S, V):
    """K2's routing scratch: bucket offsets (B, S + 1) and (v, g) entries
    (B, V, 2), i32; g (B, V), f32; room for a count, a pad and a (b, s)
    pair for every bucket that can hold a term (B * min(S, V)), i32; all
    on the device asked for (meta here)."""
    ofs, lists, gs, heavy = sparton_bwd.dh_scratch(B, S, V,
                                                   torch.device("meta"))
    assert ofs.shape == (B, S + 1) and lists.shape == (B, V, 2)
    assert gs.shape == (B, V)
    assert heavy.shape == (2 + 2 * B * min(S, V),)
    assert ofs.dtype == lists.dtype == heavy.dtype == torch.int32
    assert gs.dtype == torch.float32
    assert {t.device.type for t in (ofs, lists, gs, heavy)} == {"meta"}
