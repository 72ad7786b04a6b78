"""The port's Sparton head (K1's plain version, the lm_head ladder, the
head API) against the JAX package on the same numpy inputs, on the CPU.

The JAX side is the pure-jnp oracle ``kernels/ref.sparton_forward_ref``
and the ``core/lm_head`` ladder: the Pallas head itself does not run on
this JAX version. Tolerances:

* f32: y to rtol = atol = 1e-5 (the same f32 products summed over D in
  another order); i_max identical except where the two positions' logits
  differ by no more than that.
* bf16 inputs: after the bf16 out cast, one bf16 ulp (values a hair
  either side of a rounding boundary land one ulp apart).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.lm_head import lm_head_naive as jax_naive
from repro.core.lm_head import lm_head_sparton as jax_sparton
from repro.kernels.ref import sparton_forward_ref as jax_ref
from repro_torch.core import head_api, lm_head
from repro_torch.kernels.ops import sparton_head
from repro_torch.kernels.ref import sparton_forward_ref
from repro_torch.kernels.sparton import sparton_forward

TOL = 1e-5
SHAPES = [  # (B, S, D, V): the sweep of tests/test_kernels_sparton.py
    (1, 16, 8, 16),
    (4, 96, 64, 200),
    (3, 33, 24, 100),     # non-divisible everything
    (8, 128, 128, 256),
    (2, 256, 32, 512),
]


def _inputs(B, S, D, V, seed=0, mask_p=0.2):
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((B, S, D)).astype(np.float32)
    E = (rng.standard_normal((V, D)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(V) * 0.2).astype(np.float32)
    mask = (rng.random((B, S)) > mask_p).astype(np.int32)
    mask[:, 0] = 1
    if B > 1:
        mask[-1] = 0                      # one fully masked row
    return H, E, b, mask


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _logit(H, E, b, softcap, bb, s, v):
    z = np.float64(H[bb, s]) @ np.float64(E[v]) + b[v]
    return softcap * np.tanh(z / softcap) if softcap else z


def _assert_imax_up_to_near_ties(i_port, i_ref, H, E, b, softcap):
    for bb, v in np.argwhere(i_port != i_ref):
        a = _logit(H, E, b, softcap, bb, i_port[bb, v], v)
        r = _logit(H, E, b, softcap, bb, i_ref[bb, v], v)
        assert abs(a - r) <= TOL * (1 + abs(r)), (bb, v, a, r)


@pytest.mark.parametrize("softcap", [None, 5.0])
@pytest.mark.parametrize("B,S,D,V", SHAPES)
def test_plain_k1_matches_jax_oracle_f32(B, S, D, V, softcap):
    H, E, b, mask = _inputs(B, S, D, V)
    y, i_max = sparton_forward(*_t(H, E, b, mask), softcap=softcap)
    y_ref, i_ref = jax_ref(*_j(H, E, b, mask), softcap)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=TOL,
                               atol=TOL)
    _assert_imax_up_to_near_ties(i_max.numpy(), np.asarray(i_ref),
                                 H, E, b, softcap)
    if B > 1:   # the fully masked row gives (0, 0), as the reference
        assert (y[-1] == 0).all() and (i_max[-1] == 0).all()
    y_port_ref, _ = sparton_forward_ref(*_t(H, E, b, mask), softcap)
    np.testing.assert_allclose(y_port_ref.numpy(), np.asarray(y_ref),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("B,S,D,V", SHAPES)
def test_lm_head_ladder_matches_jax_f32(B, S, D, V):
    H, E, b, mask = _inputs(B, S, D, V, seed=1)
    ref = np.asarray(jax_naive(*_j(H, E, b, mask), logit_softcap=3.0))
    for fn in (lm_head.lm_head_naive, lm_head.lm_head_tiled,
               lm_head.lm_head_sparton):
        kw = {} if fn is lm_head.lm_head_naive else {"vocab_tile": 64}
        y = fn(*_t(H, E, b, mask), logit_softcap=3.0, **kw)
        np.testing.assert_allclose(y.numpy(), ref, rtol=TOL, atol=TOL,
                                   err_msg=fn.__name__)
    y_sparton = np.asarray(jax_sparton(*_j(H, E, b, mask),
                                       logit_softcap=3.0))
    np.testing.assert_allclose(ref, y_sparton, rtol=TOL, atol=TOL)


def _bf16_ulp(x):
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("B,S,D,V", SHAPES)
def test_kernel_head_bf16_within_one_ulp_of_jax(B, S, D, V):
    H, E, b, mask = _inputs(B, S, D, V, seed=2)
    Ht, Et = (torch.from_numpy(a).to(torch.bfloat16) for a in (H, E))
    Hj, Ej = (jnp.asarray(a).astype(jnp.bfloat16) for a in (H, E))
    head = head_api.make_head(head_api.HeadSpec(impl="kernel"))
    y = head(Ht, Et, *_t(b, mask))
    assert y.dtype == torch.bfloat16
    y_ref = np.asarray(jax_sparton(Hj, Ej, *_j(b, mask)), np.float32)
    y = y.float().numpy()
    assert (np.abs(y - y_ref) <= _bf16_ulp(y_ref)).all()
    # i_max on bf16 inputs against the oracle (exact f32 products)
    _, i_max = sparton_forward(Ht, Et, *_t(b, mask))
    _, i_ref = jax_ref(Hj, Ej, *_j(b, mask))
    Hb, Eb = (np.asarray(a, np.float32) for a in (Hj, Ej))
    _assert_imax_up_to_near_ties(i_max.numpy(), np.asarray(i_ref),
                                 Hb, Eb, b, None)


def test_registry_names():
    assert head_api.available_impls() == ("kernel", "naive", "sparton",
                                          "tiled")
    with pytest.raises(ValueError, match="unknown head impl"):
        head_api.get_head_impl("pallas")


@pytest.mark.parametrize("impl", ["naive", "tiled", "sparton", "kernel"])
def test_every_impl_matches_jax_naive(impl):
    H, E, b, mask = _inputs(3, 33, 24, 100, seed=3)
    spec = head_api.HeadSpec(impl=impl, vocab_tile=32, logit_softcap=2.0,
                             out_dtype="float32")
    y = head_api.make_head(spec)(*_t(H, E, b, mask))
    ref = jax_naive(*_j(H, E, b, mask), logit_softcap=2.0)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("pin", ["block_b", "block_s", "block_v"])
def test_kernel_impl_refuses_pinned_tpu_blocks(pin):
    H, E, b, mask = _t(*_inputs(1, 16, 8, 16))
    head = head_api.make_head(head_api.HeadSpec(impl="kernel",
                                                **{pin: 8}))
    with pytest.raises(ValueError, match="TPU tiles"):
        head(H, E, b, mask)


def test_head_without_bias_or_mask_defaults():
    H, E, b, mask = _inputs(2, 16, 8, 16, seed=4)
    y = sparton_head(*_t(H, E))
    ref = jax_naive(*_j(H, E))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("impl", ["kernel", "sparton"])
def test_requires_grad_raises_naming_the_training_slice(impl):
    """Once a raise until the training slice; now the grads of both
    heads against ``jax.grad`` of the JAX ``lm_head_sparton`` (f32, the
    tolerance above), and inference under ``torch.no_grad()``."""
    import jax

    H, E, b, mask = _inputs(2, 16, 8, 16)
    w = np.random.default_rng(9).standard_normal((2, 16)).astype(np.float32)
    Ht, Et, bt, maskt = _t(H, E, b, mask)
    for t in (Ht, Et, bt):
        t.requires_grad_(True)
    head = head_api.make_head(head_api.HeadSpec(impl=impl))
    (head(Ht, Et, bt, maskt) * torch.from_numpy(w)).sum().backward()
    ref = jax.grad(lambda H, E, b: (jax_sparton(H, E, b, jnp.asarray(mask))
                                    * w).sum(), argnums=(0, 1, 2))(*_j(H, E, b))
    for got, want in zip((Ht.grad, Et.grad, bt.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
    with torch.no_grad():              # inference is fine
        assert head(Ht, Et, bt, maskt).shape == (2, 16)


@pytest.mark.parametrize("B", [3, 65535, 65536, 140000])
def test_kernel_arguments_checked_without_a_card(B):
    """K1 takes any batch (launched in chunks of 65535 rows): it passes the
    wrapper's checks and reaches the device check, where meta tensors
    get the kernel's empty outputs and launch nothing (a CPU bias beside
    them fails it); an empty one does not pass."""
    H = torch.empty((B, 4, 8), dtype=torch.bfloat16, device="meta")
    E = torch.empty((16, 8), dtype=torch.bfloat16, device="meta")
    b = torch.empty((16,), device="meta")
    mask = torch.empty((B, 4), dtype=torch.int32, device="meta")
    launches = sparton_forward.launches
    y, i_max = sparton_forward(H, E, b, mask)
    assert tuple(y.shape) == tuple(i_max.shape) == (B, 16)
    assert sparton_forward.launches == launches
    with pytest.raises(ValueError, match="one CUDA device"):
        sparton_forward(H, E, torch.empty((16,)), mask)
    with pytest.raises(ValueError, match="outside the kernel's range"):
        sparton_forward(H[:, :0], E, b, mask[:, :0])
