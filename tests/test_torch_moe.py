"""``repro_torch.models.moe.moe_ffn`` against ``repro.models.moe.moe_ffn``
on the same seeded numpy inputs (CPU).

Tolerances:

* f32: outputs and the aux loss rtol = atol = 1e-5 (the router's f32
  softmax and the experts' products summed in another order by another
  library; one layer, D 16-32);
* bf16 inputs (the router up-cast to f32 in both, so both route the same
  tokens to the same experts): the bf16 rows of ``test_torch_decoder.py``,
  atol 0.1 with a mean-error bound of 0.02; the aux loss, computed in f32
  from the same routing, 1e-5;
* which assignments drop: exactly the same in both (a dropped assignment
  moves its token's output by O(1), far past the tolerance; with
  ``top_k`` 1 a token dropped by both has an output row of exact zeros).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.moe import moe_ffn as jax_moe_ffn
from repro_torch.models import moe

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(atol=0.1, mean=0.02)
TOP_K = (1, 2, 6)


def _inputs(T, D, Fd, E, seed, *, skew=0.0):
    """x (T, D), router (D, E), w_gate/w_up (E, D, F), w_down (E, F, D);
    ``skew`` adds a bias towards expert 0 through a constant input
    feature, so that expert takes more than its capacity."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, D)).astype(np.float32)
    router = (rng.standard_normal((D, E)) * D ** -0.5).astype(np.float32)
    if skew:
        x[:, 0] = 1.0
        router[0, 0] = skew
    wg = (rng.standard_normal((E, D, Fd)) * D ** -0.5).astype(np.float32)
    wu = (rng.standard_normal((E, D, Fd)) * D ** -0.5).astype(np.float32)
    wd = (rng.standard_normal((E, Fd, D)) * Fd ** -0.5).astype(np.float32)
    return x, router, wg, wu, wd


def _run_both(arrays, top_k, cf, dtype="float32"):
    """Both functions on the same arrays, all but the router in
    ``dtype`` (as the trunk hands them over: the router keeps its param
    dtype and both up-cast it)."""
    jd = jnp.dtype(dtype)
    td = getattr(torch, dtype)
    j_in = [jnp.asarray(a) if i == 1 else jnp.asarray(a, jd)
            for i, a in enumerate(arrays)]
    t_in = [torch.from_numpy(a) if i == 1 else torch.from_numpy(a).to(td)
            for i, a in enumerate(arrays)]
    out_j, aux_j = jax_moe_ffn(*j_in, top_k=top_k, capacity_factor=cf)
    out_t, aux_t = moe.moe_ffn(*t_in, top_k=top_k, capacity_factor=cf)
    assert out_t.dtype == td and out_t.shape == arrays[0].shape
    assert aux_t.dtype == torch.float32 and aux_t.shape == ()
    return (np.asarray(jnp.asarray(out_j, jnp.float32)), float(aux_j),
            out_t.float().numpy(), float(aux_t))


def _kept(arrays, top_k, cf):
    """Assignments the reference keeps, from its own routing:
    ``sum_e min(count_e, C)`` of ``lax.top_k`` on its f32 softmax."""
    x, router = arrays[:2]
    T, E = x.shape[0], router.shape[1]
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    _, idx = jax.lax.top_k(probs, top_k)
    counts = np.bincount(np.asarray(idx).ravel(), minlength=E)
    C = max(1, int(cf * top_k * T / E))
    return int(np.minimum(counts, C).sum()), T * top_k


def _close_f32(out_t, out_j, aux_t, aux_j):
    assert np.isfinite(out_t).all()
    np.testing.assert_allclose(out_t, out_j, **F32)
    np.testing.assert_allclose(aux_t, aux_j, **F32)


# (T, D, F, E, capacity_factor, skew): no drop (capacity_factor = E gives
# C = top_k * T), the config default 1.25 on a skewed router (drops),
# T not a multiple of E, and a tight capacity
CASES = {
    "no_drop": (32, 32, 48, 8, 8.0, 0.0),
    "skewed_drops": (48, 32, 48, 8, 1.25, 6.0),
    "t_not_divisible_by_e": (37, 16, 24, 8, 1.25, 0.0),
    "tight_capacity": (29, 16, 24, 8, 0.5, 0.0),
}


@pytest.mark.parametrize("top_k", TOP_K)
@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_matches_jax_f32(case, top_k):
    T, D, Fd, E, cf, skew = CASES[case]
    arrays = _inputs(T, D, Fd, E, seed=top_k, skew=skew)
    out_j, aux_j, out_t, aux_t = _run_both(arrays, top_k, cf)
    _close_f32(out_t, out_j, aux_t, aux_j)
    kept, total = _kept(arrays, top_k, cf)
    if case == "no_drop":
        assert kept == total
    if case in ("skewed_drops", "tight_capacity"):
        assert kept < total
    if top_k == 1:
        # a token whose one assignment drops gets exact zeros in both
        dropped_t = (out_t == 0).all(axis=1)
        dropped_j = (out_j == 0).all(axis=1)
        np.testing.assert_array_equal(dropped_t, dropped_j)
        assert int(dropped_t.sum()) == total - kept


@pytest.mark.parametrize("top_k", TOP_K)
@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_matches_jax_bf16(case, top_k):
    T, D, Fd, E, cf, skew = CASES[case]
    arrays = _inputs(T, D, Fd, E, seed=10 + top_k, skew=skew)
    out_j, aux_j, out_t, aux_t = _run_both(arrays, top_k, cf, "bfloat16")
    assert np.isfinite(out_t).all()
    np.testing.assert_allclose(out_t, out_j, rtol=0.0, atol=BF16["atol"])
    assert np.abs(out_t - out_j).mean() <= BF16["mean"]
    np.testing.assert_allclose(aux_t, aux_j, **F32)


@pytest.mark.parametrize("top_k", [1, 2])
def test_router_ties_go_to_the_lowest_expert(top_k):
    """Experts 2 and 3 have the same router column, so every token's
    probabilities tie there; with expert 0 first for top_k 2 (and
    nothing above the tie for top_k 1) the k-th choice falls on the tie
    and both packages take expert 2."""
    T, D, Fd, E = 24, 16, 24, 5
    x, router, wg, wu, wd = _inputs(T, D, Fd, E, seed=7)
    x = np.abs(x) + 0.1
    router[:] = 0.0
    router[:, 2] = router[:, 3] = 0.3
    if top_k == 2:
        router[:, 0] = 0.6
    arrays = (x, router, wg, wu, wd)
    probs, gates, experts = moe.route(torch.from_numpy(x),
                                      torch.from_numpy(router), top_k)
    assert bool((probs[:, 2] == probs[:, 3]).all())
    assert bool((experts[:, top_k - 1] == 2).all())
    _, idx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x @ router)), top_k)
    np.testing.assert_array_equal(experts.numpy(), np.asarray(idx))
    out_j, aux_j, out_t, aux_t = _run_both(arrays, top_k, float(E))
    _close_f32(out_t, out_j, aux_t, aux_j)


def test_capacity_is_the_reference_rule_per_call():
    assert moe.capacity(4, 64, 6, 1.25) == 1        # moonshot decode, B 4
    assert moe.capacity(16384, 64, 6, 1.25) == 1920  # its 2 x 8192 prefill
    assert moe.capacity(16384, 16, 2, 1.25) == 2560  # phi3.5-moe's
    assert moe.capacity(37, 8, 2, 8.0) == 74         # factor E: C = k T
    for T, E, k, cf in [(1, 8, 1, 0.1), (37, 8, 6, 1.25), (100, 16, 2, 1.0)]:
        assert moe.capacity(T, E, k, cf) == max(1, int(cf * k * T / E))


def test_moe_ffn_is_the_same_bits_twice_and_leaves_its_inputs():
    arrays = _inputs(48, 32, 48, 8, seed=3, skew=6.0)
    t_in = [torch.from_numpy(a.copy()) for a in arrays]
    before = [t.clone() for t in t_in]
    a = moe.moe_ffn(*t_in, top_k=2, capacity_factor=1.25)
    b = moe.moe_ffn(*t_in, top_k=2, capacity_factor=1.25)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for t, t0 in zip(t_in, before):
        assert torch.equal(t, t0)


def test_router_stays_f32_on_bf16_tokens():
    """The router's logits are f32 products of the up-cast inputs, as the
    reference's ``einsum`` of ``astype(float32)`` operands."""
    x, router = _inputs(16, 16, 8, 4, seed=5)[:2]
    xb = torch.from_numpy(x).to(torch.bfloat16)
    probs, gates, _ = moe.route(xb, torch.from_numpy(router), 2)
    want = torch.softmax(xb.float() @ torch.from_numpy(router), dim=-1)
    assert probs.dtype == gates.dtype == torch.float32
    assert torch.equal(probs, want)
    torch.testing.assert_close(gates.sum(dim=1), torch.ones(16))


def test_init_moe_params_layout_and_scales():
    g = torch.Generator().manual_seed(0)
    p = moe.init_moe_params(g, 3, 64, 32, 8)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "router": (3, 64, 8), "w_gate": (3, 8, 64, 32),
        "w_up": (3, 8, 64, 32), "w_down": (3, 8, 32, 64)}
    assert all(v.dtype == torch.float32 for v in p.values())
    np.testing.assert_allclose(float(p["w_gate"].std()), 64 ** -0.5,
                               rtol=0.05)
    np.testing.assert_allclose(float(p["w_down"].std()), 32 ** -0.5,
                               rtol=0.05)
    again = moe.init_moe_params(torch.Generator().manual_seed(0), 3, 64,
                                32, 8)
    assert all(torch.equal(p[k], again[k]) for k in p)
