"""The MarginMSE distillation term of the LSR train step and the loose
public functions of the port's ported modules, against the JAX package on
the CPU: ``TransformerConfig.distill_weight``, one train step with
``neg_tokens``, ``neg_mask`` and ``teacher_margin`` in the batch against
the jitted JAX step, the term skipped without them,
``infonce_from_scores`` and ``kernels/ops.sparton_lm_head_kernel``
(Adagrad, ``sgd_momentum`` and the schedules are held in
``test_torch_recsys.py``).

Tolerances: the step as ``test_torch_decoder_train.py``'s f32 cases (a
peak lr of 0.5: loss rtol 1e-5; params atol 1e-5 except where JAX's Adam
step ran in its eps regime, ``0 < sqrt(nu / (1 - b2^t)) < 1e-6``, held
there to 2.1 x the summed lr_t; each leaf's update outside that regime
within 1e-3 of the JAX update's norm; measured: 1 element of 32768 of
the embedding beyond 1e-5, 2.9e-5, in the regime); ``infonce_from_scores``
rtol 1e-6;
``sparton_lm_head_kernel`` against the JAX package's plain head at f32,
1e-5 (its plain versions sum over D in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.splade_bert import SMOKE as JAX_SMOKE
from repro.core.lm_head import lm_head_naive as jax_lm_head_naive
from repro.data import synthetic as jax_data
from repro.launch import steps as jax_steps
from repro.losses import contrastive as jax_losses
from repro_torch.configs.base import TransformerConfig
from repro_torch.configs.splade_bert import SMOKE
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.losses import contrastive as losses
from repro_torch.tree import tree_leaves
from repro_torch.weights import state_from_jax

N_PAIRS, Q_LEN, D_LEN = 4, 12, 16
LR, ADAM_EPS_REGIME = 0.5, 1e-6


def test_distill_weight_field_is_the_reference_s():
    import repro.configs.base as jax_base

    ref = {f.name: f.default for f in
           dataclasses.fields(jax_base.TransformerConfig)}
    mine = {f.name: f.default for f in dataclasses.fields(TransformerConfig)}
    assert mine["distill_weight"] == ref["distill_weight"] == 0.0
    assert SMOKE.distill_weight == JAX_SMOKE.distill_weight == 0.0


def _distill_batch(seed=0):
    """A pair batch with hard negatives (another draw's docs) and random
    teacher margins."""
    b = next(jax_data.lsr_pair_batches(batch=N_PAIRS, q_len=Q_LEN,
                                       d_len=D_LEN, vocab=SMOKE.vocab_size,
                                       seed=seed))
    neg = next(jax_data.lsr_pair_batches(batch=N_PAIRS, q_len=Q_LEN,
                                         d_len=D_LEN, vocab=SMOKE.vocab_size,
                                         seed=seed + 100))
    rng = np.random.default_rng(seed)
    return {**b, "neg_tokens": neg["d_tokens"], "neg_mask": neg["d_mask"],
            "teacher_margin": rng.normal(size=N_PAIRS).astype(np.float32)}


def _steps(batch, distill_weight, n=2):
    """``n`` steps of both packages (f32 compute; JAX on its plain head,
    the port on its plain ``sparton`` head) from the JAX SMOKE init:
    ``[(jax loss, jax params, port loss, port params, eps regime)]``, the
    last a list (per leaf, in JAX's order) of the elements whose JAX Adam
    step ran in its eps regime so far."""
    cfg_j = dataclasses.replace(JAX_SMOKE, compute_dtype="float32",
                                head_impl="jax", distill_weight=distill_weight)
    cfg_t = dataclasses.replace(SMOKE, compute_dtype="float32",
                                head_impl="sparton",
                                distill_weight=distill_weight)
    j_state, _ = jax_steps.init_state("splade_bert", jax.random.PRNGKey(0),
                                      smoke=True)
    t_state = state_from_jax(jax.tree.map(np.asarray, j_state), cfg_t, "cpu")
    j_step = jax.jit(jax_steps.build_lsr_train_step(
        cfg_j, None, n_micro=1, n_pairs=N_PAIRS, lr=LR))
    t_step = steps.build_lsr_train_step(cfg_t, lr=LR)
    regime = [np.zeros(p.shape, bool)
              for p in jax.tree.leaves(j_state["params"])]
    out = []
    for t in range(1, n + 1):
        j_state, jm = j_step(j_state, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
        t_state, tm = t_step(t_state, {k: torch.from_numpy(np.array(v))
                                       for k, v in batch.items()})
        vhat = [np.asarray(nu) / (1 - 0.999 ** t)
                for nu in jax.tree.leaves(j_state["opt"]["nu"])]
        regime = [r | ((v > 0) & (np.sqrt(v) < ADAM_EPS_REGIME))
                  for r, v in zip(regime, vhat)]
        out.append((float(jm["loss"]), j_state["params"],
                    float(tm["loss"]), t_state["params"], regime))
    return out


@pytest.fixture(scope="module")
def distilled():
    batch = _distill_batch()
    p0 = [np.asarray(p) for p in jax.tree.leaves(jax_steps.init_state(
        "splade_bert", jax.random.PRNGKey(0), smoke=True)[0]["params"])]
    return p0, _steps(batch, 0.5)


@pytest.mark.parametrize("n", [1, 2])
def test_margin_mse_step_matches_the_jitted_jax_step(distilled, n):
    from repro_torch.optim.schedules import linear_warmup_cosine

    p0, runs = distilled
    j_loss, j_params, t_loss, t_params, regime = runs[n - 1]
    np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5)
    moved = 2.1 * sum(linear_warmup_cosine(LR, 1000, 100_000)(s)
                      for s in range(n))
    for g, r, p, eps_regime in zip(tree_leaves(t_params),
                                   jax.tree.leaves(j_params), p0, regime):
        r = np.asarray(r)
        diff = np.abs(g.numpy() - r)
        assert diff.max(initial=0, where=~eps_regime) <= 1e-5
        assert diff.max(initial=0, where=eps_regime) <= moved
        u_t, u_j = (g.numpy() - p)[~eps_regime], (r - p)[~eps_regime]
        assert np.linalg.norm(u_t - u_j) <= 1e-3 * np.linalg.norm(u_j)


def test_margin_mse_term_is_in_the_loss(distilled):
    """With the negatives the first loss exceeds the same step's without
    the term by ``0.5 * margin_mse`` > 0."""
    batch = _distill_batch()
    plain = {k: v for k, v in batch.items()
             if k not in ("neg_tokens", "neg_mask", "teacher_margin")}
    without = _steps(plain, 0.5, n=1)[0]
    with_term = distilled[1][0]
    assert with_term[2] > without[2] + 1e-3
    assert with_term[0] > without[0] + 1e-3


@pytest.mark.parametrize("weight,drop", [(0.5, True), (0.0, False)])
def test_margin_mse_term_is_skipped(weight, drop):
    """Without ``neg_tokens`` (weight 0.5), or at ``distill_weight`` 0 with
    them, the step's loss is the plain step's."""
    batch = _distill_batch(1)
    if drop:
        batch = {k: v for k, v in batch.items()
                 if k not in ("neg_tokens", "neg_mask", "teacher_margin")}
    cfg = dataclasses.replace(SMOKE, compute_dtype="float32",
                              head_impl="sparton", distill_weight=weight)
    base = dataclasses.replace(cfg, distill_weight=0.0)
    state = steps.init_state("splade_bert",
                             torch.Generator().manual_seed(0), smoke=True)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    got = steps.lsr_loss(cfg)(state["params"], tb)
    want = steps.lsr_loss(base)(state["params"],
                                {k: tb[k] for k in ("q_tokens", "q_mask",
                                                    "d_tokens", "d_mask")})
    assert float(got) == float(want)
    ref = _steps(batch, weight, n=1)[0]
    np.testing.assert_allclose(ref[2], ref[0], rtol=1e-5)


@pytest.mark.parametrize("temperature", [1.0, 0.05])
def test_infonce_from_scores_matches_jax(temperature):
    rng = np.random.default_rng(3)
    scores = (rng.normal(size=(6, 9)) * 4).astype(np.float32)
    got = losses.infonce_from_scores(torch.from_numpy(scores),
                                     temperature=temperature)
    ref = jax_losses.infonce_from_scores(jnp.asarray(scores),
                                         temperature=temperature)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    q = np.maximum(rng.normal(size=(5, 40)), 0).astype(np.float32)
    d = np.maximum(rng.normal(size=(5, 40)), 0).astype(np.float32)
    a = losses.infonce_from_scores(torch.from_numpy(q @ d.T))
    b = losses.infonce_loss(torch.from_numpy(q), torch.from_numpy(d))
    np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


@pytest.mark.parametrize("softcap", [None, 3.0])
def test_sparton_lm_head_kernel_matches_the_jax_head(softcap):
    """The reference's positional call ``(H, E, b, mask, None, None, None,
    softcap, interpret)``: y and the grads of ``sum(y * c)`` in H, E and b
    against the JAX package's plain head (its Pallas kernel does not run
    on the CPU)."""
    rng = np.random.default_rng(5)
    B, S, D, V = 2, 7, 16, 40
    H = rng.normal(size=(B, S, D)).astype(np.float32)
    E = (rng.normal(size=(V, D)) * 0.3).astype(np.float32)
    b = (rng.normal(size=V) * 0.2).astype(np.float32)
    mask = (rng.random((B, S)) > 0.3).astype(np.int32)
    c = rng.normal(size=(B, V)).astype(np.float32)

    def jax_loss(H_, E_, b_):
        y = jax_lm_head_naive(H_, E_, b_, jnp.asarray(mask),
                              logit_softcap=softcap)
        return jnp.sum(y * c), y

    (_, y_ref), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(H), jnp.asarray(E), jnp.asarray(b))
    live = [torch.from_numpy(x).requires_grad_(True) for x in (H, E, b)]
    y = ops.sparton_lm_head_kernel(*live, torch.from_numpy(mask), None,
                                   None, None, softcap, True)
    (y * torch.from_numpy(c)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               rtol=1e-5, atol=1e-5)
    for t, g in zip(live, grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5,
                                   atol=1e-5)


def test_sparton_lm_head_kernel_refuses_tile_pins():
    H, E = torch.zeros((1, 2, 8)), torch.zeros((4, 8))
    b, mask = torch.zeros(4), torch.ones((1, 2), dtype=torch.int32)
    for kw in ({"block_b": 8}, {"dh_blocks": (8, 8, 128)}):
        with pytest.raises(ValueError, match="TPU tiles"):
            ops.sparton_lm_head_kernel(H, E, b, mask, **kw)
