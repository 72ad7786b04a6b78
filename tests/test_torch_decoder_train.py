"""Decoder training in the port against the JAX package, on the CPU: the
LSR train step on the three dense decoders (llama3.2-3b, gemma2-27b,
phi3-mini) and the two MoE decoders (moonshot-v1-16b-a3b, phi3.5-moe),
whose objective adds ``aux_weight * (aux_q + aux_d)``; ``moe_ffn``'s
gradients against ``jax.grad``; remat; the train CLI on every decoder id
and alias; and ``weights.state_from_jax`` on decoder train states. The
JAX SMOKE states are carried over by ``state_from_jax``; the port runs
its kernels' plain versions (the default kernel head), JAX its plain
head (``head_impl="jax"``: its Pallas K1-K3 do not run on this jax).

Tolerances:

* the train step, as ``test_torch_train.py``'s encoder cases (a peak lr
  of 0.5, so that a step moves a param by ~lr_t = 5e-4), with two
  differences the decoders' SMOKE inits force. At f32 compute: each
  leaf's update (new minus old params) within 1e-3 of the JAX update's
  norm; every param atol 1e-5 except where Adam's step ran in its eps
  regime (JAX's ``0 < sqrt(nu / (1 - b2^t)) < 1e-6`` at some step,
  within 100x of eps = 1e-8: a gradient element near zero, made ~1e-8 by
  the global-norm clip, whose f32 rounding moves ``m / (sqrt(v) + eps)``
  by O(1)), held there to 2.1 x the summed lr_t (a step's largest move
  either way) and left out of the update's norm. Measured: every element
  off by more than 1e-5 had ``sqrt(v) <= 8.5e-9`` at its first step, all
  others agreed to 1.3e-7, and the regime held 0.16-6.4 % of a tree.
  The loss rtol 1e-4, not 1e-5: the decoders' InfoNCE logits (q . d over
  the SMOKE vocabularies) reach ~300 at init, where an f32 ulp is 3e-5
  (measured 1.5e-5 to 6.1e-5 apart), so a loss of ~0.5-3 carries up to
  ~4e-5 (measured 3.7e-5 relative, phi3.5-moe's second step). At bf16
  compute (the dense decoders only: at bf16 a rounding can route an MoE
  token to another expert) the loss rtol 2e-2 and the whole tree's update
  within 0.5 of JAX's norm, each leaf's within 0.75 (a step that moves
  nothing gives 1.0, a wrong gradient ~1.4; measured 0.23-0.36 over the
  tree and 0.0-0.59 a leaf, the 128-element ``ln2`` the widest), params
  not held elementwise (Adam's first steps move a param by about +-lr
  whatever the size of its gradient, so a gradient that rounding leaves
  near zero can flip its step);
* ``moe_ffn``'s gradients at f32: rtol 1e-5 plus 1e-6 of the leaf's
  largest gradient (the router's sums over T tokens cancel: measured
  3.4e-7 of its largest);
* remat on against off: 1e-6 (the same ops recomputed);
* the CLI's first loss (bf16 compute, the default kernel head) against
  the JAX CLI's on the same state: rtol 2e-2, as the encoder's.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import synthetic as jax_data
from repro.launch import steps as jax_steps
from repro.models import moe as jax_moe
from repro_torch.configs import get_config
from repro_torch.launch import steps, train
from repro_torch.launch.train import make_runner, pair_loader
from repro_torch.models import moe
from repro_torch.optim.schedules import linear_warmup_cosine
from repro_torch.tree import tree_items, tree_leaves
from repro_torch.weights import state_from_jax

DENSE = ("llama3_2_3b", "gemma2_27b", "phi3_mini")
MOE = ("moonshot_v1_16b", "phi3_5_moe")
ALIASES = ("llama3.2-3b", "gemma2-27b", "phi3-mini-3.8b",
           "moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b")
# case: (arch, compute dtype, loss rtol, param atol or None, update tol
#        of the whole tree or None, of each leaf)
STEP_CASES = {
    **{f"{a}-f32": (a, "float32", 1e-4, 1e-5, None, 1e-3)
       for a in DENSE + MOE},
    **{f"{a}-bf16": (a, "bfloat16", 2e-2, None, 0.5, 0.75) for a in DENSE},
}
N_PAIRS, Q_LEN, D_LEN = 4, 12, 16
LR, ADAM_EPS_REGIME = 0.5, 1e-6


def _jax_state(arch):
    state, _ = jax_steps.init_state(arch, jax.random.PRNGKey(0), smoke=True)
    return state


def _cfgs(arch, **over):
    return (dataclasses.replace(jax_config(arch).SMOKE, head_impl="jax",
                                **over),
            dataclasses.replace(get_config(arch).SMOKE, **over))


def _batches(vocab, n=2, batch=N_PAIRS):
    it = jax_data.lsr_pair_batches(batch=batch, q_len=Q_LEN, d_len=D_LEN,
                                   vocab=vocab)
    return [next(it) for _ in range(n)]


def _two_steps(arch, cdtype, n_micro=1):
    """Two steps of both packages from the same SMOKE state: the initial
    params and, per step, ``(jax loss, jax params, port loss, port
    params, eps regime)``, the last a list (per leaf, in JAX's order) of
    the elements whose JAX Adam step ran in its eps regime so far."""
    cfg_j, cfg_t = _cfgs(arch, compute_dtype=cdtype)
    j_state = _jax_state(arch)
    t_state = state_from_jax(jax.tree.map(np.asarray, j_state), cfg_t, "cpu")
    j_step = jax.jit(jax_steps.build_lsr_train_step(
        cfg_j, None, n_micro=n_micro, n_pairs=N_PAIRS, lr=LR))
    t_step = steps.build_lsr_train_step(cfg_t, n_micro=n_micro, lr=LR)
    p0 = [np.asarray(p) for p in jax.tree.leaves(j_state["params"])]
    regime = [np.zeros(p.shape, bool) for p in p0]
    runs = []
    for t, b in enumerate(_batches(cfg_t.vocab_size), start=1):
        j_state, jm = j_step(j_state, {k: jnp.asarray(v)
                                       for k, v in b.items()})
        t_state, tm = t_step(t_state, {k: torch.from_numpy(v)
                                       for k, v in b.items()})
        vhat = [np.asarray(nu) / (1 - 0.999 ** t)
                for nu in jax.tree.leaves(j_state["opt"]["nu"])]
        regime = [r | ((v > 0) & (np.sqrt(v) < ADAM_EPS_REGIME))
                  for r, v in zip(regime, vhat)]
        runs.append((float(jm["loss"]), j_state["params"], float(tm["loss"]),
                     t_state["params"], regime))
    assert t_state["step"] == int(j_state["step"]) == 2
    return p0, runs


@pytest.fixture(scope="module")
def two_steps():
    cache = {}

    def get(case):
        if case not in cache:
            arch, cdtype, *_ = STEP_CASES[case]
            cache[case] = _two_steps(arch, cdtype)
        return cache[case]
    return get


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _hold_step(p0, run, n_steps, loss_rtol, param_atol, tree_tol, leaf_tol):
    j_loss, j_params, t_loss, t_params, regime = run
    assert np.isfinite(t_loss)
    np.testing.assert_allclose(t_loss, j_loss, rtol=loss_rtol)
    j_leaves = jax.tree.leaves(j_params)
    t_leaves = tree_leaves(t_params)
    assert len(j_leaves) == len(t_leaves) == len(p0)
    # a step's largest move either way, in Adam's eps regime
    moved = 2.1 * sum(linear_warmup_cosine(LR, 1000, 100_000)(s)
                      for s in range(n_steps))
    u_all = []
    for g, r, p, eps_regime in zip(t_leaves, j_leaves, p0, regime):
        assert g.dtype == torch.float32
        r = np.asarray(r)
        u_t, u_j = g.numpy() - p, r - p
        if param_atol is not None:
            diff = np.abs(g.numpy() - r)
            assert diff.max(initial=0, where=~eps_regime) <= param_atol
            assert diff.max(initial=0, where=eps_regime) <= moved
            held = ~eps_regime
            assert _rel(u_t[held], u_j[held]) <= leaf_tol
        else:
            assert _rel(u_t, u_j) <= leaf_tol
        u_all.append((u_t.ravel(), u_j.ravel()))
    if tree_tol is not None:
        u_t, u_j = (np.concatenate(u) for u in zip(*u_all))
        assert _rel(u_t, u_j) <= tree_tol


@pytest.mark.parametrize("n_steps", [1, 2])
@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_decoder_train_step_matches_jax_jitted_step(two_steps, case,
                                                    n_steps):
    _, _, *tol = STEP_CASES[case]
    p0, runs = two_steps(case)
    _hold_step(p0, runs[n_steps - 1], n_steps, *tol)


def test_moe_train_step_with_microbatches_matches_jax():
    """moonshot at n_micro 2 against the JAX step at n_micro 2: each
    micro-batch routes its own 2 x S tokens (its own capacity) in both."""
    p0, runs = _two_steps("moonshot_v1_16b", "float32", n_micro=2)
    for n_steps, run in enumerate(runs, start=1):
        _hold_step(p0, run, n_steps, *STEP_CASES["moonshot_v1_16b-f32"][2:])


def test_moe_loss_holds_the_aux_term():
    """The objective is the SPLADE loss plus ``aux_weight * (aux_q +
    aux_d)``: the loss moves by exactly the aux term's change when
    ``aux_weight`` does, and a dense trunk's aux is 0."""
    cfg = dataclasses.replace(get_config("moonshot_v1_16b").SMOKE,
                              compute_dtype="float32")
    state = state_from_jax(jax.tree.map(np.asarray,
                                        _jax_state("moonshot_v1_16b")),
                           cfg, "cpu")
    b = {k: torch.from_numpy(v) for k, v in _batches(cfg.vocab_size, 1)[0]
         .items()}
    encode = steps._encode_fn(cfg, None, N_PAIRS)
    with torch.no_grad():
        aux = sum(float(encode(state["params"], b[f"{s}_tokens"],
                               b[f"{s}_mask"])[1]) for s in ("q", "d"))
        losses = [float(steps.lsr_loss(dataclasses.replace(
            cfg, aux_weight=w))(state["params"], b)) for w in (0.0, 1.0)]
    assert aux > 0
    np.testing.assert_allclose(losses[1] - losses[0], aux, rtol=1e-5)


# ---------------------------------------------------------------------------
# the MoE backward
# ---------------------------------------------------------------------------

MOE_T, MOE_D, MOE_E, MOE_K, MOE_F = 64, 32, 8, 2, 48


@pytest.mark.parametrize("capacity_factor", [0.5, float(MOE_E)],
                         ids=["drops", "no_drops"])
def test_moe_ffn_grads_match_jax_grad(capacity_factor):
    """The gradients of ``sum(out * w) + 0.37 * aux`` with respect to x,
    the router and the three expert weights: through the stable top-k
    values and their renormalisation, zero for a dropped assignment's
    gate (the port zeroes it, the reference multiplies a zero row), and
    the aux term through ``probs.mean(0)`` only (the counts, as the
    reference's one-hot ``ce``, carry none)."""
    rng = np.random.default_rng(11)
    args = [rng.standard_normal(s).astype(np.float32) * sc for s, sc in (
        ((MOE_T, MOE_D), 1.0), ((MOE_D, MOE_E), MOE_D ** -0.5),
        ((MOE_E, MOE_D, MOE_F), MOE_D ** -0.5),
        ((MOE_E, MOE_D, MOE_F), MOE_D ** -0.5),
        ((MOE_E, MOE_F, MOE_D), MOE_F ** -0.5))]
    w_out = rng.standard_normal((MOE_T, MOE_D)).astype(np.float32)
    kw = dict(top_k=MOE_K, capacity_factor=capacity_factor)

    def j_loss(*a):
        out, aux = jax_moe.moe_ffn(*a, **kw)
        return (out * w_out).sum() + 0.37 * aux

    want = jax.grad(j_loss, argnums=tuple(range(5)))(
        *(jnp.asarray(a) for a in args))
    live = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out, aux = moe.moe_ffn(*live, **kw)
    loss = (out * torch.from_numpy(w_out)).sum() + 0.37 * aux
    got = torch.autograd.grad(loss, live)
    C = moe.capacity(MOE_T, MOE_E, MOE_K, capacity_factor)
    assert (C < MOE_T * MOE_K / MOE_E) == (capacity_factor < 1)
    for name, g, w in zip(("x", "router", "w_gate", "w_up", "w_down"),
                          got, want):
        assert float(g.abs().sum()) > 0, name
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max(), err_msg=name)


def _loss_and_grads(cfg, params, batch):
    loss, grads = steps.value_and_grad(steps.lsr_loss(cfg))(params, batch)
    return float(loss), tree_items(grads)


def _moonshot(**over):
    cfg = dataclasses.replace(get_config("moonshot_v1_16b").SMOKE,
                              compute_dtype="float32", **over)
    state = state_from_jax(jax.tree.map(np.asarray,
                                        _jax_state("moonshot_v1_16b")),
                           cfg, "cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in _batches(cfg.vocab_size, 1)[0].items()}
    return cfg, state["params"], batch


def test_remat_on_and_off_give_the_same_loss_and_grads():
    """With remat each layer runs under ``torch.utils.checkpoint`` and
    hands its aux loss out of it: the loss and every gradient equal
    without (1e-6), the router's included."""
    cfg, params, batch = _moonshot()
    l_off, g_off = _loss_and_grads(dataclasses.replace(cfg, remat=False),
                                   params, batch)
    l_on, g_on = _loss_and_grads(dataclasses.replace(cfg, remat=True),
                                 params, batch)
    np.testing.assert_allclose(l_on, l_off, rtol=1e-6, atol=1e-6)
    assert sorted(g_on) == sorted(g_off)
    assert float(g_on["layers/mlp/router"].abs().sum()) > 0
    for name in g_off:
        torch.testing.assert_close(g_on[name], g_off[name], rtol=1e-6,
                                   atol=1e-6, msg=name)


def test_aux_weight_moves_the_router_gradient():
    """The aux term reaches the router: a larger ``aux_weight`` changes
    its gradient."""
    cfg, params, batch = _moonshot()
    _, g_lo = _loss_and_grads(cfg, params, batch)
    _, g_hi = _loss_and_grads(dataclasses.replace(cfg, aux_weight=1.0),
                              params, batch)
    diff = (g_hi["layers/mlp/router"] - g_lo["layers/mlp/router"]).norm()
    assert float(diff) > 1e-3 * float(g_lo["layers/mlp/router"].norm())


# ---------------------------------------------------------------------------
# weights.state_from_jax on decoder train states
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE + MOE)
def test_state_from_jax_carries_a_decoder_train_state(arch, param_dtype):
    """Params in their dtype (f32 SMOKE or bf16, bit for bit), f32
    moments, the step an int."""
    from repro.models import transformer as jax_tfm
    from repro.optim import optimizers as jax_opt

    cfg_j, cfg_t = _cfgs(arch, param_dtype=param_dtype)
    params = jax_tfm.init_params(jax.random.PRNGKey(3), cfg_j)
    j_state = {"params": params,
               "opt": jax.tree.map(lambda m: m + 0.5,
                                   jax_opt.adamw(1e-4).init(params)),
               "step": jnp.array(4, jnp.int32)}
    t_state = state_from_jax(jax.tree.map(np.asarray, j_state), cfg_t, "cpu")
    assert t_state["step"] == 4
    for part in ("params", "opt"):
        for got, want in zip(tree_leaves(t_state[part]),
                             jax.tree.leaves(j_state[part]), strict=True):
            want = np.asarray(want)
            if want.dtype.name == "bfloat16":
                assert got.dtype == torch.bfloat16
                np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                              want.view(np.int16))
            else:
                assert want.dtype == np.float32
                assert got.dtype == torch.float32
                np.testing.assert_array_equal(got.numpy(), want)
    assert t_state["params"]["embed"].dtype == (
        torch.bfloat16 if param_dtype == "bfloat16" else torch.float32)


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE + MOE + ALIASES)
def test_train_cli_trains_a_decoder_on_the_cpu(arch, capsys, tmp_path):
    assert train.main(["--arch", arch, "--steps", "2", "--batch", "2",
                       "--seq-len", "16", "--device", "cpu", "--ckpt-dir",
                       str(tmp_path)]) == 0
    out = capsys.readouterr().out
    m = re.search(r"step 2: loss ([-0-9.e]+) \(first ([-0-9.e]+)\)", out)
    assert m and all(np.isfinite(float(x)) for x in m.groups())
    assert "(head kernel)" in out and "0 skipped" in out


@pytest.mark.parametrize("arch", ["llama3_2_3b", "moonshot_v1_16b"])
def test_train_cli_first_loss_matches_jax_cli(arch, tmp_path, capsys):
    """The port's CLI loop from the JAX CLI's SMOKE state (PRNGKey(0))
    against the JAX CLI's printed first loss, both at the same flags."""
    from repro.launch.train import main as jax_main

    flags = ["--arch", arch, "--steps", "2", "--batch", "2", "--seq-len",
             "16"]
    assert jax_main(flags + ["--ckpt-dir", str(tmp_path)]) == 0
    first = float(re.search(r"\(first ([-0-9.e]+)\)",
                            capsys.readouterr().out).group(1))
    cfg = get_config(arch).SMOKE
    state = state_from_jax(jax.tree.map(np.asarray, _jax_state(arch)), cfg,
                           "cpu")
    cpu = torch.device("cpu")
    with pair_loader(cfg, batch=2, seq_len=16, device=cpu) as loader:
        runner = make_runner(cfg, state, iter(loader), steps=2, lr=2e-4,
                             device=cpu, ckpt_dir=str(tmp_path / "port"))
        runner.run()
    assert runner.errors == [] and runner.skipped_steps == []
    got = [float(m["loss"]) for m in runner.metrics_log]
    assert len(got) == 2 and all(np.isfinite(got))
    np.testing.assert_allclose(got[0], first, rtol=2e-2)


def test_train_cli_evaluates_a_decoder(capsys, tmp_path):
    assert train.main(["--arch", "phi3_5_moe", "--steps", "2", "--batch",
                       "2", "--seq-len", "16", "--eval-every", "1",
                       "--eval-queries", "8", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    for line in ("eval @ init: mrr@10", "eval @ step 1: mrr@10",
                 "eval @ step 2: mrr@10", "eval improvement over init:"):
        assert line in out
