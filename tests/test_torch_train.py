"""The port's training slice (losses, clipping, AdamW, the schedule,
gradient accumulation, the synthetic pairs, the train step and the train
CLI) against the JAX package on the same numpy inputs and the same
carried state, on the CPU.

Tolerances:

* losses, clipping, the schedule: rtol 1e-6 (the same f32 formulas;
  reductions in another order); AdamW's updates and moments: rtol 1e-5
  (the clip scale's norm sums in another order, so the clipped grads
  differ in their last ulps);
* ``microbatch_grads`` against the whole batch: atol 1e-6 (a loss that
  is a mean over rows, so the mean of the chunks' is the batch's);
* the synthetic pairs: identical;
* the train step, with a peak lr of 0.5 so that a step moves a param by
  ~1e-3: the loss, every param elementwise, and each leaf's update (new
  minus old params) by its relative norm. At f32 compute: loss rtol
  1e-5, params atol 1e-5, updates 1e-3. At bf16 compute both sides round
  the trunk's matmuls at other places, and Adam's first steps move a
  param by about ±lr whatever the size of its gradient, so a gradient
  that rounding leaves near zero can flip its step (10-35 % of an
  update's norm, measured): loss rtol 2e-2 and updates 0.5 (a wrong
  gradient gives ~1.4, a step that moves nothing 1.0). Params are not
  held elementwise there: a flipped step puts a param as far from JAX's
  as two steps can move it, so any atol that passes would pass a frozen
  step too;
* the CLI's first loss (SMOKE, bf16 compute, the default kernel head)
  against the JAX CLI's on the same state: rtol 2e-2.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.splade_bert import SMOKE as JAX_SMOKE
from repro.data import synthetic as jax_data
from repro.launch import steps as jax_steps
from repro.losses import contrastive as jax_losses
from repro.optim import optimizers as jax_opt
from repro.optim.accumulation import GradAccumulator as JaxGradAccumulator
from repro.optim import schedules as jax_sched
from repro_torch.configs.splade_bert import SMOKE
from repro_torch.data import synthetic
from repro_torch.launch import steps
from repro_torch.launch.train import make_runner, pair_loader
from repro_torch.losses import contrastive as losses
from repro_torch.optim import optimizers as opt
from repro_torch.optim import schedules as sched
from repro_torch.optim import GradAccumulator
from repro_torch.optim.accumulation import microbatch_grads
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.weights import state_from_jax

ROOT = Path(__file__).resolve().parents[1]


def _reps(B, V, seed, n_docs=None):
    rng = np.random.default_rng(seed)
    q = np.maximum(rng.standard_normal((B, V)), 0).astype(np.float32)
    d = np.maximum(rng.standard_normal((n_docs or B, V)), 0)
    return q, d.astype(np.float32)


LOSSES = {
    "infonce": lambda m, q, d, n, t: m.infonce_loss(q, d, temperature=0.7),
    "flops": lambda m, q, d, n, t: m.flops_regularizer(d),
    "l1": lambda m, q, d, n, t: m.l1_regularizer(q),
    "margin_mse": lambda m, q, d, n, t: m.margin_mse_loss(q, d[:4], n, t),
    "splade": lambda m, q, d, n, t: m.splade_loss(q, d, l1_weight=1e-3,
                                                  lambda_q=1e-2),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_match_jax(name):
    q, d = _reps(4, 50, 0, n_docs=8)          # 4 extra docs: negatives
    neg, _ = _reps(4, 50, 1)
    margin = np.random.default_rng(2).standard_normal(4).astype(np.float32)
    args = (q, d, neg, margin)
    got = LOSSES[name](losses, *(torch.from_numpy(a) for a in args))
    ref = LOSSES[name](jax_losses, *(jnp.asarray(a) for a in args))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((5, 3)) * scale).astype(np.float32),
            "blk": {"b": (rng.standard_normal(3) * scale).astype(np.float32),
                    "s": (rng.standard_normal(7) * scale).astype(np.float32)}}


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_trees(got, ref, **tol):
    for g, r in zip(tree_leaves(got), jax.tree.leaves(ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **tol)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])   # clipped, untouched
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(3)
    got, gn = opt.clip_by_global_norm(_to_torch(g), max_norm)
    ref, rgn = jax_opt.clip_by_global_norm(g, max_norm)
    np.testing.assert_allclose(float(gn), float(rgn), rtol=1e-6)
    _assert_trees(got, ref, rtol=1e-6, atol=1e-7)


def test_clip_on_blocks_without_axes_is_the_unsharded_clip():
    """Over a mesh with no leaf split the norm is the unsharded one bit for
    bit: the leaves added in ``tree_leaves``' order, not the dict's (here
    the two orders round 2^24 + 3 + 3 differently)."""
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.tree import tree_items

    grads = {"b": torch.tensor([4096.0]),
             "a": {"w": torch.ones(3), "v": torch.ones(3)}}
    axes = {"b": (), "a": {"w": (), "v": ()}}
    want, want_gn = opt.clip_by_global_norm(grads, 1.0)
    got, gn = opt.clip_by_global_norm(
        grads, 1.0, mesh=AbstractMesh((2, 2), ("data", "model")),
        block_axes=axes)
    assert torch.equal(gn, want_gn)
    for k, v in tree_items(want).items():
        assert torch.equal(tree_items(got)[k], v), k


def test_adamw_three_steps_from_carried_state_match_jax():
    """Three updates from a state with non-zero moments, at step 5, with
    clipping and weight decay on every leaf."""
    kw = dict(b1=0.8, b2=0.99, eps=1e-6, weight_decay=0.1, max_grad_norm=2.0)
    lr = jax_sched.linear_warmup_cosine(0.1, 3, 20)
    j_opt = jax_opt.adamw(lr, **kw)
    t_opt = opt.adamw(sched.linear_warmup_cosine(0.1, 3, 20), **kw)
    params = _tree(4)
    state = {"mu": _tree(5, 0.1), "nu": jax.tree.map(np.abs, _tree(6, 0.1))}
    j_params, j_state = params, state
    t_params, t_state = _to_torch(params), _to_torch(state)
    for k in range(3):
        grads = _tree(10 + k, scale=3.0)
        upd, j_state = j_opt.update(grads, j_state, j_params,
                                    jnp.asarray(5 + k, jnp.int32))
        j_params = jax_opt.apply_updates(j_params, upd)
        t_upd, t_state = t_opt.update(_to_torch(grads), t_state, t_params,
                                      5 + k)
        t_params = opt.apply_updates(t_params, t_upd)
        _assert_trees(t_upd, upd, rtol=1e-5, atol=1e-8)
    _assert_trees(t_params, j_params, rtol=1e-6, atol=1e-7)
    _assert_trees(t_state["mu"], j_state["mu"], rtol=1e-5, atol=1e-8)
    _assert_trees(t_state["nu"], j_state["nu"], rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("step", [0, 1, 500, 998, 999, 1000, 1001, 50_000,
                                  99_999, 200_000])
def test_linear_warmup_cosine_matches_jax(step):
    for args in ((2e-4, 1000, 100_000), (1.0, 1000, 100_000, 0.1)):
        kw = {"final_fraction": args[3]} if len(args) > 3 else {}
        got = sched.linear_warmup_cosine(*args[:3], **kw)(step)
        ref = jax_sched.linear_warmup_cosine(*args[:3], **kw)(
            jnp.asarray(step, jnp.int32))
        np.testing.assert_allclose(got, float(ref), rtol=1e-6)
    assert sched.constant_schedule(0.3)(step) == float(
        jax_sched.constant_schedule(0.3)(step))


def test_microbatch_grads_equal_the_whole_batch():
    rng = np.random.default_rng(7)
    params = {"w": torch.ones((4, 3))}
    batch = {"x": torch.from_numpy(rng.standard_normal((8, 4))).float(),
             "y": torch.from_numpy(rng.standard_normal((8, 3))).float()}
    grad_fn = steps.value_and_grad(
        lambda p, b: ((b["x"] @ p["w"] - b["y"]) ** 2).mean())
    l_full, g_full = grad_fn(params, batch)
    for n_micro in (2, 4):
        l_m, g_m = microbatch_grads(grad_fn, params, batch, n_micro=n_micro)
        np.testing.assert_allclose(float(l_m), float(l_full), atol=1e-6)
        np.testing.assert_allclose(g_m["w"].numpy(), g_full["w"].numpy(),
                                   atol=1e-6)
    with pytest.raises(ValueError, match="divisible"):
        microbatch_grads(grad_fn, params, batch, n_micro=3)


def test_grad_accumulator_renormalizes():
    acc = GradAccumulator()
    acc.add({"w": torch.tensor(2.0)})
    acc.add({"w": torch.tensor(4.0)})
    out = acc.mean_and_reset()
    assert float(out["w"]) == pytest.approx(3.0)
    assert acc.count == 0 and acc.grads is None
    with pytest.raises(ValueError, match="no gradients"):
        acc.mean_and_reset()


def test_grad_accumulator_matches_jax():
    """Three trees added, the mean taken, then two more: the same f32
    values as the JAX accumulator's (the same sums in the same order)."""
    trees = [_tree(s) for s in range(5)]
    acc, ref = GradAccumulator(), JaxGradAccumulator()
    for window in (trees[:3], trees[3:]):
        for t in window:
            acc.add(_to_torch(t))
            ref.add(jax.tree.map(jnp.asarray, t))
        assert acc.count == ref.count == len(window)
        _assert_trees(acc.mean_and_reset(), ref.mean_and_reset(), rtol=0,
                      atol=0)


@pytest.mark.parametrize("seed,shard", [(0, 0), (3, 1)])
def test_lsr_pair_batches_identical_to_jax(seed, shard):
    kw = dict(batch=3, q_len=9, d_len=14, vocab=300, seed=seed, shard=shard)
    ours, theirs = synthetic.lsr_pair_batches(**kw), \
        jax_data.lsr_pair_batches(**kw)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def _jax_state():
    state, _ = jax_steps.init_state("splade_bert", jax.random.PRNGKey(0),
                                    smoke=True)
    return state


STEP_CASES = {  # name: (compute dtype, head impl, loss rtol, param atol
    #                      or None, update relative norm)
    "f32-sparton": ("float32", "sparton", 1e-5, 1e-5, 1e-3),
    "f32-kernel": ("float32", "kernel", 1e-5, 1e-5, 1e-3),
    "bf16-kernel": ("bfloat16", "kernel", 2e-2, None, 0.5),
}


@pytest.fixture(scope="module")
def two_steps():
    """Two steps of both packages from the same SMOKE state, per case:
    ``{case: (initial params, [(jax loss, jax params, port loss, port
    params), ...])}``."""
    batches = list(zip(range(2), jax_data.lsr_pair_batches(
        batch=4, q_len=12, d_len=16, vocab=SMOKE.vocab_size)))
    out = {}
    for name, (cdtype, impl, *_) in STEP_CASES.items():
        cfg_j = dataclasses.replace(JAX_SMOKE, compute_dtype=cdtype,
                                    head_impl="jax")
        cfg_t = dataclasses.replace(SMOKE, compute_dtype=cdtype,
                                    head_impl=impl)
        j_state = _jax_state()
        t_state = state_from_jax(jax.tree.map(np.asarray, j_state), cfg_t,
                                 "cpu")
        j_step = jax.jit(jax_steps.build_lsr_train_step(
            cfg_j, None, n_micro=1, n_pairs=4, lr=0.5))
        t_step = steps.build_lsr_train_step(cfg_t, lr=0.5)
        p0 = [np.asarray(p) for p in jax.tree.leaves(j_state["params"])]
        out[name] = (p0, [])
        for _, b in batches:
            j_state, jm = j_step(j_state, {k: jnp.asarray(v)
                                           for k, v in b.items()})
            t_state, tm = t_step(t_state, {k: torch.from_numpy(v)
                                           for k, v in b.items()})
            out[name][1].append((float(jm["loss"]), j_state["params"],
                              float(tm["loss"]), t_state["params"]))
        assert t_state["step"] == int(j_state["step"]) == 2
    return out


@pytest.mark.parametrize("n_steps", [1, 2])
@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_matches_jax_jitted_step(two_steps, case, n_steps):
    _, _, loss_rtol, param_atol, update_tol = STEP_CASES[case]
    p0, runs = two_steps[case]
    j_loss, j_params, t_loss, t_params = runs[n_steps - 1]
    assert np.isfinite(t_loss)
    np.testing.assert_allclose(t_loss, j_loss, rtol=loss_rtol)
    j_leaves = jax.tree.leaves(j_params)
    t_leaves = tree_leaves(t_params)
    assert len(j_leaves) == len(t_leaves) == len(p0)
    for g, r, p in zip(t_leaves, j_leaves, p0):
        assert g.dtype == torch.float32
        if param_atol is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                       atol=param_atol)
        u_t, u_j = g.numpy() - p, np.asarray(r) - p
        assert np.linalg.norm(u_t - u_j) <= update_tol * np.linalg.norm(u_j)


def test_train_step_with_microbatches_matches_one_batch_loss_mean():
    """n_micro = 2 averages the two halves' losses and grads."""
    cfg = dataclasses.replace(SMOKE, compute_dtype="float32")
    state = state_from_jax(jax.tree.map(np.asarray, _jax_state()), cfg,
                           "cpu")
    b = next(synthetic.lsr_pair_batches(batch=4, q_len=8, d_len=8,
                                        vocab=cfg.vocab_size))
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in tb.items()}
              for i in range(2)]
    _, m2 = steps.build_lsr_train_step(cfg, n_micro=2)(state, tb)
    one = steps.build_lsr_train_step(cfg)
    mean = sum(float(one(state, h)[1]["loss"]) for h in halves) / 2
    np.testing.assert_allclose(float(m2["loss"]), mean, rtol=1e-6)


def test_train_cli_first_loss_matches_jax_cli(tmp_path, capsys):
    """The port's CLI loop from the JAX CLI's SMOKE state (PRNGKey(0))
    against the JAX CLI's printed first loss, both at the same flags."""
    from repro.launch.train import main as jax_main

    flags = ["--arch", "splade_bert", "--steps", "3", "--batch", "2",
             "--seq-len", "16"]
    assert jax_main(flags + ["--ckpt-dir", str(tmp_path)]) == 0
    first = float(re.search(r"\(first ([-0-9.e]+)\)",
                            capsys.readouterr().out).group(1))
    state = state_from_jax(jax.tree.map(np.asarray, _jax_state()), SMOKE,
                           "cpu")
    cpu = torch.device("cpu")
    with pair_loader(SMOKE, batch=2, seq_len=16, device=cpu) as loader:
        runner = make_runner(SMOKE, state, iter(loader), steps=3, lr=2e-4,
                             device=cpu, ckpt_dir=str(tmp_path / "port"))
        runner.run()
    assert runner.errors == [] and runner.skipped_steps == []
    got = [float(m["loss"]) for m in runner.metrics_log]
    assert len(got) == 3 and all(np.isfinite(got))
    np.testing.assert_allclose(got[0], first, rtol=2e-2)


def _cli(ckpt_dir, *extra):
    """The CLI in a process of its own, checkpointing into ``ckpt_dir``
    (each test its own: the default directory is shared)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "splade_bert", "--steps", "3", "--batch", "2", "--seq-len", "16",
         "--ckpt-dir", str(ckpt_dir), *extra], capture_output=True,
        text=True, env=env, cwd=ROOT, timeout=300)


def test_train_cli_runs_on_the_cpu_when_asked(tmp_path):
    """With no --head-impl the CLI trains through the kernel head (its
    plain versions, on CPU tensors)."""
    proc = _cli(tmp_path, "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    m = re.search(r"step 3: loss ([-0-9.e]+) \(first ([-0-9.e]+)\)",
                  proc.stdout)
    assert m and all(np.isfinite(float(x)) for x in m.groups())
    assert "(head kernel)" in proc.stdout


@pytest.mark.parametrize("full", [False, True])
def test_configs_default_to_the_kernel_head(full):
    from repro_torch.configs.splade_bert import CONFIG

    cfg = CONFIG if full else SMOKE
    assert cfg.head_spec().impl == "kernel"
    assert dataclasses.replace(cfg, head_impl="jax").head_spec().impl \
        == "sparton"


def test_train_cli_without_cuda_exits_non_zero_naming_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = _cli(tmp_path)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr and "step" not in proc.stdout
