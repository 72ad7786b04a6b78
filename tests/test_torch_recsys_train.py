"""Recsys training in the port against the JAX package, on the CPU:
``build_recsys_train_step`` against the jitted JAX step from the carried
SMOKE state (loss, params and Adagrad's ``acc``) for each family, 15
steps that learn, the train CLI on ``xdeepfm`` and ``dien`` against the
JAX step driven over the same batches, and Adagrad checkpoints: npz keys,
arrays and treedef equal to the JAX ``save_checkpoint``'s for the same
state, a resumed run equal to an uninterrupted one.

Tolerances (f32; each package sums in its own order):

* the loss rtol 1e-5 (measured at most 9.1e-8 relative);
* every param and ``acc`` element atol 1e-6 plus rtol 1e-5 (measured at
  most 3.0e-8 on params, 2.4e-7 on ``acc`` of ~0.1-1, after 2 steps):
  Adagrad's accumulator starts at 0.1, so no element's step divides by a
  rounding error;
* the CLI's losses against the JAX step's: rtol 1e-5.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jax_store
from repro.configs import get_config as jax_config
from repro.data import synthetic as jax_data
from repro.launch import steps as jax_steps
from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.launch import steps, train
from repro_torch.launch.train import make_runner, recsys_loader
from repro_torch.tree import tree_leaves
from repro_torch.weights import state_from_jax

ARCHS = ("dlrm_mlperf", "xdeepfm", "dien", "wide_deep")
CPU = torch.device("cpu")
LOSS_RTOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 1e-6, 1e-5


def _jax_state(arch, seed=0):
    return jax_steps.init_state(arch, jax.random.PRNGKey(seed),
                                smoke=True)[0]


def _carry(state, cfg):
    return state_from_jax(jax.tree.map(np.asarray, state), cfg, CPU)


def _batches(cfg, B, n, seed=0):
    gen = jax_data.recsys_batches(
        batch=B, n_dense=cfg.n_dense, n_sparse=cfg.n_sparse,
        table_sizes=cfg.table_sizes, seq_len=cfg.seq_len, seed=seed)
    return [next(gen) for _ in range(n)]


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


@pytest.fixture(scope="module", params=ARCHS)
def two_steps(request):
    """Two steps of each package from the carried JAX init on the same
    batches: (arch, port states and losses, JAX states and losses)."""
    arch = request.param
    cfg = get_config(arch).SMOKE
    jstate = _jax_state(arch, 1)
    state = _carry(jstate, cfg)
    jstep = jax.jit(jax_steps.build_recsys_train_step(jax_config(arch).SMOKE))
    step = steps.build_recsys_train_step(cfg)
    mine, ref = [], []
    for b in _batches(cfg, 24, 2, seed=3):
        before = state
        state, m = step(state, _torch(b))
        assert before is not state
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        mine.append((state, float(m["loss"])))
        ref.append((jstate, float(jm["loss"])))
    return arch, mine, ref


@pytest.mark.parametrize("n", [1, 2])
def test_train_step_matches_the_jitted_jax_step(two_steps, n):
    arch, mine, ref = two_steps
    (state, loss), (jstate, jloss) = mine[n - 1], ref[n - 1]
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    assert state["step"] == int(jstate["step"]) == n
    for a, b in zip(tree_leaves(state["params"]) + tree_leaves(state["opt"]),
                    jax.tree.leaves(jstate["params"])
                    + jax.tree.leaves(jstate["opt"])):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=PARAM_ATOL,
                                   rtol=PARAM_RTOL)


def test_train_step_leaves_its_input_intact():
    cfg = get_config("wide_deep").SMOKE
    state = steps.init_state("wide_deep", torch.Generator().manual_seed(0),
                             smoke=True)
    copy = [x.clone() for x in tree_leaves(state)
            if isinstance(x, torch.Tensor)]
    steps.build_recsys_train_step(cfg)(state, _torch(_batches(cfg, 8, 1)[0]))
    live = [x for x in tree_leaves(state) if isinstance(x, torch.Tensor)]
    assert all(torch.equal(a, b) for a, b in zip(copy, live))
    assert state["step"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_fifteen_steps_learn(arch):
    """``tests/test_models_recsys.py``'s check on the port's own init: 15
    steps at lr 0.05 on one batch lower the loss."""
    cfg = get_config(arch).SMOKE
    state = steps.init_state(arch, torch.Generator().manual_seed(1),
                             smoke=True)
    batch = _torch(_batches(cfg, 16, 1, seed=2)[0])
    step = steps.build_recsys_train_step(cfg, lr=0.05)
    losses = []
    for _ in range(15):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_bce_is_the_reference_s_at_zero_and_large_logits():
    x = torch.tensor([0.0, 30.0, -30.0, 1.5], requires_grad=True)
    y = torch.tensor([1.0, 0.0, 1.0, 1.0])
    loss = steps.bce_with_logits(x, y)
    loss.backward()

    def ref(xx):
        yy = jnp.asarray(y.numpy())
        return jnp.mean(jnp.maximum(xx, 0) - xx * yy
                        + jnp.log1p(jnp.exp(-jnp.abs(xx))))

    jx = jnp.asarray(x.detach().numpy())
    np.testing.assert_allclose(float(loss.detach()), float(ref(jx)),
                               rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jax.grad(ref)(jx)),
                               rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["xdeepfm", "dien"])
def test_train_cli_losses_match_the_jax_step(arch, tmp_path, monkeypatch,
                                             capsys):
    """The CLI's ``run`` on 3 SMOKE steps from the carried JAX init
    (``--batch 16``: the CLI's own loader, shard 0) against the jitted JAX
    step on the JAX ``recsys_batches``: the same 3 losses."""
    cfg = get_config(arch).SMOKE
    jstate = _jax_state(arch)
    monkeypatch.setattr(train, "init_state",
                        lambda *a, **k: _carry(jstate, cfg))
    args = train.parser().parse_args(
        ["--arch", arch, "--steps", "3", "--batch", "16", "--ckpt-dir",
         str(tmp_path), "--lambda-q", "0.5", "--eval-every", "1"])
    out = train.run(args, CPU)
    printed = capsys.readouterr().out
    assert "(Adagrad)" in printed and "0 skipped" in printed
    assert "eval @" not in printed
    jstep = jax.jit(jax_steps.build_recsys_train_step(jax_config(arch).SMOKE))
    ref = []
    for b in _batches(cfg, 16, 3):
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        ref.append(float(m["loss"]))
    np.testing.assert_allclose(out["losses"], ref, rtol=LOSS_RTOL)
    m = re.search(r"step 3: loss ([-0-9.e]+) \(first ([-0-9.e]+)\)", printed)
    assert m and abs(float(m.group(2)) - ref[0]) < 1e-4
    assert store.latest_step(str(tmp_path)) == 3


@pytest.mark.parametrize("alias", ["dlrm-mlperf", "wide-deep"])
def test_train_cli_main_takes_the_aliases(alias, tmp_path):
    assert train.main(["--arch", alias, "--steps", "2", "--batch", "8",
                       "--device", "cpu", "--ckpt-dir", str(tmp_path)]) == 0


def test_config_from_args_leaves_a_recsys_config_as_it_is():
    args = train.parser().parse_args(
        ["--arch", "wide-deep", "--head-impl", "naive", "--l1-weight", "1"])
    assert train.config_from_args(args) is get_config("wide_deep").SMOKE


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_adagrad_checkpoint_equals_jax_s(arch, tmp_path):
    """One JAX step from the SMOKE init (``acc`` no longer 0.1 everywhere),
    saved by both stores: the same npz keys, arrays and treedef."""
    cfg = get_config(arch).SMOKE
    jstate = _jax_state(arch)
    b = _batches(cfg, 8, 1)[0]
    jstate, _ = jax.jit(jax_steps.build_recsys_train_step(
        jax_config(arch).SMOKE))(jstate, {k: jnp.asarray(v)
                                          for k, v in b.items()})
    jax_store.save_checkpoint(str(tmp_path / "jax"), 1, jstate)
    store.save_checkpoint(str(tmp_path / "port"), 1, _carry(jstate, cfg))
    manifests = [json.loads((tmp_path / side / "step_000000001" /
                             "manifest.json").read_text())
                 for side in ("jax", "port")]
    assert manifests[0] == manifests[1]
    assert "[" in manifests[0]["treedef"] and "'acc'" in manifests[0][
        "treedef"]
    with np.load(tmp_path / "jax" / "step_000000001" / "arrays.npz") as a, \
            np.load(tmp_path / "port" / "step_000000001" / "arrays.npz") as p:
        assert sorted(a.files) == sorted(p.files)
        for key in a.files:
            assert a[key].dtype == p[key].dtype
            np.testing.assert_array_equal(a[key], p[key])
    # and the port resumes the JAX one onto its own template
    template = steps.init_state(arch, torch.Generator().manual_seed(5),
                                smoke=True)
    loaded, step = store.load_checkpoint(str(tmp_path / "jax"), template)
    assert step == 1 and loaded["step"] == 1
    for x, y in zip(tree_leaves(loaded), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(_np(x), np.asarray(y))


def test_resumed_run_equals_an_uninterrupted_one(tmp_path):
    """DIEN's SMOKE through the CLI's loop: 2 steps checkpointed at step
    2, then steps 2-3 run on from the state in memory and, by another
    runner, resumed from the checkpoint (both on a fresh batch stream, as
    the runner replays it): the same bits, the step counter included."""
    cfg = get_config("dien").SMOKE

    def run(state, ckpt_dir, max_steps, *, start=0, resume=False):
        with recsys_loader(cfg, batch=8, device=CPU) as loader:
            runner = make_runner(cfg, state, iter(loader), steps=max_steps,
                                 lr=None, device=CPU,
                                 ckpt_dir=str(ckpt_dir), ckpt_every=2)
            runner.start_step = start
            if resume:
                assert runner.try_resume() and runner.start_step == start
            return runner.run()

    def fresh(seed):
        return steps.init_state("dien", torch.Generator().manual_seed(seed),
                                smoke=True)

    at_2 = run(fresh(3), tmp_path / "a", 2)
    on = run(at_2, tmp_path / "b", 4, start=2)
    resumed = run(fresh(4), tmp_path / "a", 4, start=2, resume=True)
    assert on["step"] == resumed["step"] == 4
    for x, y in zip(tree_leaves(on), tree_leaves(resumed)):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))
