"""The port's fault-tolerant runner against the JAX package's, on the CPU.

Every runner case of ``tests/test_runtime.py`` with the same fake clocks
on torch states, and each scenario's decisions (``skipped_steps``,
``remesh_events``, the steps of ``metrics_log``, the final counter) held
equal to the JAX runner's on the same durations. Then the real train
step under the runner: a retried step re-runs from unchanged params and
gives the same bits as a run without the retry; a step that raises makes
the train CLI exit non-zero and publishes no checkpoint (JAX's runner
still writes one labelled ``max_steps``, the one decision where the two
differ), so a resume trains the lost steps again; a resumed run matches JAX's from one
carried state (f32 compute: loss rtol 1e-5, params atol 1e-5, the
tolerances of ``test_torch_train.py``); the two CLIs resume each other's
checkpoints (bf16 compute: the resumed run's first loss within the 2e-2
of ``test_train_cli_first_loss_matches_jax_cli``). Runs on the real
clock take a 60 s floor under the deadline, so that a loaded test
machine does not skip a step.
"""

import dataclasses
import itertools
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jax_store
from repro.configs.splade_bert import SMOKE as JAX_SMOKE
from repro.data import synthetic as jax_data
from repro.launch import steps as jax_steps
from repro.runtime import fault_tolerance as jax_ft
from repro_torch.checkpoint.store import latest_step, load_checkpoint
from repro_torch.configs.splade_bert import SMOKE
from repro_torch.launch import steps
from repro_torch.launch import train as cli
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.runtime.fault_tolerance import (ElasticMeshManager,
                                                 FaultTolerantRunner,
                                                 RunnerConfig,
                                                 StragglerPolicy)
from repro_torch.tree import tree_leaves
from repro_torch.weights import state_from_jax

CPU = torch.device("cpu")
PATIENT = StragglerPolicy(min_deadline_s=60.0)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _counting_step(durations, clock):
    """A step whose (fake) duration comes from `durations`."""
    it = iter(durations)

    def step(state, batch):
        clock.advance(next(it, 0.1))
        return {"n": state["n"] + 1}, {"loss": 1.0 / (state["n"] + 1)}
    return step


def _batches():
    return itertools.repeat({"x": torch.zeros((2,))})


def _n0():
    return {"n": torch.tensor(0)}


def test_runner_runs_and_checkpoints(tmp_path):
    clock = FakeClock()
    runner = FaultTolerantRunner(
        _counting_step([0.1] * 100, clock), _n0(), _batches(),
        config=RunnerConfig(ckpt_dir=str(tmp_path), ckpt_every=4,
                            max_steps=10, log_every=1),
        clock=clock)
    state = runner.run()
    assert int(state["n"]) == 10
    assert len(runner.metrics_log) == 10
    assert runner.skipped_steps == [] and runner.errors == []
    assert latest_step(str(tmp_path)) == 10
    restored, step = load_checkpoint(str(tmp_path), _n0(), step=8)
    assert step == 8 and int(restored["n"]) == 8


def test_runner_on_step_hook(tmp_path):
    """on_step fires after every successful step with the fresh state;
    a non-empty returned dict lands in metrics_log as its own entry."""
    clock = FakeClock()
    seen = []

    def hook(step, state):
        seen.append((step, int(state["n"])))
        return {"eval_x": step * 10} if step % 3 == 0 else None

    runner = FaultTolerantRunner(
        _counting_step([0.1] * 100, clock), _n0(), _batches(),
        config=RunnerConfig(ckpt_dir=str(tmp_path), ckpt_every=0,
                            max_steps=6, log_every=0),
        on_step=hook, clock=clock)
    runner.run()
    assert seen == [(i, i + 1) for i in range(6)]
    assert runner.metrics_log == [{"step": 0, "eval_x": 0},
                                  {"step": 3, "eval_x": 30}]


def test_runner_on_step_skipped_on_straggler(tmp_path):
    """Straggled (skipped) steps must not fire the hook."""
    clock = FakeClock()
    fired = []
    # steps 0/1 fast (build EWMA), step 2 slow twice (retry + skip)
    durations = [0.1, 0.1, 9.0, 9.0] + [0.1] * 10
    runner = FaultTolerantRunner(
        _counting_step(durations, clock), _n0(), _batches(),
        config=RunnerConfig(
            ckpt_dir=str(tmp_path), ckpt_every=0, max_steps=5,
            log_every=0,
            straggler=StragglerPolicy(slack=2.0, min_deadline_s=0.05)),
        on_step=lambda s, st: fired.append(s),
        clock=clock)
    runner.run()
    assert runner.skipped_steps == [2]
    assert fired == [0, 1, 3, 4]


def test_runner_resume(tmp_path):
    clock = FakeClock()
    cfg = RunnerConfig(ckpt_dir=str(tmp_path), ckpt_every=5, max_steps=5)
    r1 = FaultTolerantRunner(_counting_step([0.1] * 50, clock), _n0(),
                             _batches(), config=cfg, clock=clock)
    r1.run()
    # second run resumes at 5 and continues to 8
    cfg2 = RunnerConfig(ckpt_dir=str(tmp_path), ckpt_every=100,
                        max_steps=8)
    r2 = FaultTolerantRunner(_counting_step([0.1] * 50, clock), _n0(),
                             _batches(), config=cfg2, clock=clock)
    assert r2.try_resume()
    assert r2.start_step == 5
    state = r2.run()
    assert int(state["n"]) == 8


def test_straggler_detection_and_skip(tmp_path):
    clock = FakeClock()
    # establish ~0.1s EWMA, then two huge stalls (initial + retry) => skip
    durations = [0.1] * 5 + [99.0, 99.0] + [0.1] * 20
    policy = StragglerPolicy(slack=3.0, max_retries=1,
                             suspect_threshold=100)
    runner = FaultTolerantRunner(
        _counting_step(durations, clock), _n0(), _batches(),
        config=RunnerConfig(ckpt_dir=str(tmp_path), ckpt_every=0,
                            max_steps=10, straggler=policy),
        clock=clock)
    state = runner.run()
    assert runner.skipped_steps == [5]
    # the skipped step consumed a batch but not an update
    assert int(state["n"]) == 9
    assert runner.errors == []


def test_remesh_triggered_after_repeated_suspects(tmp_path):
    clock = FakeClock()
    durations = [0.1] * 3 + [50.0, 50.0] * 3 + [0.1] * 30
    policy = StragglerPolicy(slack=3.0, max_retries=1, suspect_threshold=3)
    remesh_calls = []

    def on_remesh(state):
        remesh_calls.append(True)
        return _counting_step([0.1] * 50, clock), state

    runner = FaultTolerantRunner(
        _counting_step(durations, clock), _n0(), _batches(),
        config=RunnerConfig(ckpt_dir=str(tmp_path), ckpt_every=0,
                            max_steps=12, straggler=policy),
        on_remesh=on_remesh, clock=clock)
    runner.run()
    assert len(remesh_calls) == 1
    assert len(runner.remesh_events) == 1


def test_step_exception_counts_as_failure(tmp_path):
    clock = FakeClock()
    calls = {"n": 0}

    def flaky(state, batch):
        calls["n"] += 1
        clock.advance(0.1)
        if calls["n"] == 3:
            raise RuntimeError("device lost")
        return {"n": state["n"] + 1}, {"loss": 0.0}

    runner = FaultTolerantRunner(
        flaky, _n0(), _batches(),
        config=RunnerConfig(ckpt_dir=str(tmp_path), ckpt_every=0,
                            max_steps=6),
        clock=clock)
    state = runner.run()
    assert len(runner.skipped_steps) == 1
    assert int(state["n"]) == 5
    assert runner.errors == [(2, "RuntimeError('device lost')")]
    # the final checkpoint is not published after a step raised
    assert latest_step(str(tmp_path)) is None


def test_elastic_mesh_factorization():
    mgr = ElasticMeshManager(lambda shape: shape, model_axis=16)
    assert mgr.factorize(512) == (1, 32, 16)
    assert mgr.factorize(256) == (1, 16, 16)
    assert mgr.factorize(255) == (1, 8, 16)   # lost a device
    assert mgr.factorize(24) == (1, 1, 16)
    assert mgr.factorize(8) == (1, 1, 8)
    assert mgr.factorize(1) == (1, 1, 1)
    for n in range(1, 600):
        assert mgr.factorize(n) == jax_ft.ElasticMeshManager(
            lambda shape: shape, model_axis=16).factorize(n)


# ---------------------------------------------------------------------------
# the same scenarios through both runners
# ---------------------------------------------------------------------------

SCENARIOS = {  # name: (durations, RunnerConfig kwargs, StragglerPolicy
    #                    kwargs, extras: "hook", "remesh", "flaky_call")
    "checkpoints": ([0.1] * 100, dict(ckpt_every=4, max_steps=10,
                                      log_every=1), {}, {}),
    "on_step_hook": ([0.1] * 100, dict(ckpt_every=0, max_steps=6,
                                       log_every=0), {}, {"hook": True}),
    "hook_skipped_on_straggler": (
        [0.1, 0.1, 9.0, 9.0] + [0.1] * 10,
        dict(ckpt_every=0, max_steps=5, log_every=0),
        dict(slack=2.0, min_deadline_s=0.05), {"hook": True}),
    "straggler_skip": ([0.1] * 5 + [99.0, 99.0] + [0.1] * 20,
                       dict(ckpt_every=0, max_steps=10),
                       dict(slack=3.0, max_retries=1,
                            suspect_threshold=100), {}),
    "retry_then_pass": ([0.1] * 4 + [9.0, 0.1] + [0.1] * 20,
                        dict(ckpt_every=3, max_steps=10, log_every=2),
                        dict(slack=3.0, min_deadline_s=0.05), {}),
    "remesh": ([0.1] * 3 + [50.0, 50.0] * 3 + [0.1] * 30,
               dict(ckpt_every=0, max_steps=12),
               dict(slack=3.0, max_retries=1, suspect_threshold=3),
               {"remesh": True}),
    "exception": ([0.1] * 100, dict(ckpt_every=0, max_steps=6), {},
                  {"flaky_call": 3}),
    "no_retries": ([0.1] * 4 + [9.0] + [0.1] * 20,
                   dict(ckpt_every=5, max_steps=9, log_every=3),
                   dict(max_retries=0, min_deadline_s=0.05,
                        suspect_threshold=1), {"remesh": True}),
}

PACKAGES = {  # runner module, a state {"n": 0}, its counter as an int
    "jax": (jax_ft, lambda: {"n": jnp.array(0)}, lambda s: int(s["n"])),
    "port": (ft, _n0, lambda s: int(s["n"])),
}


def _drive(pkg, scenario, ckpt_dir):
    mod, n0, count = PACKAGES[pkg]
    durations, cfg_kw, policy_kw, extra = SCENARIOS[scenario]
    clock = FakeClock()
    step = _counting_step(durations, clock)
    if "flaky_call" in extra:
        calls = {"n": 0}
        inner = step

        def step(state, batch):
            calls["n"] += 1
            if calls["n"] == extra["flaky_call"]:
                clock.advance(0.1)
                raise RuntimeError("device lost")
            return inner(state, batch)

    hook = None
    if extra.get("hook"):
        def hook(s, st):
            return {"eval_x": s * 10} if s % 3 == 0 else None
    remesh = None
    if extra.get("remesh"):
        def remesh(state):
            return _counting_step([0.1] * 50, clock), state
    runner = mod.FaultTolerantRunner(
        step, n0(), itertools.repeat({"x": np.zeros((2,), np.float32)}),
        config=mod.RunnerConfig(ckpt_dir=ckpt_dir, **cfg_kw,
                                straggler=mod.StragglerPolicy(**policy_kw)),
        on_step=hook, on_remesh=remesh, clock=clock)
    state = runner.run()
    return {"skipped": runner.skipped_steps, "remesh": runner.remesh_events,
            "logged": [(m["step"], sorted(m)) for m in runner.metrics_log],
            "n": count(state), "ckpt": latest_step(ckpt_dir)}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_runner_decisions_match_jax(scenario, tmp_path):
    got = _drive("port", scenario, str(tmp_path / "port"))
    want = _drive("jax", scenario, str(tmp_path / "jax"))
    if "flaky_call" in SCENARIOS[scenario][3]:
        # where a step raised, JAX still labels a final checkpoint
        # max_steps; the port publishes none from the error on
        assert want["ckpt"] == SCENARIOS[scenario][1]["max_steps"]
        want["ckpt"] = None
    assert got == want


# ---------------------------------------------------------------------------
# the train step under the runner
# ---------------------------------------------------------------------------

def _jax_state():
    state, _ = jax_steps.init_state("splade_bert", jax.random.PRNGKey(0),
                                    smoke=True)
    return state


def _pairs(n, batch=4):
    return list(itertools.islice(jax_data.lsr_pair_batches(
        batch=batch, q_len=12, d_len=16, vocab=SMOKE.vocab_size), n))


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _tensors(state):
    return tree_leaves({"params": state["params"], "opt": state["opt"]})


def test_retried_step_reruns_from_unchanged_params(tmp_path):
    """A step that misses its deadline is run again on the state the
    runner kept: the step leaves its input as it was, and the run ends
    with the same bits as one without the retry."""
    cfg = dataclasses.replace(SMOKE, compute_dtype="float32")
    base = state_from_jax(jax.tree.map(np.asarray, _jax_state()), cfg, "cpu")
    train_step = steps.build_lsr_train_step(cfg, lr=0.5)
    batches = [_torch_batch(b) for b in _pairs(4)]
    inputs_kept = []

    def run(durations, where):
        clock = FakeClock()
        it = iter(durations)

        def step(state, batch):
            before = [x.clone() for x in _tensors(state)]
            out = train_step(state, batch)
            inputs_kept.append(all(torch.equal(a, b) for a, b in zip(
                before, _tensors(state), strict=True)))
            clock.advance(next(it))
            return out

        runner = FaultTolerantRunner(
            step, base, iter(batches),
            config=RunnerConfig(ckpt_dir=str(tmp_path / where),
                                ckpt_every=0, max_steps=4, log_every=1),
            clock=clock)
        return runner, runner.run()

    straight, s_state = run([0.1] * 4, "straight")
    retried, r_state = run([0.1, 0.1, 9.0, 0.1, 0.1], "retried")
    assert straight.errors == retried.errors == []
    assert straight.skipped_steps == retried.skipped_steps == []
    assert len(inputs_kept) == 9 and all(inputs_kept)
    assert r_state["step"] == s_state["step"] == 4
    for a, b in zip(_tensors(r_state), _tensors(s_state), strict=True):
        assert torch.equal(a, b)
    assert [float(m["loss"]) for m in retried.metrics_log] == \
        [float(m["loss"]) for m in straight.metrics_log]


def test_resumed_run_matches_the_jax_runner_from_a_carried_state(tmp_path):
    """Both runners resume from one JAX-written checkpoint at step 2 and
    run steps 2 and 3 at f32 compute on a fresh stream (batches 0 and 1
    again): the losses and the params at step 4 agree."""
    cfg_j = dataclasses.replace(JAX_SMOKE, compute_dtype="float32",
                                head_impl="jax")
    cfg_t = dataclasses.replace(SMOKE, compute_dtype="float32")
    j_step = jax.jit(jax_steps.build_lsr_train_step(
        cfg_j, None, n_micro=1, n_pairs=4, lr=0.5))
    pairs = _pairs(2)

    def jax_runner(ckpt_dir, max_steps, state):
        return jax_ft.FaultTolerantRunner(
            j_step, state, iter(pairs),
            config=jax_ft.RunnerConfig(
                ckpt_dir=ckpt_dir, ckpt_every=2, max_steps=max_steps,
                log_every=1,
                straggler=jax_ft.StragglerPolicy(min_deadline_s=60.0)),
            place_batch=lambda b: {k: jnp.asarray(v) for k, v in b.items()})

    jax_runner(str(tmp_path / "jax"), 2, _jax_state()).run()
    shutil.copytree(tmp_path / "jax", tmp_path / "port")

    j_run = jax_runner(str(tmp_path / "jax"), 4, _jax_state())
    assert j_run.try_resume() and j_run.start_step == 2
    j_final = j_run.run()

    template = steps.init_state("splade_bert",
                                torch.Generator().manual_seed(1), smoke=True)
    t_run = FaultTolerantRunner(
        steps.build_lsr_train_step(cfg_t, lr=0.5), template, iter(pairs),
        config=RunnerConfig(ckpt_dir=str(tmp_path / "port"), ckpt_every=2,
                            max_steps=4, log_every=1, straggler=PATIENT),
        place_batch=_torch_batch)
    assert t_run.try_resume() and t_run.start_step == 2
    t_final = t_run.run()

    assert t_run.skipped_steps == j_run.skipped_steps == []
    assert [m["step"] for m in t_run.metrics_log] == [2, 3]
    np.testing.assert_allclose(
        [float(m["loss"]) for m in t_run.metrics_log],
        [float(m["loss"]) for m in j_run.metrics_log], rtol=1e-5)
    assert t_final["step"] == int(j_final["step"]) == 4
    for got, want in zip(tree_leaves(t_final["params"]),
                         jax.tree.leaves(j_final["params"]), strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
    # and each package's final checkpoint loads in the other's store
    back, step = jax_store.load_checkpoint(
        str(tmp_path / "port"), jax.tree.map(jnp.zeros_like, _jax_state()))
    assert step == 4
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(
            {**t_final, "step": np.int32(4)}), strict=True):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------

FLAGS = ["--arch", "splade_bert", "--batch", "2", "--seq-len", "16"]
LOSS_LINE = r"step (\d+): loss ([-0-9.e]+) \(first ([-0-9.e]+)\)"


def test_cli_exits_non_zero_when_a_step_raises(tmp_path, monkeypatch,
                                               capsys):
    build = cli.build_lsr_train_step

    def failing_build(cfg, **kw):
        step, calls = build(cfg, **kw), []

        def fails_second(state, batch):
            calls.append(1)
            if len(calls) == 2:
                raise RuntimeError("kernel did not launch")
            return step(state, batch)
        return fails_second

    monkeypatch.setattr(cli, "build_lsr_train_step", failing_build)
    rc = cli.main(FLAGS + ["--steps", "3", "--device", "cpu", "--ckpt-dir",
                           str(tmp_path)])
    out, err = capsys.readouterr()
    assert rc != 0
    assert "step 1: RuntimeError('kernel did not launch')" in err
    assert "1 skipped" in out


def test_cli_resume_after_a_step_raised_trains_the_lost_steps(
        tmp_path, monkeypatch, capsys):
    """A step that raises in a run of 4 steps with --ckpt-every 2 leaves
    only step 2 on disk and exits non-zero; --resume then goes back to
    step 2 and trains steps 3 and 4 again."""
    build = cli.build_lsr_train_step

    def failing_build(cfg, **kw):
        step, calls = build(cfg, **kw), []

        def fails_third(state, batch):
            calls.append(1)
            if len(calls) == 3:
                raise RuntimeError("kernel did not launch")
            return step(state, batch)
        return fails_third

    args = FLAGS + ["--steps", "4", "--device", "cpu", "--ckpt-dir",
                    str(tmp_path), "--ckpt-every", "2"]
    monkeypatch.setattr(cli, "build_lsr_train_step", failing_build)
    assert cli.main(args) != 0
    assert "step 2: RuntimeError('kernel did not launch')" in (
        capsys.readouterr().err)
    assert [p.name for p in tmp_path.iterdir()] == ["step_000000002"]
    monkeypatch.setattr(cli, "build_lsr_train_step", build)
    again = cli.run(cli.parser().parse_args(args + ["--resume"]), CPU)
    assert "resumed from step 2" in capsys.readouterr().out
    assert again["start_step"] == 2 and again["state"]["step"] == 4
    assert len(again["losses"]) == 2 and again["skipped"] == []


def test_cli_resumes_from_its_checkpoint(tmp_path, capsys):
    """--ckpt-every 2 over 3 steps writes steps 2 and 3; --resume --steps
    5 goes on from 3, replaying the stream from its first batch."""
    args = FLAGS + ["--device", "cpu", "--ckpt-dir", str(tmp_path),
                    "--ckpt-every", "2"]
    first = cli.run(cli.parser().parse_args(args + ["--steps", "3"]), CPU)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_000000002", "step_000000003"]
    capsys.readouterr()
    again = cli.run(cli.parser().parse_args(
        args + ["--steps", "5", "--resume"]), CPU)
    out = capsys.readouterr().out
    assert "resumed from step 3" in out
    assert again["start_step"] == 3 and again["state"]["step"] == 5
    assert len(again["losses"]) == 2
    m = re.search(LOSS_LINE, out)
    assert m.group(1) == "5"
    # the stream starts over: batch 0 again, from the resumed state
    replay = steps.build_lsr_train_step(SMOKE, lr=2e-4)(
        first["state"], _torch_batch(next(jax_data.lsr_pair_batches(
            batch=2, q_len=16, d_len=16, vocab=SMOKE.vocab_size))))
    assert again["losses"][0] == float(replay[1]["loss"])
    saved, _ = load_checkpoint(str(tmp_path), first["state"], step=3)
    assert saved["step"] == 3
    for a, b in zip(_tensors(saved), _tensors(first["state"]), strict=True):
        assert torch.equal(a, b)


def test_cli_resumes_the_jax_cli_checkpoint(tmp_path, capsys):
    """The JAX CLI writes step 2; the port CLI and the JAX CLI each resume
    it to step 4 and print ``resumed from step 2``. The port's first loss
    after resuming is the JAX step's on the same state and batch (bf16
    compute), and both final states moved alike from step 2."""
    from repro.launch.train import main as jax_main

    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    assert jax_main(FLAGS + ["--steps", "2", "--ckpt-dir", str(jax_dir),
                             "--ckpt-every", "2"]) == 0
    shutil.copytree(jax_dir, port_dir)
    capsys.readouterr()
    s2, _ = jax_store.load_checkpoint(
        str(jax_dir), jax.tree.map(jnp.zeros_like, _jax_state()), step=2)

    assert cli.main(FLAGS + ["--steps", "4", "--resume", "--device", "cpu",
                             "--ckpt-dir", str(port_dir)]) == 0
    port_out = capsys.readouterr().out
    assert jax_main(FLAGS + ["--steps", "4", "--resume", "--ckpt-dir",
                             str(jax_dir)]) == 0
    jax_out = capsys.readouterr().out
    assert "resumed from step 2" in port_out
    assert "resumed from step 2" in jax_out
    assert "done: 4 steps" in port_out and "done: 4 steps" in jax_out

    b0 = next(jax_data.lsr_pair_batches(batch=2, q_len=16, d_len=16,
                                        vocab=SMOKE.vocab_size))
    j_step = jax.jit(jax_steps.build_lsr_train_step(
        JAX_SMOKE, None, n_micro=1, n_pairs=2, lr=2e-4))
    _, jm = j_step(s2, {k: jnp.asarray(v) for k, v in b0.items()})
    first = float(re.search(LOSS_LINE, port_out).group(3))
    np.testing.assert_allclose(first, float(jm["loss"]), rtol=2e-2)

    template = jax.tree.map(jnp.zeros_like, _jax_state())
    j4, step_j = jax_store.load_checkpoint(str(jax_dir), template)
    t4, step_t = jax_store.load_checkpoint(str(port_dir), template)
    assert step_j == step_t == 4 and int(j4["step"]) == int(t4["step"]) == 4
    for p2, pj, pt in zip(jax.tree.leaves(s2["params"]),
                          jax.tree.leaves(j4["params"]),
                          jax.tree.leaves(t4["params"]), strict=True):
        u_j = np.asarray(pj) - np.asarray(p2)
        u_t = np.asarray(pt) - np.asarray(p2)
        assert np.linalg.norm(u_t - u_j) <= 0.5 * np.linalg.norm(u_j)


def test_example_trains_and_probes_on_the_cpu(tmp_path, capsys):
    from repro_torch.examples import train_splade

    args = train_splade.parser().parse_args(
        ["--device", "cpu", "--ckpt-dir", str(tmp_path)])
    res = train_splade.run(args, CPU)
    assert [s for s, _ in res["losses"]] == list(range(0, 200, 20))
    assert res["losses"][-1][1] < res["losses"][0][1]
    assert res["skipped"] == [] and 0.0 <= res["acc"] <= 1.0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_000000100", "step_000000150", "step_000000200"]
    assert "in-batch retrieval acc@1" in capsys.readouterr().out
