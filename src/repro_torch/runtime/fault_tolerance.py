"""Fault-tolerant training runtime (``repro/runtime/fault_tolerance.py``):
checkpoint/restart, stragglers, elastic re-mesh.

* **Checkpoint/restart** — async atomic checkpoints every N steps and at
  the end (``repro_torch.checkpoint``); ``try_resume`` loads the latest
  valid step.
* **Straggler mitigation** — every step runs under a deadline (EWMA of
  recent step times × slack). A step past it is retried from the same
  state; a second miss, or an exception, skips the step (it consumes a
  batch but makes no update) and counts a strike. Persistent strikes
  trigger a re-mesh.
* **Elastic re-mesh** — ``ElasticMeshManager`` works out the largest
  supported (pod, data, model) factorization of a device count; the mesh
  itself comes from an injected ``make_mesh``.

The policy is the JAX runner's, decision for decision. Two places are
particular to CUDA. A step's time is read after the device of the new
state has finished (``torch.cuda.synchronize``), where the JAX runner
blocks on the state: PyTorch returns once the work is queued. And since
the runner also turns any exception of a step into a skipped step, as
the reference does, it records each as ``(step, repr)`` in ``errors``,
so that its caller can refuse a run in which a kernel failed to build or
launch. Once a step has raised, the runner publishes no checkpoint, the
final one included: the reference labels its final checkpoint
``max_steps`` all the same, so a resume would run no step and hide the
failure, where here it goes back to the last checkpoint written before
the error and trains the lost steps again. A retry re-runs ``step_fn`` on the state it kept, so a step must
never update its input in place.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint.store import (AsyncCheckpointer, latest_step,
                                          load_checkpoint)
from repro_torch.tree import tree_leaves

Tree = Any


@dataclasses.dataclass
class StragglerPolicy:
    slack: float = 3.0           # deadline = slack * EWMA step time
    ewma_alpha: float = 0.1
    min_deadline_s: float = 1.0
    max_retries: int = 1
    suspect_threshold: int = 3   # suspect marks before demanding re-mesh


@dataclasses.dataclass
class RunnerConfig:
    ckpt_dir: str
    ckpt_every: int = 100
    keep_ckpts: int = 3
    max_steps: int = 1000
    straggler: StragglerPolicy = dataclasses.field(
        default_factory=StragglerPolicy)
    log_every: int = 10


class ElasticMeshManager:
    """Owns mesh (re)construction under changing device counts.

    ``factorize(n)`` picks the largest (pod, data, model) with
    pod*data*model == usable <= n, preferring to keep the model axis and
    power-of-two axes.
    """

    def __init__(self, make_mesh: Callable[[Tuple[int, ...]], Any],
                 *, model_axis: int = 16):
        self.make_mesh = make_mesh
        self.model_axis = model_axis

    def factorize(self, n_devices: int) -> Tuple[int, int, int]:
        model = self.model_axis
        while model > 1 and n_devices < model:
            model //= 2
        rest = n_devices // model
        # largest power of two <= rest for the data axis
        data = 1 << (max(rest, 1).bit_length() - 1)
        pod = 1  # pods collapse into data when devices are lost
        return (pod, data, model)

    def build(self, n_devices: int):
        shape = self.factorize(n_devices)
        return self.make_mesh(shape), shape


class _StepClock:
    def __init__(self, policy: StragglerPolicy):
        self.policy = policy
        self.ewma: Optional[float] = None

    def deadline(self) -> float:
        if self.ewma is None:
            return float("inf")  # first step: no baseline yet
        return max(self.policy.min_deadline_s,
                   self.policy.slack * self.ewma)

    def record(self, dt: float) -> None:
        a = self.policy.ewma_alpha
        self.ewma = dt if self.ewma is None else (1 - a) * self.ewma + a * dt


def block_until_ready(state: Tree) -> Tree:
    """Wait for the devices of ``state``'s CUDA tensors to finish."""
    devices = {x.device for x in tree_leaves(state)
               if isinstance(x, torch.Tensor) and x.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return state


class FaultTolerantRunner:
    """Drives (state, batch) -> (state, metrics) steps with FT policy.

    Parameters
    ----------
    step_fn: the train step; it returns a new state and leaves its input
      as it was.
    state: initial train state (params, opt state, step).
    batches: iterator of host batches.
    place_batch: host batch -> device tensors.
    config: RunnerConfig.
    on_remesh: optional callback(state) -> (step_fn, state) invoked when
      the straggler policy demands a re-mesh.
    on_step: optional callback(step, state) invoked after every
      *successful* step (skipped/straggled steps don't fire it). A
      returned non-empty dict is appended to ``metrics_log`` as its own
      ``{"step": step, **extras}`` entry. Exceptions propagate.
    clock: seconds, monotonic.

    After ``run``: ``skipped_steps``, ``remesh_events``, ``metrics_log``
    and ``errors``, the ``(step, repr)`` of every exception a step raised;
    no checkpoint was written from the first of them on.
    """

    def __init__(
        self,
        step_fn: Callable[[Tree, Tree], Tuple[Tree, Dict[str, Any]]],
        state: Tree,
        batches,
        *,
        config: RunnerConfig,
        place_batch: Callable[[Any], Tree] = lambda b: b,
        on_remesh: Optional[Callable[[Tree], Tuple[Callable, Tree]]] = None,
        on_step: Optional[Callable[[int, Tree],
                                   Optional[Dict[str, Any]]]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.step_fn = step_fn
        self.state = state
        self.batches = batches
        self.config = config
        self.place_batch = place_batch
        self.on_remesh = on_remesh
        self.on_step = on_step
        self.clock = clock
        self._step_clock = _StepClock(config.straggler)
        self._ckpt = AsyncCheckpointer(config.ckpt_dir,
                                       keep=config.keep_ckpts)
        self.start_step = 0
        self.suspect_strikes = 0
        self.skipped_steps: List[int] = []
        self.remesh_events: List[int] = []
        self.metrics_log: List[Dict[str, Any]] = []
        self.errors: List[Tuple[int, str]] = []

    # -- resume ----------------------------------------------------------
    def try_resume(self) -> bool:
        step = latest_step(self.config.ckpt_dir)
        if step is None:
            return False
        self.state, self.start_step = load_checkpoint(
            self.config.ckpt_dir, self.state)
        return True

    # -- main loop --------------------------------------------------------
    def run(self) -> Tree:
        cfg = self.config
        step = self.start_step
        while step < cfg.max_steps:
            batch = next(self.batches)
            placed = self.place_batch(batch)
            ok, metrics = self._attempt_step(placed, step)
            if not ok:
                self.skipped_steps.append(step)
                self.suspect_strikes += 1
                if (self.suspect_strikes
                        >= cfg.straggler.suspect_threshold
                        and self.on_remesh is not None):
                    self.step_fn, self.state = self.on_remesh(self.state)
                    self.remesh_events.append(step)
                    self.suspect_strikes = 0
                step += 1
                continue
            self.suspect_strikes = 0
            if cfg.log_every and step % cfg.log_every == 0:
                self.metrics_log.append({"step": step, **metrics})
            if self.on_step is not None:
                extras = self.on_step(step, self.state)
                if extras:
                    self.metrics_log.append({"step": step, **extras})
            step += 1
            if (cfg.ckpt_every and step % cfg.ckpt_every == 0
                    and not self.errors):
                self._ckpt.save(step, self.state)
        if not self.errors:
            self._ckpt.save(cfg.max_steps, self.state)
        self._ckpt.close()
        return self.state

    def _attempt_step(self, placed_batch, step: int
                      ) -> Tuple[bool, Dict[str, Any]]:
        deadline = self._step_clock.deadline()
        for _ in range(1 + self.config.straggler.max_retries):
            t0 = self.clock()
            try:
                new_state, metrics = self.step_fn(self.state, placed_batch)
                new_state = block_until_ready(new_state)
            except Exception as e:  # a lost device raises here too
                self.errors.append((step, repr(e)))
                return False, {"error": repr(e)}
            dt = self.clock() - t0
            if dt <= deadline:
                self._step_clock.record(dt)
                self.state = new_state
                m = dict(metrics)
                m["step_time_s"] = dt
                return True, m
            # straggler: discard result, retry once with fresh deadline
        return False, {"straggler": True, "deadline_s": deadline}
