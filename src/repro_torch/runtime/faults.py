"""Deterministic fault injection for the serving runtime
(``repro/runtime/faults.py``).

Every hardening behaviour of ``runtime/serving.py`` (bisect isolation of
poison batches, the OOM-driven batch cap, shedding under latency spikes)
is testable without a card and without flaky randomness.
``FaultInjector`` wraps any callable (the encode fn, a search fn) with a
*plan*: a list of plain dicts, each naming a trigger, an action and a
budget. The plan format, its validation messages, ``log`` and ``calls``
and the seeded ``prob`` stream are the JAX package's, so one plan fires
on the same calls in both packages.

Plan format, one dict per rule::

    {"on":  {"call": 5}              # the 5th call (0-based), or
            {"every": 7}             # every 7th call (calls 6, 13, ...), or
            {"token": 17}            # any element of arg 0 equals 17, or
            {"prob": 0.05},          # seeded Bernoulli per call
     "do":  "raise" | "delay",       # default "raise"
     "exc": "fault" | "transient" | "oom",   # default "fault"
     "times": 3,                     # fire at most 3 times; None/absent
                                     # = persistent (fires forever)
     "delay_s": 0.02}                # only for "do": "delay"

* ``"token"`` is the poison-request trigger: a persistent token rule fails
  every batch holding that request, the case the loop's bisect isolation
  must survive. Arg 0 may be a numpy array or a torch tensor on any
  device (a tensor is copied to the host for the test).
* ``"times": 1`` models a transient fault: the bisect retry serves the
  whole batch.
* ``"exc": "oom"`` raises :class:`ResourceExhausted`, which
  ``is_oom_error`` recognises, so the loop halves its batch cap.
* ``"prob"`` draws from ``numpy.random.default_rng(seed + rule index)``,
  one draw per call whatever the other rules do.

``"delay"`` rules call the injected ``sleep`` (a fake clock's ``advance``
in tests, ``time.sleep`` by default) and then fall through to the wrapped
fn: a latency spike, not a failure.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class FaultError(RuntimeError):
    """Base class for injected failures."""


class TransientFault(FaultError):
    """A failure expected to heal on retry (network blip, preemption)."""


class ResourceExhausted(FaultError):
    """OOM-shaped: the device pushed back on the batch size."""


_EXC: Dict[str, type] = {
    "fault": FaultError,
    "transient": TransientFault,
    "oom": ResourceExhausted,
}

# Markers accelerator stacks put in OOM errors (XLA's RESOURCE_EXHAUSTED,
# CUDA's "out of memory"), matched on the type name and message.
_OOM_MARKERS = ("resource_exhausted", "resourceexhausted",
                "out of memory", "oom")


def is_oom_error(e: BaseException) -> bool:
    """Does this exception look like the device ran out of memory?"""
    if isinstance(e, (ResourceExhausted, torch.cuda.OutOfMemoryError)):
        return True
    text = f"{type(e).__name__}: {e}".lower()
    return any(m in text for m in _OOM_MARKERS)


_TRIGGERS = ("call", "every", "token", "prob")


@dataclasses.dataclass
class _Rule:
    on: Dict[str, Any]
    do: str
    exc: str
    times: Optional[int]
    delay_s: float
    rng: Optional[np.random.Generator]
    fired: int = 0

    @property
    def exhausted(self) -> bool:
        return self.times is not None and self.fired >= self.times


def _compile(plan: Sequence[Dict[str, Any]], seed: int) -> List[_Rule]:
    rules = []
    for ri, spec in enumerate(plan):
        on = dict(spec.get("on", {}))
        trigger = [t for t in _TRIGGERS if t in on]
        if len(trigger) != 1:
            raise ValueError(
                f"rule {ri}: 'on' needs exactly one of {_TRIGGERS}, "
                f"got {sorted(on)}")
        do = spec.get("do", "raise")
        if do not in ("raise", "delay"):
            raise ValueError(f"rule {ri}: unknown do={do!r}")
        exc = spec.get("exc", "fault")
        if exc not in _EXC:
            raise ValueError(f"rule {ri}: unknown exc={exc!r} "
                             f"(one of {sorted(_EXC)})")
        rng = (np.random.default_rng(seed + ri)
               if trigger[0] == "prob" else None)
        rules.append(_Rule(on=on, do=do, exc=exc, times=spec.get("times"),
                           delay_s=float(spec.get("delay_s", 0.0)), rng=rng))
    return rules


def _holds(arg, token) -> bool:
    """Does any element of ``arg`` equal ``token``? A tensor is compared
    on the host."""
    if isinstance(arg, torch.Tensor):
        return bool((arg.detach().cpu() == token).any())
    return bool(np.any(np.asarray(arg) == token))


class FaultInjector:
    """Wrap ``fn`` with a deterministic fault plan (module docstring).

    Call-compatible with the wrapped fn. ``calls`` counts invocations,
    ``log`` records ``(call_idx, rule_idx, action)`` for every firing.
    """

    def __init__(self, fn: Callable[..., Any],
                 plan: Sequence[Dict[str, Any]], *, seed: int = 0,
                 sleep: Optional[Callable[[float], None]] = None):
        self.fn = fn
        self.rules = _compile(plan, seed)
        self.sleep = sleep if sleep is not None else time.sleep
        self.calls = 0
        self.log: List[Tuple[int, int, str]] = []

    def _matches(self, rule: _Rule, call_idx: int, first_arg) -> bool:
        on = rule.on
        if "call" in on:
            return call_idx == int(on["call"])
        if "every" in on:
            n = int(on["every"])
            return n > 0 and (call_idx + 1) % n == 0
        if "token" in on:
            return first_arg is not None and _holds(first_arg, on["token"])
        if "prob" in on:
            # always consume a draw so the stream stays aligned with the
            # call index whatever the other rules do
            return bool(rule.rng.random() < float(on["prob"]))
        return False

    def __call__(self, *args, **kwargs):
        call_idx = self.calls
        self.calls += 1
        first_arg = args[0] if args else None
        for ri, rule in enumerate(self.rules):
            if rule.exhausted or not self._matches(rule, call_idx,
                                                   first_arg):
                continue
            rule.fired += 1
            self.log.append((call_idx, ri, rule.do))
            if rule.do == "delay":
                self.sleep(rule.delay_s)
                continue        # a spike, not a failure: keep going
            raise _EXC[rule.exc](
                f"injected {rule.exc} (call {call_idx}, rule {ri})")
        return self.fn(*args, **kwargs)


def inject_faults(fn: Callable[..., Any],
                  plan: Sequence[Dict[str, Any]], *, seed: int = 0,
                  sleep: Optional[Callable[[float], None]] = None
                  ) -> FaultInjector:
    """``inject_faults(encode, plan)`` -> the wrapped callable."""
    return FaultInjector(fn, plan, seed=seed, sleep=sleep)
