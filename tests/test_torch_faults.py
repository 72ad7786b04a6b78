"""The port's fault injector and hardened serving loop against the JAX
package (CPU).

The same plan with the same seed must fire on the same calls and leave the
same ``log`` in both packages (``call``, ``every``, ``token``, ``prob``,
``delay``, ``times``), refuse the same plans with the same messages, and
agree with JAX's ``is_oom_error``. The hardened loop is then driven by the
injector through the cases of ``tests/test_serving_hardened.py`` (shed on
a full queue and on a deadline, poison isolation, transient faults, the
OOM halving the cap and regrowing it, continuous EDF order, the
completion invariant under random interleavings): each scenario runs
once through the JAX loop and once through the port's, each with its own
fake clock and a numpy encode stub feeding its own ``SparseRep``, and the
outcomes (served reps, shed reasons, failures), counters, batch sizes and
caps must be equal. Every comparison is exact.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.runtime as jrt
import repro_torch.runtime as trt
from repro.retrieval.sparse_rep import SparseRep as JSparseRep
from repro.runtime import faults as jfaults
from repro.runtime import serving as jserving
from repro_torch.retrieval.sparse_rep import SparseRep as TSparseRep
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import serving as tserving

PKGS = {"jax": (jfaults, jserving, JSparseRep),
        "torch": (tfaults, tserving, TSparseRep)}
POISON = 999


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def np_encoder(rep_cls, width=4, cost=0.0, clock=None, vocab=64):
    """Numpy encode stub: the top-``width`` token counts of each row, as
    ``rep_cls`` (each package's ``SparseRep``)."""

    def encode(tokens, mask):
        toks = np.asarray(tokens)
        msk = np.asarray(mask)
        if clock is not None and cost:
            clock.advance(cost)
        B = toks.shape[0]
        vals = np.zeros((B, width), np.float32)
        idxs = np.zeros((B, width), np.int32)
        for i in range(B):
            ids, counts = np.unique(toks[i][msk[i] > 0] % vocab,
                                    return_counts=True)
            order = np.argsort(-counts, kind="stable")[:width]
            vals[i, :order.size] = counts[order]
            idxs[i, :order.size] = ids[order]
        return rep_cls(vals, idxs, (vals > 0).sum(axis=1).astype(np.int32))

    return encode


# ---------------------------------------------------------------------------
# the injector
# ---------------------------------------------------------------------------

PLANS = {
    "call": [{"on": {"call": 2}}],
    "every_times": [{"on": {"every": 2}, "times": 2, "exc": "transient"}],
    "every_zero": [{"on": {"every": 0}}],
    "prob": [{"on": {"prob": 0.3}}],
    "prob_two_rules": [{"on": {"prob": 0.2}, "exc": "oom"},
                       {"on": {"prob": 0.5}, "times": 3}],
    "delay_then_raise": [{"on": {"every": 3}, "do": "delay",
                          "delay_s": 0.25},
                         {"on": {"call": 5}, "exc": "oom", "times": 1}],
    "token": [{"on": {"token": 7}}],
    "token_times": [{"on": {"token": 7}, "exc": "transient", "times": 2},
                    {"on": {"prob": 0.1}}],
}


def _drive(fault_mod, plan, seed, args_of):
    clock = FakeClock()
    inj = fault_mod.FaultInjector(lambda *a: "ok", plan, seed=seed,
                                  sleep=clock.advance)
    outcomes = []
    for i in range(40):
        try:
            outcomes.append(inj(*args_of(i)))
        except fault_mod.FaultError as e:
            outcomes.append(type(e).__name__ + ": " + str(e))
    return outcomes, inj.log, inj.calls, clock.t


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_injector_fires_on_the_same_calls_as_jax(name, seed):
    def args_of(i):
        return (np.array([[1, 7 if i % 5 == 1 else 2]], np.int32), None)

    want = _drive(jfaults, PLANS[name], seed, args_of)
    got = _drive(tfaults, PLANS[name], seed, args_of)
    assert got == want
    # every 0 never fires (n > 0 is required); the others must
    assert bool(want[1]) == (name != "every_zero")


def test_token_trigger_reads_torch_tensors():
    """Arg 0 as a torch tensor (numpy for the JAX injector): the same
    firings; other dtypes and shapes too."""
    plan = [{"on": {"token": 7}}]
    for dtype in (torch.int32, torch.int64, torch.float32):
        def t_args(i):
            return (torch.tensor([[1, 7 if i % 3 == 0 else 2]], dtype=dtype),
                    None)

        def j_args(i):
            return (t_args(i)[0].numpy(), None)

        assert _drive(tfaults, plan, 0, t_args) == _drive(jfaults, plan, 0,
                                                          j_args)
    inj = tfaults.FaultInjector(lambda *a: "ok", plan)
    assert inj(None) == "ok" and inj() == "ok" and inj.log == []


@pytest.mark.parametrize("plan", [
    [{"on": {}}],
    [{"on": {"call": 0, "every": 2}}],
    [{"on": {"sometimes": 1}}],
    [{"on": {"call": 0}, "do": "x"}],
    [{"on": {"call": 0}, "exc": "x"}],
    [{"on": {"call": 0}}, {"on": {"prob": 0.1}, "exc": "nope"}],
], ids=["empty", "two", "unknown_trigger", "do", "exc", "second_rule"])
def test_plan_validation_equals_jax(plan):
    with pytest.raises(ValueError) as want:
        jfaults.FaultInjector(lambda: None, plan)
    with pytest.raises(ValueError) as got:
        tfaults.FaultInjector(lambda: None, plan)
    assert str(got.value) == str(want.value)


def test_is_oom_error_agrees_with_jax():
    cases = [RuntimeError("RESOURCE_EXHAUSTED: 2.1GiB"),
             RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"),
             RuntimeError("shape mismatch"), ValueError("oom-ish"),
             MemoryError("")]
    for e in cases:
        assert tfaults.is_oom_error(e) == jfaults.is_oom_error(e), e
    # each package's own classes, and CUDA's OOM error
    assert tfaults.is_oom_error(tfaults.ResourceExhausted("nope"))
    assert jfaults.is_oom_error(jfaults.ResourceExhausted("nope"))
    assert not tfaults.is_oom_error(tfaults.TransientFault("blip"))
    assert not jfaults.is_oom_error(jfaults.TransientFault("blip"))
    assert tfaults.is_oom_error(torch.cuda.OutOfMemoryError("2 GiB"))
    assert tfaults.is_oom_error(RuntimeError("injected"
                                             "ResourceExhausted"))


def test_runtime_exports_what_jax_exports():
    want = {n for n in dir(jrt) if not n.startswith("_")} - {
        "fault_tolerance", "faults", "frontier", "serving"}
    assert want <= set(trt.__all__)
    for name in trt.__all__:
        assert getattr(trt, name) is not None


# ---------------------------------------------------------------------------
# the hardened loop, driven by the injector, against the JAX loop
# ---------------------------------------------------------------------------

def _req(serving, uid, deadline_s=None, token=None):
    toks = np.arange(1, 9, dtype=np.int32)
    if token is not None:
        toks = toks.copy()
        toks[0] = token
    return serving.Request(uid=uid, tokens=toks, deadline_s=deadline_s)


def _loop(pkg, clock, *, plan=None, cost=0.0, vocab=64, max_batch=8,
          max_wait_s=10.0, max_queue=None, **kw):
    faults, serving, rep_cls = PKGS[pkg]
    encode = np_encoder(rep_cls, cost=cost, clock=clock, vocab=vocab)
    if plan is not None:
        encode = faults.inject_faults(encode, plan, sleep=clock.advance)
    admission = (serving.AdmissionPolicy(max_queue_depth=max_queue)
                 if max_queue is not None else None)
    return serving.ServingLoop(
        serving.BatchedEncoder(encode, policy=serving.BatchPolicy(
            max_batch=max_batch, max_wait_s=max_wait_s)),
        clock=clock, admission=admission, **kw)


def _outcome(r):
    """A completion record as plain data: a served rep's arrays, a shed's
    reason and wait, a failure's error and OOM flag."""
    if hasattr(r, "reason"):
        return ("shed", r.uid, r.reason, r.waited_s)
    if hasattr(r, "error"):
        return ("failed", r.uid, r.error, r.oom)
    return ("served", np.asarray(r.values).tolist(),
            np.asarray(r.indices).tolist(), int(np.asarray(r.nnz)))


def _summary(loop, uids):
    st = loop.stats()
    return {"outcomes": [_outcome(loop.take(u)) for u in uids],
            "left": sorted(loop.completed), "stats": st,
            "batch_sizes": list(loop.batch_sizes),
            "pending": [r.uid for r in loop.pending]}


def _queue_full(pkg):
    serving = PKGS[pkg][1]
    clock = FakeClock()
    loop = _loop(pkg, clock, max_queue=2)
    adm = [loop.submit(_req(serving, u)).value for u in range(3)]
    return adm, _summary(loop, [2])


def _est_deadline(pkg):
    serving = PKGS[pkg][1]
    clock = FakeClock()
    loop = _loop(pkg, clock, cost=1.0, max_batch=2)
    loop.submit(_req(serving, 0))
    loop.tick(force=True)
    est = loop.estimated_queue_delay(1)
    loop.submit(_req(serving, 1))
    loop.submit(_req(serving, 2))
    adm = [loop.submit(_req(serving, 3, deadline_s=0.5)).value,
           loop.submit(_req(serving, 4, deadline_s=10.0)).value]
    return est, adm, _summary(loop, [0, 3])


def _idle_never_sheds(pkg):
    serving = PKGS[pkg][1]
    clock = FakeClock()
    loop = _loop(pkg, clock, cost=5.0)
    loop.submit(_req(serving, 0))
    loop.tick(force=True)
    return loop.submit(_req(serving, 1, deadline_s=0.1)).value


def _expired_before_encode(pkg):
    serving = PKGS[pkg][1]
    clock = FakeClock()
    loop = _loop(pkg, clock, max_batch=4, plan=[{"on": {"call": 9}}])
    loop.submit(_req(serving, 0, deadline_s=1.0))
    loop.submit(_req(serving, 1))
    clock.advance(2.0)
    n = loop.tick(force=True)
    return n, loop.encoder.encode_fn.calls, _summary(loop, [0, 1])


def _poison(pkg, poisoned=(3,)):
    serving = PKGS[pkg][1]
    clock = FakeClock()
    loop = _loop(pkg, clock, vocab=2048, plan=[{"on": {"token": POISON}}])
    for u in range(8):
        loop.submit(_req(serving, u,
                         token=POISON if u in poisoned else None))
    n = loop.tick(force=True)
    return n, loop.encoder.encode_fn.log, _summary(loop, range(8))


def _two_poisons(pkg):
    return _poison(pkg, poisoned=(0, 7))


def _transient(pkg):
    serving = PKGS[pkg][1]
    clock = FakeClock()
    loop = _loop(pkg, clock, max_batch=4,
                 plan=[{"on": {"call": 0}, "exc": "transient", "times": 1}])
    for u in range(4):
        loop.submit(_req(serving, u))
    loop.tick(force=True)
    return _summary(loop, range(4))


def _oom_halves_and_regrows(pkg):
    serving = PKGS[pkg][1]
    clock = FakeClock()
    loop = _loop(pkg, clock,
                 plan=[{"on": {"call": 0}, "exc": "oom", "times": 1}])
    for u in range(8):
        loop.submit(_req(serving, u))
    loop.tick(force=True)
    caps = [loop.stats()["batch_cap"]]
    for round_ in range(8):
        for u in range(100 + round_ * 4, 104 + round_ * 4):
            loop.submit(_req(serving, u))
        loop.tick(force=True)
        caps.append(loop.stats()["batch_cap"])
    loop.drain()
    return caps, _summary(loop, list(range(8)) + list(range(100, 132)))


def _cap_feeds_dispatch(pkg):
    serving = PKGS[pkg][1]
    clock = FakeClock()
    loop = _loop(pkg, clock,
                 plan=[{"on": {"call": 0}, "exc": "oom", "times": 1}])
    for u in range(16):
        loop.submit(_req(serving, u))
    sizes = [loop.tick(force=True), loop.tick(force=True)]
    loop.drain()
    return sizes, _summary(loop, range(16))


def _drain_one_batch_a_tick(pkg):
    serving = PKGS[pkg][1]
    clock = FakeClock()
    loop = _loop(pkg, clock, max_batch=4)
    for u in range(10):
        loop.submit(_req(serving, u))
    sizes = []
    while loop.pending:
        sizes.append(loop.tick(force=True))
    return sizes, _summary(loop, range(10))


def _latency_spike(pkg):
    """A delay rule: the encode's time feeds the EWMA, the latencies and
    the deadline shed of the next submit."""
    serving = PKGS[pkg][1]
    clock = FakeClock()
    loop = _loop(pkg, clock, max_batch=2, plan=[
        {"on": {"every": 2}, "do": "delay", "delay_s": 0.75}])
    for u in range(6):
        loop.submit(_req(serving, u, deadline_s=2.0))
        loop.tick()
        clock.advance(0.5)
    loop.drain()
    return _summary(loop, range(6))


def _edf_order(pkg):
    serving = PKGS[pkg][1]
    out = []
    for continuous in (True, False):
        clock = FakeClock()
        loop = _loop(pkg, clock, max_batch=2, continuous=continuous)
        loop.submit(_req(serving, 0, deadline_s=10.0))
        loop.submit(_req(serving, 1, deadline_s=10.0))
        loop.submit(_req(serving, 2, deadline_s=0.05))
        loop.submit(_req(serving, 3))
        out.append((loop.tick(force=True), sorted(loop.completed),
                    _summary(loop, sorted(loop.completed))))
    return out


def _urgency_trigger(pkg):
    serving = PKGS[pkg][1]
    clock = FakeClock()
    loop = _loop(pkg, clock, continuous=True)
    loop.submit(_req(serving, 0, deadline_s=0.5))
    first = loop.tick()
    clock.advance(0.5)
    return first, loop.ready(), loop.tick(), _summary(loop, [0])


def _edf_admission(pkg):
    serving = PKGS[pkg][1]
    out = []
    for continuous in (False, True):
        clock = FakeClock()
        loop = _loop(pkg, clock, max_batch=2, continuous=continuous)
        loop.submit(_req(serving, 100))
        loop.submit(_req(serving, 101))
        clock.advance(0.2)
        loop.tick(force=True)
        loop._encode_ewma = 1.0
        for u in range(8):
            loop.submit(_req(serving, u, deadline_s=60.0))
        out.append((loop.submit(_req(serving, 99, deadline_s=1.5)).value,
                    [r.uid for r in loop.pending]))
    return out


SCENARIOS = {f.__name__.lstrip("_"): f for f in (
    _queue_full, _est_deadline, _idle_never_sheds, _expired_before_encode,
    _poison, _two_poisons, _transient, _oom_halves_and_regrows,
    _cap_feeds_dispatch, _drain_one_batch_a_tick, _latency_spike,
    _edf_order, _urgency_trigger, _edf_admission)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_hardened_loop_equals_jax(name):
    assert SCENARIOS[name]("torch") == SCENARIOS[name]("jax")


def test_scenarios_reach_their_cases():
    """The scenarios above do what their names say (on the port)."""
    n, log, s = _poison("torch")
    assert n == 8 and s["stats"]["served"] == 7 and s["stats"]["failed"] == 1
    assert s["outcomes"][3][0] == "failed" and "fault" in s["outcomes"][3][2]
    caps, s = _oom_halves_and_regrows("torch")
    assert caps[0] == 4 and caps[-1] == 8 and s["stats"]["oom_faults"] == 1
    assert _cap_feeds_dispatch("torch")[0] == [8, 4]
    assert [o[0] for o in _transient("torch")["outcomes"]] == ["served"] * 4
    adm, s = _queue_full("torch")
    assert adm == ["accepted", "accepted", "shed"]
    assert s["outcomes"][0][2] == "queue_full"
    assert _est_deadline("torch")[1] == ["shed", "accepted"]
    assert _idle_never_sheds("torch") == "accepted"
    n, calls, s = _expired_before_encode("torch")
    assert n == 1 and calls == 1 and s["outcomes"][0][2] == "expired"
    (_, done_edf, _), (_, done_fifo, _) = _edf_order("torch")
    assert done_edf == [0, 2] and done_fifo == [0, 1]
    assert _urgency_trigger("torch")[:3] == (0, True, 1)
    (fifo, _), (cont, pending) = _edf_admission("torch")
    assert fifo == "shed" and cont == "accepted" and pending[-1] == 99


def _property_run(pkg, seed, max_batch, max_queue, continuous):
    serving = PKGS[pkg][1]
    rng = np.random.default_rng(seed)
    clock = FakeClock()
    loop = _loop(pkg, clock, cost=0.05, vocab=2048, max_batch=max_batch,
                 max_wait_s=0.01, max_queue=max_queue, continuous=continuous,
                 plan=[{"on": {"token": POISON}},
                       {"on": {"call": 3}, "exc": "oom", "times": 1},
                       {"on": {"prob": 0.1}, "exc": "transient",
                        "times": 2}])
    uid = 0
    for _ in range(60):
        op = rng.integers(0, 4)
        if op == 0:
            deadline = (float(rng.uniform(0.01, 0.5))
                        if rng.random() < 0.5 else None)
            poison = rng.random() < 0.15
            loop.submit(_req(serving, uid, deadline_s=deadline,
                             token=POISON if poison else None))
            uid += 1
        elif op == 1:
            loop.tick()
        elif op == 2:
            clock.advance(float(rng.uniform(0.0, 0.1)))
        else:
            loop.tick(force=True)
    loop.drain()
    out = _summary(loop, range(uid))
    assert not loop.completed
    st = out["stats"]
    assert st["served"] + st["shed"] + st["failed"] == uid
    return out, loop.encoder.encode_fn.log


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000),
       max_batch=st.integers(min_value=1, max_value=6),
       max_queue=st.integers(min_value=1, max_value=12),
       continuous=st.sampled_from([False, True]))
def test_every_uid_completes_exactly_once_as_in_jax(seed, max_batch,
                                                    max_queue, continuous):
    """Random interleavings of submits, ticks and time with poison
    requests, deadlines, a one-shot OOM and seeded transient faults: every
    uid completes exactly once, and each outcome, counter and firing is the
    JAX loop's."""
    args = (seed, max_batch, max_queue, continuous)
    assert _property_run("torch", *args) == _property_run("jax", *args)
