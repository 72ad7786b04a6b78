"""The LSR train step on a state held by specs
(``launch/steps.build_lsr_train_step(cfg, mesh, param_specs=,
zero_specs=)``, ``launch/sharding.shard_state`` / ``gather_state``)
against the JAX package's ZeRO step, the port's unsharded step and its
replicated mesh step, on the CPU.

The JAX side runs once in a subprocess with four forced host devices
(``jax.make_mesh`` with Auto axes, the state placed by
``state_shardings`` with ``device_put``, the step jitted under
``set_mesh``); the port's side in a world of four gloo ranks for the
(2, 2) cases and one of two for the (1, 2) and (2, 1) cases. Both start
from the JAX package's SMOKE init (``PRNGKey(0)``) carried across with
``weights.state_from_jax``, then cut by ``shard_state``, at f32 compute;
the port on the kernel head's plain versions.

The configs: splade_xlmr's SMOKE at d_model 512 (2 layers, V 1024), so
that ``zero_spec`` finds free dimensions of 512 (at SMOKE's d 64 it
splits nothing): on (2, 2) ``embed`` is split over ``model`` (rows) and
``data`` (columns), and ``lm_head.b``, whose one dimension ``model``
splits, gets no ZeRO axis (its gradient is ``psum``'d). The same at V
1023, which ``model`` does not divide (the head runs unsharded with a
warning); phi3.5-moe's SMOKE (untied E, experts split over ``model``) on
(1, 2), with the 10f warning.

Tolerances, two steps at a peak lr of 0.5 (``test_torch_sharded_train``'s
and ``test_torch_decoder_train``'s rules for one step):
* step 1: the loss within 1e-5 relative; the moments per leaf within
  1e-5 of the leaf's largest |value| (``MU_TOL``, the replicated mesh
  step's; measured at most 7.4e-6 against JAX); the params within 1e-5
  except where the reference's Adam step ran in its eps regime (``0 <
  sqrt(nu / (1 - b2^t)) < 1e-6``: a gradient element near zero whose f32
  rounding moves ``m / (sqrt(v) + eps)`` by O(1));
* step 2: every param within 2.1 x the summed lr_t (a step's largest
  move either way); the loss within 1e-5 relative, each leaf's moments
  within 1e-4 of the reference's norm and each leaf's update outside
  the eps regime within 1e-3 of the reference update's norm. Step 2's
  gradient is taken at step 1's params, whose eps-regime elements differ
  by up to lr_t (one can flip a gate of the head), so every reordering
  of f32 sums moves step 2 more than step 1: the port's unsharded step
  against JAX as much as this one (measured at most 5.2e-5 in the
  moments and 5.4e-5 in the updates, against any reference). Against JAX
  each bound is at least twice the port's unsharded step's own distance
  from JAX: at V 1023 that step is 1.5e-5 (loss), 7.1e-3 (updates) and
  1.1e-2 (``lm_head.b``'s first moments) from JAX at step 2, after a
  step 1 within 4.3e-6, and this one is as far;
* every rank's state bytes equal to the specs' count; every rank that
  holds a block holds the same bits after each step.
"""

import dataclasses
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_mesh_ranks import (finish_jax, start_jax, torch_batch, train_cfg,
                               world, zero_rank, zero_refusals_rank)
from repro.configs import get_config as jax_config
from repro.data.synthetic import lsr_pair_batches
from repro.models import transformer as jax_tfm
from repro.optim.optimizers import adamw as jax_adamw
from repro_torch.launch import steps
from repro_torch.optim.schedules import linear_warmup_cosine
from repro_torch.tree import tree_items
from repro_torch.weights import state_from_jax

PAIRS, Q_LEN, D_LEN, LR = 8, 12, 16, 0.5
LOSS_RTOL, MU_TOL, STEP2_MOMENT_RTOL = 1e-5, 1e-5, 1e-4
PARAM_ATOL, UPDATE_RTOL, ADAM_EPS_REGIME = 1e-5, 1e-3, 1e-6
WIDE = {"d_model": 512}
BOTH, PARAMS, ZERO = ("params", "zero"), ("params",), ("zero",)

CASES = {  # name: (arch, mesh, n_micro, specs, vocab, fields)
    "xlmr_2x2_m1": ("splade_xlmr", (2, 2), 1, BOTH, 1024, WIDE),
    "xlmr_2x2_m2": ("splade_xlmr", (2, 2), 2, BOTH, 1024, WIDE),
    "xlmr_1x2_m1": ("splade_xlmr", (1, 2), 1, BOTH, 1024, WIDE),
    "xlmr_1x2_m2": ("splade_xlmr", (1, 2), 2, BOTH, 1024, WIDE),
    "xlmr_2x1_m1": ("splade_xlmr", (2, 1), 1, BOTH, 1024, WIDE),
    "xlmr_2x1_m2": ("splade_xlmr", (2, 1), 2, BOTH, 1024, WIDE),
    "xlmr_2x2_m2_params": ("splade_xlmr", (2, 2), 2, PARAMS, 1024, WIDE),
    "xlmr_2x2_m1_zero": ("splade_xlmr", (2, 2), 1, ZERO, 1024, WIDE),
    "xlmr_1x2_m1_params": ("splade_xlmr", (1, 2), 1, PARAMS, 1024, WIDE),
    "xlmr_2x1_m2_zero": ("splade_xlmr", (2, 1), 2, ZERO, 1024, WIDE),
    "xlmr_v1023_2x2_m1": ("splade_xlmr", (2, 2), 1, BOTH, 1023, WIDE),
    "moe_1x2_m1": ("phi3_5_moe", (1, 2), 1, BOTH, 512, {}),
}
# the JAX package routes an MoE under a mesh through its expert-parallel
# path (10f), the port through the dense dispatch on each rank's rows:
# the MoE case is held to the port's own steps only
JAX_CASES = [name for name in CASES if not name.startswith("moe")]

_JAX = """
import os, dataclasses
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.compat import set_mesh
from repro.configs import get_config
from repro.data.synthetic import lsr_pair_batches
from repro.launch import steps
from repro.launch.sharding import state_shardings, transformer_param_specs
from repro.models import transformer as tfm
from repro.optim.optimizers import adamw

CASES = %r
PAIRS, Q_LEN, D_LEN, LR = %r
out = {}

def flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat(v, prefix + k + "/")
    else:
        yield prefix[:-1], np.asarray(tree)

for name, (arch, shape, n_micro, specs, vocab, fields) in CASES.items():
    cfg = dataclasses.replace(get_config(arch).SMOKE, compute_dtype="float32",
                              vocab_size=vocab, l1_weight=0.0,
                              distill_weight=0.0, **fields)
    params = tfm.init_params(jax.random.PRNGKey(0), cfg)
    state = {"params": params, "opt": adamw(1e-4).init(params),
             "step": jnp.zeros((), jnp.int32)}
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:shape[0] * shape[1]])
    sh = state_shardings(transformer_param_specs(cfg, mesh),
                         jax.eval_shape(lambda: params), "adamw", mesh)
    whole = jax.tree.map(lambda s: NamedSharding(mesh, P()), sh["params"])
    p_sh = sh["params"] if "params" in specs else None
    z_sh = sh["opt"]["mu"] if "zero" in specs else None
    held_z = z_sh or p_sh or whole
    place = {"params": p_sh or whole, "opt": {"mu": held_z, "nu": held_z},
             "step": sh["step"]}
    step = jax.jit(steps.build_lsr_train_step(
        cfg, mesh, n_micro=n_micro, n_pairs=PAIRS, lr=LR, param_specs=p_sh,
        zero_specs=z_sh))
    b = next(lsr_pair_batches(batch=PAIRS, q_len=Q_LEN, d_len=D_LEN,
                              vocab=vocab))
    with set_mesh(mesh):
        state = jax.device_put(state, place)
        for t in (1, 2):
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            out[f"{name}|{t}|loss"] = np.asarray(m["loss"])
            for k, v in flat({"params": state["params"], "opt": state["opt"]}):
                out[f"{name}|{t}|{k}"] = v
np.savez(os.environ["OUT"], **out)
"""


def _case(name, arch, mesh, n_micro, specs, vocab, fields):
    cfg = dataclasses.replace(jax_config(arch).SMOKE, vocab_size=vocab,
                              **fields)
    params = jax_tfm.init_params(jax.random.PRNGKey(0), cfg)
    state = jax.tree.map(np.asarray, {
        "params": params, "opt": jax_adamw(1e-4).init(params),
        "step": jnp.zeros((), jnp.int32)})
    batch = next(lsr_pair_batches(batch=PAIRS, q_len=Q_LEN, d_len=D_LEN,
                                  vocab=vocab))
    return {"name": name, "arch": arch, "mesh": mesh, "n_micro": n_micro,
            "specs": specs, "vocab": vocab, "fields": fields, "l1": 0.0,
            "distill": 0.0, "pairs": PAIRS, "state": state, "batch": batch}


def _unsharded(case):
    """The port's unsharded step, twice, on the same state and batch: the
    losses and the state after each step, by leaf name."""
    cfg = train_cfg(case)
    state = state_from_jax(case["state"], cfg, "cpu")
    step = steps.build_lsr_train_step(cfg, n_micro=case["n_micro"], lr=LR)
    losses, states = [], []
    for _ in range(2):
        state, m = step(state, torch_batch(case["batch"]))
        losses.append(float(m["loss"]))
        states.append({k: v.numpy() for k, v in tree_items(
            {"params": state["params"], "opt": state["opt"]}).items()})
    return losses, states


@pytest.fixture(scope="module")
def runs():
    cases = [_case(name, *spec) for name, spec in CASES.items()]
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "jax.npz"
        proc = start_jax(_JAX % ({n: CASES[n] for n in JAX_CASES},
                                 (PAIRS, Q_LEN, D_LEN, LR)), out)
        by_size = {}
        for c in cases:
            by_size.setdefault(c["mesh"][0] * c["mesh"][1], []).append(c)
        ranks = {}
        for n, group in by_size.items():
            for r, res in enumerate(world(zero_rank, group, n=n)):
                for name, rec in res.items():
                    ranks.setdefault(name, []).append(rec)
        ref = finish_jax(proc, out)
    jax_states = {name: ([float(ref[f"{name}|{t}|loss"]) for t in (1, 2)],
                         [{k.split("|", 2)[2]: v for k, v in ref.items()
                           if k.startswith(f"{name}|{t}|")
                           and not k.endswith("|loss")} for t in (1, 2)])
                  for name in JAX_CASES}
    return {"cases": {c["name"]: c for c in cases}, "ranks": ranks,
            "jax": jax_states,
            "unsharded": {c["name"]: _unsharded(c) for c in cases}}


def _rel(got, want):
    return float(np.linalg.norm(got - want)) / max(
        float(np.linalg.norm(want)), 1e-30)


def _regime(states, leaf, upto):
    """Where the reference's Adam step ran in its eps regime at some step
    of the first ``upto``."""
    out = False
    for t, st in enumerate(states[:upto], start=1):
        vhat = st["opt/nu/" + leaf] / (1 - 0.999 ** t)
        out = out | ((vhat > 0) & (np.sqrt(vhat) < ADAM_EPS_REGIME))
    return out


def _step2_distances(got, p0, ref):
    """Step 2's distances from ``ref`` = (losses, states): the loss's
    relative one, each moment leaf's relative norm, and each param leaf's
    update outside the eps regime, relative in norm."""
    losses, states = ref
    out = {"loss": abs(got[0][1] - losses[1]) / abs(losses[1])}
    for name, w in states[1].items():
        if name.startswith("opt/"):
            out[name] = _rel(got[1][1][name], w)
        else:
            leaf = name[len("params/"):]
            held = ~_regime(states, leaf, 2)
            out[name] = _rel((got[1][1][name] - p0[leaf])[held],
                             (w - p0[leaf])[held])
    return out


def _hold(runs, name, ref, control=None):
    """The spec'd step (rank 0's gathered states) against ``ref`` = (losses,
    states after each step). Step 1: the loss, the moments within
    ``MU_TOL`` of each leaf's largest |value|, the params by the
    eps-regime rule. Step 2: every param within a step's largest move;
    the loss, each moment leaf and each param leaf's update within their
    tolerances, or within twice ``control``'s distance from ``ref``
    (another step against the same reference)."""
    rec = runs["ranks"][name][0]
    losses, states = ref
    got = (rec["losses"], rec["states"])
    p0 = {k: np.asarray(v) for k, v in tree_items(
        runs["cases"][name]["state"]["params"]).items()}
    assert set(got[1][1]) == set(states[1])
    np.testing.assert_allclose(got[0][0], losses[0], rtol=LOSS_RTOL)
    moved = 2.1 * sum(linear_warmup_cosine(LR, 1000, 100_000)(s)
                      for s in range(2))
    for key, w in states[0].items():
        diff = np.abs(got[1][0][key] - w)
        if key.startswith("opt/"):
            bound = MU_TOL * max(float(np.abs(w).max()), 1e-30)
            assert diff.max() <= bound, (name, key, diff.max(), bound)
        else:
            regime = _regime(states, key[len("params/"):], 1)
            assert diff.max(initial=0, where=~regime) <= PARAM_ATOL, \
                (name, key)
            assert np.abs(got[1][1][key] - states[1][key]).max() <= moved, \
                (name, key)
    dist = _step2_distances(got, p0, ref)
    ctrl = _step2_distances(control, p0, ref) if control else {}
    for key, d in dist.items():
        tol = (LOSS_RTOL if key == "loss" else STEP2_MOMENT_RTOL
               if key.startswith("opt/") else UPDATE_RTOL)
        bound = max(tol, 2 * ctrl.get(key, 0.0))
        assert d <= bound, f"{name} step 2: {key} {d} > {bound}"


@pytest.mark.parametrize("name", JAX_CASES)
def test_spec_step_matches_the_jax_zero_step(runs, name):
    """Against the JAX step (the port's unsharded step its control)."""
    _hold(runs, name, runs["jax"][name], runs["unsharded"][name])


@pytest.mark.parametrize("name", list(CASES))
def test_spec_step_matches_the_unsharded_step(runs, name):
    _hold(runs, name, runs["unsharded"][name])


@pytest.mark.parametrize("name", list(CASES))
def test_spec_step_matches_the_replicated_mesh_step(runs, name):
    """The mesh step without specs from the same state: every rank holds
    the whole state, the gradients summed over the batch axes once a
    step."""
    _hold(runs, name, runs["ranks"][name][0]["replicated"])


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_exactly_the_specs_bytes(runs, name):
    whole = sum(np.asarray(v).nbytes for v in tree_items(
        runs["cases"][name]["state"]["params"]).values()) * 3
    for rec in runs["ranks"][name]:
        assert rec["nbytes"] == rec["spec_nbytes"]
        if len(runs["ranks"][name]) > 1 and CASES[name][3] == BOTH:
            assert rec["nbytes"] < whole


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_holding_a_block_hold_the_same_bits(runs, name):
    """After each step, every leaf's block is the same bits on each rank
    whose coordinates agree on the axes its spec names."""
    recs = runs["ranks"][name]
    for t in range(2):
        for leaf, axes in recs[0]["axes"].items():
            if leaf == "step":
                continue
            groups = {}
            for rec in recs:
                key = tuple(rec["coords"][a] for a in axes)
                groups.setdefault(key, set()).add(rec["blocks"][t][leaf])
            assert all(len(d) == 1 for d in groups.values()), (leaf, t)
    assert all(rec["step"] == 2 for rec in recs)


@pytest.mark.parametrize("name", list(CASES))
def test_new_state_on_a_mesh_is_the_cut_global_state(runs, name):
    """``new_state`` / ``init_state`` with ``mesh=`` and ``specs=`` build
    this rank's blocks: the same bits as ``shard_state`` of the global
    state from the same seed, on every rank."""
    assert all(rec["new_state_is_shard_state"]
               for rec in runs["ranks"][name])


def test_zero_split_over_model_and_data_at_the_wide_smoke(runs):
    """The case the test width is chosen for: on (2, 2) ``embed``'s moments
    split over ``model`` and ``data``, ``lm_head.b``'s over ``model``
    alone."""
    axes = runs["ranks"]["xlmr_2x2_m1"][0]["axes"]
    assert axes["opt/mu/embed"] == ("model", "data")
    assert axes["params/embed"] == ("model",)
    assert axes["opt/mu/lm_head/b"] == ("model",)
    assert axes["opt/mu/layers/ln1"] == ("data",)


def test_moe_under_param_specs_keeps_the_dense_dispatch_and_warns(runs):
    for rec in runs["ranks"]["moe_1x2_m1"]:
        assert any("expert-parallel MoE is not ported" in w and "10f" in w
                   for w in rec["warnings"]), rec["warnings"]
        assert rec["axes"]["params/layers/mlp/w_gate"] == ("model",)


def test_non_divisible_vocab_runs_the_head_unsharded_with_a_warning(runs):
    for rec in runs["ranks"]["xlmr_v1023_2x2_m1"]:
        assert any("vocab 1023 not divisible by 2 'model' shards" in w
                   for w in rec["warnings"])
        assert rec["axes"]["params/embed"] == ()
        assert rec["axes"]["opt/mu/embed"] == ("data",)


@pytest.fixture(scope="module")
def refusals():
    state = _case("refusals", "splade_xlmr", (2, 2), 1, BOTH, 1024,
                  {})["state"]
    return world(zero_refusals_rank, state, n=4)


@pytest.mark.parametrize("what,message", [
    ("batch_axis_param", "over the batch axes"),
    ("not_refining", "does not refine"),
    ("mixed_axes", "batch and other axes"),
    ("uneven", "does not split evenly"),
    ("no_mesh", "give the mesh"),
    ("state_mesh_alone", "go together"),
    ("state_specs_alone", "go together"),
])
def test_what_the_spec_step_cannot_run_raises(refusals, what, message):
    for r in refusals:
        assert message in r[what], r.get(what)
