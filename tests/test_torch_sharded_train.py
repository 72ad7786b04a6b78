"""The LSR train and prefill steps over a (data, model) mesh
(``launch/steps.py`` with a ``launch.mesh.Mesh``) against the JAX
package's sharded steps and the port's unsharded ones, on the CPU.

The JAX side runs once in a subprocess with four forced host devices
(``jax.make_mesh`` over them, the steps jitted under ``set_mesh``); the
port's side once in a world of four gloo ranks (``spawn_world``). Both
start from the JAX package's SMOKE init (``PRNGKey(0)``), carried across
with ``weights.state_from_jax``, at f32 compute; JAX on its plain
``sparton`` head (its Pallas kernels do not run here), the port on the
config's ``kernel`` head (the plain versions of K1-K3 on the CPU).

Cases cover splade_xlmr (V 1024) and splade_bert (V 512) on the (2, 2),
(1, 4) and (4, 1) meshes, n_micro 1 and 2, the L1 and MarginMSE terms,
and splade_bert at V 510 on (1, 4), whose vocabulary the model axis does
not divide: the head runs unsharded with a warning and the objective is
the gathered one. Tolerances (f32 sums in another order): the loss
within 1e-5 relative of JAX's and of the unsharded step's (measured at
most 7.5e-7 and 2.1e-6); the first Adam moments (``0.1 * g`` clipped)
per leaf within 1e-5 of the largest |moment| of the leaf (measured at
most 2.3e-6 against JAX, 4.3e-6 against the unsharded step); every
rank's parameters and moments the same bytes; the prefill's gathered Y
blocks within 1e-5 of JAX's (measured 1.6e-6) and equal to the
unsharded prefill's.
"""

import dataclasses
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_mesh_ranks import (assemble, fallback_rank, finish_jax, mesh_id,
                               start_jax, torch_batch, train_cfg, train_rank,
                               world, wrong_batch_rank)
from repro.configs import get_config as jax_config
from repro.data.synthetic import lsr_pair_batches
from repro.models import transformer as jax_tfm
from repro.optim.optimizers import adamw as jax_adamw
from repro_torch.launch import steps
from repro_torch.tree import tree_items
from repro_torch.weights import state_from_jax

PAIRS, Q_LEN, D_LEN = 8, 12, 16
LOSS_RTOL, MU_TOL = 1e-5, 1e-5

CASES = {  # name: (arch, mesh, n_micro, l1_weight, distill_weight, vocab)
    "xlmr_2x2_m1_l1_distill": ("splade_xlmr", (2, 2), 1, 1e-3, 0.5, 1024),
    "xlmr_1x4_m2": ("splade_xlmr", (1, 4), 2, 0.0, 0.0, 1024),
    "bert_4x1_m2_l1_distill": ("splade_bert", (4, 1), 2, 1e-3, 0.5, 512),
    "bert_v510_1x4_m1_l1_distill": ("splade_bert", (1, 4), 1, 1e-3, 0.5,
                                    510),
}
PREFILLS = {f"{arch.split('_')[1]}_{mesh_id(m)}": (arch, m)
            for arch in ("splade_xlmr", "splade_bert")
            for m in ((1, 4), (4, 1), (2, 2))}
MOE_CASE = "phi3_5_moe_1x4"
BF16_CASE = "xlmr_1x4_bf16"
# bf16 on (1, 4): the vocab sums (scores, FLOPS in f32) move the loss by
# f32 rounding, and K2's dH summed over model in f32 rounds once, so the
# moments are the unsharded step's to f32 rounding through a bf16 trunk
# (measured at most 1e-6 at SMOKE on (1, 2))
BF16_LOSS_RTOL, BF16_MU_RTOL = 1e-5, 1e-4

_JAX = """
import os, dataclasses
import numpy as np, jax, jax.numpy as jnp
from repro.compat import set_mesh
from repro.configs import get_config
from repro.data.synthetic import lsr_pair_batches
from repro.launch import steps
from repro.models import transformer as tfm
from repro.optim.optimizers import adamw

CASES, PREFILLS = %r, %r
out = {}

def flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat(v, prefix + k + "/")
    else:
        yield prefix[:-1], np.asarray(tree)

def setup(arch, vocab, l1, distill):
    cfg = dataclasses.replace(get_config(arch).SMOKE, compute_dtype="float32",
                              vocab_size=vocab, l1_weight=l1,
                              distill_weight=distill)
    params = tfm.init_params(jax.random.PRNGKey(0), cfg)
    state = {"params": params, "opt": adamw(1e-4).init(params),
             "step": jnp.zeros((), jnp.int32)}
    return cfg, state

def batch(vocab):
    b = next(lsr_pair_batches(batch=%d, q_len=%d, d_len=%d, vocab=vocab))
    neg = next(lsr_pair_batches(batch=%d, q_len=%d, d_len=%d, vocab=vocab,
                                seed=7))
    margin = np.random.default_rng(3).normal(size=%d).astype(np.float32)
    return {**b, "neg_tokens": neg["d_tokens"], "neg_mask": neg["d_mask"],
            "teacher_margin": margin}

for name, (arch, shape, n_micro, l1, distill, vocab) in CASES.items():
    cfg, state = setup(arch, vocab, l1, distill)
    mesh = jax.make_mesh(shape, ("data", "model"))
    step = steps.build_lsr_train_step(cfg, mesh, n_micro=n_micro,
                                      n_pairs=%d, lr=0.5)
    with set_mesh(mesh):
        new, m = jax.jit(step)(state, {k: jnp.asarray(v)
                                       for k, v in batch(vocab).items()})
    out[name + "|loss"] = np.asarray(m["loss"])
    for k, v in flat(new["opt"]["mu"]):
        out[name + "|mu|" + k] = v

for name, (arch, shape) in PREFILLS.items():
    cfg, state = setup(arch, get_config(arch).SMOKE.vocab_size, 0.0, 0.0)
    mesh = jax.make_mesh(shape, ("data", "model"))
    b = batch(cfg.vocab_size)
    with set_mesh(mesh):
        y = jax.jit(steps.build_lsr_prefill_step(cfg, mesh, %d))(
            state["params"], {"tokens": jnp.asarray(b["q_tokens"]),
                              "mask": jnp.asarray(b["q_mask"])})
    out[name + "|y"] = np.asarray(y)
np.savez(os.environ["OUT"], **out)
"""


def _batch(vocab):
    """The pair batch both sides draw (hard negatives from another seed,
    teacher margins from numpy)."""
    b = next(lsr_pair_batches(batch=PAIRS, q_len=Q_LEN, d_len=D_LEN,
                              vocab=vocab))
    neg = next(lsr_pair_batches(batch=PAIRS, q_len=Q_LEN, d_len=D_LEN,
                                vocab=vocab, seed=7))
    margin = np.random.default_rng(3).normal(size=PAIRS).astype(np.float32)
    return {**b, "neg_tokens": neg["d_tokens"], "neg_mask": neg["d_mask"],
            "teacher_margin": margin}


def _jax_state(arch, vocab):
    """The JAX package's SMOKE init at ``vocab``, as numpy."""
    cfg = dataclasses.replace(jax_config(arch).SMOKE, vocab_size=vocab)
    params = jax_tfm.init_params(jax.random.PRNGKey(0), cfg)
    state = {"params": params, "opt": jax_adamw(1e-4).init(params),
             "step": jnp.zeros((), jnp.int32)}
    return jax.tree.map(np.asarray, state)


def _case(name, arch, mesh, n_micro, l1, distill, vocab, impl="kernel"):
    return {"name": name, "arch": arch, "mesh": mesh, "n_micro": n_micro,
            "l1": l1, "distill": distill, "vocab": vocab, "impl": impl,
            "pairs": PAIRS, "state": _jax_state(arch, vocab),
            "batch": _batch(vocab)}


def _unsharded(case):
    """The port's unsharded step on the same state and batch: (loss,
    moments by leaf name)."""
    cfg = train_cfg(case)
    state = state_from_jax(case["state"], cfg, "cpu")
    new, m = steps.build_lsr_train_step(cfg, n_micro=case["n_micro"],
                                        lr=0.5)(state,
                                                torch_batch(case["batch"]))
    return float(m["loss"]), {k: v.numpy()
                              for k, v in tree_items(new["opt"]["mu"]).items()}


@pytest.fixture(scope="module")
def runs():
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "jax.npz"
        proc = start_jax(_JAX % (CASES, PREFILLS, PAIRS, Q_LEN, D_LEN, PAIRS,
                                 Q_LEN, D_LEN, PAIRS, PAIRS, PAIRS), out)
        cases = [_case(name, *spec) for name, spec in CASES.items()]
        cases.append(_case(MOE_CASE, "phi3_5_moe", (1, 4), 1, 0.0, 0.0,
                           jax_config("phi3_5_moe").SMOKE.vocab_size))
        cases.append({**_case(BF16_CASE, "splade_xlmr", (1, 4), 1, 1e-3,
                              0.0, 1024), "dtype": "bfloat16"})
        prefills = []
        for name, (arch, mesh) in PREFILLS.items():
            vocab = jax_config(arch).SMOKE.vocab_size
            p = _case(name, arch, mesh, 1, 0.0, 0.0, vocab)
            p["rows"] = PAIRS
            p["batch"] = {"tokens": p["batch"]["q_tokens"],
                          "mask": p["batch"]["q_mask"]}
            prefills.append(p)
        moe = _case("moe_2x2", "phi3_5_moe", (2, 2), 1, 0.0, 0.0,
                    cases[-1]["vocab"])
        prefills.append({**moe, "rows": PAIRS, "batch": {
            "tokens": moe["batch"]["q_tokens"],
            "mask": moe["batch"]["q_mask"]}})
        ranks = world(train_rank, cases, prefills)
        ref = finish_jax(proc, out)
    unsharded = {c["name"]: _unsharded(c) for c in cases}
    return {"cases": {c["name"]: c for c in cases},
            "prefills": {p["name"]: p for p in prefills},
            "ranks": ranks, "jax": ref, "unsharded": unsharded}


def _mu_close(got, want, where):
    for name, w in want.items():
        tol = MU_TOL * max(float(np.abs(w).max()), 1e-30)
        diff = float(np.abs(got[name] - w).max())
        assert diff <= tol, f"{where}: {name} differs by {diff} > {tol}"


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_loss_matches_jax(runs, case):
    want = float(runs["jax"][case + "|loss"])
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["cases"][case]["loss"], want,
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_moments_match_jax(runs, case):
    prefix = case + "|mu|"
    want = {k[len(prefix):]: v for k, v in runs["jax"].items()
            if k.startswith(prefix)}
    got = runs["ranks"][0]["cases"][case]["mu"]
    assert set(got) == set(want)
    _mu_close(got, want, case)


@pytest.mark.parametrize("case", list(CASES) + [MOE_CASE])
def test_sharded_step_matches_the_unsharded_step(runs, case):
    loss, mu = runs["unsharded"][case]
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["cases"][case]["loss"], loss,
                                   rtol=LOSS_RTOL)
    _mu_close(runs["ranks"][0]["cases"][case]["mu"], mu, case)


@pytest.mark.parametrize("case", list(CASES) + [MOE_CASE, BF16_CASE])
def test_every_rank_leaves_the_step_with_the_same_bits(runs, case):
    first = runs["ranks"][0]["cases"][case]
    assert first["step"] == 1
    for r in runs["ranks"][1:]:
        assert r["cases"][case]["digest"] == first["digest"]
        assert r["cases"][case]["step"] == 1


def test_bf16_sharded_step_matches_the_unsharded_step(runs):
    """At bf16 compute on (1, 4) (splade_xlmr SMOKE, the kernel head's
    plain versions): the loss and each leaf's first moments (relative
    norm) those of the port's unsharded step."""
    loss, mu = runs["unsharded"][BF16_CASE]
    got = runs["ranks"][0]["cases"][BF16_CASE]
    np.testing.assert_allclose(got["loss"], loss, rtol=BF16_LOSS_RTOL)
    for name, want in mu.items():
        rel = np.linalg.norm(got["mu"][name] - want) / max(
            np.linalg.norm(want), 1e-30)
        assert rel <= BF16_MU_RTOL, (name, rel)


def test_non_divisible_vocab_warns_keeps_the_impl_and_gathers():
    """splade_bert at V 510 on model 4: the JAX factory's warning, the
    spec's ``kernel`` impl kept (called once a rank by the prefill, on
    the whole vocabulary), and the gathered objective equal to the
    unsharded loss."""
    case = _case("fallback", "splade_bert", (1, 4), 1, 1e-3, 0.0, 510)
    out = world(fallback_rank, case)
    loss, _ = _unsharded(case)
    for r in out:
        assert any("vocab 510 not divisible by 4 'model' shards" in w
                   and "'kernel'" in w for w in r["warnings"])
        assert r["kernel_calls"] == [(PAIRS, 510)]
        np.testing.assert_allclose(r["loss"], loss, rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", list(PREFILLS))
def test_prefill_blocks_match_jax(runs, name):
    arch, mesh = PREFILLS[name]
    blocks = [r["prefill"][name]["y"] for r in runs["ranks"]]
    want = runs["jax"][name + "|y"]
    got = assemble(blocks, want.shape, (("data",), ("model",)), mesh)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(PREFILLS))
def test_prefill_blocks_equal_the_unsharded_prefill(runs, name):
    p = runs["prefills"][name]
    cfg = train_cfg(p)
    params = state_from_jax(p["state"], cfg, "cpu")["params"]
    want = steps.build_lsr_prefill_step(cfg)(params,
                                             torch_batch(p["batch"])).numpy()
    blocks = [r["prefill"][name]["y"] for r in runs["ranks"]]
    got = assemble(blocks, want.shape, (("data",), ("model",)), p["mesh"])
    np.testing.assert_array_equal(got, want)


def test_an_moe_config_under_a_mesh_says_the_expert_parallel_path_waits(runs):
    for r in runs["ranks"]:
        for msgs in (r["prefill"]["moe_2x2"]["warnings"],
                     r["cases"][MOE_CASE]["warnings"]):
            assert any("expert-parallel MoE is not ported" in m
                       and "10f" in m for m in msgs), msgs


@pytest.mark.parametrize("build", ["decode", "recsys_train", "retrieval",
                                   "build_step"])
def test_the_other_steps_still_refuse_a_mesh_naming_item_10(build):
    """Decode and ``build_step`` refuse a mesh, naming item 10g; the recsys
    steps take one (``tests/test_torch_recsys_mesh.py``) and refuse
    specs without it."""
    from repro_torch.configs import get_config
    from repro_torch.configs.specs import cell_spec

    refusal = ((ValueError, "give the mesh")
               if build in ("recsys_train", "retrieval")
               else (NotImplementedError, "item 10g"))
    with pytest.raises(refusal[0], match=refusal[1]):
        if build == "decode":
            steps.build_decode_step(get_config("llama3_2_3b").SMOKE,
                                    mesh=object())
        elif build == "recsys_train":
            steps.build_recsys_train_step(get_config("xdeepfm").SMOKE,
                                          param_specs=object())
        elif build == "retrieval":
            steps.build_retrieval_step(get_config("xdeepfm").SMOKE,
                                       param_specs=object())
        else:
            steps.build_step("splade_xlmr",
                             cell_spec("splade_xlmr", "train_16"),
                             mesh=object())


def test_a_step_built_for_n_pairs_refuses_another_batch():
    with pytest.raises(RuntimeError, match="built for 4"):
        world(wrong_batch_rank, _batch(512), n=2)
