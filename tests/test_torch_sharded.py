"""The vocab-sharded head and the objectives over it (``core/sharded.py``,
``head_api.make_head(mesh=)``, ``losses.gathered_infonce``) against the
JAX package's ``shard_map`` versions, on the CPU, on the (1, 4), (4, 1)
and (2, 2) (data, model) meshes.

The JAX side runs once in a subprocess with four forced host devices,
each function jitted on the global arrays with ``jax.value_and_grad``;
the port's once in a world of four gloo ranks, each rank calling the
function on its blocks (``core.sharded.local_block``) and
differentiating its own output (the function's scalar, or ``sum(out *
c)`` with its block of the cotangent ``c``). The blocks are put back
together by the specs of ``head_shardings``; blocks that several ranks
hold must be the same bits on each. ``∇E`` and ``∇b``, which every rank
holds whole for its rows of the batch, are summed over ``data``.

Inputs: B 8, S 12, D 16, V 64 (bias, a mask with empty positions), f32,
one numpy seed; the heads at vocab tile 16; InfoNCE at temperature 0.5.
The reps are positive: at an exact 0 the gradient of ``|x|`` is 1 in
JAX and 0 in PyTorch (a head's reps are 0 only where its relu passes no
gradient, so the train step never sees the difference).
The JAX heads are ``sparton`` (its Pallas kernel does not run here); the
port's ``kernel`` head runs the plain versions of K1-K3 on the CPU.
Tolerance: 1e-5 relative to the largest |value| of each output or
gradient (f32 sums in another order; measured at most 3.6e-6).
"""

import tempfile
from pathlib import Path

import numpy as np
import pytest

from _torch_mesh_ranks import (MESHES, SHARDED_FNS, assemble, finish_jax,
                               mesh_id, sharded_rank, start_jax, world)

B, S, D, V = 8, 12, 16, 64
TOL = 1e-5

_JAX = """
import os
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import set_mesh, shard_map
from repro.core import sharded as sh
from repro.core.head_api import HeadSpec, make_head
from repro.losses.contrastive import gathered_infonce

x = dict(np.load(os.environ["OUT"] + ".in.npz"))
out = {}
ba = ("data",)
for shape in %r:
    mesh = jax.make_mesh(shape, ("data", "model"))
    key = "x".join(map(str, shape))
    head = make_head(HeadSpec(impl="sparton", vocab_tile=16), mesh=mesh,
                     batch_axes=ba)
    sp_head = sh.sharded_sparton_head(mesh, batch_axes=ba, vocab_tile=16)
    sim = sh.sharded_similarity(mesh, batch_axes=ba)
    inf = sh.sharded_infonce(mesh, batch_axes=ba, temperature=0.5)
    fl = sh.sharded_flops_reg(mesh, batch_axes=ba)
    l1 = sh.sharded_l1_reg(mesh, batch_axes=ba)
    rd = sh.sharded_row_dots(mesh, batch_axes=ba)

    def gathered(axes):
        return shard_map(
            lambda a, c: gathered_infonce(a, c, axis_names=axes,
                                          temperature=0.5),
            mesh=mesh, in_specs=(P(axes, None), P(axes, None)),
            out_specs=P(), check_vma=False)

    def with_head(h):
        def f(H, E, b):
            y = h(H, E, b, x["mask"])
            return jnp.sum(y * x["cy"]), y
        return f, (x["H"], x["E"], x["b"])

    fns = {
        "make_head_sparton": with_head(head),
        "make_head_kernel": with_head(head),
        "sparton_head": with_head(sp_head),
        "similarity": (lambda q, d: (jnp.sum(sim(q, d) * x["cs"]),
                                     sim(q, d)), (x["q"], x["d"])),
        "infonce": (lambda q, d: (inf(q, d), inf(q, d)), (x["q"], x["d"])),
        "flops": (lambda q: (fl(q), fl(q)), (x["q"],)),
        "l1": (lambda q: (l1(q), l1(q)), (x["q"],)),
        "row_dots": (lambda q, d: (jnp.sum(rd(q, d) * x["cr"]), rd(q, d)),
                     (x["q"], x["d"])),
        "gathered_data": (lambda q, d: (gathered(ba)(q, d),) * 2,
                          (x["q"], x["d"])),
        "gathered_all": (lambda q, d: (gathered(("data", "model"))(q, d),)
                         * 2, (x["q"], x["d"])),
    }
    for name, (f, args) in fns.items():
        g = jax.jit(jax.value_and_grad(f, tuple(range(len(args))),
                                       has_aux=True))
        with set_mesh(mesh):
            (_, y), grads = g(*args)
        out[f"{key}|{name}|y"] = np.asarray(y)
        for i, gr in enumerate(grads):
            out[f"{key}|{name}|g{i}"] = np.asarray(gr)
np.savez(os.environ["OUT"], **out)
"""


def _inputs():
    rng = np.random.default_rng(11)
    f = np.float32
    mask = (rng.random((B, S)) > 0.25).astype(np.int32)
    mask[:, 0] = 1
    mask[3, 5:] = 0
    return {"H": rng.normal(size=(B, S, D)).astype(f),
            "E": (rng.normal(size=(V, D)) * 0.3).astype(f),
            "b": (rng.normal(size=V) * 0.1).astype(f), "mask": mask,
            "q": (np.abs(rng.normal(size=(B, V))) + 0.01).astype(f),
            "d": (np.abs(rng.normal(size=(B, V))) + 0.01).astype(f),
            "cy": rng.normal(size=(B, V)).astype(f),
            "cs": rng.normal(size=(B, B)).astype(f),
            "cr": rng.normal(size=B).astype(f)}


@pytest.fixture(scope="module")
def runs():
    x = _inputs()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "jax.npz"
        np.savez(str(out) + ".in.npz", **x)
        proc = start_jax(_JAX % (MESHES,), out)
        ranks = world(sharded_rank, x)
        ref = finish_jax(proc, out)
    return ranks, ref


REP = (("data",), ("model",))
H_SPEC = (("data",), None, None)


def _specs(name):
    """Each output's and gradient's spec: None for a value every rank
    holds whole, "data_sum" for a gradient to be summed over ``data``."""
    if name.startswith(("make_head", "sparton_head")):
        return REP, [H_SPEC, "data_sum", "data_sum"]
    if name.startswith("gathered"):
        axes = ("data",) if name == "gathered_data" else ("data", "model")
        return None, [(axes, None)] * 2
    n_in = 1 if name in ("flops", "l1") else 2
    y = {"similarity": (("data",), None), "row_dots": (("data",),)}
    return y.get(name), [REP] * n_in


def _global(blocks, spec, shape, mesh):
    if spec is None:
        for b in blocks[1:]:
            assert np.array_equal(b, blocks[0]), "replicated value differs"
        return blocks[0]
    if spec == "data_sum":
        n_model = mesh[1]
        rows = [blocks[r * n_model:(r + 1) * n_model] for r in range(mesh[0])]
        for row in rows:
            for b in row[1:]:
                assert np.array_equal(b, row[0]), "model ranks differ"
        return np.sum([row[0] for row in rows], axis=0)
    return assemble(blocks, shape, spec, mesh)


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    diff = float(np.abs(np.asarray(got) - want).max())
    assert diff <= TOL * scale, f"{what}: {diff} > {TOL} x {scale}"


CASES = [(m, f) for m in MESHES for f in SHARDED_FNS]
IDS = [f"{mesh_id(m)}-{f}" for m, f in CASES]


@pytest.mark.parametrize("mesh,name", CASES, ids=IDS)
def test_forward_matches_jax(runs, mesh, name):
    ranks, ref = runs
    key = f"{mesh_id(mesh)}|{name}"
    want = ref[key + "|y"]
    y_spec, _ = _specs(name)
    got = _global([r[(mesh_id(mesh), name)]["y"] for r in ranks], y_spec,
                  want.shape, mesh)
    _close(got, want, key)


@pytest.mark.parametrize("mesh,name", CASES, ids=IDS)
def test_gradients_match_jax(runs, mesh, name):
    ranks, ref = runs
    key = f"{mesh_id(mesh)}|{name}"
    _, g_specs = _specs(name)
    for i, spec in enumerate(g_specs):
        want = ref[f"{key}|g{i}"]
        got = _global([r[(mesh_id(mesh), name)]["grads"][i] for r in ranks],
                      spec, want.shape, mesh)
        _close(got, want, f"{key} grad {i}")


def test_head_shardings_and_local_block():
    """The specs are the JAX package's ``head_shardings`` PartitionSpecs;
    ``local_block`` cuts the block a rank of each mesh holds."""
    from types import SimpleNamespace

    from repro_torch.core.sharded import head_shardings, local_block

    mesh = SimpleNamespace(shape={"data": 2, "model": 2},
                           axis_names=("data", "model"),
                           coords={"data": 1, "model": 0})
    specs = head_shardings(mesh, batch_axes=("data",))
    assert specs == {"H": (("data",), None, None), "E": (("model",), None),
                     "b": (("model",),), "mask": (("data",), None),
                     "Y": (("data",), ("model",))}
    y = np.arange(4 * 6).reshape(4, 6)
    np.testing.assert_array_equal(local_block(mesh, specs["Y"], y),
                                  y[2:4, 0:3])
    with pytest.raises(ValueError, match="not distinct axes"):
        head_shardings(mesh)   # the JAX default names "pod", absent here
