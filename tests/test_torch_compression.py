"""``optim/compression.py`` against the JAX package's
``repro/optim/compression.py`` on the CPU: the int8 quantizer, the
error-feedback tree compression and the flat layout in-process, and
``compressed_allreduce`` over a mesh axis in a world of four gloo ranks
against the JAX function under ``shard_map`` (a subprocess with four
forced host devices): over ``data`` of a (4,) mesh and over ``model`` of
a (2, 2) one, twice, the residual of the first call carried into the
second. The quantizer is exact; the means agree with the JAX function's
to 1e-6 of the leaf's largest |value| (the dequantized chunks are summed
in rank order, XLA's reduction may order them otherwise), the residuals
to 4 ulp of the largest |gradient| (XLA fuses ``corrected - q * s`` into
one FMA, so the two differ by an ulp of ``q * s`` where they differ), and
each mean lies within the int8
bound of the plain mean: for every element ``M / 127``, ``M`` the mean
over the ranks of ``max |gradient + residual|``, plus the mean residual
carried in.
"""

import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_ranks import (compression_rank, finish_jax, mesh_id,
                               start_jax, world)
from repro.optim import compression as jax_comp
from repro_torch.optim import compression as comp

SETUPS = [((4,), "data"), ((2, 2), "model")]
LEAVES = {"w": ((5, 7), 1.0), "b": ((11,), 0.01), "z/k": ((7,), 100.0)}
CALLS = 2

_JAX = """
import os
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import set_mesh, shard_map
from repro.optim.compression import compressed_allreduce

x = dict(np.load(os.environ["OUT"] + ".in.npz"))
out = {}
for shape, axis in %r:
    key = "x".join(map(str, shape))
    axes = ("data", "model")[:len(shape)]
    mesh = jax.make_mesh(shape, axes)
    spec = P(axes)

    def body(*leaves):
        res, outs = None, []
        for c in range(%d):
            w, b, k = (l[0] for l in leaves[3 * c:3 * c + 3])
            mean, res = compressed_allreduce(
                {"w": w, "b": b, "z": {"k": k}}, res, axis)
            outs += [mean["w"][None], mean["b"][None], mean["z"]["k"][None],
                     res[None]]
        return tuple(outs)

    args = [x[f"{key}|{c}|{n}"] for c in range(%d) for n in ("w", "b", "z/k")]
    fn = shard_map(body, mesh=mesh, in_specs=(spec,) * len(args),
                   out_specs=spec, check_vma=False)
    with set_mesh(mesh):
        res = jax.jit(fn)(*args)
    for c in range(%d):
        for i, n in enumerate(("w", "b", "z/k", "residual")):
            out[f"{key}|{c}|{n}"] = np.asarray(res[4 * c + i])
np.savez(os.environ["OUT"], **out)
"""


def _grads(setup_index, call, rank):
    rng = np.random.default_rng(100 * setup_index + 10 * call + rank)
    return {name: (rng.normal(size=shape) * scale).astype(np.float32)
            for name, (shape, scale) in LEAVES.items()}


def _tree(flat):
    return {"w": flat["w"], "b": flat["b"], "z": {"k": flat["z/k"]}}


@pytest.fixture(scope="module")
def runs():
    inputs = {}
    for i, (shape, _) in enumerate(SETUPS):
        for c in range(CALLS):
            per = [_grads(i, c, r) for r in range(4)]
            for name in LEAVES:
                inputs[f"{mesh_id(shape)}|{c}|{name}"] = np.stack(
                    [g[name] for g in per])
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "jax.npz"
        np.savez(str(out) + ".in.npz", **inputs)
        proc = start_jax(_JAX % (SETUPS, CALLS, CALLS, CALLS), out)
        ported = {}
        for i, (shape, axis) in enumerate(SETUPS):
            calls = [[{k: v for k, v in _tree(_grads(i, c, r)).items()}
                      for r in range(4)] for c in range(CALLS)]
            ported[mesh_id(shape)] = world(compression_rank, calls, shape,
                                           axis)
        ref = finish_jax(proc, out)
    return ported, ref


def _flat_mean(mean):
    return {"w": mean["w"], "b": mean["b"], "z/k": mean["z"]["k"]}


@pytest.mark.parametrize("call", range(CALLS))
@pytest.mark.parametrize("shape,axis", SETUPS,
                         ids=[f"{mesh_id(s)}-{a}" for s, a in SETUPS])
def test_compressed_allreduce_matches_jax(runs, shape, axis, call):
    ported, ref = runs
    key = mesh_id(shape)
    for r, calls in enumerate(ported[key]):
        mean, residual = calls[call]
        for name, got in _flat_mean(mean).items():
            want = ref[f"{key}|{call}|{name}"][r]
            tol = 1e-6 * float(np.abs(want).max())
            assert float(np.abs(got - want).max()) <= tol, (name, r)
        # XLA fuses ``corrected - q * s`` into one FMA, PyTorch rounds the
        # product first: 4 ulp of the largest |gradient|
        i = SETUPS.index((shape, axis))
        top = max(float(np.abs(v).max()) for v in _grads(i, call, r).values())
        want = ref[f"{key}|{call}|residual"][r]
        tol = 4 * np.finfo(np.float32).eps * top
        assert float(np.abs(residual - want).max()) <= tol, ("residual", r)


@pytest.mark.parametrize("call", range(CALLS))
@pytest.mark.parametrize("shape,axis", SETUPS,
                         ids=[f"{mesh_id(s)}-{a}" for s, a in SETUPS])
def test_compressed_allreduce_within_the_int8_bound(runs, shape, axis, call):
    """Each rank's mean against the plain mean of its group's gradients:
    within ``M / 127`` of the mean of ``gradient + residual in``, the same
    bits on every rank of the group."""
    ported, _ = runs
    i = SETUPS.index((shape, axis))
    n_axis = shape[-1] if axis == "model" else shape[0]
    for r, calls in enumerate(ported[mesh_id(shape)]):
        group = ([g * shape[-1] + m for g in [r // shape[-1]]
                  for m in range(shape[-1])] if axis == "model"
                 else list(range(4)))
        assert len(group) == n_axis
        flats = [np.concatenate([_grads(i, call, q)[n].ravel()
                                 for n in ("b", "w", "z/k")])
                 for q in group]
        pad = (-flats[0].size) % n_axis
        res_in = [np.zeros(flats[0].size + pad, np.float32) if call == 0
                  else ported[mesh_id(shape)][q][call - 1][1] for q in group]
        corrected = [np.pad(f, (0, pad)) + res for f, res in
                     zip(flats, res_in)]
        bound = np.mean([np.abs(c).max() for c in corrected]) / 127
        want = np.mean(corrected, axis=0)[:flats[0].size]
        mean, _ = calls[call]
        got = np.concatenate([_flat_mean(mean)[n].ravel()
                              for n in ("b", "w", "z/k")])
        assert np.abs(got - want).max() <= bound * (1 + 1e-5)
        for q in group:
            other, _ = ported[mesh_id(shape)][q][call]
            for n, v in _flat_mean(other).items():
                np.testing.assert_array_equal(v, _flat_mean(mean)[n])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0, 0.0])
def test_compress_int8_matches_jax(dtype, scale):
    x = (np.random.default_rng(4).normal(size=(9, 13)) * scale).astype(
        np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    q_j, s_j = jax_comp.compress_int8(jx)
    q_t, s_t = comp.compress_int8(tx)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    assert float(s_t) == float(s_j)
    np.testing.assert_array_equal(
        comp.decompress_int8(q_t, s_t).numpy(),
        np.asarray(jax_comp.decompress_int8(q_j, s_j)))
    assert comp.decompress_int8(q_t, s_t, torch.bfloat16).dtype == \
        torch.bfloat16


@pytest.mark.parametrize("with_residual", [False, True])
def test_compress_tree_matches_jax(with_residual):
    rng = np.random.default_rng(8)
    grads = {"a": rng.normal(size=(4, 5)).astype(np.float32),
             "b": [rng.normal(size=3).astype(np.float32) * 7,
                   rng.normal(size=(2, 2)).astype(np.float32)]}
    res = (jax.tree.map(lambda g: (g * 0.01).astype(np.float32), grads)
           if with_residual else None)
    out_j = jax_comp.compress_tree(jax.tree.map(jnp.asarray, grads),
                                   None if res is None else
                                   jax.tree.map(jnp.asarray, res))
    to_t = lambda t: jax.tree.map(torch.from_numpy, t)  # noqa: E731
    out_t = comp.compress_tree(to_t(grads),
                               None if res is None else to_t(res))
    for got, want in zip(out_t, out_j):
        for g, w in zip(jax.tree.leaves(jax.tree.map(
                lambda t: t.numpy(), got)), jax.tree.leaves(want)):
            np.testing.assert_array_equal(g, np.asarray(w))


def test_flatten_order_and_round_trip_match_jax():
    rng = np.random.default_rng(9)
    tree = {"z": rng.normal(size=(2, 3)).astype(np.float32),
            "a": {"y": rng.normal(size=4).astype(np.float32),
                  "b": rng.normal(size=(1, 2)).astype(np.float32)}}
    flat_j, _ = jax_comp._flatten(jax.tree.map(jnp.asarray, tree))
    flat_t, spec = comp._flatten(
        {"z": torch.from_numpy(tree["z"]),
         "a": {k: torch.from_numpy(v) for k, v in tree["a"].items()}})
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(flat_j))
    back = comp._unflatten(flat_t * 2, spec)
    assert list(back) == ["z", "a"] and list(back["a"]) == ["y", "b"]
    for k, v in (("z", back["z"]), ("y", back["a"]["y"]),
                 ("b", back["a"]["b"])):
        want = tree[k] if k == "z" else tree["a"][k]
        np.testing.assert_array_equal(v.numpy(), want * 2)
