"""``launch/mesh.py``, ``launch/sharding.py`` and ``collectives.py``
against the JAX package and ``jax.lax``'s collectives under
``shard_map``, on the CPU.

Meshes (1, 4), (4, 1) and (2, 2) over (data, model), and (1, 2, 2) and
(2, 2, 1) over (pod, data, model), in a world of four gloo ranks; the
JAX side once in a subprocess with four forced host devices. Per mesh:
each rank's coordinates are those of device ``rank`` in
``jax.make_mesh`` (row-major); over each tuple of axes (each axis, the
last two in both orders, all of them): ``axis_index`` is the JAX
package's row-major offset, and ``psum``, ``pmean``, ``all_gather``
(tiled), ``all_to_all`` (tiled), ``replicated_input`` and
``shard_rows`` give the outputs and input gradients of
``jax.value_and_grad`` of the ``shard_map`` that computes the same
thing, with the replication of each value as JAX types it (a cotangent
of ``psum``'s output that is the same over the tuple; JAX's implicit
cast of a replicated value into one that differs over the tuple is
``replicated_input``). Exact: the values are small integers in f32.
``batch_axes_for`` and ``batch_spec`` are held against the JAX
package's on meshes of 1, 2 and 3 axes, without a world.
"""

import itertools
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from _torch_mesh_ranks import (MESH_SHAPES, collective_inputs, finish_jax,
                               mesh_id, mesh_rank, mesh_tuples, refusals_rank,
                               start_jax, world)

_JAX = """
import os, itertools
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import axis_size, set_mesh, shard_map
import sys
sys.path.insert(0, %r)
from _torch_mesh_ranks import collective_inputs, mesh_tuples

out = {}
for shape, axes in %r:
    mesh = jax.make_mesh(shape, axes)
    key = "x".join(map(str, shape))
    out[key + "|ids"] = np.array([d.id for d in mesh.devices.flat])
    n_dev = int(np.prod(shape))
    coords = list(itertools.product(*map(range, shape)))
    for t in mesh_tuples(axes):
        others = tuple(a for a in axes if a not in t)
        n_t = int(np.prod([shape[axes.index(a)] for a in t]))
        def other_of(c):
            i = 0
            for a in others:
                i = i * shape[axes.index(a)] + c[axes.index(a)]
            return i
        per = [collective_inputs(r, n_t, other_of(c))
               for r, c in enumerate(coords)]
        stack = lambda k: np.stack([p[k] for p in per])
        n_o = n_dev // n_t
        by_other = lambda k: np.stack([next(p[k] for p, c in zip(per, coords)
                                            if other_of(c) == o)
                                       for o in range(n_o)])
        ALL, OTH = P(axes), P(others if others else None)
        g = {k: stack(k) for k in ("x", "w", "w_ag", "z", "w_a2a",
                                   "w_rows")}
        g["w_inv"], g["x_rep"] = by_other("w_inv"), by_other("x_rep")
        rows = per[0]["rows"]

        def index(x):
            off = jnp.zeros((), jnp.int32)
            for ax in t:
                off = off * axis_size(ax) + jax.lax.axis_index(ax)
            return off[None]

        def ops(x, x2, x3, z, xr, rw):
            x, x2, x3, z, xr = x[0], x2[0], x3[0], z[0], xr[0]
            return {"psum": jax.lax.psum(x, t),
                    "pmean": jax.lax.pmean(x2, t),
                    "all_gather": jax.lax.all_gather(x3.reshape(2, 3), t,
                                                     axis=0, tiled=True),
                    "all_to_all": jax.lax.all_to_all(z, t, 0, 1, tiled=True),
                    "replicated_input": xr, "shard_rows": rw}

        fwd_specs = (ALL, ALL, ALL, ALL, OTH, P(t, None))
        fwd = shard_map(lambda *a: {k: v[None] for k, v in
                                    ops(*a).items()} | {"index": index(a[0])},
                        mesh=mesh, in_specs=fwd_specs, out_specs=ALL,
                        check_vma=False)

        def loss_body(x, x2, x3, z, xr, rw, w_inv, w, w_ag, w_a2a, w_rows):
            y = ops(x, x2, x3, z, xr, rw)
            w_inv, w, w_ag, w_a2a, w_rows = (w_inv[0], w[0], w_ag[0],
                                              w_a2a[0], w_rows[0])
            return (jnp.sum(y["psum"] * w_inv)[None],
                    jnp.sum(y["pmean"] * w_inv)[None],
                    jnp.sum(y["all_gather"] * w_ag)[None],
                    jnp.sum(y["all_to_all"] * w_a2a)[None],
                    jnp.sum(y["replicated_input"] * w)[None],
                    jnp.sum(y["shard_rows"] * w_rows)[None])

        body = shard_map(loss_body, mesh=mesh,
                         in_specs=fwd_specs + (OTH, ALL, ALL, ALL, ALL),
                         out_specs=(OTH, OTH, ALL, ALL, ALL, ALL))
        args = (g["x"], g["x"], g["x"], g["z"], g["x_rep"], rows)
        ws = (g["w_inv"], g["w"], g["w_ag"], g["w_a2a"], g["w_rows"])
        loss = lambda *a: sum(jnp.sum(o) for o in body(*a, *ws))
        with set_mesh(mesh):
            y = jax.jit(fwd)(*args)
            grads = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(*args)
        tk = key + "|" + ",".join(t)
        for k, v in y.items():
            out[tk + "|y|" + k] = np.asarray(v)
        for k, v in zip(("psum", "pmean", "all_gather", "all_to_all",
                         "replicated_input", "shard_rows"), grads):
            out[tk + "|g|" + k] = np.asarray(v)
np.savez(os.environ["OUT"], **out)
"""


@pytest.fixture(scope="module")
def runs():
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "jax.npz"
        proc = start_jax(_JAX % (str(Path(__file__).parent), MESH_SHAPES),
                         out)
        ranks = world(mesh_rank)
        ref = finish_jax(proc, out)
    return ranks, ref


MESHES = [mesh_id(s) for s, _ in MESH_SHAPES]
TUPLES = [(mesh_id(s), t) for s, axes in MESH_SHAPES
          for t in mesh_tuples(axes)]
TUPLE_IDS = [f"{m}-{'.'.join(t)}" for m, t in TUPLES]
OPS = ("psum", "pmean", "all_gather", "all_to_all", "replicated_input",
       "shard_rows")


def _shape(key):
    return next((s, a) for s, a in MESH_SHAPES if mesh_id(s) == key)


@pytest.mark.parametrize("key", MESHES)
def test_coordinates_are_jax_make_mesh_s(runs, key):
    ranks, ref = runs
    shape, axes = _shape(key)
    ids = ref[key + "|ids"]
    for pos, c in enumerate(itertools.product(*map(range, shape))):
        assert ranks[int(ids[pos])][key]["coords"] == list(c)
    for r in ranks:
        assert r[key]["device"] == "cpu"
        assert r[key]["batch_axes"] == tuple(a for a in axes if a != "model")
        assert r[key]["n_batch_shards"] == int(np.prod(
            [n for n, a in zip(shape, axes) if a != "model"]))


@pytest.mark.parametrize("key,t", TUPLES, ids=TUPLE_IDS)
def test_axis_index_size_and_group(runs, key, t):
    ranks, ref = runs
    tk = f"{key}|{','.join(t)}"
    for r, rec in enumerate(ranks):
        assert rec[key][("index", t)] == int(ref[tk + "|y|index"][r])
        group = rec[key][("ranks", t)]
        assert len(group) == rec[key][("size", t)] and r in group
        assert group[rec[key][("index", t)]] == r
        for other in group:   # one group, the same order, on every member
            assert ranks[other][key][("ranks", t)] == group


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("key,t", TUPLES, ids=TUPLE_IDS)
def test_collective_and_its_gradient_match_shard_map(runs, key, t, op):
    ranks, ref = runs
    tk = f"{key}|{','.join(t)}"
    shape, axes = _shape(key)
    want_y, want_g = ref[f"{tk}|y|{op}"], ref[f"{tk}|g|{op}"]
    for r, rec in enumerate(ranks):
        y, g = rec[key][(op, t)]
        np.testing.assert_array_equal(y, want_y[r])
        if op == "replicated_input":     # JAX: the grad of the global x_rep
            other = _other(r, shape, axes, t)
            np.testing.assert_array_equal(g, want_g[other])
        elif op != "shard_rows":
            np.testing.assert_array_equal(g, want_g[r])
    if op == "shard_rows":   # every rank holds its group's whole gradient
        groups = {}
        for r, rec in enumerate(ranks):
            groups.setdefault(_other(r, shape, axes, t), rec[key][(op, t)][1])
        np.testing.assert_array_equal(sum(groups.values()), want_g)


def _other(r, shape, axes, t):
    c = np.unravel_index(r, shape)
    i = 0
    for a, n, ci in zip(axes, shape, c):
        if a not in t:
            i = i * n + int(ci)
    return i


@pytest.mark.parametrize("key,t", TUPLES, ids=TUPLE_IDS)
def test_broadcast_takes_the_first_rank_of_the_tuple(runs, key, t):
    ranks, _ = runs
    for rec in ranks:
        src = rec[key][("ranks", t)][0]
        other = rec[key][("ranks", t)].index(src)
        np.testing.assert_array_equal(
            rec[key][("broadcast", t)],
            collective_inputs(src, len(rec[key][("ranks", t)]), 0)["w"])
        assert other == 0


def _fake_mesh(shape, axes):
    return SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))


FAKE = [((8,), ("data",)), ((4, 2), ("data", "model")),
        ((2, 4), ("data", "model")), ((3, 5), ("pod", "data")),
        ((2, 3, 4), ("pod", "data", "model")),
        ((2, 16, 16), ("pod", "data", "model")),
        ((16, 16), ("data", "model"))]


@pytest.mark.parametrize("shape,axes", FAKE,
                         ids=[mesh_id(s) for s, _ in FAKE])
@pytest.mark.parametrize("n", [1, 2, 3, 6, 12, 16, 32, 96])
def test_batch_axes_for_and_batch_spec_match_jax(shape, axes, n):
    from repro.launch import mesh as jax_mesh
    from repro.launch import sharding as jax_sharding
    from repro_torch.launch import mesh, sharding

    m = _fake_mesh(shape, axes)
    assert sharding.batch_axes_for(m, n) == jax_sharding.batch_axes_for(m, n)
    for rank in (1, 3):   # a PartitionSpec writes a 1-tuple as its name
        want = tuple((e,) if isinstance(e, str) else e
                     for e in jax_sharding.batch_spec(m, n, rank))
        assert sharding.batch_spec(m, n, rank) == want
    assert mesh.batch_axes(m) == jax_mesh.batch_axes(m)
    assert mesh.n_batch_shards(m) == jax_mesh.n_batch_shards(m)


def test_meshes_refuse_a_world_of_another_size():
    out = world(refusals_rank, n=2)
    for r in out:
        assert "needs a world of 256 ranks" in r["production"]
        assert "needs a world of 512 ranks" in r["multi_pod"]
        assert "holds 4 ranks, the world has 2" in r["wrong_size"]
        assert r["default_axes"] == ("data", "model")


def test_a_mesh_needs_an_initialised_world():
    from repro_torch.launch.mesh import Mesh

    with pytest.raises(RuntimeError, match="init_process_group"):
        Mesh((1,), ("data",), device="cpu")
