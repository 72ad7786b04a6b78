"""``sparse/distributed.py`` in the port against the JAX package's
``distributed_take_local`` and ``distributed_segment_sum_local`` under
``shard_map``, on the CPU.

Meshes (4,) over ``x``, (2, 2) over ``(x, y)`` and over ``(y, x)`` (the
row-major order of a reversed tuple), in a world of four gloo ranks, and
(1, 2) over ``(x, y)`` in a world of two; the JAX side once in a
subprocess with four forced host devices, ``Auto`` axis types, its calls
jitted under ``set_mesh``. Cases (``_torch_mesh_ranks.dist_inputs``):
uniform ids (nothing drops), graph-order ids with a third of them 0, as
padding asks (heavy drops), ids below 0 and at or past ``n *
rows_local``, and 3 ids a shard (fewer than 4 n). For each: the take's
rows, the segment sum's output, both dropped counts (summed over the
axes, the same on every rank) and the gradients of the table and of the
values equal the reference's exactly (integers in f32: every sum is
exact). The capacity formula is held to the reference's on a grid.
"""

import tempfile
from pathlib import Path

import numpy as np
import pytest

from _torch_mesh_ranks import (DIST_CASES, DIST_MESHES, dist_id,
                               distributed_rank, finish_jax, start_jax,
                               world)

_JAX = """
import os, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType, PartitionSpec as P
from repro.compat import set_mesh, shard_map
from repro.sparse.distributed import (distributed_segment_sum_local,
                                      distributed_take_local)
sys.path.insert(0, %r)
from _torch_mesh_ranks import (DIST_CASES, DIST_MESHES, DIST_ROWS,
                               dist_id, dist_inputs)

out = {}
for shape, axes, shard in DIST_MESHES:
    n = int(np.prod(shape))
    mesh = jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes),
                         devices=jax.devices()[:n])
    ROW, REP = P(shard, None), P()
    take = shard_map(lambda t, i: distributed_take_local(
        t, i, axis_names=shard), mesh=mesh, in_specs=(ROW, P(shard)),
        out_specs=(ROW, REP), check_vma=False)
    seg = shard_map(lambda v, i: distributed_segment_sum_local(
        v, i, DIST_ROWS, axis_names=shard), mesh=mesh,
        in_specs=(ROW, P(shard)), out_specs=(ROW, REP), check_vma=False)
    for case in DIST_CASES:
        x = {k: jnp.asarray(v) for k, v in dist_inputs(case, n).items()}
        with set_mesh(mesh):
            rows, dropped = jax.jit(take)(x["table"], x["idx"])
            g_t = jax.jit(jax.grad(lambda t: jnp.sum(
                take(t, x["idx"])[0] * x["w_take"])))(x["table"])
            summed, s_dropped = jax.jit(seg)(x["vals"], x["idx"])
            g_v = jax.jit(jax.grad(lambda v: jnp.sum(
                seg(v, x["idx"])[0] * x["w_sum"])))(x["vals"])
        key = dist_id((shape, axes, shard)) + "|" + case
        for name, v in (("take", rows), ("take_dropped", dropped),
                        ("take_grad", g_t), ("sum", summed),
                        ("sum_dropped", s_dropped), ("sum_grad", g_v)):
            out[key + "|" + name] = np.asarray(v)
np.savez(os.environ["OUT"], **out)
"""


@pytest.fixture(scope="module")
def runs():
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "jax.npz"
        proc = start_jax(_JAX % str(Path(__file__).parent), out)
        four = [m for m in DIST_MESHES if np.prod(m[0]) == 4]
        two = [m for m in DIST_MESHES if np.prod(m[0]) == 2]
        ranks = {4: world(distributed_rank, four),
                 2: world(distributed_rank, two, n=2)}
        ref = finish_jax(proc, out)
    return ranks, ref


def _blocks(ranks, mesh, case, name):
    """The ranks' blocks of ``name`` in the order of the shard axes."""
    from repro_torch.launch.mesh import as_axes

    shape, axes, shard = mesh
    order = []
    for r in range(len(ranks)):
        coords = dict(zip(axes, np.unravel_index(r, shape)))
        i = 0
        for a in as_axes(shard):
            i = i * shape[axes.index(a)] + int(coords[a])
        order.append((i, r))
    return np.concatenate([ranks[r][(dist_id(mesh), case)][name]
                           for _, r in sorted(order)])


@pytest.mark.parametrize("case", DIST_CASES)
@pytest.mark.parametrize("mesh", DIST_MESHES,
                         ids=[dist_id(m) for m in DIST_MESHES])
@pytest.mark.parametrize("op", ["take", "sum"])
def test_matches_shard_map_with_its_drops_and_gradients(runs, mesh, case,
                                                        op):
    ranks, ref = runs
    ranks = ranks[int(np.prod(mesh[0]))]
    key = f"{dist_id(mesh)}|{case}|{op}"
    np.testing.assert_array_equal(_blocks(ranks, mesh, case, op), ref[key])
    np.testing.assert_array_equal(_blocks(ranks, mesh, case, op + "_grad"),
                                  ref[key + "_grad"])
    for rank in ranks:
        assert rank[(dist_id(mesh), case)][op + "_dropped"] == \
            int(ref[key + "_dropped"])


@pytest.mark.parametrize("mesh", DIST_MESHES,
                         ids=[dist_id(m) for m in DIST_MESHES])
def test_the_cases_drop_what_they_are_meant_to(runs, mesh):
    ranks, _ = runs
    rec = ranks[int(np.prod(mesh[0]))][0]
    assert rec[(dist_id(mesh), "uniform")]["take_dropped"] == 0
    assert rec[(dist_id(mesh), "small_r")]["take_dropped"] == 0
    assert rec[(dist_id(mesh), "graph_order")]["take_dropped"] > 0
    assert rec[(dist_id(mesh), "graph_order")]["sum_dropped"] > 0


@pytest.mark.parametrize("R", [1, 3, 7, 64, 1000, 21504])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("cap", [1.0, 1.25, 2.0])
def test_capacity_is_the_reference_s(R, n, cap):
    from repro.sparse.distributed import _capacity as ref
    from repro_torch.sparse.distributed import _capacity

    assert _capacity(R, n, cap) == ref(R, n, cap)
