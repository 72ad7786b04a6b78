"""The row-sharded embedding tables of the port
(``sparse/sharded_embedding.py``) against the JAX package's, on the CPU.

``make_sharded_lookup`` on a (32, 8) table over ``model`` and over
``("model", "data")`` on each mesh of (1, 4), (4, 1) and (2, 2), on a
``(5,)`` and a ``(4, 6)`` id array (ids outside the table among them),
against JAX's under ``shard_map`` in a subprocess with four forced host
devices (whose body takes a flat id vector: the ``(4, 6)`` ids go to it
flat, and its rows come back in their shape); the port's side in a world
of four gloo ranks. Then
``row_sharded_take``, the lookup of the recsys mesh steps, on planted
ids (negative, past the table, past its negative end) against
``take_rows`` (``jnp.take``'s rule), with the ids whole on every rank
and split over ``data``; ``pad_table_rows``, ``table_sharding`` and
``init_tables``.

Tolerances: the forward is exact (each output row is one rank's row plus
zeros); the table's gradient within 1e-6 (repeated ids add their
cotangents in each package's own order).
"""

import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_ranks import (MESHES, embedding_rank, finish_jax, mesh_id,
                               start_jax, world)
from repro.sparse import sharded_embedding as jax_se
from repro_torch.sparse import sharded_embedding as se
from repro_torch.sparse.embedding_bag import embedding_lookup as take_rows

GRAD_ATOL = 1e-6
ROWS, DIM = 32, 8

_JAX = """
import os
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.compat import set_mesh
from repro.sparse.sharded_embedding import make_sharded_lookup

CASES = %r
AXES = {"model": "model", "model_data": ("model", "data")}
z = dict(np.load(%r))
table = jnp.asarray(z["table"])
out = {}
for name, (shape, key) in CASES.items():
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:shape[0] * shape[1]])
    lookup = make_sharded_lookup(mesh, axis_name=AXES[key])
    # the reference's body takes a flat id vector: (B, T) ids go flat
    shape_ids = z[name + "|ids"].shape
    ids = jnp.asarray(z[name + "|ids"].reshape(-1))
    cot = jnp.asarray(z[name + "|cot"].reshape(ids.shape[0], -1))
    with set_mesh(mesh):
        out[name + "|out"] = np.asarray(jax.jit(lookup)(table, ids)).reshape(
            shape_ids + (-1,))
        out[name + "|grad"] = np.asarray(jax.jit(jax.grad(
            lambda t: jnp.sum(lookup(t, ids) * cot)))(table))
np.savez(os.environ["OUT"], **out)
"""

IDS = {"flat": np.array([0, 5, 17, 31, 8], np.int32),
       "bt": np.random.default_rng(1).integers(-4, 40, (4, 6)).astype(
           np.int32)}
CASES = {f"{mesh_id(shape)}_{key}_{ids}": (shape, key, ids)
         for shape in MESHES for key in ("model", "model_data")
         for ids in IDS}
# negative (wrapping), past the table, past its negative end, repeated
PLANTED = np.array([[0, -1, 31], [32, -32, 16], [-33, 100, 7],
                    [15, 8, -17], [24, 24, -8], [9, 40, 23],
                    [-31, 1, 30], [31, 0, -64]], np.int32)


def _table():
    return np.random.default_rng(0).normal(size=(ROWS, DIM)).astype(
        np.float32)


@pytest.fixture(scope="module")
def runs():
    table = _table()
    rng = np.random.default_rng(2)
    cases = {name: (shape, key, IDS[ids], rng.normal(
        size=IDS[ids].shape + (DIM,)).astype(np.float32))
        for name, (shape, key, ids) in CASES.items()}
    with tempfile.TemporaryDirectory() as tmp:
        inp, out = Path(tmp) / "in.npz", Path(tmp) / "jax.npz"
        np.savez(inp, table=table, **{
            f"{name}|{part}": arr for name, (_, _, ids, cot) in cases.items()
            for part, arr in (("ids", ids), ("cot", cot))})
        proc = start_jax(_JAX % ({n: (s, k) for n, (s, k, _, _)
                                  in cases.items()}, str(inp)), out)
        ranks = world(embedding_rank, table, cases, PLANTED)
        ref = finish_jax(proc, out)
    return {"ranks": ranks, "jax": ref, "table": table, "cases": cases}


def _planted_ref(table):
    """``take_rows`` on the whole table at PLANTED: the rows, and the
    table's gradient of the sum of the rows that are not NaN."""
    t = torch.from_numpy(table).requires_grad_(True)
    got = take_rows(t, torch.from_numpy(PLANTED))
    torch.nan_to_num(got).sum().backward()
    return got.detach().numpy(), t.grad.numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_lookup_equals_jax_s_under_shard_map(runs, name):
    want = runs["jax"][f"{name}|out"]
    for rank in runs["ranks"]:
        np.testing.assert_array_equal(rank[name][0], want)


@pytest.mark.parametrize("name", list(CASES))
def test_lookup_gradient_equals_jax_s(runs, name):
    want = runs["jax"][f"{name}|grad"]
    for rank in runs["ranks"]:
        np.testing.assert_allclose(rank[name][1], want, atol=GRAD_ATOL)


@pytest.mark.parametrize("name", [n for n in CASES if n.endswith("bt")])
def test_ids_outside_every_block_read_zero(runs, name):
    """The reference's rule for ``sharded_lookup_local``: an id outside
    the table (negative ones included) reads 0, not NaN, and wraps
    nowhere."""
    ids = runs["cases"][name][2]
    got = runs["ranks"][0][name][0]
    outside = (ids < 0) | (ids >= ROWS)
    assert outside.any() and (~outside).any()
    assert (got[outside] == 0).all()
    np.testing.assert_array_equal(got[~outside],
                                  runs["table"][ids[~outside]])


@pytest.mark.parametrize("layout", ["whole", "split"])
@pytest.mark.parametrize("key", ["model", "model_data"])
def test_row_sharded_take_keeps_take_rows_rule(runs, layout, key):
    """On planted ids ``row_sharded_take`` gives ``take_rows``' rows bit for
    bit (a negative id wraps, one outside the table after that reads
    NaN) on every rank, and the table's gradient (NaN rows pass none)."""
    rows, grad = _planted_ref(runs["table"])
    for rank in runs["ranks"]:
        got, got_grad = rank[f"take_{layout}_{key}"]
        np.testing.assert_array_equal(got, rows)
        np.testing.assert_allclose(got_grad, grad, atol=GRAD_ATOL)


def test_take_rows_rule_is_jnp_take_s_on_the_planted_ids():
    table = _table()
    rows, _ = _planted_ref(table)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(PLANTED),
                               axis=0))
    np.testing.assert_array_equal(rows, want)
    nan = np.isnan(rows).all(axis=-1)
    assert nan.any() and not np.isnan(rows[~nan]).any()
    assert ((PLANTED[nan] >= ROWS) | (PLANTED[nan] < -ROWS)).all()


@pytest.mark.parametrize("rows,n", [(32, 4), (33, 4), (1, 2), (100, 7),
                                    (1000001, 4), (0, 3)])
def test_pad_table_rows_is_the_reference_s(rows, n):
    assert se.pad_table_rows(rows, n) == jax_se.pad_table_rows(rows, n)


@pytest.mark.parametrize("axis", ["model", ("model", "data")])
def test_table_sharding_is_the_rows_over_the_axes(axis):
    got = se.table_sharding(None, axis)
    assert got == ((axis,) if isinstance(axis, str) else axis, None)


def test_init_tables_shapes_and_scale():
    sizes, dim = (100, 4097, 33), 64
    got = se.init_tables(torch.Generator().manual_seed(0), sizes, dim,
                         n_shards=4)
    want = jax_se.init_tables(jax.random.PRNGKey(0), sizes, dim, n_shards=4)
    assert [tuple(t.shape) for t in got] == [w.shape for w in want]
    assert all(t.dtype == torch.float32 and t.device.type == "cpu"
               for t in got)
    std = torch.cat([t.reshape(-1) for t in got]).std().item()
    assert abs(std - dim ** -0.5) < 0.03 * dim ** -0.5
    again = se.init_tables(torch.Generator().manual_seed(0), sizes, dim,
                           n_shards=4, dtype=torch.float64)
    assert [t.dtype for t in again] == [torch.float64] * 3
