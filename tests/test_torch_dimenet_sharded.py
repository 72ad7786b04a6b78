"""DimeNet's row-sharded path in the port (``forward``,
``forward_dense_triplets`` and ``forward_graph`` with ``shard_axes=`` and
``mesh=``, ``gnn_loss`` and ``build_gnn_train_step`` over a mesh) against
the JAX package's ``shard_axes`` path, on the CPU.

The cases (``_torch_mesh_ranks.GNN_CASES``): the dense ``(E, K)`` and the
flat triplet layouts, at SMOKE and at CONFIG width, on batches of 8
molecules of 8 atoms and 16 edges (K 4 at SMOKE, 8 at CONFIG), in each
loss branch (graph, node mask, seeds), on the meshes (4,), (2, 2) and
(1, 2). "graph" order is the reference's own layout (molecules in graph
order, padded triplet slots on edge 0), on which the capacity rule drops
requests; "uniform" shuffles the node and edge ids and points padded
slots at random edges, and nothing drops. Ranks are gloo worlds of four
and two; the JAX side runs once in a subprocess with four forced host
devices, ``Auto`` axis types, each case jitted under ``set_mesh``, the
reference step's loss and ``build_gnn_train_step(shard_axes=)``.

Held: the node outputs (each rank's block, put together), the graph
outputs (on every rank), the loss and the gradients (summed over the
axes, the same bits on every rank) equal JAX's sharded ones, dropped
requests included; where no take or sum dropped a request (every flat
case, every uniform one), they also equal the port's unsharded path;
one sharded train step equals the jitted JAX step, and every rank holds
the same state bytes after it. ``launch.steps.gnn_batch_block`` cuts the
node, edge and triplet rows alone.

Tolerances (f32, sums in other orders): graph outputs and losses atol
1e-5 + rtol 1e-5 elementwise; node outputs within 1e-5, and gradients,
params and moments within 1e-4, of the array's largest |value| (at least
1): the untrained CONFIG's node sums and gradients reach ~500, and an
element that cancels to ~1 keeps their rounding (measured: 5e-5 on a
node output of 0.57, 0.04 on gradient elements of ~490). The drop-heavy
cases run at SMOKE width only: a dropped ``vec_in`` row reads zeros, its
distance is 1e-6, the envelope's ``1 / d`` makes its basis ~1e6, and at
CONFIG width the outputs reach ~3e4, where the summation order alone
moves them by ~0.1.
"""

import dataclasses
import os
import tempfile
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from _torch_mesh_ranks import (GNN_CASES, GNN_GRAPHS, finish_jax, gnn_cfg,
                               gnn_rank, start_jax, world)
from repro.configs import get_config as jax_config
from repro.data import synthetic as jax_data
from repro.models import dimenet as jax_dimenet
from repro.sparse import triplets as jax_triplets
from repro_torch.launch import steps

ATOL = RTOL = 1e-5
GRAD_TOL = 1e-4


def _leaf_close(got, want, tol=GRAD_TOL):
    """``got`` within ``tol`` of ``want``'s largest |value| (at least 1)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max(initial=0)))
    assert np.abs(np.asarray(got) - want).max(initial=0) <= tol * scale


_JAX = """
import dataclasses, os, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.compat import set_mesh
from repro.configs import get_config
from repro.configs.specs import CellSpec
from repro.launch import steps as jax_steps
from repro.models import dimenet as jd
from repro.optim.optimizers import adamw
sys.path.insert(0, %r)
from _torch_mesh_ranks import GNN_CASES, GNN_GRAPHS, GNN_LR

inp = np.load(os.environ["IN"])
out = {}
for seed, case in enumerate(GNN_CASES):
    name, axes = case["name"], tuple(case["axes"])
    n = int(np.prod(case["mesh"]))
    mesh = jax.make_mesh(tuple(case["mesh"]), axes,
                         axis_types=(AxisType.Auto,) * len(axes),
                         devices=jax.devices()[:n])
    cfg = dataclasses.replace(getattr(get_config("dimenet"), case["width"]),
                              d_feat=case["d_feat"])
    params = jd.init_params(jax.random.PRNGKey(seed), cfg)
    batch = {k.split("|")[1]: jnp.asarray(inp[k]) for k in inp.files
             if k.split("|")[0] == name}
    n_graphs = GNN_GRAPHS if case["loss"] == "graph" else 0

    def loss_fn(p, b):   # launch/steps.py build_gnn_train_step's loss_fn,
        if n_graphs:     # with its prediction as aux
            pred = jd.forward_graph(p, cfg, b, n_graphs, shard_axes=axes)
            err = pred - b["target"]
            return jnp.mean(err * err), pred
        pred = jd.forward(p, cfg, b, shard_axes=axes)
        if "seed_ids" in b:
            err = jnp.take(pred, b["seed_ids"], axis=0) - b["target"]
            return jnp.mean(err * err), pred
        err = (pred - b["target"]) * b["node_mask"].astype(pred.dtype)[:, None]
        return (jnp.sum(err * err)
                / jnp.maximum(jnp.sum(b["node_mask"]), 1.0)), pred

    def run(p, b):
        (loss, pred), grads = jax.value_and_grad(loss_fn, has_aux=True)(p, b)
        return pred, loss, jax.tree.leaves(grads)

    with set_mesh(mesh):
        pred, loss, grads = jax.jit(run)(params, batch)
        if case["step"]:
            cell = CellSpec("dimenet", name, "gnn_train", {},
                            n_graphs=n_graphs)
            state = {"params": params, "opt": adamw(GNN_LR).init(params),
                     "step": jnp.zeros((), jnp.int32)}
            new, m = jax.jit(jax_steps.build_gnn_train_step(
                cfg, cell, lr=GNN_LR, shard_axes=axes))(state, batch)
            out[name + "|step_loss"] = np.asarray(m["loss"])
            for part, tree in (("params", new["params"]),
                               ("mu", new["opt"]["mu"]),
                               ("nu", new["opt"]["nu"])):
                for i, leaf in enumerate(jax.tree.leaves(tree)):
                    out[f"{name}|{part}|{i}"] = np.asarray(leaf)
    out[name + ("|graph" if n_graphs else "|node")] = np.asarray(pred)
    out[name + "|loss"] = np.asarray(loss)
    for i, g in enumerate(grads):
        out[f"{name}|grad|{i}"] = np.asarray(g)
np.savez(os.environ["OUT"], **out)
"""


def _jax_cfg(case):
    return dataclasses.replace(getattr(jax_config("dimenet"), case["width"]),
                               d_feat=case["d_feat"])


def _batch(case, seed):
    """8 molecules (``molecule_batches``), the case's loss inputs, ids in
    the case's order, its triplet layout."""
    b = next(jax_data.molecule_batches(n_graphs=GNN_GRAPHS, nodes_per_graph=8,
                                       edges_per_graph=16, seed=seed))
    rng = np.random.default_rng(seed)
    N, E = len(b["node_mask"]), len(b["edge_src"])
    K = gnn_cfg(case).max_triplets_per_edge
    if case["d_feat"]:
        b["node_feat"] = rng.normal(size=(N, case["d_feat"])).astype(
            np.float32)
    b["node_mask"][-3:] = 0
    if case["loss"] == "node":
        b["target"] = rng.normal(size=(N, 1)).astype(np.float32)
    elif case["loss"] == "seed":
        b["seed_ids"] = rng.choice(N, 6, replace=False).astype(np.int32)
        b["target"] = rng.normal(size=(6, 1)).astype(np.float32)
    if case["order"] == "uniform":
        perm = rng.permutation(N)            # node i becomes node perm[i]
        inv = np.argsort(perm)
        for key in ("positions", "node_feat", "node_mask", "node_graph_id"):
            b[key] = b[key][inv]
        if case["loss"] == "node":
            b["target"] = b["target"][inv]
        if "seed_ids" in b:
            b["seed_ids"] = perm[b["seed_ids"]].astype(np.int32)
        order = rng.permutation(E)
        for key in ("edge_src", "edge_dst", "edge_mask"):
            b[key] = b[key][order]
        b["edge_src"] = perm[b["edge_src"]].astype(np.int32)
        b["edge_dst"] = perm[b["edge_dst"]].astype(np.int32)
    t_in, t_out = jax_triplets.build_triplets(b["edge_src"], b["edge_dst"], N,
                                              max_per_edge=K)
    if case["layout"] == "flat":
        T, pad = len(t_in), (-len(t_in)) % 4
        b["t_in"] = np.concatenate([t_in, np.zeros(pad, np.int32)])
        b["t_out"] = np.concatenate([t_out, np.zeros(pad, np.int32)])
        b["t_mask"] = (np.arange(T + pad) < T).astype(np.int32)
    else:
        dense, mask = jax_triplets.densify_triplets(t_in, t_out, E, K)
        if case["order"] == "uniform":
            dense = np.where(mask > 0, dense,
                             rng.integers(0, E, dense.shape)).astype(np.int32)
        b["t_in_dense"], b["t_mask_dense"] = dense, mask
    return b


def _state_np(params):
    zeros = jax.tree.map(np.zeros_like, params)
    return {"params": params, "opt": {"mu": zeros,
                                      "nu": jax.tree.map(np.copy, zeros)},
            "step": 0}


@pytest.fixture(scope="module")
def runs():
    batches, params, states = {}, {}, {}
    for seed, case in enumerate(GNN_CASES):
        batches[case["name"]] = _batch(case, seed)
        params[case["name"]] = jax.tree.map(
            np.asarray, jax_dimenet.init_params(jax.random.PRNGKey(seed),
                                                _jax_cfg(case)))
        if case["step"]:
            states[case["name"]] = _state_np(params[case["name"]])
    with tempfile.TemporaryDirectory() as tmp:
        inp, out = Path(tmp) / "in.npz", Path(tmp) / "jax.npz"
        np.savez(inp, **{f"{name}|{k}": v for name, b in batches.items()
                         for k, v in b.items()})
        os.environ["IN"] = str(inp)
        try:
            proc = start_jax(_JAX % str(Path(__file__).parent), out)
        finally:
            del os.environ["IN"]
        ranks = {}
        for size in (4, 2):
            cases = [c for c in GNN_CASES if np.prod(c["mesh"]) == size]
            ranks[size] = world(gnn_rank, cases, batches, params, states,
                                n=size)
        ref = finish_jax(proc, out)
    return ranks, ref


def _case(name):
    return next(c for c in GNN_CASES if c["name"] == name)


def _ranks(runs, case):
    return runs[0][int(np.prod(case["mesh"]))]


def _node_blocks(ranks, case):
    """The ranks' node blocks in the row-major order of the mesh axes (all
    of them the shard axes): rank order."""
    return np.concatenate([r[case["name"]]["sharded"]["node"]
                           for r in ranks])


NAMES = [c["name"] for c in GNN_CASES]


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_the_jax_sharded_path(runs, name):
    """The node outputs put together (the graph outputs on every rank for
    a graph loss: the JAX side returns the prediction its loss takes)."""
    case = _case(name)
    ranks, ref = _ranks(runs, case), runs[1]
    if case["loss"] != "graph":
        _leaf_close(_node_blocks(ranks, case), ref[name + "|node"], ATOL)
        return
    for r in ranks:
        np.testing.assert_allclose(r[name]["sharded"]["graph"],
                                   ref[name + "|graph"], atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradients_match_jax_grad(runs, name):
    case = _case(name)
    ranks, ref = _ranks(runs, case), runs[1]
    first = ranks[0][name]["sharded"]
    np.testing.assert_allclose(first["loss"], float(ref[name + "|loss"]),
                               atol=ATOL, rtol=RTOL)
    grads = list(first["grads"].values())
    assert len(grads) == len([k for k in ref if k.startswith(name + "|grad|")])
    for i, g in enumerate(grads):
        _leaf_close(g, ref[f"{name}|grad|{i}"])
    for r in ranks[1:]:
        assert r[name]["sharded"]["loss"] == first["loss"]
        for a, b in zip(r[name]["sharded"]["grads"].values(), grads):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", NAMES)
def test_drops_where_the_reference_drops_and_unsharded_where_none(runs,
                                                                  name):
    case = _case(name)
    ranks = _ranks(runs, case)
    rec = ranks[0][name]
    drops = [n for _, n in rec["sharded"]["drops"]]
    for r in ranks:   # the counts are summed over the axes
        assert [n for _, n in r[name]["sharded"]["drops"]] == drops
    assert rec["one"]["drops"] == []
    if case["layout"] == "flat":
        assert drops == []      # gathers and psum_scatters: nothing to drop
    elif case["order"] == "uniform":
        assert len(drops) > 0 and not any(drops)
    else:                       # the reference's layout drops requests
        assert sum(drops) > 0
        return
    one = rec["one"]
    _leaf_close(_node_blocks(ranks, case), one["node"], ATOL)
    np.testing.assert_allclose(rec["sharded"]["graph"], one["graph"],
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(rec["sharded"]["loss"], one["loss"],
                               atol=ATOL, rtol=RTOL)
    for a, b in zip(rec["sharded"]["grads"].values(), one["grads"].values()):
        _leaf_close(a, b)


@pytest.mark.parametrize("name", [c["name"] for c in GNN_CASES
                                  if c["step"]])
def test_sharded_train_step_matches_jax_and_every_rank_holds_its_bytes(
        runs, name):
    case = _case(name)
    ranks, ref = _ranks(runs, case), runs[1]
    steps_ = [r[name]["step"] for r in ranks]
    assert len({s["digest"] for s in steps_}) == 1
    np.testing.assert_allclose(steps_[0]["loss"],
                               float(ref[name + "|step_loss"]), atol=ATOL,
                               rtol=RTOL)
    for part, leaves in steps_[0]["state"].items():
        for i, leaf in enumerate(leaves.values()):
            _leaf_close(leaf, ref[f"{name}|{part}|{i}"])


def test_batch_block_cuts_node_edge_and_triplet_rows_only():
    b = _batch(dict(GNN_CASES[0], layout="flat", loss="seed"), 0)
    b["t_in"], b["t_out"], b["t_mask"] = (v[:64] for v in (
        b["t_in"], b["t_out"], b["t_mask"]))
    for i in range(4):
        mesh = SimpleNamespace(axis_names=("x", "y"),
                               shape={"x": 2, "y": 2},
                               coords={"x": i // 2, "y": i % 2})
        blk = steps.gnn_batch_block(b, mesh, ("x", "y"))
        for key, v in b.items():
            if key in ("seed_ids", "target"):
                np.testing.assert_array_equal(blk[key], v)
            else:
                n = len(v) // 4
                np.testing.assert_array_equal(blk[key], v[i * n:(i + 1) * n])
