"""The recsys train, serve and retrieval steps over a mesh
(``launch/steps.build_recsys_train_step(mesh=, param_specs=, zero_specs=)``,
``build_recsys_serve_step(cfg, mesh, param_specs)``,
``build_retrieval_step(cfg, mesh)``) against the JAX package's steps on
the same specs and the port's unsharded steps, on the CPU.

All four families at their SMOKE widths with ``table_sizes`` replaced
(``RECSYS_MESH_SIZES``) so that each spec of ``recsys_param_specs``
occurs: a table of 1003520 padded rows over ``("model", "data")``, one
of 143360 over ``model``, the rest whole (DIEN's one table is the large
one). The JAX side runs once in a subprocess with four forced host
devices: the state placed by ``state_shardings(recsys_param_specs(...),
..., "adagrad")`` with ``device_put``, the step jitted with those
``param_specs`` and ``zero_specs`` under ``set_mesh`` (as
``dryrun.run_cell`` builds it, but run), the serve step on params so
placed and a batch split over the batch axes, ``build_retrieval_step(cfg,
mesh)`` on candidates split over every axis. The port's side runs in a
world of four gloo ranks on each mesh of (1, 4), (4, 1) and (2, 2). Both
start from the JAX init (``PRNGKey(0)``) carried by
``weights.recsys_params_from_jax``.

The train batch draws its ids in the large tables uniformly, so that
every block of them is read; the planted batch adds negative ids (read
wrapped); the served batch also ids past either end of a table (read as
NaN: its rows' probabilities are NaN, the others finite). A table of
1M rows is compared at its probe rows (every row an id of the batches
can reach, and a few others); every other row must keep its bits, as
Adagrad leaves a row no id touched.

Tolerances (f32):
* against JAX, the train step's loss rtol 1e-5 and every state element
  atol 1e-6 plus rtol 1e-5 (``test_torch_recsys_train``'s, measured at
  most 3.0e-8 there), probabilities atol 1e-6;
* against the port's unsharded step, loss rtol 1e-6, state atol 1e-7 plus
  rtol 1e-6 (the mesh sums the batch's rows in other groupings: psums of
  partial gradients and of the loss; measured at most 3.0e-8),
  probabilities atol 1e-7;
* retrieval ids equal (ties to the lowest id), values atol 1e-5.
"""

import dataclasses
import pickle
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_mesh_ranks import (MESHES, RECSYS_MESH_SIZES, finish_jax,
                               mesh_id, one_rank_mesh, recsys_mesh_cfg,
                               recsys_mesh_rank, recsys_probe, start_jax,
                               torch_batch, world)
from repro.configs import get_config as jax_config
from repro.data import synthetic as jax_data
from repro.models import recsys as jax_recsys
from repro_torch.launch import sharding as S
from repro_torch.launch import steps
from repro_torch.models.recsys import padded_rows
from repro_torch.optim.optimizers import adagrad
from repro_torch.tree import tree_items
from repro_torch.weights import recsys_params_from_jax

ARCHS = tuple(RECSYS_MESH_SIZES)
LR, B, B_SERVE = 0.05, 32, 16
JAX_LOSS_RTOL, JAX_ATOL, JAX_RTOL = 1e-5, 1e-6, 1e-5
PORT_LOSS_RTOL, PORT_ATOL, PORT_RTOL = 1e-6, 1e-7, 1e-6
JAX_PROB_ATOL, PORT_PROB_ATOL, VAL_ATOL = 1e-6, 1e-7, 1e-5
PROBE_MIN_ROWS = 65536
# name: (candidates, k); "short": 8 rows a rank at four ranks, below k
RETRIEVAL = {"main": (4000, 10), "short": (32, 12)}

_JAX = """
import dataclasses, os, pickle
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.compat import set_mesh
from repro.configs import get_config
from repro.launch import steps
from repro.launch.sharding import (batch_shardings, recsys_param_specs,
                                   state_shardings)
from repro.optim.optimizers import adagrad

SIZES, MESHES, LR = %r
with open(%r, "rb") as f:
    cases = pickle.load(f)
out = {}

def flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat(v, prefix + k + "/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flat(v, prefix + str(i) + "/")
    else:
        yield prefix[:-1], np.asarray(tree)

def put(batch, mesh):
    arrs = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.device_put(arrs, batch_shardings(mesh, arrs))

for arch, case in cases.items():
    cfg = dataclasses.replace(get_config(arch).SMOKE,
                              table_sizes=SIZES[arch])
    params = jax.tree.map(jnp.asarray, case["params"])
    state = {"params": params, "opt": adagrad(LR).init(params),
             "step": jnp.zeros((), jnp.int32)}
    for shape in MESHES:
        tag = arch + "|" + "x".join(map(str, shape))
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:shape[0] * shape[1]])
        sh = state_shardings(recsys_param_specs(cfg, mesh),
                             jax.eval_shape(lambda: params), "adagrad", mesh)
        step = jax.jit(steps.build_recsys_train_step(
            cfg, lr=LR, param_specs=sh["params"],
            zero_specs=sh["opt"]["acc"]))
        with set_mesh(mesh):
            placed = jax.device_put(state, sh)
            kinds = ("train", "planted") if shape == (2, 2) else ("train",)
            for kind in kinds:
                new, m = step(placed, put(case[kind], mesh))
                out[tag + "|" + kind + "|loss"] = np.asarray(m["loss"])
                for k, v in flat({"params": new["params"],
                                  "opt": new["opt"]}):
                    rows = case["probes"][k]
                    out[tag + "|" + kind + "|" + k] = (
                        v[rows] if rows is not None else v)
            serve = jax.jit(steps.build_recsys_serve_step(cfg))
            out[tag + "|serve"] = np.asarray(serve(
                placed["params"], put(case["serve"], mesh)))
            axes = tuple(mesh.axis_names)
            for name, ret in case["retrieval"].items():
                batch = {k: jax.device_put(jnp.asarray(v),
                                           NamedSharding(mesh, P()))
                         for k, v in ret["batch"].items()}
                batch["candidates"] = jax.device_put(
                    jnp.asarray(ret["candidates"]),
                    NamedSharding(mesh, P(axes, None)))
                retrieve = jax.jit(steps.build_retrieval_step(
                    cfg, mesh, k=ret["k"]))
                v, i = retrieve(placed["params"], batch)
                out[tag + "|" + name + "|v"] = np.asarray(v)
                out[tag + "|" + name + "|i"] = np.asarray(i)
np.savez(os.environ["OUT"], **out)
"""


def _batch(cfg, n, seed):
    """A ``recsys_batches`` draw of n rows, the ids of every table of at
    least 131072 rows drawn uniformly over it instead (the zipf draw
    reads only its first rows, one block)."""
    b = next(jax_data.recsys_batches(
        batch=n, n_dense=cfg.n_dense, n_sparse=cfg.n_sparse,
        table_sizes=cfg.table_sizes, seq_len=cfg.seq_len, seed=seed))
    rng = np.random.default_rng(seed + 100)
    if cfg.seq_len:
        rows = cfg.table_sizes[0]
        b["hist_idx"] = rng.integers(0, rows, b["hist_idx"].shape,
                                     dtype=np.int32)
        b["target_idx"] = rng.integers(0, rows, (n,), dtype=np.int32)
        return b
    for f, rows in enumerate(cfg.table_sizes):
        if rows >= 131072:
            b["sparse_idx"][:, f] = rng.integers(0, rows, n, dtype=np.int32)
    return b


def _plant(cfg, b, past):
    """Negative ids that wrap (to the last row, row 0 and the middle row of
    each table) in rows 0-2; with ``past`` also ids past either end of a
    table in rows 3 and 4."""
    b = {k: v.copy() for k, v in b.items()}
    if cfg.seq_len:
        cols = [(b["hist_idx"], (slice(None), 0), padded_rows(
            cfg.table_sizes[0])), (b["target_idx"], (slice(None),),
                                   padded_rows(cfg.table_sizes[0]))]
    else:
        cols = [(b["sparse_idx"], (slice(None), f), padded_rows(rows))
                for f, rows in enumerate(cfg.table_sizes)]
    for arr, where, n in cols:
        col = arr[where]
        col[:3] = (-1, -n, -(n // 2))
        if past:
            col[3:5] = (n + 2, -n - 1)
        arr[where] = col
    return b


def _probes(cfg, params, batches):
    """For each state leaf of at least PROBE_MIN_ROWS rows: every row an id
    of ``batches`` reaches (wrapped) and four more; else None."""
    ids = np.concatenate([v.reshape(-1) for b in batches for k, v in b.items()
                          if k.endswith("idx")]).astype(np.int64)
    out = {}
    for name, leaf in tree_items(params).items():
        rows = leaf.shape[0]
        probe = None
        if rows >= PROBE_MIN_ROWS:
            hit = ids[(ids >= -rows) & (ids < rows)] % rows
            probe = np.unique(np.concatenate(
                [hit, [0, 1, rows // 2, rows - 1]]))
        for part in ("params", "opt/acc"):
            out[f"{part}/{name}"] = probe
    return out


def _retrieval(cfg, params, seed):
    """Each RETRIEVAL case: a 3-row query batch (a wrapped negative id in
    it) and candidates; in "main" the best candidate of query 0 copied to
    two later shards' rows (exact ties, which go to the lowest id)."""
    out = {}
    for name, (n, k) in RETRIEVAL.items():
        batch = _plant(cfg, _batch(cfg, 3, seed), past=False)
        C = np.random.default_rng(seed).normal(
            size=(n, cfg.embed_dim)).astype(np.float32)
        if name == "main":
            qv = steps.recsys_model.user_embedding(
                params, cfg, torch_batch(batch))
            best = int((qv[0] @ torch.from_numpy(C).T).argmax())
            C[(best + 2 * n // 4) % n] = C[best]
            C[(best + n // 4 + 5) % n] = C[best]
        out[name] = {"batch": batch, "candidates": C, "k": k}
    return out


def _case(arch):
    cfg = recsys_mesh_cfg(arch)
    jcfg = dataclasses.replace(jax_config(arch).SMOKE,
                               table_sizes=cfg.table_sizes)
    params = jax.tree.map(np.asarray, jax_recsys.init_params(
        jax.random.PRNGKey(0), jcfg))
    port = recsys_params_from_jax(params, cfg, "cpu")
    train = _batch(cfg, B, 1)
    planted = _plant(cfg, train, past=False)
    serve = _plant(cfg, _batch(cfg, B_SERVE, 2), past=True)
    return {"params": params, "train": train, "planted": planted,
            "serve": serve, "lr": LR,
            "probes": _probes(cfg, port, [train, planted]),
            "retrieval": _retrieval(cfg, port, 3)}


def _unsharded(arch, case):
    """The port's unsharded steps on the same inputs: the train and planted
    steps' losses and probed states, the serve probabilities and each
    retrieval's result."""
    cfg = recsys_mesh_cfg(arch)
    params = recsys_params_from_jax(case["params"], cfg, "cpu")
    state = {"params": params, "opt": adagrad(LR).init(params), "step": 0}
    step = steps.build_recsys_train_step(cfg, lr=LR)
    out = {}
    for kind in ("train", "planted"):
        new, m = step(state, torch_batch(case[kind]))
        got = {k: v.numpy() for k, v in tree_items(
            {"params": new["params"], "opt": new["opt"]}).items()}
        out[kind] = {"loss": float(m["loss"]),
                     "state": {k: recsys_probe(v, case["probes"][k])
                               for k, v in got.items()}}
    out["serve"] = steps.build_recsys_serve_step(cfg)(
        params, torch_batch(case["serve"])).numpy()
    out["retrieval"] = {}
    for name, ret in case["retrieval"].items():
        batch = torch_batch(ret["batch"])
        batch["candidates"] = torch.from_numpy(ret["candidates"])
        v, i = steps.build_retrieval_step(cfg, k=ret["k"])(params, batch)
        out["retrieval"][name] = (v.numpy(), i.numpy())
    return out


@pytest.fixture(scope="module")
def runs():
    cases = {arch: _case(arch) for arch in ARCHS}
    with tempfile.TemporaryDirectory() as tmp:
        path, out = Path(tmp) / "cases.pkl", Path(tmp) / "jax.npz"
        with open(path, "wb") as f:
            pickle.dump(cases, f)
        proc = start_jax(_JAX % ((RECSYS_MESH_SIZES, MESHES, LR),
                                 str(path)), out)
        ranks = world(recsys_mesh_rank, str(path), timeout=400)
        ref = finish_jax(proc, out)
    return {"cases": cases, "ranks": ranks, "jax": ref,
            "unsharded": {arch: _unsharded(arch, cases[arch])
                          for arch in ARCHS}}


CELLS = [(arch, shape) for arch in ARCHS for shape in MESHES]
IDS = [f"{arch}-{mesh_id(shape)}" for arch, shape in CELLS]


def _jax_state(runs, arch, shape, kind):
    tag = f"{arch}|{mesh_id(shape)}|{kind}|"
    ref = runs["jax"]
    return (float(ref[tag + "loss"]),
            {k[len(tag):]: v for k, v in ref.items()
             if k.startswith(tag) and not k.endswith("|loss")})


def _hold(got, loss, state, loss_rtol, atol, rtol):
    np.testing.assert_allclose(got["loss"], loss, rtol=loss_rtol)
    assert set(got["state"]) == set(state)
    for key, want in state.items():
        np.testing.assert_allclose(got["state"][key], want, atol=atol,
                                   rtol=rtol, err_msg=key)


@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_train_step_matches_the_jax_step_on_the_specs(runs, arch, shape):
    got = runs["ranks"][0][(arch, shape)]["train"]
    _hold(got, *_jax_state(runs, arch, shape, "train"), JAX_LOSS_RTOL,
          JAX_ATOL, JAX_RTOL)


@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_train_step_matches_the_unsharded_step(runs, arch, shape):
    want = runs["unsharded"][arch]["train"]
    for rank in runs["ranks"]:
        np.testing.assert_allclose(rank[(arch, shape)]["train"]["loss"],
                                   want["loss"], rtol=PORT_LOSS_RTOL)
    _hold(runs["ranks"][0][(arch, shape)]["train"], want["loss"],
          want["state"], PORT_LOSS_RTOL, PORT_ATOL, PORT_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_planted_negative_ids_wrap_as_in_the_unsharded_step(runs, arch):
    """On (2, 2), the batch with negative ids: the same step as the
    unsharded one's and the JAX step's on the specs."""
    got = runs["ranks"][0][(arch, (2, 2))]["planted"]
    want = runs["unsharded"][arch]["planted"]
    _hold(got, want["loss"], want["state"], PORT_LOSS_RTOL, PORT_ATOL,
          PORT_RTOL)
    _hold(got, *_jax_state(runs, arch, (2, 2), "planted"), JAX_LOSS_RTOL,
          JAX_ATOL, JAX_RTOL)
    assert got["loss"] != runs["ranks"][0][(arch, (2, 2))]["train"]["loss"]


@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_rows_no_id_touched_keep_their_bits(runs, arch, shape):
    assert runs["ranks"][0][(arch, shape)]["train"]["rest_kept"]


@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_each_rank_holds_exactly_the_specs_bytes(runs, arch, shape):
    whole = 2 * sum(np.asarray(v).nbytes for v in tree_items(
        runs["cases"][arch]["params"]).values())
    for rank in runs["ranks"]:
        rec = rank[(arch, shape)]
        assert rec["nbytes"] == rec["spec_nbytes"] < whole


@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_ranks_holding_a_block_hold_the_same_bits(runs, arch, shape):
    """After the step every leaf's block is the same bits on each rank whose
    coordinates agree on the axes its spec names; the step counter
    advanced."""
    recs = [rank[(arch, shape)] for rank in runs["ranks"]]
    for leaf, axes in recs[0]["axes"].items():
        groups = {}
        for rec in recs:
            key = tuple(rec["coords"][a] for a in axes)
            groups.setdefault(key, set()).add(rec["train"]["blocks"][leaf])
        assert all(len(d) == 1 for d in groups.values()), leaf
    assert all(rec["train"]["step"] == 1 for rec in recs)


@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_new_state_on_a_mesh_is_the_cut_global_state(runs, arch, shape):
    assert all(rank[(arch, shape)]["new_state_is_shard_state"]
               for rank in runs["ranks"])


@pytest.mark.parametrize("arch", ARCHS)
def test_every_spec_of_the_tables_occurs(runs, arch):
    axes = runs["ranks"][0][(arch, (2, 2))]["axes"]
    tables = {k: v for k, v in axes.items() if k.startswith("params/")
              and ("tables" in k or "item_table" in k)}
    want = {("model", "data")} if arch == "dien" else {
        (), ("model",), ("model", "data")}
    assert set(tables.values()) == want


@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_serve_matches_jax_s_and_the_unsharded_step(runs, arch, shape):
    """Every rank returns the whole batch's probabilities: those of JAX's
    serve step on the specs and of the unsharded step; the rows with an
    id past a table's end NaN, the others finite."""
    want = runs["unsharded"][arch]["serve"]
    ref = runs["jax"][f"{arch}|{mesh_id(shape)}|serve"]
    nan = np.isnan(want)
    assert nan[3:5].all() and not nan[:3].any() and not nan[5:].any()
    for rank in runs["ranks"]:
        got = rank[(arch, shape)]["serve"]
        assert got.shape == (B_SERVE,)
        np.testing.assert_allclose(got, want, atol=PORT_PROB_ATOL)
        np.testing.assert_allclose(got, ref, atol=JAX_PROB_ATOL)


@pytest.mark.parametrize("name", list(RETRIEVAL))
@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_retrieval_matches_jax_s_and_the_unsharded_step(runs, arch, shape,
                                                       name):
    """The same ids as JAX's sharded step and the unsharded step on every
    rank (ties to the lowest id; in "short", k past each rank's rows, the
    padding as the reference pads), the values within VAL_ATOL."""
    v1, i1 = runs["unsharded"][arch]["retrieval"][name]
    tag = f"{arch}|{mesh_id(shape)}|{name}|"
    vj, ij = runs["jax"][tag + "v"], runs["jax"][tag + "i"]
    for rank in runs["ranks"]:
        v, i = rank[(arch, shape)]["retrieval"][name]
        np.testing.assert_array_equal(i, ij)
        np.testing.assert_allclose(v, vj, atol=VAL_ATOL)
        if name == "main":
            np.testing.assert_array_equal(i, i1)
            np.testing.assert_allclose(v, v1, atol=VAL_ATOL)


def test_main_retrieval_holds_exact_ties_in_id_order(runs):
    _, i = runs["ranks"][0][("wide_deep", (2, 2))]["retrieval"]["main"]
    v, _ = runs["ranks"][0][("wide_deep", (2, 2))]["retrieval"]["main"]
    assert v[0, 0] == v[0, 1] == v[0, 2]
    assert list(i[0, :3]) == sorted(i[0, :3])


def test_a_one_rank_mesh_step_is_the_unsharded_step(tmp_path):
    """On a (1, 1) mesh every spec is whole and no collective runs: the
    mesh step, serve and retrieval give the unsharded steps' bits."""
    cfg = recsys_mesh_cfg("wide_deep")
    case = _case("wide_deep")
    params = recsys_params_from_jax(case["params"], cfg, "cpu")
    state = {"params": params, "opt": adagrad(LR).init(params), "step": 0}
    batch = torch_batch(case["train"])
    want, wm = steps.build_recsys_train_step(cfg, lr=LR)(state, batch)
    with one_rank_mesh(tmp_path) as mesh:
        ps = S.recsys_param_specs(cfg, mesh)
        got, gm = steps.build_recsys_train_step(
            cfg, lr=LR, mesh=mesh, param_specs=ps)(state, batch)
        p = steps.build_recsys_serve_step(cfg, mesh, ps)(
            params, torch_batch(case["serve"]))
        ret = case["retrieval"]["main"]
        rb = torch_batch(ret["batch"])
        rb["candidates"] = S.candidate_block(
            mesh, torch.from_numpy(ret["candidates"]))
        r = steps.build_retrieval_step(cfg, mesh, k=ret["k"])(params, rb)
    assert float(gm["loss"]) == float(wm["loss"])
    for a, b in zip(tree_items(got).values(), tree_items(want).values()):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    torch.testing.assert_close(p, steps.build_recsys_serve_step(cfg)(
        params, torch_batch(case["serve"])), rtol=0, atol=0, equal_nan=True)
    rb["candidates"] = torch.from_numpy(ret["candidates"])
    r1 = steps.build_retrieval_step(cfg, k=ret["k"])(params, rb)
    assert all(torch.equal(a, b) for a, b in zip(r, r1))


def test_what_the_recsys_mesh_steps_cannot_run_raises(tmp_path):
    cfg = recsys_mesh_cfg("dlrm_mlperf")
    with pytest.raises(ValueError, match="give the mesh"):
        steps.build_recsys_train_step(cfg, param_specs={})
    with pytest.raises(ValueError, match="give the mesh"):
        steps.build_recsys_serve_step(cfg, param_specs={})
    with pytest.raises(ValueError, match="give the mesh"):
        steps.build_retrieval_step(cfg, param_specs={})
    state = steps.new_state(cfg, torch.Generator().manual_seed(0))
    batch = torch_batch(_batch(cfg, 4, 0))
    with one_rank_mesh(tmp_path) as mesh:
        ps = S.recsys_param_specs(cfg, mesh)
        ps["bot_mlp"][0]["w"] = (None, ("model",))
        with pytest.raises(ValueError, match="more than a table's rows"):
            steps.build_recsys_train_step(cfg, mesh=mesh, param_specs=ps)(
                state, batch)
        with pytest.raises(NotImplementedError, match="item 10g"):
            steps.build_decode_step(cfg, mesh)
