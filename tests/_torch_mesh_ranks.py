"""What each rank runs in the port's multi-rank tests
(``tests/test_torch_mesh.py``, ``test_torch_sharded.py``,
``test_torch_sharded_train.py``, ``test_torch_compression.py``).

The ranks are spawned processes (``launch.mesh.spawn_world``, gloo on the
CPU), so this module imports neither JAX nor the JAX package: each
function takes numpy inputs and returns numpy results. ``start_jax`` and
``finish_jax`` run a JAX script in a subprocess with four forced host
devices (as ``tests/test_sharded.py`` does), beside the ranks.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np

SRC = str(Path(__file__).resolve().parents[1] / "src")
MESHES = [(1, 4), (4, 1), (2, 2)]
AXES = ("data", "model")


def mesh_id(shape) -> str:
    return "x".join(str(n) for n in shape)


def start_jax(script: str, out: Path) -> subprocess.Popen:
    """Start ``script`` in a subprocess with four forced CPU devices; it
    writes its arrays to ``out`` (the environment's ``OUT``)."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=SRC, OUT=str(out))
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(script)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_jax(proc: subprocess.Popen, out: Path, timeout: float = 400):
    """Wait for ``start_jax``'s subprocess; its arrays as a dict."""
    stdout, stderr = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, \
        f"JAX side failed:\n{stdout}\n{stderr[-4000:]}"
    with np.load(out, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def world(fn, *args, n=4, timeout=300):
    """``fn(rank, *args)`` on ``n`` gloo ranks on the CPU, one thread each."""
    from repro_torch.launch.mesh import spawn_world

    with tempfile.TemporaryDirectory(prefix="torch_world_") as root:
        return spawn_world(fn, n, backend="gloo", root=root, args=args,
                           timeout=timeout, threads=1)


@contextlib.contextmanager
def one_rank_mesh(root):
    """A (1, 1) (data, model) mesh on a gloo world of this process alone
    (its ``FileStore`` under ``root``), destroyed on exit."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import Mesh

    dist.init_process_group("gloo", init_method=f"file://{root}/store",
                            rank=0, world_size=1)
    try:
        yield Mesh((1, 1), AXES, device="cpu")
    finally:
        dist.destroy_process_group()


def to_numpy(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().numpy()
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_numpy(v) for v in x)
    return x


def digest(tree) -> str:
    """SHA-256 of every leaf's bytes, in ``tree_leaves`` order."""
    import torch

    from repro_torch.tree import tree_leaves

    h = hashlib.sha256()
    for leaf in tree_leaves(tree):
        h.update(leaf.detach().contiguous().view(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def assemble(blocks, shape, spec, mesh_shape):
    """The global array of ``shape`` from each rank's block under ``spec``
    (a tuple of axis tuples or None per dim), rank-ordered ``blocks``; a
    block whose place is shared by several ranks must be the same bits
    on each."""
    out = np.full(shape, np.nan, dtype=np.asarray(blocks[0]).dtype)
    coords = [dict(zip(AXES, np.unravel_index(r, mesh_shape)))
              for r in range(len(blocks))]
    seen = {}
    for r, block in enumerate(blocks):
        index = []
        for dim, axes in enumerate(spec):
            if not axes:
                index.append(slice(None))
                continue
            n, i = 1, 0
            for a in axes:
                n *= mesh_shape[AXES.index(a)]
                i = i * mesh_shape[AXES.index(a)] + coords[r][a]
            size = shape[dim] // n
            index.append(slice(i * size, (i + 1) * size))
        key = tuple((s.start, s.stop) for s in index)
        if key in seen:
            assert np.array_equal(seen[key], block, equal_nan=True), \
                f"ranks sharing block {key} differ"
        seen[key] = block
        out[tuple(index)] = block
    return out


# ---------------------------------------------------------------------------
# test_torch_sharded_train.py
# ---------------------------------------------------------------------------

def train_cfg(case):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(case["arch"]).SMOKE
    return dataclasses.replace(
        cfg, compute_dtype=case.get("dtype", "float32"),
        head_impl=case.get("impl", "kernel"),
        vocab_size=case["vocab"], l1_weight=case["l1"],
        distill_weight=case["distill"], **case.get("fields", {}))


def torch_batch(batch):
    import torch

    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def train_rank(rank, cases, prefills):
    """Each case's sharded train step (one step, lr 0.5, from the carried
    state) and each prefill's Y block: losses, rank 0's moments, digests
    of every rank's state, the warnings raised."""
    import warnings

    import torch

    from repro_torch.launch import steps
    from repro_torch.launch.mesh import Mesh
    from repro_torch.tree import tree_items
    from repro_torch.weights import state_from_jax

    out = {"cases": {}, "prefill": {}}
    for case in cases:
        cfg = train_cfg(case)
        mesh = Mesh(case["mesh"], AXES, device="cpu")
        state = state_from_jax(case["state"], cfg, "cpu")
        step = steps.build_lsr_train_step(cfg, mesh, n_micro=case["n_micro"],
                                          n_pairs=case["pairs"], lr=0.5)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            new, metrics = step(state, torch_batch(case["batch"]))
        out["cases"][case["name"]] = {
            "loss": float(metrics["loss"]),
            "mu": to_numpy(tree_items(new["opt"]["mu"])) if rank == 0
            else None,
            "digest": {part: digest(new[part]) for part in ("params", "opt")},
            "step": new["step"],
            "warnings": sorted({str(w.message) for w in caught}),
        }
    for p in prefills:
        cfg = train_cfg(p)
        mesh = Mesh(p["mesh"], AXES, device="cpu")
        state = state_from_jax(p["state"], cfg, "cpu")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            serve = steps.build_lsr_prefill_step(cfg, mesh, p["rows"])
            y = serve(state["params"], torch_batch(p["batch"]))
        out["prefill"][p["name"]] = {
            "y": to_numpy(y), "warnings": sorted({str(w.message)
                                                  for w in caught})}
    return out


def fallback_rank(rank, case):
    """A prefill and a train step at a vocabulary the model axis does not
    divide: the warnings, the shapes each call of the spec's impl saw,
    and the loss."""
    import warnings

    from repro_torch.core import head_api
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import Mesh
    from repro_torch.weights import state_from_jax

    cfg = train_cfg(case)
    kernel, calls = head_api.get_head_impl(cfg.head_impl), []

    def counted(H, E, b, mask, *, spec):
        calls.append((H.shape[0], E.shape[0]))
        return kernel(H, E, b, mask, spec=spec)

    head_api.register_head_impl(cfg.head_impl, counted)
    mesh = Mesh(case["mesh"], AXES, device="cpu")
    state = state_from_jax(case["state"], cfg, "cpu")
    batch = torch_batch(case["batch"])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        steps.build_lsr_prefill_step(cfg, mesh, case["pairs"])(
            state["params"], {"tokens": batch["q_tokens"],
                              "mask": batch["q_mask"]})
        prefill_calls = list(calls)
        _, m = steps.build_lsr_train_step(cfg, mesh, lr=0.5)(state, batch)
    return {"warnings": [str(x.message) for x in caught],
            "kernel_calls": prefill_calls, "loss": float(m["loss"])}


def wrong_batch_rank(rank, batch):
    """A step built for 4 pairs given a batch of another size (raises)."""
    import torch

    from repro_torch.launch import steps
    from repro_torch.launch.mesh import Mesh

    cfg = train_cfg({"arch": "splade_bert", "vocab": 512, "l1": 0.0,
                     "distill": 0.0})
    mesh = Mesh((1, 2), AXES, device="cpu")
    state = steps.new_state(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    steps.build_lsr_train_step(cfg, mesh, n_pairs=4)(state,
                                                     torch_batch(batch))


# ---------------------------------------------------------------------------
# test_torch_sharded.py
# ---------------------------------------------------------------------------

SHARDED_FNS = ("make_head_sparton", "make_head_kernel", "sparton_head",
               "similarity", "infonce", "flops", "l1", "row_dots",
               "gathered_data", "gathered_all")


def sharded_rank(rank, inputs):
    """Every ``SHARDED_FNS`` entry on every mesh of ``MESHES``: this rank's
    outputs and the gradients of its inputs (loss: the function's scalar,
    or ``sum(out * c)`` with ``c`` the matching block of the global
    cotangent)."""
    import warnings

    import torch

    from repro_torch.core import sharded as sh
    from repro_torch.core.head_api import HeadSpec, make_head
    from repro_torch.launch.mesh import Mesh
    from repro_torch.losses.contrastive import gathered_infonce

    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    out = {}
    for shape in MESHES:
        mesh = Mesh(shape, AXES, device="cpu")
        ba = ("data",)
        blk = lambda spec, x: sh.local_block(mesh, spec, x)  # noqa: E731
        specs = sh.head_shardings(mesh, batch_axes=ba)
        for name in SHARDED_FNS:
            if name.startswith("make_head") or name == "sparton_head":
                if name == "sparton_head":
                    fn = sh.sharded_sparton_head(mesh, batch_axes=ba,
                                                 vocab_tile=16)
                else:
                    impl = name.split("_")[-1]
                    fn = make_head(HeadSpec(impl=impl, vocab_tile=16), mesh,
                                   batch_axes=ba)
                args = [blk(specs["H"], t["H"]).clone(), t["E"].clone(),
                        t["b"].clone()]
                for a in args:
                    a.requires_grad_(True)
                y = fn(args[0], args[1], args[2], blk(specs["mask"],
                                                       t["mask"]))
                loss = (y * blk(specs["Y"], t["cy"])).sum()
            elif name.startswith("gathered"):
                axes = ("data",) if name == "gathered_data" else AXES
                spec = (axes, None)
                args = [blk(spec, t["q"]).clone().requires_grad_(True),
                        blk(spec, t["d"]).clone().requires_grad_(True)]
                y = loss = gathered_infonce(*args, axis_names=axes,
                                            temperature=0.5, mesh=mesh)
            else:
                rep = specs["Y"]
                if name in ("flops", "l1"):
                    args = [blk(rep, t["q"]).clone().requires_grad_(True)]
                else:
                    args = [blk(rep, t["q"]).clone().requires_grad_(True),
                            blk(rep, t["d"]).clone().requires_grad_(True)]
                if name == "similarity":
                    y = sh.sharded_similarity(mesh, batch_axes=ba)(*args)
                    loss = (y * blk((ba, None), t["cs"])).sum()
                elif name == "infonce":
                    y = loss = sh.sharded_infonce(
                        mesh, batch_axes=ba, temperature=0.5)(*args)
                elif name == "flops":
                    y = loss = sh.sharded_flops_reg(mesh, batch_axes=ba)(*args)
                elif name == "l1":
                    y = loss = sh.sharded_l1_reg(mesh, batch_axes=ba)(*args)
                else:
                    y = sh.sharded_row_dots(mesh, batch_axes=ba)(*args)
                    loss = (y * blk((ba,), t["cr"])).sum()
            with warnings.catch_warnings():
                warnings.simplefilter("error")
                loss.backward()
            out[(mesh_id(shape), name)] = {
                "y": to_numpy(y), "grads": [to_numpy(a.grad) for a in args]}
    return out


# ---------------------------------------------------------------------------
# test_torch_mesh.py
# ---------------------------------------------------------------------------

MESH_SHAPES = [((1, 4), AXES), ((4, 1), AXES), ((2, 2), AXES),
               ((1, 2, 2), ("pod", "data", "model")),
               ((2, 2, 1), ("pod", "data", "model"))]


def mesh_tuples(axes):
    """The axis tuples the mesh tests run each collective over."""
    return [(a,) for a in axes] + [axes[-2:], tuple(reversed(axes[-2:])),
                                   tuple(axes)]


def collective_inputs(r, n_t, other):
    """Rank ``r``'s inputs and cotangents for ``mesh_rank`` (the JAX side
    builds the same as global arrays): ``other`` is its index over the
    axes outside the tuple, ``n_t`` the tuple's size."""
    f = np.float32
    return {"x": np.arange(6, dtype=f) * (r + 1),
            "w": np.arange(6, dtype=f) + 10 * r,
            "w_inv": np.arange(6, dtype=f) + 10 * other,
            "w_ag": np.arange(6 * n_t, dtype=f).reshape(2 * n_t, 3) * (r + 1),
            "z": (np.arange(4 * n_t, dtype=f) + 100 * r).reshape(n_t, 4),
            "w_a2a": np.arange(4 * n_t, dtype=f).reshape(1, 4 * n_t) + r,
            "x_rep": np.arange(6, dtype=f) * (other + 1),
            "rows": np.arange(8 * n_t, dtype=f).reshape(4 * n_t, 2),
            "w_rows": np.full((4, 2), r + 1, dtype=f)}


def mesh_rank(rank):
    """Each mesh of ``MESH_SHAPES``: this rank's coordinates, indices and
    groups, and over each tuple of ``mesh_tuples`` each collective's
    output and its input's gradient (the loss ``sum(out * w)`` of a
    cotangent ``w`` that differs over the tuple, or for ``psum`` and
    ``pmean``, whose outputs are the same over it, one that does not)."""
    import torch

    from repro_torch import collectives as C
    from repro_torch.launch import mesh as M

    out = {}
    for shape, axes in MESH_SHAPES:
        mesh = M.Mesh(shape, axes, device="cpu")
        rec = {"coords": [mesh.coords[a] for a in axes],
               "device": str(mesh.device),
               "batch_axes": M.batch_axes(mesh),
               "n_batch_shards": M.n_batch_shards(mesh)}
        for t in mesh_tuples(axes):
            n_t = M.axis_size(mesh, t)
            others = tuple(a for a in axes if a not in t)
            other = M.axis_index(mesh, others) if others else 0
            x = {k: torch.from_numpy(v).requires_grad_(True)
                 for k, v in collective_inputs(rank, n_t, other).items()}
            rec[("index", t)] = M.axis_index(mesh, t)
            rec[("size", t)] = n_t
            rec[("ranks", t)] = mesh.ranks(t)
            runs = {
                "psum": (C.psum(x["x"], t, mesh), x["w_inv"], "x"),
                "pmean": (C.pmean(x["x"], t, mesh), x["w_inv"], "x"),
                "all_gather": (C.all_gather(x["x"].reshape(2, 3), t, mesh),
                               x["w_ag"], "x"),
                "all_to_all": (C.all_to_all(x["z"], t, mesh, split_dim=0,
                                            concat_dim=1), x["w_a2a"], "z"),
                "replicated_input": (C.replicated_input(x["x_rep"], t, mesh),
                                     x["w"], "x_rep"),
                "shard_rows": (C.shard_rows(x["rows"], t, mesh),
                               x["w_rows"], "rows"),
            }
            for name, (y, w, wrt) in runs.items():
                x[wrt].grad = None
                (y * w).sum().backward()
                rec[(name, t)] = (y.detach().numpy().copy(),
                                  x[wrt].grad.numpy().copy())
            rec[("broadcast", t)] = C.broadcast(x["w"], t, mesh).numpy()
        out[mesh_id(shape)] = rec
    return out


def refusals_rank(rank):
    """The mesh builders' refusals in a world of two ranks."""
    from repro_torch.launch import mesh

    out = {}
    for key, fn in (("production", lambda: mesh.make_production_mesh(
            device="cpu")), ("multi_pod", lambda: mesh.make_production_mesh(
                multi_pod=True, device="cpu")),
            ("wrong_size", lambda: mesh.Mesh((2, 2), ("data", "model"),
                                             device="cpu"))):
        try:
            fn()
        except ValueError as e:
            out[key] = str(e)
    out["default_axes"] = mesh.make_mesh_for((1, 2), device="cpu").axis_names
    return out


# ---------------------------------------------------------------------------
# test_torch_compression.py
# ---------------------------------------------------------------------------

def compression_rank(rank, grads_by_rank, shape, axis):
    """``compressed_allreduce`` twice over ``axis`` of a mesh of ``shape``
    (the residual carried): the means and residuals."""
    import torch

    from repro_torch.launch.mesh import Mesh
    from repro_torch.optim.compression import compressed_allreduce
    from repro_torch.tree import tree_map

    axes = ("data", "model")[:len(shape)]
    mesh = Mesh(shape, axes, device="cpu")
    out, residual = [], None
    for call in grads_by_rank:
        g = tree_map(torch.from_numpy, call[rank])
        mean, residual = compressed_allreduce(g, residual, axis, mesh)
        out.append((to_numpy(mean), residual.numpy().copy()))
    return out


# ---------------------------------------------------------------------------
# test_torch_sharded_index.py
# ---------------------------------------------------------------------------

# the meshes of the sharded engines' world, with their axis names
SHARD_MESHES = [((4,), ("x",)), ((2, 2), ("x", "y")), ((1, 4), ("x", "y"))]
PRUNE = {"prune_margin": 0.5, "candidates": 24}


def shard_cases(n_docs):
    """Each mesh path of the sharded engines: a dict a case (literals only,
    for the JAX script). ``same_bits``: the mesh result must be the port's
    one-process result bit for bit (no psum, or a psum of two partials);
    ``error``: a piece of the ``ValueError`` both sides raise."""
    cases = []

    def add(shape, axes, kind, name, **kw):
        cases.append({"name": f"{mesh_id(shape)}|{name}", "mesh": shape,
                      "axes": axes, "kind": kind, "kw": {}, "build": {},
                      "same_bits": True, **kw})

    def grid(shape, axes, d, t, order, *, pruned=False, tag="", **kw):
        psum_ranks = shape[list(order).index("term")]
        add(shape, axes, "grid", f"grid{d}x{t}|{'_'.join(order)}{tag}"
            + ("_pruned" if pruned else ""), grid=(d, t), order=order,
            kw=dict(PRUNE) if pruned else {}, same_bits=psum_ranks <= 2,
            **kw)

    # (4,): each index over the one axis; a shard count of 3 refused
    add((4,), ("x",), "sharded", "sharded4", shards=4)
    add((4,), ("x",), "term", "term4", shards=4, same_bits=False)
    add((4,), ("x",), "term", "term4_pruned", shards=4, kw=dict(PRUNE),
        same_bits=False)
    for kind in ("sharded", "term"):
        add((4,), ("x",), kind, f"{kind}3", shards=3,
            error="n_shards=3 must equal mesh axis 'x' size 4")
    # (2, 2): the 1D indexes on each axis, the grid in both orders
    for ax in ("x", "y"):
        add((2, 2), ("x", "y"), "sharded", f"sharded2_{ax}", shards=2,
            kw={"axis_name": ax})
        add((2, 2), ("x", "y"), "term", f"term2_{ax}", shards=2,
            kw={"axis_name": ax})
        add((2, 2), ("x", "y"), "term", f"term2_{ax}_pruned", shards=2,
            kw={"axis_name": ax, **PRUNE})
    for order in (("doc", "term"), ("term", "doc")):
        for pruned in (False, True):
            grid((2, 2), ("x", "y"), 2, 2, order, pruned=pruned)
    grid((2, 2), ("x", "y"), 2, 2, ("doc", "term"), tag="_uneven",
         build={"doc_boundaries": (0, 17, n_docs)})
    add((2, 2), ("x", "y"), "grid", "grid3x2", grid=(3, 2),
        order=("doc", "term"),
        error="shard2d_retrieve: n_shards=3 must equal mesh axis 'x' size 2")
    # (1, 4): the wide axis
    add((1, 4), ("x", "y"), "sharded", "sharded4_y", shards=4,
        kw={"axis_name": "y"})
    add((1, 4), ("x", "y"), "term", "term4_y", shards=4,
        kw={"axis_name": "y"}, same_bits=False)
    grid((1, 4), ("x", "y"), 1, 4, ("doc", "term"))
    grid((1, 4), ("x", "y"), 1, 4, ("doc", "term"), pruned=True)
    grid((1, 4), ("x", "y"), 4, 1, ("term", "doc"))
    return cases


def sharded_index_rank(rank, x, cases, vocab, k):
    """Each case of ``shard_cases`` on this rank: the index built from the
    numpy rows, searched under the case's mesh and in this one process
    (``one_v``, ``one_i``), or the ``ValueError`` raised."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.retrieval.engine import (shard2d, sharded_index,
                                              term_sharded)
    from repro_torch.retrieval.engine.shard2d import ShardPlan
    from repro_torch.retrieval.sparse_rep import SparseRep

    docs = SparseRep(x["dv"], x["di"], x["dn"])
    q = SparseRep(x["qv"], x["qi"], x["qn"])
    meshes, out = {}, {}
    for case in cases:
        shape = tuple(case["mesh"])
        if shape not in meshes:
            meshes[shape] = Mesh(shape, case["axes"], device="cpu")
        mesh, kw = meshes[shape], dict(case["kw"])
        if case["kind"] == "sharded":
            idx = sharded_index.shard_index(docs, vocab, case["shards"],
                                            device="cpu")
            fn = sharded_index.sharded_retrieve
        elif case["kind"] == "term":
            idx = term_sharded.term_shard_index(
                docs, vocab, case["shards"], keep_forward=True, device="cpu")
            fn = term_sharded.term_sharded_retrieve
        else:
            idx = shard2d.shard2d_index(docs, vocab, *case["grid"],
                                        keep_forward=True, device="cpu",
                                        **dict(case["build"]))
            kw["plan"] = ShardPlan(*case["grid"],
                                   axis_order=tuple(case["order"]))
            fn = shard2d.shard2d_retrieve
        try:
            v, i = fn(q, idx, k, mesh=mesh, **kw)
        except ValueError as e:
            out[case["name"]] = {"error": str(e)}
            continue
        kw.pop("axis_name", None)
        kw.pop("plan", None)
        one_v, one_i = fn(q, idx, k, **kw)
        out[case["name"]] = {"v": v.numpy(), "i": i.numpy(),
                             "one_v": one_v.numpy(), "one_i": one_i.numpy()}
    return out


# ---------------------------------------------------------------------------
# test_torch_distributed.py
# ---------------------------------------------------------------------------

# (mesh shape, mesh axes, the axes the rows are blocked over)
DIST_MESHES = [((4,), ("x",), ("x",)), ((2, 2), ("x", "y"), ("x", "y")),
               ((2, 2), ("x", "y"), ("y", "x")),
               ((1, 2), ("x", "y"), ("x", "y"))]
DIST_CASES = ("uniform", "graph_order", "out_of_range", "small_r")
DIST_ROWS, DIST_D = 16, 3       # table rows a shard, row width


def dist_id(mesh):
    shape, _, shard = mesh
    return f"{mesh_id(shape)}|{'.'.join(shard)}"


def dist_inputs(case, n):
    """The global arrays of a case over ``n`` shards (integers in f32, so
    every sum is exact): ``table`` (n * DIST_ROWS, d), ``idx`` (n * R,)
    and the take's cotangent ``w_take`` (n * R, d); ``vals`` (n * R, d)
    scattered by ``idx`` into n * DIST_ROWS rows, its cotangent
    ``w_sum``. ``uniform``: ids uniform (nothing drops); ``graph_order``:
    most of a shard's ids in its own block and a third 0 (padding), as a
    molecule batch in graph order asks (heavy drops); ``out_of_range``:
    ids from -2 blocks to 2 blocks past the end; ``small_r``: 3 ids a
    shard, fewer than 4 n."""
    rng = np.random.default_rng(DIST_CASES.index(case) * 10 + n)
    rows, R = n * DIST_ROWS, 3 if case == "small_r" else 64
    if case == "graph_order":
        idx = np.concatenate([
            np.where(rng.random(R) < 0.35, 0,
                     np.where(rng.random(R) < 0.8,
                              s * DIST_ROWS + rng.integers(0, DIST_ROWS, R),
                              rng.integers(0, rows, R)))
            for s in range(n)])
    elif case == "out_of_range":
        idx = rng.integers(-2 * DIST_ROWS, rows + 2 * DIST_ROWS, n * R)
    else:
        idx = rng.integers(0, rows, n * R)
    f = np.float32
    return {"table": rng.integers(-8, 8, (rows, DIST_D)).astype(f),
            "idx": idx.astype(np.int32),
            "w_take": rng.integers(-4, 5, (n * R, DIST_D)).astype(f),
            "vals": rng.integers(-8, 8, (n * R, DIST_D)).astype(f),
            "w_sum": rng.integers(-4, 5, (rows, DIST_D)).astype(f)}


def distributed_rank(rank, meshes):
    """Each case of ``DIST_CASES`` on each mesh of ``meshes`` (those of
    this world's size): this rank's blocks of the take's rows, the segment
    sum's output, the dropped counts and the gradients of ``sum(out *
    w)`` (``w`` this rank's block of the global cotangent)."""
    import torch

    from repro_torch.launch.mesh import Mesh, axis_index, axis_size
    from repro_torch.sparse import distributed as D

    out = {}
    for shape, axes, shard in meshes:
        mesh = Mesh(shape, axes, device="cpu")
        n, i = axis_size(mesh, shard), axis_index(mesh, shard)
        for case in DIST_CASES:
            x = dist_inputs(case, n)
            blk = {k: torch.from_numpy(
                v[i * (len(v) // n):(i + 1) * (len(v) // n)].copy())
                for k, v in x.items()}
            table = blk["table"].requires_grad_(True)
            rows, dropped = D.make_distributed_take(mesh, shard)(
                table, blk["idx"])
            (rows * blk["w_take"]).sum().backward()
            vals = blk["vals"].requires_grad_(True)
            summed, s_dropped = D.distributed_segment_sum_local(
                vals, blk["idx"], DIST_ROWS, axis_names=shard, mesh=mesh)
            (summed * blk["w_sum"]).sum().backward()
            out[(dist_id((shape, axes, shard)), case)] = {
                "take": rows.detach().numpy(), "take_dropped": int(dropped),
                "take_grad": table.grad.numpy(),
                "sum": summed.detach().numpy(), "sum_dropped": int(s_dropped),
                "sum_grad": vals.grad.numpy()}
    return out


# ---------------------------------------------------------------------------
# test_torch_dimenet_sharded.py
# ---------------------------------------------------------------------------

def _gnn(name, mesh, layout, order, loss, *, width="SMOKE", d_feat=0,
         step=False):
    axes = ("x", "y")[:len(mesh)]
    return {"name": name, "mesh": mesh, "axes": axes, "width": width,
            "layout": layout, "order": order, "loss": loss,
            "d_feat": d_feat, "step": step}


# order "graph": molecules in graph order, padded triplet slots on edge 0
# (the reference's layout: heavy drops in the dense layout); "uniform":
# node and edge ids shuffled, padded slots on random edges (no drops)
GNN_CASES = [
    _gnn("dense_graph_2x2", (2, 2), "dense", "graph", "graph", step=True),
    _gnn("dense_seed_1x2", (1, 2), "dense", "graph", "seed"),
    _gnn("dense_node_4", (4,), "dense", "uniform", "node", d_feat=6),
    _gnn("flat_graph_2x2", (2, 2), "flat", "graph", "graph"),
    _gnn("flat_node_4", (4,), "flat", "graph", "node", d_feat=6),
    _gnn("flat_seed_1x2", (1, 2), "flat", "graph", "seed"),
    _gnn("dense_config_4", (4,), "dense", "uniform", "graph",
         width="CONFIG"),
    _gnn("dense_config_2x2", (2, 2), "dense", "uniform", "node",
         width="CONFIG"),
    _gnn("flat_config_2x2", (2, 2), "flat", "graph", "graph",
         width="CONFIG"),
]
GNN_GRAPHS = 8          # molecules a batch (the graph loss's n_graphs)
GNN_LR = 1e-3


def gnn_cfg(case):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(getattr(get_config("dimenet"), case["width"]),
                               d_feat=case["d_feat"])


def gnn_rank(rank, cases, batches, params, states):
    """Each case of ``cases`` (those of this world's size) on this rank:
    its block of the node outputs, the graph outputs, the loss and the
    gradients (summed over the axes, as the step sums them) of the
    sharded path, the dropped counts of its takes and sums, and the same
    of the unsharded path on the whole batch; for a ``step`` case one
    sharded train step (lr ``GNN_LR``) from the carried state: its loss,
    the digest of the state and, on rank 0, the state."""
    import torch

    from repro_torch.collectives import psum
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import dimenet
    from repro_torch.sparse import distributed as D
    from repro_torch.tree import tree_items, tree_map
    from repro_torch.weights import dimenet_params_from_jax, state_from_jax

    meshes, out = {}, {}
    for case in cases:
        shape, axes = tuple(case["mesh"]), tuple(case["axes"])
        if shape not in meshes:
            meshes[shape] = Mesh(shape, axes, device="cpu")
        mesh, cfg = meshes[shape], gnn_cfg(case)
        n_graphs = GNN_GRAPHS if case["loss"] == "graph" else 0
        p = dimenet_params_from_jax(params[case["name"]], cfg, "cpu")
        whole = torch_batch(batches[case["name"]])
        blk = steps.gnn_batch_block(whole, mesh, axes, n_graphs=n_graphs)
        rec = {}
        for tag, b, kw in (("sharded", blk, {"shard_axes": axes,
                                              "mesh": mesh}),
                           ("one", whole, {})):
            D.DROPS.reset()
            with torch.no_grad():
                node = dimenet.forward(p, cfg, b, kw.get("shard_axes"),
                                       mesh=kw.get("mesh"))
                graph = dimenet.forward_graph(
                    p, cfg, b, GNN_GRAPHS, kw.get("shard_axes"),
                    mesh=kw.get("mesh"))
            drops = D.DROPS.summary()
            D.DROPS.reset(on=False)
            loss, grads = steps.value_and_grad(
                steps.gnn_loss(cfg, n_graphs, **kw))(p, b)
            if tag == "sharded":
                grads = tree_map(lambda g: psum(g, axes, mesh), grads)
            rec[tag] = {"node": node.numpy(), "graph": graph.numpy(),
                        "loss": float(loss), "drops": drops,
                        "grads": to_numpy(tree_items(grads))}
        if case["step"]:
            state = state_from_jax(states[case["name"]], cfg, "cpu")
            new, m = steps.build_gnn_train_step(
                cfg, n_graphs=n_graphs, lr=GNN_LR, shard_axes=axes,
                mesh=mesh)(state, blk)
            rec["step"] = {
                "loss": float(m["loss"]), "step_count": new["step"],
                "digest": digest({"params": new["params"], "opt": new["opt"]}),
                "state": to_numpy({"params": tree_items(new["params"]),
                                   "mu": tree_items(new["opt"]["mu"]),
                                   "nu": tree_items(new["opt"]["nu"])})
                if rank == 0 else None}
        out[case["name"]] = rec
    return out



# ---------------------------------------------------------------------------
# test_torch_zero_train.py
# ---------------------------------------------------------------------------

def zero_rank(rank, cases):
    """Each case of ``cases`` (those of this world's size) on this rank:
    ``build_lsr_train_step(param_specs=, zero_specs=)`` (its specs from
    ``state_shardings(transformer_param_specs(cfg, mesh), ...)``, either
    left out as the case says) for two steps (lr 0.5) from the carried
    state cut by ``shard_state``, then the replicated mesh step from
    the same state. Returns the losses, this rank's state bytes beside
    the specs' count, each leaf's block digest after each step (with the
    axes its spec names), the warnings raised and, on rank 0, the state
    after each step (``gather_state``); the replicated step's losses and
    (rank 0) states likewise."""
    import warnings

    import torch

    from repro_torch.launch import sharding as S
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import Mesh
    from repro_torch.tree import tree_items, tree_leaves, tree_map
    from repro_torch.weights import state_from_jax

    out = {}
    for case in cases:
        cfg = train_cfg(case)
        mesh = Mesh(case["mesh"], AXES, device="cpu")
        glob = state_from_jax(case["state"], cfg, "cpu")
        full = S.transformer_param_specs(cfg, mesh)
        sh = S.state_shardings(full, glob["params"], "adamw", mesh)
        pspecs = full if "params" in case["specs"] else None
        zspecs = sh["opt"]["mu"] if "zero" in case["specs"] else None
        held_p = pspecs or tree_map(lambda p: S.replicated(p.ndim),
                                    glob["params"])
        held_z = zspecs or held_p
        specs = {"params": held_p, "opt": {"mu": held_z, "nu": held_z},
                 "step": ()}
        state = S.shard_state(mesh, specs, glob)
        rec = {"nbytes": sum(t.nbytes for t in tree_leaves(state)
                             if isinstance(t, torch.Tensor)),
               "spec_nbytes": S.state_nbytes(mesh, specs, glob),
               "coords": dict(mesh.coords), "losses": [], "blocks": [],
               "states": [], "axes": {}}
        S.map_specs(lambda spec, name: rec["axes"].setdefault(
            name, S.spec_axes(spec)), specs, _names(specs))
        step = steps.build_lsr_train_step(
            cfg, mesh, n_micro=case["n_micro"], n_pairs=case["pairs"],
            lr=0.5, param_specs=pspecs, zero_specs=zspecs)
        batch = torch_batch(case["batch"])
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(2):
                state, metrics = step(state, batch)
                rec["losses"].append(float(metrics["loss"]))
                body = {"params": state["params"], "opt": state["opt"]}
                rec["blocks"].append({k: digest(v) for k, v in
                                      tree_items(body).items()})
                whole = S.gather_state(mesh, specs, state)
                if rank == 0:
                    rec["states"].append(to_numpy(tree_items(
                        {"params": whole["params"], "opt": whole["opt"]})))
            rec["step"] = state["step"]
            repl = steps.build_lsr_train_step(
                cfg, mesh, n_micro=case["n_micro"], n_pairs=case["pairs"],
                lr=0.5)
            r_state, rec["replicated"] = glob, ([], [])
            for _ in range(2):
                r_state, metrics = repl(r_state, batch)
                rec["replicated"][0].append(float(metrics["loss"]))
                if rank == 0:
                    rec["replicated"][1].append(to_numpy(tree_items(
                        {"params": r_state["params"],
                         "opt": r_state["opt"]})))
        rec["warnings"] = sorted({str(w.message) for w in caught})
        rec["new_state_is_shard_state"] = _built_state_is_cut(
            case, cfg, mesh, specs)
        out[case["name"]] = rec
    return out


def _built_state_is_cut(case, cfg, mesh, specs):
    """Whether ``new_state(cfg, ..., mesh=, specs=)`` and ``init_state(arch,
    ..., smoke=True, mesh=, specs=)`` give, leaf for leaf and bit for bit,
    ``shard_state`` of the global state drawn from the same seed."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as S
    from repro_torch.launch import steps
    from repro_torch.tree import tree_items

    def seed():
        return torch.Generator().manual_seed(7)

    def same(a, b):
        a, b = tree_items(a), tree_items(b)
        return a.keys() == b.keys() and all(
            torch.equal(v, b[k]) if isinstance(v, torch.Tensor)
            else v == b[k] for k, v in a.items())

    built = same(steps.new_state(cfg, seed(), mesh=mesh, specs=specs),
                 S.shard_state(mesh, specs, steps.new_state(cfg, seed())))
    smoke = steps.init_state(case["arch"], seed(), smoke=True)
    smoke_specs = S.state_shardings(
        S.transformer_param_specs(get_config(case["arch"]).SMOKE,
                                  mesh), smoke["params"], "adamw", mesh)
    return built and same(
        steps.init_state(case["arch"], seed(), smoke=True, mesh=mesh,
                         specs=smoke_specs),
        S.shard_state(mesh, smoke_specs, smoke))


def _names(tree, prefix=""):
    """A tree like ``tree`` (nested dicts and lists; a spec tuple is a
    leaf) of each leaf's ``tree_items`` name."""
    if isinstance(tree, dict):
        return {k: _names(v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_names(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return prefix[:-1]


def zero_refusals_rank(rank, state):
    """The spec'd step's refusals in a (2, 2) world: a param spec over a
    batch axis, a ZeRO spec that does not refine the param spec, a
    dimension split over batch and model axes at once, no mesh, a spec
    that splits a dimension unevenly, and ``new_state`` given a mesh
    without specs or specs without a mesh."""
    import torch

    from repro_torch.launch import sharding as S
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import Mesh
    from repro_torch.weights import state_from_jax

    cfg = train_cfg({"arch": "splade_xlmr", "vocab": 1024, "l1": 0.0,
                     "distill": 0.0})
    mesh = Mesh((2, 2), AXES, device="cpu")
    glob = state_from_jax(state, cfg, "cpu")
    full = S.transformer_param_specs(cfg, mesh)
    batch = {"q_tokens": torch.zeros((4, 8), dtype=torch.int32),
             "q_mask": torch.ones((4, 8), dtype=torch.int32),
             "d_tokens": torch.zeros((4, 8), dtype=torch.int32),
             "d_mask": torch.ones((4, 8), dtype=torch.int32)}

    def with_leaf(tree, leaf_spec):
        return {**tree, "final_norm": leaf_spec}

    cases = {
        "batch_axis_param": dict(param_specs=with_leaf(full, (("data",),))),
        "not_refining": dict(param_specs=full, zero_specs={
            **full, "embed": (None, ("data",))}),
        "mixed_axes": dict(param_specs=S.map_specs(
            lambda s: S.replicated(len(s)), full),
            zero_specs=with_leaf(S.map_specs(
                lambda s: S.replicated(len(s)), full),
                (("model", "data"),))),
    }
    out = {}
    for name, kw in cases.items():
        state = S.shard_state(mesh, {"params": kw["param_specs"],
                                     "opt": {"mu": kw["param_specs"],
                                             "nu": kw["param_specs"]},
                                     "step": ()}, glob)
        try:
            steps.build_lsr_train_step(cfg, mesh, lr=0.5, **kw)(state, batch)
        except ValueError as e:
            out[name] = str(e)
    try:
        S.shard_state(mesh, {"x": (("model",),)}, {"x": torch.zeros(3)})
    except ValueError as e:
        out["uneven"] = str(e)
    try:
        steps.build_lsr_train_step(cfg, None, param_specs=full)
    except ValueError as e:
        out["no_mesh"] = str(e)
    specs = S.state_shardings(full, glob["params"], "adamw", mesh)
    for name, kw in {"state_mesh_alone": dict(mesh=mesh),
                     "state_specs_alone": dict(specs=specs)}.items():
        try:
            steps.new_state(cfg, torch.Generator().manual_seed(0), **kw)
        except ValueError as e:
            out[name] = str(e)
    return out


# ---------------------------------------------------------------------------
# test_torch_sharded_embedding.py
# ---------------------------------------------------------------------------

EMB_AXES = {"model": "model", "model_data": ("model", "data")}


def embedding_rank(rank, table, cases, planted):
    """``make_sharded_lookup`` on this rank's block of ``table`` for each
    case ``(mesh, axis key, ids, cotangent)``: the output and the
    gradient of ``sum(out * cotangent)`` gathered over the axes; then, on
    the (2, 2) mesh, ``row_sharded_take`` on the ``planted`` ids (whole
    on every rank, and this rank's rows of them split over ``data``):
    the output (the batch's rows gathered back) and the table's gradient
    of ``sum(out * 1)`` over the rows that are not NaN (a block split over
    ``model`` alone holds this rank's share of it: summed over ``data``,
    as the train step's ``zero_reducer`` sums it)."""
    import torch

    from repro_torch.collectives import all_gather, all_gather_invariant, psum
    from repro_torch.core.sharded import local_block
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sparse import sharded_embedding as se

    full = torch.from_numpy(table)

    def run(fn, block, axes, shares=()):
        block = block.clone().requires_grad_(True)
        out, weight = fn(block)
        (torch.nan_to_num(out) * weight).sum().backward()
        with torch.no_grad():
            grad = psum(block.grad, shares, mesh) if shares else block.grad
            grad = all_gather(grad, axes, mesh)
        return out.detach().numpy(), grad.numpy()

    out = {}
    meshes = {}
    for name, (shape, key, ids, cot) in cases.items():
        if shape not in meshes:
            meshes[shape] = Mesh(shape, AXES, device="cpu")
        mesh = meshes[shape]
        axes = EMB_AXES[key]
        spec = se.table_sharding(mesh, axes)
        lookup = se.make_sharded_lookup(mesh, axes)
        out[name] = run(lambda b: (lookup(b, torch.from_numpy(ids)),
                                   torch.from_numpy(cot)),
                        local_block(mesh, spec, full), spec[0])
    mesh = meshes[(2, 2)]
    ids = torch.from_numpy(planted)
    for key, axes in EMB_AXES.items():
        block = local_block(mesh, se.table_sharding(mesh, axes), full)
        axes = se.table_sharding(mesh, axes)[0]
        out[f"take_whole_{key}"] = run(
            lambda b: (se.row_sharded_take(b, ids, axes=axes, mesh=mesh),
                       torch.ones(())), block, axes)
        rows = local_block(mesh, (("data",), None), ids)

        def split(b):
            got = se.row_sharded_take(b, rows, axes=axes, mesh=mesh,
                                      batch_axes=("data",))
            return all_gather_invariant(got, "data", mesh), torch.ones(())
        out[f"take_split_{key}"] = run(
            split, block, axes, () if "data" in axes else ("data",))
    return out


# ---------------------------------------------------------------------------
# test_torch_recsys_mesh.py
# ---------------------------------------------------------------------------

# each family's SMOKE widths with one table padded to at least 1M rows that
# the four ranks divide (its rows over ``("model", "data")``), one between
# 131072 and 1M rows (over ``model``) and the rest whole; DIEN's one table
# is the large one
RECSYS_MESH_SIZES = {"dlrm_mlperf": (100, 140000, 1000001, 30),
                     "xdeepfm": (50, 140000, 1000001, 80, 40),
                     "dien": (1000001,),
                     "wide_deep": (200, 140000, 1000001, 30)}


def recsys_mesh_cfg(arch):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch).SMOKE,
                               table_sizes=RECSYS_MESH_SIZES[arch])


def recsys_probe(leaf, probes):
    """A leaf as the recsys mesh tests compare it: whole, or at the rows
    ``probes`` lists for it (a large table)."""
    return leaf[probes] if probes is not None else leaf


def recsys_mesh_rank(rank, path):
    """Each family of the pickled cases at ``path`` on each mesh of
    MESHES: its JAX init carried by ``weights.recsys_params_from_jax``
    and cut by ``shard_state`` under ``state_shardings(recsys_param_
    specs(...))``, one ``build_recsys_train_step(mesh=, param_specs=,
    zero_specs=)`` step on the train batch (and, at (2, 2), on the
    planted batch): the losses, this rank's state bytes beside the specs'
    count, each leaf's block digest with the axes its spec names, whether
    ``new_state(mesh=, specs=)`` is ``shard_state`` of the global state,
    and on rank 0 the gathered state (large tables at their probe rows;
    whether every other row kept its bits). Then the serve step on the
    served batch and the retrieval step on each candidate case."""
    import pickle

    import torch

    from repro_torch.launch import sharding as S
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import Mesh
    from repro_torch.optim.optimizers import adagrad
    from repro_torch.tree import tree_items
    from repro_torch.weights import recsys_params_from_jax

    with open(path, "rb") as f:
        cases = pickle.load(f)
    out = {}
    for arch, case in cases.items():
        cfg = recsys_mesh_cfg(arch)
        params = recsys_params_from_jax(case["params"], cfg, "cpu")
        glob = {"params": params, "opt": adagrad(case["lr"]).init(params),
                "step": 0}
        init = {k: v.numpy() for k, v in tree_items(
            {"params": glob["params"], "opt": glob["opt"]}).items()}
        for shape in MESHES:
            mesh = Mesh(shape, AXES, device="cpu")
            ps = S.recsys_param_specs(cfg, mesh)
            specs = S.state_shardings(ps, params, "adagrad", mesh)
            step = steps.build_recsys_train_step(
                cfg, lr=case["lr"], mesh=mesh, param_specs=ps,
                zero_specs=specs["opt"]["acc"])
            rec = {"coords": dict(mesh.coords),
                   "spec_nbytes": S.state_nbytes(mesh, specs, glob),
                   "axes": {k: S.spec_axes(v) for k, v in
                            S.spec_items({"params": specs["params"],
                                          "opt": specs["opt"]}).items()}}
            built = steps.new_state(cfg, torch.Generator().manual_seed(3),
                                    mesh=mesh, specs=specs)
            drawn = S.shard_state(mesh, specs, steps.new_state(
                cfg, torch.Generator().manual_seed(3)))
            rec["new_state_is_shard_state"] = all(
                torch.equal(a, drawn_leaf) for a, drawn_leaf in zip(
                    tree_items(built).values(), tree_items(drawn).values())
                if isinstance(a, torch.Tensor))
            del built, drawn
            for kind in ("train", "planted"):
                if kind == "planted" and shape != (2, 2):
                    continue
                state = S.shard_state(mesh, specs, glob)
                if kind == "train":
                    rec["nbytes"] = sum(
                        t.nbytes for t in tree_items(state).values()
                        if isinstance(t, torch.Tensor))
                new, m = step(state, torch_batch(case[kind]))
                body = {"params": new["params"], "opt": new["opt"]}
                res = {"loss": float(m["loss"]), "step": new["step"],
                       "blocks": {k: digest(v) for k, v in
                                  tree_items(body).items()}}
                whole = S.gather_state(mesh, specs, new)
                if rank == 0:
                    got = {k: v.numpy() for k, v in tree_items(
                        {"params": whole["params"],
                         "opt": whole["opt"]}).items()}
                    res["state"] = {k: recsys_probe(v, case["probes"][k])
                                    for k, v in got.items()}
                    res["rest_kept"] = all(
                        np.array_equal(np.delete(v, case["probes"][k], 0),
                                       np.delete(init[k],
                                                 case["probes"][k], 0))
                        for k, v in got.items()
                        if case["probes"][k] is not None)
                rec[kind] = res
                del state, new, whole
            state = S.shard_state(mesh, specs, glob)
            serve = steps.build_recsys_serve_step(cfg, mesh, ps)
            rec["serve"] = serve(state["params"],
                                 torch_batch(case["serve"])).numpy()
            rec["retrieval"] = {}
            for name, ret in case["retrieval"].items():
                batch = torch_batch(ret["batch"])
                batch["candidates"] = S.candidate_block(
                    mesh, torch.from_numpy(ret["candidates"]))
                v, i = steps.build_retrieval_step(
                    cfg, mesh, k=ret["k"], param_specs=ps)(
                        state["params"], batch)
                rec["retrieval"][name] = (v.numpy(), i.numpy())
            out[(arch, shape)] = rec
    return out
