"""DimeNet training in the port against the JAX package, on the CPU:
``build_gnn_train_step`` against the jitted JAX step from the carried
SMOKE state in each of the loss's three branches (the graph MSE, the
seed MSE, the ``node_mask``-weighted node MSE), two steps each (loss,
params, AdamW's ``mu`` and ``nu``); the step leaves its input intact; 12
steps learn (``tests/test_models_gnn.py``'s check); AdamW checkpoints of
a DimeNet state equal to the JAX ``save_checkpoint``'s (keys, arrays,
treedef) and a resumed run equal to an uninterrupted one; both CLIs
refuse ``--arch dimenet``.

Tolerances (f32; each package sums in its own order): the loss rtol
1e-5; ``mu`` and ``nu`` atol 1e-7 plus rtol 1e-4 (their elements are
gradients and squared gradients of ~1e-6-1); params atol 1e-6, except
where Adam's step ran in its eps regime (JAX's ``0 < sqrt(nu / (1 -
b2^t)) < 1e-6`` at some step, within 100x of eps = 1e-8: a gradient
element near zero, whose f32 rounding moves ``m / (sqrt(v) + eps)`` by
O(1)), held there to 2.1 x the summed lr (a step's largest move either
way), as ``test_torch_decoder_train.py`` holds the decoders.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jax_store
from repro.configs import get_config as jax_config
from repro.configs.specs import CellSpec
from repro.data import synthetic as jax_data
from repro.launch import steps as jax_steps
from repro.launch import train as jax_train
from repro.sparse import sampler as jax_sampler
from repro.sparse import triplets as jax_triplets
from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.launch import serve, steps, train
from repro_torch.tree import tree_leaves
from repro_torch.weights import state_from_jax

CPU = torch.device("cpu")
LR = 1e-3
LOSS_RTOL = 1e-5
MOMENT_ATOL, MOMENT_RTOL = 1e-7, 1e-4
PARAM_ATOL = 1e-6
ADAM_EPS_REGIME = 1e-6


def _molecules(seed=0, n_graphs=4):
    b = next(jax_data.molecule_batches(n_graphs=n_graphs, nodes_per_graph=8,
                                       edges_per_graph=16, seed=seed))
    t_in, t_out = jax_triplets.build_triplets(
        b["edge_src"], b["edge_dst"], n_graphs * 8, max_per_edge=0)
    b.update(t_in=t_in, t_out=t_out, t_mask=np.ones(len(t_in), np.int32))
    return b


def _densified(b, src, dst, n_nodes, k=4):
    t_in, t_out = jax_triplets.build_triplets(src, dst, n_nodes,
                                              max_per_edge=k)
    b["t_in_dense"], b["t_mask_dense"] = jax_triplets.densify_triplets(
        t_in, t_out, len(src), k)
    return b


def _full_graph(d_feat, seed=1, n=40, pad=8):
    """A power-law graph of n nodes padded by ``pad`` masked nodes and 16
    masked edges (0 -> 0), capped triplets densified: the node branch."""
    rng = np.random.default_rng(seed)
    src, dst = jax_data.make_synthetic_graph(n, 250, seed=seed)
    E = len(src) + 16
    b = {key: np.zeros(E, np.int32)
         for key in ("edge_src", "edge_dst", "edge_mask")}
    b["edge_src"][:len(src)], b["edge_dst"][:len(src)] = src, dst
    b["edge_mask"][:len(src)] = 1
    N = n + pad
    b.update(positions=rng.uniform(0, 6.0, size=(N, 3)).astype(np.float32),
             node_feat=rng.normal(size=(N, d_feat)).astype(np.float32),
             node_mask=(np.arange(N) < n).astype(np.int32),
             target=rng.normal(size=(N, 1)).astype(np.float32))
    return _densified(b, b["edge_src"], b["edge_dst"], N)


def _sampled(d_feat, seed=2):
    """A fanout-sampled subgraph (6 seeds, fanout (3, 2)) padded to its
    budget, its two hops' blocks concatenated: the seed branch."""
    rng = np.random.default_rng(seed)
    src, dst = jax_data.make_synthetic_graph(120, 1500, seed=seed)
    g = jax_sampler.CSRGraph.from_edges(src, dst, 120)
    total, per_hop = jax_sampler.fanout_budget(6, (3, 2))
    sub = jax_sampler.sample_subgraph(
        g, rng.choice(120, 6, replace=False), (3, 2), rng=rng,
        pad_nodes=total, pad_edges_per_hop=per_hop)
    b = {"edge_src": np.concatenate([x.src for x in sub.blocks]),
         "edge_dst": np.concatenate([x.dst for x in sub.blocks]),
         "edge_mask": np.concatenate([x.mask for x in sub.blocks]),
         "positions": rng.uniform(0, 6.0, size=(total, 3)).astype(
             np.float32),
         "node_feat": rng.normal(size=(total, d_feat)).astype(np.float32),
         "node_mask": sub.node_mask, "seed_ids": sub.seeds,
         "target": rng.normal(size=(6, 1)).astype(np.float32)}
    return _densified(b, b["edge_src"], b["edge_dst"], total)


BRANCHES = {  # name: (d_feat, n_graphs, batch maker)
    "graph": (0, 4, lambda s: _molecules(seed=s)),
    "node": (6, 0, lambda s: _full_graph(6, seed=s)),
    "seed": (5, 0, lambda s: _sampled(5, seed=s)),
}


def _cfgs(d_feat):
    return (dataclasses.replace(get_config("dimenet").SMOKE, d_feat=d_feat),
            dataclasses.replace(jax_config("dimenet").SMOKE, d_feat=d_feat))


def _jax_state(jcfg, seed=0):
    from repro.models import dimenet as jax_dimenet
    from repro.optim.optimizers import adamw

    params = jax_dimenet.init_params(jax.random.PRNGKey(seed), jcfg)
    return {"params": params, "opt": adamw(1e-4).init(params),
            "step": jnp.zeros((), jnp.int32)}


def _carry(state, cfg):
    return state_from_jax(jax.tree.map(np.asarray, state), cfg, CPU)


def _torch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


@pytest.fixture(scope="module", params=list(BRANCHES))
def two_steps(request):
    d_feat, n_graphs, make = BRANCHES[request.param]
    cfg, jcfg = _cfgs(d_feat)
    jstate = _jax_state(jcfg, 1)
    state = _carry(jstate, cfg)
    cell = CellSpec("dimenet", request.param, "gnn_train", {},
                    n_graphs=n_graphs)
    jstep = jax.jit(jax_steps.build_gnn_train_step(jcfg, cell, lr=LR))
    step = steps.build_gnn_train_step(cfg, n_graphs=n_graphs, lr=LR)
    mine, ref, regimes = [], [], []
    regime = [np.zeros(p.shape, bool)
              for p in jax.tree.leaves(jstate["params"])]
    for t, seed in enumerate((3, 4), start=1):
        b = make(seed)
        state, m = step(state, _torch(b))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        vhat = [np.asarray(nu) / (1 - 0.999 ** t)
                for nu in jax.tree.leaves(jstate["opt"]["nu"])]
        regime = [r | ((v > 0) & (np.sqrt(v) < ADAM_EPS_REGIME))
                  for r, v in zip(regime, vhat)]
        mine.append((state, float(m["loss"])))
        ref.append((jstate, float(jm["loss"])))
        regimes.append(regime)
    return request.param, mine, ref, regimes


@pytest.mark.parametrize("n", [1, 2])
def test_train_step_matches_the_jitted_jax_step(two_steps, n):
    _, mine, ref, regimes = two_steps
    (state, loss), (jstate, jloss) = mine[n - 1], ref[n - 1]
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    assert state["step"] == int(jstate["step"]) == n
    for a, b, eps_regime in zip(tree_leaves(state["params"]),
                                jax.tree.leaves(jstate["params"]),
                                regimes[n - 1]):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        diff = np.abs(_np(a) - np.asarray(b))
        assert diff.max(initial=0, where=~eps_regime) <= PARAM_ATOL
        assert diff.max(initial=0, where=eps_regime) <= 2.1 * LR * n
    for slot in ("mu", "nu"):
        for a, b in zip(tree_leaves(state["opt"][slot]),
                        jax.tree.leaves(jstate["opt"][slot])):
            np.testing.assert_allclose(_np(a), np.asarray(b),
                                       atol=MOMENT_ATOL, rtol=MOMENT_RTOL)


def test_train_step_leaves_its_input_intact():
    cfg, _ = _cfgs(0)
    state = steps.new_state(cfg, torch.Generator().manual_seed(0))
    copy = [x.clone() for x in tree_leaves(state)
            if isinstance(x, torch.Tensor)]
    out, _ = steps.build_gnn_train_step(cfg, n_graphs=4)(
        state, _torch(_molecules()))
    live = [x for x in tree_leaves(state) if isinstance(x, torch.Tensor)]
    assert all(torch.equal(a, b) for a, b in zip(copy, live))
    assert state["step"] == 0 and out["step"] == 1


def test_init_state_is_adamw_at_zero():
    state = steps.init_state("dimenet", torch.Generator().manual_seed(0),
                             smoke=True)
    assert state["step"] == 0 and set(state["opt"]) == {"mu", "nu"}
    assert all((x == 0).all() for x in tree_leaves(state["opt"]))
    assert len(state["params"]["blocks"]) == get_config("dimenet").SMOKE \
        .n_blocks


def test_twelve_steps_learn():
    """``tests/test_models_gnn.py``'s check on the port's own init: 12
    steps at lr 3e-3 on one molecule batch cut the loss by 10 %."""
    state = steps.init_state("dimenet", torch.Generator().manual_seed(0),
                             smoke=True)
    batch = _torch(_molecules())
    step = steps.build_gnn_train_step(get_config("dimenet").SMOKE,
                                      n_graphs=4, lr=3e-3)
    losses = []
    for _ in range(12):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9, losses


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d_feat", [0, 6])
def test_adamw_checkpoint_equals_jax_s(d_feat, tmp_path):
    """One JAX step from the SMOKE init (moments no longer 0), saved by
    both stores: the same npz keys, arrays and treedef; the port loads
    the JAX one onto its own template, bit for bit."""
    cfg, jcfg = _cfgs(d_feat)
    jstate = _jax_state(jcfg)
    n_graphs, make = (4, _molecules) if d_feat == 0 else \
        (0, lambda s: _full_graph(d_feat, seed=s))
    cell = CellSpec("dimenet", "x", "gnn_train", {}, n_graphs=n_graphs)
    jstate, _ = jax.jit(jax_steps.build_gnn_train_step(jcfg, cell))(
        jstate, {k: jnp.asarray(v) for k, v in make(0).items()})
    jax_store.save_checkpoint(str(tmp_path / "jax"), 1, jstate)
    store.save_checkpoint(str(tmp_path / "port"), 1, _carry(jstate, cfg))
    manifests = [json.loads((tmp_path / side / "step_000000001" /
                             "manifest.json").read_text())
                 for side in ("jax", "port")]
    assert manifests[0] == manifests[1]
    assert "'blocks'" in manifests[0]["treedef"] and "'nu'" in manifests[0][
        "treedef"]
    with np.load(tmp_path / "jax" / "step_000000001" / "arrays.npz") as a, \
            np.load(tmp_path / "port" / "step_000000001" / "arrays.npz") as p:
        assert sorted(a.files) == sorted(p.files)
        for key in a.files:
            assert a[key].dtype == p[key].dtype
            np.testing.assert_array_equal(a[key], p[key])
    template = steps.new_state(cfg, torch.Generator().manual_seed(5))
    loaded, step = store.load_checkpoint(str(tmp_path / "jax"), template)
    assert step == 1 and loaded["step"] == 1
    for x, y in zip(tree_leaves(loaded), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(_np(x), np.asarray(y))


def test_resumed_run_equals_an_uninterrupted_one(tmp_path):
    """4 steps in one run against 2 steps, a checkpoint, a load onto
    another init's template and 2 more: the same bits."""
    cfg = get_config("dimenet").SMOKE
    step = steps.build_gnn_train_step(cfg, n_graphs=4, lr=LR)
    batches = [_torch(_molecules(seed=s)) for s in range(4)]

    def run(state, bs):
        for b in bs:
            state, _ = step(state, b)
        return state

    start = steps.new_state(cfg, torch.Generator().manual_seed(2))
    whole = run(start, batches)
    store.save_checkpoint(str(tmp_path), 2, run(start, batches[:2]))
    template = steps.new_state(cfg, torch.Generator().manual_seed(9))
    loaded, at = store.load_checkpoint(str(tmp_path), template)
    assert at == 2
    resumed = run(loaded, batches[2:])
    assert resumed["step"] == whole["step"] == 4
    for a, b in zip(tree_leaves(resumed), tree_leaves(whole)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def test_train_cli_refuses_dimenet_as_the_jax_cli(tmp_path):
    with pytest.raises(SystemExit) as ref:
        jax_train.main(["--arch", "dimenet", "--steps", "1",
                        "--ckpt-dir", str(tmp_path / "jax")])
    with pytest.raises(SystemExit) as mine:
        train.main(["--arch", "dimenet", "--steps", "1", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path / "port")])
    assert mine.value.code == ref.value.code == \
        "use examples/train_dimenet.py for the GNN family"
    assert not (tmp_path / "port").exists()


def test_serve_cli_refuses_dimenet(capsys):
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", "dimenet", "--device", "cpu"])
    assert exc.value.code == 2
    assert "DimeNet" in capsys.readouterr().err
