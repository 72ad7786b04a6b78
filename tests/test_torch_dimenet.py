"""DimeNet in the port against the JAX package, on the CPU, at f32: the
configs field for field, the bases, the reference's tie rule for
``clip``/``maximum`` against ``jax.grad``, ``forward`` (atom types and
``d_feat > 0``), ``forward_dense_triplets`` and ``forward_graph`` at
SMOKE and at CONFIG width on small molecules, the dense triplet layout
equal to the flat one, translation and rotation invariance, padded edges
as in the reference, and ``shard_axes`` refused without a mesh or on row
counts the shards do not divide (the sharded path itself:
``test_torch_dimenet_sharded.py``). The JAX params are
carried across with ``weights.dimenet_params_from_jax``.

Tolerances (f32; the two packages sum in other orders): outputs and
bases atol 1e-5 + rtol 1e-5 (measured at most ~2e-7 on outputs of
~0.1-1); gradients of the tie helpers exactly; invariance as the
reference's tests (1e-4 translation, 1e-3 rotation).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import synthetic as jax_data
from repro.models import dimenet as jax_dimenet
from repro.sparse import triplets as jax_triplets
from repro_torch import configs
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES_GNN
from repro_torch.models import dimenet
from repro_torch.weights import _dimenet_shapes, dimenet_params_from_jax
from repro_torch.tree import tree_items, tree_leaves

ATOL = RTOL = 1e-5


def _cfgs(width, d_feat=0):
    mine = getattr(get_config("dimenet"), width)
    ref = getattr(jax_config("dimenet"), width)
    if d_feat:
        mine = dataclasses.replace(mine, d_feat=d_feat)
        ref = dataclasses.replace(ref, d_feat=d_feat)
    return mine, ref


def _params(width, d_feat=0, seed=0):
    cfg, jcfg = _cfgs(width, d_feat)
    jp = jax_dimenet.init_params(jax.random.PRNGKey(seed), jcfg)
    return cfg, jcfg, jp, dimenet_params_from_jax(
        jax.tree.map(np.asarray, jp), cfg, "cpu")


def _molecules(n_graphs=4, nodes=8, edges=16, seed=0, cap=4, d_feat=0):
    """A molecule batch (padded edges included) with flat triplets over
    the padded arrays, as the reference's tests build them."""
    b = next(jax_data.molecule_batches(n_graphs=n_graphs,
                                       nodes_per_graph=nodes,
                                       edges_per_graph=edges, seed=seed))
    t_in, t_out = jax_triplets.build_triplets(
        b["edge_src"], b["edge_dst"], n_graphs * nodes, max_per_edge=cap)
    b.update(t_in=t_in, t_out=t_out, t_mask=np.ones(len(t_in), np.int32))
    if d_feat:
        b["node_feat"] = np.random.default_rng(seed).normal(
            size=(n_graphs * nodes, d_feat)).astype(np.float32)
    return b


def _dense(b, k):
    dense, mask = jax_triplets.densify_triplets(
        b["t_in"], b["t_out"], len(b["edge_src"]), k)
    out = {key: v for key, v in b.items() if not key.startswith("t_")}
    out.update(t_in_dense=dense, t_mask_dense=mask)
    return out


def _both(b):
    return ({k: torch.from_numpy(np.array(v)) for k, v in b.items()},
            {k: jnp.asarray(v) for k, v in b.items()})


def _close(got, want, atol=ATOL, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", ["CONFIG", "SMOKE"])
def test_configs_are_the_reference_s(width):
    cfg, jcfg = _cfgs(width)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


def test_shapes_and_registry_are_the_reference_s():
    ref = jax_config("dimenet").SHAPES
    assert get_config("dimenet").SHAPES is SHAPES_GNN
    assert list(SHAPES_GNN) == list(ref)
    for name, spec in ref.items():
        assert dataclasses.asdict(SHAPES_GNN[name]) == \
            dataclasses.asdict(spec)
    assert "dimenet" in configs.ARCHS
    assert configs.resolve_arch("dimenet") == "dimenet"
    assert configs.ALIASES["dimenet"] == \
        jax_config.__globals__["ALIASES"]["dimenet"]


@pytest.mark.parametrize("d_feat", [0, 12])
def test_init_params_tree_is_the_reference_s(d_feat):
    cfg, jcfg = _cfgs("SMOKE", d_feat)
    mine = dimenet.init_params(torch.Generator().manual_seed(0), cfg)
    ref = jax_dimenet.init_params(jax.random.PRNGKey(0), jcfg)
    flat = tree_items(mine)
    assert {k: tuple(v.shape) for k, v in flat.items()} == \
        _dimenet_shapes(cfg)
    assert [tuple(x.shape) for x in jax.tree.leaves(ref)] == \
        [tuple(x.shape) for x in tree_leaves(mine)]
    assert all(v.dtype == torch.float32 for v in flat.values())


def test_carrying_refuses_a_wrong_tree():
    cfg, jcfg, jp, _ = _params("SMOKE")
    host = jax.tree.map(np.asarray, jp)
    with pytest.raises(ValueError, match="do not match"):
        dimenet_params_from_jax(dict(host, blocks=host["blocks"][:1]), cfg,
                                "cpu")
    with pytest.raises(ValueError, match="embed_msg/w has shape"):
        dimenet_params_from_jax(dict(host, embed_msg={
            "w": host["embed_msg"]["w"][:-1], "b": host["embed_msg"]["b"]}),
            cfg, "cpu")
    with pytest.raises(ValueError, match="do not match"):   # d_feat 12
        dimenet_params_from_jax(host, dataclasses.replace(cfg, d_feat=12),
                                "cpu")


# ---------------------------------------------------------------------------
# bases and the tie rule
# ---------------------------------------------------------------------------

def test_bases_match_jax():
    cfg, jcfg = _cfgs("CONFIG")
    rng = np.random.default_rng(1)
    d = np.concatenate([[1e-6, cfg.cutoff, cfg.cutoff * 1.1],
                        rng.uniform(0.1, 6.0, size=40)]).astype(np.float32)
    ang = rng.uniform(0, np.pi, size=d.shape[0]).astype(np.float32)
    ds = d / cfg.cutoff
    _close(dimenet.envelope(torch.from_numpy(ds), 5),
           jax_dimenet.envelope(jnp.asarray(ds), 5), rtol=1e-6)
    _close(dimenet.radial_basis(torch.from_numpy(d), cfg),
           jax_dimenet.radial_basis(jnp.asarray(d), jcfg), rtol=1e-6)
    _close(dimenet.spherical_basis(torch.from_numpy(d), torch.from_numpy(ang),
                                   cfg),
           jax_dimenet.spherical_basis(jnp.asarray(d), jnp.asarray(ang),
                                       jcfg), rtol=1e-6)


@pytest.mark.parametrize("fn", ["maximum", "clip"])
def test_tie_helpers_pass_the_gradient_as_jax(fn):
    """At exact ties (x == 0 for ``maximum(x, 0)``, x == f32(+-(1 - 1e-7))
    for the cosine's clip) x gets half the gradient, as under
    ``jax.grad``; off the ties all or none."""
    b = float(np.float32(1 - 1e-7))
    xs = np.array([0.0, -0.5, 0.5, b, -b, 1.0, -1.0, 0.3],
                  np.float32)
    if fn == "maximum":
        mine = lambda x: dimenet.maximum(x, 0.0)          # noqa: E731
        ref = lambda x: jnp.maximum(x, 0.0)               # noqa: E731
    else:
        mine = lambda x: dimenet.clip(x, -1.0 + 1e-7, 1.0 - 1e-7)  # noqa
        ref = lambda x: jnp.clip(x, -1.0 + 1e-7, 1.0 - 1e-7)      # noqa
    x = torch.from_numpy(xs).requires_grad_(True)
    out = mine(x)
    out.sum().backward()
    want = np.asarray(jax.vmap(jax.grad(ref))(jnp.asarray(xs)))
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.asarray(ref(jnp.asarray(xs))))
    np.testing.assert_array_equal(x.grad.numpy(), want)
    assert 0.5 in want                   # a tie was hit
    if fn == "clip":                     # torch.clamp would pass 1
        xt = torch.tensor([b], requires_grad=True)
        torch.clamp(xt, -b, b).sum().backward()
        assert xt.grad.item() == 1.0 and x.grad[3].item() == 0.5


def test_envelope_gradient_at_a_padded_edge_is_finite_and_jax_s():
    """Padded edges sit at d ~ 1e-6: the derivative of 1/d is ~1e12 there,
    kept out of the result by the reference's ``where``; no NaN."""
    cfg, jcfg = _cfgs("SMOKE")
    d = np.array([1e-6, 0.0, 2.0, 4.99], np.float32)
    x = torch.from_numpy(d).requires_grad_(True)
    (dimenet.radial_basis(x, cfg) * torch.tensor([0.0, 0.0, 1.0, 1.0])[
        :, None]).sum().backward()
    want = jax.grad(lambda v: jnp.sum(jax_dimenet.radial_basis(v, jcfg)
                                      * jnp.array([0.0, 0, 1, 1])[:, None]))(
        jnp.asarray(d))
    assert np.isfinite(x.grad.numpy()).all()
    _close(x.grad, want, rtol=1e-5)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width,d_feat", [("SMOKE", 0), ("SMOKE", 12),
                                          ("CONFIG", 0), ("CONFIG", 20)])
def test_forward_flat_dense_and_graph_match_jax(width, d_feat):
    """``forward`` on flat triplets, ``forward_dense_triplets`` on the
    ``(E, K)`` layout (a cap that some edges fill) and ``forward_graph``,
    each against the reference on the same carried params."""
    cfg, jcfg, jp, p = _params(width, d_feat, seed=1)
    cap = cfg.max_triplets_per_edge
    b = _molecules(seed=2, cap=cap, d_feat=d_feat)
    tb, jb = _both(b)
    out = dimenet.forward(p, cfg, tb)
    assert out.shape == (32, cfg.n_targets)
    _close(out, jax_dimenet.forward(jp, jcfg, jb))
    _close(dimenet.forward_graph(p, cfg, tb, 4),
           jax_dimenet.forward_graph(jp, jcfg, jb, 4))
    tbd, jbd = _both(_dense(b, cap))
    dense = dimenet.forward(p, cfg, tbd)
    _close(dense, jax_dimenet.forward(jp, jcfg, jbd))
    _close(dimenet.forward_dense_triplets(p, cfg, tbd),
           jax_dimenet.forward_dense_triplets(jp, jcfg, jbd))
    _close(dense, out)                    # the layouts agree


def test_dense_layout_equals_flat_on_a_capped_graph():
    """``tests/test_models_gnn.py``'s check on a power-law graph: capped
    triplets (K 4), flat against dense."""
    cfg, jcfg, jp, p = _params("SMOKE", 6, seed=3)
    src, dst = jax_data.make_synthetic_graph(40, 300, seed=5)
    src, dst = src.astype(np.int32), dst.astype(np.int32)
    rng = np.random.default_rng(5)
    t_in, t_out = jax_triplets.build_triplets(src, dst, 40, max_per_edge=4)
    b = {"positions": rng.uniform(0, 6.0, size=(40, 3)).astype(np.float32),
         "node_feat": rng.normal(size=(40, 6)).astype(np.float32),
         "node_mask": np.ones(40, np.int32), "edge_src": src,
         "edge_dst": dst, "edge_mask": np.ones(len(src), np.int32),
         "t_in": t_in, "t_out": t_out,
         "t_mask": np.ones(len(t_in), np.int32)}
    tb, jb = _both(b)
    flat = dimenet.forward(p, cfg, tb)
    tbd, jbd = _both(_dense(b, 4))
    _close(dimenet.forward(p, cfg, tbd), flat)
    _close(flat, jax_dimenet.forward(jp, jcfg, jb))


def test_padded_edges_behave_as_in_the_reference():
    """Padded edges (0 -> 0, ``edge_mask`` 0) carry non-zero messages and
    are triplet sources and targets with ``t_mask`` 1; the port follows
    the reference, so changing what a padded edge's triplets see changes
    both outputs alike."""
    cfg, jcfg, jp, p = _params("SMOKE", seed=4)
    b = _molecules(n_graphs=3, nodes=6, edges=40, seed=7)   # 30 pairs
    pad = np.flatnonzero(b["edge_mask"] == 0)
    assert len(pad) and np.isin(pad, b["t_out"]).any() and \
        np.isin(pad, b["t_in"]).any()
    tb, jb = _both(b)
    out = dimenet.forward(p, cfg, tb)
    _close(out, jax_dimenet.forward(jp, jcfg, jb))
    b2 = dict(b, t_mask=np.where(np.isin(b["t_in"], pad), 0,
                                 b["t_mask"]).astype(np.int32))
    tb2, jb2 = _both(b2)
    out2 = dimenet.forward(p, cfg, tb2)
    _close(out2, jax_dimenet.forward(jp, jcfg, jb2))
    assert not np.allclose(out.numpy(), out2.numpy(), atol=1e-6)


def test_translation_and_rotation_invariance():
    cfg, _, _, p = _params("SMOKE", seed=0)
    b = _molecules(seed=3)
    tb, _ = _both(b)
    out = dimenet.forward(p, cfg, tb)
    moved = dict(tb, positions=tb["positions"]
                 + torch.tensor([5.0, -3.0, 2.0]))
    np.testing.assert_allclose(dimenet.forward(p, cfg, moved).numpy(),
                               out.numpy(), atol=1e-4, rtol=1e-4)
    th = 0.7
    R = torch.tensor([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th),
                                                    0], [0, 0, 1.0]],
                     dtype=torch.float32)
    turned = dict(tb, positions=tb["positions"] @ R.T)
    np.testing.assert_allclose(dimenet.forward(p, cfg, turned).numpy(),
                               out.numpy(), atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("fn", ["forward", "forward_dense_triplets",
                                "forward_graph", "gnn_loss",
                                "build_gnn_train_step"])
def test_shard_axes_without_a_mesh_raises(fn):
    from repro_torch.launch import steps

    cfg, _, _, p = _params("SMOKE")
    tb, _ = _both(_dense(_molecules(), 4))
    calls = {
        "forward": lambda: dimenet.forward(p, cfg, tb, ("data",)),
        "forward_dense_triplets": lambda: dimenet.forward_dense_triplets(
            p, cfg, tb, ("data",)),
        "forward_graph": lambda: dimenet.forward_graph(p, cfg, tb, 4,
                                                       ("data",)),
        "gnn_loss": lambda: steps.gnn_loss(cfg, shard_axes=("data",)),
        "build_gnn_train_step": lambda: steps.build_gnn_train_step(
            cfg, shard_axes=("data",))}
    with pytest.raises(ValueError, match="needs the mesh="):
        calls[fn]()


@pytest.mark.parametrize("shards", [3, 5, 7])
@pytest.mark.parametrize("layout", ["dense", "flat"])
def test_rows_the_shards_do_not_divide_raise(shards, layout):
    from types import SimpleNamespace

    from repro_torch.launch import steps

    b = _molecules()
    b["t_in"], b["t_out"], b["t_mask"] = (v[:64] for v in (
        b["t_in"], b["t_out"], b["t_mask"]))
    if layout == "dense":
        b = _dense(b, 4)
    mesh = SimpleNamespace(axis_names=("data",), shape={"data": shards},
                           coords={"data": 0})
    with pytest.raises(ValueError, match=f"{shards} shards over"):
        steps.gnn_batch_block(b, mesh, ("data",), n_graphs=4)
