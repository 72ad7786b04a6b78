"""The recsys family in the port against the JAX package, on the CPU:
the configs, ``recsys_batches``, ``tree.py`` on lists, Adagrad, the gather
rule, ``models.recsys`` (each family's ``forward`` and ``user_embedding``
at SMOKE, the JAX init carried across by ``weights.state_from_jax``),
the serve step and the retrieval step.

Tolerances (f32 throughout, both packages summing in their own order):

* ``forward`` and ``user_embedding``: atol 1e-5 plus rtol 1e-5 for every
  family (measured at most 1.8e-7 apart on logits up to 3.5, 2.4e-7 on
  the query vectors); DIEN's two recurrences over 12 steps need no looser
  one (measured 7.5e-8 on its logits);
* Adagrad and SGD with momentum on a carried tree: rtol 1e-6 (one
  division and square root an element; measured equal bit for bit);
* the gather rule: exact (a gather and a scatter-add of ones);
* the retrieval step's ids: identical (ties to the lowest id), its values
  within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data import synthetic as jax_data
from repro.launch import steps as jax_steps
from repro.models import recsys as jax_recsys
from repro.optim import optimizers as jax_opt
from repro.optim import schedules as jax_sched
from repro_torch import configs
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES_RECSYS
from repro_torch.data import synthetic
from repro_torch.launch import steps
from repro_torch.models import recsys
from repro_torch.optim import optimizers as opt
from repro_torch.optim import schedules
from repro_torch.tree import tree_items, tree_leaves, tree_map
from repro_torch.weights import recsys_params_from_jax, state_from_jax

ARCHS = ("dlrm_mlperf", "xdeepfm", "dien", "wide_deep")
ALIASES = {"dlrm-mlperf": "dlrm_mlperf", "xdeepfm": "xdeepfm",
           "dien": "dien", "wide-deep": "wide_deep"}
FWD_TOL = 1e-5
CPU = torch.device("cpu")


def _jax_state(arch, seed=0):
    state, layout = jax_steps.init_state(arch, jax.random.PRNGKey(seed),
                                         smoke=True)
    assert layout == "adagrad"
    return state


def _carry(state, cfg):
    return state_from_jax(jax.tree.map(np.asarray, state), cfg, CPU)


def _np_batch(cfg, B=16, seed=0, step=0):
    gen = synthetic.recsys_batches(
        batch=B, n_dense=cfg.n_dense, n_sparse=cfg.n_sparse,
        table_sizes=cfg.table_sizes, seq_len=cfg.seq_len, seed=seed)
    for _ in range(step):
        next(gen)
    return next(gen)


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def cfg_jax(arch):
    return jax_config(arch).SMOKE


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_field_for_field(arch, which):
    import dataclasses

    mine = getattr(get_config(arch), which)
    ref = getattr(jax_config(arch), which)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.total_rows == ref.total_rows


@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_and_table_sizes_are_the_reference_s(arch):
    mod, ref = get_config(arch), jax_config(arch)
    for name, spec in ref.SHAPES.items():
        mine = mod.SHAPES[name]
        assert (mine.kind, mine.batch, mine.n_candidates) == (
            spec.kind, spec.batch, spec.n_candidates)
    assert mod.SHAPES is SHAPES_RECSYS
    for name in ("MLPERF_TABLE_SIZES", "TABLE_SIZES"):
        if hasattr(ref, name):
            assert getattr(mod, name) == getattr(ref, name)


@pytest.mark.parametrize("alias", sorted(ALIASES))
def test_aliases_resolve(alias):
    assert configs.resolve_arch(alias) == ALIASES[alias]
    assert get_config(alias) is get_config(ALIASES[alias])
    assert configs.ALIASES[alias] == jax_config.__globals__["ALIASES"][alias]
    assert ALIASES[alias] in configs.RECSYS_ARCHS


def test_dlrm_full_tables_are_96_gb():
    cfg = get_config("dlrm_mlperf").CONFIG
    rows = sum(recsys.padded_rows(r) for r in cfg.table_sizes)
    assert rows == 187_838_464
    assert round(rows * cfg.embed_dim * 4 / 1e9, 1) == 96.2


# ---------------------------------------------------------------------------
# data, tree, optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed,shard", [(0, 0), (3, 2)])
def test_recsys_batches_identical_to_jax(arch, seed, shard):
    cfg = get_config(arch).SMOKE
    kw = dict(batch=9, n_dense=cfg.n_dense, n_sparse=cfg.n_sparse,
              table_sizes=cfg.table_sizes, seq_len=cfg.seq_len, seed=seed,
              shard=shard)
    mine, ref = synthetic.recsys_batches(**kw), jax_data.recsys_batches(**kw)
    for _ in range(3):
        a, b = next(mine), next(ref)
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


def test_recsys_batches_identical_at_the_full_tables():
    cfg = get_config("xdeepfm").CONFIG
    kw = dict(batch=64, n_dense=0, n_sparse=cfg.n_sparse,
              table_sizes=cfg.table_sizes, seed=1)
    a = next(synthetic.recsys_batches(**kw))
    b = next(jax_data.recsys_batches(**kw))
    np.testing.assert_array_equal(a["sparse_idx"], b["sparse_idx"])
    assert a["sparse_idx"].max() < max(cfg.table_sizes)


def _nested(seed=0, *, tuple_node=True):
    """Lists of tables and of layers, and (``tuple_node``) a tuple: the
    reference's optimizers take no tuple node (their results are tuples
    at the leaves)."""
    g = torch.Generator().manual_seed(seed)
    tree = {"tables": [torch.randn((5, 3), generator=g),
                       torch.randn((2, 3), generator=g)],
            "mlp": [{"w": torch.randn((3, 4), generator=g),
                     "b": torch.randn((4,), generator=g)},
                    {"w": torch.randn((4, 1), generator=g),
                     "b": torch.randn((1,), generator=g)}],
            "a": (torch.randn((2,), generator=g),)}
    if not tuple_node:
        tree["a"] = [tree["a"][0]]
    return tree


def test_tree_leaves_are_jax_s_on_lists_and_tuples():
    tree = _nested()
    ref = jax.tree.leaves(jax.tree.map(_np, tree))
    got = tree_leaves(tree)
    assert len(got) == len(ref) == 7
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(_np(a), b)


def test_tree_map_keeps_lists_tuples_and_dict_order():
    tree = _nested()
    out = tree_map(lambda x, y: x + y, tree, tree)
    assert list(out) == ["tables", "mlp", "a"]
    assert isinstance(out["tables"], list) and isinstance(out["a"], tuple)
    assert list(out["mlp"][1]) == ["w", "b"]
    torch.testing.assert_close(out["mlp"][0]["w"], 2 * tree["mlp"][0]["w"])
    assert list(tree_items(tree)) == [
        "tables/0", "tables/1", "mlp/0/w", "mlp/0/b", "mlp/1/w", "mlp/1/b",
        "a/0"]


def test_tree_on_dicts_is_unchanged():
    """A dict-only tree: tree_map keeps insertion order, tree_leaves sorts
    the keys, tree_items names by path in insertion order."""
    tree = {"z": torch.ones(1), "a": {"y": torch.zeros(2), "b": torch.ones(3)}}
    assert [x.numel() for x in tree_leaves(tree)] == [3, 2, 1]
    assert list(tree_map(lambda x: x, tree)) == ["z", "a"]
    assert list(tree_items(tree)) == ["z", "a/y", "a/b"]
    assert tree_map(lambda x: x, 3) == 3


def test_adagrad_matches_jax_on_a_nested_tree_with_lists():
    params = _nested(1, tuple_node=False)
    jparams = jax.tree.map(lambda x: jnp.asarray(_np(x)), params)
    mine, ref = opt.adagrad(0.05), jax_opt.adagrad(0.05)
    state, jstate = mine.init(params), ref.init(jparams)
    assert jax.tree.structure(jax.tree.map(_np, state)) == \
        jax.tree.structure(jstate)
    for s in range(3):
        grads = _nested(10 + s, tuple_node=False)
        jgrads = jax.tree.map(lambda x: jnp.asarray(_np(x)), grads)
        upd, state = mine.update(grads, state, params, s)
        jupd, jstate = ref.update(jgrads, jstate, jparams, jnp.int32(s))
        params = opt.apply_updates(params, upd)
        jparams = jax_opt.apply_updates(jparams, jupd)
    for a, b in zip(tree_leaves(params) + tree_leaves(state),
                    jax.tree.leaves(jparams) + jax.tree.leaves(jstate)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    assert all(a.dtype == torch.float32 for a in tree_leaves(state))


def test_adagrad_keeps_an_untouched_row_as_the_reference():
    """A zero gradient row: acc stays 0.1 and the param exactly the
    same."""
    p = {"t": [torch.ones((3, 2))]}
    g = {"t": [torch.tensor([[1.0, 2.0], [0.0, 0.0], [3.0, 0.0]])]}
    o = opt.adagrad(0.1)
    upd, st = o.update(g, o.init(p), p, 0)
    new = opt.apply_updates(p, upd)
    assert torch.equal(new["t"][0][1], p["t"][0][1])
    assert torch.equal(st["acc"]["t"][0][1], torch.full((2,), 0.1))


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_momentum_matches_jax(nesterov):
    params = _nested(2, tuple_node=False)
    jparams = jax.tree.map(lambda x: jnp.asarray(_np(x)), params)
    sched = schedules.cosine_schedule(0.1, 10)
    mine = opt.sgd_momentum(sched, nesterov=nesterov)
    ref = jax_opt.sgd_momentum(jax_sched.cosine_schedule(0.1, 10),
                               nesterov=nesterov)
    state, jstate = mine.init(params), ref.init(jparams)
    for s in range(3):
        grads = _nested(20 + s, tuple_node=False)
        jgrads = jax.tree.map(lambda x: jnp.asarray(_np(x)), grads)
        upd, state = mine.update(grads, state, params, s)
        jupd, jstate = ref.update(jgrads, jstate, jparams, jnp.int32(s))
        params = opt.apply_updates(params, upd)
        jparams = jax_opt.apply_updates(jparams, jupd)
    for a, b in zip(tree_leaves(params) + tree_leaves(state),
                    jax.tree.leaves(jparams) + jax.tree.leaves(jstate)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 14])
def test_schedules_match_jax(step):
    s = jnp.int32(step)
    for mine, ref in (
            (schedules.cosine_schedule(3e-4, 10),
             jax_sched.cosine_schedule(3e-4, 10)),
            (schedules.cosine_schedule(1.0, 12, final_fraction=0.0),
             jax_sched.cosine_schedule(1.0, 12, final_fraction=0.0)),
            (schedules.linear_warmup_linear_decay(2e-3, 4, 12),
             jax_sched.linear_warmup_linear_decay(2e-3, 4, 12))):
        assert np.float32(mine(step)) == np.float32(ref(s))


# ---------------------------------------------------------------------------
# the gather rule
# ---------------------------------------------------------------------------

def test_take_rows_follows_jnp_take_with_its_gradient():
    """Ids -1 (wrapped), in range, -5 and 4 (outside a 4-row table) and
    100: the values and the table's gradient of ``sum(rows * c)``."""
    t = np.arange(12, dtype=np.float32).reshape(4, 3) / 7
    idx = np.array([[-1, 0, 3], [4, 100, -5]], np.int32)
    c = np.linspace(-1, 1, 18, dtype=np.float32).reshape(2, 3, 3)
    ref = np.asarray(jnp.take(jnp.asarray(t), jnp.asarray(idx), axis=0))
    got = recsys.take_rows(torch.from_numpy(t), torch.from_numpy(idx))
    np.testing.assert_array_equal(_np(got), ref)
    assert np.isnan(ref[1]).all() and np.isfinite(ref[0]).all()
    np.testing.assert_array_equal(ref[0, 0], t[3])
    jgrad = jax.grad(lambda tt: jnp.sum(
        jnp.take(tt, jnp.asarray(idx), axis=0) * c))(jnp.asarray(t))
    tt = torch.from_numpy(t).requires_grad_(True)
    (recsys.take_rows(tt, torch.from_numpy(idx)) * torch.from_numpy(c)
     ).sum().backward()
    np.testing.assert_array_equal(_np(tt.grad), np.asarray(jgrad))


def test_lookup_on_padded_rows_and_past_them_matches_jax():
    """DLRM's SMOKE tables (100 real rows padded to 4096): ids -1, the last
    real row, padded rows, the last padded row and past it."""
    cfg = get_config("dlrm_mlperf").SMOKE
    jstate = _jax_state("dlrm_mlperf")
    tables = _carry(jstate, cfg)["params"]["tables"]
    idx = np.array([[-1, 99, 100, 4095], [4096, 5000, 0, -4096]], np.int32)
    idx = np.concatenate([idx, idx], axis=1)[:, :4]
    c = np.linspace(-2, 2, 2 * 4 * 16, dtype=np.float32).reshape(2, 4, 16)

    def jax_fn(ts):
        return jnp.sum(jax_recsys._lookup_all(ts, jnp.asarray(idx)) * c)

    ref = np.asarray(jax_recsys._lookup_all(jstate["params"]["tables"],
                                            jnp.asarray(idx)))
    jgrads = jax.grad(jax_fn)(jstate["params"]["tables"])
    live = [t.clone().requires_grad_(True) for t in tables]
    out = recsys._lookup_all(live, torch.from_numpy(idx))
    np.testing.assert_array_equal(_np(out), ref)
    (out * torch.from_numpy(c)).sum().backward()
    for t, g in zip(live, jgrads):
        np.testing.assert_array_equal(_np(t.grad), np.asarray(g))
    assert np.isnan(ref[1, :2]).all() and np.isfinite(ref[0]).all()


def test_dlrm_interaction_pairs_are_row_major():
    for n in (2, 5, 27):
        iu, ju = torch.triu_indices(n, n, offset=1)
        ri, rj = np.triu_indices(n, k=1)
        np.testing.assert_array_equal(iu.numpy(), ri)
        np.testing.assert_array_equal(ju.numpy(), rj)


@pytest.mark.parametrize("rows", [1, 100, 4095, 4096, 4097, 39884406])
def test_padded_rows_matches(rows):
    assert recsys.padded_rows(rows) == jax_recsys.padded_rows(rows)
    assert recsys.ROW_PAD == jax_recsys.ROW_PAD


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_tree(arch):
    cfg = get_config(arch).SMOKE
    mine = steps.init_state(arch, torch.Generator().manual_seed(0),
                            smoke=True)
    ref = _jax_state(arch)
    assert jax.tree.structure(jax.tree.map(_np, mine)) == \
        jax.tree.structure(ref)
    for a, b in zip(tree_leaves(mine["params"]),
                    jax.tree.leaves(ref["params"])):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    assert all(bool((a == 0.1).all()) for a in tree_leaves(mine["opt"]))
    for t, raw in zip(mine["params"].get("tables", []), cfg.table_sizes):
        assert t.shape[0] == recsys.padded_rows(raw)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_user_embedding_match_jax(arch):
    cfg = get_config(arch).SMOKE
    jstate = _jax_state(arch)
    params = _carry(jstate, cfg)["params"]
    batch = _np_batch(cfg, B=16, seed=4)
    tol = FWD_TOL
    got = recsys.forward(params, cfg, _torch(batch))
    ref = jax_recsys.forward(jstate["params"], cfg_jax(arch), _jnp(batch))
    assert got.shape == (16,) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=tol, atol=tol)
    qv = recsys.user_embedding(params, cfg, _torch(batch))
    jqv = jax_recsys.user_embedding(jstate["params"], cfg_jax(arch),
                                    _jnp(batch))
    assert qv.shape == (16, cfg.embed_dim)
    np.testing.assert_allclose(_np(qv), np.asarray(jqv), rtol=tol, atol=tol)


def test_dien_unroll_changes_nothing():
    cfg = get_config("dien").SMOKE
    state = steps.init_state("dien", torch.Generator().manual_seed(0),
                             smoke=True)
    batch = _torch(_np_batch(cfg))
    y1 = recsys.forward(state["params"], cfg, batch, unroll=1)
    y4 = recsys.forward(state["params"], cfg, batch, unroll=4)
    assert torch.equal(y1, y4)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_gives_probabilities_matching_jax(arch):
    cfg = get_config(arch).SMOKE
    jstate = _jax_state(arch)
    params = _carry(jstate, cfg)["params"]
    batch = _np_batch(cfg, B=32, seed=5)
    p = steps.build_recsys_serve_step(cfg)(params, _torch(batch))
    assert not p.requires_grad
    assert bool(((p >= 0) & (p <= 1)).all())
    ref = jax.jit(jax_steps.build_recsys_serve_step(cfg_jax(arch)))(
        jstate["params"], _jnp(batch))
    np.testing.assert_allclose(_np(p), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_state_from_jax_refuses_a_wrong_tree():
    cfg = get_config("xdeepfm").SMOKE
    host = jax.tree.map(np.asarray, _jax_state("xdeepfm"))
    bad = dict(host["params"], cin=host["params"]["cin"][:1])
    with pytest.raises(ValueError, match="do not match"):
        recsys_params_from_jax(bad, cfg, CPU)
    tables = host["params"]["tables"]
    wrong = dict(host["params"], tables=[
        t[:-1] if i == 2 else t for i, t in enumerate(tables)])
    with pytest.raises(ValueError, match="tables/2 has shape"):
        recsys_params_from_jax(wrong, cfg, CPU)
    other = get_config("wide_deep").SMOKE
    with pytest.raises(ValueError):
        state_from_jax(host, other, CPU)


# ---------------------------------------------------------------------------
# retrieval
# ---------------------------------------------------------------------------

def _candidates(N, D, seed, dup=()):
    C = np.random.default_rng(seed).normal(size=(N, D)).astype(np.float32)
    for src, dst in dup:         # exact ties: equal rows, equal scores
        C[dst] = C[src]
    return C


@pytest.mark.parametrize("arch", ARCHS)
def test_retrieval_step_ids_identical_to_jax(arch):
    """``build_retrieval_step`` at N 500 (one tile) and ``streaming_topk``
    at tile 128 on its query vectors, against the JAX step and the JAX
    ``streaming_topk``: ids identical, ties (duplicated rows) to the
    lowest id."""
    cfg = get_config(arch).SMOKE
    jstate = _jax_state(arch)
    params = _carry(jstate, cfg)["params"]
    batch = _np_batch(cfg, B=3, seed=6)
    C = _candidates(500, cfg.embed_dim, 7,
                    dup=[(3, 400), (10, 11), (200, 499)])
    batch["candidates"] = C
    v, i = steps.build_retrieval_step(cfg, None, k=20)(params, _torch(batch))
    jv, ji = jax.jit(jax_steps.build_retrieval_step(cfg_jax(arch), None,
                                                    k=20))(
        jstate["params"], _jnp(batch))
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_array_equal(_np(i), np.asarray(ji))
    np.testing.assert_allclose(_np(v), np.asarray(jv), rtol=1e-5, atol=1e-5)
    # tile 128: four tiles, the last short, on the JAX query vectors
    qv = np.array(jax_recsys.user_embedding(jstate["params"],
                                              cfg_jax(arch), _jnp(batch)))
    v2, i2 = steps.streaming_topk(torch.from_numpy(qv), torch.from_numpy(C),
                                  k=20, tile=128)
    jv2, ji2 = jax_steps.streaming_topk(jnp.asarray(qv), jnp.asarray(C),
                                        k=20, tile=128)
    np.testing.assert_array_equal(_np(i2), np.asarray(ji2))
    np.testing.assert_allclose(_np(v2), np.asarray(jv2), rtol=1e-5,
                               atol=1e-5)


def test_retrieval_ties_go_to_the_lowest_id():
    cfg = get_config("wide_deep").SMOKE
    params = steps.init_state("wide_deep", torch.Generator().manual_seed(1),
                              smoke=True)["params"]
    batch = _torch(_np_batch(cfg, B=1))
    qv = recsys.user_embedding(params, cfg, batch)
    C = torch.from_numpy(_candidates(300, cfg.embed_dim, 8))
    best = int((qv @ C[:200].T).argmax())
    C[260] = C[best]
    C[250] = C[best]
    C[200:] = torch.where((qv @ C[200:].T).T > (qv @ C[best]), -C[200:],
                          C[200:])
    C[260] = C[best]
    C[250] = C[best]
    batch["candidates"] = C
    vals, idx = steps.build_retrieval_step(cfg, k=4)(params, batch)
    assert idx[0, :3].tolist() == [best, 250, 260]
    assert vals[0, 0] == vals[0, 1] == vals[0, 2] > vals[0, 3]


def test_retrieval_step_refuses_a_mesh():
    """Specs without a mesh are refused: they place the params on one
    (the steps over a mesh: ``tests/test_torch_recsys_mesh.py``)."""
    cfg = get_config("dlrm_mlperf").SMOKE
    with pytest.raises(ValueError, match="give the mesh"):
        steps.build_retrieval_step(cfg, param_specs={})
    with pytest.raises(ValueError, match="give the mesh"):
        steps.build_recsys_train_step(cfg, param_specs={})
