"""The spec functions of ``launch/sharding.py`` against the JAX package's,
with no world: ``transformer_param_specs``, ``dimenet_param_specs``,
``recsys_param_specs``, ``zero_spec``, ``opt_state_specs``,
``state_shardings`` and ``batch_shardings``, on the port's shape-only
``launch.mesh.AbstractMesh`` and JAX's ``jax.sharding.AbstractMesh`` of
the same shape. A ``PartitionSpec`` is read as the port's spec: a name
as a one-axis tuple, a tuple of names as it is, ``None`` as it is.

Every arch of ``configs.all_cells`` at CONFIG width (DimeNet also at
each of its cells' input widths, ``arch_config_for_cell``), on the
production meshes ``(16, 16)`` and ``(2, 16, 16)`` and on ``(2, 2)``,
``(1, 2)``, ``(2, 1)`` and ``(1, 4)``, where splade_bert's 30522 and
splade_xlmr's 250002 rows are not divisible by 4 (the vocabulary falls
back to whole). Specs are compared leaf for leaf, exactly.
"""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import all_cells as jax_all_cells
from repro.configs import get_config as jax_config
from repro.configs import specs as jax_specs
from repro.configs.base import DimeNetConfig as JaxDimeNetConfig
from repro.configs.base import TransformerConfig as JaxTransformerConfig
from repro.launch import dryrun as jax_dryrun
from repro.launch import sharding as jax_sharding
from repro.launch import steps as jax_steps
from repro.models import dimenet as jax_dimenet
from repro.models import recsys as jax_recsys
from repro.models import transformer as jax_tfm
from repro_torch.configs import all_cells, get_config
from repro_torch.configs import specs
from repro_torch.configs.base import DimeNetConfig, TransformerConfig
from repro_torch.launch import sharding
from repro_torch.launch import steps
from repro_torch.launch.mesh import AbstractMesh

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x2": ((1, 2), ("data", "model")),
          "2x1": ((2, 1), ("data", "model")),
          "1x4": ((1, 4), ("data", "model"))}
ARCHS = sorted({arch for arch, _, _ in all_cells(True)})
DIMENET_CELLS = sorted({shape for arch, shape, spec in all_cells(True)
                        if arch == "dimenet" and not spec.skip})
CONFIGS = [(arch, None) for arch in ARCHS] + [
    ("dimenet", shape) for shape in DIMENET_CELLS]
CELLS = [(arch, shape) for arch, shape, spec in jax_all_cells(True)
         if not spec.skip]


def _meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), JaxAbstractMesh(shape, axes)


def _port_spec(spec):
    """A ``PartitionSpec`` (or a ``NamedSharding``'s) as the port's spec."""
    if isinstance(spec, NamedSharding):
        spec = spec.spec
    return tuple(None if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in spec)


def _jax_flat(tree):
    """``{path: spec}`` of a JAX tree of specs or shardings."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (P, NamedSharding)))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): _port_spec(leaf)
            for path, leaf in leaves}


def _port_flat(tree, prefix=""):
    """``{path: spec}`` of the port's tree of specs."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


@functools.lru_cache(maxsize=None)
def _configs(arch, cell):
    """(port config, JAX config) at CONFIG width, or adapted to ``cell``."""
    if cell is None:
        return get_config(arch).CONFIG, jax_config(arch).CONFIG
    return (steps.arch_config_for_cell(arch, specs.cell_spec(arch, cell)),
            jax_steps.arch_config_for_cell(
                arch, jax_specs.cell_spec(arch, cell)))


@functools.lru_cache(maxsize=None)
def _shapes(arch, cell):
    """The params' shapes: the port's on ``meta`` tensors, JAX's from
    ``jax.eval_shape``."""
    cfg, jcfg = _configs(arch, cell)
    port = steps.init_params(cfg, torch.Generator(), device="meta")
    if isinstance(jcfg, JaxTransformerConfig):
        init = lambda k: jax_tfm.init_params(k, jcfg)  # noqa: E731
    elif isinstance(jcfg, JaxDimeNetConfig):
        init = lambda k: jax_dimenet.init_params(k, jcfg)  # noqa: E731
    else:
        init = lambda k: jax_recsys.init_params(k, jcfg)  # noqa: E731
    return port, jax.eval_shape(init, jax.ShapeDtypeStruct((2,), jnp.uint32))


def _param_specs(arch, cell, mesh, jmesh):
    cfg, jcfg = _configs(arch, cell)
    if isinstance(cfg, TransformerConfig):
        return (sharding.transformer_param_specs(cfg, mesh),
                jax_sharding.transformer_param_specs(jcfg, jmesh), "adamw")
    if isinstance(cfg, DimeNetConfig):
        return (sharding.dimenet_param_specs(cfg, mesh),
                jax_sharding.dimenet_param_specs(jcfg, jmesh), "adamw")
    return (sharding.recsys_param_specs(cfg, mesh),
            jax_sharding.recsys_param_specs(jcfg, jmesh), "adagrad")


def _config_id(case):
    arch, cell = case
    return arch if cell is None else f"{arch}-{cell}"


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("case", CONFIGS, ids=_config_id)
def test_param_specs_equal_jax(case, mesh_name):
    mesh, jmesh = _meshes(mesh_name)
    port, ref, _ = _param_specs(*case, mesh, jmesh)
    assert _port_flat(port) == _jax_flat(ref)
    shapes = _port_flat(sharding.map_specs(lambda s, x: tuple(x.shape), port,
                                           _shapes(*case)[0]))
    for path, spec in _port_flat(port).items():
        assert len(spec) == len(shapes[path]), path


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("case", CONFIGS, ids=_config_id)
def test_state_specs_equal_jax(case, mesh_name):
    """``opt_state_specs`` (``zero_spec`` on every leaf) and
    ``state_shardings``' whole tree."""
    mesh, jmesh = _meshes(mesh_name)
    port, ref, layout = _param_specs(*case, mesh, jmesh)
    port_shapes, jax_shapes = _shapes(*case)
    assert _port_flat(sharding.opt_state_specs(port, port_shapes, mesh)) \
        == _jax_flat(jax_sharding.opt_state_specs(ref, jax_shapes, jmesh))
    got = sharding.state_shardings(port, port_shapes, layout, mesh)
    want = jax_sharding.state_shardings(ref, jax_shapes, layout, jmesh)
    assert _port_flat(got) == _jax_flat(want)
    assert got["step"] == () and sorted(got["opt"]) == sorted(want["opt"])


def test_xlmr_on_the_production_mesh_replicates_embed_and_zero_splits_it():
    """At (16, 16) 250002 rows do not divide over 16 ``model`` ranks: the
    embedding is whole and its moments split dim 1 (768) over ``data``."""
    cfg = get_config("splade_xlmr").CONFIG
    mesh = AbstractMesh((16, 16), ("data", "model"))
    params = steps.init_params(cfg, torch.Generator(), device="meta")
    state = sharding.state_shardings(
        sharding.transformer_param_specs(cfg, mesh), params, "adamw", mesh)
    assert state["params"]["embed"] == (None, None)
    assert state["opt"]["mu"]["embed"] == (None, ("data",))
    assert state["params"]["layers"]["attn"]["wq"] == (None, None,
                                                       ("model",))


ZERO_EDGES = {  # name: (param spec, shape, mesh)
    "first_dim_512": ((None, None), (512, 64), "2x2"),
    "511_skipped": ((None, None), (511, 1024), "2x2"),
    "nothing_reaches_512": ((None, None), (64, 128), "2x2"),
    "split_dims_skipped": ((("model",), None), (1024, 1000), "2x2"),
    "pod_and_data": ((None, None), (512, 512), "2x16x16"),
    "528_not_divisible_by_32": ((None, None), (528, 1024), "2x16x16"),
    "data_of_one": ((None, ("model",)), (768, 1024), "1x2"),
    "short_param_spec": ((None,), (8, 1024), "2x2"),
    "nothing_divides": ((None, None), (1026, 1030), "16x16"),
    "scalar": ((), (), "2x2"),
}
ODD_MESHES = {"3x2": ((3, 2), ("data", "model")),
              "model_only": ((4,), ("model",))}


@pytest.mark.parametrize("name", list(ZERO_EDGES) + list(ODD_MESHES))
def test_zero_spec_edges_equal_jax(name):
    """The >= 512 and divisibility edges; a batch-axis product that is not
    a power of two (3) and a mesh without batch axes add nothing."""
    if name in ODD_MESHES:
        shape, axes = ODD_MESHES[name]
        mesh, jmesh = AbstractMesh(shape, axes), JaxAbstractMesh(shape, axes)
        spec, dims = (None, None), (1536, 1024)
    else:
        spec, dims, mesh_name = ZERO_EDGES[name]
        mesh, jmesh = _meshes(mesh_name)
    jspec = P(*(None if e is None else e[0] if len(e) == 1 else e
                for e in spec))
    assert sharding.zero_spec(spec, dims, mesh) == _port_spec(
        jax_sharding.zero_spec(jspec, dims, jmesh))


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16", "2x2"])
@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_batch_shardings_equal_jax(cell, mesh_name):
    """Each cell's batch, with no overrides and with the JAX dry run's own
    (``_batch_overrides``: caches, candidates, graph arrays)."""
    mesh, jmesh = _meshes(mesh_name)
    arch, shape = cell
    batch = specs.cell_spec(arch, shape).batch
    jbatch = jax_specs.cell_spec(arch, shape).batch
    plain = sharding.batch_shardings(mesh, batch)
    assert plain == {k: _port_spec(v) for k, v in
                     jax_sharding.batch_shardings(jmesh, jbatch).items()}
    jover = jax_dryrun._batch_overrides(arch, jax_specs.cell_spec(
        arch, shape), jmesh)
    over = {k: _port_spec(v) for k, v in jover.items()}
    got = sharding.batch_shardings(mesh, batch, over)
    assert got == {k: _port_spec(v) for k, v in jax_sharding.batch_shardings(
        jmesh, jbatch, jover).items()}
    assert all(got[k] == over[k] for k in over)


@pytest.mark.parametrize("what", ["uneven", "unknown_axis", "repeated_axis",
                                  "wrong_rank", "not_refining"])
def test_a_spec_the_tensor_cannot_take_raises(what):
    mesh = AbstractMesh((2, 2), ("data", "model"))
    with pytest.raises(ValueError):
        if what == "uneven":
            sharding.shard_state(mesh, {"x": (("model",),)},
                                 {"x": torch.zeros(3)})
        elif what == "unknown_axis":
            sharding.block_shape(mesh, (("pod",),), (4,))
        elif what == "repeated_axis":
            sharding.block_shape(mesh, (("data",), ("data",)), (4, 4))
        elif what == "wrong_rank":
            sharding.state_nbytes(mesh, {"x": (None,)},
                                  {"x": torch.zeros(2, 2)})
        else:
            sharding.zero_extra((("model",), None), (None, ("data",)))


def test_state_nbytes_counts_each_rank_block():
    cfg = get_config("splade_xlmr").CONFIG
    state = steps.new_state(cfg, torch.Generator(), device="meta")
    whole = 305_516_946 * 12
    counts = {}
    for name in ("1x2", "2x1", "2x2"):
        mesh, _ = _meshes(name)
        counts[name] = sharding.state_nbytes(mesh, sharding.state_shardings(
            sharding.transformer_param_specs(cfg, mesh), state["params"],
            "adamw", mesh), state)
    # (1, 2): all but ln1, ln2, final_norm (19200 values) halved;
    # (2, 1): the f32 params whole, the moments halved but lm_head.b's
    # (250002 rows, its one dimension already given to a model axis of 1)
    assert counts["1x2"] == ((305_516_946 - 19_200) // 2 + 19_200) * 12
    assert counts["2x1"] == 305_516_946 * 4 + (
        (305_516_946 - 250_002) // 2 + 250_002) * 8
    assert counts["2x2"] < counts["1x2"] < counts["2x1"] < whole
