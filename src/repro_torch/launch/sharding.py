"""Sharding rules (``repro/launch/sharding.py``): which axes of a mesh split
a batch, a model's parameters, the optimizer's moments (ZeRO) and the
whole train state, and the two helpers that hold a state by such specs.

A spec is a tuple with one entry per dimension: ``None`` (the dimension
is whole on every rank) or a tuple of axis names (split over them,
row-major), as a ``PartitionSpec``. ``core.sharded.local_block`` cuts a
rank's block out of a global tensor by such a spec.

* activations and token batches: dim 0 over the batch axes (``pod`` x
  ``data``), or the largest contiguous run of them that divides the
  batch (``batch_axes_for``, ``batch_spec``, ``batch_shardings``);
* parameters (``transformer_param_specs``): attention heads, FFN hidden
  units, experts and vocabulary rows over ``model`` where the axis
  divides them, else whole; DimeNet's whole; the recsys tables' rows
  over ``model`` (and the batch axes when huge), the MLPs whole;
* optimizer moments (``zero_spec``, ``opt_state_specs``): the param
  spec plus the first free dimension of at least 512 that the batch axes
  divide, split over them (ZeRO).

The spec functions read only ``mesh.shape`` and ``mesh.axis_names``, so a
shape-only ``launch.mesh.AbstractMesh`` such as the production ``(16,
16)`` stands in for a world. JAX places a tensor by a ``NamedSharding``
and gathers it when read; here ``shard_state`` cuts this rank's blocks
out of a global state and ``gather_state`` assembles the global tensors
again (every rank of the mesh calls it). A dimension that a spec splits
unevenly raises; nothing is padded or quietly replicated.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.collectives import all_gather
from repro_torch.launch.mesh import axis_size, batch_axes
from repro_torch.tree import tree_map

Spec = Tuple[Optional[Tuple[str, ...]], ...]
Tree = Any


def batch_axes_for(mesh: Any, n: int) -> Tuple[str, ...]:
    """Largest contiguous batch-axis combination whose product divides
    ``n`` (prefers more shards: ("pod","data") > ("data",) > ("pod",))."""
    baxes = batch_axes(mesh)
    candidates = []
    for i in range(len(baxes)):
        for j in range(i + 1, len(baxes) + 1):
            sub = baxes[i:j]
            prod = 1
            for ax in sub:
                prod *= mesh.shape[ax]
            candidates.append((prod, sub))
    candidates.sort(key=lambda t: -t[0])
    for prod, sub in candidates:
        if n % prod == 0:
            return sub
    return ()


def batch_spec(mesh: Any, n: int, rank: int) -> Spec:
    """``((batch axes), None, ...)`` for an ``(n, ...)`` batch tensor of
    ``rank`` dimensions (``None`` first when no batch axis divides n)."""
    axes = batch_axes_for(mesh, n)
    return (axes if axes else None,) + (None,) * (rank - 1)


# ---------------------------------------------------------------------------
# spec trees
# ---------------------------------------------------------------------------

def map_specs(fn: Callable[..., Any], specs: Tree, *trees: Tree) -> Tree:
    """``fn(spec, *leaves)`` over a tree of specs (nested dicts and lists;
    a tuple is a spec, a leaf) and trees of the same shape."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, *(t[k] for t in trees))
                for k, v in specs.items()}
    if isinstance(specs, list):
        return [map_specs(fn, v, *(t[i] for t in trees))
                for i, v in enumerate(specs)]
    return fn(specs, *trees)


def spec_items(specs: Tree, prefix: str = "") -> Dict[str, Spec]:
    """``{"a/b": spec}`` for every spec of a spec tree, named as
    ``tree.tree_items`` names the leaves of the tree it describes."""
    if isinstance(specs, (dict, list)):
        items = specs.items() if isinstance(specs, dict) else enumerate(specs)
        out: Dict[str, Spec] = {}
        for key, value in items:
            out.update(spec_items(value, f"{prefix}{key}/"))
        return out
    return {prefix[:-1]: specs}


def replicated(ndim: int) -> Spec:
    return (None,) * ndim


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every axis ``spec`` names, in the order of its dimensions."""
    return tuple(a for axes in spec if axes for a in axes)


def block_shape(mesh: Any, spec: Spec, shape) -> Tuple[int, ...]:
    """The shape of one rank's block of a ``shape`` tensor under ``spec``;
    an axis the mesh lacks, an axis named twice, a spec of another rank
    than the tensor or a dimension the axes do not divide raise
    ``ValueError``."""
    shape = tuple(shape)
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} has {len(spec)} entries for a tensor "
                         f"of shape {shape}")
    names = spec_axes(spec)
    unknown = [a for a in names if a not in mesh.shape]
    if unknown or len(set(names)) != len(names):
        raise ValueError(f"spec {spec} names axes {names} that are not "
                         f"distinct axes of the mesh {tuple(mesh.axis_names)}")
    out = []
    for dim, (axes, n) in enumerate(zip(spec, shape)):
        k = axis_size(mesh, axes) if axes else 1
        if n % k:
            raise ValueError(f"spec {spec}: dimension {dim} of {shape} does "
                             f"not split evenly over {axes} ({k} ranks)")
        out.append(n // k)
    return tuple(out)


def zero_extra(param_spec: Spec, zero_spec: Spec
               ) -> Tuple[Tuple[str, ...], ...]:
    """For each dimension, the axes that ``zero_spec`` splits it over
    beyond ``param_spec``'s: the ZeRO block is a block of the param block.
    A zero spec that does not refine the param spec raises."""
    if len(param_spec) != len(zero_spec):
        raise ValueError(f"param spec {param_spec} and ZeRO spec "
                         f"{zero_spec} differ in rank")
    out = []
    for p, z in zip(param_spec, zero_spec):
        p, z = tuple(p or ()), tuple(z or ())
        if z[:len(p)] != p:
            raise ValueError(f"ZeRO spec {zero_spec} does not refine the "
                             f"param spec {param_spec}: each moment block "
                             "must lie inside its param block")
        out.append(z[len(p):])
    return tuple(out)


# ---------------------------------------------------------------------------
# transformer params
# ---------------------------------------------------------------------------

def _divisible(dim: int, mesh: Any, axis: str) -> bool:
    return dim % mesh.shape[axis] == 0


def transformer_param_specs(cfg: Any, mesh: Any) -> Dict[str, Any]:
    """The spec tree of ``models.transformer.init_params``: ``wq`` and
    ``wo`` over ``model`` where it divides ``n_heads * d_head``, ``wk``
    and ``wv`` only where it divides the KV heads (a flat split would
    cross head boundaries), the FFN on ``d_ff`` (an MoE's on its
    experts), ``embed`` and the head's ``E``/``b`` on the vocabulary
    where ``model`` divides it; the rest whole."""
    m = ("model",)
    whole3, whole4 = replicated(3), replicated(4)

    def tp(ok: bool, spec: Spec, fallback: Spec) -> Spec:
        return spec if ok else fallback

    heads_ok = _divisible(cfg.n_heads * cfg.d_head, mesh, "model")
    kv_aligned = cfg.n_kv_heads % mesh.shape["model"] == 0
    attn = {
        "wq": tp(heads_ok, (None, None, m), whole3),
        "wk": tp(kv_aligned, (None, None, m), whole3),
        "wv": tp(kv_aligned, (None, None, m), whole3),
        "wo": tp(heads_ok, (None, m, None), whole3),
    }
    if cfg.is_moe:
        ok = _divisible(cfg.n_experts, mesh, "model")
        expert = tp(ok, (None, m, None, None), whole4)
        mlp = {"router": whole3, "w_gate": expert, "w_up": expert,
               "w_down": expert}
    else:
        ok = _divisible(cfg.d_ff, mesh, "model")
        mlp = {"w_gate": tp(ok, (None, None, m), whole3),
               "w_up": tp(ok, (None, None, m), whole3),
               "w_down": tp(ok, (None, m, None), whole3)}
    vocab_ok = _divisible(cfg.vocab_size, mesh, "model")
    rows = (m, None) if vocab_ok else replicated(2)
    specs: Dict[str, Any] = {
        "embed": rows,
        "layers": {"attn": attn, "mlp": mlp, "ln1": replicated(2),
                   "ln2": replicated(2)},
        "final_norm": replicated(1),
        "lm_head": {"b": (m,) if vocab_ok else replicated(1)},
    }
    if not cfg.tie_embeddings:
        specs["lm_head"]["E"] = rows
    return specs


# ---------------------------------------------------------------------------
# GNN / recsys params
# ---------------------------------------------------------------------------

def dimenet_param_specs(cfg: Any, mesh: Any) -> Any:
    """DimeNet's params are small (< 10M): every leaf whole. The shapes
    come from ``models.dimenet.init_params`` on ``meta`` tensors."""
    from repro_torch.models import dimenet as dn

    params = dn.init_params(torch.Generator(), cfg, device="meta")
    return tree_map(lambda leaf: replicated(leaf.ndim), params)


def recsys_param_specs(cfg: Any, mesh: Any) -> Any:
    """Embedding-table rows over ``model`` (and the batch axes too when a
    table has a million rows or more and they divide it); tables under
    131072 padded rows whole, so that their lookups need no collective;
    the MLPs whole."""
    from repro_torch.models.recsys import padded_rows

    baxes = batch_axes(mesh)

    def table_spec(raw_rows: int) -> Spec:
        rows = padded_rows(raw_rows)
        if rows < 131_072:
            return replicated(2)
        total = mesh.shape["model"] * axis_size(mesh, baxes)
        if rows >= 1_000_000 and rows % total == 0:
            return (("model",) + baxes, None)
        if rows % mesh.shape["model"] == 0:
            return (("model",), None)
        return replicated(2)

    def mlp_spec(layers):
        return [{"w": replicated(2), "b": replicated(1)} for _ in layers]

    if cfg.interaction == "dot":
        return {"tables": [table_spec(r) for r in cfg.table_sizes],
                "bot_mlp": mlp_spec(cfg.bot_mlp[:-1]),
                "top_mlp": mlp_spec(cfg.top_mlp)}
    if cfg.interaction == "cin":
        return {"tables": [table_spec(r) for r in cfg.table_sizes],
                "linear": [table_spec(r) for r in cfg.table_sizes],
                "cin": [replicated(2) for _ in cfg.cin_layers],
                "dnn": mlp_spec(cfg.mlp),
                "out": mlp_spec((1,))}
    if cfg.interaction == "augru":
        gru = {"w": replicated(2), "u": replicated(2), "b": replicated(1)}
        return {"item_table": table_spec(cfg.table_sizes[0]),
                "gru1": dict(gru), "augru": dict(gru),
                "att": mlp_spec((1, 2)), "item_proj": mlp_spec((1,)),
                "mlp": mlp_spec(cfg.mlp + (1,))}
    if cfg.interaction == "concat":
        return {"tables": [table_spec(r) for r in cfg.table_sizes],
                "wide": [table_spec(r) for r in cfg.table_sizes],
                "deep": mlp_spec(cfg.mlp + (1,))}
    raise ValueError(cfg.interaction)


# ---------------------------------------------------------------------------
# optimizer state (ZeRO) + state assembly
# ---------------------------------------------------------------------------

def zero_spec(param_spec: Spec, shape, mesh: Any) -> Spec:
    """``param_spec`` plus the first free dimension of at least 512 that the
    batch axes' product divides, split over them (every batch axis when
    their product is a power of two: ``batch_axes_for(mesh, 2**30)``);
    ``param_spec`` itself when there is none."""
    baxes = batch_axes_for(mesh, 1 << 30)
    if not baxes:
        return param_spec
    n_shards = axis_size(mesh, baxes)
    entries = list(param_spec) + [None] * (len(shape) - len(param_spec))
    for i, (cur, dim) in enumerate(zip(entries, shape)):
        if cur is None and dim % n_shards == 0 and dim >= 512:
            entries[i] = baxes
            return tuple(entries)
    return param_spec


def opt_state_specs(param_specs: Tree, params_shape: Tree, mesh: Any
                    ) -> Tree:
    """``zero_spec`` of each leaf: ``params_shape`` is a tree like the
    params of anything with a ``.shape`` (``meta`` tensors, say)."""
    return map_specs(lambda spec, leaf: zero_spec(spec, leaf.shape, mesh),
                     param_specs, params_shape)


def state_shardings(param_specs: Tree, params_shape: Tree, opt_layout: str,
                    mesh: Any) -> Dict[str, Any]:
    """The spec tree of the whole train state: ``{"params": param_specs,
    "opt": {"mu", "nu"} (``"adamw"``) | {"acc"} (``"adagrad"``) | {"v"}
    (``"sgd"``), each at the ZeRO specs, "step": ()}``."""
    zspecs = opt_state_specs(param_specs, params_shape, mesh)
    if opt_layout == "adamw":
        opt = {"mu": zspecs, "nu": zspecs}
    elif opt_layout == "adagrad":
        opt = {"acc": zspecs}
    elif opt_layout == "sgd":
        opt = {"v": zspecs}
    else:
        raise ValueError(opt_layout)
    return {"params": param_specs, "opt": opt, "step": ()}


def batch_shardings(mesh: Any, batch_specs: Dict[str, Any],
                    overrides: Optional[Dict[str, Spec]] = None
                    ) -> Dict[str, Spec]:
    """Each batch entry's spec (``batch_specs`` maps a name to anything with
    a ``.shape``): ``overrides``' where given, else dim 0 over the batch
    axes that divide it (``batch_spec``)."""
    out = {}
    for name, x in batch_specs.items():
        if overrides and name in overrides:
            out[name] = overrides[name]
        else:
            out[name] = batch_spec(mesh, x.shape[0], len(x.shape))
    return out


def candidate_block(mesh: Any, candidates: Any) -> Any:
    """This rank's row block of a global ``(N, D)`` candidate matrix, its
    rows split over every axis of the mesh (row-major in the mesh's
    order, the reference's ``P(axes, None)``; a view, the rows must split
    evenly): what ``build_retrieval_step(cfg, mesh)`` takes as
    ``batch["candidates"]``, the query inputs whole."""
    from repro_torch.core.sharded import local_block

    block_shape(mesh, (tuple(mesh.axis_names), None), candidates.shape)
    return local_block(mesh, (tuple(mesh.axis_names), None), candidates)


# ---------------------------------------------------------------------------
# a state held by its specs
# ---------------------------------------------------------------------------

def shard_state(mesh: Any, specs: Tree, state: Tree) -> Tree:
    """This rank's blocks of the global ``state`` under ``specs`` (a spec
    tree like it: ``state_shardings``' for a train state): each split
    leaf a contiguous copy of its block, so that the global tensor can
    be freed; a whole leaf and a non-tensor (the step) as given. The
    counterpart of ``jax.device_put`` with ``NamedSharding``s."""
    from repro_torch.core.sharded import local_block

    def cut(spec, x):
        if not isinstance(x, torch.Tensor):
            return x
        block_shape(mesh, spec, x.shape)
        if not spec_axes(spec):
            return x
        return local_block(mesh, spec, x).clone(
            memory_format=torch.contiguous_format)
    return map_specs(cut, specs, state)


def gather_state(mesh: Any, specs: Tree, state: Tree) -> Tree:
    """The global tensors of a state held by ``specs`` (each rank's blocks
    gathered over the axes that split them; every rank of the mesh calls
    it and gets the same tensors): the counterpart of reading a global
    array, for checks and checkpoints."""
    def gather(spec, x):
        if not isinstance(x, torch.Tensor):
            return x
        with torch.no_grad():
            for dim, axes in enumerate(spec):
                if axes:
                    x = all_gather(x, axes, mesh, dim=dim)
        return x
    return map_specs(gather, specs, state)


def state_nbytes(mesh: Any, specs: Tree, state: Tree) -> int:
    """The bytes one rank holds of ``state`` (global tensors, ``meta`` ones
    will do) under ``specs``: each tensor's block size times its element
    size; a non-tensor (the step) counts 0."""
    total = []

    def count(spec, x):
        if isinstance(x, torch.Tensor):
            n = 1
            for k in block_shape(mesh, spec, x.shape):
                n *= k
            total.append(n * x.element_size())
    map_specs(count, specs, state)
    return sum(total)
