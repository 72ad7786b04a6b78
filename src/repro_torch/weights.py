"""Carry the JAX package's parameters and train state over to the port.

``params_from_jax`` takes the JAX param pytree of a transformer (dense
or MoE), already converted to numpy arrays by the caller (stacked ``(L, ...)``
layer leaves, weights laid out for ``x @ W``), and returns the port's
params: the same tree of tensors on ``device``. ``recsys_params_from_jax``
does the same for a recsys model (lists of tables, lists of ``{"w", "b"}``
layers), ``dimenet_params_from_jax`` for DimeNet (its list of blocks;
``embed_nodes`` an ``(n_atom_types, d)`` table when ``d_feat == 0``, a
``{"w", "b"}`` layer otherwise). ``state_from_jax`` carries a whole train
state: params, the optimizer state (the AdamW moments of a transformer
or of DimeNet, the Adagrad accumulators of a recsys model) and the step.
A bf16 leaf (the decoders' published CONFIGs hold bf16 params) is carried
by its bits.
With them both packages compute the same function and take the same
steps, which is how the tests compare them. This module imports no JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import (DimeNetConfig, RecSysConfig,
                                      TransformerConfig)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_items, tree_map


def _expected_shapes(cfg: TransformerConfig) -> Dict[str, tuple]:
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    H, KV, dh, Fd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff
    shapes = {
        "embed": (V, D),
        "layers/attn/wq": (L, D, H * dh),
        "layers/attn/wk": (L, D, KV * dh),
        "layers/attn/wv": (L, D, KV * dh),
        "layers/attn/wo": (L, H * dh, D),
        "layers/ln1": (L, D),
        "layers/ln2": (L, D),
        "final_norm": (D,),
        "lm_head/b": (V,),
    }
    if cfg.is_moe:
        E = cfg.n_experts
        shapes.update({"layers/mlp/router": (L, D, E),
                       "layers/mlp/w_gate": (L, E, D, Fd),
                       "layers/mlp/w_up": (L, E, D, Fd),
                       "layers/mlp/w_down": (L, E, Fd, D)})
    else:
        shapes.update({"layers/mlp/w_gate": (L, D, Fd),
                       "layers/mlp/w_up": (L, D, Fd),
                       "layers/mlp/w_down": (L, Fd, D)})
    if not cfg.tie_embeddings:
        shapes["lm_head/E"] = (V, D)
    return shapes


def params_from_jax(tree: Dict[str, Any], cfg: TransformerConfig,
                    device: DeviceLike = None) -> Dict[str, Any]:
    """The port's params from a numpy copy of the JAX pytree.

    Raises if a leaf is missing, extra or of the wrong shape for ``cfg``
    (an MoE tree has other leaves than a dense one: either is refused for
    the other's config).
    """
    dev = resolve_device(device)
    flat = tree_items(tree)
    expected = _expected_shapes(cfg)
    if set(flat) != set(expected):
        raise ValueError(
            f"params_from_jax: leaves {sorted(set(flat) ^ set(expected))} "
            f"do not match {'an MoE' if cfg.is_moe else 'a dense'} "
            f"{cfg.name} tree")
    out: Dict[str, Any] = {}
    for path, value in flat.items():
        arr = np.asarray(value)
        if arr.shape != expected[path]:
            raise ValueError(f"params_from_jax: {path} has shape "
                             f"{arr.shape}, {cfg.name} needs "
                             f"{expected[path]}")
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = _tensor(arr).to(dev)
    return out


def _mlp_shapes(prefix: str, dims) -> Dict[str, tuple]:
    out: Dict[str, tuple] = {}
    for i in range(len(dims) - 1):
        out[f"{prefix}/{i}/w"] = (dims[i], dims[i + 1])
        out[f"{prefix}/{i}/b"] = (dims[i + 1],)
    return out


def _recsys_shapes(cfg: RecSysConfig) -> Dict[str, tuple]:
    """Every leaf's path and shape in ``models.recsys.init_params``'s
    tree for ``cfg``."""
    from repro_torch.models.recsys import padded_rows

    d, m = cfg.embed_dim, cfg.n_sparse

    def tables(name, dim):
        return {f"{name}/{i}": (padded_rows(rows), dim)
                for i, rows in enumerate(cfg.table_sizes)}

    if cfg.interaction == "dot":
        n_f = m + 1
        return {**tables("tables", d), **_mlp_shapes("bot_mlp", cfg.bot_mlp),
                **_mlp_shapes("top_mlp", (d + n_f * (n_f - 1) // 2,)
                              + tuple(cfg.top_mlp))}
    if cfg.interaction == "cin":
        cin, h_prev = {}, m
        for i, h in enumerate(cfg.cin_layers):
            cin[f"cin/{i}"] = (h_prev * m, h)
            h_prev = h
        return {**tables("tables", d), **tables("linear", 1), **cin,
                **_mlp_shapes("dnn", (m * d,) + tuple(cfg.mlp)),
                **_mlp_shapes("out", (cfg.mlp[-1] + sum(cfg.cin_layers)
                                      + 1, 1))}
    if cfg.interaction == "augru":
        g = cfg.gru_dim
        gru = {f"{name}/{k}": shape for name, d_in in (("gru1", d),
                                                        ("augru", g))
               for k, shape in (("w", (d_in, 3 * g)), ("u", (g, 3 * g)),
                                ("b", (3 * g,)))}
        return {"item_table": (padded_rows(cfg.table_sizes[0]), d), **gru,
                **_mlp_shapes("att", (2 * g, 36, 1)),
                **_mlp_shapes("item_proj", (d, g)),
                **_mlp_shapes("mlp", (2 * g + d,) + tuple(cfg.mlp) + (1,))}
    if cfg.interaction == "concat":
        return {**tables("tables", d), **tables("wide", 1),
                **_mlp_shapes("deep", (m * d,) + tuple(cfg.mlp) + (1,))}
    raise ValueError(f"unknown interaction {cfg.interaction!r}")


def _carry_checked(tree: Any, expected: Dict[str, tuple], what: str,
                   kind: str, device: DeviceLike) -> Any:
    """``tree`` with every leaf a tensor on ``device``, the same dicts and
    lists; raises if a leaf is missing, extra or not of its ``expected``
    shape."""
    dev = resolve_device(device)
    out = tree_map(lambda a: _tensor(np.asarray(a)).to(dev), tree)
    flat = tree_items(out)
    if set(flat) != set(expected):
        raise ValueError(
            f"{what}: leaves {sorted(set(flat) ^ set(expected))} do not "
            f"match a {kind} tree")
    for path, value in flat.items():
        if tuple(value.shape) != expected[path]:
            raise ValueError(f"{what}: {path} has shape "
                             f"{tuple(value.shape)}, {kind} needs "
                             f"{expected[path]}")
    return out


def recsys_params_from_jax(tree: Dict[str, Any], cfg: RecSysConfig,
                           device: DeviceLike = None) -> Dict[str, Any]:
    """The port's recsys params (or a tree like them, such as Adagrad's
    accumulators) from a numpy copy of the JAX pytree: the same dicts and
    lists, each leaf a tensor on ``device``. Raises if a leaf is missing,
    extra or of the wrong shape for ``cfg`` (every table's padded rows,
    every layer's widths)."""
    return _carry_checked(tree, _recsys_shapes(cfg), "recsys_params_from_jax",
                          f"{cfg.interaction} {cfg.name}", device)


def _dimenet_shapes(cfg: DimeNetConfig) -> Dict[str, tuple]:
    """Every leaf's path and shape in ``models.dimenet.init_params``'s tree
    for ``cfg``."""
    d, r = cfg.d_hidden, cfg.n_radial

    def dense(name, din, dout):
        return {f"{name}/w": (din, dout), f"{name}/b": (dout,)}

    shapes = ({"embed_nodes": (cfg.n_atom_types, d)} if cfg.d_feat == 0
              else dense("embed_nodes", cfg.d_feat, d))
    shapes.update({**dense("embed_rbf", r, d), **dense("embed_msg", 3 * d, d),
                   **dense("out_final", d, cfg.n_targets)})
    for i in range(cfg.n_blocks):
        blk = f"blocks/{i}"
        shapes.update({
            **dense(f"{blk}/rbf_gate", r, d),
            **dense(f"{blk}/sbf_proj", cfg.n_spherical * r, cfg.n_bilinear),
            f"{blk}/w_bilinear": (cfg.n_bilinear, d, d),
            **dense(f"{blk}/msg_in", d, d),
            **dense(f"{blk}/msg_out", 2 * d, d),
            **dense(f"{blk}/out_rbf", r, d),
            **dense(f"{blk}/out_node", d, d)})
    return shapes


def dimenet_params_from_jax(tree: Dict[str, Any], cfg: DimeNetConfig,
                            device: DeviceLike = None) -> Dict[str, Any]:
    """The port's DimeNet params (or a tree like them, such as AdamW's
    moments) from a numpy copy of the JAX pytree, each leaf a tensor on
    ``device``. Raises if a leaf is missing, extra or of the wrong shape
    for ``cfg`` (its blocks, widths and ``d_feat``)."""
    return _carry_checked(tree, _dimenet_shapes(cfg),
                          "dimenet_params_from_jax", cfg.name, device)


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A host copy of ``arr`` as a tensor; numpy's bfloat16 (ml_dtypes',
    which JAX hands over for a bf16 leaf and ``torch.from_numpy`` refuses)
    by its bits."""
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def state_from_jax(state: Dict[str, Any], cfg: Any,
                   device: DeviceLike = None) -> Dict[str, Any]:
    """The port's train state from a numpy copy of the JAX one: for a
    ``TransformerConfig`` or a ``DimeNetConfig`` ``{"params", "opt": {"mu",
    "nu"}, "step"}`` (AdamW layout), for a ``RecSysConfig`` ``{"params",
    "opt": {"acc"}, "step"}`` (Adagrad layout); the optimizer's trees are
    shaped like the params, the step an int."""
    if isinstance(cfg, RecSysConfig):
        carry, slots = recsys_params_from_jax, ("acc",)
    elif isinstance(cfg, DimeNetConfig):
        carry, slots = dimenet_params_from_jax, ("mu", "nu")
    else:
        carry, slots = params_from_jax, ("mu", "nu")
    return {
        "params": carry(state["params"], cfg, device),
        "opt": {k: carry(state["opt"][k], cfg, device) for k in slots},
        "step": int(np.asarray(state["step"])),
    }
