"""Carry the JAX package's parameters and train state over to the port.

``params_from_jax`` takes the JAX param pytree of a transformer (dense
or MoE), already converted to numpy arrays by the caller (stacked ``(L, ...)``
layer leaves, weights laid out for ``x @ W``), and returns the port's
params: the same tree of tensors on ``device``. ``state_from_jax`` does
the same for a whole train state (params, the AdamW moments, the step).
With them both packages compute the same function and take the same
steps, which is how the tests compare them. This module imports no JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import TransformerConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tree import tree_items


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
        node[leaf] = torch.from_numpy(np.array(arr)).to(dev)
    return out


def state_from_jax(state: Dict[str, Any], cfg: TransformerConfig,
                   device: DeviceLike = None) -> Dict[str, Any]:
    """The port's train state from a numpy copy of the JAX one
    (``{"params", "opt": {"mu", "nu"}, "step"}``, AdamW layout): the
    moments are trees shaped like the params, the step an int."""
    return {
        "params": params_from_jax(state["params"], cfg, device),
        "opt": {k: params_from_jax(state["opt"][k], cfg, device)
                for k in ("mu", "nu")},
        "step": int(np.asarray(state["step"])),
    }
