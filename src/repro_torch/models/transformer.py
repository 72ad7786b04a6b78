"""The dense transformer trunk of the SPLADE encoders
(``repro/models/transformer.py``).

Parameters are a plain dict of tensors in the JAX package's layout:
every layer leaf is stacked with a leading ``n_layers`` axis, and weights
are stored for ``x @ W``. So ``weights.params_from_jax`` is a copy, and
both packages compute the same function on the same numbers. The layer
loop is a Python loop (eager PyTorch needs no scan); with ``cfg.remat``
and autograd on, each layer runs under ``torch.utils.checkpoint``
(recomputed in the backward, as the JAX scan's ``jax.checkpoint``).

Training runs from the f32 master params: every call casts the weights
to the compute dtype inside autograd, so the gradients reach the
masters (a tied ``E`` adds to the embedding gather's). The cast-once
copy of ``compute_weights`` is for serving only. MoE trunks, the causal
LM head and ``decode_step`` wait for the slice of those families.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import TransformerConfig
from repro_torch.device import dtype_of
from repro_torch.models.attention import apply_rope, bidirectional_attention

Params = Dict[str, Any]


def _dense_only(cfg: TransformerConfig) -> None:
    if cfg.is_moe or cfg.sliding_window or not cfg.bidirectional_encoder:
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense bidirectional encoder "
            "only; MoE, sliding-window and causal trunks arrive with the "
            "slice of those model families")


def init_params(generator: torch.Generator,
                cfg: TransformerConfig) -> Params:
    """Random weights (normal, scaled by fan-in) on the generator's
    device, in the JAX package's layout. The numbers differ from
    ``jax.random``'s: tests carry weights across with
    ``weights.params_from_jax`` instead."""
    _dense_only(cfg)
    dtype = dtype_of(cfg.param_dtype)
    dev = generator.device
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    H, KV, dh, Fd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=dtype) * scale

    sc_d, sc_a, sc_f = D ** -0.5, (H * dh) ** -0.5, Fd ** -0.5
    params: Params = {
        "embed": normal((V, D), sc_d),
        "layers": {
            "attn": {
                "wq": normal((L, D, H * dh), sc_d),
                "wk": normal((L, D, KV * dh), sc_d),
                "wv": normal((L, D, KV * dh), sc_d),
                "wo": normal((L, H * dh, D), sc_a),
            },
            "mlp": {
                "w_gate": normal((L, D, Fd), sc_d),
                "w_up": normal((L, D, Fd), sc_d),
                "w_down": normal((L, Fd, D), sc_f),
            },
            "ln1": torch.ones((L, D), dtype=dtype, device=dev),
            "ln2": torch.ones((L, D), dtype=dtype, device=dev),
        },
        "final_norm": torch.ones((D,), dtype=dtype, device=dev),
        "lm_head": {"b": torch.zeros((V,), dtype=torch.float32,
                                     device=dev)},
    }
    if not cfg.tie_embeddings:
        params["lm_head"]["E"] = normal((V, D), sc_d)
    return params


def head_weights(params: Params, cfg: TransformerConfig):
    E = params["embed"] if cfg.tie_embeddings else params["lm_head"]["E"]
    return E, params["lm_head"]["b"]


def compute_weights(params: Params, cfg: TransformerConfig) -> Params:
    """``params`` with the embedding, the head's ``E`` and every layer's
    projections in the compute dtype, so that ``forward_hidden`` and the
    head cast nothing per call. Norm scales and the head bias keep their
    dtype; the numbers are those of a cast at each call. Serving only: a
    copy made once goes stale at the first update and would cut the
    gradient off from the f32 masters."""
    cdtype = dtype_of(cfg.compute_dtype)
    layers = params["layers"]
    out: Params = {
        "embed": params["embed"].to(cdtype),
        "layers": {
            "attn": {n: w.to(cdtype) for n, w in layers["attn"].items()},
            "mlp": {n: w.to(cdtype) for n, w in layers["mlp"].items()},
            "ln1": layers["ln1"], "ln2": layers["ln2"]},
        "final_norm": params["final_norm"],
        "lm_head": {"b": params["lm_head"]["b"]},
    }
    if not cfg.tie_embeddings:
        out["lm_head"]["E"] = params["lm_head"]["E"].to(cdtype)
    return out


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale).to(x.dtype)


def _layer(x: torch.Tensor, lp: Params, i: int, cfg: TransformerConfig, *,
           positions: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Layer ``i`` of the stacked params ``lp`` on ``x`` (B, S, D)."""
    B, S, _ = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    cdtype = x.dtype
    attn, mlp = lp["attn"], lp["mlp"]

    h = rms_norm(x, lp["ln1"][i], cfg.norm_eps)
    q = (h @ attn["wq"][i].to(cdtype)).reshape(B, S, H, dh)
    k = (h @ attn["wk"][i].to(cdtype)).reshape(B, S, KV, dh)
    v = (h @ attn["wv"][i].to(cdtype)).reshape(B, S, KV, dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = bidirectional_attention(q, k, v, kv_mask=mask,
                                  logit_softcap=cfg.attn_logit_softcap)
    x = x + out.reshape(B, S, H * dh) @ attn["wo"][i].to(cdtype)

    h = rms_norm(x, lp["ln2"][i], cfg.norm_eps)
    g = h @ mlp["w_gate"][i].to(cdtype)
    u = h @ mlp["w_up"][i].to(cdtype)
    return x + (F.silu(g) * u) @ mlp["w_down"][i].to(cdtype)


def forward_hidden(params: Params, cfg: TransformerConfig,
                   tokens: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Final hidden states ``H`` (B, S, D) in the compute dtype. (The JAX
    function also returns the MoE aux loss, always 0 for a dense trunk.)"""
    _dense_only(cfg)
    B, S = tokens.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.int32, device=tokens.device)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = params["embed"][tokens.long()].to(dtype_of(cfg.compute_dtype))
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        if remat:
            x = checkpoint(_layer, x, params["layers"], i, cfg,
                           positions=positions, mask=mask,
                           use_reentrant=False)
        else:
            x = _layer(x, params["layers"], i, cfg, positions=positions,
                       mask=mask)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def lsr_encode(params: Params, cfg: TransformerConfig, tokens: torch.Tensor,
               mask: torch.Tensor, *,
               head_impl: Optional[str] = None) -> torch.Tensor:
    """SPLADE-style encoding: trunk + Sparton head (Eq. 1), ``(B, V)``."""
    from repro_torch.core.head_api import make_head

    spec = cfg.head_spec() if head_impl is None \
        else cfg.head_spec(impl=head_impl)
    Hs = forward_hidden(params, cfg, tokens, mask)
    E, b = head_weights(params, cfg)
    return make_head(spec)(Hs, E.to(Hs.dtype), b, mask)
