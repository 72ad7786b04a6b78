"""The transformer trunks (``repro/models/transformer.py``): the
bidirectional SPLADE encoders, the dense causal decoders (llama3.2-3b,
phi3-mini; gemma2-27b with its sliding window on the even layers and its
logit softcaps) and the MoE decoders (moonshot-v1-16b-a3b, phi3.5-moe),
whose FFN is ``models.moe.moe_ffn`` on the layer's flattened tokens.

Parameters are a plain dict of tensors in the JAX package's layout:
every layer leaf is stacked with a leading ``n_layers`` axis, and weights
are stored for ``x @ W``. So ``weights.params_from_jax`` is a copy, and
both packages compute the same function on the same numbers. The layer
loop is a Python loop (eager PyTorch needs no scan); with ``cfg.remat``
and autograd on, each layer runs under ``torch.utils.checkpoint``
(recomputed in the backward, as the JAX scan's ``jax.checkpoint``).

Training runs from the master params (f32 in the SMOKE configs, bf16
in the decoders' published CONFIGs, as the JAX package's): every call
casts the weights to the compute dtype inside autograd, so the gradients
reach the masters (a tied ``E`` adds to the embedding gather's). The
cast-once copy of ``compute_weights`` is for serving only.

Heads: ``lsr_encode`` (the trunk and the Sparton head, Eq. 1) and
``causal_lm_logits`` / ``decode_step`` (next-token logits, a plain
matmul as in the JAX package, which computes them outside any Pallas
kernel). ``decode_step`` writes each layer's key and value into one
stacked cache in place. An MoE layer's load-balance loss is summed over
the layers by ``forward_hidden(..., return_aux=True)``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import TransformerConfig
from repro_torch.device import dtype_of
from repro_torch.models.attention import (apply_rope, chunked_attention,
                                          decode_attention)
from repro_torch.models.moe import init_moe_params, moe_ffn

Params = Dict[str, Any]


def layer_window(cfg: TransformerConfig, i: int) -> Optional[int]:
    """Layer ``i``'s attention window: with ``local_global_alternating``
    the even layers are local (``sliding_window``) and the odd global."""
    if cfg.local_global_alternating and cfg.sliding_window:
        return cfg.sliding_window if i % 2 == 0 else None
    return cfg.sliding_window


def init_params(generator: torch.Generator,
                cfg: TransformerConfig, device=None) -> Params:
    """Random weights (normal, scaled by fan-in) on ``device`` (default the
    generator's), in the JAX package's layout; ``device="meta"`` with a
    CPU generator gives the shapes alone (the dry run's state). The
    numbers differ from ``jax.random``'s: tests carry weights across with
    ``weights.params_from_jax`` instead."""
    dtype = dtype_of(cfg.param_dtype)
    dev = generator.device if device is None else device
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    H, KV, dh, Fd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=dev,
                           dtype=dtype).mul_(scale)

    sc_d, sc_a, sc_f = D ** -0.5, (H * dh) ** -0.5, Fd ** -0.5
    # drawn in this order: the embedding, attention, then the FFN
    embed = normal((V, D), sc_d)
    attn = {"wq": normal((L, D, H * dh), sc_d),
            "wk": normal((L, D, KV * dh), sc_d),
            "wv": normal((L, D, KV * dh), sc_d),
            "wo": normal((L, H * dh, D), sc_a)}
    if cfg.is_moe:
        mlp = init_moe_params(generator, L, D, Fd, cfg.n_experts, dtype,
                              dev)
    else:
        mlp = {"w_gate": normal((L, D, Fd), sc_d),
               "w_up": normal((L, D, Fd), sc_d),
               "w_down": normal((L, Fd, D), sc_f)}
    params: Params = {
        "embed": embed,
        "layers": {
            "attn": attn,
            "mlp": mlp,
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
    projections (an MoE layer's experts) in the compute dtype, so that
    ``forward_hidden`` and the head cast nothing per call. Norm scales,
    the head bias and an MoE ``router`` (which ``moe_ffn`` up-casts to f32
    at each call) keep their dtype; the numbers are those of a cast at
    each call. Serving only: a copy made once goes stale at the first
    update and would cut the gradient off from the f32 masters."""
    cdtype = dtype_of(cfg.compute_dtype)
    layers = params["layers"]
    out: Params = {
        "embed": params["embed"].to(cdtype),
        "layers": {
            "attn": {n: w.to(cdtype) for n, w in layers["attn"].items()},
            "mlp": {n: w if n == "router" else w.to(cdtype)
                    for n, w in layers["mlp"].items()},
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
           positions: torch.Tensor, mask: torch.Tensor, causal: bool
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Layer ``i`` of the stacked params ``lp`` on ``x`` (B, S, D);
    ``positions`` (S,). Returns the new ``x`` and the MoE aux loss (None
    for a dense layer)."""
    B, S, _ = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    cdtype = x.dtype
    attn = lp["attn"]

    h = rms_norm(x, lp["ln1"][i], cfg.norm_eps)
    q = (h @ attn["wq"][i].to(cdtype)).reshape(B, S, H, dh)
    k = (h @ attn["wk"][i].to(cdtype)).reshape(B, S, KV, dh)
    v = (h @ attn["wv"][i].to(cdtype)).reshape(B, S, KV, dh)
    pos2d = positions.expand(B, S)
    q = apply_rope(q, pos2d, cfg.rope_theta)
    k = apply_rope(k, pos2d, cfg.rope_theta)
    out = chunked_attention(
        q, k, v, q_positions=positions, k_positions=positions, kv_mask=mask,
        causal=causal, window=layer_window(cfg, i),
        logit_softcap=cfg.attn_logit_softcap, chunk_size=cfg.attn_chunk)
    x = x + out.reshape(B, S, H * dh) @ attn["wo"][i].to(cdtype)
    y, aux = _mlp(x, lp, i, cfg)
    return x + y, aux


def _mlp(x: torch.Tensor, lp: Params, i: int, cfg: TransformerConfig
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Layer ``i``'s FFN on ``x`` (..., D) after its norm: SwiGLU, or
    ``moe_ffn`` on the flattened tokens with its aux loss (else None)."""
    cdtype = x.dtype
    mlp = lp["mlp"]
    h = rms_norm(x, lp["ln2"][i], cfg.norm_eps)
    if cfg.is_moe:
        out, aux = moe_ffn(
            h.reshape(-1, h.shape[-1]), mlp["router"][i], mlp["w_gate"][i],
            mlp["w_up"][i], mlp["w_down"][i], top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor)
        return out.reshape(h.shape), aux
    g = h @ mlp["w_gate"][i].to(cdtype)
    u = h @ mlp["w_up"][i].to(cdtype)
    return (F.silu(g) * u) @ mlp["w_down"][i].to(cdtype), None


def forward_hidden(params: Params, cfg: TransformerConfig,
                   tokens: torch.Tensor,
                   mask: Optional[torch.Tensor] = None, *,
                   causal: Optional[bool] = None, return_aux: bool = False):
    """Final hidden states ``H`` (B, S, D) in the compute dtype, causal
    unless the config is a bidirectional encoder (or ``causal`` says
    otherwise). With ``return_aux`` it returns ``(H, aux)`` as the JAX
    function does: the MoE load-balance loss summed over the layers, an
    f32 scalar (0 for a dense trunk). Padded positions are routed and take
    expert capacity, as in the reference, whose FFN never sees the
    mask."""
    B, S = tokens.shape
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.int32, device=tokens.device)
    if causal is None:
        causal = not cfg.bidirectional_encoder
    positions = torch.arange(S, device=tokens.device)
    x = params["embed"][tokens.long()].to(dtype_of(cfg.compute_dtype))
    remat = cfg.remat and torch.is_grad_enabled()
    aux = None
    for i in range(cfg.n_layers):
        if remat:
            x, layer_aux = checkpoint(
                _layer, x, params["layers"], i, cfg, positions=positions,
                mask=mask, causal=causal, use_reentrant=False)
        else:
            x, layer_aux = _layer(x, params["layers"], i, cfg,
                                  positions=positions, mask=mask,
                                  causal=causal)
        if layer_aux is not None:
            aux = layer_aux if aux is None else aux + layer_aux
    H = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if not return_aux:
        return H
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    return H, aux


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


def _next_token_logits(x: torch.Tensor, params: Params,
                       cfg: TransformerConfig) -> torch.Tensor:
    """The LM head on hidden states ``x`` (..., D): ``x @ E^T + b`` (the
    product in the compute dtype, the sum with the f32 bias in f32), then
    the final softcap."""
    E, b = head_weights(params, cfg)
    logits = torch.matmul(x, E.to(x.dtype).t()) + b
    if cfg.final_logit_softcap is not None:
        cap = cfg.final_logit_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits


def causal_lm_logits(params: Params, cfg: TransformerConfig,
                     tokens: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, S, V) next-token logits of the causal trunk, softcap applied.
    (The JAX function also returns the MoE aux loss:
    ``forward_hidden(..., return_aux=True)`` gives it.)"""
    return _next_token_logits(
        forward_hidden(params, cfg, tokens, mask, causal=True), params, cfg)


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int,
                  dtype: Optional[torch.dtype] = None,
                  device=None) -> Dict[str, torch.Tensor]:
    """Zeroed ``{"k", "v"}``, each (L, B, max_len, KV, d_head) in the
    compute dtype unless ``dtype`` is given, on ``device`` (``cuda``
    unless the caller passes the CPU)."""
    from repro_torch.device import resolve_device

    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    kw = {"dtype": dtype or dtype_of(cfg.compute_dtype),
          "device": resolve_device(device)}
    return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw)}


def decode_step(params: Params, cfg: TransformerConfig,
                cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One autoregressive step: ``tokens`` (B, 1), the newest token of
    each row, at ``positions`` (B,). Returns ``((B, V) logits, cache)``.

    Each layer writes its key and value at ``positions`` into the stacked
    ``cache`` in place (one ``index_put_`` on the (L, B, S_max, KV, dh)
    tensor, never a copy of it), then attends over the cache with the
    layer's window. An MoE layer runs ``moe_ffn`` on the B rows, so its
    capacity is that of a B-token call. The returned cache is the one
    given, updated; the JAX function returns an updated copy.
    """
    B = tokens.shape[0]
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    cdtype = dtype_of(cfg.compute_dtype)
    layers = params["layers"]
    attn = layers["attn"]
    x = params["embed"][tokens[:, 0].long()].to(cdtype)[:, None, :]
    k_all, v_all = cache["k"], cache["v"]
    rows = torch.arange(B, device=tokens.device)
    pos = positions.long()
    for i in range(cfg.n_layers):
        h = rms_norm(x, layers["ln1"][i], cfg.norm_eps)
        q = (h @ attn["wq"][i].to(cdtype)).reshape(B, 1, H, dh)
        k = (h @ attn["wk"][i].to(cdtype)).reshape(B, 1, KV, dh)
        v = (h @ attn["wv"][i].to(cdtype)).reshape(B, 1, KV, dh)
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k = apply_rope(k, pos[:, None], cfg.rope_theta)
        k_all[i].index_put_((rows, pos), k[:, 0].to(k_all.dtype))
        v_all[i].index_put_((rows, pos), v[:, 0].to(v_all.dtype))
        out = decode_attention(q, k_all[i], v_all[i], positions=pos,
                               window=layer_window(cfg, i),
                               logit_softcap=cfg.attn_logit_softcap)
        x = x + out.reshape(B, 1, H * dh) @ attn["wo"][i].to(cdtype)
        x = x + _mlp(x, layers, i, cfg)[0]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _next_token_logits(x[:, 0], params, cfg), cache
