"""Attention primitives (``repro/models/attention.py``): RoPE and the
bidirectional attention of the SPLADE encoders.

The JAX package's ``chunked_attention`` walks KV chunks of 512 with an
online softmax. For sequences of one chunk (the serving path's are) that
is exactly the plain softmax written here, with the same roundings: the
scaled query is cast to the key's dtype, scores and the softmax stay in
f32, the probabilities are cast to the value's dtype for the second
product, whose sum is f32. The causal and sliding-window cases wait for
the slice of the causal-LM families.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._common import NEG_INF


def rope_frequencies(d_head: int, theta: float,
                     device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, N, d_head); positions: (B, S) int."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs           # (B, S, d/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def bidirectional_attention(
    q: torch.Tensor,          # (B, Sq, H, dh)
    k: torch.Tensor,          # (B, Sk, KV, dh)
    v: torch.Tensor,          # (B, Sk, KV, dh)
    *,
    kv_mask: torch.Tensor,    # (B, Sk) 1 = valid
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Softmax attention over every valid key; returns (B, Sq, H, dh).

    Masked keys score the finite ``NEG_INF``, so a row whose keys are all
    masked averages them evenly instead of producing NaN, as in the JAX
    package. Grouped-query heads share KV head ``h // (H // KV)``.
    """
    B, Sq, H, dh = q.shape
    group = H // k.shape[2]
    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    qs = (q.float() * dh ** -0.5).to(k.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    s = torch.where(kv_mask.bool()[:, None, None, :], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    row_sum = p.sum(dim=-1).transpose(1, 2)[..., None]      # (B, Sq, H, 1)
    return (acc / row_sum.clamp_min(1e-30)).to(q.dtype)
