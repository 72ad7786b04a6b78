"""Attention primitives (``repro/models/attention.py``): RoPE, the
chunked online-softmax attention of every trunk, and the one-token
attention of KV-cache decode.

``chunked_attention`` walks the keys in chunks of ``chunk_size`` (the
config's ``attn_chunk``) in the JAX package's order, with its roundings:
the scaled query is cast to the key's dtype, scores, the running max, the
running sum and the accumulator stay in f32, the probabilities are cast
to the value's dtype for the second product, whose sum is f32. The
recurrence starts from the first chunk's own max and sums (the JAX
initial state gives the same numbers), so one chunk is the plain
softmax. Keys are
padded to whole chunks (position -1, mask 0). Causal and sliding-window
masks come from position comparisons per chunk, never an ``(S, S)``
tensor. The JAX function scores every query against a chunk at once; here
the queries are taken in blocks, so that the scores of a block against
one chunk stay within ``SCORE_BYTES``. Each query row sees the same
chunk updates in the same order, so the numbers are the same. Operands
in bf16 are up-cast one chunk at a time for f32 products (exact: bf16
products fit in f32; the sums are f32 on the card while TF32 is off).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels._common import NEG_INF

# f32 scores of one query block against one key chunk: every encoder
# shape the port runs (up to Table-1's 320 x 512 x 12 heads, 3.8 GiB)
# stays one block, as its one-chunk softmax was; the decoders' long
# sequences take several
SCORE_BYTES = 4 * 2**30
# cache positions up-cast to f32 at a time in decode: never the whole cache
DECODE_CHUNK = 4096


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


def _chunk_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                kv_valid: torch.Tensor, causal: bool,
                window: Optional[int]) -> torch.Tensor:
    """(B, Sq, C) keep-mask of one key chunk: a key is kept when valid,
    not after the query (``causal``) and less than ``window`` before it."""
    m = kv_valid[:, None, :]
    rel = q_pos[None, :, None] - k_pos[None, None, :]
    if causal:
        m = m & (rel >= 0)
    if window is not None:
        m = m & (rel < window)
    return m


def chunked_attention(
    q: torch.Tensor,            # (B, Sq, H, dh)
    k: torch.Tensor,            # (B, Sk, KV, dh)
    v: torch.Tensor,            # (B, Sk, KV, dh)
    *,
    q_positions: torch.Tensor,  # (Sq,)
    k_positions: torch.Tensor,  # (Sk,)
    kv_mask: torch.Tensor,      # (B, Sk) 1 = valid
    causal: bool,
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
    chunk_size: int = 512,
) -> torch.Tensor:
    """Online-softmax attention over key chunks; returns (B, Sq, H, dh).

    Masked keys score the finite ``NEG_INF``: a row whose keys so far are
    all masked averages them evenly, and the first chunk with a kept key
    scales that away exactly (``exp(NEG_INF - max)`` is 0), as in the
    JAX package. Grouped-query head ``h`` reads KV head ``h // (H //
    KV)``. The queries are scored in blocks of as many as ``SCORE_BYTES``
    of scores hold.
    """
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    chunk_size = min(chunk_size, max(Sk, 1))   # no padding blow-up at small S
    pad = (-Sk) % chunk_size
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_mask = F.pad(kv_mask, (0, pad))
        k_positions = F.pad(k_positions, (0, pad), value=-1)
    q_block = max(1, SCORE_BYTES // (4 * B * H * chunk_size))
    valid = kv_mask != 0
    qs = (q.float() * dh ** -0.5).to(k.dtype)
    outs = []
    for q0 in range(0, Sq, q_block):
        qb = qs[:, q0:q0 + q_block].float()                 # (B, n, H, dh)
        for lo in range(0, k.shape[1], chunk_size):
            hi = lo + chunk_size
            kc, vc = k[:, lo:hi], v[:, lo:hi]
            if G > 1:    # grouped-query head h reads KV head h // G
                kc = kc.repeat_interleave(G, dim=2)
                vc = vc.repeat_interleave(G, dim=2)
            s = torch.einsum("bqhd,bkhd->bhqk", qb, kc.float())
            if logit_softcap is not None:
                s = logit_softcap * torch.tanh(s / logit_softcap)
            keep = _chunk_mask(q_positions[q0:q0 + q_block],
                               k_positions[lo:hi], valid[:, lo:hi], causal,
                               window)
            s = torch.where(keep[:, None], s, NEG_INF)
            if lo == 0:
                # the JAX recurrence from its initial state (max NEG_INF,
                # sums 0): the first chunk's max is at least NEG_INF, and
                # its alpha scales zeros, so these are its numbers
                row_max = s.amax(dim=-1)                       # (B, H, n)
                p = torch.exp(s - row_max[..., None])
                acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                                   vc.float())
                row_sum = p.sum(dim=-1).transpose(1, 2)         # (B, n, H)
                continue
            new_max = torch.maximum(row_max, s.amax(dim=-1))
            alpha = torch.exp(row_max - new_max)
            p = torch.exp(s - new_max[..., None])
            acc = acc * alpha.transpose(1, 2)[..., None] + torch.einsum(
                "bhqk,bkhd->bqhd", p.to(v.dtype).float(), vc.float())
            row_sum = (row_sum * alpha.transpose(1, 2)
                       + p.sum(dim=-1).transpose(1, 2))
            row_max = new_max
        outs.append(acc / row_sum.clamp_min(1e-30)[..., None])
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.to(q.dtype)


def decode_attention(
    q: torch.Tensor,            # (B, 1, H, dh)
    k_cache: torch.Tensor,      # (B, S_max, KV, dh)
    v_cache: torch.Tensor,      # (B, S_max, KV, dh)
    *,
    positions: torch.Tensor,    # (B,) current write position
    window: Optional[int] = None,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """One query token against its cache; returns (B, 1, H, dh).

    A key is kept when its position is at most the query's and, with a
    ``window``, less than ``window`` before it. The scores are (B, H,
    S_max) f32: linear in the cache. The cache keeps its dtype; only
    ``DECODE_CHUNK`` positions of it are up-cast at a time for the f32
    products (the JAX function never up-casts the cache either).
    """
    B, _, H, dh = q.shape
    S_max, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qf = (q.float() * dh ** -0.5).to(k_cache.dtype).float()
    qf = qf.reshape(B, KV, G, dh)
    s = torch.empty((B, KV, G, S_max), dtype=torch.float32, device=q.device)
    for lo in range(0, S_max, DECODE_CHUNK):
        s[..., lo:lo + DECODE_CHUNK] = torch.einsum(
            "bkgd,bckd->bkgc", qf, k_cache[:, lo:lo + DECODE_CHUNK].float())
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    k_pos = torch.arange(S_max, device=q.device)
    rel = positions[:, None].long() - k_pos[None, :]
    keep = rel >= 0
    if window is not None:
        keep = keep & (rel < window)
    s = torch.where(keep[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.zeros((B, KV, G, dh), dtype=torch.float32, device=q.device)
    for lo in range(0, S_max, DECODE_CHUNK):
        out += torch.einsum("bkgc,bckd->bkgd",
                            p[..., lo:lo + DECODE_CHUNK].float(),
                            v_cache[:, lo:lo + DECODE_CHUNK].float())
    return out.reshape(B, 1, H, dh).to(q.dtype)
