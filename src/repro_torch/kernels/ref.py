"""Plain PyTorch oracles (``repro/kernels/ref.py``).

Deliberately naive: the head's oracles materialize the whole
``(B, S, V)`` f32 logit tensor and the one-hot routing, the scorer's the
whole ``(B, N)`` score matrix. They are the ground truth the tiled and
kernel versions are held against, at small shapes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels._common import NEG_INF, bwd_factor


def sparton_forward_ref(
    H: torch.Tensor,
    E: torch.Tensor,
    b: Optional[torch.Tensor],
    mask: Optional[torch.Tensor],
    softcap: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle for ``kernels.sparton.sparton_forward``: (y, i_max)."""
    logits = torch.einsum("bsd,vd->bsv", H.float(), E.float())
    if b is not None:
        logits = logits + b.float()
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    if mask is not None:
        logits = torch.where(mask.bool()[:, :, None], logits, NEG_INF)
    raw_max, i_max = logits.max(dim=1)
    return torch.log1p(raw_max.clamp_min(0.0)), i_max.int()


def sparton_backward_ref(
    g: torch.Tensor,       # (B, V), the f' factor already applied
    i_max: torch.Tensor,   # (B, V)
    H: torch.Tensor,       # (B, S, D)
    E: torch.Tensor,       # (V, D)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle for the backward's contractions: ``(dH, dE)`` in f32."""
    w = F.one_hot(i_max.long(), H.shape[1]).float() * g.float()[..., None]
    dH = torch.einsum("bvs,vd->bsd", w, E.float())
    dE = torch.einsum("bvs,bsd->vd", w, H.float())
    return dH, dE


def sparton_backward_fused_ref(
    dy: torch.Tensor,      # (B, V) raw upstream cotangent
    y: torch.Tensor,       # (B, V) stored post-activation
    i_max: torch.Tensor,   # (B, V)
    H: torch.Tensor,       # (B, S, D)
    E: torch.Tensor,       # (V, D)
    softcap: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Oracle for the fused backward: ``(dH, dE, db)`` from ``(dy, y)``."""
    g = bwd_factor(y.float(), dy, softcap)
    dH, dE = sparton_backward_ref(g, i_max, H, E)
    return dH, dE, g.sum(dim=0)


def topk_score_ref(
    q: torch.Tensor,       # (D,) or (B, D)
    C: torch.Tensor,       # (N, D) candidate matrix
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle for ``kernels.topk_score``: the f32 scores and the indices of
    the top ``k <= N`` by dot, ties to the lowest id."""
    q2 = q if q.dim() == 2 else q[None]
    scores = torch.einsum("bd,nd->bn", q2.float(), C.float())
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k].int()
    if q.dim() == 1:
        return vals[0], idx[0]
    return vals, idx
