"""LSR training objectives (``repro/losses/contrastive.py``): InfoNCE
over in-batch negatives plus the SPLADE sparsity regularizers.

Scores are f32 products of the reps, as the JAX package's
``preferred_element_type=f32``. The mesh-aware ``gathered_infonce``
waits for the multi-GPU slice.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def infonce_loss(q_reps: torch.Tensor, d_reps: torch.Tensor, *,
                 temperature: float = 1.0) -> torch.Tensor:
    """In-batch-negatives InfoNCE: the positive of query i is doc i
    (``d_reps`` may hold more docs than queries: the negatives)."""
    scores = (q_reps.float() @ d_reps.float().T) / temperature
    logp = F.log_softmax(scores, dim=-1)
    return -logp.diagonal().mean()


def infonce_from_scores(scores: torch.Tensor, *,
                        temperature: float = 1.0) -> torch.Tensor:
    """InfoNCE on a precomputed ``(Bq, Bd)`` score matrix (the positive of
    query i is column i)."""
    logp = F.log_softmax(scores / temperature, dim=-1)
    return -logp.diagonal().mean()


def flops_regularizer(reps: torch.Tensor) -> torch.Tensor:
    """SPLADE FLOPS: ``sum_v (mean_b |Y[b, v]|)^2``."""
    mean_act = reps.float().abs().mean(dim=0)
    return (mean_act * mean_act).sum()


def l1_regularizer(reps: torch.Tensor) -> torch.Tensor:
    return reps.float().abs().sum(dim=-1).mean()


def margin_mse_loss(q_reps: torch.Tensor, d_pos: torch.Tensor,
                    d_neg: torch.Tensor,
                    teacher_margin: torch.Tensor) -> torch.Tensor:
    """MarginMSE distillation: match the teacher's score margins."""
    s_pos = torch.einsum("bv,bv->b", q_reps, d_pos)
    s_neg = torch.einsum("bv,bv->b", q_reps, d_neg)
    return ((s_pos - s_neg - teacher_margin) ** 2).mean()


def splade_loss(
    q_reps: torch.Tensor,
    d_reps: torch.Tensor,
    *,
    temperature: float = 1.0,
    lambda_q: float = 5e-4,
    lambda_d: float = 3e-4,
    l1_weight: float = 0.0,
    aux_loss: Optional[torch.Tensor] = None,
    aux_weight: float = 1e-2,
) -> torch.Tensor:
    """The SPLADE objective: InfoNCE + FLOPS(q) + FLOPS(d) (+ L1, + aux)."""
    loss = infonce_loss(q_reps, d_reps, temperature=temperature)
    loss = loss + lambda_q * flops_regularizer(q_reps)
    loss = loss + lambda_d * flops_regularizer(d_reps)
    if l1_weight:
        loss = loss + l1_weight * (l1_regularizer(q_reps)
                                   + l1_regularizer(d_reps))
    if aux_loss is not None:
        loss = loss + aux_weight * aux_loss
    return loss
