"""LSR training objectives (``repro/losses/contrastive.py``): InfoNCE
over in-batch negatives plus the SPLADE sparsity regularizers.

Scores are f32 products of the reps, as the JAX package's
``preferred_element_type=f32``. ``gathered_infonce`` is InfoNCE over a
batch split across the batch axes of a ``launch.mesh.Mesh``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def infonce_loss(q_reps: torch.Tensor, d_reps: torch.Tensor, *,
                 temperature: float = 1.0) -> torch.Tensor:
    """In-batch-negatives InfoNCE: the positive of query i is doc i
    (``d_reps`` may hold more docs than queries: the negatives)."""
    scores = (q_reps.float() @ d_reps.float().T) / temperature
    logp = F.log_softmax(scores, dim=-1)
    return -logp.diagonal().mean()


def gathered_infonce(q_reps: torch.Tensor, d_reps: torch.Tensor, *,
                     axis_names: Tuple[str, ...] = (),
                     temperature: float = 1.0,
                     mesh=None) -> torch.Tensor:
    """InfoNCE with the negatives gathered across ``axis_names`` of
    ``mesh``: each rank holds its ``B_local`` rows of queries and docs;
    the docs are gathered (row-major over the axes), the positive of
    query i sits at its global row, and the per-rank means are averaged,
    so every rank holds ``infonce_loss`` of the whole batch. With no axes
    it is ``infonce_loss``."""
    if not axis_names:
        return infonce_loss(q_reps, d_reps, temperature=temperature)
    from repro_torch.collectives import all_gather, pmean
    from repro_torch.launch.mesh import axis_index

    bq = q_reps.shape[0]
    d_full = all_gather(d_reps, axis_names, mesh)
    scores = (q_reps.float() @ d_full.float().T) / temperature
    rows = torch.arange(bq, device=q_reps.device)
    labels = axis_index(mesh, axis_names) * bq + rows
    local = -F.log_softmax(scores, dim=-1)[rows, labels].mean()
    return pmean(local, axis_names, mesh)


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
