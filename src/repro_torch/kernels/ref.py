"""Plain PyTorch oracle for the Sparton forward (``repro/kernels/ref.py``).

Deliberately naive: it materializes the whole ``(B, S, V)`` f32 logit
tensor. It is the ground truth the tiled and kernel versions are held
against, at small shapes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._common import NEG_INF


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
