"""The kernel-backed Sparton head (``repro/kernels/ops.py``), forward only.

``sparton_head`` runs K1 on CUDA tensors (its plain version on CPU ones)
and casts ``y`` to ``out_dtype or H.dtype``, as the JAX wrapper does.
The backward (the paper's Alg. 3 over the dH and dE kernels) arrives
with the training slice; until then a call that would need a gradient
raises instead of letting autograd differentiate something else.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.sparton import sparton_forward

def refuse_grad(where: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise if autograd would need a backward through the head."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{where}: inputs require grad, but the Sparton head's "
            "backward (kernels K2/K3 behind a torch.autograd.Function) "
            "arrives with port slice 2, training; call it under "
            "torch.no_grad() for inference")


def with_defaults(H, E, b, mask):
    """Fill an absent bias (zeros, f32) and mask (every position kept)."""
    if b is None:
        b = torch.zeros(E.shape[0], dtype=torch.float32, device=H.device)
    if mask is None:
        mask = torch.ones(H.shape[:2], dtype=torch.int32, device=H.device)
    return b, mask


def sparton_head(
    H: torch.Tensor,
    E: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    *,
    logit_softcap: Optional[float] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Kernel-backed head with optional bias (zeros) and mask (all kept)."""
    refuse_grad("sparton_head", H, E, b)
    b, mask = with_defaults(H, E, b, mask)
    y, _ = sparton_forward(H, E, b, mask, softcap=logit_softcap)
    return y.to(out_dtype or H.dtype)
