"""Constants and helpers shared by the port's kernels and their plain
versions (the port's copy of ``repro/kernels/_common.py``)."""

from __future__ import annotations

from typing import Optional

import torch

# Finite stand-in for -inf (as in the JAX package): keeps the streaming
# max/argmax and the running top-k well defined, and lets masked or
# padded entries lose every comparison. f32 only: it does not fit in fp16.
NEG_INF = -1e30


def bwd_factor(y: torch.Tensor, dy: torch.Tensor,
               softcap: Optional[float]) -> torch.Tensor:
    """``g = dY/d(raw max logit)`` from the stored post-activation ``y``.

    ``f(x) = log1p(relu(c(x)))`` with ``c`` the softcap or the identity.
    ``exp(y) = 1 + relu(c(m))`` at the max ``m``, and ``y > 0`` exactly
    where ``m > 0`` (the softcap keeps the sign), so
    ``df/dc = exp(-y)`` there and 0 elsewhere, and
    ``dc/dm = 1 - (c / cap)^2`` with ``c = expm1(y)``. f32, elementwise;
    K2 and K3 compute it in their epilogue in the same order.
    """
    g = dy.float() * torch.exp(-y)
    if softcap is not None:
        c = torch.expm1(y)
        g = g * (1.0 - (c / softcap) ** 2)
    return torch.where(y > 0, g, 0.0)
