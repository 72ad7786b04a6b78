"""The Sparton LM head ladder in plain PyTorch (``repro/core/lm_head.py``).

Eq. 1 of the paper, ``Y = max_s [log(1 + ReLU(H Eᵀ + b)) · M']``, in the
flavours of the paper's experiments, forward only in this slice:

* ``lm_head_naive``   — Alg. 1: materializes the ``(B, S, V)`` logits,
  applies f and the multiplicative mask, then the max over S.
* ``lm_head_tiled``   — Alg. 2 forward: the running max over vocabulary
  tiles, masked positions at ``NEG_INF`` before the max.
* ``lm_head_sparton`` — the same forward; what sets it apart in the JAX
  package is its Alg. 3 backward, which arrives with the training slice,
  so a call that needs a gradient raises.

The kernel-backed head is ``repro_torch.kernels.ops.sparton_head``. The
masking argument of the JAX module holds here too: ``f`` is monotone
with ``f(0) = 0``, so excluding masked positions before the max equals
Eq. 1's multiplicative mask.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ops import refuse_grad, with_defaults
from repro_torch.kernels.sparton import sparton_forward_plain


def lm_head_naive(
    H: torch.Tensor,
    E: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    *,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Alg. 1 written as Eq. 1 verbatim: (B, S, V) logits, f, mask, max."""
    logits = torch.einsum("bsd,vd->bsv", H.float(), E.float())
    if b is not None:
        logits = logits + b
    if logit_softcap is not None:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    acts = torch.log1p(torch.relu(logits))
    if mask is not None:
        acts = acts * mask.to(acts.dtype)[..., None]
    return acts.amax(dim=1).to(H.dtype)


def lm_head_tiled(
    H: torch.Tensor,
    E: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    *,
    vocab_tile: int = 4096,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Vocabulary-tiled forward (peak O(B·S·tile)); autograd backward."""
    b, mask = with_defaults(H, E, b, mask)
    y, _ = sparton_forward_plain(H, E, b, mask, logit_softcap,
                                 vocab_tile=vocab_tile)
    return y.to(H.dtype)


def lm_head_sparton(
    H: torch.Tensor,
    E: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    *,
    vocab_tile: int = 4096,
    logit_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Sparton head forward (Alg. 2); its Alg. 3 backward comes later."""
    refuse_grad("lm_head_sparton", H, E, b)
    return lm_head_tiled(H, E, b, mask, vocab_tile=vocab_tile,
                         logit_softcap=logit_softcap)
