"""The Sparton LM head ladder in plain PyTorch (``repro/core/lm_head.py``).

Eq. 1 of the paper, ``Y = max_s [log(1 + ReLU(H Eᵀ + b)) · M']``, in the
flavours of the paper's experiments:

* ``lm_head_naive``   — Alg. 1: materializes the ``(B, S, V)`` logits,
  applies f and the multiplicative mask, then the max over S; autograd
  backward.
* ``lm_head_tiled``   — Alg. 2 forward: the running max over vocabulary
  tiles, masked positions at ``NEG_INF`` before the max; autograd
  backward (which keeps every tile's logits).
* ``lm_head_sparton`` — the same forward, saving only ``(y, i_max)``
  beyond the inputs, with the Alg. 3 backward: per chunk of
  ``bwd_batch_chunk`` batch rows, a scatter of ``g * E`` into ``dH`` and
  a gather of ``H[b, i_max]`` for ``dE`` (the plain versions of K2 and
  K3).

``sparton_forward_with_indices`` is the inference forward that also
returns the argmax positions (K1 on the card). ``lm_head(..., impl=)``
dispatches through the head API's registry (``core/head_api``), so
``impl="kernel"`` reaches the kernel-backed head,
``repro_torch.kernels.ops.sparton_head``; ``IMPLEMENTATIONS`` is the
JAX package's table of the plain rungs. The masking argument of the JAX
module holds here too: ``f`` is monotone with ``f(0) = 0``, so excluding
masked positions before the max equals Eq. 1's multiplicative mask.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.ops import with_defaults
from repro_torch.kernels.sparton import (sparton_forward,
                                         sparton_forward_plain)
from repro_torch.kernels.sparton_bwd import (sparton_backward_de_plain,
                                             sparton_backward_dh_plain)


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


class _SpartonCore(torch.autograd.Function):
    """Alg. 2 forward and Alg. 3 backward in plain PyTorch."""

    @staticmethod
    def forward(ctx, H, E, b, mask, vocab_tile, softcap, bwd_batch_chunk):
        y, i_max = sparton_forward_plain(H, E, b, mask, softcap,
                                         vocab_tile=vocab_tile)
        ctx.save_for_backward(H, E, y, i_max)
        ctx.softcap, ctx.chunk = softcap, bwd_batch_chunk
        return y.to(H.dtype)

    @staticmethod
    def backward(ctx, dy):
        H, E, y, i_max = ctx.saved_tensors
        dH = sparton_backward_dh_plain(dy, y, i_max, E, H.shape[1],
                                       ctx.softcap,
                                       bwd_batch_chunk=ctx.chunk)
        dE, db = sparton_backward_de_plain(dy, y, i_max, H, ctx.softcap,
                                           bwd_batch_chunk=ctx.chunk)
        return (dH.to(H.dtype), dE.to(E.dtype), db, None, None, None,
                None)


def lm_head_sparton(
    H: torch.Tensor,
    E: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    *,
    vocab_tile: int = 4096,
    logit_softcap: Optional[float] = None,
    bwd_batch_chunk: int = 8,
) -> torch.Tensor:
    """Sparton LM head (Alg. 2 + 3) in plain PyTorch, differentiable.

    Saves only ``(y, i_max)`` beyond the inputs: O(B·V) backward state
    instead of O(B·S·V).
    """
    b, mask = with_defaults(H, E, b, mask)
    return _SpartonCore.apply(H, E, b, mask, vocab_tile, logit_softcap,
                              bwd_batch_chunk)


def sparton_forward_with_indices(
    H: torch.Tensor,
    E: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    *,
    vocab_tile: int = 4096,
    logit_softcap: Optional[float] = None,
):
    """Inference forward that also returns the argmax positions: ``(y
    (B, V) in H's dtype, i_max (B, V) i32)``, ``i_max[b, v]`` the first
    position whose logit is the max (which token activated each vocab
    dimension). On the card it runs K1 (``kernels/sparton``: H and E
    both f32 or both bf16, contiguous); CPU tensors take its plain
    version over vocab tiles of ``vocab_tile``."""
    b, mask = with_defaults(H, E, b, mask)
    if H.device.type == "cpu":
        y, i_max = sparton_forward_plain(H, E, b, mask, logit_softcap,
                                         vocab_tile=vocab_tile)
    else:
        y, i_max = sparton_forward(H, E, b, mask, softcap=logit_softcap)
    return y.to(H.dtype), i_max


# The JAX package's table of the plain rungs. The registry of every
# backend, ``kernel`` and any registered at run time included, is
# ``repro_torch.core.head_api.available_impls()``.
IMPLEMENTATIONS = {
    "naive": lm_head_naive,
    "tiled": lm_head_tiled,
    "sparton": lm_head_sparton,
}


def lm_head(H, E, b=None, mask=None, *, impl="sparton", softcap=None, **kw):
    """The head by registry name, as the JAX package's ``lm_head`` shim:
    ``impl="kernel"`` (and any backend registered at run time) works too,
    an unknown name lists the registry. Keyword arguments are
    ``HeadSpec`` fields; ``softcap=`` is the deprecated spelling of
    ``logit_softcap``. New code calls ``make_head(HeadSpec(...))``."""
    from repro_torch.core.head_api import (HeadSpec, get_head_impl,
                                           normalize_softcap_kwarg)

    kw["logit_softcap"] = normalize_softcap_kwarg(
        kw.get("logit_softcap"), softcap, "lm_head")
    spec = HeadSpec(impl=impl, **kw)
    fn = get_head_impl(impl)
    b, mask = with_defaults(H, E, b, mask)
    return fn(H, E, b, mask, spec=spec)
