"""The kernel-backed, differentiable Sparton head (``repro/kernels/ops.py``).

``sparton_head`` is a ``torch.autograd.Function``: its forward runs K1
(``kernels/sparton.py``) and saves only ``(H, E, y, i_max)`` — never the
``(B, S, V)`` logits; its backward casts ``dy`` to f32 and runs K2 and
K3 (``kernels/sparton_bwd.py``), which compute ``g = dy * f'(y)`` and
``db = sum_b g`` inside the kernels. Gradients come back in the inputs'
dtypes (``db`` in f32), as in the JAX wrapper's ``_bwd``. CPU tensors
take each kernel's plain version. ``sparton_lm_head_kernel`` is the JAX
package's name and positional signature for the same head (its
``jax.custom_vjp``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels.sparton import sparton_forward
from repro_torch.kernels.sparton_bwd import sparton_backward


def with_defaults(H, E, b, mask):
    """Fill an absent bias (zeros, f32) and mask (every position kept)."""
    if b is None:
        b = torch.zeros(E.shape[0], dtype=torch.float32, device=H.device)
    if mask is None:
        mask = torch.ones(H.shape[:2], dtype=torch.int32, device=H.device)
    return b, mask


class _SpartonHead(torch.autograd.Function):
    """K1 forward, K2 + K3 backward (the paper's Alg. 2 and 3)."""

    @staticmethod
    def forward(ctx, H, E, b, mask, softcap, out_dtype, dh_reduce):
        y, i_max = sparton_forward(H, E, b, mask, softcap=softcap)
        ctx.save_for_backward(H, E, y, i_max)
        ctx.softcap, ctx.dh_reduce = softcap, dh_reduce
        return y.to(out_dtype or H.dtype)

    @staticmethod
    def backward(ctx, dy):
        H, E, y, i_max = ctx.saved_tensors
        dH, dE, db = sparton_backward(dy.float().contiguous(), y, i_max, H,
                                      E, softcap=ctx.softcap)
        if ctx.dh_reduce is not None:
            dH = ctx.dh_reduce(dH)
        return dH.to(H.dtype), dE.to(E.dtype), db, None, None, None, None


def sparton_lm_head_kernel(
    H: torch.Tensor,
    E: torch.Tensor,
    b: torch.Tensor,
    mask: torch.Tensor,
    block_b: Optional[int] = None,
    block_s: Optional[int] = None,
    block_v: Optional[int] = None,
    softcap: Optional[float] = None,
    interpret: bool = False,
    out_dtype: Optional[torch.dtype] = None,
    dh_blocks: Optional[Tuple[int, int, int]] = None,
    de_blocks: Optional[Tuple[int, int, int]] = None,
) -> torch.Tensor:
    """The differentiable kernel head under the reference's name: K1
    forward, K2 + K3 backward, ``y`` in ``out_dtype`` (default ``H``'s).
    ``block_*``, ``dh_blocks`` and ``de_blocks`` are the Pallas kernels'
    TPU tiles: the CUDA kernels pick their own, so a pin raises.
    ``interpret`` asks the reference for the Pallas interpreter; here the
    tensors' device decides (CPU tensors take the plain versions)."""
    pinned = {name: value for name, value in (
        ("block_b", block_b), ("block_s", block_s), ("block_v", block_v),
        ("dh_blocks", dh_blocks), ("de_blocks", de_blocks))
        if value is not None}
    if pinned:
        raise ValueError(
            f"sparton_lm_head_kernel: {pinned} are TPU tiles of the JAX "
            "package's Pallas head; the CUDA kernels pick their own tiles")
    return _SpartonHead.apply(H, E, b, mask, softcap, out_dtype, None)


def sparton_head(
    H: torch.Tensor,
    E: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    *,
    logit_softcap: Optional[float] = None,
    out_dtype: Optional[torch.dtype] = None,
    dh_reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """Kernel-backed head with optional bias (zeros) and mask (all kept);
    differentiable in ``H``, ``E`` and ``b``. ``dh_reduce`` takes K2's f32
    ``dH`` before its cast to ``H``'s dtype (the vocab-sharded head sums
    it over ``model`` there, so that it rounds once)."""
    b, mask = with_defaults(H, E, b, mask)
    return _SpartonHead.apply(H, E, b, mask, logit_softcap, out_dtype,
                              dh_reduce)
