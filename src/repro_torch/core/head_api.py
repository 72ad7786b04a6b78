"""Unified head API (``repro/core/head_api.py``): one spec, one registry,
one factory.

* ``HeadSpec``           — frozen description of a head configuration.
* ``register_head_impl`` — backends with one calling convention
  ``fn(H, E, b, mask, *, spec) -> (B, V)``: ``naive``, ``tiled``,
  ``sparton`` (plain PyTorch) and ``kernel`` (the CUDA K1 forward, K2
  and K3 backward) ship registered. Every one is differentiable in
  ``H``, ``E`` and ``b``.
* ``make_head(spec)``    — ``head(H, E, b=None, mask=None) -> Y``.
* ``make_encoder(spec)`` — the head plus the spec's rep sparsifier.
* ``normalize_softcap_kwarg`` — folds the deprecated ``softcap=`` into
  ``logit_softcap``.

The JAX factory's ``mesh=`` (the vocab-sharded head) waits for the
multi-GPU slice.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import lm_head as _lm
from repro_torch.device import dtype_of
from repro_torch.kernels.ops import sparton_head, with_defaults

HeadFn = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class HeadSpec:
    """Everything needed to build a Sparton head, in one hashable value.

    ``impl``            registry name: naive | tiled | sparton | kernel.
    ``block_b/s/v``     the JAX package's Pallas (TPU) tiles. The CUDA
                        kernel picks its own tiles, so ``kernel`` refuses
                        pinned values instead of ignoring them.
    ``vocab_tile``      streaming tile of the plain impls.
    ``logit_softcap``   gemma-2 style ``c * tanh(x / c)`` on the logits.
    ``out_dtype``       output dtype name (e.g. "bfloat16"); None = H's.
    ``rep_topk``        sparsify the (B, V) output to its top-k terms.
    ``rep_threshold``   drop rep entries at or below this weight.
    ``rep_max_nnz``     slot budget of threshold-only sparsification.
    """

    impl: str = "sparton"
    block_b: Optional[int] = None
    block_s: Optional[int] = None
    block_v: Optional[int] = None
    vocab_tile: int = 4096
    logit_softcap: Optional[float] = None
    out_dtype: Optional[str] = None
    rep_topk: Optional[int] = None
    rep_threshold: Optional[float] = None
    rep_max_nnz: int = 256

    @property
    def sparse_reps(self) -> bool:
        """Whether encoders built from this spec emit SparseReps."""
        return self.rep_topk is not None or self.rep_threshold is not None

    def replace(self, **kw) -> "HeadSpec":
        return dataclasses.replace(self, **kw)


_REGISTRY: Dict[str, HeadFn] = {}


def register_head_impl(name: str, fn: HeadFn) -> None:
    """Register (or override) a head backend under ``name``."""
    _REGISTRY[name] = fn


def available_impls() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_head_impl(name: str) -> HeadFn:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown head impl {name!r}; one of {list(available_impls())}"
        ) from None


def normalize_softcap_kwarg(
    logit_softcap: Optional[float],
    softcap: Optional[float],
    where: str,
) -> Optional[float]:
    """Fold the deprecated ``softcap=`` spelling into ``logit_softcap``:
    a ``DeprecationWarning`` when it is given, a ``ValueError`` when both
    are given and differ."""
    if softcap is None:
        return logit_softcap
    warnings.warn(
        f"{where}: the 'softcap' kwarg is deprecated; use "
        "'logit_softcap' (one normalized name across every head "
        "surface)", DeprecationWarning, stacklevel=3)
    if logit_softcap is not None and logit_softcap != softcap:
        raise ValueError(
            f"{where}: conflicting logit_softcap={logit_softcap!r} and "
            f"deprecated softcap={softcap!r}")
    return softcap


def _out_dtype(H: torch.Tensor, spec: HeadSpec) -> torch.dtype:
    return dtype_of(spec.out_dtype) or H.dtype


def _naive_impl(H, E, b, mask, *, spec: HeadSpec):
    y = _lm.lm_head_naive(H, E, b, mask, logit_softcap=spec.logit_softcap)
    return y.to(_out_dtype(H, spec))


def _tiled_impl(H, E, b, mask, *, spec: HeadSpec):
    y = _lm.lm_head_tiled(H, E, b, mask, vocab_tile=spec.vocab_tile,
                          logit_softcap=spec.logit_softcap)
    return y.to(_out_dtype(H, spec))


def _sparton_impl(H, E, b, mask, *, spec: HeadSpec):
    y = _lm.lm_head_sparton(H, E, b, mask, vocab_tile=spec.vocab_tile,
                            logit_softcap=spec.logit_softcap)
    return y.to(_out_dtype(H, spec))


def _kernel_impl(H, E, b, mask, *, spec: HeadSpec):
    pinned = {name: getattr(spec, name)
              for name in ("block_b", "block_s", "block_v")
              if getattr(spec, name) is not None}
    if pinned:
        raise ValueError(
            f"impl='kernel': {pinned} are TPU tiles of the JAX package's "
            "Pallas head; the CUDA kernel picks its own tiles — leave "
            "block_b/block_s/block_v unset")
    return sparton_head(H, E, b, mask, logit_softcap=spec.logit_softcap,
                        out_dtype=_out_dtype(H, spec))


register_head_impl("naive", _naive_impl)
register_head_impl("tiled", _tiled_impl)
register_head_impl("sparton", _sparton_impl)
register_head_impl("kernel", _kernel_impl)


def make_head(spec: HeadSpec) -> Callable[..., torch.Tensor]:
    """One canonical ``head(H, E, b=None, mask=None) -> Y`` callable."""
    impl_fn = get_head_impl(spec.impl)

    def head(H, E, b=None, mask=None):
        b, mask = with_defaults(H, E, b, mask)
        return impl_fn(H, E, b, mask, spec=spec)

    return head


def make_sparsifier(spec: HeadSpec) -> Optional[Callable[..., object]]:
    """The spec's rep sparsifier ``(B, V) -> SparseRep``, or None when
    both rep knobs are off (dense output)."""
    if not spec.sparse_reps:
        return None
    from repro_torch.retrieval.sparse_rep import (sparsify_threshold,
                                                  sparsify_topk)

    if spec.rep_topk is not None:
        topk, thr = spec.rep_topk, spec.rep_threshold or 0.0
        return lambda y: sparsify_topk(y, topk, threshold=thr)
    threshold, max_nnz = spec.rep_threshold, spec.rep_max_nnz
    return lambda y: sparsify_threshold(y, threshold, max_nnz=max_nnz)


def make_encoder(spec: HeadSpec) -> Callable[..., object]:
    """Head + rep sparsifier: ``encode(H, E, b=None, mask=None)`` gives a
    ``SparseRep`` when the spec's rep knobs are set, else the dense
    ``(B, V)`` tensor. The sparsifier runs on the head's device."""
    head = make_head(spec)
    sparsify = make_sparsifier(spec)
    if sparsify is None:
        return head

    def encode(H, E, b=None, mask=None):
        return sparsify(head(H, E, b, mask))

    return encode
