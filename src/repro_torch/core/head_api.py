"""Unified head API (``repro/core/head_api.py``): one spec, one registry,
one factory.

* ``HeadSpec``           — frozen description of a head configuration.
* ``register_head_impl`` — backends with one calling convention
  ``fn(H, E, b, mask, *, spec) -> (B, V)``: ``naive``, ``tiled``,
  ``sparton`` (plain PyTorch) and ``kernel`` (the CUDA K1 forward, K2
  and K3 backward) ship registered. Every one is differentiable in
  ``H``, ``E`` and ``b``.
* ``make_head(spec, mesh=None)`` — ``head(H, E, b=None, mask=None) ->
  Y``; with a ``launch.mesh.Mesh``, the vocab-sharded head on this rank's
  blocks (``core/sharded.py``).
* ``make_encoder(spec, mesh=None)`` — the head plus the spec's rep
  sparsifier.
* ``normalize_softcap_kwarg`` — folds the deprecated ``softcap=`` into
  ``logit_softcap``.
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


def _kernel_impl(H, E, b, mask, *, spec: HeadSpec, dh_reduce=None):
    pinned = {name: getattr(spec, name)
              for name in ("block_b", "block_s", "block_v")
              if getattr(spec, name) is not None}
    if pinned:
        raise ValueError(
            f"impl='kernel': {pinned} are TPU tiles of the JAX package's "
            "Pallas head; the CUDA kernel picks its own tiles — leave "
            "block_b/block_s/block_v unset")
    return sparton_head(H, E, b, mask, logit_softcap=spec.logit_softcap,
                        out_dtype=_out_dtype(H, spec), dh_reduce=dh_reduce)


# takes ``dh_reduce``: K2's f32 dH before its cast (``make_head`` with a mesh)
_kernel_impl.takes_dh_reduce = True

register_head_impl("naive", _naive_impl)
register_head_impl("tiled", _tiled_impl)
register_head_impl("sparton", _sparton_impl)
register_head_impl("kernel", _kernel_impl)


def make_head(
    spec: HeadSpec,
    mesh=None,
    *,
    axis_name: str = "model",
    batch_axes: Tuple[str, ...] = ("pod", "data"),
) -> Callable[..., torch.Tensor]:
    """One canonical ``head(H, E, b=None, mask=None) -> Y`` callable.

    Without a mesh: the registered backend, called directly.

    With a ``launch.mesh.Mesh``: ``H`` and ``mask`` are this rank's rows
    of the batch (split over ``batch_axes``, the same on every rank of
    ``axis_name``), ``E`` and ``b`` the whole head. Vocab divisibility is
    a property of the call: when ``axis_name``'s size divides
    ``E.shape[0]``, the backend runs on this rank's rows of ``E`` and
    ``b`` (views, not copies) and returns its ``(B_local, V_local)``
    block of ``Y``; ``∇H`` is summed over ``axis_name`` and the rows'
    ``∇E``, ``∇b`` gathered over it in the backward
    (``collectives.replicated_input``, ``collectives.shard_rows``). The
    kernel impl (``takes_dh_reduce``) sums K2's f32 ``∇H`` before its
    cast to H's dtype, so a bf16 ``∇H`` rounds once, as the unsharded
    head's does (the JAX package sums the bf16 cotangents). Any
    other call warns and runs the unsharded head, ``(B_local, V)``, on
    every rank. Either way the spec's impl runs: the JAX package demotes
    ``kernel`` to ``sparton`` there (``pallas_call`` has no GSPMD rule);
    the CUDA kernels take any rows, so the card never runs a plain head
    on this path.
    """
    impl_fn = get_head_impl(spec.impl)

    if mesh is None:
        def head(H, E, b=None, mask=None):
            b, mask = with_defaults(H, E, b, mask)
            return impl_fn(H, E, b, mask, spec=spec)
        return head

    from repro_torch.collectives import psum, replicated_input, shard_rows
    from repro_torch.core.sharded import check_axes

    check_axes(mesh, axis_name, batch_axes)
    n_shard = mesh.shape[axis_name]

    def sharded(H, E, b=None, mask=None):
        b, mask = with_defaults(H, E, b, mask)
        if E.shape[0] % n_shard == 0:
            e = shard_rows(E, axis_name, mesh)
            b_ = shard_rows(b, axis_name, mesh)
            if getattr(impl_fn, "takes_dh_reduce", False):
                return impl_fn(H, e, b_, mask, spec=spec,
                               dh_reduce=lambda g: psum(g, axis_name, mesh))
            return impl_fn(replicated_input(H, axis_name, mesh), e, b_,
                           mask, spec=spec)
        warnings.warn(
            f"make_head: vocab {E.shape[0]} not divisible by {n_shard} "
            f"{axis_name!r} shards — running the unsharded {spec.impl!r} "
            f"head on every {axis_name!r} rank")
        return impl_fn(H, E, b, mask, spec=spec)

    return sharded


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


def make_encoder(
    spec: HeadSpec,
    mesh=None,
    *,
    axis_name: str = "model",
    batch_axes: Tuple[str, ...] = ("pod", "data"),
) -> Callable[..., object]:
    """Head + rep sparsifier: ``encode(H, E, b=None, mask=None)`` gives a
    ``SparseRep`` when the spec's rep knobs are set, else the dense
    ``(B, V)`` tensor (with a mesh, ``make_head``'s block). The
    sparsifier runs on the head's device; with a mesh it sees whole
    rows, the vocab blocks gathered over ``axis_name`` first, so its
    top-k is the unsharded one."""
    head = make_head(spec, mesh, axis_name=axis_name, batch_axes=batch_axes)
    sparsify = make_sparsifier(spec)
    if sparsify is None:
        return head

    def encode(H, E, b=None, mask=None):
        y = head(H, E, b, mask)
        if mesh is not None and y.shape[-1] != E.shape[0]:
            from repro_torch.collectives import all_gather

            y = all_gather(y, axis_name, mesh, dim=-1)
        return sparsify(y)

    return encode
