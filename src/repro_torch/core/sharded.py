"""The vocabulary-sharded Sparton head and the objectives over it
(``repro/core/sharded.py``), on a ``launch.mesh.Mesh``.

The vocabulary dimension is split over the ``model`` axis: each rank
runs the head on its rows of ``E`` and ``b`` and holds its ``(B_local,
V / n_model)`` block of ``Y``. The forward needs no collective;
``∇H = Σ_v g·E[v]`` is one sum over ``model`` in the backward; ``∇E``
stays on its rank's rows until the train step gathers it. InfoNCE's
``q · dᵀ``, the FLOPS and L1 regularizers and MarginMSE's row dots are
sums over the vocabulary: each rank sums its block and one sum over
``model`` (``collectives.psum``) gives a value every rank holds, so the
``(B, V)`` reps are never gathered.

Each factory binds a mesh and returns the JAX package's ``shard_map``
body as a function of this rank's blocks: ``H`` and ``mask`` its rows of
the batch (split over ``batch_axes``, replicated over ``model``), ``E``
and ``b`` whole (replicated; the head takes the rank's rows as views),
reps its ``(B_local, V_local)`` block. ``head_shardings`` gives each
tensor's spec and ``local_block`` cuts a rank's block out of a global
tensor by it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.collectives import all_gather, pmean, psum
from repro_torch.launch.mesh import Mesh, as_axes, axis_index, axis_size
from repro_torch.launch.sharding import Spec


def check_axes(mesh: Mesh, axis_name: str,
               batch_axes: Sequence[str]) -> Tuple[str, ...]:
    """``batch_axes`` as a tuple, after checking that it and ``axis_name``
    are distinct axes of ``mesh`` (as ``shard_map`` refuses others)."""
    batch_axes = as_axes(batch_axes)
    names = batch_axes + (axis_name,)
    missing = [a for a in names if a not in mesh.shape]
    if missing or len(set(names)) != len(names):
        raise ValueError(f"axes {names} are not distinct axes of the mesh "
                         f"{mesh.axis_names} (missing {missing})")
    return batch_axes


def sharded_sparton_head(
    mesh: Mesh,
    *,
    axis_name: str = "model",
    batch_axes: Tuple[str, ...] = ("pod", "data"),
    vocab_tile: int = 4096,
    logit_softcap: Optional[float] = None,
    unroll: int = 1,
    bwd_batch_chunk: int = 8,
):
    """``head(H, E, b, mask) -> Y`` block, the plain ``sparton`` head on the
    rank's vocab rows: ``make_head(HeadSpec(impl="sparton", ...),
    mesh=mesh, ...)``. ``unroll`` and ``bwd_batch_chunk`` shape the JAX
    package's scan and its custom VJP; eager PyTorch has neither."""
    from repro_torch.core.head_api import HeadSpec, make_head

    del unroll, bwd_batch_chunk
    spec = HeadSpec(impl="sparton", vocab_tile=vocab_tile,
                    logit_softcap=logit_softcap)
    return make_head(spec, mesh=mesh, axis_name=axis_name,
                     batch_axes=batch_axes)


def _scores(q, d, mesh, axis_name, batch_axes):
    """``q (Bq_local, V_local) · d_allᵀ`` in f32, the documents gathered
    over ``batch_axes`` (row-major) and the partial sums over ``model``:
    ``(Bq_local, Bd_global)``."""
    d_full = all_gather(d, batch_axes, mesh) if batch_axes else d
    return psum(q.float() @ d_full.float().T, axis_name, mesh)


def sharded_similarity(mesh: Mesh, *, axis_name: str = "model",
                       batch_axes: Tuple[str, ...] = ("pod", "data")):
    """``(q, d) -> scores (Bq_local, Bd_global)``: this rank's queries
    against every document of the global batch, replicated over
    ``model``."""
    batch_axes = check_axes(mesh, axis_name, batch_axes)

    def fn(q, d):
        return _scores(q, d, mesh, axis_name, batch_axes)
    return fn


def sharded_infonce(mesh: Mesh, *, axis_name: str = "model",
                    batch_axes: Tuple[str, ...] = ("pod", "data"),
                    temperature: float = 1.0):
    """``(q, d) -> loss``: in-batch InfoNCE over the global batch, the
    positive of this rank's query i at its global row (the row-major
    offset over ``batch_axes``), the per-rank means averaged over the
    batch axes; the same value on every rank."""
    batch_axes = check_axes(mesh, axis_name, batch_axes)

    def fn(q, d):
        bq = q.shape[0]
        scores = _scores(q, d, mesh, axis_name, batch_axes) / temperature
        offset = axis_index(mesh, batch_axes) if batch_axes else 0
        labels = offset * bq + torch.arange(bq, device=q.device)
        logp = F.log_softmax(scores, dim=-1)
        local = -logp[torch.arange(bq, device=q.device), labels].mean()
        return pmean(local, batch_axes, mesh) if batch_axes else local
    return fn


def sharded_flops_reg(mesh: Mesh, *, axis_name: str = "model",
                      batch_axes: Tuple[str, ...] = ("pod", "data")):
    """``y -> sum_v (mean_b |Y[b, v]|)^2`` over the sharded vocabulary, in
    f32 as ``losses.flops_regularizer``. (The JAX body keeps ``y``'s
    dtype: at bf16 reps its regularizer is rounded to bf16, about 2e-3
    of the unsharded one; the port does not copy that.)"""
    batch_axes = check_axes(mesh, axis_name, batch_axes)

    def fn(y):
        mean_b = y.float().abs().mean(dim=0)
        if batch_axes:
            mean_b = pmean(mean_b, batch_axes, mesh)
        return psum((mean_b * mean_b).sum(), axis_name, mesh)
    return fn


def sharded_l1_reg(mesh: Mesh, *, axis_name: str = "model",
                   batch_axes: Tuple[str, ...] = ("pod", "data")):
    """``y -> mean_b sum_v |Y[b, v]|`` (f32): the row sums summed over
    ``model``, the batch mean averaged over the batch axes."""
    batch_axes = check_axes(mesh, axis_name, batch_axes)

    def fn(y):
        local = y.float().abs().sum(dim=-1).mean()
        total = psum(local, axis_name, mesh)
        return pmean(total, batch_axes, mesh) if batch_axes else total
    return fn


def sharded_row_dots(mesh: Mesh, *, axis_name: str = "model",
                     batch_axes: Tuple[str, ...] = ("pod", "data")):
    """``(a, c) -> s (B_local,)``, ``s[b] = sum_v a[b, v] c[b, v]`` in f32
    (MarginMSE's scores), replicated over ``model``."""
    check_axes(mesh, axis_name, batch_axes)

    def fn(a, c):
        return psum((a.float() * c.float()).sum(dim=-1), axis_name, mesh)
    return fn


def head_shardings(mesh: Mesh, *, axis_name: str = "model",
                   batch_axes: Tuple[str, ...] = ("pod", "data")
                   ) -> Dict[str, Spec]:
    """The spec of each of the head's tensors (H, E, b, mask, Y): for each
    dimension the axes it is split over (None: whole)."""
    batch_axes = check_axes(mesh, axis_name, batch_axes) or None
    model = (axis_name,)
    return {"H": (batch_axes, None, None), "E": (model, None), "b": (model,),
            "mask": (batch_axes, None), "Y": (batch_axes, model)}


def local_block(mesh: Mesh, spec: Spec, x: Any) -> Any:
    """This rank's block of the global ``x`` under ``spec``: a view (a numpy
    array's block is a numpy view)."""
    for dim, axes in enumerate(spec):
        if not axes:
            continue
        n = axis_size(mesh, axes)
        if x.shape[dim] % n:
            raise ValueError(f"local_block: dimension {dim} of "
                             f"{tuple(x.shape)} does not split over "
                             f"{tuple(axes)} ({n} ranks)")
        size = x.shape[dim] // n
        lo = axis_index(mesh, axes) * size
        index = (slice(None),) * dim + (slice(lo, lo + size),)
        x = x[index]
    return x
