"""SparseRep — the post-head currency of the retrieval stack
(``repro/retrieval/sparse_rep.py``).

A fixed-width sparse row per query or document::

    values  (..., K) f32  — impact weights, > 0 when active, padding 0.0
    indices (..., K) i32  — vocab ids of the active terms, padding 0
    nnz     (...,)   i32  — active slots per row (always a prefix)

Leaves are tensors on the device right after the sparsifier, and numpy
arrays on the host (``device_get``, ``split_rows``, ``stack_rows``), as
in the JAX package. The sparsifiers keep the largest values with ties to
the lowest vocab id (``kernels.topk_score.merge_topk``'s contract).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.topk_score import topk_rows


@dataclasses.dataclass(frozen=True)
class SparseRep:
    """Fixed-width sparse rows (see the module docstring for the layout)."""

    values: Any       # (..., K) float — torch.Tensor or np.ndarray
    indices: Any      # (..., K) int32
    nnz: Any          # (...,)   int32

    @property
    def width(self) -> int:
        return self.values.shape[-1]

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return tuple(self.values.shape[:-1])

    def to(self, device) -> "SparseRep":
        """The rep with tensor leaves on ``device``."""
        return SparseRep(*(torch.as_tensor(a, device=device)
                           for a in (self.values, self.indices, self.nnz)))

    def to_dense(self, vocab_size: int) -> torch.Tensor:
        """Scatter back to a dense ``(..., V)`` tensor (padding adds 0.0
        at column 0, a no-op)."""
        rep = self.to(self.values.device
                      if isinstance(self.values, torch.Tensor) else "cpu")
        k = self.width
        flat_v = rep.values.reshape(-1, k).float()
        flat_i = rep.indices.reshape(-1, k).long()
        out = torch.zeros((flat_v.shape[0], vocab_size),
                          dtype=torch.float32, device=flat_v.device)
        out.scatter_add_(1, flat_i, flat_v)
        return out.reshape(*self.batch_shape, vocab_size)


def query_columns(queries: SparseRep, device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows' ``(B, K)`` i32 vocab ids and f32 weights, contiguous on
    ``device``: what the fused scorers' index entries take."""
    q = queries.to(device)
    width = queries.width
    return (q.indices.reshape(-1, width).int().contiguous(),
            q.values.reshape(-1, width).float().contiguous())


def _finalize(vals: torch.Tensor, idx: torch.Tensor,
              threshold: float) -> SparseRep:
    # non-positive entries are absent; winners are value-descending, so
    # the kept slots form a prefix
    keep = vals > max(float(threshold), 0.0)
    return SparseRep(values=torch.where(keep, vals, 0.0),
                     indices=torch.where(keep, idx, 0),
                     nnz=keep.sum(dim=-1, dtype=torch.int32))


def sparsify_topk(dense: torch.Tensor, k: int, *,
                  threshold: float = 0.0) -> SparseRep:
    """Keep the ``k`` largest strictly-positive entries per row (ties to
    the lowest id); ``threshold`` also drops kept entries at or below
    it. Width ``min(k, V)``."""
    vals, idx = topk_rows(dense, min(k, dense.shape[1]))
    return _finalize(vals, idx, threshold)


def sparsify_threshold(dense: torch.Tensor, threshold: float = 0.0, *,
                       max_nnz: int = 256) -> SparseRep:
    """Keep entries strictly above ``threshold``, the ``max_nnz`` largest
    when more qualify."""
    vals, idx = topk_rows(dense, min(max_nnz, dense.shape[1]))
    return _finalize(vals, idx, threshold)


def device_get(rep: SparseRep) -> SparseRep:
    """The rep with numpy leaves on the host."""
    return SparseRep(*(a.cpu().numpy() if isinstance(a, torch.Tensor)
                       else np.asarray(a)
                       for a in (rep.values, rep.indices, rep.nnz)))


def split_rows(rep: SparseRep) -> List[SparseRep]:
    """A batched ``(B, K)`` rep as B single-row ``(K,)`` numpy reps."""
    host = device_get(rep)
    v = host.values.reshape(-1, host.width)
    i = host.indices.reshape(-1, host.width)
    n = host.nnz.reshape(-1)
    return [SparseRep(v[r], i[r], n[r]) for r in range(v.shape[0])]


def truncate_width(rep: SparseRep, k: int) -> SparseRep:
    """Shrink the width to the ``k`` largest-value slots per row (numpy,
    host-side; the degrade ladder's query-side move). No-op when
    ``k >= width``."""
    if k >= rep.width:
        return rep
    if k < 1:
        raise ValueError(f"truncate_width needs k >= 1, got {k}")
    host = device_get(rep)
    v = host.values.astype(np.float32).reshape(-1, rep.width)
    i = host.indices.astype(np.int32).reshape(-1, rep.width)
    sel = np.argsort(-v, axis=1, kind="stable")[:, :k]
    rows = np.arange(v.shape[0])[:, None]
    nv, ni = v[rows, sel], i[rows, sel]
    shape = rep.batch_shape
    return SparseRep(nv.reshape(*shape, k), ni.reshape(*shape, k),
                     (nv > 0).sum(axis=1).astype(np.int32).reshape(shape))


def stack_rows(reps: Sequence[SparseRep]) -> SparseRep:
    """Stack single-row or batched reps into one ``(N, K)`` numpy rep;
    narrower rows are zero-padded to the widest (a no-op)."""
    if not reps:
        raise ValueError("stack_rows: empty sequence")
    parts = [device_get(r) for r in reps]
    width = max(p.width for p in parts)
    vs, is_, ns = [], [], []
    for p in parts:
        v = p.values.reshape(-1, p.width)
        i = p.indices.reshape(-1, p.width)
        pad = width - p.width
        if pad:
            v = np.pad(v, ((0, 0), (0, pad)))
            i = np.pad(i, ((0, 0), (0, pad)))
        vs.append(np.asarray(v, np.float32))
        is_.append(np.asarray(i, np.int32))
        ns.append(np.asarray(p.nnz).reshape(-1))
    return SparseRep(np.concatenate(vs), np.concatenate(is_),
                     np.concatenate(ns).astype(np.int32))
