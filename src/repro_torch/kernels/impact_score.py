"""K4 — fused impact scoring with a streaming top-k, a CUDA kernel.

Replaces the Pallas TPU kernel ``repro/kernels/impact_score.py:
_impact_kernel`` (entry ``fused_impact_topk``): per query row, score the
flat posting lanes ``(w = q·impact, doc id)`` into doc tiles visited in
ascending order and keep a running top-k, so the ``(B, N)`` score matrix
never reaches device memory. The kernel is ``csrc/impact_topk.cu``; its
header says how it is laid out.

Bound on the H100: each lane is read once (4 bytes of weight, 4 of doc
id), so the floor is ``fused_window_bytes`` over 3.35 TB/s. The design
keeps a tile of up to 32768 scores in shared memory (the whole corpus at
the serving shape, so the window is read once) and scatters one query
term at a time, which makes the sums deterministic in the reference's
lane order. One block per query leaves most SMs idle at small batches.

``fused_impact_topk`` dispatches on the tensors' device: CPU tensors go
to ``fused_impact_topk_plain``, CUDA tensors to the kernel (or a raise).
``fused_impact_topk.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.topk_score import topk_rows

MAX_K = 1024  # the kernel keeps k running entries twice in shared memory
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def scatter_scores(w: torch.Tensor, docs: torch.Tensor,
                   n_docs: int) -> torch.Tensor:
    """Dense ``(B, n_docs)`` scores: each lane's weight added to its doc.

    Lanes whose doc id lies outside ``[0, n_docs)`` score nothing. On the
    CPU the adds run in lane order.
    """
    B, W = w.shape
    docs = docs.long()
    ok = (docs >= 0) & (docs < n_docs)
    rows = torch.arange(B, device=w.device).unsqueeze(1) * n_docs
    flat = torch.zeros(B * n_docs, dtype=torch.float32, device=w.device)
    flat.index_add_(0, (rows + docs)[ok], w.float()[ok])
    return flat.view(B, n_docs)


def fused_impact_topk_plain(w: torch.Tensor, docs: torch.Tensor, *,
                            n_docs: int, k: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4: the dense scores, then the merge's
    top-k (ties to the lowest doc id, ``(NEG_INF, 0)`` past ``n_docs``)."""
    return topk_rows(scatter_scores(w, docs, n_docs), k)


def _launch(w, docs, n_docs, k, term_lanes):
    if not (w.is_cuda and docs.device == w.device):
        raise ValueError("fused_impact_topk: w and docs must lie on one "
                         "CUDA device")
    if w.dim() != 2 or docs.shape != w.shape:
        raise ValueError(f"fused_impact_topk: w {tuple(w.shape)} and docs "
                         f"{tuple(docs.shape)} must both be (B, W)")
    if w.dtype != torch.float32 or docs.dtype != torch.int32:
        raise ValueError(f"fused_impact_topk: the kernel takes f32 weights "
                         f"and i32 doc ids, got {w.dtype} / {docs.dtype}")
    if not (w.is_contiguous() and docs.is_contiguous()):
        raise ValueError("fused_impact_topk: w and docs must be contiguous")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"fused_impact_topk: the kernel takes 1 <= k <= "
                         f"{MAX_K}, got k={k}")
    if n_docs < 1:
        raise ValueError(f"fused_impact_topk: n_docs must be >= 1, got "
                         f"{n_docs}")
    B, W = w.shape
    vals = torch.empty((B, k), dtype=torch.float32, device=w.device)
    idx = torch.empty((B, k), dtype=torch.int32, device=w.device)
    if B == 0:
        return vals, idx
    fn = _build.function("impact_topk", "impact_topk", _ARGTYPES)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream().cuda_stream
        fused_impact_topk.launches += 1
        rc = fn(w.data_ptr(), docs.data_ptr(), vals.data_ptr(),
                idx.data_ptr(), B, W, term_lanes, n_docs, k, stream)
    _build.check_launch(rc, "impact_topk")
    return vals, idx


def fused_impact_topk(
    w: torch.Tensor,        # (B, W) f32 — per-lane q[t]*impact, invalid 0
    docs: torch.Tensor,     # (B, W) i32 — per-lane absolute doc ids
    *,
    n_docs: int,
    k: int,
    term_lanes: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused scoring + top-k over flat posting windows.

    Returns ``(vals (B, k) f32, idx (B, k) i32)``: ties to the lowest doc
    id, columns past ``n_docs`` hold ``(NEG_INF, 0)``. ``term_lanes``
    (>= 1) is the lanes per query term (the window's ``max_postings``);
    the kernel scatters one term at a time, which fixes the order of each
    doc's sum. CPU tensors take the plain version.
    """
    if term_lanes < 1:
        raise ValueError(f"fused_impact_topk: term_lanes must be >= 1, got "
                         f"{term_lanes}")
    if w.device.type == "cpu":
        return fused_impact_topk_plain(w, docs, n_docs=n_docs, k=k)
    return _launch(w, docs, n_docs, k, term_lanes)


fused_impact_topk.launches = 0


def fused_window_bytes(B: int, Q: int, L: int) -> int:
    """Device bytes of the gathered ``(B, Q, L)`` posting windows one
    fused call reads: f32 weights + i32 doc ids. (The JAX function's
    ``"u4"`` variant belongs to the quantized kernel, not ported yet.)"""
    return B * Q * L * (4 + 4)
