"""Dense scoring with a streaming top-k (K6), and the running top-k merge
shared by every top-k in the port.

``topk_score`` replaces the Pallas TPU kernel
``repro/kernels/topk_score.py:_topk_kernel`` (entry ``topk_score``):
score queries ``(B, D)`` against candidates ``(N, D)`` as ``q @ C^T`` and
keep only the top-k of each row, so the ``(B, N)`` score matrix never
reaches device memory. The kernel is ``csrc/topk_score.cu``; its header
says how it is laid out. CPU tensors go to ``topk_score_plain``, CUDA
tensors to the kernel (or a raise); ``topk_score.launches`` counts
kernel launches.

``torch.topk`` promises no order among equal values, so ``merge_topk`` is
a stable descending sort: equal values keep their position in the
concatenation ``[running, new]``, and when blocks are visited in
ascending-id order ties go to the lowest id, as with ``lax.top_k``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import NEG_INF

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
             + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def merge_topk(run_vals: torch.Tensor, run_idx: torch.Tensor,
               new_vals: torch.Tensor, new_idx: torch.Tensor, k: int):
    """Union of ``(B, k)`` running winners and a ``(B, m)`` block,
    re-top-k'd: value descending, ties to the earlier entry."""
    all_vals = torch.cat([run_vals, new_vals], dim=1)
    all_idx = torch.cat([run_idx, new_idx], dim=1)
    top_vals, pos = torch.sort(all_vals, dim=1, descending=True, stable=True)
    return top_vals[:, :k], torch.gather(all_idx, 1, pos[:, :k])


def topk_rows(x: torch.Tensor, k: int):
    """Top-k of each row of ``(B, N)`` ``x`` with the merge's contract:
    ties to the lowest column; when ``k > N`` the tail holds
    ``(NEG_INF, 0)``. Returns ``(vals f32, idx i32)``."""
    B, N = x.shape
    init_v = torch.full((B, k), NEG_INF, dtype=torch.float32, device=x.device)
    init_i = torch.zeros((B, k), dtype=torch.int32, device=x.device)
    ids = torch.arange(N, dtype=torch.int32, device=x.device).expand(B, N)
    return merge_topk(init_v, init_i, x.float(), ids, k)


def topk_score_plain(q: torch.Tensor, C: torch.Tensor, *, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K6: the whole ``(B, N)`` f32 product,
    then the merge's top-k (ties to the lowest id, ``(NEG_INF, 0)`` past
    ``N``)."""
    return topk_rows(q.float() @ C.float().T, k)


def _launch(q, C, k):
    if k < 0:
        raise ValueError(f"topk_score: k must be >= 0, got k={k}")
    if q.dim() != 2 or C.dim() != 2 or q.shape[1] != C.shape[1]:
        raise ValueError(f"topk_score: q {tuple(q.shape)} and C "
                         f"{tuple(C.shape)} must be (B, D) and (N, D)")
    # the device last, so that the checks above run on meta tensors too
    if not (q.is_cuda and C.device == q.device):
        raise ValueError("topk_score: q and C must lie on one CUDA device")
    # the reference casts to f32; a corpus kept f32 and contiguous (as the
    # serve path keeps it) is read in place, anything else is copied once
    q = q.float().contiguous()
    C = C.float().contiguous()
    B, D = q.shape
    N = C.shape[0]
    vals = torch.empty((B, k), dtype=torch.float32, device=q.device)
    idx = torch.empty((B, k), dtype=torch.int32, device=q.device)
    if B == 0 or k == 0:
        return vals, idx
    workspace = _build.function("topk_score", "topk_score_workspace",
                                [ctypes.c_int] * 4, ctypes.c_longlong)
    fn = _build.function("topk_score", "topk_score", _ARGTYPES)
    with torch.cuda.device(q.device):
        nbytes = workspace(B, N, D, k)
        if nbytes < 0:
            raise RuntimeError(f"topk_score: no launch plan for B={B}, "
                               f"N={N}, D={D}, k={k}")
        # the padded queries, pass 1's partial lists and, for a large k,
        # the running lists; freed on return, which is safe: the caching
        # allocator hands the block only to work queued later on this
        # stream
        ws = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=q.device)
        stream = torch.cuda.current_stream().cuda_stream
        topk_score.launches += 1
        rc = fn(q.data_ptr(), C.data_ptr(), ws.data_ptr(), nbytes,
                vals.data_ptr(), idx.data_ptr(), B, N, D, k, stream)
    _build.check_launch(rc, "topk_score")
    return vals, idx


def stream_rows() -> int:
    """The largest batch the kernel scores with f32 FMAs; larger batches
    take split f32 (3xTF32) on the tensor cores. Read from the built
    kernel, which defines it."""
    return _build.function("topk_score", "topk_score_stream_rows", [])()


def topk_score(q: torch.Tensor, C: torch.Tensor, *, k: int = 100
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused scoring + streaming top-k: ``(vals (B, k) f32, idx (B, k)
    i32)`` of ``q @ C^T``, in f32.

    Ties between equal scores go to the lowest candidate id. When
    ``k > N`` the first ``N`` columns are the full descending ranking and
    the tail holds ``(NEG_INF, 0)``. Any ``k >= 0``. CPU tensors take the
    plain version. On the card a contiguous f32 corpus is read in place;
    another dtype or layout is cast to contiguous f32 once per call, as
    the reference casts it.
    """
    if q.device.type == "cpu" and C.device.type == "cpu":
        return topk_score_plain(q, C, k=k)
    return _launch(q, C, k)


topk_score.launches = 0
