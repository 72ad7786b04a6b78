"""K4 and K5 — fused impact scoring with a streaming top-k, CUDA kernels.

K4 replaces the Pallas TPU kernel ``repro/kernels/impact_score.py:
_impact_kernel`` (entry ``fused_impact_topk``): per query row, score the
flat posting lanes ``(w = q·impact, doc id)`` into doc tiles visited in
ascending order and keep a running top-k, so the ``(B, N)`` score matrix
never reaches device memory.

K5 replaces ``_impact_q_kernel`` (entry ``fused_quantized_topk``): the same
scoring over the u4+delta windows of a ``QuantizedIndex``, decoded inside
the kernel. For each query term t and lane l below its length (and only
where ``qv > 0``) the code is the high nibble of ``byte_win`` when the
absolute posting position ``starts + l`` is odd, else the low one; the
doc id is the running sum of the term's gaps; the weight is
``(lo + (code - 1) * step) * qv``, and code 0 (an escape phantom) weighs
exactly 0 but still advances the running sum.

Both kernels live in ``csrc/impact_topk.cu``; its header says how they
are laid out. Bound on the H100: each lane is read once (8 bytes: weight
and doc id for K4, packed byte and gap for K5), so the floor is
``fused_window_bytes`` over 3.35 TB/s. The design keeps a tile of up to
32768 scores in shared memory and scatters one query term at a time, which
makes the sums deterministic in the reference's lane order. One block per
query leaves most SMs idle at small batches. Any ``k >= 1``: the two
running lists of k entries sit beside the tile in shared memory while
they fit, else in a device workspace the wrapper allocates.

``fused_impact_topk`` and ``fused_quantized_topk`` dispatch on the
tensors' device: CPU tensors go to their ``*_plain`` version, CUDA tensors
to the kernel (or a raise). Each wrapper's ``.launches`` counts its kernel
launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.topk_score import topk_rows

# u4 codes 1..15 span 14 steps between a term's lo and hi (engine/quantize)
U4_LEVELS = 14
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_Q_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _workspace(B: int, n_docs: int, k: int, device) -> torch.Tensor:
    """The device workspace K4 and K5 need for B query rows: empty while
    the running lists fit in shared memory, else ``B * 4 * k`` floats."""
    fn = _build.function("impact_topk", "impact_topk_workspace",
                         [ctypes.c_int] * 3, ctypes.c_longlong)
    nbytes = fn(B, n_docs, k)
    if nbytes < 0:
        raise RuntimeError(f"impact_topk: no plan for B={B}, "
                           f"n_docs={n_docs}, k={k}")
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr() if t.numel() else 0


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
    if w.dim() != 2 or docs.shape != w.shape:
        raise ValueError(f"fused_impact_topk: w {tuple(w.shape)} and docs "
                         f"{tuple(docs.shape)} must both be (B, W)")
    if w.dtype != torch.float32 or docs.dtype != torch.int32:
        raise ValueError(f"fused_impact_topk: the kernel takes f32 weights "
                         f"and i32 doc ids, got {w.dtype} / {docs.dtype}")
    if not (w.is_contiguous() and docs.is_contiguous()):
        raise ValueError("fused_impact_topk: w and docs must be contiguous")
    if k < 1:
        raise ValueError(f"fused_impact_topk: k must be >= 1, got k={k}")
    if n_docs < 1:
        raise ValueError(f"fused_impact_topk: n_docs must be >= 1, got "
                         f"{n_docs}")
    # the device last, so that the checks above run on meta tensors too
    if not (w.is_cuda and docs.device == w.device):
        raise ValueError("fused_impact_topk: w and docs must lie on one "
                         "CUDA device")
    B, W = w.shape
    vals = torch.empty((B, k), dtype=torch.float32, device=w.device)
    idx = torch.empty((B, k), dtype=torch.int32, device=w.device)
    if B == 0:
        return vals, idx
    fn = _build.function("impact_topk", "impact_topk", _ARGTYPES)
    with torch.cuda.device(w.device):
        ws = _workspace(B, n_docs, k, w.device)
        stream = torch.cuda.current_stream().cuda_stream
        fused_impact_topk.launches += 1
        rc = fn(w.data_ptr(), docs.data_ptr(), vals.data_ptr(),
                idx.data_ptr(), _ptr(ws), B, W, term_lanes, n_docs, k,
                stream)
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


def decode_quantized_windows(byte_win: torch.Tensor, gap_win: torch.Tensor,
                             starts: torch.Tensor, lens: torch.Tensor,
                             qv: torch.Tensor, lo: torch.Tensor,
                             step: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The u4+delta decode of ``(B, Q, L)`` windows: ``(w f32, docs i32)``
    per lane, in the JAX kernel's arithmetic (two roundings, no fused
    multiply-add). Invalid lanes (past ``lens``, or ``qv <= 0``) and
    phantoms weigh 0; invalid lanes keep the last valid doc id."""
    L = byte_win.shape[2]
    lane = torch.arange(L, dtype=torch.int32, device=byte_win.device)
    valid = (lane < lens[:, :, None]) & (qv > 0)[:, :, None]
    odd = ((starts[:, :, None] + lane) & 1) == 1
    code = torch.where(odd, byte_win >> 4, byte_win & 0xF)
    code = torch.where(valid, code, 0)
    docs = torch.cumsum(torch.where(valid, gap_win, 0), dim=2,
                        dtype=torch.int32)
    val = lo[:, :, None] + (code - 1).float() * step[:, :, None]
    return torch.where(code > 0, val, 0.0) * qv[:, :, None], docs


def fused_quantized_topk_plain(byte_win, gap_win, starts, lens, qv, lo,
                               step, *, n_docs: int, k: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5: the decode, then the dense scores summed
    one query term at a time (each doc's sum in term order, the kernel's
    order on every device), then the merge's top-k."""
    w, docs = decode_quantized_windows(byte_win, gap_win, starts, lens, qv,
                                       lo, step)
    B, Q, _ = w.shape
    rows = torch.arange(B, device=w.device).unsqueeze(1) * n_docs
    flat = torch.zeros(B * n_docs, dtype=torch.float32, device=w.device)
    for t in range(Q):
        d = docs[:, t].long()
        ok = (d >= 0) & (d < n_docs)
        flat.index_add_(0, torch.where(ok, rows + d, 0).view(-1),
                        torch.where(ok, w[:, t], 0.0).view(-1))
    return topk_rows(flat.view(B, n_docs), k)


def _launch_q(byte_win, gap_win, starts, lens, qv, lo, step, n_docs, k):
    wins, metas = (byte_win, gap_win), (starts, lens, qv, lo, step)
    dev = byte_win.device
    if byte_win.dim() != 3 or gap_win.shape != byte_win.shape:
        raise ValueError(f"fused_quantized_topk: byte_win "
                         f"{tuple(byte_win.shape)} and gap_win "
                         f"{tuple(gap_win.shape)} must both be (B, Q, L)")
    B, Q, L = byte_win.shape
    if any(t.shape != (B, Q) for t in metas):
        raise ValueError(f"fused_quantized_topk: starts, lens, qv, lo and "
                         f"step must be (B, Q) = {(B, Q)}, got "
                         f"{[tuple(t.shape) for t in metas]}")
    if (any(t.dtype != torch.int32 for t in (byte_win, gap_win, starts, lens))
            or any(t.dtype != torch.float32 for t in (qv, lo, step))):
        raise ValueError("fused_quantized_topk: the kernel takes i32 "
                         "byte_win, gap_win, starts, lens and f32 qv, lo, "
                         "step")
    if not all(t.is_contiguous() for t in wins + metas):
        raise ValueError("fused_quantized_topk: inputs must be contiguous")
    if k < 1:
        raise ValueError(f"fused_quantized_topk: k must be >= 1, got k={k}")
    if n_docs < 1:
        raise ValueError(f"fused_quantized_topk: n_docs must be >= 1, got "
                         f"{n_docs}")
    # the device last, so that the checks above run on meta tensors too
    if not all(t.is_cuda and t.device == dev for t in wins + metas):
        raise ValueError("fused_quantized_topk: every input must lie on one "
                         "CUDA device")
    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0:
        return vals, idx
    fn = _build.function("impact_topk", "impact_q_topk", _Q_ARGTYPES)
    with torch.cuda.device(dev):
        ws = _workspace(B, n_docs, k, dev)
        stream = torch.cuda.current_stream().cuda_stream
        fused_quantized_topk.launches += 1
        rc = fn(*(t.data_ptr() for t in wins + metas), vals.data_ptr(),
                idx.data_ptr(), _ptr(ws), B, Q, L, n_docs, k, stream)
    _build.check_launch(rc, "impact_q_topk")
    return vals, idx


def fused_quantized_topk(
    byte_win: torch.Tensor,   # (B, Q, L) i32 — packed byte of each lane
    gap_win: torch.Tensor,    # (B, Q, L) i32 — doc-id gap of each lane
    starts: torch.Tensor,     # (B, Q) i32 — posting offset of each term
    lens: torch.Tensor,       # (B, Q) i32 — expanded list length
    qv: torch.Tensor,         # (B, Q) f32 — query term weight
    lo: torch.Tensor,         # (B, Q) f32 — the term's affine low
    step: torch.Tensor,       # (B, Q) f32 — the term's affine step
    *,
    n_docs: int,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused u4+delta decode, scoring and top-k over gathered windows.

    Returns ``(vals (B, k) f32, idx (B, k) i32)``: ties to the lowest doc
    id, columns past ``n_docs`` hold ``(NEG_INF, 0)``. Lanes at or past a
    term's ``lens`` are ignored, so padding may hold anything. CPU tensors
    take the plain version.
    """
    if byte_win.device.type == "cpu":
        return fused_quantized_topk_plain(byte_win, gap_win, starts, lens,
                                          qv, lo, step, n_docs=n_docs, k=k)
    return _launch_q(byte_win, gap_win, starts, lens, qv, lo, step, n_docs,
                     k)


fused_quantized_topk.launches = 0


def fused_window_bytes(B: int, Q: int, L: int, variant: str = "f32") -> int:
    """Device bytes of the gathered ``(B, Q, L)`` posting windows one fused
    call reads: ``"f32"`` (K4) f32 weights + i32 doc ids; ``"u4"`` (K5)
    i32 packed bytes + i32 gaps + five per-term columns."""
    if variant == "f32":
        return B * Q * L * (4 + 4)
    if variant == "u4":
        return B * Q * L * (4 + 4) + B * Q * 5 * 4
    raise ValueError(f"unknown fused variant {variant!r}")
