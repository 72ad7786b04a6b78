"""K2 and K3 — the Sparton LM-head backward, CUDA kernels for Hopper.

Replace the Pallas TPU kernels ``repro/kernels/sparton_bwd.py``:
``_dh_kernel`` (entry ``sparton_backward_dh``) and ``_de_kernel`` (entry
``sparton_backward_de``). From the forward's saved ``(y, i_max)`` and
the upstream cotangent ``dy``, with ``g = bwd_factor(y, dy, softcap)``:

* K2: ``dH[b, s, :] = sum_v g[b, v] * [i_max[b, v] == s] * E[v, :]``
* K3: ``dE[v, :] = sum_b g[b, v] * H[b, i_max[b, v], :]`` and the fused
  ``db[v] = sum_b g[b, v]``.

The kernels are ``csrc/sparton_bwd.cu``; its header gives their design.
K2 is two launches: a routing pass that computes ``g`` once per term and
sorts each batch row's terms with ``g != 0`` by ``i_max`` (stably, so
ascending ``v`` within a position), into scratch the wrapper allocates
(``dh_scratch``: bucket offsets, sorted ``(v, g)`` lists, ``g`` and a
list of the heavy buckets); then one warp per (position, up to 768 columns) sums its
bucket's rows of E in registers, while helper warps split the heavy
buckets (past 1024 terms) into 64-column pieces. K3 gives one warp to
each (vocab row, up to 768 columns), summing over ascending ``b`` in
registers, in waves of blocks that walk ``b`` together so that the rows
of H they gather stay in L2. Both keep the rows in flight in a
``cp.async`` ring in shared memory.
Both take any B, S and D. They use no atomics: each output element is
summed by one lane as a chain of FMAs in a fixed order (ascending ``v``
for dH, ascending ``b`` for dE and db), so two launches give the same
bits. Bound on the H100: ``2 * nnz(g) * D`` f32 FLOP against the bytes
of ``dy, y, i_max``, the rows the terms need and the output, about 0.27
ms at the train step's shape at random init (nearly every ``g != 0``);
the kernels are bound instead by the rows they gather from L2, one row of
E or H per term with ``g != 0`` (18 GB at that shape).

Each entry dispatches on the tensors' device: CPU tensors go to the
plain version (Alg. 3 of the paper as ``repro/core/lm_head.py`` writes
it: per batch chunk, ``index_add_`` for dH and a gather of
``H[b, i_max]`` for dE), CUDA tensors to the kernel or a raise, with no
fallback. ``sparton_backward_dh.launches`` and
``sparton_backward_de.launches`` count kernel launches. ``meta`` tensors
(the dry run's abstract pass, ``launch/dryrun.py``) get empty outputs of
the kernels' shapes and K2's routing scratch, allocated as the CUDA
wrappers allocate them, with no launch. ``dh_cost`` and ``de_cost`` give
the kernels' work from the shapes; the meta branches and the plain
versions report it to a running ``launch.cost_analysis.StepCounter``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import bwd_factor
from repro_torch.launch import cost_analysis

_DH_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_DE_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
BWD_BATCH_CHUNK = 8    # batch rows per step of the plain versions


def sparton_backward_dh_plain(
    dy: torch.Tensor,      # (B, V) raw upstream cotangent
    y: torch.Tensor,       # (B, V) f32 stored post-activation
    i_max: torch.Tensor,   # (B, V) i32
    E: torch.Tensor,       # (V, D)
    seq_len: int,
    softcap: Optional[float] = None,
    *,
    bwd_batch_chunk: int = BWD_BATCH_CHUNK,
) -> torch.Tensor:
    """Plain PyTorch version of K2: ``dH (B, S, D)`` f32.

    Per chunk of batch rows, ``g * E`` is scattered into the rows
    ``i_max`` with ``index_add_`` (peak memory one ``(chunk, V, D)`` f32
    tensor).
    """
    g = bwd_factor(y, dy, softcap)
    B, V = g.shape
    E32 = E.float()
    dH = torch.zeros((B, seq_len, E.shape[1]), dtype=torch.float32,
                     device=g.device)
    chunk = max(1, min(bwd_batch_chunk, B))
    for c0 in range(0, B, chunk):
        g_b, i_b = g[c0:c0 + chunk], i_max[c0:c0 + chunk].long()
        n = g_b.shape[0]
        rows = (torch.arange(n, device=g.device)[:, None] * seq_len
                + i_b).reshape(-1)
        contrib = (g_b[..., None] * E32).reshape(n * V, -1)
        dH[c0:c0 + n].view(n * seq_len, -1).index_add_(0, rows, contrib)
    return dH


def sparton_backward_de_plain(
    dy: torch.Tensor,      # (B, V)
    y: torch.Tensor,       # (B, V) f32
    i_max: torch.Tensor,   # (B, V) i32
    H: torch.Tensor,       # (B, S, D)
    softcap: Optional[float] = None,
    *,
    bwd_batch_chunk: int = BWD_BATCH_CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3: ``(dE (V, D), db (V,))`` f32.

    Per chunk of batch rows, ``H[b, i_max[b, v]]`` is gathered and
    contracted with ``g`` over the chunk (peak memory one
    ``(chunk, V, D)`` f32 tensor).
    """
    g = bwd_factor(y, dy, softcap)
    B, V = g.shape
    dE = torch.zeros((V, H.shape[2]), dtype=torch.float32, device=g.device)
    chunk = max(1, min(bwd_batch_chunk, B))
    for c0 in range(0, B, chunk):
        g_b, i_b = g[c0:c0 + chunk], i_max[c0:c0 + chunk].long()
        rows = torch.arange(g_b.shape[0], device=g.device)[:, None]
        gathered = H[c0:c0 + chunk].float()[rows, i_b]     # (n, V, D)
        dE += torch.einsum("cv,cvd->vd", g_b, gathered)
    return dE, g.sum(dim=0)


def _bytes_read(B: int, V: int, D: int, itemsize: int, rows: int) -> int:
    return B * V * 12 + rows * D * itemsize


def dh_cost(B: int, S: int, D: int, V: int, itemsize: int,
            nnz: Optional[int] = None,
            rows: Optional[int] = None) -> Tuple[int, int]:
    """K2's work ``(flops, bytes)``: one FMA (2 f32 FLOP) per term with
    ``g != 0`` (``nnz``, default every one of the B·V: random init, or
    meta tensors without values) and column; ``dy``, ``y`` and ``i_max``
    read once, the ``rows`` of E that such a term reads (default all V)
    once each, dH written once. Terms with ``g == 0`` are skipped by the
    kernel, so they are not counted."""
    nnz = B * V if nnz is None else nnz
    rows = V if rows is None else rows
    return 2 * nnz * D, _bytes_read(B, V, D, itemsize, rows) + B * S * D * 4


def de_cost(B: int, S: int, D: int, V: int, itemsize: int,
            nnz: Optional[int] = None,
            rows: Optional[int] = None) -> Tuple[int, int]:
    """K3's work ``(flops, bytes)``, as ``dh_cost``'s but for the distinct
    ``(b, i_max)`` rows of H that its terms read (default ``B · min(S,
    V)``) and dE and db written once."""
    nnz = B * V if nnz is None else nnz
    rows = B * min(S, V) if rows is None else rows
    return (2 * nnz * D,
            _bytes_read(B, V, D, itemsize, rows) + V * D * 4 + V * 4)


def _check(what, dy, y, i_max, X, S):
    """The kernels' argument checks, on CUDA and meta tensors alike (the
    device comes last)."""
    if dy.dim() != 2 or y.shape != dy.shape or i_max.shape != dy.shape:
        raise ValueError(f"{what}: dy {tuple(dy.shape)}, y "
                         f"{tuple(y.shape)} and i_max {tuple(i_max.shape)} "
                         "must all be (B, V)")
    if dy.dtype != torch.float32 or y.dtype != torch.float32 \
            or i_max.dtype != torch.int32:
        raise ValueError(f"{what}: the kernel takes dy and y float32 and "
                         f"i_max int32, got {dy.dtype}, {y.dtype} and "
                         f"{i_max.dtype}")
    if X.dtype not in _DTYPE_CODE:
        raise ValueError(f"{what}: the kernel takes float32 or bfloat16 "
                         f"weights, got {X.dtype}")
    if not (dy.is_contiguous() and y.is_contiguous()
            and i_max.is_contiguous() and X.is_contiguous()):
        raise ValueError(f"{what}: every input must be contiguous")
    B, V = dy.shape
    if min(B, V, S, X.shape[-1]) < 1:
        raise ValueError(f"{what}: shape (B={B}, S={S}, D={X.shape[-1]}, "
                         f"V={V}) outside the kernel's range (all >= 1)")
    if not (dy.device.type in ("cuda", "meta") and y.device == dy.device
            and i_max.device == dy.device and X.device == dy.device):
        raise ValueError(f"{what}: dy, y, i_max and the weights must lie "
                         "on one CUDA device (or all on meta)")


def dh_scratch(B: int, S: int, V: int, device) -> Tuple[torch.Tensor, ...]:
    """K2's routing scratch: each batch row's bucket offsets ``(B, S + 1)``
    (i32), its sorted ``(v, g)`` entries ``(B, V, 2)`` (i32, g as f32
    bits), its ``g`` ``(B, V)`` (f32), and the heavy buckets' list (i32: a
    count, a pad, then up to ``B * min(S, V)`` pairs ``(b, s)``)."""
    return (torch.empty((B, S + 1), dtype=torch.int32, device=device),
            torch.empty((B, V, 2), dtype=torch.int32, device=device),
            torch.empty((B, V), dtype=torch.float32, device=device),
            torch.empty((2 + 2 * B * min(S, V),), dtype=torch.int32,
                        device=device))


def _cap(softcap: Optional[float]) -> float:
    if softcap is None:
        return 0.0
    if not softcap > 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    return float(softcap)


def _launch_dh(dy, y, i_max, E, seq_len, softcap):
    _check("sparton_backward_dh", dy, y, i_max, E, seq_len)
    B, V = dy.shape
    if E.dim() != 2 or E.shape[0] != V:
        raise ValueError(f"sparton_backward_dh: E {tuple(E.shape)} is not "
                         f"(V={V}, D)")
    D = E.shape[1]
    dH = torch.empty((B, seq_len, D), dtype=torch.float32, device=dy.device)
    ofs, lists, gs, heavy = dh_scratch(B, seq_len, V, dy.device)
    if dy.is_meta:
        cost_analysis.count_kernel(
            "sparton_bwd_dh", *dh_cost(B, seq_len, D, V, E.element_size()),
            "f32")
        return dH
    # 16-byte loads of 8-column pieces need D % 8 == 0 and an aligned base
    vec = int(D % 8 == 0 and E.data_ptr() % 16 == 0)
    fn = _build.function("sparton_bwd", "sparton_bwd_dh", _DH_ARGTYPES)
    with torch.cuda.device(dy.device):
        stream = torch.cuda.current_stream().cuda_stream
        sparton_backward_dh.launches += 1
        rc = fn(dy.data_ptr(), y.data_ptr(), i_max.data_ptr(), E.data_ptr(),
                dH.data_ptr(), ofs.data_ptr(), lists.data_ptr(),
                gs.data_ptr(), heavy.data_ptr(), B, seq_len, D, V,
                _DTYPE_CODE[E.dtype],
                _cap(softcap), vec, stream)
    _build.check_launch(rc, "sparton_bwd_dh")
    return dH


def _launch_de(dy, y, i_max, H, softcap):
    if H.dim() != 3:
        raise ValueError(f"sparton_backward_de: H {tuple(H.shape)} is not "
                         "(B, S, D)")
    _check("sparton_backward_de", dy, y, i_max, H, H.shape[1])
    B, V = dy.shape
    if H.shape[0] != B:
        raise ValueError(f"sparton_backward_de: H {tuple(H.shape)} and dy "
                         f"{tuple(dy.shape)} differ in B")
    S, D = H.shape[1], H.shape[2]
    dE = torch.empty((V, D), dtype=torch.float32, device=dy.device)
    db = torch.empty((V,), dtype=torch.float32, device=dy.device)
    if dy.is_meta:
        cost_analysis.count_kernel(
            "sparton_bwd_de", *de_cost(B, S, D, V, H.element_size()), "f32")
        return dE, db
    # 16-byte loads of 8-column pieces need D % 8 == 0 and an aligned base
    vec = int(D % 8 == 0 and H.data_ptr() % 16 == 0)
    fn = _build.function("sparton_bwd", "sparton_bwd_de", _DE_ARGTYPES)
    with torch.cuda.device(dy.device):
        stream = torch.cuda.current_stream().cuda_stream
        sparton_backward_de.launches += 1
        rc = fn(dy.data_ptr(), y.data_ptr(), i_max.data_ptr(), H.data_ptr(),
                dE.data_ptr(), db.data_ptr(), B, S, D, V,
                _DTYPE_CODE[H.dtype], _cap(softcap), vec, stream)
    _build.check_launch(rc, "sparton_bwd_de")
    return dE, db


def sparton_backward_dh(
    dy: torch.Tensor,
    y: torch.Tensor,
    i_max: torch.Tensor,
    E: torch.Tensor,
    seq_len: int,
    *,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """K2: ``dH (B, S, D)`` f32. CPU tensors take the plain version; CUDA
    tensors launch the kernel, which takes dy and y f32, i_max i32 and E
    f32 or bf16, all contiguous; meta tensors launch nothing."""
    if dy.device.type == "cpu":
        B, V = dy.shape
        with cost_analysis.plain_version(
                "sparton_bwd_dh",
                *dh_cost(B, seq_len, E.shape[-1], V, E.element_size()),
                "f32"):
            return sparton_backward_dh_plain(dy, y, i_max, E, seq_len,
                                             softcap)
    return _launch_dh(dy, y, i_max, E, seq_len, softcap)


def sparton_backward_de(
    dy: torch.Tensor,
    y: torch.Tensor,
    i_max: torch.Tensor,
    H: torch.Tensor,
    *,
    softcap: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: ``(dE (V, D), db (V,))`` f32. CPU tensors take the plain
    version; CUDA tensors launch the kernel, which takes dy and y f32,
    i_max i32 and H f32 or bf16, all contiguous; meta tensors launch
    nothing."""
    if dy.device.type == "cpu":
        B, S, D = H.shape
        with cost_analysis.plain_version(
                "sparton_bwd_de",
                *de_cost(B, S, D, dy.shape[1], H.element_size()), "f32"):
            return sparton_backward_de_plain(dy, y, i_max, H, softcap)
    return _launch_de(dy, y, i_max, H, softcap)


sparton_backward_dh.launches = 0
sparton_backward_de.launches = 0


def sparton_backward(
    dy: torch.Tensor,      # (B, V) f32
    y: torch.Tensor,       # (B, V) f32
    i_max: torch.Tensor,   # (B, V) i32
    H: torch.Tensor,       # (B, S, D) f32 or bf16
    E: torch.Tensor,       # (V, D) f32 or bf16
    *,
    softcap: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused backward, K2 then K3: ``(dH, dE, db)`` in f32."""
    dH = sparton_backward_dh(dy, y, i_max, E, H.shape[1], softcap=softcap)
    dE, db = sparton_backward_de(dy, y, i_max, H, softcap=softcap)
    return dH, dE, db
