"""K1 — the fused Sparton LM-head forward, a CUDA kernel for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/sparton.py:_fwd_kernel``
(entry ``sparton_forward``): ``y = log1p(relu(max_s(mask(softcap(H·Eᵀ +
b)))))`` with the first-occurrence argmax ``i_max`` over S, without the
``(B, S, V)`` logits ever reaching device memory. The kernel is
``csrc/sparton_fwd.cu``; its header says how it is tiled.

Bound on the H100: at the paper's Table-1 shape (B=320, S=512, D=768,
V=30522) the contraction is 2·B·S·V·D ≈ 7.68 TFLOP against ≈0.38 GB of
compulsory traffic, so the kernel is compute-bound (≈7.8 ms at 989
TFLOP/s bf16). The design keeps the logits in registers and shared
memory (the paper's point) and runs the contraction on the tensor cores
for bf16 inputs, fed by a ring of asynchronous copies; it does not yet
use TMA or wgmma.

``sparton_forward`` dispatches on the tensors' device: CPU tensors go to
``sparton_forward_plain``, CUDA tensors to the kernel (or a raise — there
is no fallback). ``sparton_forward.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import NEG_INF

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_BATCH = 65535  # the kernel's grid.y limit


def sparton_forward_plain(
    H: torch.Tensor,        # (B, S, D) f32 or bf16
    E: torch.Tensor,        # (V, D)
    b: torch.Tensor,        # (V,)
    mask: torch.Tensor,     # (B, S), nonzero = keep
    softcap: Optional[float] = None,
    *,
    vocab_tile: int = 4096,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1: the streaming max over vocab tiles.

    Logits are f32 products of the inputs as given (bf16 products are
    exact in f32), so the only difference from the kernel is the order
    of the sums over D. Peak memory is one ``(B, S, vocab_tile)`` tile.
    Returns ``(y (B, V) f32, i_max (B, V) i32)``.
    """
    keep = mask.bool()[:, :, None]
    Hf = H.float()
    ys, args = [], []
    for v0 in range(0, E.shape[0], vocab_tile):
        logits = torch.einsum("bsd,vd->bsv", Hf,
                              E[v0:v0 + vocab_tile].float())
        logits = logits + b[v0:v0 + vocab_tile].float()
        if softcap is not None:
            logits = softcap * torch.tanh(logits / softcap)
        logits = torch.where(keep, logits, NEG_INF)
        m, i = logits.max(dim=1)      # first occurrence on ties
        ys.append(m)
        args.append(i)
    raw = torch.cat(ys, dim=1)
    return torch.log1p(raw.clamp_min(0.0)), torch.cat(args, dim=1).int()


def _check(H, E, b, mask, softcap):
    if not (H.is_cuda and E.device == H.device and b.device == H.device
            and mask.device == H.device):
        raise ValueError("sparton_forward: H, E, b and mask must lie on one "
                         "CUDA device")
    if H.dim() != 3 or E.dim() != 2 or H.shape[2] != E.shape[1]:
        raise ValueError(f"sparton_forward: H {tuple(H.shape)} and E "
                         f"{tuple(E.shape)} are not (B, S, D) and (V, D)")
    B, S, D = H.shape
    V = E.shape[0]
    if tuple(b.shape) != (V,) or tuple(mask.shape) != (B, S):
        raise ValueError(f"sparton_forward: b {tuple(b.shape)} / mask "
                         f"{tuple(mask.shape)} do not match (V,)=({V},) / "
                         f"(B, S)=({B}, {S})")
    if H.dtype not in _DTYPE_CODE or E.dtype != H.dtype:
        raise ValueError(f"sparton_forward: the kernel takes H and E both "
                         f"float32 or both bfloat16, got {H.dtype} and "
                         f"{E.dtype}")
    if not (H.is_contiguous() and E.is_contiguous()):
        raise ValueError("sparton_forward: H and E must be contiguous")
    if min(B, S, D, V) < 1 or B > MAX_BATCH:
        raise ValueError(f"sparton_forward: shape (B={B}, S={S}, D={D}, "
                         f"V={V}) outside the kernel's range (all >= 1, "
                         f"B <= {MAX_BATCH})")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"sparton_forward: softcap must be > 0, got "
                         f"{softcap}")


def _launch(H, E, b, mask, softcap):
    _check(H, E, b, mask, softcap)
    B, S, D = H.shape
    V = E.shape[0]
    b = b.to(torch.float32).contiguous()
    mask = mask.to(torch.int32).contiguous()
    y = torch.empty((B, V), dtype=torch.float32, device=H.device)
    i_max = torch.empty((B, V), dtype=torch.int32, device=H.device)
    # 16-byte async copies of bf16 rows need D % 8 == 0 and aligned bases
    vec = int(H.dtype == torch.bfloat16 and D % 8 == 0
              and H.data_ptr() % 16 == 0 and E.data_ptr() % 16 == 0)
    fn = _build.function("sparton_fwd", "sparton_fwd", _ARGTYPES)
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream().cuda_stream
        sparton_forward.launches += 1
        rc = fn(H.data_ptr(), E.data_ptr(), b.data_ptr(), mask.data_ptr(),
                y.data_ptr(), i_max.data_ptr(), B, S, D, V,
                _DTYPE_CODE[H.dtype],
                float(softcap) if softcap is not None else 0.0, vec, stream)
    _build.check_launch(rc, "sparton_fwd")
    return y, i_max


def sparton_forward(
    H: torch.Tensor,
    E: torch.Tensor,
    b: torch.Tensor,
    mask: torch.Tensor,
    *,
    softcap: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused forward. Returns ``(y (B, V) f32, i_max (B, V) i32)``.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes H and E both f32 or both bf16 and contiguous.
    """
    if H.device.type == "cpu":
        return sparton_forward_plain(H, E, b, mask, softcap)
    return _launch(H, E, b, mask, softcap)


sparton_forward.launches = 0
