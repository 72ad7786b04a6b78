"""K1 — the fused Sparton LM-head forward, a CUDA kernel for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/sparton.py:_fwd_kernel``
(entry ``sparton_forward``): ``y = log1p(relu(max_s(mask(softcap(H·Eᵀ +
b)))))`` with the first-occurrence argmax ``i_max`` over S, without the
``(B, S, V)`` logits ever reaching device memory. The kernel is
``csrc/sparton_fwd.cu``; its header says how each path is tiled.

Bound on the H100: at the paper's Table-1 shape (B=320, S=512, D=768,
V=30522) the contraction is 2·B·S·V·D ≈ 7.68 TFLOP against ≈0.38 GB of
compulsory traffic, so the kernel is compute-bound (≈7.8 ms at 989
TFLOP/s bf16).

Three paths, chosen by the plain rule ``_plan`` and counted apart in
``sparton_forward.path_launches`` (beside the total ``launches``):

* ``"tma"`` — bf16 H and E with ``D % 8 == 0`` and 16-byte aligned bases
  (TMA's rule for strides and bases): every launch of the serving and
  training paths. A persistent, warp-specialised kernel: a producer
  warpgroup keeps a ring of TMA loads in flight (two blocks of a cluster
  share each E slice by multicast), two consumer warpgroups each run
  ``wgmma`` on 128 of a tile's 256 vocab columns and fold bias, softcap,
  mask and the running max/argmax in registers. The C entry works out
  its launch geometry. On an NVIDIA H100 80GB HBM3 at 700 W it takes
  about 7 ms at the train step's padded 384 × 256, the WMMA design 32 ms
  (``PERF.md`` has the runs, each beside its bound).
* ``"wmma"`` — the other bf16 inputs: WMMA fed by a ``cp.async`` ring
  (16-byte copies where the rows allow, element copies otherwise).
* ``"f32"`` — f32 inputs: a register tile of FMAs.

A ``"tma"`` launch that cannot encode its tensor maps or launch raises;
it never gives way to another path or to the plain version.

``sparton_forward`` dispatches on the tensors' device: CPU tensors go to
``sparton_forward_plain``, CUDA tensors to the kernel (or a raise — there
is no fallback), ``meta`` tensors (the dry run's abstract pass,
``launch/dryrun.py``) to empty outputs of the kernel's shapes, allocated
as the CUDA wrapper allocates them, with no launch. ``forward_cost``
gives the kernel's work from the shapes; the meta branch and the plain
version report it to a running ``launch.cost_analysis.StepCounter``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import NEG_INF
from repro_torch.launch import cost_analysis

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float]
             + [ctypes.c_void_p])
_DTYPES = (torch.float32, torch.bfloat16)
PATHS = ("f32", "wmma", "tma")    # the C entry's path codes, in this order
# the C entry's code for a tensor map it could not encode: 10000 + CUresult
_ENCODE_FAILED = 10000


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


def forward_cost(B: int, S: int, D: int, V: int, itemsize: int,
                 kept: Optional[int] = None) -> Tuple[int, int]:
    """K1's work ``(flops, bytes)``: the products of the ``kept``
    (unmasked) positions only, since a masked logit is NEG_INF whatever
    H·E gives (every position when ``kept`` is None, as on meta tensors,
    whose mask has no values); every input read and every output written
    once."""
    kept = B * S if kept is None else kept
    flops = 2 * kept * V * D
    nbytes = (B * S * D + V * D) * itemsize + V * 4 + B * S * 4 + B * V * 8
    return flops, nbytes


def _cost(H: torch.Tensor, E: torch.Tensor):
    """``forward_cost`` of the inputs and the peak its products run at."""
    B, S, D = H.shape
    kind = "bf16" if H.element_size() == 2 else "f32"
    return forward_cost(B, S, D, E.shape[0], H.element_size()) + (kind,)


def _plan(H: torch.Tensor, E: torch.Tensor) -> str:
    """The kernel path for H and E: ``"tma"`` for bf16 with ``D % 8 ==
    0`` and both bases 16-byte aligned, ``"wmma"`` for the other bf16
    inputs, ``"f32"`` for f32. Reads only dtypes, shapes and addresses,
    so it runs on CPU and meta tensors too."""
    if H.dtype == torch.float32:
        return "f32"
    if (H.shape[-1] % 8 == 0 and H.data_ptr() % 16 == 0
            and E.data_ptr() % 16 == 0):
        return "tma"
    return "wmma"


def _check(H, E, b, mask, softcap, force=None):
    """The kernel's argument checks, on CUDA and meta tensors alike (the
    device comes last). ``force`` is ``_launch``'s ``_path``: only
    ``"wmma"``, and only for bf16 inputs."""
    if H.dim() != 3 or E.dim() != 2 or H.shape[2] != E.shape[1]:
        raise ValueError(f"sparton_forward: H {tuple(H.shape)} and E "
                         f"{tuple(E.shape)} are not (B, S, D) and (V, D)")
    B, S, D = H.shape
    V = E.shape[0]
    if tuple(b.shape) != (V,) or tuple(mask.shape) != (B, S):
        raise ValueError(f"sparton_forward: b {tuple(b.shape)} / mask "
                         f"{tuple(mask.shape)} do not match (V,)=({V},) / "
                         f"(B, S)=({B}, {S})")
    if H.dtype not in _DTYPES or E.dtype != H.dtype:
        raise ValueError(f"sparton_forward: the kernel takes H and E both "
                         f"float32 or both bfloat16, got {H.dtype} and "
                         f"{E.dtype}")
    if not (H.is_contiguous() and E.is_contiguous()):
        raise ValueError("sparton_forward: H and E must be contiguous")
    if min(B, S, D, V) < 1:
        raise ValueError(f"sparton_forward: shape (B={B}, S={S}, D={D}, "
                         f"V={V}) outside the kernel's range (all >= 1)")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"sparton_forward: softcap must be > 0, got "
                         f"{softcap}")
    if force is not None and (force != "wmma" or H.dtype != torch.bfloat16):
        raise ValueError(f"sparton_forward: only bf16 inputs may be sent "
                         f"to 'wmma', not {H.dtype} ones to {force!r}")
    if not (H.device.type in ("cuda", "meta") and E.device == H.device
            and b.device == H.device and mask.device == H.device):
        raise ValueError("sparton_forward: H, E, b and mask must lie on one "
                         "CUDA device (or all on meta)")


def _launch(H, E, b, mask, softcap, *, _path=None):
    """Launch the kernel on the path ``_plan`` gives. ``_path="wmma"``
    forces the WMMA path on bf16 inputs that ``"tma"`` would take, to time
    the two designs on the same inputs; nothing on the main path sets
    it."""
    _check(H, E, b, mask, softcap, _path)
    B, S, D = H.shape
    V = E.shape[0]
    path = _path or _plan(H, E)
    b = b.to(torch.float32).contiguous()
    mask = mask.to(torch.int32).contiguous()
    y = torch.empty((B, V), dtype=torch.float32, device=H.device)
    i_max = torch.empty((B, V), dtype=torch.int32, device=H.device)
    if H.is_meta:
        cost_analysis.count_kernel("sparton_fwd", *_cost(H, E))
        return y, i_max
    fn = _build.function("sparton_fwd", "sparton_fwd", _ARGTYPES)
    with torch.cuda.device(H.device):
        stream = torch.cuda.current_stream().cuda_stream
        sparton_forward.launches += 1
        sparton_forward.path_launches[path] += 1
        rc = fn(H.data_ptr(), E.data_ptr(), b.data_ptr(), mask.data_ptr(),
                y.data_ptr(), i_max.data_ptr(), B, S, D, V,
                PATHS.index(path),
                float(softcap) if softcap is not None else 0.0, stream)
    if rc >= _ENCODE_FAILED:
        raise RuntimeError(f"sparton_fwd: encoding the TMA tensor maps "
                           f"failed (CUresult {rc - _ENCODE_FAILED})")
    _build.check_launch(rc, f"sparton_fwd ({path})")
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

    CPU tensors take the plain version; CUDA tensors launch the kernel
    on the path ``_plan`` gives, which takes H and E both f32 or both
    bf16 and contiguous; meta tensors get the kernel's empty outputs and
    launch nothing.
    """
    if H.device.type == "cpu":
        with cost_analysis.plain_version("sparton_fwd", *_cost(H, E)):
            return sparton_forward_plain(H, E, b, mask, softcap)
    return _launch(H, E, b, mask, softcap)


sparton_forward.launches = 0
sparton_forward.path_launches = dict.fromkeys(PATHS, 0)
