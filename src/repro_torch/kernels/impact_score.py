"""K4 and K5 — fused impact scoring with a streaming top-k, CUDA kernels.

K4 replaces the Pallas TPU kernel ``repro/kernels/impact_score.py:
_impact_kernel`` (entry ``fused_impact_topk``): per query row, score the
posting lanes ``(w = q·impact, doc id)`` of every query term and keep the
top-k, so the ``(B, N)`` score matrix never reaches device memory.

K5 replaces ``_impact_q_kernel`` (entry ``fused_quantized_topk``): the same
scoring over the u4+delta postings of a ``QuantizedIndex``, decoded inside
the kernel. For each query term t and lane l below its length (and only
where ``qv > 0``) the code is the high nibble of the packed byte when the
absolute posting position ``starts + l`` is odd, else the low one; the
doc id is the running sum of the term's gaps; the weight is
``(lo + (code - 1) * step) * qv``, and code 0 (an escape phantom) weighs
exactly 0 but still advances the running sum.

K4 has a third entry, ``fused_ceiling_index_topk``: the tier-1 ceilings of
the two-tier pruned scorer (``repro/retrieval/engine/pruning.py``
``upper_bound_scores`` followed by ``lax.top_k``). It reads an
``InvertedIndex``'s doc ids in place, never its impacts: every lane of a
query term weighs the term's ceiling ``q_val * term_ubs[id]``.

Two entries each:

* the window entries ``fused_impact_topk`` and ``fused_quantized_topk``
  take the gathered, padded posting windows (the counterparts of the JAX
  entries, held against the Pallas kernels by the CPU tests);
* the index entries ``fused_impact_index_topk`` and
  ``fused_quantized_index_topk`` take the query rep's ``(B, Q)`` ids and
  weights and the index's arrays as they are stored (u8/u16 deltas and
  nibble-packed codes, u16 or i32 lengths, f16 bounds: no widening copy),
  and read each query term's postings in place. Their plain version is
  the gather of the windows (``index_windows``,
  ``quantized_index_windows``) followed by the window entry's.

All five run one kernel (``csrc/impact_topk.cu``; its header says how it is
laid out): a grid of (query row, doc slice) blocks that fills the card,
each staging its query's postings in shared memory with ``cp.async`` and
summing every doc's lanes in query-term order, then a merge of the
slices' top-k lists. A window batch is read as an index whose term
``(b, t)`` starts at a computed offset. Bound on the H100: the bytes the
in-place read needs (the query's postings once, the per-term columns, the
``(B, k)`` results), far below a microsecond at the serving shapes; the
time is the launches' and the dependent loads' latency. Any ``k >= 1``:
the slices' lists sit in a device workspace the wrapper allocates.

Each entry dispatches on the tensors' device: CPU tensors go to its
``*_plain`` version, CUDA tensors to the kernel (or a raise). Each
wrapper's ``.launches`` counts its calls on the card: one a call, though a
call with more than one doc slice a row runs two CUDA kernels (slices,
then merge).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.topk_score import topk_rows

# u4 codes 1..15 span 14 steps between a term's lo and hi (engine/quantize)
U4_LEVELS = 14
# The scorers' step is (hi - lo) times the f32 reciprocal of U4_LEVELS: the
# JAX package divides by the constant under jit, which XLA computes as that
# product (it differs from a true division by one ulp in about half the
# terms). The quantizer's build divides, as the reference's numpy build does.
STEP_SCALE = float(np.float32(1.0 / U4_LEVELS))
_VP, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_float)
_ARGTYPES = [_VP] * 5 + [_I] * 5 + [_VP]
_Q_ARGTYPES = [_VP] * 10 + [_I] * 5 + [_VP]
_INDEX_ARGTYPES = [_VP] * 9 + [_I] * 3 + [_LL] + [_I] * 2 + [_VP]
_Q_INDEX_ARGTYPES = ([_VP] * 11 + [_I] * 3 + [_LL] * 2 + [_I] * 2 + [_F]
                     + [_I] * 2 + [_VP])


@functools.lru_cache(maxsize=1024)
def _workspace_bytes(device_index: int, B: int, n_docs: int, k: int) -> int:
    """The device workspace bytes K4 and K5 need for B query rows on the
    current device (``device_index``): the doc slices' top-k lists (0 when
    one slice covers the docs)."""
    fn = _build.function("impact_topk", "impact_topk_workspace",
                         [ctypes.c_int] * 3, ctypes.c_longlong)
    nbytes = fn(B, n_docs, k)
    if nbytes < 0:
        raise RuntimeError(f"impact_topk: no plan for B={B}, "
                           f"n_docs={n_docs}, k={k}")
    return nbytes


def _run(entry, cname, argtypes, dev, B, n_docs, k, ptrs, ints):
    """Allocate ``(vals, idx)`` and the workspace on ``dev`` and launch the
    C entry ``cname`` as ``cname(*ptrs, vals, idx, ws, *ints, stream)``,
    counting the call on ``entry.launches``."""
    if B and dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _run(entry, cname, argtypes, dev, B, n_docs, k, ptrs,
                        ints)
    vals = torch.empty((B, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B == 0:
        return vals, idx
    fn = _build.function("impact_topk", cname, argtypes)
    nbytes = _workspace_bytes(dev.index, B, n_docs, k)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=dev) if nbytes else None
    entry.launches += 1
    rc = fn(*ptrs, vals.data_ptr(), idx.data_ptr(),
            ws.data_ptr() if ws is not None else 0, *ints,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(rc, cname)
    return vals, idx


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr() if t.numel() else 0


def _check_k(name: str, n_docs: int, k: int) -> None:
    if k < 1:
        raise ValueError(f"{name}: k must be >= 1, got k={k}")
    if n_docs < 1:
        raise ValueError(f"{name}: n_docs must be >= 1, got {n_docs}")


def _check_cuda(name: str, tensors) -> torch.device:
    """The one CUDA device every tensor lies on, else a raise (checked
    last, so that the other checks run on meta tensors too)."""
    dev = tensors[0].device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError(f"{name}: every input must lie on one CUDA device")
    return dev


def term_rows(q_idx: torch.Tensor, vocab: int) -> torch.Tensor:
    """The vocab rows that query ids ``q_idx`` read (int64), by the
    reference's rule for a gather (JAX's): a negative id plus ``vocab``,
    then clamped to ``[0, vocab - 1]``. The kernels apply the same rule
    to each id they read."""
    qi = q_idx.long()
    return torch.where(qi < 0, qi + vocab, qi).clamp(0, max(vocab - 1, 0))


def _gather_i32(a: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``a[pos]`` widened to int32 (uint16 through its int16 view: PyTorch
    implements few operators for uint16 on the card)."""
    if a.dtype == torch.uint16:
        return a.view(torch.int16)[pos].int() & 0xFFFF
    return a[pos].int()


def scatter_scores(w: torch.Tensor, docs: torch.Tensor, n_docs: int,
                   term_lanes: int) -> torch.Tensor:
    """Dense ``(B, n_docs)`` scores: each lane's weight added to its doc,
    one query term (``term_lanes`` lanes) at a time, one ``index_add_`` a
    term.

    Lanes whose doc id lies outside ``[0, n_docs)`` score nothing. A doc
    occurs at most once a term, so no two adds of an ``index_add_`` meet,
    and each doc's sum is taken in term order, ``0 + w(t0) + w(t1) +
    ...``, on every device: the kernels' order, and the same bits on
    every run on the card (one ``index_add_`` over all the lanes would
    add them there in no fixed order).
    """
    B, W = w.shape
    n_seg = -(-W // term_lanes)
    d = docs.long()
    ok = (d >= 0) & (d < n_docs)
    rows = torch.arange(B, device=w.device).unsqueeze(1) * n_docs
    # lanes that score nothing add 0 to a slot past the scores
    pos = torch.where(ok, rows + d, B * n_docs)
    val = torch.where(ok, w.float(), 0.0)
    if n_seg * term_lanes != W:
        pos = F.pad(pos, (0, n_seg * term_lanes - W), value=B * n_docs)
        val = F.pad(val, (0, n_seg * term_lanes - W))
    # term-major, so that each term's lanes are one contiguous row
    shape = (n_seg, B * term_lanes)
    pos = pos.view(B, n_seg, term_lanes).transpose(0, 1).reshape(shape)
    val = val.view(B, n_seg, term_lanes).transpose(0, 1).reshape(shape)
    flat = torch.zeros(B * n_docs + 1, dtype=torch.float32, device=w.device)
    for p, v in zip(pos.unbind(0), val.unbind(0)):
        flat.index_add_(0, p, v)
    return flat[:-1].view(B, n_docs)


def fused_impact_topk_plain(w: torch.Tensor, docs: torch.Tensor, *,
                            n_docs: int, k: int, term_lanes: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4: the dense scores summed one term
    (``term_lanes`` lanes) at a time, the kernel's order on every device,
    then the merge's top-k (ties to the lowest doc id, ``(NEG_INF, 0)``
    past ``n_docs``)."""
    return topk_rows(scatter_scores(w, docs, n_docs, term_lanes), k)


def _launch(w, docs, n_docs, k, term_lanes):
    name = "fused_impact_topk"
    if w.dim() != 2 or docs.shape != w.shape:
        raise ValueError(f"{name}: w {tuple(w.shape)} and docs "
                         f"{tuple(docs.shape)} must both be (B, W)")
    if w.dtype != torch.float32 or docs.dtype != torch.int32:
        raise ValueError(f"{name}: the kernel takes f32 weights "
                         f"and i32 doc ids, got {w.dtype} / {docs.dtype}")
    if not (w.is_contiguous() and docs.is_contiguous()):
        raise ValueError(f"{name}: w and docs must be contiguous")
    _check_k(name, n_docs, k)
    dev = _check_cuda(name, (w, docs))
    B, W = w.shape
    return _run(fused_impact_topk, "impact_topk", _ARGTYPES, dev, B, n_docs,
                k, (_ptr(w), _ptr(docs)), (B, W, term_lanes, n_docs, k))


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
    each doc's lanes are summed in term order, and a doc may occur at
    most once within a term's lanes. CPU tensors take the plain version.
    """
    if term_lanes < 1:
        raise ValueError(f"fused_impact_topk: term_lanes must be >= 1, got "
                         f"{term_lanes}")
    if w.device.type == "cpu":
        return fused_impact_topk_plain(w, docs, n_docs=n_docs, k=k,
                                       term_lanes=term_lanes)
    return _launch(w, docs, n_docs, k, term_lanes)


fused_impact_topk.launches = 0


def index_windows(q_idx: torch.Tensor, q_val: torch.Tensor,
                  term_starts: torch.Tensor, term_lens: torch.Tensor,
                  postings_doc: torch.Tensor, postings_val: torch.Tensor,
                  max_postings: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat ``(B, Q * max_postings)`` weight/doc windows of an inverted
    index: each query term's posting list padded to ``max_postings``
    lanes, invalid lanes (past the list, or ``q_val <= 0``) at weight
    exactly 0 and doc 0."""
    dev = postings_doc.device
    lane = torch.arange(max_postings, dtype=torch.int32, device=dev)
    qv = q_val.float()
    qi = term_rows(q_idx, term_starts.shape[0])
    starts = term_starts[qi]                                # (B, Q)
    lens = term_lens[qi]
    pos = starts[:, :, None] + lane                         # (B, Q, L)
    valid = (lane < lens[:, :, None]) & (qv > 0)[:, :, None]
    pos = pos.clamp(0, postings_doc.shape[0] - 1).long()
    docs = torch.where(valid, postings_doc[pos], 0)
    w = torch.where(valid, postings_val[pos], 0.0) * qv[:, :, None]
    b = w.shape[0]
    return w.reshape(b, -1).contiguous(), docs.reshape(b, -1).contiguous()


def ceiling_windows(q_idx: torch.Tensor, q_val: torch.Tensor,
                    term_starts: torch.Tensor, term_lens: torch.Tensor,
                    postings_doc: torch.Tensor, term_ubs: torch.Tensor,
                    max_postings: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``index_windows`` with each valid lane weighing its term's ceiling
    ``c = q_val * term_ubs[id]`` (one rounding) instead of its impact: the
    windows of the tier-1 upper-bound pass. ``postings_val`` is not
    read."""
    dev = postings_doc.device
    lane = torch.arange(max_postings, dtype=torch.int32, device=dev)
    qv = q_val.float()
    qi = term_rows(q_idx, term_starts.shape[0])
    c = qv * term_ubs[qi]                                   # (B, Q)
    pos = term_starts[qi][:, :, None] + lane                # (B, Q, L)
    valid = (lane < term_lens[qi][:, :, None]) & (qv > 0)[:, :, None]
    pos = pos.clamp(0, postings_doc.shape[0] - 1).long()
    docs = torch.where(valid, postings_doc[pos], 0)
    w = torch.where(valid, c[:, :, None], 0.0)
    b = w.shape[0]
    return w.reshape(b, -1).contiguous(), docs.reshape(b, -1).contiguous()


def query_lanes(q_idx: torch.Tensor, term_lens: torch.Tensor) -> int:
    """The longest posting list among the query's terms (>= 1): the
    window width at which the plain versions gather every posting (any
    wider window gives the same result)."""
    if q_idx.numel() == 0:
        return 1
    return max(1, int(_gather_i32(
        term_lens, term_rows(q_idx, term_lens.shape[0])).max()))


def fused_impact_index_topk_plain(q_idx, q_val, term_starts, term_lens,
                                  postings_doc, postings_val, *,
                                  n_docs: int, k: int
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4 in place: the windows' gather (as wide
    as the query's longest list), then the window entry's plain version,
    one term at a time."""
    L = query_lanes(q_idx, term_lens)
    w, docs = index_windows(q_idx, q_val, term_starts, term_lens,
                            postings_doc, postings_val, L)
    return fused_impact_topk_plain(w, docs, n_docs=n_docs, k=k,
                                   term_lanes=L)


def _launch_index(q_idx, q_val, term_starts, term_lens, postings_doc,
                  postings_val, n_docs, k):
    name = "fused_impact_index_topk"
    query, cols = (q_idx, q_val), (term_starts, term_lens)
    posts = (postings_doc, postings_val)
    if q_idx.dim() != 2 or q_val.shape != q_idx.shape:
        raise ValueError(f"{name}: q_idx {tuple(q_idx.shape)} and q_val "
                         f"{tuple(q_val.shape)} must both be (B, Q)")
    if (any(t.dim() != 1 for t in cols + posts)
            or term_lens.shape != term_starts.shape
            or postings_val.shape != postings_doc.shape):
        raise ValueError(f"{name}: term_starts/term_lens must be (V,) and "
                         f"postings_doc/postings_val (P,)")
    if (any(t.dtype != torch.int32 for t in (q_idx,) + cols + posts[:1])
            or q_val.dtype != torch.float32
            or postings_val.dtype != torch.float32):
        raise ValueError(f"{name}: the kernel takes i32 q_idx, term_starts, "
                         f"term_lens, postings_doc and f32 q_val, "
                         f"postings_val")
    if not all(t.is_contiguous() for t in query + cols + posts):
        raise ValueError(f"{name}: inputs must be contiguous")
    _check_k(name, n_docs, k)
    dev = _check_cuda(name, query + cols + posts)
    B, Q = q_idx.shape
    return _run(fused_impact_index_topk, "impact_index_topk",
                _INDEX_ARGTYPES, dev, B, n_docs, k,
                tuple(_ptr(t) for t in query + cols + posts),
                (B, Q, term_starts.shape[0], postings_doc.shape[0], n_docs,
                 k))


def fused_impact_index_topk(
    q_idx: torch.Tensor,         # (B, Q) i32 — vocab id of each query term
    q_val: torch.Tensor,         # (B, Q) f32 — its weight (<= 0: skipped)
    term_starts: torch.Tensor,   # (V,) i32 — the index's arrays, as stored
    term_lens: torch.Tensor,     # (V,) i32
    postings_doc: torch.Tensor,  # (P,) i32
    postings_val: torch.Tensor,  # (P,) f32
    *,
    n_docs: int,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 reading an ``InvertedIndex`` in place: the same result as
    ``fused_impact_topk`` on the query's windows (``index_windows``), with
    no window built on the card. CPU tensors take the plain version."""
    if postings_doc.device.type == "cpu":
        return fused_impact_index_topk_plain(
            q_idx, q_val, term_starts, term_lens, postings_doc, postings_val,
            n_docs=n_docs, k=k)
    return _launch_index(q_idx, q_val, term_starts, term_lens, postings_doc,
                         postings_val, n_docs, k)


fused_impact_index_topk.launches = 0


def fused_ceiling_index_topk_plain(q_idx, q_val, term_starts, term_lens,
                                   postings_doc, term_ubs, *, n_docs: int,
                                   k: int
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4's ceiling entry: the ceiling windows (as
    wide as the query's longest list), the dense ceilings summed one term
    at a time (``scatter_scores``, the kernel's order), then the merge's
    top-k (ties to the lowest doc id, zero-ceiling docs included)."""
    L = query_lanes(q_idx, term_lens)
    w, docs = ceiling_windows(q_idx, q_val, term_starts, term_lens,
                              postings_doc, term_ubs, L)
    return topk_rows(scatter_scores(w, docs, n_docs, L), k)


def _launch_ceiling(q_idx, q_val, term_starts, term_lens, postings_doc,
                    term_ubs, n_docs, k):
    name = "fused_ceiling_index_topk"
    query, cols = (q_idx, q_val), (term_starts, term_lens, term_ubs)
    if q_idx.dim() != 2 or q_val.shape != q_idx.shape:
        raise ValueError(f"{name}: q_idx {tuple(q_idx.shape)} and q_val "
                         f"{tuple(q_val.shape)} must both be (B, Q)")
    if (any(t.dim() != 1 for t in cols + (postings_doc,))
            or any(t.shape != term_starts.shape for t in cols)):
        raise ValueError(f"{name}: term_starts/term_lens/term_ubs must be "
                         f"(V,) and postings_doc (P,)")
    if (any(t.dtype != torch.int32 for t in (q_idx, term_starts, term_lens,
                                             postings_doc))
            or q_val.dtype != torch.float32
            or term_ubs.dtype != torch.float32):
        raise ValueError(f"{name}: the kernel takes i32 q_idx, term_starts, "
                         f"term_lens, postings_doc and f32 q_val, term_ubs")
    if not all(t.is_contiguous() for t in query + cols + (postings_doc,)):
        raise ValueError(f"{name}: inputs must be contiguous")
    _check_k(name, n_docs, k)
    dev = _check_cuda(name, query + cols + (postings_doc,))
    B, Q = q_idx.shape
    return _run(fused_ceiling_index_topk, "impact_ceiling_index_topk",
                _INDEX_ARGTYPES, dev, B, n_docs, k,
                tuple(_ptr(t) for t in (q_idx, q_val, term_starts, term_lens,
                                        postings_doc, term_ubs)),
                (B, Q, term_starts.shape[0], postings_doc.shape[0], n_docs,
                 k))


def fused_ceiling_index_topk(
    q_idx: torch.Tensor,         # (B, Q) i32 — vocab id of each query term
    q_val: torch.Tensor,         # (B, Q) f32 — its weight (<= 0: skipped)
    term_starts: torch.Tensor,   # (V,) i32 — the index's arrays, as stored
    term_lens: torch.Tensor,     # (V,) i32
    postings_doc: torch.Tensor,  # (P,) i32
    term_ubs: torch.Tensor,      # (V,) f32 — each term's largest impact
    *,
    n_docs: int,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's tier-1 ceiling entry: per query row, each doc's sum over the
    live query terms whose list holds it of ``q_val * term_ubs[id]``, in
    term order, and the k best ``(vals (B, k) f32, idx (B, k) i32)``: value
    descending, ties to the lowest doc id (zero-ceiling docs fill the list
    by id when fewer docs have a ceiling), ``(NEG_INF, 0)`` past
    ``n_docs``. Reads ``postings_doc`` in place and never the impacts. CPU
    tensors take the plain version."""
    if postings_doc.device.type == "cpu":
        return fused_ceiling_index_topk_plain(
            q_idx, q_val, term_starts, term_lens, postings_doc, term_ubs,
            n_docs=n_docs, k=k)
    return _launch_ceiling(q_idx, q_val, term_starts, term_lens,
                           postings_doc, term_ubs, n_docs, k)


fused_ceiling_index_topk.launches = 0


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
    one query term at a time (``scatter_scores``: each doc's sum in term
    order, the kernel's order on every device), then the merge's top-k."""
    w, docs = decode_quantized_windows(byte_win, gap_win, starts, lens, qv,
                                       lo, step)
    B, Q, L = w.shape
    return topk_rows(scatter_scores(w.reshape(B, -1), docs.reshape(B, -1),
                                    n_docs, max(L, 1)), k)


def _launch_q(byte_win, gap_win, starts, lens, qv, lo, step, n_docs, k):
    name = "fused_quantized_topk"
    wins, metas = (byte_win, gap_win), (starts, lens, qv, lo, step)
    if byte_win.dim() != 3 or gap_win.shape != byte_win.shape:
        raise ValueError(f"{name}: byte_win "
                         f"{tuple(byte_win.shape)} and gap_win "
                         f"{tuple(gap_win.shape)} must both be (B, Q, L)")
    B, Q, L = byte_win.shape
    if any(t.shape != (B, Q) for t in metas):
        raise ValueError(f"{name}: starts, lens, qv, lo and "
                         f"step must be (B, Q) = {(B, Q)}, got "
                         f"{[tuple(t.shape) for t in metas]}")
    if (any(t.dtype != torch.int32 for t in (byte_win, gap_win, starts, lens))
            or any(t.dtype != torch.float32 for t in (qv, lo, step))):
        raise ValueError(f"{name}: the kernel takes i32 "
                         "byte_win, gap_win, starts, lens and f32 qv, lo, "
                         "step")
    if not all(t.is_contiguous() for t in wins + metas):
        raise ValueError(f"{name}: inputs must be contiguous")
    _check_k(name, n_docs, k)
    dev = _check_cuda(name, wins + metas)
    return _run(fused_quantized_topk, "impact_q_topk", _Q_ARGTYPES, dev, B,
                n_docs, k, tuple(_ptr(t) for t in wins + metas),
                (B, Q, L, n_docs, k))


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


def quantized_index_windows(q_idx: torch.Tensor, q_val: torch.Tensor,
                            term_starts: torch.Tensor,
                            term_lens: torch.Tensor,
                            packed_vals: torch.Tensor, deltas: torch.Tensor,
                            term_lo: torch.Tensor, term_hi: torch.Tensor,
                            max_postings: int) -> Tuple[torch.Tensor, ...]:
    """The packed ``(B, Q, max_postings)`` windows and per-term columns
    K5's window entry takes: ``(byte_win, gap_win, starts, lens, qv, lo,
    step)``. Nothing is decoded here; ``step`` is computed once per term
    (``STEP_SCALE``)."""
    dev = deltas.device
    lane = torch.arange(max_postings, dtype=torch.int32, device=dev)
    qv = q_val.float()
    qi = term_rows(q_idx, term_starts.shape[0])
    starts = term_starts[qi]                               # (B, Q)
    lens = _gather_i32(term_lens, qi)                      # (B, Q)
    pos = (starts[:, :, None] + lane).clamp(0, deltas.shape[0] - 1).long()
    byte_win = packed_vals[pos >> 1].int()
    gap_win = _gather_i32(deltas, pos)
    lo = term_lo[qi].float()
    step = (term_hi[qi].float() - lo) * STEP_SCALE
    return (byte_win.contiguous(), gap_win.contiguous(), starts.contiguous(),
            lens.contiguous(), qv.contiguous(), lo.contiguous(),
            step.contiguous())


def fused_quantized_index_topk_plain(q_idx, q_val, term_starts, term_lens,
                                     packed_vals, deltas, term_lo, term_hi,
                                     *, n_docs: int, k: int
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5 in place: the windows' gather (as wide
    as the query's longest list), then the window entry's plain
    version."""
    return fused_quantized_topk_plain(
        *quantized_index_windows(q_idx, q_val, term_starts, term_lens,
                                 packed_vals, deltas, term_lo, term_hi,
                                 query_lanes(q_idx, term_lens)),
        n_docs=n_docs, k=k)


def _launch_q_index(q_idx, q_val, term_starts, term_lens, packed_vals,
                    deltas, term_lo, term_hi, n_docs, k):
    name = "fused_quantized_index_topk"
    query = (q_idx, q_val)
    cols = (term_starts, term_lens, term_lo, term_hi)
    posts = (packed_vals, deltas)
    if q_idx.dim() != 2 or q_val.shape != q_idx.shape:
        raise ValueError(f"{name}: q_idx {tuple(q_idx.shape)} and q_val "
                         f"{tuple(q_val.shape)} must both be (B, Q)")
    if (any(t.dim() != 1 for t in cols + posts)
            or any(t.shape != term_starts.shape for t in cols)
            or 2 * packed_vals.shape[0] < deltas.shape[0]):
        raise ValueError(f"{name}: term_starts/term_lens/term_lo/term_hi "
                         f"must be (V,), deltas (P,) and packed_vals "
                         f"(>= P / 2,)")
    if (q_idx.dtype != torch.int32 or q_val.dtype != torch.float32
            or term_starts.dtype != torch.int32
            or term_lens.dtype not in (torch.uint16, torch.int32)
            or term_lo.dtype != torch.float16
            or term_hi.dtype != torch.float16
            or packed_vals.dtype != torch.uint8
            or deltas.dtype not in (torch.uint8, torch.uint16)):
        raise ValueError(f"{name}: the kernel takes i32 q_idx, term_starts; "
                         f"f32 q_val; u16 or i32 term_lens; f16 term_lo, "
                         f"term_hi; u8 packed_vals; u8 or u16 deltas")
    if not all(t.is_contiguous() for t in query + cols + posts):
        raise ValueError(f"{name}: inputs must be contiguous")
    _check_k(name, n_docs, k)
    dev = _check_cuda(name, query + cols + posts)
    B, Q = q_idx.shape
    return _run(fused_quantized_index_topk, "impact_q_index_topk",
                _Q_INDEX_ARGTYPES, dev, B, n_docs, k,
                tuple(_ptr(t) for t in (q_idx, q_val, term_starts, term_lens,
                                        packed_vals, deltas, term_lo,
                                        term_hi)),
                (B, Q, term_starts.shape[0], deltas.shape[0],
                 packed_vals.shape[0], int(term_lens.dtype == torch.uint16),
                 deltas.element_size(), STEP_SCALE, n_docs, k))


def fused_quantized_index_topk(
    q_idx: torch.Tensor,         # (B, Q) i32 — vocab id of each query term
    q_val: torch.Tensor,         # (B, Q) f32 — its weight (<= 0: skipped)
    term_starts: torch.Tensor,   # (V,) i32 — the QuantizedIndex's arrays,
    term_lens: torch.Tensor,     # (V,) u16 or i32      as stored
    packed_vals: torch.Tensor,   # (ceil(P / 2),) u8 — two u4 codes a byte
    deltas: torch.Tensor,        # (P,) u8 or u16 — doc-id gaps
    term_lo: torch.Tensor,       # (V,) f16
    term_hi: torch.Tensor,       # (V,) f16
    *,
    n_docs: int,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 reading a ``QuantizedIndex`` in place (1.5 or 2.5 bytes a
    posting): the same result as ``fused_quantized_topk`` on the query's
    windows (``quantized_index_windows``), with no window built on the
    card. CPU tensors take the plain version."""
    if deltas.device.type == "cpu":
        return fused_quantized_index_topk_plain(
            q_idx, q_val, term_starts, term_lens, packed_vals, deltas,
            term_lo, term_hi, n_docs=n_docs, k=k)
    return _launch_q_index(q_idx, q_val, term_starts, term_lens, packed_vals,
                           deltas, term_lo, term_hi, n_docs, k)


fused_quantized_index_topk.launches = 0


def fused_window_bytes(B: int, Q: int, L: int, variant: str = "f32") -> int:
    """Device bytes of the gathered ``(B, Q, L)`` posting windows one
    window-entry call reads: ``"f32"`` (K4) f32 weights + i32 doc ids;
    ``"u4"`` (K5) i32 packed bytes + i32 gaps + five per-term columns."""
    if variant == "f32":
        return B * Q * L * (4 + 4)
    if variant == "u4":
        return B * Q * L * (4 + 4) + B * Q * 5 * 4
    raise ValueError(f"unknown fused variant {variant!r}")
