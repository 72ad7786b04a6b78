"""Posting-list compression: u4 impacts + delta-encoded doc ids
(``repro/retrieval/engine/quantize.py``).

A raw posting costs 8 bytes (i32 doc id + f32 impact); the quantized
layout stores it in 1.5 (u8 deltas) or 2.5 (u16 deltas) bytes:

* **Impacts: nibble-packed u4, per-term affine.** ``val ~= lo[t] + (q - 1)
  * (hi[t] - lo[t]) / 14`` with q in 1..15; code 0 marks a phantom. Two
  codes pack per byte, the even posting in the low nibble. ``lo``/``hi``
  are stored f16, and the build quantizes against the f16-rounded bounds,
  so build and scorer agree exactly.
* **Doc ids: gaps with escape phantoms.** The first posting of a term
  stores its absolute id; a gap g above the delta type's escape E becomes
  ``g // E`` phantom postings (delta E, code 0) before the real posting's
  ``g % E``. The scorer's running sum passes through phantoms, which weigh
  exactly 0. The build picks u8 or u16 deltas, whichever stores fewer
  bytes.

``quantize_index`` is the JAX package's host numpy build, copied: the same
arrays bit for bit, dtypes included, then moved to the index's device.
uint16 arrays (``deltas``, ``term_lens`` of short lists) keep their dtype,
since ``memory_bytes`` counts it; the scorers gather them through their
int16 view (PyTorch implements few operators for uint16 on the card).

Scoring: ``quantized_retrieve`` (the ``"quantized"`` method) decodes the
windows in plain PyTorch and scatters them into dense ``(B, N)`` scores on
every device, as the JAX package leaves it to XLA; ``fused_quantized_
retrieve`` hands the query and the index's arrays as stored to K5
(``kernels/impact_score.fused_quantized_index_topk``), which reads each
query term's packed postings in place, decodes, scores and keeps the
top-k without windows or the ``(B, N)`` matrix (on the CPU its plain
version: the windows, the decode and a dense scatter).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels.impact_score import (U4_LEVELS,
                                              decode_quantized_windows,
                                              fused_quantized_index_topk,
                                              quantized_index_windows,
                                              scatter_scores)
from repro_torch.kernels.topk_score import topk_rows
from repro_torch.retrieval.index import InvertedIndex
from repro_torch.retrieval.sparse_rep import SparseRep, query_columns

_DELTA_DTYPES = ((np.uint8, 255), (np.uint16, 65535))  # (dtype, escape)


@dataclasses.dataclass(frozen=True)
class QuantizedIndex:
    term_starts: torch.Tensor   # (V,) i32 — offsets in *postings* units
    term_lens: torch.Tensor     # (V,) u16/i32 — expanded list lengths
    packed_vals: torch.Tensor   # (ceil(P/2),) u8 — two u4 codes per byte
    deltas: torch.Tensor        # (P,) u8/u16 — doc-id gaps (max = escape)
    term_lo: torch.Tensor       # (V,) f16 — affine low per term
    term_hi: torch.Tensor       # (V,) f16 — affine high per term
    n_docs: int
    vocab_size: int
    max_postings: int           # longest *expanded* list (>= 1)
    n_source_postings: int      # postings before phantom expansion

    @property
    def device(self) -> torch.device:
        return self.deltas.device

    @property
    def n_postings(self) -> int:
        return self.deltas.shape[0]

    def memory_bytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in (
            self.term_starts, self.term_lens, self.packed_vals, self.deltas,
            self.term_lo, self.term_hi))

    def stats(self) -> Dict[str, float]:
        return {
            "n_docs": self.n_docs,
            "vocab_size": self.vocab_size,
            "n_postings": self.n_postings,
            "n_source_postings": self.n_source_postings,
            "phantom_frac": 1.0 - self.n_source_postings
            / max(self.n_postings, 1),
            "max_postings": self.max_postings,
            "memory_bytes": self.memory_bytes(),
        }


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor of the index as a host numpy array of the same dtype."""
    if t.dtype == torch.uint16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _put(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).to(device).view(
            torch.uint16)
    return torch.from_numpy(a).to(device)


def quantize_index(index: InvertedIndex) -> QuantizedIndex:
    """Compress an ``InvertedIndex`` (host-side numpy build); the result
    lies on the index's device."""
    V = index.vocab_size
    starts = to_numpy(index.term_starts).astype(np.int64)
    lens = to_numpy(index.term_lens).astype(np.int64)
    docs = to_numpy(index.postings_doc).astype(np.int64)
    vals = to_numpy(index.postings_val).astype(np.float32)
    has_real = lens.sum() > 0

    # per-term affine bounds over the source impacts, f16-rounded so the
    # scorer's decode matches the build's encode exactly
    term_of = np.repeat(np.arange(V), lens)          # (P_real,)
    real = slice(0, term_of.shape[0])
    lo = np.full(V, np.inf, np.float32)
    hi = np.zeros(V, np.float32)
    if has_real:
        np.minimum.at(lo, term_of, vals[real])
        np.maximum.at(hi, term_of, vals[real])
    lo[~np.isfinite(lo)] = 0.0
    lo16 = lo.astype(np.float16)
    hi16 = hi.astype(np.float16)
    lo_r = lo16.astype(np.float32)
    # the build divides, as the reference's numpy build does; the scorers
    # multiply by kernels/impact_score.STEP_SCALE, as XLA computes the
    # reference's division under jit
    step = (hi16.astype(np.float32) - lo_r) / U4_LEVELS

    # u4 codes (1..15) for real postings
    if has_real:
        s = step[term_of]
        q = np.where(s > 0,
                     np.rint((vals[real] - lo_r[term_of])
                             / np.where(s > 0, s, 1.0)),
                     0.0)
        codes = (1 + np.clip(q, 0, U4_LEVELS)).astype(np.uint8)
    else:
        codes = np.ones(0, np.uint8)

    # doc-id gaps (reset at term boundaries; first gap = absolute id)
    gaps = np.empty(term_of.shape[0], np.int64)
    if has_real:
        d = docs[real]
        gaps[:] = d
        gaps[1:] -= d[:-1]
        first = starts[lens > 0]
        gaps[first] = d[first]

    # escape expansion: gap = escape * m + r -> m phantoms + the real entry,
    # at the delta width that stores the fewest bytes
    def posting_bytes(dtype, escape):
        n = int((1 + gaps // escape).sum()) if has_real else 1
        return n * (np.dtype(dtype).itemsize + 0.5)

    dtype, escape = min(_DELTA_DTYPES, key=lambda de: posting_bytes(*de))
    m = gaps // escape
    counts = (1 + m).astype(np.int64)
    Pq = int(counts.sum()) if has_real else 1
    out_deltas = np.full(Pq, escape, dtype)
    out_codes = np.zeros(Pq, np.uint8)
    new_lens = np.zeros(V, np.int64)
    if has_real:
        real_pos = np.cumsum(counts) - 1
        out_deltas[real_pos] = (gaps % escape).astype(dtype)
        out_codes[real_pos] = codes
        np.add.at(new_lens, term_of, counts)
    else:
        out_deltas[0] = 0
    new_starts = np.zeros(V, np.int64)
    np.cumsum(new_lens[:-1], out=new_starts[1:])

    # nibble-pack: even posting -> low nibble, odd -> high
    padded = np.zeros(Pq + (Pq & 1), np.uint8)
    padded[:Pq] = out_codes
    packed = (padded[0::2] | (padded[1::2] << 4)).astype(np.uint8)

    lens_dtype = np.uint16 if new_lens.max(initial=0) < 2**16 else np.int32
    dev = index.device
    return QuantizedIndex(
        term_starts=_put(new_starts.astype(np.int32), dev),
        term_lens=_put(new_lens.astype(lens_dtype), dev),
        packed_vals=_put(packed, dev),
        deltas=_put(out_deltas, dev),
        term_lo=_put(lo16, dev),
        term_hi=_put(hi16, dev),
        n_docs=index.n_docs,
        vocab_size=index.vocab_size,
        max_postings=max(int(new_lens.max(initial=0)), 1),
        n_source_postings=int(lens.sum()),
    )


def _fused_q_windows(queries: SparseRep, index: QuantizedIndex
                     ) -> Tuple[torch.Tensor, ...]:
    """The packed ``(B, Q, max_postings)`` windows and per-term columns
    K5's window entry takes: ``(byte_win, gap_win, starts, lens, qv, lo,
    step)``. Nothing is decoded here; ``step`` is computed once per term
    (``STEP_SCALE``).
    """
    return quantized_index_windows(*query_columns(queries, index.device),
                                   *_index_arrays(index),
                                   index.max_postings)


def _index_arrays(index: QuantizedIndex) -> Tuple[torch.Tensor, ...]:
    return (index.term_starts, index.term_lens, index.packed_vals,
            index.deltas, index.term_lo, index.term_hi)


def quantized_scores(queries: SparseRep, index: QuantizedIndex
                     ) -> torch.Tensor:
    """Dense ``(B, n_docs)`` scores, decoding the windows on the fly (the
    ``"quantized"`` method's scores), summed one query term at a time, as
    K5's plain version sums them (the same bits on every run)."""
    w, docs = decode_quantized_windows(*_fused_q_windows(queries, index))
    B, _, L = w.shape
    return scatter_scores(w.reshape(B, -1), docs.reshape(B, -1),
                          index.n_docs, L)


def quantized_retrieve(queries: SparseRep, index: QuantizedIndex,
                       k: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the compressed index: ``(vals (B, k') f32, idx (B, k')
    i32)`` with ``k' = min(k, n_docs)``, ties to the lowest doc id."""
    return topk_rows(quantized_scores(queries, index), min(k, index.n_docs))


def fused_quantized_retrieve(queries: SparseRep, index: QuantizedIndex,
                             k: int = 10
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k through K5 (its plain version on CPU): the same ids as
    ``quantized_retrieve`` (the decode is exact against the same
    f16-rounded bounds)."""
    return fused_quantized_index_topk(
        *query_columns(queries, index.device), *_index_arrays(index),
        n_docs=index.n_docs, k=min(k, index.n_docs))
