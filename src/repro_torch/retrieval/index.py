"""Inverted impact index over SparseReps (``repro/retrieval/index.py``).

Padded CSC over the vocabulary, flattened into four arrays::

    term_starts  (V,) i32  — offset of each term's postings
    term_lens    (V,) i32  — posting-list length per term
    postings_doc (P,) i32  — doc ids, grouped by term, ascending per term
    postings_val (P,) f32  — impact weights, same order

plus ``n_docs``, ``vocab_size`` and ``max_postings`` (the longest list:
the static gather width of the scorers). The build is host-side numpy,
as in the JAX package, and the arrays are then moved to the device.

The engine extensions of the JAX index:

* ``term_ubs`` (V,) f32 — each term's largest impact (0 for a term with
  no postings): the ceilings of the two-tier pruned scorer
  (``engine/pruning``). Built unless ``with_upper_bounds=False``.
* ``doc_values`` / ``doc_indices`` (N, K) — the forward rows the index was
  built from, kept with ``keep_forward=True``: the pruned scorer rescores
  its candidates from them.

``vocab_range=(lo, hi)`` builds a term shard: the terms of ``[lo, hi)``
only, remapped to ``t - lo``, with global doc ids (the term-sharded and
2D engines, ``engine/term_sharded``, ``engine/shard2d``).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.retrieval.sparse_rep import SparseRep, device_get

# warn when one posting list covers more than this fraction of the corpus
# (every query gather is padded to max_postings)
STOPWORD_WARN_FRAC = 0.5


@dataclasses.dataclass(frozen=True)
class InvertedIndex:
    term_starts: torch.Tensor     # (V,) i32
    term_lens: torch.Tensor       # (V,) i32
    postings_doc: torch.Tensor    # (P,) i32
    postings_val: torch.Tensor    # (P,) f32
    n_docs: int
    vocab_size: int
    max_postings: int             # longest posting list (>= 1)
    term_ubs: Optional[torch.Tensor] = None      # (V,) f32 max impact/term
    doc_values: Optional[torch.Tensor] = None    # (N, K) f32 forward rows
    doc_indices: Optional[torch.Tensor] = None   # (N, K) i32
    # (p50, p90, p99, max) posting lengths over active terms
    posting_percentiles: Tuple[float, ...] = ()

    @property
    def device(self) -> torch.device:
        return self.postings_doc.device

    @property
    def n_postings(self) -> int:
        return self.postings_doc.shape[0]

    @property
    def has_upper_bounds(self) -> bool:
        return self.term_ubs is not None

    @property
    def has_forward(self) -> bool:
        return self.doc_values is not None and self.doc_indices is not None

    def memory_bytes(self) -> int:
        """Index footprint (compare with ``n_docs * vocab_size * 4``): every
        stored array, the upper bounds and forward rows included."""
        arrays = [self.term_starts, self.term_lens, self.postings_doc,
                  self.postings_val]
        arrays += [a for a in (self.term_ubs, self.doc_values,
                               self.doc_indices) if a is not None]
        return sum(a.numel() * a.element_size() for a in arrays)

    def stats(self) -> Dict[str, float]:
        lens = self.term_lens.cpu().numpy()
        active = lens > 0
        out = {
            "n_docs": self.n_docs,
            "vocab_size": self.vocab_size,
            "n_postings": self.n_postings,
            "active_terms": int(active.sum()),
            "max_postings": self.max_postings,
            "mean_postings": float(lens[active].mean()) if active.any()
            else 0.0,
            "memory_bytes": self.memory_bytes(),
        }
        for name, v in zip(("p50", "p90", "p99", "max"),
                           self.posting_percentiles):
            out[f"postings_{name}"] = v
        return out


def _posting_percentiles(lens: np.ndarray) -> Tuple[float, ...]:
    active = lens[lens > 0]
    if active.size == 0:
        return (0.0, 0.0, 0.0, 0.0)
    p50, p90, p99 = np.percentile(active, (50, 90, 99))
    return (float(p50), float(p90), float(p99), float(active.max()))


def build_inverted_index(reps: SparseRep, vocab_size: int, *,
                         keep_forward: bool = False,
                         with_upper_bounds: bool = True,
                         stopword_warn_frac: float = STOPWORD_WARN_FRAC,
                         vocab_range: Optional[Tuple[int, int]] = None,
                         device: DeviceLike = None) -> InvertedIndex:
    """Build the index from a batched ``(N, K)`` corpus rep.

    Active slots (``value > 0``) become (term, doc, impact) triples,
    stably sorted by term so each posting list is in doc order. An empty
    corpus still yields one zero-impact posting, so the scorers' shapes
    never degenerate. Warns, with the posting-length percentiles, when
    the longest list covers more than ``stopword_warn_frac`` of the docs.
    ``with_upper_bounds`` stores each term's largest impact
    (``term_ubs``); ``keep_forward=True`` also stores the ``(N, K)``
    forward rows, which the pruned scorer rescores from.

    ``vocab_range=(lo, hi)`` builds a term shard: only the terms of ``[lo,
    hi)``, remapped to local ids ``t - lo``, and ``vocab_size`` ``hi -
    lo``; doc ids stay global (every term shard scores the whole corpus).
    It excludes ``keep_forward``: forward rows carry global term ids (the
    term-sharded index stores them once).
    """
    dev = resolve_device(device)
    host = device_get(reps)
    k = host.width
    v = np.asarray(host.values, np.float32).reshape(-1, k)
    i = np.asarray(host.indices, np.int32).reshape(-1, k)
    n_docs = v.shape[0]

    active = v > 0
    terms = i[active]
    if (terms < 0).any() or (terms >= vocab_size).any():
        raise ValueError(
            f"build_inverted_index: term ids outside [0, {vocab_size})")
    vals = v[active]
    docs = np.broadcast_to(np.arange(n_docs, dtype=np.int32)[:, None],
                           i.shape)[active]
    if vocab_range is not None:
        lo, hi = vocab_range
        if not 0 <= lo < hi <= vocab_size:
            raise ValueError(
                f"vocab_range {vocab_range} outside [0, {vocab_size})")
        if keep_forward:
            raise ValueError(
                "vocab_range is incompatible with keep_forward — forward "
                "rows carry global term ids (store them once on the "
                "term-sharded index instead)")
        sel = (terms >= lo) & (terms < hi)
        terms, vals, docs = terms[sel] - lo, vals[sel], docs[sel]
        vocab_size = hi - lo

    order = np.argsort(terms, kind="stable")
    terms, vals, docs = terms[order], vals[order], docs[order]
    lens = np.bincount(terms, minlength=vocab_size).astype(np.int32)
    starts = np.zeros(vocab_size, np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    ubs = np.zeros(vocab_size, np.float32)
    if terms.size:
        np.maximum.at(ubs, terms, vals)
    if terms.size == 0:
        docs = np.zeros(1, np.int32)
        vals = np.zeros(1, np.float32)

    pct = _posting_percentiles(lens)
    max_postings = max(int(lens.max(initial=0)), 1)
    if n_docs and max_postings > stopword_warn_frac * n_docs:
        warnings.warn(
            f"build_inverted_index: longest posting list covers "
            f"{max_postings}/{n_docs} docs (> {stopword_warn_frac:.0%} "
            f"of the corpus) — a stopword-like term pads every query "
            f"gather to ~N. Posting-length percentiles (active terms): "
            f"p50={pct[0]:.0f} p90={pct[1]:.0f} p99={pct[2]:.0f} "
            f"max={pct[3]:.0f}.", UserWarning, stacklevel=2)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    return InvertedIndex(
        term_starts=put(starts, np.int32),
        term_lens=put(lens, np.int32),
        postings_doc=put(docs, np.int32),
        postings_val=put(vals, np.float32),
        n_docs=n_docs, vocab_size=vocab_size, max_postings=max_postings,
        term_ubs=put(ubs, np.float32) if with_upper_bounds else None,
        doc_values=put(v, np.float32) if keep_forward else None,
        doc_indices=put(i, np.int32) if keep_forward else None,
        posting_percentiles=pct)
