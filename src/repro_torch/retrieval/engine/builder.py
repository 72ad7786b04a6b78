"""Incremental index builder: online corpus growth without full rebuilds
(``repro/retrieval/engine/builder.py``).

``IndexBuilder`` keeps the served index live under three operations:

* ``add(reps)``    — append a batch of document rows. Buffered on the
                     host; the next ``flush()`` packs only the new rows
                     into a small **delta segment** (an ``InvertedIndex``
                     over the tail doc range). The **base segment** is
                     untouched.
* ``remove(ids)``  — tombstone documents by external id. A tombstone in
                     the base segment is applied at flush time by zeroing
                     the doc's postings (a mask, no re-sort) and its
                     forward row, and, for a quantized base, quantizing
                     again: the doc then scores 0 and its slot is
                     reclaimed at the next compaction. The per-term upper
                     bounds stay as they are: zeroing only lowers impacts,
                     so they still bound them.
* ``flush()``      — make pending adds/removes visible to ``search``.
                     When the delta outgrows ``merge_frac`` of the base,
                     or tombstones exceed ``compact_dead_frac`` of the
                     corpus, flush escalates to ``compact()``: one full
                     rebuild over the live rows.

``search`` scores base and delta independently, merges their top-k with
``merge_topk`` (ties to the base), and maps internal slots to stable
**external ids** (compaction renumbers slots, never external ids;
tombstoned slots and padding surface as -1). With ``quantize=True`` the
base segment is a ``QuantizedIndex`` and the hot delta stays raw; under
``method="auto"`` each segment resolves by its own size, so a base of at
least ``AUTO_FUSED_N`` docs is scored by K5 and a small delta by the
plain impact path, while ``method="fused"`` sends both to their kernels
(K5 and K4). With ``keep_forward=True`` both segments carry their forward
rows, so ``auto`` resolves each to the two-tier ``pruned`` method (K4's
ceiling entry); ``method="pruned"`` scores the delta with ``impact``. Every
mutation that can change what ``search`` returns bumps ``generation``.

``term_shards=n`` serves the base as a ``TermShardedIndex`` over ``n``
vocab ranges; ``plan=`` (a ``ShardPlan``) carries the topology instead: its
term axis sets the ranges, and a grid of both axes serves the base as a
``Shard2DIndex`` (a doc-only plan keeps the one-index base: doc sharding is
the serving mesh's concern). The delta stays a raw ``InvertedIndex``: the
``pruned``, ``quantized`` and sharded methods score it with ``impact``,
and ``fused`` with K4; ``pruned`` and ``fused`` on a sharded base go to the
base's sharded method (its own two-tier composition; margin 0 is its exact
path). A sharded base and ``quantize`` are exclusive.

The segments live on ``device`` (default ``cuda``); the row store and the
builds are host numpy, as in the JAX package. Not thread-safe; callers
serialize, as the serving loop does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.topk_score import merge_topk
from repro_torch.retrieval import score
from repro_torch.retrieval.engine.quantize import (QuantizedIndex,
                                                   quantize_index)
from repro_torch.retrieval.engine.shard2d import Shard2DIndex, shard2d_index
from repro_torch.retrieval.engine.term_sharded import (TermShardedIndex,
                                                       term_shard_index)
from repro_torch.retrieval.index import InvertedIndex, build_inverted_index
from repro_torch.retrieval.sparse_rep import (SparseRep, device_get,
                                              truncate_width)

# the methods a raw delta cannot serve: it is searched with "impact"
BASE_ONLY = ("pruned", "quantized", "sharded", "term_sharded", "shard2d")


def _host_rows(reps: SparseRep) -> Tuple[np.ndarray, np.ndarray]:
    host = device_get(reps)
    k = host.width
    v = np.asarray(host.values, np.float32).reshape(-1, k)
    i = np.asarray(host.indices, np.int32).reshape(-1, k)
    return v, i


class IndexBuilder:
    """Incremental add/remove/flush over an LSR corpus (see the module
    docstring)."""

    def __init__(self, vocab_size: int, *, quantize: bool = False,
                 keep_forward: bool = False, merge_frac: float = 0.25,
                 compact_dead_frac: float = 0.25, term_shards: int = 0,
                 plan=None, device: DeviceLike = None):
        # the plan's term axis sets term_shards; a grid of both axes makes
        # the base a Shard2DIndex
        self._grid = None
        if plan is not None:
            if term_shards:
                raise ValueError(
                    "pass either plan= or term_shards=, not both — "
                    "the plan carries the shard topology")
            if plan.doc_shards > 1 and plan.term_shards > 1:
                self._grid = (plan.doc_shards, plan.term_shards)
            else:
                term_shards = plan.term_shards if plan.term_shards > 1 else 0
        if (term_shards or self._grid) and quantize:
            raise ValueError(
                "sharded plans and quantize are exclusive — the base "
                "segment is either partitioned or compressed")
        self.plan = plan
        self.term_shards = term_shards
        self.vocab_size = vocab_size
        self.quantize = quantize
        self.keep_forward = keep_forward
        self.merge_frac = merge_frac
        self.compact_dead_frac = compact_dead_frac
        self.device = resolve_device(device)

        self._values: Optional[np.ndarray] = None    # (N, K) live rows
        self._indices: Optional[np.ndarray] = None   # (N, K)
        self._ext_ids = np.zeros(0, np.int64)        # slot -> external
        self._alive = np.zeros(0, bool)
        self._slot: Dict[int, int] = {}              # external -> slot
        self._next_ext = 0

        self._base: Union[InvertedIndex, QuantizedIndex, TermShardedIndex,
                          Shard2DIndex, None] = None
        self._base_raw: Union[InvertedIndex, TermShardedIndex, Shard2DIndex,
                              None] = None
        self._base_n = 0          # slots [0, _base_n) live in the base
        self._delta: Optional[InvertedIndex] = None
        self._delta_dirty = False      # adds/removes touching the tail
        self._base_removals: List[int] = []   # tombstoned base slots
        self.n_compactions = 0
        self.generation = 0

    # -- bookkeeping -----------------------------------------------------

    @property
    def n_slots(self) -> int:
        return self._ext_ids.shape[0]

    @property
    def n_alive(self) -> int:
        return int(self._alive.sum())

    @property
    def n_dead(self) -> int:
        return self.n_slots - self.n_alive

    @property
    def dirty(self) -> bool:
        return (self._delta_dirty or bool(self._base_removals)
                or (self._base is None and self.n_slots > 0))

    def stats(self) -> Dict[str, float]:
        """The JAX builder's stats."""
        return {
            "n_slots": self.n_slots,
            "n_alive": self.n_alive,
            "n_dead": self.n_dead,
            "base_docs": self._base_n,
            "delta_docs": self.n_slots - self._base_n,
            "n_compactions": self.n_compactions,
            "quantized_base": bool(self.quantize
                                   and self._base is not None),
            "term_shards": self.term_shards,
            "doc_shards": self._grid[0] if self._grid else 0,
            "grid_term_shards": self._grid[1] if self._grid else 0,
            "generation": self.generation,
        }

    def memory_bytes(self) -> int:
        """Approximate resident bytes: the host row store plus the served
        segments' ``memory_bytes``."""
        total = int(self._ext_ids.nbytes + self._alive.nbytes)
        if self._values is not None:
            total += int(self._values.nbytes + self._indices.nbytes)
        for seg in (self._base, self._delta):
            if seg is not None:
                total += int(seg.memory_bytes())
        return total

    # -- mutation --------------------------------------------------------

    def add(self, reps: SparseRep,
            ids: Optional[Sequence[int]] = None) -> np.ndarray:
        """Append a batch of document rows; returns their external ids
        (assigned in increasing order unless ``ids`` is given)."""
        v, i = _host_rows(reps)
        n = v.shape[0]
        if ids is None:
            ids = np.arange(self._next_ext, self._next_ext + n,
                            dtype=np.int64)
            self._next_ext += n
        else:
            ids = np.asarray(list(ids), np.int64)
            if ids.shape[0] != n:
                raise ValueError(f"{ids.shape[0]} ids for {n} rows")
            dup = [int(e) for e in ids if int(e) in self._slot]
            if dup:
                raise ValueError(f"duplicate external ids: {dup[:5]}")
            self._next_ext = max(self._next_ext, int(ids.max()) + 1)

        base_slot = self.n_slots
        if self._values is None:
            self._values, self._indices = v.copy(), i.copy()
        else:
            k_old, k_new = self._values.shape[1], v.shape[1]
            width = max(k_old, k_new)
            if k_old < width:
                pad = ((0, 0), (0, width - k_old))
                self._values = np.pad(self._values, pad)
                self._indices = np.pad(self._indices, pad)
            if k_new < width:
                pad = ((0, 0), (0, width - k_new))
                v, i = np.pad(v, pad), np.pad(i, pad)
            self._values = np.concatenate([self._values, v])
            self._indices = np.concatenate([self._indices, i])
        self._ext_ids = np.concatenate([self._ext_ids, ids])
        self._alive = np.concatenate([self._alive, np.ones(n, bool)])
        for off, e in enumerate(ids):
            self._slot[int(e)] = base_slot + off
        self._delta_dirty = True
        self.generation += 1
        return ids

    def remove(self, ids: Sequence[int]) -> int:
        """Tombstone documents by external id; unknown or already removed
        ids are ignored. Returns the number tombstoned. The external id is
        released at once: a later ``add`` may reuse it."""
        n = 0
        for e in ids:
            slot = self._slot.pop(int(e), None)
            if slot is None or not self._alive[slot]:
                continue
            self._alive[slot] = False
            if slot < self._base_n:
                self._base_removals.append(slot)
            else:
                self._delta_dirty = True
            n += 1
        if n:
            self.generation += 1
        return n

    # -- flush / compaction ----------------------------------------------

    def _tail_rep(self) -> SparseRep:
        v = self._values[self._base_n:].copy()
        i = self._indices[self._base_n:]
        v[~self._alive[self._base_n:]] = 0.0
        return SparseRep(v, i, (v > 0).sum(axis=1).astype(np.int32))

    def _pack_base(self, values: np.ndarray, indices: np.ndarray) -> None:
        rep = SparseRep(values, indices,
                        (values > 0).sum(axis=1).astype(np.int32))
        if self._grid is not None:
            d, t = self._grid
            # compaction can leave fewer live rows than planned chunks:
            # clamp rather than refuse to serve
            raw = shard2d_index(rep, self.vocab_size, min(d, values.shape[0]),
                                t, keep_forward=self.keep_forward,
                                device=self.device)
        elif self.term_shards:
            # postings_doc holds global slot ids on every shard, so the
            # tombstone flush zeroes them as on a one-index base
            raw = term_shard_index(rep, self.vocab_size, self.term_shards,
                                   keep_forward=self.keep_forward,
                                   device=self.device)
        else:
            raw = build_inverted_index(rep, self.vocab_size,
                                       keep_forward=self.keep_forward,
                                       device=self.device)
        self._base_raw = raw
        self._base = quantize_index(raw) if self.quantize else raw

    def compact(self) -> None:
        """Full rebuild over live rows: tombstoned slots are dropped,
        internal slots renumber, external ids are untouched."""
        keep = self._alive
        if self._values is not None:
            self._values = self._values[keep]
            self._indices = self._indices[keep]
        self._ext_ids = self._ext_ids[keep]
        self._alive = np.ones(self._ext_ids.shape[0], bool)
        self._slot = {int(e): s for s, e in enumerate(self._ext_ids)}
        self._base_n = self._ext_ids.shape[0]
        self._base_removals = []
        self._delta = None
        self._delta_dirty = False
        self.n_compactions += 1
        self.generation += 1
        if self._base_n:
            self._pack_base(self._values, self._indices)
        else:
            self._base = self._base_raw = None

    def flush(self, *, force_compact: bool = False) -> None:
        """Make pending adds/removes visible to ``search``.

        Cheap paths first: base tombstones are zeroed in place, adds
        rebuild only the delta segment. Escalates to ``compact()`` when
        the delta outgrows ``merge_frac`` of the base or dead slots exceed
        ``compact_dead_frac`` of the corpus.
        """
        if self.dirty or force_compact:
            self.generation += 1
        n_delta = self.n_slots - self._base_n
        needs_compact = (
            force_compact
            or (self.n_slots > 0
                and self.n_dead > self.compact_dead_frac * self.n_slots)
            or (self._base_n > 0
                and n_delta > self.merge_frac * self._base_n))
        if needs_compact:
            self.compact()
            return

        if self._base_removals and self._base_raw is not None:
            raw = self._base_raw
            if isinstance(raw, Shard2DIndex):
                # the cells hold chunk-local doc ids: the index remaps
                self._base_raw = raw.zero_docs(self._base_removals)
            else:
                # a one-index or term-sharded base: global slot ids
                dead = torch.as_tensor(
                    np.asarray(self._base_removals, np.int64),
                    device=raw.device)
                zeroed = torch.isin(raw.postings_doc.long(), dead)
                kw = {"postings_val": torch.where(zeroed, 0.0,
                                                  raw.postings_val)}
                if raw.doc_values is not None:
                    kw["doc_values"] = raw.doc_values.index_fill(0, dead,
                                                                 0.0)
                self._base_raw = dataclasses.replace(raw, **kw)
            self._base = (quantize_index(self._base_raw) if self.quantize
                          else self._base_raw)
            self._base_removals = []

        if self._base is None and self._base_n == 0 and self.n_slots:
            # first flush: everything becomes the base segment
            self._base_n = self.n_slots
            self._pack_base(self._values.copy(), self._indices)
            self._delta = None
            self._delta_dirty = False
            # zero tombstones that arrived before the first flush
            if not self._alive.all():
                self._base_removals = list(np.flatnonzero(~self._alive))
                self.flush()
            return

        if self._delta_dirty:
            tail = self._tail_rep()
            self._delta = (build_inverted_index(
                tail, self.vocab_size, keep_forward=self.keep_forward,
                device=self.device) if tail.values.shape[0] else None)
            self._delta_dirty = False

    # -- search ----------------------------------------------------------

    def _base_method(self, method: str) -> str:
        """The method the base segment is scored with (before ``auto``
        resolves): a term-sharded or 2D base serves ``pruned`` through its
        own two-tier composition and ``fused`` through its exact path (no
        kernel reads a sharded index), so both go to its sharded
        method."""
        if method in ("pruned", "fused"):
            if self._grid is not None:
                return "shard2d"
            if self.term_shards:
                return "term_sharded"
        return method

    def resolved_method(self, method: str = "auto") -> str:
        """The method ``search(method=...)`` scores the base segment with
        (the delta's if there is no base)."""
        if self._base is not None:
            return score.resolve_method(self._base_method(method),
                                        self._base)
        if method != "auto":
            return score.resolve_method(method, None)
        if self._delta is not None:
            return score.resolve_method("auto", self._delta)
        return "impact"

    def _check_search_kwargs(self, method: str, kw: dict) -> str:
        """The dispatcher's kwarg check, as ``TypeError`` naming the
        resolved method: names no method takes, and names the resolved
        method does not accept (``score.METHOD_KWARGS``; a None value
        counts as not passed). Returns the resolved method."""
        resolved = self.resolved_method(method)
        every = frozenset().union(*score.METHOD_KWARGS.values())
        allowed = score.METHOD_KWARGS.get(resolved, frozenset())
        unknown = sorted(n for n in kw if n not in every)
        stray = sorted(n for n, v in kw.items()
                       if n in every and v is not None and n not in allowed)
        if unknown or stray:
            what = []
            if unknown:
                what.append(f"unknown kwargs {', '.join(unknown)}")
            if stray:
                what.append(f"kwargs {', '.join(stray)} that "
                            f"method={resolved!r} does not accept")
            raise TypeError(
                f"search(method={method!r}) resolved to {resolved!r}: "
                + "; ".join(what) + " (accepted: "
                + (f"{sorted(allowed)}" if allowed else "no tuning kwargs")
                + ")")
        return resolved

    def search(self, queries: SparseRep, k: int = 10, *,
               method: str = "auto", q_width: Optional[int] = None,
               base_scorer: Optional[Callable] = None,
               **kw) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k over base + delta; returns host ``(vals (B, k) f32, ids
        (B, k) int64)`` with **external** doc ids (-1 marks padding below
        the top-k and tombstoned slots). Flushes pending mutations first.

        ``q_width`` truncates the queries to their ``q_width`` largest
        terms (the serving degrade ladder's knob); the other keywords
        (``prune_margin``, ``candidates``) go to ``retrieve`` for the base
        segment once ``_check_search_kwargs`` has let them through.

        ``base_scorer`` is the serving frontier's hot-window seam
        (``runtime/frontier/caches``): called as ``base_scorer(queries,
        base, k_base, resolved, kw)`` before ``retrieve`` on the base
        segment; a ``None`` return declines and the normal dispatch runs.
        """
        if q_width is not None:
            queries = truncate_width(queries, q_width)
        if self.dirty:
            self.flush()
        resolved = self._check_search_kwargs(method, kw)
        if self.n_slots == 0 or (self._base is None and self._delta is None):
            b = queries.values.reshape(-1, queries.width).shape[0]
            return (np.full((b, k), -np.inf, np.float32),
                    np.full((b, k), -1, np.int64))

        parts = []   # (vals (B, k'), internal slots (B, k'))
        if self._base is not None:
            k_base = min(k, self._base.n_docs)
            out = None
            if base_scorer is not None:
                out = base_scorer(queries, self._base, k_base, resolved,
                                  dict(kw))
            if out is None:
                out = score.retrieve(queries, self._base, k_base,
                                     method=self._base_method(method), **kw)
            parts.append(out)
        if self._delta is not None:
            # the delta is always a raw InvertedIndex: the base-only
            # methods fall back to exact impact scoring
            dm = "impact" if method in BASE_ONLY else method
            dv, di = score.retrieve(queries, self._delta,
                                    min(k, self._delta.n_docs), method=dm)
            parts.append((dv, di + self._base_n))

        vals, idx = parts[0]
        for nv, ni in parts[1:]:
            vals, idx = merge_topk(vals, idx, nv, ni,
                                   min(k, vals.shape[1] + nv.shape[1]))
        vals = vals.cpu().numpy()
        idx = idx.cpu().numpy()
        if vals.shape[1] < k:
            pad = ((0, 0), (0, k - vals.shape[1]))
            vals = np.pad(vals, pad, constant_values=-np.inf)
            idx = np.pad(idx, pad, constant_values=-1)

        ext = np.full(idx.shape, -1, np.int64)
        ok = idx >= 0
        slots = np.clip(idx, 0, self.n_slots - 1)
        ext[ok] = self._ext_ids[slots][ok]
        ext[ok & ~self._alive[slots]] = -1      # tombstoned slots
        return vals, ext
