"""Serving-frontier caches: query results and hot posting windows
(``repro/runtime/frontier/caches.py``).

Skewed query popularity dominates LSR serving traffic, so the frontier in
front of ``CorpusEngine`` remembers work: a repeated query costs a hash
look-up, and the heaviest terms' posting windows stay pinned on the card
instead of being gathered from the index per query. One hard invariant:

**Cache-on is bit for bit cache-off.** Both caches get there by
construction, not by tolerance:

* ``QueryResultCache``: a bounded, byte-accounted LRU over final search
  results ``(vals (k,), ext_ids (k,))``, host numpy. The key is the exact
  f32/i32 bytes of the query row's active prefix, the search kwargs, the
  corpus tag and the index **generation**, digested as the JAX package
  digests them (the same keys for the same row). ``IndexBuilder`` bumps
  its generation on every visible mutation (add, remove, a dirty flush,
  compact), so a stale entry never matches again; ``invalidate()``
  reclaims the dead entries' bytes eagerly.
* ``HotPostingCache``: pins the windows of the terms with the longest
  posting lists (docs and raw impacts padded to the index's
  ``max_postings``) until ``capacity_bytes`` is spent, as the JAX cache
  pins them. The pinned rows live on the index's device, one ``(n_pinned,
  max_postings)`` tensor of doc ids and one of impacts, with a term → row
  map; there is no host mirror of the postings. ``ensure()`` rebuilds on
  a new index object or generation, so a stale window is never served.

``hot_fused_retrieve`` builds the ``(B, Q * max_postings)`` windows of
``kernels/impact_score.index_windows`` lane for lane (valid lanes, inside
the list and ``qv > 0``, carry ``postings_val * qv`` as one f32 multiply;
the others weight 0 and doc 0), hot terms from the pinned rows and the
rest from the index, in a few device operations for the whole batch, and
scores them with K4's window entry ``fused_impact_topk``. A query id
outside ``[0, V)`` reads the term ``impact_score.term_rows`` gives it, as
the port's ``fused`` does (the JAX hot path indexes its host arrays with
the raw id, and raises for an id at or past V). ``CachedEngine`` wires
both caches over a ``CorpusEngine``: row-level result look-ups (a batch
with 3 hits scores only its 2 misses, in one search), generation-driven
invalidation, and the ``base_scorer`` seam of ``IndexBuilder.search`` for
the hot windows.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.impact_score import (fused_impact_topk,
                                              index_windows, term_rows)
from repro_torch.retrieval.index import InvertedIndex
from repro_torch.retrieval.sparse_rep import (SparseRep, device_get,
                                              split_rows, stack_rows)

__all__ = [
    "ENTRY_OVERHEAD_BYTES",
    "QueryResultCache",
    "HotPostingCache",
    "CachedEngine",
    "query_cache_key",
    "hot_fused_retrieve",
    "hot_windows",
]

# fixed per-entry overhead charged on top of the payload arrays (key
# digest + OrderedDict node + entry record, order of magnitude)
ENTRY_OVERHEAD_BYTES = 128


def query_cache_key(row: SparseRep, k: int, kwargs: Mapping[str, Any],
                    tag: str, generation: int,
                    decimals: Optional[int] = None) -> bytes:
    """Digest of one query row and everything else that can change its
    result: blake2b (16 bytes) over the active prefix's f32 values and
    i32 ids, then ``repr`` of ``(k, tag, generation, sorted non-None
    kwargs)``. Two rows differing only in padding width hash the same.
    ``decimals`` rounds the values first (off in the serving stack: two
    near-equal queries would share one entry)."""
    host = device_get(row)
    v = np.asarray(host.values, np.float32).reshape(-1)
    i = np.asarray(host.indices, np.int32).reshape(-1)
    n = int(np.asarray(host.nnz).reshape(-1)[0])
    v, i = v[:n], i[:n]
    if decimals is not None:
        v = np.round(v, decimals).astype(np.float32)
    h = hashlib.blake2b(digest_size=16)
    h.update(v.tobytes())
    h.update(i.tobytes())
    meta = (int(k), str(tag), int(generation),
            tuple(sorted((name, repr(val)) for name, val in kwargs.items()
                         if val is not None)))
    h.update(repr(meta).encode())
    return h.digest()


@dataclasses.dataclass
class _Entry:
    tag: str
    generation: int
    vals: np.ndarray
    ids: np.ndarray
    nbytes: int


class QueryResultCache:
    """Bounded byte-accounted LRU over per-row search results.

    ``get``/``put`` move entries to the MRU end; inserts evict from the LRU
    end until the payload fits ``capacity_bytes``. Entries carry a corpus
    tag and generation so one tenant's mutation invalidates only its own
    entries (``invalidate(tag, live_generation)``).
    """

    def __init__(self, capacity_bytes: int):
        if capacity_bytes <= 0:
            raise ValueError(
                f"capacity_bytes must be positive, got {capacity_bytes}")
        self.capacity_bytes = int(capacity_bytes)
        self._entries: "collections.OrderedDict[bytes, _Entry]" = \
            collections.OrderedDict()
        self.bytes_used = 0
        self.counters: collections.Counter = collections.Counter()

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: bytes) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        e = self._entries.get(key)
        if e is None:
            self.counters["misses"] += 1
            return None
        self._entries.move_to_end(key)
        self.counters["hits"] += 1
        # copies: a caller mutating its result must not poison the cache
        return e.vals.copy(), e.ids.copy()

    def put(self, key: bytes, tag: str, generation: int,
            vals: np.ndarray, ids: np.ndarray) -> None:
        vals = np.asarray(vals)
        ids = np.asarray(ids)
        nbytes = int(vals.nbytes + ids.nbytes) + ENTRY_OVERHEAD_BYTES
        if nbytes > self.capacity_bytes:
            self.counters["oversize_skipped"] += 1
            return
        old = self._entries.pop(key, None)
        if old is not None:
            self.bytes_used -= old.nbytes
        self._entries[key] = _Entry(str(tag), int(generation), vals.copy(),
                                    ids.copy(), nbytes)
        self.bytes_used += nbytes
        while self.bytes_used > self.capacity_bytes and self._entries:
            _, victim = self._entries.popitem(last=False)
            self.bytes_used -= victim.nbytes
            self.counters["evictions"] += 1

    def invalidate(self, tag: str, live_generation: int) -> int:
        """Reclaim every entry of ``tag`` whose generation is not the live
        one. Returns the number invalidated."""
        dead = [k for k, e in self._entries.items()
                if e.tag == tag and e.generation != live_generation]
        for k in dead:
            e = self._entries.pop(k)
            self.bytes_used -= e.nbytes
        self.counters["invalidations"] += len(dead)
        return len(dead)

    def stats(self) -> Dict[str, Any]:
        c = self.counters
        looked = c["hits"] + c["misses"]
        return {
            "entries": len(self._entries),
            "bytes_used": self.bytes_used,
            "capacity_bytes": self.capacity_bytes,
            "hits": c["hits"],
            "misses": c["misses"],
            "hit_rate": round(c["hits"] / looked, 4) if looked else 0.0,
            "evictions": c["evictions"],
            "invalidations": c["invalidations"],
        }


class HotPostingCache:
    """Pinned posting windows of the heaviest terms of one index.

    ``ensure(index, generation)`` (re)builds against that index: terms
    ranked by posting-list length (a stable descending sort of the
    ``(V,)`` lengths, the only host copy), the first ones pinned, each
    charged ``max_postings * 8 + ENTRY_OVERHEAD_BYTES``, until the next
    would pass ``capacity_bytes``, a term has no postings, or ``top_m``
    are pinned. The pinned rows are gathered on the index's device in one
    step. ``window(term)`` serves a pinned row or ``None`` (counted as a
    hit or a miss); ``hot_fused_retrieve`` counts its slots the same way.
    A rebuild that drops pins counts an invalidation.
    """

    def __init__(self, capacity_bytes: int, *, top_m: int = 1 << 30):
        if capacity_bytes <= 0:
            raise ValueError(
                f"capacity_bytes must be positive, got {capacity_bytes}")
        self.capacity_bytes = int(capacity_bytes)
        self.top_m = int(top_m)
        self.counters: collections.Counter = collections.Counter()
        self.bytes_pinned = 0
        self.generation: Optional[int] = None
        self._index_ref: Optional[int] = None
        self._l_max = 1
        self._terms = np.zeros(0, np.int64)      # pinned term ids, by rank
        self._row_of = np.zeros(0, np.int64)     # (V,) term -> row, or -1
        self._docs: Optional[torch.Tensor] = None   # (n_pinned, L) i32
        self._vals: Optional[torch.Tensor] = None   # (n_pinned, L) f32

    @property
    def pinned_terms(self) -> int:
        return int(self._terms.shape[0])

    def ensure(self, index: InvertedIndex, generation: int) -> None:
        """Make the cache current for ``(index, generation)``; a no-op
        when it already is."""
        if self.generation == generation and self._index_ref == id(index):
            return
        if self.pinned_terms:
            self.counters["invalidations"] += 1
        self.counters["rebuilds"] += 1
        self.generation = generation
        self._index_ref = id(index)
        self._l_max = L = int(index.max_postings)
        lens = index.term_lens.cpu().numpy().astype(np.int64)
        per_window = L * (4 + 4) + ENTRY_OVERHEAD_BYTES
        order = np.argsort(-lens, kind="stable")[:self.top_m]
        empty = np.flatnonzero(lens[order] == 0)
        n = min(order.shape[0], self.capacity_bytes // per_window,
                int(empty[0]) if empty.size else order.shape[0])
        self._terms = order[:n]
        self.bytes_pinned = n * per_window
        self._row_of = np.full(lens.shape[0], -1, np.int64)
        self._row_of[self._terms] = np.arange(n)
        dev = index.device
        terms = torch.from_numpy(self._terms).to(dev)
        lane = torch.arange(L, device=dev)
        pos = index.term_starts[terms].long()[:, None] + lane
        valid = lane < index.term_lens[terms][:, None]
        pos = pos.clamp(0, index.n_postings - 1)
        self._docs = torch.where(valid, index.postings_doc[pos], 0)
        self._vals = torch.where(valid, index.postings_val[pos], 0.0)

    def window(self, term: int) -> Optional[Tuple[torch.Tensor,
                                                  torch.Tensor]]:
        """Term ``term``'s pinned ``(docs (L,), vals (L,))``, or None."""
        t = int(term)
        row = self._row_of[t] if 0 <= t < self._row_of.shape[0] else -1
        if row < 0:
            self.counters["misses"] += 1
            return None
        self.counters["hits"] += 1
        return self._docs[row], self._vals[row]

    def stats(self) -> Dict[str, Any]:
        c = self.counters
        looked = c["hits"] + c["misses"]
        return {
            "pinned_terms": self.pinned_terms,
            "bytes_pinned": self.bytes_pinned,
            "capacity_bytes": self.capacity_bytes,
            "hits": c["hits"],
            "misses": c["misses"],
            "hit_rate": round(c["hits"] / looked, 4) if looked else 0.0,
            "rebuilds": c["rebuilds"],
            "invalidations": c["invalidations"],
        }


def hot_windows(queries: SparseRep, index: InvertedIndex, *,
                hot: HotPostingCache) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flat ``(B, Q * max_postings)`` weight/doc windows of
    ``index_windows(..., index.max_postings)``, bit for bit, on the
    index's device: each valid slot (``qv > 0``) of a pinned term from
    its pinned row, the other valid slots gathered from the index,
    invalid slots zero (doc 0). Counts one hot-cache look-up a valid
    slot. ``hot`` must be current for ``index`` (``ensure``)."""
    host = device_get(queries)
    width = host.width
    qv = np.asarray(host.values, np.float32).reshape(-1, width)
    qi = np.asarray(host.indices, np.int32).reshape(-1, width)
    B, L, dev = qv.shape[0], hot._l_max, index.device
    valid = (qv > 0).reshape(-1)
    rows = hot._row_of[term_rows(torch.from_numpy(qi),
                                 index.term_lens.shape[0]).numpy().ravel()]
    hot_slots = np.flatnonzero(valid & (rows >= 0))
    cold_slots = np.flatnonzero(valid & (rows < 0))
    hot.counters["hits"] += hot_slots.size
    hot.counters["misses"] += cold_slots.size
    # one copy to the device: the slots, their pinned rows, ids and weights
    picked = np.concatenate([hot_slots, rows[hot_slots], cold_slots])
    picked = torch.from_numpy(picked).to(dev)
    hs, hr, cs = picked.split([hot_slots.size] * 2 + [cold_slots.size])
    q_val = torch.from_numpy(qv.reshape(-1)).to(dev)
    q_idx = torch.from_numpy(qi.reshape(-1)).to(dev)
    w = torch.zeros((B * width, L), dtype=torch.float32, device=dev)
    docs = torch.zeros((B * width, L), dtype=torch.int32, device=dev)
    if hs.numel():
        w[hs] = hot._vals[hr] * q_val[hs, None]
        docs[hs] = hot._docs[hr]
    if cs.numel():
        cw, cd = index_windows(q_idx[cs][None], q_val[cs][None],
                               index.term_starts, index.term_lens,
                               index.postings_doc, index.postings_val, L)
        w[cs] = cw.view(-1, L)
        docs[cs] = cd.view(-1, L)
    return w.view(B, -1), docs.view(B, -1)


def hot_fused_retrieve(queries: SparseRep, index: InvertedIndex, k: int,
                       *, hot: HotPostingCache
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``score.fused_retrieve`` through the hot windows: ``hot_windows``,
    then K4's window entry at ``term_lanes = max_postings`` (its plain
    version on CPU tensors). The same ``(vals, idx)`` as the port's
    ``fused_retrieve`` bit for bit, cache warm or cold."""
    w, docs = hot_windows(queries, index, hot=hot)
    return fused_impact_topk(w, docs, n_docs=index.n_docs,
                             k=min(k, index.n_docs), term_lanes=hot._l_max)


class CachedEngine:
    """The caching frontier over one ``CorpusEngine``.

    Mutations delegate straight through (the builder's generation bump is
    the invalidation signal). ``search`` goes row by row through the
    shared ``QueryResultCache``: hits come from the cache, misses are
    batched again into **one** underlying search (every retrieval path
    scores rows independently) and stored. With a ``HotPostingCache``,
    miss searches pass a hot-window ``base_scorer`` to
    ``IndexBuilder.search``; it scores only when the resolved method is
    ``fused`` over a raw ``InvertedIndex`` base, and declines (None: the
    normal dispatch) otherwise. ``tag`` namespaces this corpus's entries
    in a cache shared across tenants.
    """

    def __init__(self, engine, *, result_cache: QueryResultCache,
                 hot_cache: Optional[HotPostingCache] = None,
                 tag: str = "corpus"):
        self.engine = engine
        self.results = result_cache
        self.hot = hot_cache
        self.tag = str(tag)
        self._seen_generation: Optional[int] = None

    # -- delegated mutations ---------------------------------------------

    @property
    def builder(self):
        return self.engine.builder

    def add_docs(self, docs, ids=None):
        return self.engine.add_docs(docs, ids=ids)

    def remove_docs(self, ids):
        return self.engine.remove_docs(ids)

    def flush(self, **kw):
        return self.engine.flush(**kw)

    # -- search ----------------------------------------------------------

    def _hot_scorer(self):
        hot = self.hot
        if hot is None:
            return None

        def scorer(queries, base, k, resolved, kw):
            # ``kw`` holds no tuning knob here: ``fused`` accepts none
            # (``score.METHOD_KWARGS``), a None value aside
            if resolved != "fused" or type(base) is not InvertedIndex:
                return None
            hot.ensure(base, self.builder.generation)
            return hot_fused_retrieve(queries, base, k, hot=hot)

        return scorer

    def search(self, queries: SparseRep, k: int = 10,
               **kw) -> Tuple[np.ndarray, np.ndarray]:
        """Row-cached top-k: the signature and results of
        ``CorpusEngine.search`` (host ``(vals f32, ids int64)``). The
        query rows are copied to the host once, for their keys."""
        b = self.builder
        if b.dirty:
            b.flush()
        gen = b.generation
        if gen != self._seen_generation:
            self.results.invalidate(self.tag, gen)
            self._seen_generation = gen

        rows = split_rows(queries)
        keys = [query_cache_key(r, k, kw, self.tag, gen) for r in rows]
        out_v: List[Optional[np.ndarray]] = [None] * len(rows)
        out_i: List[Optional[np.ndarray]] = [None] * len(rows)
        miss_rows, miss_pos = [], []
        for j, key in enumerate(keys):
            hit = self.results.get(key)
            if hit is not None:
                out_v[j], out_i[j] = hit
            else:
                miss_rows.append(rows[j])
                miss_pos.append(j)
        if miss_rows:
            mv, mi = b.search(stack_rows(miss_rows), k,
                              base_scorer=self._hot_scorer(), **kw)
            for r, j in enumerate(miss_pos):
                self.results.put(keys[j], self.tag, gen, mv[r], mi[r])
                out_v[j], out_i[j] = mv[r], mi[r]
        return np.stack(out_v), np.stack(out_i)

    # -- observability ---------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        d = {"tag": self.tag, "results": self.results.stats()}
        if self.hot is not None:
            d["hot"] = self.hot.stats()
        d["engine"] = self.engine.stats()
        return d
