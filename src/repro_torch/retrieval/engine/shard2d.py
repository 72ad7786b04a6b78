"""2D (doc × term) sharding behind the ``ShardPlan`` placement API
(``repro/retrieval/engine/shard2d.py``).

Doc sharding (``sharded_index``) splits the documents and keeps the
whole ``O(V)`` term directory on every rank; term sharding
(``term_sharded``) splits the vocabulary and pays a ``(B, N)``
partial-sum all-reduce a query. The paper's large-|V| regime (the
250002-term multilingual encoder) wants both: enough term shards to cut
the directory, enough doc shards to keep that all-reduce small and the
corpus growing with the rank count.

``Shard2DIndex`` composes the two on a (doc × term) grid: cell ``(i, j)``
holds the posting lists of vocab range ``j`` restricted to the docs of
contiguous chunk ``i``. The merge composes the two 1D merges in the one
order that is exact:

1. **psum over the term axis**: within a chunk a doc's score is spread
   over the ``T`` ranges, so the cells' ``(B, docs_per_chunk)`` partial
   sums are all-reduced first;
2. **top-k merge over the doc axis**: each chunk's scores are then
   exact, so a per-chunk top-k, an ``all_gather`` and a second top-k
   finish the query.

The pruned composition: each cell's ceiling partials (from its own upper
bounds) are psum'd over the term axis into exact chunk ceilings,
gathered over the doc axis into the global ``(B, N)`` bound, and the
surviving candidates rescored exactly from the forward rows stored once
on the index (``pruning.select_and_rescore_dense``).

``plan_placement(stats, n_devices, per_device_hbm)`` picks the grid:
frozen ``ShardPlan`` tuples ``(doc_shards, term_shards, replicas,
axis_order, reason)`` from the per-device posting bytes, the directory
slice (doc sharding keeps all ``DIR_BYTES_PER_TERM * V`` of it, term
sharding divides it by ``term_shards``) and the replicated forward rows.
The planner is host arithmetic, the reference's to the letter (its
``reason`` strings too). Term-range cuts are balanced by posting mass
(``mass_balanced_boundaries``).

As for the 1D indexes: ``mesh`` given, each rank scores its cell (a
``launch.mesh.Mesh`` of at least two axes; ``psum`` and ``all_gather``
through ``collectives``); ``mesh=None``, every cell in one process.
Chunks may be uneven, so a flattened ``(D * dpc)`` position is not a
global id: positions go through ``chunk_starts``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import collectives
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels._common import NEG_INF
from repro_torch.kernels.topk_score import topk_rows
from repro_torch.retrieval.engine.sharded_index import (
    host_rows, mask_padding, merge_gathered, nbytes, partial_scores,
    partial_ub_scores, put, resolve_mesh_axes, shard_mapped, stack_field,
    sum_in_order, two_tier_args)
from repro_torch.retrieval.index import InvertedIndex, build_inverted_index
from repro_torch.retrieval.sparse_rep import SparseRep, query_columns

# term_starts + term_lens + term_ubs per vocab entry — the per-device
# term-directory cost the planner accounts (doc sharding replicates
# it, term sharding divides it by term_shards)
DIR_BYTES_PER_TERM = 12
# one posting = i32 doc id + f32 impact
POSTING_BYTES = 8


# ---------------------------------------------------------------------------
# corpus statistics — the planner's input
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CorpusStats:
    """The sizes that drive placement: posting mass, vocab width, and
    the replicated extras. Build one ``from_index``/``from_rep`` for a
    live corpus or fill the fields directly to plan a hypothetical one
    (the bench's 30k-vs-250k vocab probe does the latter)."""

    posting_bytes: int        # total posting-array bytes (docs + vals)
    vocab_size: int           # |V| — the directory is O(V) per replica
    n_docs: int
    forward_bytes: int = 0    # (N, K) forward rows, replicated per dev

    @classmethod
    def from_index(cls, index: InvertedIndex) -> "CorpusStats":
        fwd = 0
        if index.has_forward:
            fwd = nbytes(index.doc_values, index.doc_indices)
        return cls(posting_bytes=POSTING_BYTES * index.n_postings,
                   vocab_size=index.vocab_size, n_docs=index.n_docs,
                   forward_bytes=fwd)

    @classmethod
    def from_rep(cls, reps: SparseRep, vocab_size: int, *,
                 keep_forward: bool = False) -> "CorpusStats":
        v = host_rows(reps)[0]
        nnz = int((v > 0).sum())
        fwd = 2 * 4 * v.size if keep_forward else 0
        return cls(posting_bytes=POSTING_BYTES * max(nnz, 1),
                   vocab_size=vocab_size, n_docs=v.shape[0],
                   forward_bytes=fwd)


# ---------------------------------------------------------------------------
# ShardPlan — the placement API
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """A frozen placement: a (doc × term) grid replicated ``replicas``
    times for throughput. ``axis_order`` names the logical axes in
    *mesh* order — ``("doc", "term")`` means mesh axis 0 carries the
    doc dimension; flip it to run the same index on a transposed mesh.
    ``reason`` is the planner's human-readable accounting trail."""

    doc_shards: int
    term_shards: int
    replicas: int = 1
    axis_order: Tuple[str, str] = ("doc", "term")
    reason: str = ""

    def __post_init__(self):
        for name in ("doc_shards", "term_shards", "replicas"):
            if getattr(self, name) < 1:
                raise ValueError(f"ShardPlan.{name} must be >= 1, got "
                                 f"{getattr(self, name)}")
        if tuple(sorted(self.axis_order)) != ("doc", "term"):
            raise ValueError(
                f"axis_order must be a permutation of ('doc', 'term'), "
                f"got {self.axis_order!r}")

    @property
    def grid(self) -> int:
        return self.doc_shards * self.term_shards

    @property
    def n_devices(self) -> int:
        return self.grid * self.replicas

    @property
    def axis(self) -> str:
        """The 1D axis name this plan degenerates to — what the
        deprecated ``choose_shard_axis`` shim returns. A genuinely 2D
        grid reports ``"2d"``."""
        if self.term_shards == 1:
            return "doc"
        if self.doc_shards == 1:
            return "term"
        return "2d"

    def per_device_bytes(self, stats: CorpusStats) -> float:
        """The planner's accounting model for one device of this grid:
        an even posting-mass slice (mass-balanced term cuts + contiguous
        doc chunks make that the design point, not an assumption), this
        device's directory slice, and the replicated forward rows."""
        return (stats.posting_bytes / self.grid
                + DIR_BYTES_PER_TERM * stats.vocab_size
                / self.term_shards
                + stats.forward_bytes)

    def describe(self) -> str:
        return (f"{self.doc_shards}x{self.term_shards} (doc x term)"
                + (f" x{self.replicas} replicas" if self.replicas > 1
                   else ""))


def _grid_candidates(n_devices: int):
    """All (doc_shards, term_shards) grids of size <= n_devices,
    ordered smallest grid first, then fewest term shards (the psum is
    the expensive merge), then fewest doc shards."""
    grids = [(d, t) for d in range(1, n_devices + 1)
             for t in range(1, n_devices // d + 1)]
    return sorted(grids, key=lambda g: (g[0] * g[1], g[1], g[0]))


def plan_placement(stats: CorpusStats, n_devices: int,
                   per_device_hbm: Optional[int] = None) -> ShardPlan:
    """Plan a (doc × term × replica) placement for this corpus.

    With an HBM budget: the smallest grid whose per-device footprint
    (``ShardPlan.per_device_bytes``) fits wins — few term shards
    preferred, since the doc axis merges k winners while the term axis
    all-reduces chunk-sized partials — and every leftover device
    becomes a whole-grid throughput replica. If nothing fits, the
    full-device grid with the smallest footprint is returned (serving
    may still spill; the ``reason`` says so loudly).

    Without a budget, only the directory-vs-postings ratio can decide:
    doc-only when the replicated O(V) directory is a rounding error
    next to a per-device posting slice, else just enough term shards
    that each device's directory slice stops dominating its postings —
    the huge-vocab sparse regime ("The Role of Vocabularies") where
    posting mass, not device count, drives placement.
    """
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    directory = DIR_BYTES_PER_TERM * stats.vocab_size
    post_slice = stats.posting_bytes / n_devices

    if per_device_hbm is None:
        if directory <= post_slice:
            return ShardPlan(
                doc_shards=n_devices, term_shards=1,
                reason=f"doc-only: replicated directory "
                       f"({directory} B) fits beside the per-device "
                       f"posting slice ({post_slice:.0f} B)")
        for t in range(2, n_devices + 1):
            if n_devices % t == 0 and directory / t <= post_slice:
                return ShardPlan(
                    doc_shards=n_devices // t, term_shards=t,
                    reason=f"{n_devices // t}x{t}: {t} term shards "
                           f"cut the directory to {directory / t:.0f} "
                           f"B <= the posting slice "
                           f"({post_slice:.0f} B)")
        return ShardPlan(
            doc_shards=1, term_shards=n_devices,
            reason=f"term-only: directory ({directory} B) dominates "
                   f"the posting slice ({post_slice:.0f} B) at every "
                   f"narrower cut")

    feasible = [(d, t) for d, t in _grid_candidates(n_devices)
                if ShardPlan(d, t).per_device_bytes(stats)
                <= per_device_hbm]
    if not feasible:
        full = [(d, t) for d, t in _grid_candidates(n_devices)
                if d * t == n_devices]
        d, t = min(full, key=lambda g: ShardPlan(*g)
                   .per_device_bytes(stats))
        need = ShardPlan(d, t).per_device_bytes(stats)
        return ShardPlan(
            doc_shards=d, term_shards=t,
            reason=f"OVER BUDGET: smallest per-device footprint "
                   f"{need:.0f} B still exceeds {per_device_hbm} B — "
                   f"needs more devices or a smaller corpus")
    d, t = feasible[0]
    plan = ShardPlan(d, t)
    replicas = n_devices // plan.grid
    used = plan.per_device_bytes(stats)
    return dataclasses.replace(
        plan, replicas=replicas,
        reason=f"{d}x{t} grid fits ({used:.0f} of {per_device_hbm} B "
               f"per device)"
               + (f"; {replicas} throughput replicas from the "
                  f"{n_devices - plan.grid} spare devices"
                  if replicas > 1 else ""))


def choose_shard_axis(posting_bytes: int, vocab_size: int,
                      n_shards: int,
                      per_device_bytes: Optional[int] = None) -> str:
    """Deprecated string shim over ``plan_placement`` — returns
    ``plan.axis`` (``"doc"``/``"term"``/``"2d"``). Migrate to the
    ``ShardPlan`` object; the string cannot express 2D grids or
    replicas."""
    warnings.warn(
        "choose_shard_axis is deprecated: use plan_placement(...) and "
        "read the ShardPlan (doc_shards/term_shards/replicas) instead "
        "of a string axis",
        DeprecationWarning, stacklevel=2)
    stats = CorpusStats(posting_bytes=posting_bytes,
                        vocab_size=vocab_size, n_docs=0)
    return plan_placement(stats, n_shards, per_device_bytes).axis


# ---------------------------------------------------------------------------
# mass-balanced vocab cuts (shared with term_sharded)
# ---------------------------------------------------------------------------

def mass_balanced_boundaries(term_counts: np.ndarray, n_shards: int
                             ) -> Tuple[int, ...]:
    """Vocab cuts that equalize cumulative posting *mass* per range.

    Width-balanced cuts give every shard ``V / n`` terms; with a
    skewed DF distribution (one stopword-heavy term owning a large
    slice of all postings) one shard's posting array then dwarfs the
    rest and — because the stacked layout pads to the widest shard —
    every shard pays for it. Cutting at the mass quantiles instead
    bounds each range near ``total / n`` postings (within one term:
    a single list is never split). Cuts are strictly increasing; with
    zero total mass the width cuts are returned.
    """
    counts = np.asarray(term_counts, np.int64)
    v = counts.shape[0]
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if n_shards > v:
        raise ValueError(f"n_shards={n_shards} exceeds vocab size {v}")
    total = int(counts.sum())
    if total == 0:
        return tuple(s * v // n_shards for s in range(n_shards + 1))
    cum = np.cumsum(counts)
    bounds = [0]
    for s in range(1, n_shards):
        target = s * total / n_shards
        b = int(np.searchsorted(cum, target))
        # keep cuts strictly increasing with enough terms left for the
        # remaining shards
        b = max(b, bounds[-1] + 1)
        b = min(b, v - (n_shards - s))
        bounds.append(b)
    bounds.append(v)
    return tuple(bounds)


def _validate_boundaries(boundaries, n_parts: int, size: int,
                         what: str) -> Tuple[int, ...]:
    boundaries = tuple(int(b) for b in boundaries)
    if (len(boundaries) != n_parts + 1 or boundaries[0] != 0
            or boundaries[-1] != size
            or any(a >= b for a, b in zip(boundaries, boundaries[1:]))):
        raise ValueError(
            f"{what} must be {n_parts + 1} strictly increasing cuts "
            f"from 0 to {size}, got {list(boundaries)}")
    return boundaries


# ---------------------------------------------------------------------------
# the 2D index
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# the 2D index
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Shard2DIndex:
    """(doc × term) grid of posting-list cells (module docstring).

    Cell ``(i, j)`` indexes doc chunk ``i`` restricted to vocab range
    ``j``: term ids local to the range (``t - term_lo[j]``), doc ids local
    to the chunk (``d - chunk_starts[i]``); stacked on two leading grid
    axes, padded to the widest cell."""

    term_starts: torch.Tensor     # (D, T, Vloc) i32 — local term offsets
    term_lens: torch.Tensor       # (D, T, Vloc) i32
    postings_doc: torch.Tensor    # (D, T, Pmax) i32 — LOCAL (chunk) doc ids
    postings_val: torch.Tensor    # (D, T, Pmax) f32
    term_ubs: torch.Tensor        # (D, T, Vloc) f32 — per-cell upper bounds
    term_lo: torch.Tensor         # (T,) i32 — vocab range starts
    term_hi: torch.Tensor         # (T,) i32 — vocab range ends (exclusive)
    chunk_starts: torch.Tensor    # (D,) i32 — first global doc id a chunk
    chunk_counts: torch.Tensor    # (D,) i32 — real docs a chunk
    doc_shards: int               # D
    term_shards: int              # T
    n_docs: int                   # real docs in all
    vocab_size: int               # global V
    local_vocab: int              # padded per-range vocab width
    docs_per_chunk: int           # padded chunk width
    max_postings: int             # the longest list over all cells
    term_boundaries: Tuple[int, ...] = ()   # the vocab cuts
    doc_boundaries: Tuple[int, ...] = ()    # the doc cuts
    doc_values: Optional[torch.Tensor] = None    # (N, K) f32, stored once
    doc_indices: Optional[torch.Tensor] = None   # (N, K) i32

    @property
    def device(self) -> torch.device:
        return self.postings_doc.device

    @property
    def has_forward(self) -> bool:
        return self.doc_values is not None and self.doc_indices is not None

    def memory_bytes(self) -> int:
        return nbytes(self.term_starts, self.term_lens, self.postings_doc,
                      self.postings_val, self.term_ubs, self.term_lo,
                      self.term_hi, self.chunk_starts, self.chunk_counts,
                      self.doc_values, self.doc_indices)

    def stats(self) -> Dict[str, float]:
        return {
            "doc_shards": self.doc_shards,
            "term_shards": self.term_shards,
            "n_docs": self.n_docs,
            "vocab_size": self.vocab_size,
            "local_vocab": self.local_vocab,
            "docs_per_chunk": self.docs_per_chunk,
            "max_postings": self.max_postings,
            "memory_bytes": self.memory_bytes(),
        }

    def zero_docs(self, global_ids: Sequence[int]) -> "Shard2DIndex":
        """Tombstone documents: zero their impacts in every cell of their
        chunk (and their forward rows). Cells hold chunk-local ids, so
        each chunk masks its own slice of ``global_ids``, shifted by its
        start (the builder's base-removal flush for a 2D base)."""
        dead = np.asarray(sorted(set(int(g) for g in global_ids)), np.int64)
        pval = self.postings_val.clone()
        bounds = self.doc_boundaries
        for i in range(self.doc_shards):
            local = dead[(dead >= bounds[i]) & (dead < bounds[i + 1])]
            if local.size:
                local = torch.as_tensor(local - bounds[i], device=self.device)
                hit = torch.isin(self.postings_doc[i].long(), local)
                pval[i] = torch.where(hit, 0.0, pval[i])
        kw = {"postings_val": pval}
        if self.doc_values is not None and dead.size:
            kw["doc_values"] = self.doc_values.index_fill(
                0, torch.as_tensor(dead, device=self.device), 0.0)
        return dataclasses.replace(self, **kw)


def shard2d_index(reps: SparseRep, vocab_size: int, doc_shards: int,
                  term_shards: int, *,
                  doc_boundaries: Optional[Sequence[int]] = None,
                  term_boundaries: Optional[Sequence[int]] = None,
                  balance: str = "mass", keep_forward: bool = False,
                  device: DeviceLike = None) -> Shard2DIndex:
    """Build the (doc × term) grid from a batched corpus rep (host numpy,
    then moved to ``device``, ``cuda`` unless given).

    Docs are cut into ``doc_shards`` contiguous chunks (even chunks of
    ``ceil(N / D)`` unless ``doc_boundaries`` says otherwise), the
    vocabulary into ``term_shards`` ranges (by posting mass with
    ``balance="mass"``, evenly with ``"width"``; ``term_boundaries`` win).
    Each (chunk, range) cell is indexed alone
    (``build_inverted_index(vocab_range=...)`` over the chunk's rows: local
    term and doc ids), then padded to the widest cell. ``keep_forward``
    stores the ``(N, K)`` forward rows once, for the pruned path.
    """
    if doc_shards < 1 or term_shards < 1:
        raise ValueError(f"shard counts must be >= 1, got "
                         f"{doc_shards}x{term_shards}")
    if term_shards > vocab_size:
        raise ValueError(f"term_shards={term_shards} exceeds vocab "
                         f"size {vocab_size}")
    if balance not in ("mass", "width"):
        raise ValueError(f"balance must be 'mass' or 'width', got "
                         f"{balance!r}")
    dev = resolve_device(device)
    v, i, n = host_rows(reps)
    n_docs = v.shape[0]
    if doc_shards > n_docs:
        raise ValueError(
            f"doc_shards={doc_shards} exceeds corpus size {n_docs}")

    if doc_boundaries is None:
        dps = -(-n_docs // doc_shards)
        doc_boundaries = [min(s * dps, n_docs)
                          for s in range(doc_shards + 1)]
        doc_boundaries[-1] = n_docs
    doc_bounds = _validate_boundaries(doc_boundaries, doc_shards, n_docs,
                                      "doc_boundaries")
    if term_boundaries is None:
        if balance == "mass":
            counts = np.bincount(i[v > 0].ravel(), minlength=vocab_size)
            term_boundaries = mass_balanced_boundaries(counts, term_shards)
        else:
            term_boundaries = [s * vocab_size // term_shards
                               for s in range(term_shards + 1)]
    term_bounds = _validate_boundaries(term_boundaries, term_shards,
                                       vocab_size, "term_boundaries")

    D, T = doc_shards, term_shards
    cells = [build_inverted_index(
        SparseRep(v[lo:hi], i[lo:hi], n[lo:hi]), vocab_size,
        vocab_range=(term_bounds[t], term_bounds[t + 1]),
        stopword_warn_frac=1.1, device="cpu")
        for lo, hi in zip(doc_bounds, doc_bounds[1:]) for t in range(T)]

    def stack(name, dtype):
        return stack_field(cells, name, dtype, dev, lead=(D, T))

    return Shard2DIndex(
        term_starts=stack("term_starts", np.int32),
        term_lens=stack("term_lens", np.int32),
        postings_doc=stack("postings_doc", np.int32),
        postings_val=stack("postings_val", np.float32),
        term_ubs=stack("term_ubs", np.float32),
        term_lo=put(np.asarray(term_bounds[:-1], np.int32), dev),
        term_hi=put(np.asarray(term_bounds[1:], np.int32), dev),
        chunk_starts=put(np.asarray(doc_bounds[:-1], np.int32), dev),
        chunk_counts=put(np.diff(np.asarray(doc_bounds)).astype(np.int32),
                         dev),
        doc_shards=D, term_shards=T, n_docs=n_docs, vocab_size=vocab_size,
        local_vocab=max(c.vocab_size for c in cells),
        docs_per_chunk=max(b - a for a, b in zip(doc_bounds,
                                                 doc_bounds[1:])),
        max_postings=max(c.max_postings for c in cells),
        term_boundaries=term_bounds, doc_boundaries=doc_bounds,
        doc_values=put(v, dev) if keep_forward else None,
        doc_indices=put(i, dev) if keep_forward else None)


# ---------------------------------------------------------------------------
# scoring: psum over the term axis, then the top-k merge over the doc axis
# ---------------------------------------------------------------------------

def _cell_partial(qi, qv, index: Shard2DIndex, d: int, t: int,
                  ubs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cell ``(d, t)``'s ``(B, docs_per_chunk)`` partial scores: the
    contribution of vocab range ``t`` to chunk ``d``; its ceiling partials
    given its upper bounds ``ubs``."""
    args = (index.term_starts[d, t], index.term_lens[d, t],
            index.postings_doc[d, t])
    ends = (index.term_lo[t], index.term_hi[t])
    sizes = (index.docs_per_chunk, index.local_vocab, index.max_postings)
    if ubs is None:
        return partial_scores(qi, qv, *args, index.postings_val[d, t],
                              *ends, *sizes)
    return partial_ub_scores(qi, qv, *args, ubs, *ends, *sizes)


def _grid_map(qi, qv, index: Shard2DIndex, with_ubs: bool = False
              ) -> torch.Tensor:
    """Every cell's partials (its ceilings ``with_ubs``): ``(D, T, B,
    docs_per_chunk)``."""
    return torch.stack([torch.stack([
        _cell_partial(qi, qv, index, d, t,
                      index.term_ubs[d, t] if with_ubs else None)
        for t in range(index.term_shards)])
        for d in range(index.doc_shards)])


def _mask_pad(chunk_scores: torch.Tensor, counts: torch.Tensor
              ) -> torch.Tensor:
    """``NEG_INF`` on every chunk's padded tail: ``(D, B, dpc)`` -> the
    same."""
    local = torch.arange(chunk_scores.shape[2], device=chunk_scores.device)
    return torch.where(local[None, None, :] < counts[:, None, None],
                       chunk_scores, NEG_INF)


def _chunk_scores(qi, qv, index: Shard2DIndex, with_ubs: bool = False
                  ) -> torch.Tensor:
    """The cells' partials summed over the term axis in range order (the
    psum's algebra), padding at ``NEG_INF``: ``(D, B, dpc)``."""
    partials = _grid_map(qi, qv, index, with_ubs)
    return _mask_pad(sum_in_order(partials.unbind(1)), index.chunk_counts)


def _global_ids(index: Shard2DIndex) -> torch.Tensor:
    """``(D * dpc,)`` the global id of each flattened chunk position."""
    local = torch.arange(index.docs_per_chunk, dtype=torch.int32,
                         device=index.device)
    return (index.chunk_starts[:, None] + local[None, :]).reshape(-1)


def _scatter_global(chunk_vals: torch.Tensor, starts: torch.Tensor,
                    n_docs: int) -> torch.Tensor:
    """``(D, B, dpc)`` ``NEG_INF``-padded chunk values -> ``(B, n_docs)``
    global rows: a scatter-max through each chunk's start (padded slots
    land on a clipped position, or on the next chunk's docs, with
    ``NEG_INF``, and lose)."""
    d, b, dpc = chunk_vals.shape
    local = torch.arange(dpc, dtype=torch.int64, device=chunk_vals.device)
    pos = (starts.long()[:, None] + local[None, :]).clamp(0, n_docs - 1)
    flat = chunk_vals.transpose(0, 1).reshape(b, -1)
    out = torch.full((b, n_docs), NEG_INF, dtype=chunk_vals.dtype,
                     device=chunk_vals.device)
    return out.scatter_reduce_(1, pos.reshape(1, -1).expand(b, -1), flat,
                               "amax")


def shard2d_retrieve(queries: SparseRep, index: Shard2DIndex, k: int = 10,
                     *, mesh=None, plan: Optional[ShardPlan] = None,
                     prune_margin: Optional[float] = None,
                     candidates: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the 2D grid; ids are global doc ids, as
    ``method="impact"`` ranks them at every grid shape.

    Exact by default. With ``prune_margin`` the two-tier composition
    runs (module docstring; forward rows needed). ``mesh`` must carry
    both logical axes: ``plan.axis_order`` maps them onto its first two
    axes (default: axis 0 doc, axis 1 term). ``mesh=None`` computes the
    same in one process.
    """
    from repro_torch.retrieval.engine.pruning import select_and_rescore_dense

    k = min(k, index.n_docs)
    qi, qv = query_columns(queries, index.device)
    cands = two_tier_args(index, k, prune_margin, candidates,
                          "shard2d_retrieve")

    if mesh is None:
        if cands is not None:
            chunks = _chunk_scores(qi, qv, index, with_ubs=True)
            ub = _scatter_global(chunks, index.chunk_starts, index.n_docs)
            vals, idx, _ = select_and_rescore_dense(
                ub, queries, index.doc_values, index.doc_indices,
                index.vocab_size, k, cands, prune_margin)
            return vals, idx
        # flattened positions rise with the global id, so the stable
        # top-k's lowest-position ties are the unsharded scorer's
        flat = _chunk_scores(qi, qv, index).transpose(0, 1).reshape(
            qi.shape[0], -1)
        vals, pos = topk_rows(flat, k)
        return vals, _global_ids(index)[pos.long()]

    order = plan.axis_order if plan is not None else ("doc", "term")
    if plan is not None and (plan.doc_shards, plan.term_shards) != (
            index.doc_shards, index.term_shards):
        raise ValueError(
            f"plan grid {plan.doc_shards}x{plan.term_shards} does not "
            f"match index grid {index.doc_shards}x{index.term_shards}")
    sizes = tuple(index.doc_shards if a == "doc" else index.term_shards
                  for a in order)
    mesh_axes = resolve_mesh_axes(mesh, None, sizes, what="shard2d_retrieve")
    doc_axis = mesh_axes[order.index("doc")]
    term_axis = mesh_axes[order.index("term")]
    grid = (doc_axis, term_axis)
    dpc = index.docs_per_chunk
    kk = min(k, dpc)

    def chunk_partials(st, ln, pd, w, lo, hi, cct, ceilings):
        fn = partial_ub_scores if ceilings else partial_scores
        part = fn(qi, qv, st[0, 0], ln[0, 0], pd[0, 0], w[0, 0], lo[0],
                  hi[0], dpc, index.local_vocab, index.max_postings)
        total = collectives.psum(part, term_axis, mesh)   # exact chunk
        return mask_padding(total, cct[0])

    if cands is not None:
        def pruned_body(st, ln, pd, ubs, lo, hi, cct):
            chunk_ub = chunk_partials(st, ln, pd, ubs, lo, hi, cct, True)
            all_ub = collectives.all_gather(chunk_ub[None], doc_axis, mesh,
                                            dim=0)        # (D, B, dpc)
            ub = _scatter_global(all_ub, index.chunk_starts, index.n_docs)
            vals, idx, _ = select_and_rescore_dense(
                ub, queries, index.doc_values, index.doc_indices,
                index.vocab_size, k, cands, prune_margin)
            return vals, idx

        merged = shard_mapped(pruned_body, mesh, None, n_in=7, in_specs=(
            grid, grid, grid, grid, (term_axis,), (term_axis,),
            (doc_axis,)))
        return merged(index.term_starts, index.term_lens, index.postings_doc,
                      index.term_ubs, index.term_lo, index.term_hi,
                      index.chunk_counts)

    def body(st, ln, pd, pv, lo, hi, cst, cct):
        total = chunk_partials(st, ln, pd, pv, lo, hi, cct, False)
        lv, li = topk_rows(total, kk)
        return merge_gathered(lv, li + cst[0], doc_axis, mesh, k)

    merged = shard_mapped(body, mesh, None, n_in=8, in_specs=(
        grid, grid, grid, grid, (term_axis,), (term_axis,), (doc_axis,),
        (doc_axis,)))
    return merged(index.term_starts, index.term_lens, index.postings_doc,
                  index.postings_val, index.term_lo, index.term_hi,
                  index.chunk_starts, index.chunk_counts)
