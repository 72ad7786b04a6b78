"""Retrieval scoring behind one ``retrieve()`` (``repro/retrieval/score.py``).

The methods:

    index corpora (queries must be ``SparseRep``s)
    "impact"    ``InvertedIndex``: gather the query terms' posting windows,
                scatter-add them into dense (B, N) scores one term at a
                time (so in a fixed order on the card too), top-k (plain
                PyTorch, as the JAX package leaves it to XLA)
    "quantized" ``QuantizedIndex`` (``engine/quantize``): the same over the
                u4+delta windows, decoded on the fly (plain PyTorch)
    "fused"     a kernel that reads the query terms' postings in place,
                scores them and keeps the top-k, no windows and no (B, N)
                matrix on the card: K4 for an ``InvertedIndex``, K5
                (decoding in the kernel) for a ``QuantizedIndex``
                (``kernels/impact_score``'s index entries; on the CPU
                their plain version, the windows and a dense scatter)
    "pruned"    ``InvertedIndex`` with upper bounds and forward rows
                (``engine/pruning``): two tiers, K4's ceiling entry
                keeping the best ``C + 1`` ceilings, then an exact
                rescoring of the candidates from the forward rows (plain
                PyTorch); ``prune_margin`` and ``candidates`` tune it
    "sharded"   ``ShardedIndex`` (``engine/sharded_index``): each doc shard
                scored as ``impact`` scores it, the per-shard winners
                merged by a stable top-k (an ``all_gather`` under a mesh)
    "term_sharded"  ``TermShardedIndex`` (``engine/term_sharded``): each
                vocab range's partial sums, added (a ``psum`` under a
                mesh), then one top-k; with ``prune_margin`` > 0 the
                two-tier composition over the summed shard ceilings
    "shard2d"   ``Shard2DIndex`` (``engine/shard2d``): the (doc × term)
                grid, partials summed over the term axis into exact chunk
                scores, then the doc axis merges per-chunk winners; with
                ``prune_margin`` > 0 the two-tier composition
                The sharded methods take ``mesh=`` (a ``launch.mesh.Mesh``;
                None scores every shard in this process) and ``plan=`` (a
                ``ShardPlan``, held to the built grid; for ``shard2d`` its
                ``axis_order`` maps the grid onto the mesh's axes)

    dense corpora (an (N, V) tensor; ``SparseRep`` queries are densified)
    "dense"     ``q @ C^T`` and a top-k (plain PyTorch, as the JAX package
                leaves it to XLA)
    "streaming" K6 (``kernels/topk_score``): the product and a running
                top-k in one kernel, no (B, N) matrix; on the card a
                contiguous f32 corpus is read in place, another one cast
                to it once per call (as the reference casts)

    "auto"      a sharded index: its sharded method; an ``InvertedIndex``
                with upper bounds and forward rows (an engine build):
                "pruned"; another index: "fused" from
                ``AUTO_FUSED_N`` docs, else "impact" (``InvertedIndex``)
                or "quantized" (``QuantizedIndex``); a dense corpus:
                "streaming" from ``AUTO_STREAMING_N`` rows, else "dense"

All return ``(vals (B, k) f32, idx (B, k) i32)`` with ties to the lowest
doc id, ``k`` clamped to the corpus size, and identical ids on inputs
without near-ties. A query id outside ``[0, V)`` reads the term the
reference's gather reads (a negative id plus V, then clamped to ``[0, V -
1]``; ``kernels/impact_score.term_rows``). The pruned and sharded
methods take keyword arguments (``prune_margin``, ``candidates``,
``mesh``, ``plan``); the JAX package's others (Pallas blocks,
``interpret``) are TPU knobs. A keyword the resolved method does not
accept raises instead of being ignored (``METHOD_KWARGS``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.impact_score import (fused_impact_index_topk,
                                              index_windows, scatter_scores)
from repro_torch.kernels.topk_score import topk_rows, topk_score
from repro_torch.retrieval.engine.pruning import pruned_retrieve
from repro_torch.retrieval.engine.quantize import (QuantizedIndex,
                                                   fused_quantized_retrieve,
                                                   quantized_retrieve)
from repro_torch.retrieval.engine.shard2d import (Shard2DIndex,
                                                  shard2d_retrieve)
from repro_torch.retrieval.engine.sharded_index import (ShardedIndex,
                                                        sharded_retrieve)
from repro_torch.retrieval.engine.term_sharded import (TermShardedIndex,
                                                       term_sharded_retrieve)
from repro_torch.retrieval.index import InvertedIndex
from repro_torch.retrieval.sparse_rep import SparseRep, query_columns

METHODS = ("auto", "impact", "quantized", "fused", "pruned", "sharded",
           "term_sharded", "shard2d", "dense", "streaming")
# methods that need an index corpus (not a dense matrix)
INDEX_METHODS = ("impact", "quantized", "fused", "pruned", "sharded",
                 "term_sharded", "shard2d")
# the tuning kwargs each method accepts (the JAX package's Pallas blocks
# and ``interpret`` are TPU knobs); the shard topology rides in ``plan``,
# the ranks in ``mesh``
METHOD_KWARGS = {m: frozenset() for m in METHODS if m != "auto"}
METHOD_KWARGS["pruned"] = frozenset({"prune_margin", "candidates"})
METHOD_KWARGS["sharded"] = frozenset({"mesh", "plan"})
METHOD_KWARGS["term_sharded"] = METHOD_KWARGS["shard2d"] = frozenset(
    {"mesh", "plan", "prune_margin", "candidates"})
# each sharded index type and its method
SHARDED_METHODS = {ShardedIndex: "sharded",
                   TermShardedIndex: "term_sharded",
                   Shard2DIndex: "shard2d"}
# corpora at or above this many rows route "auto" to a kernel that keeps
# only the top-k (the streaming scorer for dense corpora, the fused impact
# scorer for indexes): below it the dense (B, N) score matrix is a
# rounding error
AUTO_STREAMING_N = 16384
AUTO_FUSED_N = 16384


def _fused_windows(queries: SparseRep, index: InvertedIndex
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat ``(B, Q * max_postings)`` weight/doc windows: each query
    term's posting list padded to ``max_postings`` lanes, invalid lanes
    at weight exactly 0 (doc 0)."""
    qi, qv = query_columns(queries, index.device)
    return index_windows(qi, qv, index.term_starts, index.term_lens,
                         index.postings_doc, index.postings_val,
                         index.max_postings)


def impact_scores(queries: SparseRep, index: InvertedIndex) -> torch.Tensor:
    """Dense ``(B, n_docs)`` impact scores from the posting windows, summed
    one query term at a time (each doc's sum in term order, the same bits
    on every run and as the fused plain version's scores)."""
    w, docs = _fused_windows(queries, index)
    return scatter_scores(w, docs, index.n_docs, index.max_postings)


def fused_retrieve(queries: SparseRep, index: InvertedIndex, k: int = 10
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k through K4 reading the index in place (its plain version, the
    windows and a dense scatter, on CPU)."""
    qi, qv = query_columns(queries, index.device)
    return fused_impact_index_topk(
        qi, qv, index.term_starts, index.term_lens, index.postings_doc,
        index.postings_val, n_docs=index.n_docs, k=min(k, index.n_docs))


def dense_retrieve(q: torch.Tensor, C: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of the whole ``(B, N)`` f32 product ``q @ C^T``: the
    ``dense`` method, left to PyTorch on every device as the JAX package
    leaves it to XLA (K6's plain version is the same sum but runs only
    for CPU tensors)."""
    return topk_rows(q.float() @ C.float().T, k)


def resolve_method(method: str, corpus) -> str:
    if method not in METHODS:
        raise ValueError(f"unknown retrieval method {method!r}; one of "
                         f"{list(METHODS)}")
    if method != "auto":
        return method
    if isinstance(corpus, QuantizedIndex):
        return "fused" if corpus.n_docs >= AUTO_FUSED_N else "quantized"
    if type(corpus) in SHARDED_METHODS:
        return SHARDED_METHODS[type(corpus)]
    if isinstance(corpus, InvertedIndex):
        # an engine build (upper bounds + forward rows) serves the two-tier
        # pruned path; a bare index only the exact ones
        if corpus.has_upper_bounds and corpus.has_forward:
            return "pruned"
        return "fused" if corpus.n_docs >= AUTO_FUSED_N else "impact"
    rows = corpus.shape[0] if hasattr(corpus, "shape") else 0
    return "streaming" if rows >= AUTO_STREAMING_N else "dense"


def _check_kwargs(method: str, passed: dict) -> None:
    """Raise on the tuning kwargs ``method`` does not accept
    (``METHOD_KWARGS``; a None value counts as not passed)."""
    allowed = METHOD_KWARGS[method]
    stray = sorted(name for name, value in passed.items()
                   if value is not None and name not in allowed)
    if stray:
        raise ValueError(
            f"method={method!r} does not accept {', '.join(stray)} "
            f"(accepted: {sorted(allowed) if allowed else 'no tuning kwargs'}"
            "); refusing to silently ignore a tuning knob")


def _check_plan(plan, method: str, doc_shards: int, term_shards: int
                ) -> None:
    """A ``plan=`` must describe the index it rides with: the grid the
    planner chose must be the grid that was built."""
    if (plan.doc_shards, plan.term_shards) != (doc_shards, term_shards):
        raise ValueError(
            f"method={method!r}: plan grid "
            f"{plan.doc_shards}x{plan.term_shards} (doc x term) does "
            f"not match the built index "
            f"{doc_shards}x{term_shards} — rebuild from the plan or "
            f"re-plan from the corpus stats")


def _sharded(queries, corpus, k: int, method: str, tuning: dict):
    """The sharded methods: the corpus type, the plan held to the grid,
    and margin 0 (or none) routed to the exact path (the same ids, no
    candidate budget to size)."""
    want = {"sharded": (ShardedIndex, "engine.sharded_index.shard_index"),
            "term_sharded": (TermShardedIndex,
                             "engine.term_sharded.term_shard_index"),
            "shard2d": (Shard2DIndex, "engine.shard2d.shard2d_index")}
    cls, builder = want[method]
    if not isinstance(corpus, cls):
        raise ValueError(f"method={method!r} needs a {cls.__name__} corpus "
                         f"— build one with {builder}")
    mesh, plan = tuning.get("mesh"), tuning.get("plan")
    if method == "sharded":
        if plan is not None:
            _check_plan(plan, method, corpus.n_shards, 1)
        return sharded_retrieve(queries, corpus, k, mesh=mesh)
    margin = tuning.get("prune_margin") or 0.0
    margin = margin if margin > 0 else None
    if method == "term_sharded":
        if plan is not None:
            _check_plan(plan, method, 1, corpus.n_shards)
        return term_sharded_retrieve(queries, corpus, k, mesh=mesh,
                                     prune_margin=margin,
                                     candidates=tuning.get("candidates"))
    if plan is not None:
        _check_plan(plan, method, corpus.doc_shards, corpus.term_shards)
    return shard2d_retrieve(queries, corpus, k, mesh=mesh, plan=plan,
                            prune_margin=margin,
                            candidates=tuning.get("candidates"))


def retrieve(queries, corpus, k: int = 10, *, method: str = "auto",
             **tuning) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k retrieval of ``queries`` (``SparseRep`` or dense ``(B, V)``)
    from ``corpus`` (an ``InvertedIndex``, a ``QuantizedIndex``, a sharded
    index or a dense ``(N, V)`` tensor).

    ``k`` is clamped to the corpus size; results lie on the corpus's
    device. See the module docstring for the methods.
    """
    method = resolve_method(method, corpus)
    _check_kwargs(method, tuning)
    if method in INDEX_METHODS:
        if not isinstance(queries, SparseRep):
            raise ValueError(
                f"method={method!r} needs SparseRep queries — sparsify "
                "with retrieval.sparse_rep.sparsify_topk/threshold (an "
                "explicit budget, not a silent one)")
        if method in SHARDED_METHODS.values():
            return _sharded(queries, corpus, k, method, tuning)
        if method == "fused" and isinstance(corpus, QuantizedIndex):
            return fused_quantized_retrieve(queries, corpus, k)
        if method == "quantized":
            if not isinstance(corpus, QuantizedIndex):
                raise ValueError(
                    "method='quantized' needs a QuantizedIndex corpus — "
                    "compress one with engine.quantize.quantize_index")
            return quantized_retrieve(queries, corpus, k)
        if method == "fused":
            if not isinstance(corpus, InvertedIndex):
                raise ValueError(
                    "method='fused' needs an InvertedIndex or "
                    "QuantizedIndex corpus — build one with "
                    "retrieval.index.build_inverted_index or "
                    "engine.quantize.quantize_index")
            return fused_retrieve(queries, corpus, k)
        if not isinstance(corpus, InvertedIndex):
            raise ValueError(
                f"method={method!r} needs an InvertedIndex corpus — build "
                "one with retrieval.index.build_inverted_index")
        if method == "pruned":
            margin = tuning.get("prune_margin")
            return pruned_retrieve(
                queries, corpus, k,
                prune_margin=margin if margin is not None else 0.0,
                candidates=tuning.get("candidates"))
        return topk_rows(impact_scores(queries, corpus),
                         min(k, corpus.n_docs))

    if not (isinstance(corpus, torch.Tensor) and corpus.dim() == 2):
        raise ValueError(
            f"method={method!r} needs a dense (N, V) corpus matrix; got "
            f"{type(corpus).__name__} (use an index method or 'auto')")
    n_docs, vocab = corpus.shape
    if isinstance(queries, SparseRep):
        q = queries.to(corpus.device).to_dense(vocab)
    else:
        q = torch.as_tensor(queries, device=corpus.device).float()
    k = min(k, n_docs)
    if method == "dense":
        return dense_retrieve(q, corpus, k)
    return topk_score(q.contiguous(), corpus, k=k)
