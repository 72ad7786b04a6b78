"""Serving entry point: ``python -m repro_torch.launch.serve``.

The pipeline of ``repro/launch/serve.py``, end to end:

1. index    — encode a synthetic corpus (16-token docs) through the
              trunk and the Sparton head, sparsify on the device
              (``--rep-topk``), build the inverted impact index
              (``--method quantized`` compresses it, ``--method pruned``
              keeps its forward rows); with ``--rep-topk 0`` keep the
              dense reps as an ``(N, V)`` f32 corpus on the device
              instead. ``--method sharded|term_sharded|shard2d`` shards
              the index over ``--shards`` doc ranges, vocab ranges or a
              (doc × term) grid (``--shard-axis`` picks the axis of
              ``sharded``: ``auto`` lets ``plan_placement`` size the grid
              from the built index's posting bytes against its O(V)
              directory). With ``--engine`` the corpus grows online
              through a ``CorpusEngine``: one ``add_docs`` + ``flush`` per
              batch, ``--remove-frac`` of it tombstoned at the end, the
              base segment compressed with ``--quantize``, the segments'
              forward rows kept with ``--prune-margin``, or the base
              partitioned by ``--shard-axis term|2d|auto`` over
              ``--shards`` (``auto`` plans from the requested corpus size
              and rep budget).
2. serve    — stream queries (4–24 tokens) through the deadline/size
              micro-batching loop; results are popped with ``take``.
              ``--deadline-ms`` gives every request an SLO (the loop may
              shed; shed and failed uids are reported and left out of
              retrieval), ``--max-queue`` bounds the admission queue and
              ``--continuous`` batches earliest-deadline-first.
3. retrieve — top-k of the first served queries through
              ``retrieve(method=--method)``, or the engine's ``search``
              (``auto`` on each segment; with ``--prune-margin M`` the
              two-tier ``pruned`` method at margin M). ``--cache-mb MB``
              fronts the engine with the serving frontier
              (``runtime/frontier``): a result cache of MB and a
              hot-posting cache of a quarter of it, the search forced to
              ``fused`` (its base through K4's window entry on the hot
              windows) and run twice, the second pass from the cache.

``--tenants N`` serves N weighted tenants (weights 1..N, the corpus split
evenly) over one encoder through a ``TenantPool`` instead, each searched
with ``fused`` (twice when caching).

``--arch`` takes the SPLADE encoders and the dense decoders
(``llama3_2_3b``, ``gemma2_27b``, ``phi3_mini``, or the JAX aliases such
as ``llama3.2-3b``): a decoder's reps come from its causal trunk and the
same head.

It runs the config's SMOKE size with seeded random weights on
``--device`` (default ``cuda``; ``--device cpu`` runs the kernels' plain
versions). ``run`` and ``run_tenants`` are the same pipelines for any
encode fn and config; ``chip_smoke.py`` drives them at full width. The
sharded indexes are searched in this one process (every shard in turn,
the reference's single-device path); ``retrieve(..., mesh=)`` spreads
them over the ranks of a ``torch.distributed`` world.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

DOC_TOKENS = 16
N_QUERIES = 8   # served queries that go on to retrieval
SEED = 0        # the synthetic corpus and requests


SHARDED = ("sharded", "term_sharded", "shard2d")


def _grid_plan(n_shards: int):
    """The most balanced (doc x term) factorization of an explicit
    ``--shard-axis 2d``: the largest doc divisor <= sqrt(n), the term axis
    the rest (a prime count degenerates to 1 x n)."""
    from repro_torch.retrieval import ShardPlan

    d = max(f for f in range(1, int(n_shards ** 0.5) + 1)
            if n_shards % f == 0)
    return ShardPlan(doc_shards=d, term_shards=n_shards // d,
                     reason=f"--shard-axis 2d: balanced factorization "
                            f"of {n_shards} devices")


def encode_corpus(encode: Callable, vocab_size: int, n_docs: int, *,
                  batch: int, rng: np.random.Generator, device):
    """Encode ``n_docs`` random docs in batches: sparse reps stacked into
    one ``(n_docs, K)`` host ``SparseRep``; dense reps written, batch by
    batch, into one ``(n_docs, V)`` f32 tensor on ``device``, the layout
    the streaming kernel reads in place."""
    from repro_torch.retrieval.sparse_rep import SparseRep, stack_rows

    parts, dense = [], None
    for lo in range(0, n_docs, batch):
        n = min(batch, n_docs - lo)
        toks = rng.integers(1, vocab_size, size=(n, DOC_TOKENS))
        reps = encode(torch.from_numpy(toks.astype(np.int32)),
                      torch.ones((n, DOC_TOKENS), dtype=torch.int32))
        if isinstance(reps, SparseRep):
            parts.append(reps)
            continue
        if dense is None:
            dense = torch.empty((n_docs, vocab_size), dtype=torch.float32,
                                device=device)
        dense[lo:lo + n] = reps
    return dense if dense is not None else stack_rows(parts)


def index_corpus(encode: Callable, vocab_size: int, n_docs: int, *,
                 batch: int, rng: np.random.Generator, device,
                 keep_forward: bool = False):
    """``encode_corpus``, the sparse reps then indexed (an
    ``InvertedIndex``, with its forward rows when ``keep_forward``)."""
    from repro_torch.retrieval.index import build_inverted_index

    reps = encode_corpus(encode, vocab_size, n_docs, batch=batch, rng=rng,
                         device=device)
    if isinstance(reps, torch.Tensor):
        return reps
    return build_inverted_index(reps, vocab_size, keep_forward=keep_forward,
                                device=device)


def shard_corpus(reps, index, vocab_size: int, method: str, shards: int,
                 shard_axis: str, device):
    """The sharded index of ``method`` over ``shards``: doc ranges
    (``sharded``), vocab ranges (``term_sharded``) or the grid of
    ``_grid_plan`` (``shard2d``); for ``sharded`` ``shard_axis`` picks the
    axis, ``auto`` by ``plan_placement`` on ``index``'s stats. Returns
    ``(corpus, method, lines)``, ``lines`` the reference's printed ones."""
    from repro_torch.retrieval import (CorpusStats, plan_placement,
                                       shard2d_index, shard_index,
                                       term_shard_index)

    plan, lines = None, []
    axis = {"term_sharded": "term", "shard2d": "2d"}.get(method, shard_axis)
    if axis == "auto":
        plan = plan_placement(CorpusStats.from_index(index), shards)
        axis = plan.axis
        lines.append(f"auto shard plan -> {plan.describe()}: {plan.reason}")
    if axis == "2d":
        plan = plan or _grid_plan(shards)
        corpus = shard2d_index(reps, vocab_size, plan.doc_shards,
                               plan.term_shards, device=device)
        lines.append(f"2d-sharded index: {plan.doc_shards} doc chunks x "
                     f"{plan.term_shards} vocab ranges (psum over terms, "
                     f"top-k merge over docs)")
        return corpus, "shard2d", lines
    if axis == "term":
        corpus = term_shard_index(reps, vocab_size, shards, device=device)
        lines.append(f"term-sharded index: {shards} shards x "
                     f"{corpus.local_vocab} vocab terms (partial-sum merge)")
        return corpus, "term_sharded", lines
    corpus = shard_index(reps, vocab_size, shards, device=device)
    lines.append(f"sharded index: {shards} shards x "
                 f"{corpus.docs_per_shard} docs")
    return corpus, "sharded", lines


def engine_plan(shard_axis: str, shards: int, corpus: int, rep_topk: int,
                vocab_size: int, quantize: bool):
    """An ``--engine`` base's placement: ``(CorpusEngine kwargs, lines)``.
    ``auto`` plans from estimated stats (no corpus exists before the
    build: the requested doc count and the sparsifier's budget bound the
    posting mass), ``2d`` takes ``_grid_plan``, ``term`` the vocab ranges;
    a quantized base stays one index."""
    from repro_torch.retrieval import CorpusStats, plan_placement

    if shard_axis == "auto" and not quantize:
        est = CorpusStats(posting_bytes=8 * corpus * min(16, rep_topk),
                          vocab_size=vocab_size, n_docs=corpus)
        plan = plan_placement(est, shards)
        return {"plan": plan}, [f"auto shard plan (estimated stats) -> "
                                f"{plan.describe()}: {plan.reason}"]
    if shard_axis == "auto":
        return {}, ["auto shard axis with --quantize: the base is "
                    "compressed, not partitioned -> doc (single-index "
                    "base)"]
    if shard_axis == "2d":
        plan = _grid_plan(shards)
        return {"plan": plan}, [f"2d shard plan -> {plan.describe()}"]
    return {"shard_axis": "term" if shard_axis == "term" else "doc",
            "n_shards": shards}, []


def grow_engine(engine, vocab_size: int, n_docs: int, *, batch: int,
                rng: np.random.Generator, remove_frac: float = 0.0) -> None:
    """Grow ``engine``'s corpus online by ``n_docs`` random docs, one
    ``add_docs`` + ``flush`` per batch (each batch is searchable as it
    arrives); then tombstone ``remove_frac`` of the first ``n_docs``
    external ids and flush."""
    for lo in range(0, n_docs, batch):
        n = min(batch, n_docs - lo)
        engine.add_docs([rng.integers(1, vocab_size, size=DOC_TOKENS)
                         .astype(np.int32) for _ in range(n)])
        engine.flush()
    if remove_frac > 0:
        drop = rng.choice(n_docs, size=int(remove_frac * n_docs),
                          replace=False)
        engine.remove_docs(drop.tolist())
        engine.flush()


def deadline_s(deadline_ms: Optional[float]) -> Optional[float]:
    return deadline_ms / 1e3 if deadline_ms is not None else None


def serve_requests(encode: Callable, vocab_size: int, n_requests: int, *,
                   rng: np.random.Generator, continuous: bool = False,
                   deadline_ms: Optional[float] = None,
                   max_queue: int = 1024):
    """Push ``n_requests`` random queries through the batching loop
    (admission bounded at ``max_queue``, each request's SLO
    ``deadline_ms``, earliest-deadline-first when ``continuous``).
    Returns ``(loop, {uid: outcome})``."""
    from repro_torch.runtime.serving import (AdmissionPolicy, BatchedEncoder,
                                             BatchPolicy, Request,
                                             ServingLoop)

    loop = ServingLoop(
        BatchedEncoder(encode,
                       policy=BatchPolicy(max_batch=16, max_wait_s=0.002)),
        admission=AdmissionPolicy(max_queue_depth=max_queue),
        continuous=continuous)
    for uid in range(n_requests):
        n = int(rng.integers(4, 24))
        loop.submit(Request(uid=uid, tokens=rng.integers(
            1, vocab_size, size=n).astype(np.int32),
            deadline_s=deadline_s(deadline_ms)))
        loop.tick()
    loop.drain()
    outcomes = {uid: loop.take(uid) for uid in range(n_requests)}
    if loop.completed:
        raise RuntimeError("take() left results behind")
    return loop, outcomes


def run(encode: Callable, vocab_size: int, *, corpus: int, requests: int,
        topk: int, method: str, index_batch: int, device, engine=None,
        remove_frac: float = 0.0, prune_margin: Optional[float] = None,
        continuous: bool = False, deadline_ms: Optional[float] = None,
        max_queue: int = 1024, cache_mb: float = 0.0, shards: int = 2,
        shard_axis: str = "doc") -> Dict[str, Any]:
    """Index, serve, retrieve. Returns what each stage produced and took
    (host seconds, each stage ending in a device synchronisation); its
    ``"index"`` is the ``InvertedIndex`` (a ``QuantizedIndex`` for
    ``method="quantized"``, the raw one then in ``"raw_index"``; with its
    forward rows for ``method="pruned"``), for dense reps the dense
    corpus, and with an ``engine`` (a ``CorpusEngine``, grown here by
    ``grow_engine``; ``corpus=0`` serves it as it is) the engine, searched
    with ``method``, or with ``method="pruned"`` at ``prune_margin`` when
    that is given. A sharded ``method`` searches ``shard_corpus``'s index
    over ``shards`` (``shard_axis`` for ``sharded``; the raw index in
    ``"raw_index"``, the method it resolved to in ``"method"``, the printed
    lines in ``"shard_lines"``). The loop takes ``continuous``,
    ``deadline_ms`` and ``max_queue`` (``serve_requests``). With ``cache_mb > 0`` the engine is
    searched through a ``CachedEngine`` (``"cached"``; ``fused`` unless
    pruned) twice: ``"passes"`` holds each pass's ``(vals, ids,
    seconds)``, ``"vals"``/``"idx"`` the second's."""
    from repro_torch.retrieval.engine.quantize import quantize_index
    from repro_torch.retrieval.index import build_inverted_index
    from repro_torch.retrieval.score import resolve_method, retrieve
    from repro_torch.retrieval.sparse_rep import SparseRep, stack_rows
    from repro_torch.runtime.serving import FailedResult, ShedResult

    rng = np.random.default_rng(SEED)
    out = {}
    t0 = time.perf_counter()
    if engine is not None:
        grow_engine(engine, vocab_size, corpus, batch=index_batch, rng=rng,
                    remove_frac=remove_frac)
        index = engine
    elif method in SHARDED:
        reps = encode_corpus(encode, vocab_size, corpus, batch=index_batch,
                             rng=rng, device=device)
        raw = build_inverted_index(reps, vocab_size, device=device)
        index, method, out["shard_lines"] = shard_corpus(
            reps, raw, vocab_size, method, shards, shard_axis, device)
        out["raw_index"] = raw
    else:
        index = index_corpus(encode, vocab_size, corpus, batch=index_batch,
                             rng=rng, device=device,
                             keep_forward=method == "pruned")
        if method == "quantized":
            out["raw_index"] = index
            index = quantize_index(index)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    index_s = time.perf_counter() - t0

    cached = None
    if cache_mb > 0:
        from repro_torch.runtime.frontier import (CachedEngine,
                                                  HotPostingCache,
                                                  QueryResultCache)

        if engine is None:
            raise ValueError("cache_mb needs an engine")
        cache_bytes = int(cache_mb * 2**20)
        cached = CachedEngine(
            engine, result_cache=QueryResultCache(cache_bytes),
            hot_cache=HotPostingCache(cache_bytes // 4))

    t0 = time.perf_counter()
    loop, outcomes = serve_requests(
        encode, vocab_size, requests, rng=rng, continuous=continuous,
        deadline_ms=deadline_ms, max_queue=max_queue)
    serve_s = time.perf_counter() - t0
    served = [r for r in outcomes.values()
              if not isinstance(r, (ShedResult, FailedResult))]

    search_kw = {"method": method}
    if engine is not None and prune_margin is not None:
        search_kw = {"method": "pruned", "prune_margin": prune_margin}
    elif cached is not None:
        # auto picks impact below 16384 docs: fused engages the hot
        # windows at any size
        search_kw = {"method": "fused"}
    out.update(index=index, index_s=index_s, loop=loop, outcomes=outcomes,
               serve_s=serve_s, served=served, cached=cached,
               method=(engine.builder.resolved_method(search_kw["method"])
                       if engine is not None else resolve_method(method,
                                                                 index)))
    if served:
        if isinstance(served[0], SparseRep):
            queries = stack_rows(served[:N_QUERIES])
        else:
            queries = torch.from_numpy(np.stack(served[:N_QUERIES]))
        t0 = time.perf_counter()
        if cached is not None:
            # the second pass is the cache's: every row keyed as before
            passes = []
            for _ in range(2):
                t1 = time.perf_counter()
                vals, idx = cached.search(queries, topk, **search_kw)
                passes.append((vals, idx, time.perf_counter() - t1))
            out["passes"] = passes
        elif engine is not None:
            vals, idx = engine.search(queries, topk, **search_kw)
        else:
            vals, idx = retrieve(queries, index, topk, method=method)
            if vals.is_cuda:
                torch.cuda.synchronize(vals.device)
        out.update(queries=queries, vals=vals, idx=idx,
                   retrieve_s=time.perf_counter() - t0)
    return out


def run_tenants(encode: Callable, vocab_size: int, *, tenants: int,
                corpus: int, requests: int, topk: int, index_batch: int,
                device, cache_mb: float = 0.0, continuous: bool = False,
                deadline_ms: Optional[float] = None,
                keep_forward: bool = False,
                mark: Optional[Callable[[int, str, np.ndarray],
                                        np.ndarray]] = None
                ) -> Dict[str, Any]:
    """Provision, serve and search ``tenants`` corpora over one encoder
    through a ``TenantPool`` (tenant ``t{i}`` at weight ``i + 1``, the
    corpus split evenly, one ``add_docs`` each; a shared result cache of
    ``cache_mb`` and per-tenant hot caches of a quarter of it). Request
    ``uid`` goes to tenant ``uid % tenants`` with SLO ``deadline_ms``, one
    ``tick`` after each submit, then ``drain``. ``mark(uid, tenant,
    tokens)``, when given, returns the tokens submitted in place of the
    drawn ones (the draws are unchanged): fault drills mark requests with
    it. Each tenant's first 4 served reps are searched with ``fused``,
    twice when caching. Returns the pool, the names, each request's
    ``(tenant, outcome)``, the ticks' ``(tenant, n)`` dispatches, each
    tenant's ``queries`` and ``searches`` (``(vals, ids)`` a pass) and the
    stages' host seconds."""
    from repro_torch.retrieval.sparse_rep import stack_rows
    from repro_torch.runtime.frontier import TenantPool, TenantQuota
    from repro_torch.runtime.serving import (BatchedEncoder, BatchPolicy,
                                             FailedResult, Request,
                                             ShedResult)

    rng = np.random.default_rng(SEED)
    cache_bytes = int(cache_mb * 2**20)
    pool = TenantPool(
        BatchedEncoder(encode, policy=BatchPolicy(max_batch=index_batch)),
        cache_bytes=cache_bytes, hot_cache_bytes=cache_bytes // 4,
        continuous=continuous)
    names = [f"t{i}" for i in range(tenants)]
    for i, name in enumerate(names):
        pool.add_tenant(name, vocab_size,
                        quota=TenantQuota(weight=float(i + 1)),
                        keep_forward=keep_forward, device=device)
    t0 = time.perf_counter()
    per = max(1, corpus // tenants)
    for name in names:
        pool.add_docs(name, [rng.integers(1, vocab_size, size=DOC_TOKENS)
                             .astype(np.int32) for _ in range(per)])
    provision_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    dispatches = []
    for uid in range(requests):
        name = names[uid % tenants]
        n = int(rng.integers(4, 24))
        tokens = rng.integers(1, vocab_size, size=n).astype(np.int32)
        if mark is not None:
            tokens = mark(uid, name, tokens)
        pool.submit(name, Request(uid=uid, tokens=tokens,
                                  deadline_s=deadline_s(deadline_ms)))
        dispatches.append(pool.tick())
    pool.drain()
    serve_s = time.perf_counter() - t0
    outcomes = {uid: (names[uid % tenants],
                      pool.take(names[uid % tenants], uid))
                for uid in range(requests)}

    t0 = time.perf_counter()
    queries, searches = {}, {}
    for name in names:
        rows = [r for tenant, r in outcomes.values() if tenant == name
                and not isinstance(r, (ShedResult, FailedResult))][:4]
        if not rows:
            continue
        queries[name] = stack_rows(rows)
        searches[name] = [pool.search(name, queries[name], topk,
                                      method="fused")
                          for _ in range(2 if cache_bytes else 1)]
    return {"pool": pool, "names": names, "per_tenant_docs": per,
            "outcomes": outcomes, "dispatches": [d for d in dispatches
                                                 if d[1]],
            "queries": queries, "searches": searches,
            "provision_s": provision_s, "serve_s": serve_s,
            "search_s": time.perf_counter() - t0}


def print_tenants(res: Dict[str, Any]) -> None:
    """The tenant mode's lines: the provisioning, one line a tenant, the
    shared result cache's."""
    pool, names = res["pool"], res["names"]
    print(f"provisioned {len(names)} tenants x {res['per_tenant_docs']} "
          f"docs in {res['provision_s'] * 1e3:.1f} ms "
          f"({pool.memory_bytes() / 2**20:.2f} MiB pooled)")
    st = pool.stats()
    for name in names:
        t = st["tenants"][name]
        line = (f"tenant {name}: weight {t['weight']}, {t['live_docs']} "
                f"docs, served {t['served']} / shed {t['shed']} / failed "
                f"{t['failed']}")
        if "cache" in t:
            c = t["cache"]["results"]
            line += f", cache hits {c['hits']}/{c['hits'] + c['misses']}"
            if "hot" in t["cache"]:
                line += f", {t['cache']['hot']['bytes_pinned']} B pinned"
        print(line)
    if "result_cache" in st:
        rc = st["result_cache"]
        print(f"shared result cache: hit ratio {rc['hit_rate']}, "
              f"{rc['bytes_used']}/{rc['capacity_bytes']} B used, "
              f"{rc['evictions']} evictions, {rc['invalidations']} "
              f"invalidations")


def main(argv=None) -> int:
    from repro_torch.configs import (ALIASES, ARCHS, GNN_ARCHS, RECSYS_ARCHS,
                                     get_config)
    from repro_torch.device import resolve_device
    from repro_torch.retrieval.score import INDEX_METHODS, METHODS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="splade_bert",
                    help=f"one of {', '.join(ARCHS)} or a JAX alias "
                         f"({', '.join(ALIASES)}) but the recsys archs "
                         f"and dimenet; "
                         f"a decoder (dense or MoE) serves through its "
                         f"causal trunk")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--corpus", type=int, default=1000)
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--rep-topk", type=int, default=64,
                    help="per-row term budget of the on-device rep "
                         "sparsifier; 0 = dense reps and a dense (N, V) "
                         "corpus")
    ap.add_argument("--method", default="auto", choices=METHODS,
                    help="retrieval path (repro_torch.retrieval.retrieve)")
    ap.add_argument("--shards", type=int, default=2,
                    help="--method sharded/term_sharded/shard2d or an "
                         "--engine base: the shard count (scored in this "
                         "one process)")
    ap.add_argument("--shard-axis", default="doc",
                    choices=("auto", "doc", "term", "2d"),
                    help="sharding axis for --method sharded or an "
                         "--engine base: doc = contiguous doc ranges "
                         "(all_gather + re-top-k merge), term = vocab "
                         "ranges with whole posting lists (partial-sum "
                         "psum merge; the huge-|V| regime), 2d = the (doc "
                         "x term) grid composing both, auto = "
                         "plan_placement picks the (doc_shards, "
                         "term_shards, replicas) grid from posting bytes "
                         "against the O(V) directory (a frozen build sizes "
                         "the real index; --engine plans from the "
                         "requested corpus size and rep budget)")
    ap.add_argument("--head-impl", default=None,
                    help="override the config's head backend (naive, "
                         "tiled, sparton or kernel; default kernel)")
    ap.add_argument("--index-batch", type=int, default=64,
                    help="corpus encoding batch size")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    ap.add_argument("--engine", action="store_true",
                    help="grow the corpus online through the incremental "
                         "IndexBuilder instead of one frozen build")
    ap.add_argument("--quantize", action="store_true",
                    help="engine mode: serve the base segment as a "
                         "compressed QuantizedIndex")
    ap.add_argument("--prune-margin", type=float, default=None,
                    metavar="M",
                    help="engine mode: retrieve through the two-tier "
                         "pruned scorer with this margin (0 = safe)")
    ap.add_argument("--remove-frac", type=float, default=0.0,
                    help="engine mode: tombstone this fraction of the "
                         "corpus after it has grown (exercises remove + "
                         "compaction)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    metavar="MS",
                    help="per-request SLO: the loop sheds requests whose "
                         "estimated or actual queue delay passes it "
                         "(default: best-effort, never shed)")
    ap.add_argument("--max-queue", type=int, default=1024,
                    help="admission bound on queue depth; submits beyond "
                         "it are shed with a ShedResult")
    ap.add_argument("--cache-mb", type=float, default=0.0, metavar="MB",
                    help="engine mode: search through the frontier's "
                         "result cache (and a hot-posting-window cache "
                         "of a quarter of it) with this byte budget; 0 = "
                         "off")
    ap.add_argument("--tenants", type=int, default=0, metavar="N",
                    help="engine mode: serve N weighted tenants over one "
                         "encoder through the TenantPool scheduler "
                         "instead of a single corpus")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching: admit requests into the "
                         "next batch in earliest-deadline-first order "
                         "instead of FIFO")
    args = ap.parse_args(argv)
    # method/rep compatibility is knowable before spending minutes
    # encoding the corpus: reject bad combinations at argparse time
    if args.method in ("dense", "streaming") and args.rep_topk > 0:
        ap.error(f"--method {args.method} needs the dense corpus matrix; "
                 "pass --rep-topk 0 to keep it (or use --method "
                 "impact/fused/auto with the sparse index)")
    if args.method in INDEX_METHODS and args.rep_topk <= 0:
        ap.error(f"--method {args.method} needs SparseRep queries and an "
                 "index; pass a positive --rep-topk")
    if args.shard_axis in ("term", "2d") and args.quantize:
        ap.error(f"--shard-axis {args.shard_axis} and --quantize are "
                 "exclusive (the base segment is either partitioned or "
                 "compressed)")
    if args.shards < 1:
        ap.error("--shards must be >= 1")
    if ((args.quantize or args.prune_margin is not None or args.remove_frac)
            and not args.engine):
        ap.error("--quantize/--prune-margin/--remove-frac need --engine")
    if args.engine and args.rep_topk <= 0:
        ap.error("--engine needs sparse reps; pass a positive --rep-topk")
    if args.engine and args.quantize and args.prune_margin is not None:
        ap.error("--quantize and --prune-margin are exclusive (the pruned "
                 "rescorer reads raw forward rows)")
    if args.engine and args.method != "auto":
        ap.error("--engine picks its retrieval path from "
                 "--quantize/--prune-margin; drop --method (the builder's "
                 "segments are searched via 'auto')")
    if (args.cache_mb > 0 or args.tenants > 0) and not args.engine:
        ap.error("--cache-mb/--tenants need --engine (cache keys and "
                 "tenant corpora live on the IndexBuilder)")
    if args.tenants < 0:
        ap.error("--tenants must be >= 0")
    try:
        arch = get_config(args.arch)
    except ValueError as e:
        ap.error(str(e))
    if arch.__name__.rsplit(".", 1)[-1] in RECSYS_ARCHS:
        ap.error(f"--arch {args.arch}: a recsys arch has no LSR head to "
                 "serve; its serving steps are launch.steps."
                 "build_recsys_serve_step and build_retrieval_step")
    if arch.__name__.rsplit(".", 1)[-1] in GNN_ARCHS:
        ap.error(f"--arch {args.arch}: DimeNet (the GNN family) has no LSR "
                 "head to serve; it trains through "
                 "repro_torch.examples.train_dimenet")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))

    from repro_torch.models.transformer import init_params
    from repro_torch.runtime.serving import make_config_encoder

    cfg = arch.SMOKE
    overrides = {"rep_topk": args.rep_topk if args.rep_topk > 0 else None}
    if args.head_impl:
        overrides["head_impl"] = args.head_impl
    cfg = dataclasses.replace(cfg, **overrides)
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg)
    encode = make_config_encoder(params, cfg)

    if args.tenants > 0:
        res = run_tenants(
            encode, cfg.vocab_size, tenants=args.tenants, corpus=args.corpus,
            requests=args.requests, topk=args.topk,
            index_batch=args.index_batch, device=device,
            cache_mb=args.cache_mb, continuous=args.continuous,
            deadline_ms=args.deadline_ms,
            keep_forward=args.prune_margin is not None)
        print_tenants(res)
        return 0

    engine = None
    if args.engine:
        from repro_torch.runtime.serving import (BatchedEncoder, BatchPolicy,
                                                 CorpusEngine)

        placement, lines = engine_plan(args.shard_axis, args.shards,
                                       args.corpus, args.rep_topk,
                                       cfg.vocab_size, args.quantize)
        for line in lines:
            print(line)
        engine = CorpusEngine(
            BatchedEncoder(encode,
                           policy=BatchPolicy(max_batch=args.index_batch)),
            cfg.vocab_size, quantize=args.quantize,
            keep_forward=args.prune_margin is not None, device=device,
            **placement)
    res = run(encode, cfg.vocab_size, corpus=args.corpus,
              requests=args.requests, topk=args.topk, method=args.method,
              index_batch=args.index_batch, device=device, engine=engine,
              remove_frac=args.remove_frac, prune_margin=args.prune_margin,
              continuous=args.continuous, deadline_ms=args.deadline_ms,
              max_queue=args.max_queue, cache_mb=args.cache_mb,
              shards=args.shards, shard_axis=args.shard_axis)
    corpus = res["index"]
    if engine is not None:
        st = engine.stats()
        shards = (f", term shards: {st['term_shards']}"
                  if st["term_shards"] else "")
        if st["doc_shards"]:
            shards = (f", grid: {st['doc_shards']}x"
                      f"{st['grid_term_shards']} (doc x term)")
        print(f"engine-indexed {st['n_alive']} live docs ({st['n_dead']} "
              f"tombstoned, {st['n_compactions']} compactions, quantized "
              f"base: {st['quantized_base']}{shards}) in "
              f"{res['index_s'] * 1e3:.1f} ms")
    elif isinstance(corpus, torch.Tensor):
        print(f"indexed {corpus.shape[0]} docs dense in "
              f"{res['index_s'] * 1e3:.1f} ms "
              f"({corpus.nbytes / 2**20:.2f} MiB)")
    else:
        raw = res.get("raw_index", corpus)
        st = raw.stats()
        print(f"indexed {st['n_docs']} docs in {res['index_s'] * 1e3:.1f} "
              f"ms: {st['n_postings']} postings over {st['active_terms']} "
              f"terms, {st['memory_bytes'] / 2**20:.2f} MiB (dense (N, V) "
              f"would be {args.corpus * cfg.vocab_size * 4 / 2**20:.2f} "
              f"MiB)")
        if "shard_lines" in res:
            for line in res["shard_lines"]:
                print(line)
        elif raw is not corpus:
            print(f"quantized index: {corpus.memory_bytes() / 2**20:.2f} "
                  f"MiB (1/{raw.memory_bytes() / corpus.memory_bytes():.2f} "
                  f"of raw)")
    loop = res["loop"]
    ls = loop.stats()
    print(f"encoded {len(res['served'])}/{args.requests} requests in "
          f"{res['serve_s'] * 1e3:.1f} ms ({ls['shed']} shed, "
          f"{ls['failed']} failed), batches: {list(loop.batch_sizes)}, "
          f"occupancy {ls['batch_occupancy']:.2f}, "
          f"p99 {ls['p99_latency_s'] * 1e3:.1f} ms")
    if "vals" not in res:
        if args.deadline_ms is not None:
            print("every request shed — deadline too tight for this host; "
                  "nothing to retrieve")
            return 0
        print("no request served; nothing to retrieve")
        return 1
    tag = res["method"]
    if engine is not None and args.prune_margin is not None:
        tag = "engine/pruned"
    if res["cached"] is not None:
        tag += "/cached"
    print(f"retrieval[{tag}]: top-{args.topk} for "
          f"{res['vals'].shape[0]} queries in "
          f"{res['retrieve_s'] * 1e3:.1f} ms, best scores "
          f"{[round(float(v), 2) for v in res['vals'][:, 0]]}")
    if res["cached"] is not None:
        cs = res["cached"].stats()
        rc, hot = cs["results"], cs.get("hot")
        line = (f"frontier cache: hit ratio {rc['hit_rate']}, "
                f"{rc['bytes_used']}/{rc['capacity_bytes']} B used, "
                f"{rc['evictions']} evictions, {rc['invalidations']} "
                f"invalidations")
        if hot is not None:
            line += (f"; hot windows: {hot['pinned_terms']} terms, "
                     f"{hot['bytes_pinned']} B pinned")
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
