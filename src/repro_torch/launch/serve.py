"""Serving entry point: ``python -m repro_torch.launch.serve``.

The pipeline of ``repro/launch/serve.py``, end to end:

1. index    — encode a synthetic corpus (16-token docs) through the
              trunk and the Sparton head, sparsify on the device
              (``--rep-topk``), build the inverted impact index
              (``--method quantized`` compresses it, ``--method pruned``
              keeps its forward rows); with ``--rep-topk 0`` keep the
              dense reps as an ``(N, V)`` f32 corpus on the device
              instead. With ``--engine`` the corpus grows online
              through a ``CorpusEngine``: one ``add_docs`` + ``flush`` per
              batch, ``--remove-frac`` of it tombstoned at the end, the
              base segment compressed with ``--quantize``, or the
              segments' forward rows kept with ``--prune-margin``.
2. serve    — stream queries (4–24 tokens) through the deadline/size
              micro-batching loop; results are popped with ``take``.
3. retrieve — top-k of the first served queries through
              ``retrieve(method=--method)``, or the engine's ``search``
              (``auto`` on each segment; with ``--prune-margin M`` the
              two-tier ``pruned`` method at margin M).

It runs the config's SMOKE size with seeded random weights on
``--device`` (default ``cuda``; ``--device cpu`` runs the kernels' plain
versions). ``run`` is the same pipeline for any encode fn and config;
``chip_smoke.py`` drives it at full width. The tenants, cache, admission
and sharding flags of the JAX entry point arrive with their slices.
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


def index_corpus(encode: Callable, vocab_size: int, n_docs: int, *,
                 batch: int, rng: np.random.Generator, device,
                 keep_forward: bool = False):
    """Encode ``n_docs`` random docs in batches. Sparse reps are indexed
    (an ``InvertedIndex``, with its forward rows when ``keep_forward``);
    dense reps are written, batch by batch, into one ``(n_docs, V)`` f32
    tensor on ``device``, the layout the streaming kernel reads in
    place."""
    from repro_torch.retrieval.index import build_inverted_index
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
    if dense is not None:
        return dense
    return build_inverted_index(stack_rows(parts), vocab_size,
                                keep_forward=keep_forward, device=device)


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


def serve_requests(encode: Callable, vocab_size: int, n_requests: int, *,
                   rng: np.random.Generator):
    """Push ``n_requests`` random queries through the batching loop.
    Returns ``(loop, {uid: outcome})``."""
    from repro_torch.runtime.serving import (BatchedEncoder, BatchPolicy,
                                             Request, ServingLoop)

    loop = ServingLoop(BatchedEncoder(
        encode, policy=BatchPolicy(max_batch=16, max_wait_s=0.002)))
    for uid in range(n_requests):
        n = int(rng.integers(4, 24))
        loop.submit(Request(uid=uid, tokens=rng.integers(
            1, vocab_size, size=n).astype(np.int32)))
        loop.tick()
    loop.drain()
    outcomes = {uid: loop.take(uid) for uid in range(n_requests)}
    if loop.completed:
        raise RuntimeError("take() left results behind")
    return loop, outcomes


def run(encode: Callable, vocab_size: int, *, corpus: int, requests: int,
        topk: int, method: str, index_batch: int, device, engine=None,
        remove_frac: float = 0.0,
        prune_margin: Optional[float] = None) -> Dict[str, Any]:
    """Index, serve, retrieve. Returns what each stage produced and took
    (host seconds, each stage ending in a device synchronisation); its
    ``"index"`` is the ``InvertedIndex`` (a ``QuantizedIndex`` for
    ``method="quantized"``, the raw one then in ``"raw_index"``; with its
    forward rows for ``method="pruned"``), for dense reps the dense
    corpus, and with an ``engine`` (a ``CorpusEngine``, grown here by
    ``grow_engine``) the engine, searched with ``method``, or with
    ``method="pruned"`` at ``prune_margin`` when that is given."""
    from repro_torch.retrieval.engine.quantize import quantize_index
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

    t0 = time.perf_counter()
    loop, outcomes = serve_requests(encode, vocab_size, requests, rng=rng)
    serve_s = time.perf_counter() - t0
    served = [r for r in outcomes.values()
              if not isinstance(r, (ShedResult, FailedResult))]

    search_kw = {"method": method}
    if engine is not None and prune_margin is not None:
        search_kw = {"method": "pruned", "prune_margin": prune_margin}
    out.update(index=index, index_s=index_s, loop=loop, outcomes=outcomes,
               serve_s=serve_s, served=served,
               method=(engine.builder.resolved_method(search_kw["method"])
                       if engine is not None else resolve_method(method,
                                                                 index)))
    if served:
        if isinstance(served[0], SparseRep):
            queries = stack_rows(served[:N_QUERIES])
        else:
            queries = torch.from_numpy(np.stack(served[:N_QUERIES]))
        t0 = time.perf_counter()
        if engine is not None:
            vals, idx = engine.search(queries, topk, **search_kw)
        else:
            vals, idx = retrieve(queries, index, topk, method=method)
            if vals.is_cuda:
                torch.cuda.synchronize(vals.device)
        out.update(queries=queries, vals=vals, idx=idx,
                   retrieve_s=time.perf_counter() - t0)
    return out


def main(argv=None) -> int:
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.device import resolve_device
    from repro_torch.retrieval.score import INDEX_METHODS, METHODS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="splade_bert", choices=ARCHS)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--corpus", type=int, default=1000)
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--rep-topk", type=int, default=64,
                    help="per-row term budget of the on-device rep "
                         "sparsifier; 0 = dense reps and a dense (N, V) "
                         "corpus")
    ap.add_argument("--method", default="auto", choices=METHODS,
                    help="retrieval path (repro_torch.retrieval.retrieve)")
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
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))

    from repro_torch.models.transformer import init_params
    from repro_torch.runtime.serving import make_config_encoder

    cfg = get_config(args.arch).SMOKE
    overrides = {"rep_topk": args.rep_topk if args.rep_topk > 0 else None}
    if args.head_impl:
        overrides["head_impl"] = args.head_impl
    cfg = dataclasses.replace(cfg, **overrides)
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg)
    encode = make_config_encoder(params, cfg)

    engine = None
    if args.engine:
        from repro_torch.runtime.serving import (BatchedEncoder, BatchPolicy,
                                                 CorpusEngine)

        engine = CorpusEngine(
            BatchedEncoder(encode,
                           policy=BatchPolicy(max_batch=args.index_batch)),
            cfg.vocab_size, quantize=args.quantize,
            keep_forward=args.prune_margin is not None, device=device)
    res = run(encode, cfg.vocab_size, corpus=args.corpus,
              requests=args.requests, topk=args.topk, method=args.method,
              index_batch=args.index_batch, device=device, engine=engine,
              remove_frac=args.remove_frac, prune_margin=args.prune_margin)
    corpus = res["index"]
    if engine is not None:
        st = engine.stats()
        print(f"engine-indexed {st['n_alive']} live docs ({st['n_dead']} "
              f"tombstoned, {st['n_compactions']} compactions, quantized "
              f"base: {st['quantized_base']}) in "
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
        if raw is not corpus:
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
        print("no request served; nothing to retrieve")
        return 1
    tag = res["method"]
    if engine is not None and args.prune_margin is not None:
        tag = "engine/pruned"
    print(f"retrieval[{tag}]: top-{args.topk} for "
          f"{res['vals'].shape[0]} queries in "
          f"{res['retrieve_s'] * 1e3:.1f} ms, best scores "
          f"{[round(float(v), 2) for v in res['vals'][:, 0]]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
