"""Serving entry point: ``python -m repro_torch.launch.serve``.

The frozen-index path of ``repro/launch/serve.py``, end to end:

1. index    — encode a synthetic corpus (16-token docs) through the
              trunk and the Sparton head, sparsify on the device
              (``--rep-topk``), build the inverted impact index.
2. serve    — stream queries (4–24 tokens) through the deadline/size
              micro-batching loop; results are popped with ``take``.
3. retrieve — top-k of the first served queries through
              ``retrieve(method=--method)``.

It runs the config's SMOKE size with seeded random weights on
``--device`` (default ``cuda``; ``--device cpu`` runs the kernels' plain
versions). ``run`` is the same pipeline for any encode fn and config;
``chip_smoke.py`` drives it at full width. The engine, tenants, cache
and sharding flags of the JAX entry point arrive with their slices.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Any, Callable, Dict

import numpy as np
import torch

DOC_TOKENS = 16
N_QUERIES = 8   # served queries that go on to retrieval
SEED = 0        # the synthetic corpus and requests


def index_corpus(encode: Callable, vocab_size: int, n_docs: int, *,
                 batch: int, rng: np.random.Generator, device):
    """Encode ``n_docs`` random docs in batches and index their reps."""
    from repro_torch.retrieval.index import build_inverted_index
    from repro_torch.retrieval.sparse_rep import stack_rows

    parts = []
    for lo in range(0, n_docs, batch):
        n = min(batch, n_docs - lo)
        toks = rng.integers(1, vocab_size, size=(n, DOC_TOKENS))
        parts.append(encode(torch.from_numpy(toks.astype(np.int32)),
                            torch.ones((n, DOC_TOKENS), dtype=torch.int32)))
    return build_inverted_index(stack_rows(parts), vocab_size,
                                device=device)


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
        topk: int, method: str, index_batch: int, device) -> Dict[str, Any]:
    """Index, serve, retrieve. Returns what each stage produced and took
    (host seconds, each stage ending in a device synchronisation)."""
    from repro_torch.retrieval.score import resolve_method, retrieve
    from repro_torch.retrieval.sparse_rep import stack_rows
    from repro_torch.runtime.serving import FailedResult, ShedResult

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    index = index_corpus(encode, vocab_size, corpus, batch=index_batch,
                         rng=rng, device=device)
    index_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    loop, outcomes = serve_requests(encode, vocab_size, requests, rng=rng)
    serve_s = time.perf_counter() - t0
    served = [r for r in outcomes.values()
              if not isinstance(r, (ShedResult, FailedResult))]

    out = {"index": index, "index_s": index_s, "loop": loop,
           "outcomes": outcomes, "serve_s": serve_s, "served": served,
           "method": resolve_method(method, index)}
    if served:
        queries = stack_rows(served[:N_QUERIES])
        t0 = time.perf_counter()
        vals, idx = retrieve(queries, index, topk, method=method)
        if vals.is_cuda:
            torch.cuda.synchronize(vals.device)
        out.update(queries=queries, vals=vals, idx=idx,
                   retrieve_s=time.perf_counter() - t0)
    return out


def main(argv=None) -> int:
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.device import resolve_device
    from repro_torch.retrieval.score import METHODS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="splade_bert", choices=ARCHS)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--corpus", type=int, default=1000)
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--rep-topk", type=int, default=64,
                    help="per-row term budget of the on-device rep "
                         "sparsifier (the port serves sparse reps only)")
    ap.add_argument("--method", default="auto", choices=METHODS,
                    help="retrieval path (repro_torch.retrieval.retrieve)")
    ap.add_argument("--head-impl", default=None,
                    help="override the config's head backend (naive, "
                         "tiled, sparton or kernel)")
    ap.add_argument("--index-batch", type=int, default=64,
                    help="corpus encoding batch size")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    args = ap.parse_args(argv)
    if args.rep_topk <= 0:
        ap.error("--rep-topk must be positive: the port's retrieval "
                 "methods need sparse reps and an inverted index")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))

    from repro_torch.models.transformer import init_params
    from repro_torch.runtime.serving import make_config_encoder

    cfg = get_config(args.arch).SMOKE
    overrides = {"rep_topk": args.rep_topk}
    if args.head_impl:
        overrides["head_impl"] = args.head_impl
    cfg = dataclasses.replace(cfg, **overrides)
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg)
    encode = make_config_encoder(params, cfg)

    res = run(encode, cfg.vocab_size, corpus=args.corpus,
              requests=args.requests, topk=args.topk, method=args.method,
              index_batch=args.index_batch, device=device)
    st = res["index"].stats()
    print(f"indexed {st['n_docs']} docs in {res['index_s'] * 1e3:.1f} ms: "
          f"{st['n_postings']} postings over {st['active_terms']} terms, "
          f"{st['memory_bytes'] / 2**20:.2f} MiB (dense (N, V) would be "
          f"{args.corpus * cfg.vocab_size * 4 / 2**20:.2f} MiB)")
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
    print(f"retrieval[{res['method']}]: top-{args.topk} for "
          f"{res['vals'].shape[0]} queries in "
          f"{res['retrieve_s'] * 1e3:.1f} ms, best scores "
          f"{[round(float(v), 2) for v in res['vals'][:, 0]]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
