"""Serving example: the sparse retrieval pipeline end to end, the port's
counterpart of the JAX package's ``examples/serve_retrieval.py``.

    python -m repro_torch.examples.serve_retrieval [--device cpu]
    python -m repro_torch.examples.serve_retrieval --engine --quantize
    python -m repro_torch.examples.serve_retrieval --engine --prune-margin 0.0
    python -m repro_torch.examples.serve_retrieval --engine --cache-mb 4

1. Index a synthetic corpus of 512 docs with the Sparton head (SMOKE
   splade_bert, reps sparsified on the device to their top 48 terms) into
   an inverted impact index; no dense (N, V) corpus matrix. With
   ``--engine`` the corpus is also grown online through a
   ``CorpusEngine`` (add + flush a batch at a time, the last 32 docs
   removed, then compacted), its base quantized with ``--quantize`` or
   kept with forward rows for ``--prune-margin``.
2. Serve 24 queries, each a doc's own tokens, through the deadline/size
   micro-batching loop; results are popped with ``take``.
3. Retrieve the top 5: (a) ``impact`` over the index, held against the
   ``dense`` method over the same reps, and the engine's search (through
   the two-tier pruned scorer at ``--prune-margin``, and with
   ``--cache-mb`` through the frontier's result and hot-posting caches,
   cache-on equal to cache-off); (b) ``streaming_topk`` on a (20000, 64)
   dense candidate matrix against K6 (``kernels/topk_score``).

Runs on ``cuda`` unless ``--device cpu`` is given (the kernels' plain
versions). The id checks are exact; on the card, where two methods sum
in different orders, ids that differ only where the two candidates'
scores lie within ``NEAR_TIE_TOL`` pass, and each such row is printed.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import TransformerConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.topk_score import topk_score
from repro_torch.launch.steps import init_state, streaming_topk
from repro_torch.retrieval.index import build_inverted_index
from repro_torch.retrieval.score import retrieve
from repro_torch.retrieval.sparse_rep import stack_rows
from repro_torch.runtime.serving import (BatchedEncoder, BatchPolicy,
                                         CorpusEngine, Request, ServingLoop,
                                         make_config_encoder)

CORPUS, QUERIES, K, REP_TOPK = 512, 24, 5, 48
DOC_LEN = 24
BATCH = 64        # encode and add batch
REMOVED = 32      # the corpus tail tombstoned in the engine
CAND, CAND_D, CAND_Q, CAND_TILE = 20000, 64, 4, 4096
# ids of two scorers may differ on the card only where the two candidates'
# scores lie this close, relative to 1 + |score| (chip_smoke's K6_TOL and
# SCORE_TOL): the same products summed in another order
NEAR_TIE_TOL = 1e-4


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--engine", action="store_true",
                    help="also grow the corpus online through a "
                         "CorpusEngine (IndexBuilder)")
    ap.add_argument("--quantize", action="store_true",
                    help="with --engine: serve the base segment as a "
                         "compressed QuantizedIndex")
    ap.add_argument("--prune-margin", type=float, default=None, metavar="M",
                    help="with --engine: search through the two-tier "
                         "pruned scorer at this margin (0 = safe)")
    ap.add_argument("--cache-mb", type=float, default=0.0, metavar="MB",
                    help="with --engine: also search through the frontier's "
                         "result + hot-posting caches at this byte budget "
                         "and check cache-on == cache-off")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    return ap


def check_args(ap: argparse.ArgumentParser, args: argparse.Namespace) -> None:
    """The flag exclusions; ``ap.error`` (exit 2) on a bad combination."""
    if (args.quantize or args.prune_margin is not None
            or args.cache_mb > 0) and not args.engine:
        ap.error("--quantize/--prune-margin/--cache-mb need --engine")
    if args.quantize and args.prune_margin is not None:
        ap.error("--quantize and --prune-margin are exclusive")


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def same_ids(name: str, got: np.ndarray, want: np.ndarray,
             scores: torch.Tensor, device: torch.device,
             held: Dict[str, bool]) -> None:
    """Require ``got == want`` (ids, one row a query). Records in
    ``held[name]`` whether they are equal. Where they are not, each row
    that differs is printed with both candidates' ``scores``; on the CPU
    that fails, on the card it fails unless every id that differs sits at
    a near tie (``NEAR_TIE_TOL``)."""
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    differ = got != want
    held[name] = not differ.any()
    if held[name]:
        return
    s = scores.float().cpu().numpy()
    s_got = np.take_along_axis(s, got, axis=1)
    s_want = np.take_along_axis(s, want, axis=1)
    for r in np.nonzero(differ.any(axis=1))[0]:
        print(f"{name}: row {r} ids {got[r].tolist()} scores "
              f"{s_got[r].tolist()} against ids {want[r].tolist()} scores "
              f"{s_want[r].tolist()}")
    near = np.abs(s_got - s_want) <= NEAR_TIE_TOL * (1 + np.abs(s_want))
    require(device.type == "cuda" and not (differ & ~near).any(),
            f"{name}: ids differ in rows "
            f"{np.nonzero(differ.any(axis=1))[0].tolist()}")


def build_engine(encode, vocab_size: int, doc_tokens: np.ndarray,
                 args: argparse.Namespace, device: torch.device
                 ) -> CorpusEngine:
    """The corpus grown online, one add + flush a batch, then the tail
    tombstoned and compacted away."""
    engine = CorpusEngine(
        BatchedEncoder(encode, policy=BatchPolicy(max_batch=BATCH)),
        vocab_size, quantize=args.quantize,
        keep_forward=args.prune_margin is not None, device=device)
    for lo in range(0, CORPUS, BATCH):
        engine.add_docs(list(doc_tokens[lo:lo + BATCH]))
        engine.flush()          # online growth: visible batch by batch
    engine.remove_docs(range(CORPUS - REMOVED, CORPUS))
    engine.flush(force_compact=True)
    st = engine.stats()
    print(f"engine-indexed {st['n_alive']} live docs "
          f"({st['n_compactions']} compactions, quantized base: "
          f"{st['quantized_base']})")
    return engine


def search_engine(engine: CorpusEngine, q_rep, idx: np.ndarray,
                  scores: torch.Tensor, args: argparse.Namespace,
                  device: torch.device, held: Dict[str, bool]
                  ) -> Dict[str, Any]:
    """The engine's search against the frozen index's ids on the rows
    whose frozen top-K holds no tombstoned doc (external ids are
    positions here); with ``--cache-mb`` also through the caches, miss
    and hit pass, each equal to cache-off."""
    kw = ({"method": "pruned", "prune_margin": args.prune_margin}
          if args.prune_margin is not None else {})
    vals_e, ids_e = engine.search(q_rep, K, **kw)
    rows_ok = (idx < CORPUS - REMOVED).all(axis=1)
    tag = "pruned" if kw else ("quantized" if args.quantize else "impact")
    if args.quantize or (args.prune_margin or 0) > 0:
        # lossy modes on an untrained random-rep corpus: the top-1 (an
        # exact-duplicate query's own doc, far ahead of the rest)
        same_ids("engine_top1", ids_e[rows_ok, :1], idx[rows_ok, :1],
                 scores[torch.from_numpy(rows_ok)], device, held)
        print(f"engine search [{tag}] top-1 == frozen-index top-1: True")
    else:
        same_ids("engine", ids_e[rows_ok], idx[rows_ok],
                 scores[torch.from_numpy(rows_ok)], device, held)
        print(f"engine search [{tag}] == frozen-index retrieval on live "
              f"docs: True")
    out = {"vals": vals_e, "ids": ids_e, "tag": tag,
           "stats": engine.stats()}
    if args.cache_mb > 0:
        from repro_torch.runtime.frontier import (CachedEngine,
                                                  HotPostingCache,
                                                  QueryResultCache)

        # a transparent layer: cache-on is cache-off, ids and values, on
        # the miss pass (cold) and the hit pass (every row from the cache)
        cache_bytes = int(args.cache_mb * 2**20)
        cached = CachedEngine(
            engine, result_cache=QueryResultCache(cache_bytes),
            hot_cache=HotPostingCache(cache_bytes // 4))
        passes = []
        for pss in ("miss", "hit"):
            vals_c, ids_c = cached.search(q_rep, K, **kw)
            require(np.array_equal(ids_c, ids_e),
                    f"cached search ids diverge on the {pss} pass")
            require(np.array_equal(vals_c, vals_e),
                    f"cached search values diverge on the {pss} pass")
            passes.append((vals_c, ids_c))
        cs = cached.stats()
        rc, hot = cs["results"], cs["hot"]
        require(rc["hits"] == QUERIES and rc["misses"] == QUERIES,
                f"the cache saw {rc['hits']} hits and {rc['misses']} "
                f"misses, expected {QUERIES} of each")
        print(f"cached engine search == uncached (miss + hit pass): True; "
              f"hit ratio {rc['hit_rate']}, {rc['bytes_used']} B cached, "
              f"{hot['pinned_terms']} hot terms / {hot['bytes_pinned']} B "
              f"pinned")
        out.update(cached=passes, cache_stats=cs)
    return out


def run(args: argparse.Namespace, device: torch.device,
        params: Optional[Dict[str, Any]] = None,
        cfg: Optional[TransformerConfig] = None) -> Dict[str, Any]:
    """The four parts. ``params`` are SMOKE splade_bert params on
    ``device`` (default: ``init_state`` from a generator seeded 0);
    ``cfg`` is the SMOKE config (default) or a copy of it, e.g. at f32
    compute, where the port and the JAX package give the same reps.
    Returns the query reps (``q_rep``), the frozen ``index``, each
    retrieval's ``(vals, ids)`` (``impact``, ``dense``, ``engine`` with
    its ``cached`` passes, ``stream`` and ``kernel``), the loop's
    ``serving`` stats, the self-retrieval rate and ``exact_ids``: for
    each id check, whether it held without the near-tie rule."""
    cfg = cfg or get_config("splade_bert").SMOKE
    # the Unified-LSR knob: reps leave the head as top-48 SparseRep rows
    cfg = dataclasses.replace(cfg, rep_topk=REP_TOPK)
    if params is None:
        params = init_state("splade_bert",
                            torch.Generator(device=device).manual_seed(0),
                            smoke=True)["params"]
    # head_impl, softcap and the rep sparsifier all come from the config
    encode = make_config_encoder(params, cfg)
    held: Dict[str, bool] = {}
    rng = np.random.default_rng(0)

    # --- 1. index the corpus (sparse; never a dense (N, V) matrix) ------
    doc_tokens = rng.integers(1, cfg.vocab_size, size=(CORPUS, DOC_LEN))
    doc_tokens = doc_tokens.astype(np.int32)
    engine = (build_engine(encode, cfg.vocab_size, doc_tokens, args, device)
              if args.engine else None)
    doc_parts = [encode(torch.from_numpy(doc_tokens[lo:lo + BATCH]),
                        torch.ones((min(BATCH, CORPUS - lo), DOC_LEN),
                                   dtype=torch.int32))
                 for lo in range(0, CORPUS, BATCH)]
    corpus_rep = stack_rows(doc_parts)
    index = build_inverted_index(corpus_rep, cfg.vocab_size, device=device)
    st = index.stats()
    print(f"indexed {st['n_docs']} docs; mean active terms "
          f"{st['n_postings'] / st['n_docs']:.0f} / {cfg.vocab_size}; "
          f"index {st['memory_bytes'] / 2**10:.0f} KiB vs dense "
          f"{CORPUS * cfg.vocab_size * 4 / 2**10:.0f} KiB")

    # --- 2. serve queries through the batching loop ---------------------
    loop = ServingLoop(BatchedEncoder(
        encode, policy=BatchPolicy(max_batch=8, max_wait_s=0.002)))
    t0 = time.monotonic()
    for uid in range(QUERIES):
        # query uid re-encodes doc uid's tokens: exact-duplicate retrieval
        # (untrained weights carry no prefix semantics); the deadline is
        # generous, this example pins the happy path (everything served)
        loop.submit(Request(uid=uid, tokens=doc_tokens[uid].copy(),
                            deadline_s=60.0))
        loop.tick()
    loop.drain()
    q_rep = stack_rows([loop.take(u) for u in range(QUERIES)])
    require(not loop.completed, "take() pops — nothing may accumulate")
    serving = loop.stats()
    require(serving["served"] == QUERIES
            and serving["shed"] == serving["failed"] == 0,
            f"served {serving['served']}, shed {serving['shed']}, failed "
            f"{serving['failed']} of {QUERIES} requests")
    print(f"served {QUERIES} queries in "
          f"{(time.monotonic() - t0) * 1e3:.1f} ms; "
          f"batch sizes {list(loop.batch_sizes)}; "
          f"occupancy {serving['batch_occupancy']:.2f}; "
          f"p99 {serving['p99_latency_s'] * 1e3:.1f} ms")

    # --- 3a. retrieval: inverted impact index (sparse path) -------------
    vals, idx = retrieve(q_rep, index, K, method="impact")
    vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
    hits = float(np.mean(idx[:, 0] == np.arange(QUERIES)))
    print(f"top-1 self-retrieval rate: {hits:.2f} (exact-duplicate "
          f"queries)")

    # parity: the dense fallback over the SAME SparseReps must agree
    d_dense = corpus_rep.to(device).to_dense(cfg.vocab_size)
    scores = q_rep.to(device).to_dense(cfg.vocab_size) @ d_dense.T
    vals_d, idx_d = retrieve(q_rep, d_dense, K, method="dense")
    vals_d, idx_d = vals_d.cpu().numpy(), idx_d.cpu().numpy()
    same_ids("impact_vs_dense", idx, idx_d, scores, device, held)
    require(np.allclose(vals, vals_d, atol=1e-4),
            f"impact and dense values differ by "
            f"{np.abs(vals - vals_d).max()}")
    print("impact scoring == dense fallback (same SparseReps): True")
    out = {"q_rep": q_rep, "index": index, "impact": (vals, idx),
           "dense": (vals_d, idx_d), "serving": serving, "hits": hits}
    if engine is not None:
        out["engine"] = search_engine(engine, q_rep, idx, scores, args,
                                      device, held)

    # --- 3b. the 1M-candidate regime: streaming top-k against K6 --------
    g = torch.Generator(device=device).manual_seed(1)
    cand = torch.randn((CAND, CAND_D), generator=g, device=device)
    qv = torch.randn((CAND_Q, CAND_D), generator=g, device=device)
    v_stream, i_stream = streaming_topk(qv, cand, k=K, tile=CAND_TILE)
    v_kernel, i_kernel = topk_score(qv, cand, k=K)
    v_stream, v_kernel = v_stream.cpu().numpy(), v_kernel.cpu().numpy()
    require(np.allclose(v_stream, v_kernel, atol=1e-5),
            f"streaming top-k and K6 values differ by "
            f"{np.abs(v_stream - v_kernel).max()}")
    same_ids("stream_vs_kernel", i_stream.cpu().numpy(),
             i_kernel.cpu().numpy(), qv @ cand.T, device, held)
    print("streaming top-k == fused kernel (K6):", held["stream_vs_kernel"])
    print("done.")
    return {**out, "stream": (v_stream, i_stream.cpu().numpy()),
            "kernel": (v_kernel, i_kernel.cpu().numpy()),
            "exact_ids": held}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    check_args(ap, args)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    run(args, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
