"""Deterministic synthetic LSR pairs (the port's copy of
``repro/data/synthetic.py:_rng``, ``_zipf_ids`` and
``lsr_pair_batches``).

Host-side numpy, seeded per ``(seed, shard, step)``: for the same
arguments the stream is the JAX package's, batch for batch.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def _rng(seed: int, shard: int, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed, shard, step]))


def _zipf_ids(rng, size, vocab: int, a: float = 1.3) -> np.ndarray:
    """Zipf-distributed ids in [0, vocab) — heavy head like real text."""
    raw = rng.zipf(a, size=size)
    return np.clip(raw - 1, 0, vocab - 1).astype(np.int32)


def lsr_pair_batches(
    *,
    batch: int,
    q_len: int,
    d_len: int,
    vocab: int,
    seed: int = 0,
    shard: int = 0,
    min_frac: float = 0.3,
) -> Iterator[Dict[str, np.ndarray]]:
    """(query, positive-doc) token batches with masks, SPLADE-style."""
    step = 0
    while True:
        rng = _rng(seed, shard, step)
        q_tok = _zipf_ids(rng, (batch, q_len), vocab)
        d_tok = _zipf_ids(rng, (batch, d_len), vocab)
        q_n = rng.integers(int(q_len * min_frac), q_len + 1, size=batch)
        d_n = rng.integers(int(d_len * min_frac), d_len + 1, size=batch)
        q_mask = (np.arange(q_len)[None] < q_n[:, None]).astype(np.int32)
        d_mask = (np.arange(d_len)[None] < d_n[:, None]).astype(np.int32)
        # overlap positives: splice some query tokens into the doc so
        # the contrastive task is learnable
        n_copy = max(1, q_len // 2)
        d_tok[:, :n_copy] = q_tok[:, :n_copy]
        yield {
            "q_tokens": q_tok, "q_mask": q_mask,
            "d_tokens": d_tok * d_mask, "d_mask": d_mask,
        }
        step += 1
