"""The port's segment sums and gathers on the card: are they run-to-run
reproducible, and how long do they take where ids repeat many times?

    python3 tools/segment_sum_check.py

For each case, rows ``(R, 128)`` f32 summed into ``n`` segments, ``hub``
of the ids on segment 0 (the padded edges of a sampled DimeNet batch all
point at node 0, its padded triplet slots at edge 0), the rest uniform:
``sparse.segment.segment_sum`` (the sorted two-level sum) five times
(the same bits?), its largest difference from an f64 ``index_add_``, and
its ms beside ``index_add_`` (atomics) and ``index_put_(accumulate=True)``
(sorted, one warp a segment). Then the gather's backward five times,
``sparse.embedding_bag.embedding_lookup(..., reproducible=True)`` (as
DimeNet gathers) against ``F.embedding``, on ids that repeat (95 atom
types, 3840 and 20000 rows). One JSON line a case; ms are host-clock
means of 5 calls after a warm-up, synchronised. Needs a card.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.sparse.embedding_bag import embedding_lookup  # noqa: E402
from repro_torch.sparse.segment import segment_sum  # noqa: E402

SUM_CASES = [  # (R, n, hub): minibatch_lg's triplet gather and node sums,
    (1351680, 168960, 1170000),  # then molecule-size sums without a hub
    (168960, 169984, 145000),
    (20000, 95, 0),
    (8192, 3840, 0),
]
GATHER_CASES = [(95, 3840), (95, 20000), (3840, 3840)]   # (rows, ids)


def ms(fn, n=5):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


def same5(fn):
    outs = [fn() for _ in range(5)]
    return all(torch.equal(outs[0], o) for o in outs[1:])


def main() -> int:
    if not torch.cuda.is_available():
        print("segment_sum_check: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for R, n, hub in SUM_CASES:
        ids = torch.randint(0, n, (R,), generator=g, device=dev)
        ids[:hub] = 0
        ids = ids[torch.randperm(R, generator=g, device=dev)]
        x = torch.randn(R, 128, generator=g, device=dev)
        z = torch.zeros(n, 128, device=dev)
        ref = z.double().index_add(0, ids, x.double())
        print(json.dumps({
            "case": "segment_sum", "R": R, "n": n, "hub": hub,
            "same_bits_x5": same5(lambda: segment_sum(x, ids, n)),
            "max_abs_vs_f64": float(
                (segment_sum(x, ids, n).double() - ref).abs().max()),
            "ms_sorted": ms(lambda: segment_sum(x, ids, n)),
            "ms_index_add": ms(lambda: z.index_add(0, ids, x)),
            "ms_index_put": ms(lambda: z.index_put((ids,), x,
                                                   accumulate=True))}),
            flush=True)
    for rows, R in GATHER_CASES:
        ids = torch.randint(0, rows, (R,), generator=g, device=dev)
        w = torch.randn(rows, 128, generator=g, device=dev)
        dy = torch.randn(R, 128, generator=g, device=dev)

        def backward(gather):
            t = w.clone().requires_grad_(True)
            return torch.autograd.grad(gather(t), t, dy)[0]

        print(json.dumps({
            "case": "gather_backward", "rows": rows, "ids": R,
            "lookup_same_bits_x5": same5(
                lambda: backward(lambda t: embedding_lookup(
                    t, ids, reproducible=True))),
            "f_embedding_same_bits_x5": same5(
                lambda: backward(lambda t: F.embedding(ids, t)))}),
            flush=True)
    print(torch.cuda.get_device_name(0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
