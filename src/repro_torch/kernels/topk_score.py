"""The running top-k merge shared by every top-k in the port.

Only ``merge_topk``'s semantics are ported here; the dense streaming
scorer that the JAX module also holds (its Pallas kernel) waits for a
later slice. ``torch.topk`` promises no order among equal values, so the
merge is a stable descending sort: equal values keep their position in
the concatenation ``[running, new]``, and when blocks are visited in
ascending-id order ties go to the lowest id, as with ``lax.top_k``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._common import NEG_INF


def merge_topk(run_vals: torch.Tensor, run_idx: torch.Tensor,
               new_vals: torch.Tensor, new_idx: torch.Tensor, k: int):
    """Union of ``(B, k)`` running winners and a ``(B, m)`` block,
    re-top-k'd: value descending, ties to the earlier entry."""
    all_vals = torch.cat([run_vals, new_vals], dim=1)
    all_idx = torch.cat([run_idx, new_idx], dim=1)
    top_vals, pos = torch.sort(all_vals, dim=1, descending=True, stable=True)
    return top_vals[:, :k], torch.gather(all_idx, 1, pos[:, :k])


def topk_rows(x: torch.Tensor, k: int):
    """Top-k of each row of ``(B, N)`` ``x`` with the merge's contract:
    ties to the lowest column; when ``k > N`` the tail holds
    ``(NEG_INF, 0)``. Returns ``(vals f32, idx i32)``."""
    B, N = x.shape
    init_v = torch.full((B, k), NEG_INF, dtype=torch.float32, device=x.device)
    init_i = torch.zeros((B, k), dtype=torch.int32, device=x.device)
    ids = torch.arange(N, dtype=torch.int32, device=x.device).expand(B, N)
    return merge_topk(init_v, init_i, x.float(), ids, k)
