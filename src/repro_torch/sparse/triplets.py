"""Triplet construction for directional message passing (DimeNet): the
port's copy of ``repro/sparse/triplets.py``, the same numpy, so the same
seed gives the same arrays bit for bit.

DimeNet updates the message on each directed edge (j -> i) by
aggregating over *triplets* (k -> j -> i), k in N(j) \\ {i}. The exact
triplet count is sum_j deg(j)^2 — quadratic in hub degree, which
explodes on power-law graphs (ogb-products would exceed 10^9). We
therefore support a per-edge cap K (``max_triplets_per_edge``),
matching the neighbor-capping used by large-scale molecular/GNN systems
(GemNet-OC / OCP practice); exact mode (cap=0) is used for molecules
and small graphs.

This is a *data-pipeline* step (host-side numpy, like the neighbor
sampler): the model consumes fixed-shape index arrays
``(t_src_edge, t_dst_edge)`` meaning message[t_dst_edge] aggregates
basis-weighted message[t_src_edge].
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def build_triplets(
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    n_nodes: int,
    *,
    max_per_edge: int = 0,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (t_in, t_out): triplet k->j contributes edge t_in[m] =
    index of edge (k->j), to target edge t_out[m] = index of edge
    (j->i). Self-loops k == i are excluded.
    """
    n_edges = len(edge_src)
    rng = np.random.default_rng(seed)
    # incoming-edge lists per node j: edges whose dst == j
    order = np.argsort(edge_dst, kind="stable")
    sorted_dst = edge_dst[order]
    starts = np.searchsorted(sorted_dst, np.arange(n_nodes), side="left")
    ends = np.searchsorted(sorted_dst, np.arange(n_nodes), side="right")

    t_in, t_out = [], []
    for e in range(n_edges):
        j = edge_src[e]          # target edge is (j -> i); aggregate k -> j
        i = edge_dst[e]
        lo, hi = starts[j], ends[j]
        incoming = order[lo:hi]
        ks = edge_src[incoming]
        valid = incoming[ks != i]
        if max_per_edge and len(valid) > max_per_edge:
            valid = rng.choice(valid, size=max_per_edge, replace=False)
        t_in.extend(valid.tolist())
        t_out.extend([e] * len(valid))
    return (np.asarray(t_in, np.int32), np.asarray(t_out, np.int32))


def densify_triplets(
    t_in: np.ndarray,
    t_out: np.ndarray,
    n_edges: int,
    k: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Flat (t_in, t_out) lists -> dense (E, K) layout + mask.

    The dense layout is what the distributed-gather forward path
    consumes (``models/dimenet.forward_dense_triplets``): row e holds
    the (<= K) in-edge indices of target edge e, zero-padded.
    """
    dense = np.zeros((n_edges, k), np.int32)
    mask = np.zeros((n_edges, k), np.int32)
    fill = np.zeros(n_edges, np.int32)
    for src_e, dst_e in zip(t_in, t_out):
        slot = fill[dst_e]
        if slot < k:
            dense[dst_e, slot] = src_e
            mask[dst_e, slot] = 1
            fill[dst_e] = slot + 1
    return dense, mask


def count_triplets(
    edge_src: np.ndarray, edge_dst: np.ndarray, n_nodes: int,
    max_per_edge: int = 0,
) -> int:
    """Triplet-count *upper bound* without materializing them (for
    static budgets; ignores the k == i exclusion)."""
    in_deg = np.bincount(edge_dst, minlength=n_nodes)
    per_edge = in_deg[edge_src]  # edges into j, minus possibly one (k==i)
    if max_per_edge:
        per_edge = np.minimum(per_edge, max_per_edge)
    return int(per_edge.sum())


def triplet_budget(
    n_nodes: int, n_edges: int, max_per_edge: int
) -> int:
    """Static triplet budget for a dry run's shapes (no graph
    materialization): cap * n_edges for capped mode; for exact mode we
    assume a regular graph (deg = E/N) giving E * deg triplets.
    """
    if max_per_edge:
        return n_edges * max_per_edge
    avg_deg = max(1, n_edges // max(1, n_nodes))
    return n_edges * avg_deg
