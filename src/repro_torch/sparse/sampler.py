"""Layered neighbor sampler (GraphSAGE-style fanout sampling): the port's
copy of ``repro/sparse/sampler.py``, the same numpy, so the same ``rng``
gives the same subgraph bit for bit.

Host-side numpy: production GNN systems sample on CPU workers and feed
fixed-shape index tensors to the accelerator; we do the same. The
sampler returns a *node-flattened subgraph* with per-layer edge lists,
padded to static shapes so every step sees the same shapes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    """Compressed neighbor lists (out-edges)."""
    indptr: np.ndarray   # (N+1,)
    indices: np.ndarray  # (E,)

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1

    @classmethod
    def from_edges(cls, src: np.ndarray, dst: np.ndarray,
                   n_nodes: int) -> "CSRGraph":
        order = np.argsort(src, kind="stable")
        s, d = src[order], dst[order]
        indptr = np.zeros(n_nodes + 1, np.int64)
        np.add.at(indptr, s + 1, 1)
        np.cumsum(indptr, out=indptr)
        return cls(indptr=indptr, indices=d.astype(np.int64))

    def neighbors(self, node: int) -> np.ndarray:
        return self.indices[self.indptr[node]:self.indptr[node + 1]]


@dataclasses.dataclass
class SampledBlock:
    """One sampled hop: edges from layer-l nodes to layer-(l+1) nodes."""
    src: np.ndarray      # (E_pad,) indices into the flat node array
    dst: np.ndarray      # (E_pad,)
    n_edges: int         # valid edges (rest is padding, src=dst=0 w/ mask 0)
    mask: np.ndarray     # (E_pad,) 1 = real edge


@dataclasses.dataclass
class SampledSubgraph:
    nodes: np.ndarray            # (N_pad,) original node ids
    n_nodes: int
    node_mask: np.ndarray        # (N_pad,)
    blocks: List[SampledBlock]
    seeds: np.ndarray            # (batch,) positions of seed nodes (= 0..B-1)


def sample_subgraph(
    graph: CSRGraph,
    seeds: np.ndarray,
    fanout: Sequence[int],
    *,
    rng: np.random.Generator,
    pad_nodes: int = 0,
    pad_edges_per_hop: Tuple[int, ...] = (),
) -> SampledSubgraph:
    """Fanout-sample `len(fanout)` hops from `seeds`.

    Node ids are remapped to a dense [0, n) range, seeds first — the
    model runs on the compact subgraph. Static padding keeps the shapes
    the same across steps.
    """
    id_map = {}
    flat_nodes: List[int] = []

    def intern(n: int) -> int:
        if n not in id_map:
            id_map[n] = len(flat_nodes)
            flat_nodes.append(n)
        return id_map[n]

    for s in seeds:
        intern(int(s))
    frontier = list(range(len(seeds)))

    blocks: List[SampledBlock] = []
    for hop, k in enumerate(fanout):
        src_l, dst_l = [], []
        next_frontier = []
        for pos in frontier:
            node = flat_nodes[pos]
            nbrs = graph.neighbors(node)
            if len(nbrs) > k:
                nbrs = rng.choice(nbrs, size=k, replace=False)
            for nb in nbrs:
                p = intern(int(nb))
                src_l.append(p)
                dst_l.append(pos)
                next_frontier.append(p)
        n_e = len(src_l)
        cap = (pad_edges_per_hop[hop] if hop < len(pad_edges_per_hop)
               else n_e)
        if n_e > cap:
            src_l, dst_l = src_l[:cap], dst_l[:cap]
            n_e = cap
        src = np.zeros(cap, np.int32)
        dst = np.zeros(cap, np.int32)
        msk = np.zeros(cap, np.int32)
        src[:n_e] = src_l
        dst[:n_e] = dst_l
        msk[:n_e] = 1
        blocks.append(SampledBlock(src=src, dst=dst, n_edges=n_e, mask=msk))
        frontier = sorted(set(next_frontier))

    n = len(flat_nodes)
    cap_n = max(pad_nodes, n)
    nodes = np.zeros(cap_n, np.int64)
    nodes[:n] = flat_nodes
    node_mask = np.zeros(cap_n, np.int32)
    node_mask[:n] = 1
    return SampledSubgraph(
        nodes=nodes, n_nodes=n, node_mask=node_mask, blocks=blocks,
        seeds=np.arange(len(seeds), dtype=np.int32),
    )


def fanout_budget(batch_nodes: int,
                  fanout: Sequence[int]) -> Tuple[int, Tuple[int, ...]]:
    """Static (node, per-hop-edge) budgets: the padded shapes of a
    sampled batch."""
    nodes = batch_nodes
    total_nodes = batch_nodes
    per_hop = []
    for k in fanout:
        edges = nodes * k
        per_hop.append(edges)
        nodes = edges
        total_nodes += edges
    return total_nodes, tuple(per_hop)
