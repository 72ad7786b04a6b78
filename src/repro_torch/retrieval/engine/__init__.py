"""The index engine (``repro/retrieval/engine``): pruned, quantized and
sharded inverted retrieval with an incremental builder.

* ``pruning``       — two-tier MaxScore scoring: K4's ceiling entry keeps
                      the best per-term-upper-bound sums, an exact
                      rescoring from the forward rows runs on the
                      survivors only.
* ``quantize``      — posting-list compression: u4 impacts with per-term
                      affine scales and delta doc ids, scored by K5 under
                      ``method="fused"``.
* ``sharded_index`` — doc-sharded index over a mesh (``launch.mesh.Mesh``;
                      every shard in one process without one), merged by
                      a stable top-k over the gathered per-shard winners.
* ``term_sharded``  — term-partitioned (vocab-sharded) index: each shard
                      owns the whole posting lists of a vocab range; the
                      per-shard partial sums are all-reduced (``psum``)
                      before one global top-k.
* ``shard2d``       — the (doc × term) composition of both on a 2D mesh,
                      and the ``ShardPlan`` placement API:
                      ``plan_placement(stats, n_devices, hbm)`` picks
                      (doc_shards, term_shards, replicas) from posting
                      mass, the O(V) directory and the forward rows.
* ``builder``       — the incremental ``IndexBuilder``: add, remove and
                      flush of document batches with tombstones, a base
                      and a delta segment, and compaction.

Everything goes through ``repro_torch.retrieval.retrieve`` (methods
``pruned``, ``quantized``, ``fused``, ``sharded``, ``term_sharded``,
``shard2d``).
"""

from repro_torch.retrieval.engine.builder import IndexBuilder
from repro_torch.retrieval.engine.pruning import (default_candidates,
                                                  pruned_retrieve,
                                                  select_and_rescore,
                                                  select_and_rescore_dense,
                                                  upper_bound_scores)
from repro_torch.retrieval.engine.quantize import (QuantizedIndex,
                                                   fused_quantized_retrieve,
                                                   quantize_index,
                                                   quantized_retrieve,
                                                   quantized_scores)
from repro_torch.retrieval.engine.shard2d import (CorpusStats, Shard2DIndex,
                                                  ShardPlan,
                                                  choose_shard_axis,
                                                  mass_balanced_boundaries,
                                                  plan_placement,
                                                  shard2d_index,
                                                  shard2d_retrieve)
from repro_torch.retrieval.engine.sharded_index import (ShardedIndex,
                                                        resolve_mesh_axes,
                                                        resolve_shard_axis,
                                                        shard_index,
                                                        shard_mapped,
                                                        sharded_retrieve)
from repro_torch.retrieval.engine.term_sharded import (TermShardedIndex,
                                                       term_shard_index,
                                                       term_sharded_retrieve)

__all__ = [
    "CorpusStats",
    "IndexBuilder",
    "QuantizedIndex",
    "Shard2DIndex",
    "ShardPlan",
    "ShardedIndex",
    "TermShardedIndex",
    "choose_shard_axis",
    "default_candidates",
    "fused_quantized_retrieve",
    "mass_balanced_boundaries",
    "plan_placement",
    "pruned_retrieve",
    "quantize_index",
    "quantized_retrieve",
    "quantized_scores",
    "resolve_mesh_axes",
    "resolve_shard_axis",
    "select_and_rescore",
    "select_and_rescore_dense",
    "shard2d_index",
    "shard2d_retrieve",
    "shard_index",
    "shard_mapped",
    "sharded_retrieve",
    "term_shard_index",
    "term_sharded_retrieve",
    "upper_bound_scores",
]
