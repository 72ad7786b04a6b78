"""Sparse-native retrieval (``repro/retrieval``): ``SparseRep`` reps, the
inverted impact index, the one ``retrieve()`` dispatcher, and the index
engine: pruned, quantized and sharded scoring and the incremental
builder."""

from repro_torch.retrieval.engine import (CorpusStats, IndexBuilder,
                                          QuantizedIndex, Shard2DIndex,
                                          ShardedIndex, ShardPlan,
                                          TermShardedIndex,
                                          choose_shard_axis,
                                          fused_quantized_retrieve,
                                          plan_placement, pruned_retrieve,
                                          quantize_index, shard2d_index,
                                          shard2d_retrieve, shard_index,
                                          sharded_retrieve, term_shard_index,
                                          term_sharded_retrieve)
from repro_torch.retrieval.index import InvertedIndex, build_inverted_index
from repro_torch.retrieval.score import (METHODS, fused_retrieve,
                                         impact_scores, retrieve)
from repro_torch.retrieval.sparse_rep import (SparseRep, sparsify_threshold,
                                              sparsify_topk, split_rows,
                                              stack_rows, truncate_width)

__all__ = [
    "CorpusStats",
    "IndexBuilder",
    "InvertedIndex",
    "METHODS",
    "QuantizedIndex",
    "Shard2DIndex",
    "ShardPlan",
    "ShardedIndex",
    "SparseRep",
    "TermShardedIndex",
    "build_inverted_index",
    "choose_shard_axis",
    "fused_quantized_retrieve",
    "fused_retrieve",
    "impact_scores",
    "plan_placement",
    "pruned_retrieve",
    "quantize_index",
    "retrieve",
    "shard2d_index",
    "shard2d_retrieve",
    "shard_index",
    "sharded_retrieve",
    "sparsify_threshold",
    "sparsify_topk",
    "split_rows",
    "stack_rows",
    "term_shard_index",
    "term_sharded_retrieve",
    "truncate_width",
]
