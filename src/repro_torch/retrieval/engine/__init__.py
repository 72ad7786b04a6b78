"""The index engine (``repro/retrieval/engine``): posting-list compression
(``quantize``: u4 impacts, delta doc ids, scored by K5 under
``method="fused"``) and the incremental ``IndexBuilder`` (``builder``).

Pruning, doc/term/2D sharding and the placement planner of the JAX engine
are not ported yet (``ROADMAP.md`` Queue 1 items 8 and 10).
"""

from repro_torch.retrieval.engine.builder import IndexBuilder
from repro_torch.retrieval.engine.quantize import (QuantizedIndex,
                                                   fused_quantized_retrieve,
                                                   quantize_index,
                                                   quantized_retrieve,
                                                   quantized_scores)

__all__ = [
    "IndexBuilder",
    "QuantizedIndex",
    "fused_quantized_retrieve",
    "quantize_index",
    "quantized_retrieve",
    "quantized_scores",
]
