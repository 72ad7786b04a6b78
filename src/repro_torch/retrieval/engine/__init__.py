"""The index engine (``repro/retrieval/engine``): posting-list compression
(``quantize``: u4 impacts, delta doc ids, scored by K5 under
``method="fused"``), two-tier pruned retrieval (``pruning``: tier-1
ceilings through K4's ceiling entry, an exact rescoring from the forward
rows) and the incremental ``IndexBuilder`` (``builder``).

Doc/term/2D sharding and the placement planner of the JAX engine are not
ported yet (``ROADMAP.md`` Queue 1 item 10).
"""

from repro_torch.retrieval.engine.builder import IndexBuilder
from repro_torch.retrieval.engine.pruning import (default_candidates,
                                                  pruned_retrieve,
                                                  upper_bound_scores)
from repro_torch.retrieval.engine.quantize import (QuantizedIndex,
                                                   fused_quantized_retrieve,
                                                   quantize_index,
                                                   quantized_retrieve,
                                                   quantized_scores)

__all__ = [
    "IndexBuilder",
    "QuantizedIndex",
    "default_candidates",
    "fused_quantized_retrieve",
    "pruned_retrieve",
    "quantize_index",
    "quantized_retrieve",
    "quantized_scores",
    "upper_bound_scores",
]
