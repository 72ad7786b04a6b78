"""Serving frontier: query-result and hot-posting caches, and multi-corpus
tenancy (``repro/runtime/frontier``).

The layer in front of ``CorpusEngine`` that makes repeated work cheap
(``caches``) and lets one process serve many corpora fairly
(``tenancy``). Continuous batching lives in ``runtime.serving`` itself:
it changes how the loop dispatches, not what sits in front of it.
"""

from repro_torch.runtime.frontier.caches import (
    CachedEngine,
    HotPostingCache,
    QueryResultCache,
    hot_fused_retrieve,
    query_cache_key,
)
from repro_torch.runtime.frontier.tenancy import (
    QuotaExceeded,
    TenantPool,
    TenantQuota,
    TenantState,
)

__all__ = [
    "CachedEngine",
    "HotPostingCache",
    "QueryResultCache",
    "QuotaExceeded",
    "hot_fused_retrieve",
    "query_cache_key",
    "TenantPool",
    "TenantQuota",
    "TenantState",
]
