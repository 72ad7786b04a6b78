"""Serving and training runtime: the batching loop, fault injection and
OOM detection, the serving frontier (caches, tenancy) and the
fault-tolerant train runner."""

from repro_torch.runtime.fault_tolerance import (
    ElasticMeshManager,
    FaultTolerantRunner,
    RunnerConfig,
    StragglerPolicy,
)
from repro_torch.runtime.faults import (
    FaultError,
    FaultInjector,
    ResourceExhausted,
    TransientFault,
    inject_faults,
    is_oom_error,
)
from repro_torch.runtime.frontier import (
    CachedEngine,
    HotPostingCache,
    QueryResultCache,
    TenantPool,
    TenantQuota,
)
from repro_torch.runtime.serving import (
    Admission,
    AdmissionPolicy,
    BatchedEncoder,
    BatchPolicy,
    CorpusEngine,
    DegradeController,
    DegradePolicy,
    DegradeStep,
    FailedResult,
    Request,
    ServingLoop,
    ShedResult,
)

__all__ = [
    "Admission", "AdmissionPolicy", "BatchPolicy", "BatchedEncoder",
    "CachedEngine", "CorpusEngine", "DegradeController", "DegradePolicy",
    "DegradeStep", "ElasticMeshManager", "FailedResult", "FaultError",
    "FaultInjector", "FaultTolerantRunner", "HotPostingCache",
    "QueryResultCache", "Request", "ResourceExhausted", "RunnerConfig",
    "ServingLoop", "ShedResult", "StragglerPolicy", "TenantPool",
    "TenantQuota", "TransientFault", "inject_faults", "is_oom_error",
]
