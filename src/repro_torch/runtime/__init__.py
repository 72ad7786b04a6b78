"""Serving and training runtime: the batching loop, OOM detection and
the fault-tolerant train runner."""

from repro_torch.runtime.fault_tolerance import (
    ElasticMeshManager,
    FaultTolerantRunner,
    RunnerConfig,
    StragglerPolicy,
)

__all__ = ["ElasticMeshManager", "FaultTolerantRunner", "RunnerConfig",
           "StragglerPolicy"]
