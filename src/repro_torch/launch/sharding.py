"""Batch sharding rules (``repro/launch/sharding.py:35-62``): which batch
axes of a mesh split a batch of ``n`` rows, and the spec of such a batch.

A spec is a tuple with one entry per dimension: ``None`` (the dimension
is whole on every rank) or a tuple of axis names (split over them,
row-major), as a ``PartitionSpec``. ``core.sharded.local_block`` cuts a
rank's block out of a global tensor by such a spec.

Still to come: the parameter, ZeRO and state specs (ROADMAP item 10d).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from repro_torch.launch.mesh import batch_axes

Spec = Tuple[Optional[Tuple[str, ...]], ...]


def batch_axes_for(mesh: Any, n: int) -> Tuple[str, ...]:
    """Largest contiguous batch-axis combination whose product divides
    ``n`` (prefers more shards: ("pod","data") > ("data",) > ("pod",))."""
    baxes = batch_axes(mesh)
    candidates = []
    for i in range(len(baxes)):
        for j in range(i + 1, len(baxes) + 1):
            sub = baxes[i:j]
            prod = 1
            for ax in sub:
                prod *= mesh.shape[ax]
            candidates.append((prod, sub))
    candidates.sort(key=lambda t: -t[0])
    for prod, sub in candidates:
        if n % prod == 0:
            return sub
    return ()


def batch_spec(mesh: Any, n: int, rank: int) -> Spec:
    """``((batch axes), None, ...)`` for an ``(n, ...)`` batch tensor of
    ``rank`` dimensions (``None`` first when no batch axis divides n)."""
    axes = batch_axes_for(mesh, n)
    return (axes if axes else None,) + (None,) * (rank - 1)
