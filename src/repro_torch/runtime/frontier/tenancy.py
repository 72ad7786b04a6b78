"""Multi-corpus tenancy: many named corpora over one encoder
(``repro/runtime/frontier/tenancy.py``).

One process, one encoder, N tenants. Each tenant owns its
``CorpusEngine`` (its corpus), its ``ServingLoop`` (its queue and
adaptive batch cap) and its ``DegradeController`` (its ladder rung). The
encoder is the only shared compute and keeps no state across batches, so
isolation is structural: a poison batch bisects inside the submitting
tenant's loop, an OOM halves *that* loop's cap, sustained pressure moves
*that* tenant's ladder.

What is shared is arbitrated explicitly:

* **Encoder time**: ``tick()`` dispatches at most one batch a call (the
  ``ServingLoop`` contract, lifted to the pool) and picks the tenant by
  stride scheduling: each tenant's virtual ``pass`` advances by
  ``dispatched / weight`` when it is served, and the dispatch-ready
  tenant with the smallest pass goes next (ties by name). A long-idle
  tenant's pass is clamped forward to the current minimum on its next
  dispatch, so banked idle time cannot starve the others.
* **Memory**: one byte budget over all tenants, metered by
  ``IndexBuilder.memory_bytes()`` plus the caches. ``add_docs`` refuses
  (``QuotaExceeded``) when the tenant would pass its ``max_docs`` quota
  (checked before anything is applied) or the pool is already over
  budget after one forced compaction of the tenant's index.
* **The result cache**: optionally one ``QueryResultCache`` across
  tenants, namespaced by tenant tag, so invalidation is per tenant too;
  each tenant gets its own ``HotPostingCache`` when ``hot_cache_bytes``
  is set.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.runtime.frontier.caches import (CachedEngine,
                                                 HotPostingCache,
                                                 QueryResultCache)
from repro_torch.runtime.serving import (Admission, AdmissionPolicy,
                                         BatchedEncoder, CorpusEngine,
                                         DegradeController, DegradePolicy,
                                         Request, ServingLoop)

__all__ = ["QuotaExceeded", "TenantQuota", "TenantState", "TenantPool"]


class QuotaExceeded(RuntimeError):
    """A mutation was refused by a per-tenant or pool-wide limit."""


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Per-tenant limits: scheduling ``weight`` (share of encoder time
    under contention) and ``max_docs`` (live-document cap; ``None`` =
    unlimited)."""
    weight: float = 1.0
    max_docs: Optional[int] = None

    def __post_init__(self):
        if not self.weight > 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")


@dataclasses.dataclass
class TenantState:
    """Everything one tenant owns. ``frontend`` is the search surface: the
    ``CachedEngine`` when the pool caches, else the engine."""
    name: str
    engine: CorpusEngine
    frontend: Any
    loop: ServingLoop
    quota: TenantQuota
    vpass: float = 0.0          # stride scheduling's virtual pass

    @property
    def live_docs(self) -> int:
        return int(self.engine.builder.stats()["n_alive"])

    def memory_bytes(self) -> int:
        return int(self.engine.builder.memory_bytes())


class TenantPool:
    """Named corpora multiplexed over one ``BatchedEncoder``.

    The per-request surface is ``ServingLoop``'s and ``CorpusEngine``'s
    with a leading tenant name: ``submit(name, req)``, ``take(name,
    uid)``, ``add_docs(name, docs)``, ``search(name, queries, k, **kw)``.
    ``tick()``/``drain()`` schedule across tenants (module docstring).
    """

    def __init__(self, encoder: BatchedEncoder, *,
                 clock: Callable[[], float] = time.monotonic,
                 memory_budget_bytes: Optional[int] = None,
                 cache_bytes: int = 0,
                 hot_cache_bytes: int = 0,
                 continuous: bool = False):
        self.encoder = encoder
        self.clock = clock
        self.memory_budget_bytes = memory_budget_bytes
        self.hot_cache_bytes = int(hot_cache_bytes)
        self.continuous = continuous
        self.result_cache: Optional[QueryResultCache] = (
            QueryResultCache(cache_bytes) if cache_bytes > 0 else None)
        self._tenants: Dict[str, TenantState] = {}

    # -- membership ------------------------------------------------------

    def add_tenant(self, name: str, vocab_size: int, *,
                   quota: Optional[TenantQuota] = None,
                   admission: Optional[AdmissionPolicy] = None,
                   degrade_policy: Optional[DegradePolicy] = None,
                   **engine_kw) -> TenantState:
        """Provision a tenant: engine, (shared-cache) frontend, its own
        loop and ladder. ``engine_kw`` goes to ``CorpusEngine``
        (``quantize``, ``keep_forward``, the shard knobs, ``device``:
        ``cuda`` unless given)."""
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already exists")
        engine = CorpusEngine(self.encoder, vocab_size, **engine_kw)
        frontend: Any = engine
        if self.result_cache is not None:
            hot = (HotPostingCache(self.hot_cache_bytes)
                   if self.hot_cache_bytes > 0 else None)
            frontend = CachedEngine(engine, result_cache=self.result_cache,
                                    hot_cache=hot, tag=name)
        loop = ServingLoop(
            self.encoder, clock=self.clock, admission=admission,
            degrade=DegradeController(degrade_policy),
            continuous=self.continuous)
        st = TenantState(name=name, engine=engine, frontend=frontend,
                         loop=loop, quota=quota or TenantQuota())
        self._tenants[name] = st
        return st

    def tenant(self, name: str) -> TenantState:
        try:
            return self._tenants[name]
        except KeyError:
            raise KeyError(f"unknown tenant {name!r} "
                           f"(have: {sorted(self._tenants)})") from None

    def names(self) -> List[str]:
        return sorted(self._tenants)

    # -- corpus mutations (quota-checked) --------------------------------

    def memory_bytes(self) -> int:
        total = sum(t.memory_bytes() for t in self._tenants.values())
        if self.result_cache is not None:
            total += self.result_cache.bytes_used
        for t in self._tenants.values():
            hot = getattr(t.frontend, "hot", None)
            if hot is not None:
                total += hot.bytes_pinned
        return total

    def _check_budget(self, st: TenantState, incoming: int) -> None:
        if (st.quota.max_docs is not None
                and st.live_docs + incoming > st.quota.max_docs):
            raise QuotaExceeded(
                f"tenant {st.name!r}: {st.live_docs} live + {incoming} "
                f"incoming docs exceeds max_docs={st.quota.max_docs}")
        budget = self.memory_budget_bytes
        if budget is not None and self.memory_bytes() > budget:
            # over from the previous add: reclaim tombstones once before
            # refusing (compaction frees bytes without dropping live docs)
            st.engine.builder.flush(force_compact=True)
            if self.memory_bytes() > budget:
                raise QuotaExceeded(
                    f"pool over memory budget: {self.memory_bytes()} > "
                    f"{budget} bytes; remove docs or raise the budget "
                    f"before adding to tenant {st.name!r}")

    def add_docs(self, name: str, docs: Sequence[np.ndarray],
                 ids: Optional[Sequence[int]] = None) -> np.ndarray:
        st = self.tenant(name)
        docs = list(docs)
        self._check_budget(st, len(docs))
        return st.frontend.add_docs(docs, ids=ids)

    def remove_docs(self, name: str, ids: Sequence[int]) -> int:
        return self.tenant(name).frontend.remove_docs(ids)

    # -- request path ----------------------------------------------------

    def submit(self, name: str, req: Request) -> Admission:
        return self.tenant(name).loop.submit(req)

    def take(self, name: str, uid: int) -> Any:
        return self.tenant(name).loop.take(uid)

    def search(self, name: str, queries, k: int = 10, **kw):
        """The tenant's search, its ladder rung's ``search_kwargs`` merged
        under the caller's."""
        st = self.tenant(name)
        d = st.loop.degrade
        merged = dict(d.search_kwargs()) if d is not None else {}
        merged.update(kw)
        return st.frontend.search(queries, k, **merged)

    # -- scheduling ------------------------------------------------------

    def _schedule_order(self) -> List[TenantState]:
        # name-tiebroken so equal passes schedule deterministically
        return sorted(self._tenants.values(),
                      key=lambda t: (t.vpass, t.name))

    def tick(self, *, force: bool = False) -> Tuple[str, int]:
        """One scheduling round: at most one batch dispatches, from the
        smallest-pass dispatch-ready tenant. The tenants that are not ready
        still get their housekeeping tick (expiry shedding and the degrade
        observation). Returns ``(tenant, batch_size)``, ``("", 0)`` when
        nothing dispatched."""
        order = self._schedule_order()
        ready = [t for t in order if t.loop.ready(force=force)]
        chosen = ready[0] if ready else None
        dispatched: Tuple[str, int] = ("", 0)
        for t in order:
            if t is chosen:
                n = t.loop.tick(force=force)
                if n:
                    # clamp forward: a long-idle tenant re-enters at the
                    # current minimum instead of cashing in banked pass
                    floor = min(x.vpass for x in order)
                    t.vpass = max(t.vpass, floor) + n / t.quota.weight
                    dispatched = (t.name, n)
            elif not t.loop.ready(force=False):
                t.loop.tick()    # housekeeping only: cannot dispatch
        return dispatched

    def drain(self) -> None:
        """Force-dispatch by pass until every tenant's queue is empty.
        Terminates: each round with pending work dispatches or sheds at
        least one request somewhere."""
        while any(t.loop.pending for t in self._tenants.values()):
            before = sum(len(t.loop.pending)
                         for t in self._tenants.values())
            self.tick(force=True)
            after = sum(len(t.loop.pending)
                        for t in self._tenants.values())
            if after >= before:   # pragma: no cover
                raise RuntimeError("pool tick(force) made no progress")

    # -- observability ---------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        per = {}
        for name in self.names():
            t = self._tenants[name]
            d = {
                "weight": t.quota.weight,
                "vpass": round(t.vpass, 6),
                "live_docs": t.live_docs,
                "memory_bytes": t.memory_bytes(),
                **t.loop.stats(),
            }
            if isinstance(t.frontend, CachedEngine):
                hot = t.frontend.hot
                d["cache"] = {
                    "results": {k: v for k, v in
                                t.frontend.results.stats().items()
                                if k in ("hits", "misses", "hit_rate")},
                    **({"hot": hot.stats()} if hot is not None else {}),
                }
            per[name] = d
        out: Dict[str, Any] = {
            "tenants": per,
            "n_tenants": len(per),
            "memory_bytes": self.memory_bytes(),
            "memory_budget_bytes": self.memory_budget_bytes,
        }
        if self.result_cache is not None:
            out["result_cache"] = self.result_cache.stats()
        return out
