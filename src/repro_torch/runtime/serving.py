"""Serving runtime: batched sparse encoding, hardened
(``repro/runtime/serving.py``).

Requests (token sequences) are micro-batched by a deadline/size policy
and pushed through the trunk and the Sparton head; with the config's rep
knobs set, the output is sparsified on the device and each request
completes as a ``SparseRep`` — only ``(B, K)`` crosses to the host.
Retrieval over the encoded queries is ``repro_torch.retrieval.retrieve``.

``ServingLoop`` is the JAX package's loop, unchanged: synchronous and
deterministic (tests drive it tick by tick), with SLO admission and
shedding, poison-batch isolation (a failing batch is bisected until the
poisoned requests stand alone and fail as ``FailedResult``), an adaptive
batch cap halved on OOM-shaped errors, the degradation ladder
(``DegradeController``), continuous (earliest-deadline-first) batching,
and ``stats()``. Every submitted uid completes exactly once as served,
shed or failed, and ``take(uid)`` pops. ``CorpusEngine`` grows and
shrinks an indexed corpus while serving (the encoder plus an
``engine.IndexBuilder``). ``retrieve_topk`` is the JAX package's
dense-fallback shim.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.retrieval.sparse_rep import SparseRep, split_rows
from repro_torch.runtime.faults import is_oom_error


def make_config_encoder(params: Any, cfg: Any, *, spec: Any = None
                        ) -> Callable[[torch.Tensor, torch.Tensor], Any]:
    """Canonical ``(tokens, mask) -> reps`` encode fn from a config.

    Built by ``make_encoder`` from ``cfg.head_spec()`` (or an explicit
    ``spec``), so ``head_impl``, ``final_logit_softcap`` and the rep
    knobs are all honored. Runs on the params' device, without autograd;
    output is a ``SparseRep`` when the spec sets ``rep_topk`` /
    ``rep_threshold``, else the dense ``(B, V)`` tensor.
    """
    from repro_torch.core.head_api import make_encoder
    from repro_torch.models import transformer as tfm

    enc = make_encoder(spec if spec is not None else cfg.head_spec())
    params = tfm.compute_weights(params, cfg)
    E, b = tfm.head_weights(params, cfg)
    device = E.device

    @torch.no_grad()
    def encode(tokens: torch.Tensor, mask: torch.Tensor):
        tokens = torch.as_tensor(tokens, device=device)
        mask = torch.as_tensor(mask, device=device)
        Hs = tfm.forward_hidden(params, cfg, tokens, mask)
        return enc(Hs, E, b, mask)

    return encode


@dataclasses.dataclass
class Request:
    uid: int
    tokens: np.ndarray          # (len,) int32
    arrival_t: float = 0.0
    deadline_s: Optional[float] = None   # relative SLO; None = best-effort


class Admission(enum.Enum):
    """``submit``'s verdict — SHED means the request was rejected up
    front and completed immediately with a ``ShedResult``."""
    ACCEPTED = "accepted"
    SHED = "shed"


@dataclasses.dataclass
class ShedResult:
    """Completion record for a request the loop refused to encode.

    ``reason`` is ``"queue_full"`` / ``"est_deadline"`` (admission
    control) or ``"expired"`` (deadline passed while queued).
    """
    uid: int
    reason: str
    waited_s: float = 0.0


@dataclasses.dataclass
class FailedResult:
    """Completion record for a request whose encode raised even in
    isolation (a poison request). ``oom`` marks OOM-shaped errors."""
    uid: int
    error: str
    oom: bool = False


@dataclasses.dataclass
class BatchPolicy:
    max_batch: int = 32
    max_wait_s: float = 0.005
    pad_to_multiple: int = 16
    # clean dispatches before a fault-halved batch cap doubles back up
    grow_after_clean: int = 4


@dataclasses.dataclass
class AdmissionPolicy:
    """When ``submit`` says no.

    ``max_queue_depth`` is the hard backpressure bound; the deadline
    estimate sheds earlier: a request whose ``deadline_s`` is already
    beaten by ``safety ×`` the estimated queue delay (EWMA encode time
    per batch × batches ahead of it) is rejected at submit time rather
    than queued to expire.
    """
    max_queue_depth: int = 1024
    safety: float = 1.0


# ---------------------------------------------------------------------------
# degradation ladder
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DegradeStep:
    """One rung: retrieval kwargs plus a query-width fraction.

    ``search_kwargs`` feed the engine's search (method + prune_margin);
    ``q_width_frac`` scales the encode-side rep width (``q_width=`` in
    search truncates the query rep to its largest terms — fewer postings
    touched).
    """
    name: str
    search_kwargs: Dict[str, Any] = dataclasses.field(
        default_factory=dict)
    q_width_frac: float = 1.0


DEFAULT_LADDER: Tuple[DegradeStep, ...] = (
    DegradeStep("exact"),
    DegradeStep("pruned", {"method": "pruned", "prune_margin": 0.0}),
    DegradeStep("aggressive",
                {"method": "pruned", "prune_margin": 0.5}, 0.5),
    DegradeStep("minimal",
                {"method": "pruned", "prune_margin": 1.0}, 0.25),
)


@dataclasses.dataclass
class DegradePolicy:
    """Hysteresis thresholds for the ladder state machine.

    Pressure is ``max(est_queue_delay / slo, depth / max_queue,
    recent_shed_fraction)`` — dimensionless, 1.0 = the queue already
    costs a full SLO (or every recent submit bounced). The shed term
    matters under hard overload: admission shedding keeps the *queue*
    healthy, so queue-derived terms alone sit just under threshold
    while most traffic is refused. The
    controller steps *down* the ladder (degrades) after ``up_ticks``
    consecutive ticks above ``high`` and climbs back one rung after
    ``down_ticks`` consecutive ticks below ``low``; the band between
    the thresholds and the longer recovery streak are the hysteresis
    that stops flapping at the boundary.
    """
    slo_s: float = 0.1          # pressure reference when requests
                                # carry no deadline of their own
    high: float = 0.8
    low: float = 0.3
    up_ticks: int = 3
    down_ticks: int = 10
    ladder: Tuple[DegradeStep, ...] = DEFAULT_LADDER


class DegradeController:
    """The ladder state machine: feed it pressure, read the rung.

    ``observe(pressure)`` is called once per loop tick;
    ``search_kwargs()`` / ``q_width(base)`` expose the current rung to
    retrieval callers. ``transitions`` records ``(tick, from, to)``
    and ``ticks_at_level`` the dwell time per rung — both surface in
    ``ServingLoop.stats()`` and the serving bench.
    """

    def __init__(self, policy: Optional[DegradePolicy] = None):
        self.policy = policy or DegradePolicy()
        if not self.policy.ladder:
            raise ValueError("DegradePolicy.ladder must be non-empty")
        self.level = 0
        self.transitions: List[Tuple[int, int, int]] = []
        self.ticks_at_level = [0] * len(self.policy.ladder)
        self._tick = 0
        self._high_streak = 0
        self._low_streak = 0

    @property
    def step(self) -> DegradeStep:
        return self.policy.ladder[self.level]

    def search_kwargs(self) -> Dict[str, Any]:
        return dict(self.step.search_kwargs)

    def q_width(self, base_width: int) -> int:
        return max(1, int(base_width * self.step.q_width_frac))

    def observe(self, pressure: float) -> int:
        """One tick's pressure sample; returns the (possibly new)
        level. Mid-band samples reset both streaks — only *sustained*
        pressure moves the ladder."""
        pol = self.policy
        self._tick += 1
        self.ticks_at_level[self.level] += 1
        if pressure > pol.high:
            self._high_streak += 1
            self._low_streak = 0
        elif pressure < pol.low:
            self._low_streak += 1
            self._high_streak = 0
        else:
            self._high_streak = 0
            self._low_streak = 0
        if (self._high_streak >= pol.up_ticks
                and self.level < len(pol.ladder) - 1):
            self._move(self.level + 1)
            self._high_streak = 0
        elif self._low_streak >= pol.down_ticks and self.level > 0:
            self._move(self.level - 1)
            self._low_streak = 0
        return self.level

    def _move(self, to: int) -> None:
        self.transitions.append((self._tick, self.level, to))
        self.level = to

    def stats(self) -> Dict[str, Any]:
        return {
            "degrade_level": self.level,
            "degrade_name": self.step.name,
            "degrade_transitions": len(self.transitions),
            "degrade_ticks_at_level": list(self.ticks_at_level),
        }


class BatchedEncoder:
    """Pads + batches requests and runs the encode fn.

    ``encode_fn(tokens (B, S), mask (B, S)) -> reps`` takes CPU int32
    tensors (the encoder moves them to its device) and returns either a
    dense ``(B, V)`` tensor or a batched ``SparseRep``; results are split
    per request (numpy row / single-row numpy rep), as in the JAX
    package. A dense row crosses to the host as f32 (``V * 4`` bytes,
    122 KB at V = 30522) where a sparse one moves ``(K,)``; either copy
    ends the batch's device work, so the loop's encode times (its
    admission estimate) are device times. Bucket padding: sequences are
    padded to the next multiple of ``pad_to_multiple``, so the kernels see
    few distinct shapes.
    """

    def __init__(self, encode_fn: Callable[..., Any],
                 *, policy: Optional[BatchPolicy] = None):
        self.encode_fn = encode_fn
        self.policy = policy or BatchPolicy()

    def _pad_len(self, n: int) -> int:
        m = self.policy.pad_to_multiple
        return max(m, ((n + m - 1) // m) * m)

    def encode_batch(self, reqs: Sequence[Request]) -> Dict[int, Any]:
        if not reqs:
            return {}
        S = self._pad_len(max(len(r.tokens) for r in reqs))
        B = len(reqs)
        toks = np.zeros((B, S), np.int32)
        mask = np.zeros((B, S), np.int32)
        for i, r in enumerate(reqs):
            n = len(r.tokens)
            toks[i, :n] = r.tokens
            mask[i, :n] = 1
        reps = self.encode_fn(torch.from_numpy(toks),
                              torch.from_numpy(mask))
        if isinstance(reps, SparseRep):
            rows: Sequence[Any] = split_rows(reps)
        else:
            rows = reps.float().cpu().numpy()
        return {r.uid: rows[i] for i, r in enumerate(reqs)}


class ServingLoop:
    """Deadline/size micro-batching with admission control, fault
    isolation, and degrade signalling (module docstring).

    Contracts:

    * ``tick`` dispatches **at most one batch** per call (expiry
      shedding aside) — schedulers interleave ticks with arrivals and
      tests stay deterministic. ``drain`` loops forced ticks and is
      guaranteed to terminate: every forced tick either sheds expired
      requests or dispatches one batch, so ``pending`` strictly
      shrinks.
    * ``tick`` never raises on encode failure: faults are bisected
      down to the poisoned request(s), which complete as
      ``FailedResult``.
    * ``completed`` holds results only until the caller collects them
      with ``take(uid)`` — results are popped on read. The stats
      windows (``batch_sizes``, the latency reservoir) are bounded
      deques, so a long-lived loop's memory stays bounded by in-flight
      work.
    """

    def __init__(self, encoder: BatchedEncoder,
                 *, clock: Callable[[], float] = time.monotonic,
                 admission: Optional[AdmissionPolicy] = None,
                 degrade: Optional[DegradeController] = None,
                 continuous: bool = False,
                 ewma_alpha: float = 0.2,
                 window: int = 512,
                 shed_window: int = 64):
        self.encoder = encoder
        self.clock = clock
        self.continuous = continuous
        self.admission = admission or AdmissionPolicy()
        self.degrade = degrade
        self.pending: List[Request] = []
        self.completed: Dict[int, Any] = {}
        # bounded rolling windows (stats inputs) — a long-lived loop
        # must not grow with total traffic
        self.batch_sizes: collections.deque = collections.deque(
            maxlen=window)
        self._latencies: collections.deque = collections.deque(
            maxlen=window)
        # recent admission/expiry outcomes (1 = shed, 0 = accepted):
        # the shed fraction is a pressure signal — admission shedding
        # keeps the *queue* healthy, so queue depth alone under-reports
        # overload; what was refused must still push the degrade ladder
        self._shed_marks: collections.deque = collections.deque(
            maxlen=max(1, shed_window))
        self._ewma_alpha = ewma_alpha
        self._encode_ewma: Optional[float] = None   # s per dispatch
        self._batch_cap = self.encoder.policy.max_batch
        self._clean_batches = 0
        self.counters: collections.Counter = collections.Counter()

    # -- admission -------------------------------------------------------

    def _effective_cap(self) -> int:
        return max(1, min(self.encoder.policy.max_batch,
                          self._batch_cap))

    def estimated_queue_delay(self, depth: Optional[int] = None
                              ) -> float:
        """EWMA encode time × batches ahead — 0 until the first
        dispatch establishes a baseline."""
        if depth is None:
            depth = len(self.pending)
        if self._encode_ewma is None or depth <= 0:
            return 0.0
        batches = -(-depth // self._effective_cap())
        return batches * self._encode_ewma

    def submit(self, req: Request) -> Admission:
        req.arrival_t = self.clock()
        self.counters["submitted"] += 1
        if len(self.pending) >= self.admission.max_queue_depth:
            return self._shed(req, "queue_full")
        # Never starve: an idle server always accepts. The delay
        # estimate is a lagging EWMA — if it went stale above the
        # deadline (e.g. after an overload at full batches), shedding
        # on an empty queue would wedge the loop at 100% shed with no
        # dispatch left to refresh the estimate.
        if req.deadline_s is not None and self.pending:
            if self.continuous:
                # EDF admission: this request only waits behind
                # pending work that is at least as urgent
                key = self._edf_key(req)
                ahead = sum(1 for p in self.pending
                            if self._edf_key(p) <= key)
                est = self.estimated_queue_delay(ahead + 1)
            else:
                est = self.estimated_queue_delay(len(self.pending) + 1)
            if self.admission.safety * est > req.deadline_s:
                return self._shed(req, "est_deadline")
        self.pending.append(req)
        self._shed_marks.append(0)
        return Admission.ACCEPTED

    def _shed(self, req: Request, reason: str) -> Admission:
        key = ("shed_expired" if reason == "expired"
               else "shed_admission")
        self.counters[key] += 1
        self._shed_marks.append(1)
        self.completed[req.uid] = ShedResult(
            req.uid, reason, waited_s=self.clock() - req.arrival_t)
        return Admission.SHED

    # -- results ---------------------------------------------------------

    def take(self, uid: int) -> Any:
        """Pop and return the completed record for ``uid`` — the
        encoded rep when served, else a ``ShedResult`` /
        ``FailedResult``. Raises ``KeyError`` when the request hasn't
        completed (or was already taken) — the loop never hands out a
        result twice."""
        return self.completed.pop(uid)

    def latencies(self) -> np.ndarray:
        """Served latencies in the bounded rolling reservoir (s)."""
        return np.asarray(self._latencies, np.float64)

    # -- the loop --------------------------------------------------------

    @staticmethod
    def _edf_key(r: Request) -> Tuple[float, float, int]:
        """Earliest-deadline-first order: absolute deadline (best-
        effort requests sort last), then arrival, then uid — a total
        order, so batch selection is deterministic."""
        dl = (r.arrival_t + r.deadline_s if r.deadline_s is not None
              else float("inf"))
        return (dl, r.arrival_t, r.uid)

    def _should_dispatch(self, now: float, *, force: bool) -> bool:
        """The dispatch trigger: forced, full batch, oldest wait over
        ``max_wait_s``, or (continuous mode) the most urgent pending
        deadline's slack has shrunk to one EWMA encode time — waiting
        any longer would expire it."""
        if not self.pending:
            return False
        if force:
            return True
        if len(self.pending) >= self._effective_cap():
            return True
        oldest_wait = now - min(r.arrival_t for r in self.pending)
        if oldest_wait >= self.encoder.policy.max_wait_s:
            return True
        if self.continuous:
            urgent = min((r.arrival_t + r.deadline_s
                          for r in self.pending
                          if r.deadline_s is not None),
                         default=None)
            if urgent is not None and (
                    urgent - now <= (self._encode_ewma or 0.0)):
                return True
        return False

    def ready(self, *, force: bool = False) -> bool:
        """Would ``tick`` dispatch a batch right now? A non-mutating
        probe for schedulers (``TenantPool``) that must pick one loop
        to tick without side effects. Expired-but-still-queued
        requests count toward readiness — the tick that follows sheds
        them first and may then dispatch nothing."""
        return bool(self.pending) and (
            force or self._should_dispatch(self.clock(), force=False))

    def _drop_expired(self, now: float) -> int:
        """Shed queued requests whose deadline already passed — before
        an encode is wasted on them."""
        if not any(r.deadline_s is not None for r in self.pending):
            return 0
        keep, dropped = [], 0
        for r in self.pending:
            if (r.deadline_s is not None
                    and now - r.arrival_t > r.deadline_s):
                self._shed(r, "expired")
                dropped += 1
            else:
                keep.append(r)
        self.pending = keep
        return dropped

    def _pressure(self) -> float:
        slos = [r.deadline_s for r in self.pending
                if r.deadline_s is not None]
        slo = min(slos) if slos else (
            self.degrade.policy.slo_s if self.degrade else 0.1)
        delay_term = (self.estimated_queue_delay() / slo
                      if slo > 0 else 0.0)
        depth_term = (len(self.pending)
                      / max(1, self.admission.max_queue_depth))
        # fraction of recent submissions shed (admission or expiry):
        # under hard overload admission holds the queue at ~one batch,
        # so the queue-derived terms sit just under threshold — the
        # refused traffic is the honest overload signal
        shed_term = (sum(self._shed_marks) / len(self._shed_marks)
                     if self._shed_marks else 0.0)
        return max(delay_term, depth_term, shed_term)

    def _encode_isolated(self, batch: List[Request]
                         ) -> Tuple[Dict[int, Any], bool]:
        """Encode with bisect isolation: a failing batch is split in
        halves and retried until the poison request(s) stand alone;
        those fail structurally, everyone else is served. OOM-shaped
        errors additionally halve the adaptive batch cap."""
        results: Dict[int, Any] = {}
        had_fault = False

        def run(reqs: List[Request]) -> None:
            nonlocal had_fault
            try:
                results.update(self.encoder.encode_batch(reqs))
                return
            except Exception as e:      # noqa: BLE001 — tick never raises
                had_fault = True
                self.counters["faults"] += 1
                oom = is_oom_error(e)
                if oom:
                    self.counters["oom_faults"] += 1
                    self._batch_cap = max(1, self._effective_cap() // 2)
                    self._clean_batches = 0
                if len(reqs) == 1:
                    r = reqs[0]
                    results[r.uid] = FailedResult(r.uid, error=repr(e),
                                                  oom=oom)
                    self.counters["failed"] += 1
                    return
                mid = len(reqs) // 2
                run(reqs[:mid])
                run(reqs[mid:])

        run(batch)
        return results, had_fault

    def tick(self, *, force: bool = False) -> int:
        """Shed expired requests, then dispatch **at most one** batch
        if the size/deadline policy (or ``force``) triggers. Returns
        the dispatched batch size. Never raises on encode faults."""
        pol = self.encoder.policy
        now = self.clock()
        self._drop_expired(now)
        if self.degrade is not None:
            self.degrade.observe(self._pressure())
        if not self._should_dispatch(now, force=force):
            return 0
        cap = self._effective_cap()
        if self.continuous:
            # admit the cap most urgent requests into this batch
            order = sorted(range(len(self.pending)),
                           key=lambda i: self._edf_key(self.pending[i]))
            chosen = set(order[:cap])
            batch = [self.pending[i] for i in order[:cap]]
            self.pending = [r for i, r in enumerate(self.pending)
                            if i not in chosen]
        else:
            batch = self.pending[:cap]
            self.pending = self.pending[cap:]
        t0 = self.clock()
        results, had_fault = self._encode_isolated(batch)
        dt = self.clock() - t0
        a = self._ewma_alpha
        self._encode_ewma = (dt if self._encode_ewma is None
                             else (1 - a) * self._encode_ewma + a * dt)
        self.completed.update(results)
        done = self.clock()
        for r in batch:
            if not isinstance(results[r.uid], FailedResult):
                self.counters["served"] += 1
                self._latencies.append(done - r.arrival_t)
        self.batch_sizes.append(len(batch))
        if had_fault:
            self._clean_batches = 0
        else:
            self._clean_batches += 1
            if (self._batch_cap < pol.max_batch
                    and self._clean_batches >= pol.grow_after_clean):
                self._batch_cap = min(pol.max_batch,
                                      self._batch_cap * 2)
                self._clean_batches = 0
        return len(batch)

    def drain(self) -> None:
        """Force-dispatch until the queue is empty. One batch per
        forced tick (the tick contract); every iteration strictly
        shrinks ``pending`` (a dispatch or expiry sheds), so this
        always terminates."""
        while self.pending:
            before = len(self.pending)
            self.tick(force=True)
            if len(self.pending) >= before:   # pragma: no cover
                raise RuntimeError("tick(force=True) made no progress")

    # -- observability ---------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Health snapshot: queue, outcome counters, batch occupancy,
        adaptive cap, p50/p99 latency over the bounded reservoir, and
        the degrade state when a controller is attached."""
        c = self.counters
        pol = self.encoder.policy
        lat = self.latencies()
        occupancy = (float(np.mean(self.batch_sizes))
                     / max(1, pol.max_batch)
                     if self.batch_sizes else 0.0)
        d: Dict[str, Any] = {
            "queue_depth": len(self.pending),
            "submitted": c["submitted"],
            "served": c["served"],
            "shed": c["shed_admission"] + c["shed_expired"],
            "shed_admission": c["shed_admission"],
            "shed_expired": c["shed_expired"],
            "failed": c["failed"],
            "faults": c["faults"],
            "oom_faults": c["oom_faults"],
            "batch_cap": self._effective_cap(),
            "continuous": self.continuous,
            "batch_occupancy": round(occupancy, 4),
            "encode_ewma_s": self._encode_ewma or 0.0,
            "p50_latency_s": (float(np.percentile(lat, 50))
                              if lat.size else 0.0),
            "p99_latency_s": (float(np.percentile(lat, 99))
                              if lat.size else 0.0),
        }
        if self.degrade is not None:
            d.update(self.degrade.stats())
        return d


class CorpusEngine:
    """Online corpus for the serving loop: encode + index + search.

    Couples a ``BatchedEncoder`` (documents go through the same batched
    encode path as queries) with an ``engine.IndexBuilder``, so the corpus
    grows and shrinks while serving::

        eng = CorpusEngine(encoder, vocab_size, quantize=True)
        ids = eng.add_docs(token_arrays)       # encode + buffer
        eng.remove_docs(ids[:3])               # tombstone
        vals, ext_ids = eng.search(q_rep, k)   # flushes, then scores

    ``search`` returns stable external doc ids (those ``add_docs`` handed
    out), across compactions. With ``quantize=True`` the base segment is
    served compressed (K5 under ``"fused"``, and under ``"auto"`` from
    ``AUTO_FUSED_N`` base docs); with ``keep_forward=True`` the segments
    keep their forward rows and ``"auto"`` searches them with the two-tier
    ``"pruned"`` method (``prune_margin=`` and ``candidates=`` pass
    through ``search``). The segments live on ``device`` (default
    ``cuda``).

    ``shard_axis``/``n_shards`` pick the base segment's partitioning:
    ``"doc"`` leaves the base one index (doc sharding is a serving-mesh
    choice, not a builder one), ``"term"`` serves it as a
    ``TermShardedIndex`` over ``n_shards`` vocab ranges. ``plan=`` (a
    ``ShardPlan`` from ``engine.shard2d.plan_placement``) supersedes both:
    its term axis sets the vocab ranges, and a grid of both axes serves the
    base as a ``Shard2DIndex``.
    """

    def __init__(self, encoder: BatchedEncoder, vocab_size: int, *,
                 quantize: bool = False, keep_forward: bool = False,
                 merge_frac: float = 0.25, compact_dead_frac: float = 0.25,
                 shard_axis: str = "doc", n_shards: int = 1, plan=None,
                 device=None):
        from repro_torch.retrieval.engine import IndexBuilder

        if plan is not None:
            if shard_axis != "doc" or n_shards != 1:
                raise ValueError(
                    "pass either plan= or shard_axis/n_shards, not both — "
                    "the plan carries the shard topology")
            self.builder_kwargs = {"plan": plan}
        else:
            if shard_axis not in ("doc", "term"):
                raise ValueError(f"shard_axis must be 'doc' or 'term', got "
                                 f"{shard_axis!r}")
            self.builder_kwargs = {
                "term_shards": n_shards if shard_axis == "term" else 0}
        self.encoder = encoder
        self.plan = plan
        self.builder = IndexBuilder(
            vocab_size, quantize=quantize, keep_forward=keep_forward,
            merge_frac=merge_frac, compact_dead_frac=compact_dead_frac,
            device=device, **self.builder_kwargs)
        self._next_uid = 0

    def add_docs(self, docs: Sequence[np.ndarray],
                 ids: Optional[Sequence[int]] = None) -> np.ndarray:
        """Encode token arrays through the batched encoder and buffer them
        into the index; returns their external doc ids.

        Documents are encoded in chunks of the encoder's
        ``policy.max_batch``. The first chunk's rows are type-checked
        before the next chunk is encoded, so a dense encoder fails fast.
        """
        from repro_torch.retrieval.sparse_rep import stack_rows

        rows = []
        chunk = max(1, self.encoder.policy.max_batch)
        docs = list(docs)
        for lo in range(0, len(docs), chunk):
            reqs = []
            for tokens in docs[lo:lo + chunk]:
                reqs.append(Request(uid=self._next_uid,
                                    tokens=np.asarray(tokens, np.int32)))
                self._next_uid += 1
            by_uid = self.encoder.encode_batch(reqs)
            chunk_rows = [by_uid[r.uid] for r in reqs]
            if not all(isinstance(r, SparseRep) for r in chunk_rows):
                raise ValueError(
                    "CorpusEngine needs a sparse encoder — set the config's "
                    "rep_topk/rep_threshold knobs so encode emits SparseReps")
            rows.extend(chunk_rows)
        if not rows:
            return np.zeros(0, np.int64)
        return self.builder.add(stack_rows(rows), ids=ids)

    def remove_docs(self, ids: Sequence[int]) -> int:
        return self.builder.remove(ids)

    def flush(self, **kw) -> None:
        self.builder.flush(**kw)

    def search(self, queries, k: int = 10, *, method: str = "auto",
               **kw) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k with external ids (``IndexBuilder.search``: ``q_width``,
        the frontier's ``base_scorer``, and ``prune_margin`` /
        ``candidates`` for the pruned method)."""
        return self.builder.search(queries, k, method=method, **kw)

    def stats(self) -> Dict[str, float]:
        return self.builder.stats()


def retrieve_topk(q_reps, doc_matrix: torch.Tensor, k: int = 10
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense-fallback retrieval: scores + top-k doc ids of ``q_reps``
    (dense ``(B, V)`` or ``SparseRep``) against an ``(N, V)`` matrix.

    Back-compat shim over the unified dispatcher — new code should call
    ``repro_torch.retrieval.score.retrieve(queries, corpus, k,
    method=...)`` directly (which also serves the index and streaming
    kernel paths).
    """
    from repro_torch.retrieval.score import retrieve

    return retrieve(q_reps, doc_matrix, k, method="dense")
